"""Per-layer device time of the headline solver, and the 2-D DFT as
batched matmuls against the FFT, on one GPU.

Usage:
  python benchmarks/layers.py [--iters 10] [--out profile_out/layers]

1. Trace. Runs the headline problem (512^2 object, 16384 positions,
   128^2 probe and detector, Gaussian) through ``run(..., piter=iters)``
   once to compile, then once more under ``jax.profiler``. The device
   time of the traced run is split by the operator scopes
   (``tikejax.ops.diffraction.SCOPES`` and the solver's ``likelihood``),
   and the device's idle share over the traced window is reported.
2. DFT A/B. On 16384 x 128^2 complex64 frames: ``jnp.fft.fft2`` against
   the 2-D DFT written as two batched matmuls ``F @ X @ F`` at float32
   ``highest`` precision, at TF32, and with bf16 operands (four real
   products, float32 accumulation).

Every line carries the card's name and power limit. Without a GPU the
script exits non-zero.
"""

from __future__ import annotations

import argparse
import collections
import glob
import json
import pathlib
import re
import sys

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from tikejax import Geometry  # noqa: E402
from tikejax.models import make_problem  # noqa: E402
from tikejax.ops.diffraction import SCOPES  # noqa: E402
from tikejax.solvers import run  # noqa: E402
from tikejax.utils import runtime  # noqa: E402

# Published dense peaks (NVIDIA H100 SXM data sheet; rates at the full
# 700 W power limit), keyed by jax's device_kind.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"hbm_gbps": 3350.0, "tf32_tflops": 495.0,
                              "bf16_tflops": 989.0, "fp32_tflops": 67.0},
}

LAYERS = SCOPES + ("likelihood",)


def log(line: str) -> None:
    print(line, flush=True)


def op_name_map(hlo_text: str) -> dict:
    """Instruction name -> ``op_name`` metadata (the jit name stack,
    named scopes included) from a compiled module's text; the trace's
    ``hlo_op`` stat names these instructions."""
    out = {}
    for m in _INSTR.finditer(hlo_text):
        out[m.group(1)] = m.group(2)
    return out


_INSTR = re.compile(r'^\s*(?:ROOT\s+)?%?([\w.\-]+)\s*=[^\n]*?'
                    r'metadata=\{[^}\n]*?op_name="([^"]+)"', re.M)
_INDEX = re.compile(r"_(\d+)$")


def classify(stats: dict, op_names: dict, name: str = "") -> str:
    """Layer of one device event: the innermost operator scope on the
    name stack of its HLO op, else 'other'. The name stack comes from the
    event's string stats, or from the compiled module's metadata looked
    up by the event's ``hlo_op`` stat -- or, for kernels replayed inside
    a CUDA graph (``hlo_op`` is then ``command_buffer``), by the kernel's
    own name, ``fusion_3`` for instruction ``fusion.3``. The last path
    component is the primitive's own name (``fft`` is both a primitive
    and a scope), so it is never matched."""
    paths = [v for v in stats.values() if isinstance(v, str) and "/" in v]
    for key in (stats.get("hlo_op"), name, _INDEX.sub(r".\1", name)):
        if isinstance(key, str) and key in op_names:
            paths.append(op_names[key])
            break
    best = None
    for path in paths:
        parts = path.split("/")[:-1]
        for i, p in enumerate(parts):
            if p in LAYERS and (best is None or i >= best[0]):
                best = (i, p)
    return best[1] if best else "other"


def reduce_events(events, op_names):
    """Per-layer device time, busy time (union of kernel intervals) and
    the window from the first kernel's start to the last one's end, all
    in ns, from (line, name, start_ns, duration_ns, stats) events."""
    per_layer = collections.Counter()
    per_kernel = collections.Counter()
    for _, name, _, dur, stats in events:
        layer = classify(stats, op_names, name)
        per_layer[layer] += dur
        per_kernel[(layer, name)] += dur
    spans = [(s, s + d) for _, _, s, d, _ in events]
    window = max(e for _, e in spans) - min(s for s, _ in spans)
    return per_layer, per_kernel, busy_ns(spans), window


def device_events(trace_dir: str):
    """(line name, event name, start_ns, duration_ns, stats) of every
    kernel event on the GPU planes of the newest trace in
    ``trace_dir``."""
    files = sorted(glob.glob(f"{trace_dir}/**/*.xplane.pb", recursive=True))
    if not files:
        raise FileNotFoundError(f"no trace under {trace_dir}")
    data = jax.profiler.ProfileData.from_file(files[-1])
    events = []
    for plane in data.planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        for line in plane.lines:
            # Stream lines hold the kernels; the derived "XLA Ops" /
            # "XLA Modules" lines repeat the same time.
            if not line.name.startswith("Stream"):
                continue
            for ev in line.events:
                stats = dict(ev.stats)
                events.append((line.name, ev.name, ev.start_ns,
                               ev.duration_ns, stats))
    return events


def busy_ns(intervals) -> float:
    """Length of the union of (start, end) intervals."""
    total, end = 0.0, -np.inf
    for s, e in sorted(intervals):
        if s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def trace_headline(iters: int, out_dir: pathlib.Path, card: str):
    g = Geometry(nz=512, n=512, nscan=16384, ndet=128, nprb=128)
    _, scan, prb, data = make_problem(jax.random.PRNGKey(0), g)
    psi0 = jnp.ones(g.psi_shape, jnp.complex64)
    jax.block_until_ready(run(data, psi0, scan, prb, g, piter=iters))
    trace_dir = str(out_dir / "trace")
    jax.profiler.start_trace(trace_dir)
    (_, _, m), wall = runtime.timed(run, data, psi0, scan, prb, g,
                                    piter=iters)
    jax.profiler.stop_trace()
    ran = int(m["iters_run"])
    events = device_events(trace_dir)
    if not events:
        raise RuntimeError("the trace holds no GPU kernel events")
    from tikejax.solvers import cg

    opts = cg.normalize_options(cg.make_options(None, piter=iters))
    hlo = cg._run_cg_jit.lower(g, opts, data, psi0, scan, prb, None,
                               None).compile().as_text()
    op_names = op_name_map(hlo)
    per_layer, per_kernel, busy, window = reduce_events(events, op_names)
    kernel_sum = sum(per_layer.values())
    log(f"trace: headline run(piter={iters}), {ran} iters, host wall "
        f"{wall * 1e3:.3f} ms, device window {window / 1e6:.3f} ms, busy "
        f"{busy / 1e6:.3f} ms, idle share {1 - busy / window:.4f} "
        f"[{card}]")
    for layer, ns in per_layer.most_common():
        log(f"trace layer {layer}: {ns / 1e6:.3f} ms "
            f"({ns / kernel_sum:.4f} of kernel time, "
            f"{ns / 1e6 / max(ran, 1):.4f} ms/iter)")
    log(f"trace host gaps: {(window - busy) / 1e6:.3f} ms "
        f"({(window - busy) / 1e6 / max(ran, 1):.4f} ms/iter)")
    rows = [{"layer": la, "kernel": k, "ns": ns}
            for (la, k), ns in per_kernel.most_common(60)]
    (out_dir / "trace_kernels.json").write_text(json.dumps(rows, indent=1))
    sample = [{"line": ln, "name": n, "dur_ns": d,
               "stats": {k: str(v)[:200] for k, v in st.items()}}
              for ln, n, _, d, st in events[:200]]
    (out_dir / "trace_sample.json").write_text(json.dumps(sample, indent=1))
    return per_layer, ran


def dft_matrix(n: int) -> jax.Array:
    k = np.arange(n)
    return jnp.asarray(np.exp(-2j * np.pi * np.outer(k, k) / n)
                       / np.sqrt(n), jnp.complex64)


def dft_ab(card: str, peaks: dict, nframes=16384, n=128, reps=10):
    k1, k2 = jax.random.split(jax.random.PRNGKey(9))
    x = lax.complex(jax.random.normal(k1, (nframes, n, n)),
                    jax.random.normal(k2, (nframes, n, n)))
    f = dft_matrix(n)

    def mm(prec):
        def g(x):
            y = jnp.matmul(f, x, precision=prec)
            return jnp.matmul(y, f, precision=prec)
        return g

    def mm_bf16(x):
        def cmul(ar, ai, br, bi, eq):
            dot = lambda a, b: jnp.einsum(  # noqa: E731
                eq, a, b, preferred_element_type=jnp.float32)
            return dot(ar, br) - dot(ai, bi), dot(ar, bi) + dot(ai, br)

        b = jnp.bfloat16
        fr, fi = jnp.real(f).astype(b), jnp.imag(f).astype(b)
        yr, yi = cmul(fr, fi, jnp.real(x).astype(b), jnp.imag(x).astype(b),
                      "ij,bjk->bik")
        zr, zi = cmul(yr.astype(b), yi.astype(b), fr, fi, "bij,jk->bik")
        return lax.complex(zr, zi)

    # name -> (function, the peak its matmuls run against)
    variants = {
        "fft2": (lambda x: jnp.fft.fft2(x, norm="ortho"), None),
        "matmul_fp32_highest": (mm(lax.Precision.HIGHEST), "fp32_tflops"),
        "matmul_tf32": (mm(lax.Precision.DEFAULT), "tf32_tflops"),
        "matmul_bf16": (mm_bf16, "bf16_tflops"),
    }
    ref = None
    bytes_moved = 2 * x.size * 8
    mm_flops = 2 * nframes * 8 * n ** 3
    for name, (fn, peak) in variants.items():
        fj = jax.jit(fn)
        y = jax.block_until_ready(fj(x))
        if ref is None:
            ref = y
        err = float(jnp.max(jnp.abs(y - ref)) / jnp.max(jnp.abs(ref)))
        times = [runtime.timed(fj, x)[1] for _ in range(reps)]
        t = float(np.median(times))
        extra = ""
        if peak is not None:
            tflops = mm_flops / t / 1e12
            extra = (f", {tflops:.2f} TFLOP/s ({tflops / peaks[peak]:.3f} "
                     f"of the {peak.split('_')[0]} peak)")
        log(f"dft {name}: {nframes}x{n}^2 c64, median {t * 1e3:.3f} ms of "
            f"{reps} (min {min(times) * 1e3:.3f}), "
            f"{bytes_moved / t / 1e9:.1f} GB/s "
            f"({bytes_moved / t / 1e9 / peaks['hbm_gbps']:.3f} of HBM "
            f"peak){extra}, max rel err vs fft2 {err:.2e} [{card}]")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--out", default=str(ROOT / "profile_out" / "layers"),
                    help="directory for the trace and its kernel table")
    args = ap.parse_args(argv)
    gpu = runtime.require_gpu()[0]
    if gpu.device_kind not in PEAKS:
        raise SystemExit(f"no published peaks for {gpu.device_kind!r}")
    runtime.enable_compile_cache()
    card = runtime.card_lines()[0]
    log(f"device: {gpu.platform} {gpu.device_kind} x{len(jax.devices())}; "
        f"nvidia-smi: {card}")
    out_dir = pathlib.Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    trace_headline(args.iters, out_dir, card)
    dft_ab(card, PEAKS[gpu.device_kind])
    return 0


if __name__ == "__main__":
    sys.exit(main())
