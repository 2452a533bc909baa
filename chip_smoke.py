"""Smoke test of tikejax on NVIDIA GPUs, through the public API.

Usage:
  python chip_smoke.py             # phases A-D on one GPU
  python chip_smoke.py --chips 4   # BASELINE.json config 5 sharded over
                                   # four GPUs, against one GPU

Phases (one GPU):
  A  fwd_raw / adj_raw / adj_probe_raw at 512^2 object, 128^2 probe and
     detector, 4096 positions: GPU against the same call on the CPU
     device, plus the object and probe adjoint identities on the GPU.
  B  headline solver run, 512^2 / 16384 positions / 128^2, Gaussian,
     ``run(..., piter=100)``: resolved kernel, compile + first run,
     steady iterations per second, peak device memory, minf monotone;
     the same run under ``jax.default_matmul_precision("highest")``.
  C  ``reconstruct(..., target_residual=1e-4)`` on the same problem.
  D  BASELINE.json config 3 (joint object+probe, Poisson, 4096
     positions) and config 4 (4 probe modes x 16384 positions, nchunks
     chosen from the device's memory limit).

Every phase prints its readings on its own line; timing lines carry the
card's name and power limit. Any failed check raises, so the script
exits non-zero. The last line of standard output is one JSON object:
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}``.
Without a GPU, or run from a directory that does not hold the tikejax
package beside this file, it exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys

import jax
import jax.numpy as jnp
import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))

import tikejax  # noqa: E402

if pathlib.Path(tikejax.__file__).resolve().parents[1] != ROOT:
    raise SystemExit(f"tikejax was imported from {tikejax.__file__}, not "
                     f"from the checkout that holds this script ({ROOT})")

from tikejax import Geometry  # noqa: E402
from tikejax.models import likelihoods, make_problem  # noqa: E402
from tikejax.ops import adj_probe_raw, adj_raw, fwd_raw  # noqa: E402
from tikejax.solvers import reconstruct, run  # noqa: E402
from tikejax.solvers.cg import make_options, normalize_options  # noqa: E402
from tikejax.utils import runtime  # noqa: E402
from tikejax.utils.runtime import timed  # noqa: E402

# Operator tolerance, GPU against CPU, both float32 under "highest"
# matmul precision: cuFFT and the CPU FFT sum in different orders
# (about 1e-6 relative max-abs error expected), and the GPU scatter-add
# accumulates overlapping patches with atomics in run-dependent order.
OP_TOL = 1e-5
# Adjoint identities <Ax, y> = <x, A^H y> on the GPU: float32 operators,
# inner products taken in float64 on the host; same bound, same reasons.
ADJ_TOL = 1e-5
# minf must not increase from one iteration to the next beyond this
# relative slack: the line search accepts a step on the objective
# evaluated from quadratic statistics, the next iteration re-evaluates it
# from a fresh forward pass, and the two differ by float32 rounding.
MONO_TOL = 1e-6
# Sharded against single-GPU minf after N iterations: psum and chunk
# order change float32 sums at ~1e-7, which the line search's discrete
# step choices can amplify over the run.
SHARD_TOL = 1e-3

HEADLINE = Geometry(nz=512, n=512, nscan=16384, ndet=128, nprb=128)


def check_device(devices=None, count=None) -> list:
    """The devices to run on: GPUs only (no CPU fallback), ``count`` of
    them when given."""
    devices = runtime.require_gpu(devices)
    if count is not None and len(devices) != count:
        raise SystemExit(f"expected {count} GPU(s), JAX reports "
                         f"{len(devices)}")
    return devices


def out(line: str) -> None:
    print(line, flush=True)


def peak_gib(device) -> float:
    """Peak bytes in use on ``device`` since the process started, GiB."""
    return device.memory_stats()["peak_bytes_in_use"] / 2**30


def executed(metrics, key="minf") -> np.ndarray:
    """A per-iteration metric, cut at the number of iterations run."""
    n = max(int(metrics["iters_run"]), 1)
    return np.asarray(metrics[key])[:n]


def check_descent(name: str, minf: np.ndarray, monotone: bool) -> None:
    if not np.all(np.isfinite(minf)):
        raise AssertionError(f"{name}: minf has non-finite values")
    if monotone:
        rise = np.diff(minf) / np.abs(minf[:-1])
        if rise.size and rise.max() > MONO_TOL:
            raise AssertionError(f"{name}: minf rose by {rise.max():.3e} "
                                 f"relative at iteration "
                                 f"{int(rise.argmax()) + 1}")
    if not minf[-1] < minf[0]:
        raise AssertionError(f"{name}: minf did not decrease "
                             f"({minf[0]:.6e} -> {minf[-1]:.6e})")


def rel_max_err(a, b) -> float:
    a, b = np.asarray(a), np.asarray(b)
    return float(np.max(np.abs(a - b)) / np.max(np.abs(b)))


def phase_a(gpu, cpu, card):
    g = Geometry(nz=512, n=512, nscan=4096, ndet=128, nprb=128)
    psi, scan, prb, _ = make_problem(jax.random.PRNGKey(1), g)
    k1, k2 = jax.random.split(jax.random.PRNGKey(2))
    farp = jax.lax.complex(jax.random.normal(k1, g.farplane_shape),
                           jax.random.normal(k2, g.farplane_shape))
    fwd = jax.jit(fwd_raw, static_argnums=(3,))
    adj = jax.jit(adj_raw, static_argnums=(3, 4))
    adjp = jax.jit(adj_probe_raw, static_argnums=(3,))
    on_cpu = [jax.device_put(x, cpu) for x in (psi, scan, prb, farp)]
    errs = {}
    with jax.default_matmul_precision("highest"):
        for name, fn, args, cargs in (
                ("fwd_raw", fwd, (psi, scan, prb, g.ndet),
                 (on_cpu[0], on_cpu[1], on_cpu[2], g.ndet)),
                ("adj_raw", adj, (farp, scan, prb, g.nz, g.n),
                 (on_cpu[3], on_cpu[1], on_cpu[2], g.nz, g.n)),
                ("adj_probe_raw", adjp, (farp, scan, psi, g.nprb),
                 (on_cpu[3], on_cpu[1], on_cpu[0], g.nprb))):
            res_gpu, dt = timed(fn, *args)
            res_cpu = fn(*cargs)
            if res_gpu.devices() != {gpu} or res_cpu.devices() != {cpu}:
                raise AssertionError(f"{name} ran on {res_gpu.devices()} "
                                     f"and {res_cpu.devices()}")
            errs[name] = rel_max_err(res_gpu, res_cpu)
            out(f"A {name}: shape {tuple(res_gpu.shape)}, GPU vs CPU "
                f"rel max-abs err {errs[name]:.3e} (bound {OP_TOL:g}); "
                f"first call incl. compile {dt:.3f} s [{card}]")
            if name == "fwd_raw":
                fp_gpu = res_gpu
            elif name == "adj_raw":
                adj_gpu = res_gpu
            else:
                adjp_gpu = res_gpu
    c128 = lambda x: np.asarray(x).astype(np.complex128)  # noqa: E731
    lhs = np.vdot(c128(fp_gpu), c128(farp))
    rel_o = abs(lhs - np.vdot(c128(psi), c128(adj_gpu))) / abs(lhs)
    rel_p = abs(lhs - np.vdot(c128(prb), c128(adjp_gpu))) / abs(lhs)
    out(f"A adjoint identity on GPU (nscan={g.nscan}): object rel err "
        f"{rel_o:.3e}, probe rel err {rel_p:.3e} (bound {ADJ_TOL:g})")
    bad = {k: v for k, v in errs.items() if not v <= OP_TOL}
    if bad:
        raise AssertionError(f"phase A: GPU vs CPU beyond {OP_TOL}: {bad}")
    if not (rel_o <= ADJ_TOL and rel_p <= ADJ_TOL):
        raise AssertionError(f"phase A: adjoint identity beyond {ADJ_TOL}")


def headline_problem():
    g = HEADLINE
    psi_true, scan, prb, data = make_problem(jax.random.PRNGKey(0), g)
    psi0 = jnp.ones(g.psi_shape, jnp.complex64)
    return g, jax.block_until_ready((scan, prb, data, psi0))


def phase_b(gpu, card, problem):
    g, (scan, prb, data, psi0) = problem
    opts = normalize_options(make_options(None, piter=100))
    out(f"B headline {g.nz}^2 object, {g.nscan} positions, {g.ndet}^2 "
        f"frames, gaussian: resolved kernel {opts.kernel!r}")
    if opts.kernel != "xla":
        raise AssertionError(f"'auto' resolved to {opts.kernel!r}")
    (_, _, m), t_first = timed(run, data, psi0, scan, prb, g, piter=100)
    minf = executed(m)
    check_descent("phase B", minf, monotone=True)
    rates = []
    for _ in range(3):
        (_, _, m2), dt = timed(run, data, psi0, scan, prb, g, piter=100)
        rates.append(int(m2["iters_run"]) / dt)
    out(f"B compile + first run {t_first:.2f} s ({len(minf)} iters); "
        f"steady {np.median(rates):.2f} iters/s (runs "
        f"{', '.join(f'{r:.2f}' for r in rates)}); peak device memory "
        f"{peak_gib(gpu):.2f} GiB [{card}]")
    with jax.default_matmul_precision("highest"):
        _, _, mh = jax.block_until_ready(
            run(data, psi0, scan, prb, g, piter=100))
    minf_h = executed(mh)
    out(f"B minf after {len(minf)} iters {minf[-1]:.9e} (default "
        f"precision), after {len(minf_h)} iters {minf_h[-1]:.9e} "
        f"(matmul precision 'highest'); rel diff "
        f"{abs(minf[-1] - minf_h[-1]) / abs(minf_h[-1]):.3e}")


def phase_c(card, problem):
    g, (scan, prb, data, psi0) = problem
    target = 1e-4
    (psi, _, stages), dt = timed(reconstruct, data, psi0, scan, prb, g,
                                 target_residual=target)
    total = 0
    for name, m in stages:
        k = max(int(m["iters_run"]), 1)
        total += k
        out(f"C stage {name}: {k} iters, residual "
            f"{float(np.asarray(m['residual'])[k - 1]):.3e}")
    fp = jax.jit(fwd_raw, static_argnums=(3,))(psi, scan, prb, g.ndet)
    res = float(jnp.sqrt(likelihoods.gaussian_minf(fp, data)
                         / jnp.sum(data)))
    out(f"C reconstruct to {target:g}: {len(stages)} stages, {total} "
        f"iters, {dt:.2f} s wall incl. compile; residual of the returned "
        f"object {res:.3e} [{card}]")
    if not res <= target:
        raise AssertionError(f"phase C: residual {res:.3e} > {target:g}")


def phase_d(gpu, card):
    g3 = Geometry(nz=512, n=512, nscan=4096, ndet=128, nprb=128)
    _, scan, prb, data = make_problem(jax.random.PRNGKey(3), g3)
    psi0 = jnp.ones(g3.psi_shape, jnp.complex64)
    (_, _, m), dt = timed(run, data, psi0, scan, prb * 0.9, g3, piter=32,
                          model="poisson", recover_prb=True)
    minf = executed(m)
    check_descent("phase D config 3", minf, monotone=False)
    out(f"D config 3 joint object+probe poisson 512^2 / 4096 / 128^2: "
        f"{len(minf)} iters, minf {minf[0]:.6e} -> {minf[-1]:.6e}, "
        f"{dt:.2f} s incl. compile [{card}]")
    del scan, prb, data, psi0

    g4 = Geometry(nz=512, n=512, nscan=16384, ndet=128, nprb=128, nmodes=4)
    nch = runtime.nchunks_for(g4, gpu)
    _, scan, prb, data = make_problem(jax.random.PRNGKey(4), g4)
    psi0 = jnp.ones(g4.psi_shape, jnp.complex64)
    (_, _, m), dt = timed(run, data, psi0, scan, prb, g4, piter=24,
                          nchunks=nch)
    minf = executed(m)
    check_descent("phase D config 4", minf, monotone=True)
    out(f"D config 4 {g4.nmodes} modes x {g4.nscan} positions, 512^2 / "
        f"128^2: nchunks={nch} (device limit "
        f"{gpu.memory_stats()['bytes_limit'] / 2**30:.1f} GiB), "
        f"{len(minf)} iters, minf {minf[0]:.6e} -> {minf[-1]:.6e}, "
        f"{dt:.2f} s incl. compile; process peak device memory "
        f"{peak_gib(gpu):.2f} GiB [{card}]")


def sharded_config5(devices, card, piter=20):
    """BASELINE.json config 5 (512^2 / 65536 positions / 128^2) over a
    1-D 'scan' mesh of all four GPUs, against one GPU."""
    from tikejax.parallel import make_mesh, run_sharded, shard_problem

    g = Geometry(nz=512, n=512, nscan=65536, ndet=128, nprb=128)
    _, scan, prb, data = make_problem(jax.random.PRNGKey(5), g)
    psi0 = jnp.ones(g.psi_shape, jnp.complex64)
    mesh = make_mesh(len(devices))
    data_s, scan_s = shard_problem(mesh, data, scan)
    for name, x in (("data", data_s), ("scan", scan_s)):
        shards = {s.device for s in x.addressable_shards}
        sizes = {s.data.shape[1] for s in x.addressable_shards}
        if shards != set(devices) or sizes != {g.nscan // len(devices)}:
            raise AssertionError(f"{name} is not split over the mesh: "
                                 f"{x.sharding}")
        out(f"S {name} sharding {x.sharding.spec} over "
            f"{len(shards)} devices, {sizes.pop()} positions each")
    (_, _, ms), t_first = timed(run_sharded, data_s, psi0, scan_s, prb, g,
                                mesh, piter=piter)
    (_, _, ms), dt_s = timed(run_sharded, data_s, psi0, scan_s, prb, g,
                             mesh, piter=piter)
    del data_s, scan_s
    nch = runtime.nchunks_for(g, devices[0])
    (_, _, m1), t_first1 = timed(run, data, psi0, scan, prb, g, piter=piter,
                                 nchunks=nch)
    (_, _, m1), dt_1 = timed(run, data, psi0, scan, prb, g, piter=piter,
                             nchunks=nch)
    minf_s, minf_1 = executed(ms), executed(m1)
    check_descent("sharded config 5", minf_s, monotone=True)
    check_descent("single-GPU config 5", minf_1, monotone=True)
    n = min(len(minf_s), len(minf_1))
    dev = np.abs(minf_s[:n] - minf_1[:n]) / np.abs(minf_1[:n])
    out(f"S config 5 sharded over {len(devices)} GPUs: compile + first "
        f"{t_first:.2f} s, {len(minf_s) / dt_s:.2f} iters/s; one GPU "
        f"(nchunks={nch}): compile + first {t_first1:.2f} s, "
        f"{len(minf_1) / dt_1:.2f} iters/s [{card}]")
    out(f"S minf after {n} iters: sharded {minf_s[n - 1]:.9e}, one GPU "
        f"{minf_1[n - 1]:.9e}; max rel deviation over the run "
        f"{dev.max():.3e} (bound {SHARD_TOL:g})")
    if len(minf_s) != len(minf_1) or not dev.max() <= SHARD_TOL:
        raise AssertionError("sharded and single-GPU runs disagree")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--chips", type=int, choices=(1, 4), default=1,
                    help="4: run only the four-GPU sharded config 5 "
                         "against one GPU")
    args = ap.parse_args(argv)
    devices = check_device(count=args.chips)
    gpu = devices[0]
    cache = runtime.enable_compile_cache()
    out(f"compile cache: {cache}")
    cards = runtime.card_lines()
    card = cards[0]
    out(f"device: platform={gpu.platform} kind={gpu.device_kind} "
        f"count={len(devices)} jax={jax.__version__}")
    for line in cards:
        out(f"nvidia-smi: {line}")
    if args.chips == 4:
        sharded_config5(devices, card)
    else:
        phase_a(gpu, jax.devices("cpu")[0], card)
        problem = headline_problem()
        phase_b(gpu, card, problem)
        phase_c(card, problem)
        del problem
        phase_d(gpu, card)
    out(json.dumps({"ok": True, "device": {
        "platform": gpu.platform, "kind": gpu.device_kind,
        "count": len(devices)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
