"""Acceptance configurations of BASELINE.json on the attached GPU(s).

Usage:
  python benchmarks/run_all.py

Runs each configuration end to end through the public API and prints one
JSON line per configuration (device, card and power limit included),
with a log on stderr. Times are taken with ``jax.block_until_ready``
after a warm-up run that compiles. The headline single-number benchmark
is bench.py at the repo root. Without a GPU the script exits non-zero.

Configurations:
  1. fwd/adj adjoint identities, 256^2 object / 64^2 probe / 100 positions
  2. Gaussian CG object-only, 256^2 / 64^2 / 1024 positions
  3. joint object+probe Poisson, 512^2 / 128^2 / 4096 positions
  4. 4 probe modes x 16384 positions, 512^2 / 128^2, position chunks
     chosen to fit the device
  5. 512^2 / 65536 positions / 128^2: position-sharded when more than
     one GPU is attached, chunked on one GPU otherwise
  6. Poisson-noised counts (1e6 photons per frame), Poisson against
     Gaussian model, 256^2 / 64^2 / 1024 positions
"""

import json
import pathlib
import sys

import jax
import jax.numpy as jnp
import numpy as np

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

from tikejax import Geometry  # noqa: E402
from tikejax.models import make_problem, relative_object_error  # noqa: E402
from tikejax.ops import adj_probe_raw, adj_raw, fwd_raw  # noqa: E402
from tikejax.solvers import run  # noqa: E402
from tikejax.utils import runtime  # noqa: E402

CARD = {}


def log(m):
    print(m, file=sys.stderr, flush=True)


def emit(obj):
    print(json.dumps({**obj, **CARD}), flush=True)


def _problem(g, key=0, **kw):
    _, scan, prb, data = jax.block_until_ready(
        make_problem(jax.random.PRNGKey(key), g, **kw))
    return scan, prb, data, jnp.ones(g.psi_shape, jnp.complex64)


def _timed_cg(g, piter, runner=run, problem=None, **kw):
    """Warm-up (compile) run, then one timed run; returns
    (seconds, iterations run, minf, residual) of the timed run."""
    scan, prb, data, psi0 = problem or _problem(g)
    jax.block_until_ready(runner(data, psi0, scan, prb, g, piter=piter,
                                 **kw))
    (_, _, m), dt = runtime.timed(runner, data, psi0, scan, prb, g,
                                  piter=piter, **kw)
    ran = max(int(m["iters_run"]), 1)
    return (dt, ran, np.asarray(m["minf"])[:ran],
            np.asarray(m["residual"])[:ran])


def _row(config, name, dt, ran, minf, res, **extra):
    return {"config": config, "name": name,
            "iters_per_sec": ran / dt, "iters_run": ran,
            "minf_first": float(minf[0]), "minf_last": float(minf[-1]),
            "residual_last": float(res[-1]),
            "pass": bool(np.all(np.isfinite(minf)) and minf[-1] < minf[0]),
            **extra}


def config1():
    g = Geometry(nz=256, n=256, nscan=100, ndet=64, nprb=64)
    psi, scan, prb, _ = make_problem(jax.random.PRNGKey(0), g)
    k1, k2 = jax.random.split(jax.random.PRNGKey(7))
    farp = jax.lax.complex(jax.random.normal(k1, g.farplane_shape),
                           jax.random.normal(k2, g.farplane_shape))
    c128 = lambda x: np.asarray(x).astype(np.complex128)  # noqa: E731
    lhs = np.vdot(c128(fwd_raw(psi, scan, prb, g.ndet)), c128(farp))
    rhs_o = np.vdot(c128(psi), c128(adj_raw(farp, scan, prb, g.nz, g.n)))
    rhs_p = np.vdot(c128(prb), c128(adj_probe_raw(farp, scan, psi,
                                                  g.nprb)))
    err_o = abs(lhs - rhs_o) / abs(lhs)
    err_p = abs(lhs - rhs_p) / abs(lhs)
    # float32 operators, float64 inner products: ~1e-7 expected.
    emit({"config": 1, "name": "adjoint_roundtrip_256_64_100",
          "object_adjoint_rel_err": err_o, "probe_adjoint_rel_err": err_p,
          "pass": bool(err_o < 1e-5 and err_p < 1e-5)})


def config2():
    g = Geometry(nz=256, n=256, nscan=1024, ndet=64, nprb=64)
    emit(_row(2, "gaussian_object_256_64_1k", *_timed_cg(g, 256)))


def config3():
    g = Geometry(nz=512, n=512, nscan=4096, ndet=128, nprb=128)
    scan, prb, data, psi0 = _problem(g)
    emit(_row(3, "joint_poisson_512_128_4k",
              *_timed_cg(g, 128, problem=(scan, prb * 0.9, data, psi0),
                         model="poisson", recover_prb=True)))


def config4():
    g = Geometry(nz=512, n=512, nscan=16384, ndet=128, nprb=128, nmodes=4)
    nch = runtime.nchunks_for(g, jax.devices()[0])
    emit(_row(4, "multimode4_16k_128", *_timed_cg(g, 48, nchunks=nch),
              nchunks=nch))


def config5():
    g = Geometry(nz=512, n=512, nscan=65536, ndet=128, nprb=128)
    ndev = len(jax.devices())
    if ndev < 2:
        nch = runtime.nchunks_for(g, jax.devices()[0])
        emit(_row(5, "positions_64k", *_timed_cg(g, 32, nchunks=nch),
                  devices=1, nchunks=nch))
        return
    from tikejax.parallel import make_mesh, run_sharded, shard_problem

    mesh = make_mesh()
    scan, prb, data, psi0 = _problem(g)
    data, scan = shard_problem(mesh, data, scan)

    def sharded(data, psi0, scan, prb, g, **kw):
        return run_sharded(data, psi0, scan, prb, g, mesh, **kw)

    emit(_row(5, "position_sharded_64k",
              *_timed_cg(g, 32, runner=sharded,
                         problem=(scan, prb, data, psi0)),
              devices=ndev))


def config6():
    """Noisy-data acceptance (SURVEY.md SS4 item 2): reconstruct
    Poisson-noised counts with the Poisson model, and with the Gaussian
    model as control; report the aligned object error."""
    g = Geometry(nz=256, n=256, nscan=1024, ndet=64, nprb=64)
    psi_true, scan, prb, data = make_problem(jax.random.PRNGKey(0), g,
                                             poisson_photons=1e6)
    psi0 = jnp.ones(g.psi_shape, jnp.complex64)
    out = {"config": 6, "name": "poisson_noisy_1e6photons_256_64_1k"}
    for model in ("poisson", "gaussian"):
        r, _, m = jax.block_until_ready(
            run(data, psi0, scan, prb, g, piter=256, model=model))
        ran = max(int(m["iters_run"]), 1)
        minf = np.asarray(m["minf"])[:ran]
        out[f"{model}_minf_last"] = float(minf[-1])
        out[f"{model}_object_err"] = relative_object_error(r, psi_true)
        out[f"{model}_converged"] = bool(minf[-1] < minf[0])
    out["pass"] = bool(out["poisson_object_err"] < 0.1 and
                       out["poisson_converged"] and
                       out["gaussian_converged"])
    emit(out)


def main():
    dev = runtime.require_gpu()[0]
    runtime.enable_compile_cache()
    name, power = runtime.parse_card_line(runtime.card_lines()[0])
    CARD.update(device=f"{dev.platform}:{dev.device_kind}",
                device_count=len(jax.devices()), card=name,
                power_limit=power)
    log(f"device: {dev.platform} {dev.device_kind} x{len(jax.devices())}; "
        f"card {name}, power limit {power}")
    for config in (config1, config2, config3, config4, config5, config6):
        config()


if __name__ == "__main__":
    main()
