"""Headline benchmark on one GPU: CG iterations per second and wall time
to a relative residual on the 512^2-object / 16384-position / 128^2
configuration (BASELINE.json metric), Gaussian model.

Usage:
  python bench.py [--piter 200] [--windows 3]

Prints exactly ONE JSON line to stdout, naming the device, the card and
its power limit. Every time is taken with ``jax.block_until_ready``;
compilation is reported apart, as set-up time. Without a GPU the script
exits non-zero.
"""

import argparse
import json
import math
import sys

import jax
import jax.numpy as jnp
import numpy as np

from tikejax import Geometry
from tikejax.models import make_problem
from tikejax.solvers import reconstruct, run
from tikejax.solvers.cg import CGOptions
from tikejax.utils import runtime
from tikejax.utils.runtime import timed


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def ls_evals_per_iter(gammas, step0=1.0, shrink=0.5,
                      growth=CGOptions.step_growth, max_halvings=16):
    """APPROXIMATE line-search objective evaluations per iteration,
    recovered from the accepted steps (gamma_i = gamma0_i * shrink^k
    means k + 1 evaluations; a failed search, gamma = 0, spent
    max_halvings + 1). With the default 'interp' search accepted steps
    may lie off the halving grid, so the count is +-1 on iterations
    that backtracked."""
    evals = 0
    gamma_prev = 0.0
    for gam in gammas:
        gamma0 = step0 if gamma_prev <= 0 else min(step0,
                                                   growth * gamma_prev)
        if gam <= 0:
            halvings = max_halvings
        else:
            halvings = max(0, round(math.log(gam / gamma0, shrink)))
        evals += halvings + 1
        gamma_prev = float(gam)
    return evals / max(len(gammas), 1)


def time_to_target(data, psi0, scan, prb, g, target):
    (_, _, stages), dt = timed(reconstruct, data, psi0, scan, prb, g,
                                 target_residual=target)
    iters = sum(int(m["iters_run"]) for _, m in stages)
    return dt, iters, len(stages)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--piter", type=int, default=200,
                    help="iterations per timed window")
    ap.add_argument("--windows", type=int, default=3)
    args = ap.parse_args(argv)
    dev = runtime.require_gpu()[0]
    runtime.enable_compile_cache()
    card_name, power_limit = runtime.parse_card_line(runtime.card_lines()[0])
    log(f"device: {dev.platform} {dev.device_kind}; card {card_name}, "
        f"power limit {power_limit}")

    g = Geometry(nz=512, n=512, nscan=16384, ndet=128, nprb=128)
    _, scan, prb, data = jax.block_until_ready(
        make_problem(jax.random.PRNGKey(0), g))
    psi0 = jnp.ones(g.psi_shape, jnp.complex64)

    (_, _, m), t_first = timed(run, data, psi0, scan, prb, g,
                               piter=args.piter)
    log(f"compile + first run: {t_first:.2f} s")
    rates = []
    for _ in range(args.windows):
        (_, _, m), dt = timed(run, data, psi0, scan, prb, g,
                              piter=args.piter)
        rates.append(int(m["iters_run"]) / dt)
        log(f"window: {int(m['iters_run'])} iters in {dt:.3f} s "
            f"({rates[-1]:.2f} iters/s)")
    rate = float(np.median(rates))
    ran = int(m["iters_run"])
    minf = np.asarray(m["minf"])[:ran]
    res = np.asarray(m["residual"])[:ran]
    evals = ls_evals_per_iter(np.asarray(m["gamma"])[:ran])

    # Time to residual through the deep driver: the first call of each
    # target compiles, the second is timed.
    deep = {}
    for target in (1e-4, 1e-6):
        time_to_target(data, psi0, scan, prb, g, target)
        dt, iters, nstages = time_to_target(data, psi0, scan, prb, g,
                                            target)
        deep[target] = (dt, iters, nstages)
        log(f"reconstruct to {target:g}: {dt:.3f} s, {iters} iters, "
            f"{nstages} stages")

    print(json.dumps({
        "metric": "cg_iters_per_sec_512obj_16kpos",
        "value": rate,
        "unit": "iters/s",
        "config": "512^2 object, 16384 positions, 128^2 probe/det, "
                  "gaussian, kernel 'auto' (xla)",
        "device": f"{dev.platform}:{dev.device_kind}",
        "device_count": len(jax.devices()),
        "card": card_name,
        "power_limit": power_limit,
        "window_rates": rates,
        "spread": (max(rates) - min(rates)) / rate,
        "ms_per_iter": 1e3 / rate,
        "compile_and_first_run_s": t_first,
        "peak_device_gib": dev.memory_stats()["peak_bytes_in_use"] / 2**30,
        "minf_first_iter": float(minf[0]),
        "minf_last_iter": float(minf[-1]),
        "rel_residual_last_iter": float(res[-1]),
        "ls_evals_per_iter": evals,
        "time_to_1e-4_residual_s": deep[1e-4][0],
        "time_to_1e-4_iters": deep[1e-4][1],
        "time_to_1e-6_residual_s": deep[1e-6][0],
        "time_to_1e-6_iters": deep[1e-6][1],
    }), flush=True)


if __name__ == "__main__":
    main()
