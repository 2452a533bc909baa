"""End-to-end reconstruction demo: simulate, reconstruct, report.

Usage:
  python examples/reconstruct.py [--size 256] [--nscan 1024] [--piter 64]
      [--model gaussian|poisson] [--recover-prb] [--nmodes 1]
      [--checkpoint out.npz]
  python examples/reconstruct.py --target 1e-6   # deep-residual driver
      (solvers.reconstruct: stage 1 to its floor, then split-operator
      refinement + Anderson mixing; --piter is ignored in this mode)

Equivalent of the reference's README usage example / rec_test script
(SURVEY.md SS4 item 2). Runs on the default JAX device; times are taken
with ``jax.block_until_ready`` and include compilation.
"""

import argparse
import pathlib
import sys
import time

import jax
import jax.numpy as jnp

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

from tikejax import Geometry  # noqa: E402
from tikejax.models import make_problem  # noqa: E402
from tikejax.solvers import reconstruct, run  # noqa: E402
from tikejax.utils import (checkpoint, cones, runtime, scalar,  # noqa: E402
                           to_host)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--size", type=int, default=256)
    ap.add_argument("--nscan", type=int, default=1024)
    ap.add_argument("--ndet", type=int, default=64)
    ap.add_argument("--nprb", type=int, default=64)
    ap.add_argument("--nmodes", type=int, default=1)
    ap.add_argument("--piter", type=int, default=64)
    ap.add_argument("--model", default="gaussian",
                    choices=["gaussian", "poisson"])
    ap.add_argument("--recover-prb", action="store_true")
    ap.add_argument("--nchunks", type=int, default=1)
    ap.add_argument("--photons", type=float, default=None,
                    help="add Poisson shot noise at this photon budget")
    ap.add_argument("--target", type=float, default=None,
                    help="reconstruct to this relative residual via the "
                         "deep-residual driver instead of a fixed piter")
    ap.add_argument("--checkpoint", default=None)
    args = ap.parse_args()
    runtime.enable_compile_cache()

    g = Geometry(nz=args.size, n=args.size, nscan=args.nscan, ndet=args.ndet,
                 nprb=args.nprb, nmodes=args.nmodes)
    print(f"device: {jax.devices()[0].device_kind}; geometry: {g}")

    psi_true, scan, prb, data = make_problem(
        jax.random.PRNGKey(0), g, poisson_photons=args.photons)
    jax.block_until_ready(data)

    t0 = time.time()
    if args.target is not None:
        psi, prb_out, stages = reconstruct(
            data, cones(g.psi_shape), scan, prb, g,
            target_residual=args.target, model=args.model,
            recover_prb=args.recover_prb, nchunks=args.nchunks)
        jax.block_until_ready(psi)
        dt = time.time() - t0
        ran = 0
        for name, m in stages:
            k = max(int(to_host(m["iters_run"])), 1)
            res = float(to_host(m["residual"])[k - 1])
            print(f"  stage {name:>14s}: {k:4d} iters, residual {res:.3e}")
            ran += k
            metrics = m
        print(f"{ran} iters / {len(stages)} stages in {dt:.2f}s "
              f"(incl. compile)")
    else:
        psi, prb_out, metrics = run(
            data, cones(g.psi_shape), scan, prb, g, piter=args.piter,
            model=args.model, recover_prb=args.recover_prb,
            nchunks=args.nchunks)
        jax.block_until_ready(psi)
        dt = time.time() - t0

        # stop_on_stall / target_residual may exit early: truncate the
        # metric arrays at the executed iteration count.
        ran = max(int(to_host(metrics["iters_run"])), 1)
        minf = to_host(metrics["minf"])[:ran]
        gamma = to_host(metrics["gamma"])[:ran]
        print(f"{ran} iters in {dt:.2f}s "
              f"({ran / dt:.1f} iters/s incl. compile)")
        for i in range(0, ran, max(1, ran // 8)):
            print(f"  iter {i:4d}: minf={minf[i]:.6e} gamma={gamma[i]:.3f}")
        print(f"  final   : minf={minf[-1]:.6e}")

    # phase-aligned relative error against ground truth (interior)
    m = g.n // 8
    a = psi[..., m:-m, m:-m].ravel()
    b = psi_true[..., m:-m, m:-m].ravel()
    phase = jnp.vdot(a, b)
    phase = phase / jnp.abs(phase)
    err = scalar(jnp.linalg.norm(a * phase - b) / jnp.linalg.norm(b))
    print(f"  object rel err vs truth (interior, phase-aligned): {err:.4f}")

    if args.checkpoint:
        checkpoint.save(args.checkpoint,
                        {"psi": psi, "prb": prb_out, "metrics": metrics})
        print(f"saved state to {args.checkpoint}")


if __name__ == "__main__":
    main()
