"""Multi-device dry run on a virtual CPU device mesh.

Validates the multi-device sharding path by executing one full
position-sharded CG step on ``n`` virtual CPU devices (SURVEY.md SS4:
the CPU fake mesh is the multi-node-without-a-cluster mechanism).

The dry run must never touch an accelerator: the calling process may
hold one (a JAX process reserves most of a GPU's memory when it first
uses it, so a second process on the same card fails), and the virtual
device count must be set before the backend starts. Therefore:

* ``main`` force-selects the CPU platform via ``jax.config.update``
  AFTER importing jax and BEFORE any backend touch;
* ``__graft_entry__.dryrun_multichip`` never runs this in-process -- it
  re-execs this module in a clean subprocess pinned to
  ``JAX_PLATFORMS=cpu`` whose ``XLA_FLAGS`` carry
  ``--xla_force_host_platform_device_count=n`` from process start.
"""

from __future__ import annotations


def run_dryrun(n_devices: int) -> None:
    """One sharded CG training step on an n-device mesh, tiny shapes.

    Uses a 2-D ('theta', 'scan') mesh when n_devices is even (exercising
    both parallelism axes: P2 angle sharding x P1 position sharding,
    SURVEY.md SS5), else a 1-D scan mesh.
    """
    import jax
    import jax.numpy as jnp

    from tikejax import Geometry
    from tikejax.models import make_problem
    from tikejax.parallel import make_mesh, run_sharded, shard_problem
    from tikejax.utils import cones

    devs = jax.devices()
    if len(devs) < n_devices:
        raise RuntimeError(
            f"need {n_devices} devices, found {len(devs)} "
            f"({devs[0].platform}); was xla_force_host_platform_device_count "
            "set before process start?")

    if n_devices % 2 == 0 and n_devices > 1:
        ntheta, mesh_shape = 2, (2, n_devices // 2)
    else:
        ntheta, mesh_shape = 1, None
    g = Geometry(ntheta=ntheta, nz=64, n=64, nscan=8 * n_devices,
                 ndet=16, nprb=12, nmodes=2)

    psi_true, scan, prb, data = make_problem(jax.random.PRNGKey(0), g)
    if mesh_shape is not None:
        mesh = make_mesh(mesh_shape, devices=devs[:n_devices])
    else:
        mesh = make_mesh(n_devices)
    data_s, scan_s = shard_problem(mesh, data, scan)
    psi0 = cones(g.psi_shape)
    psi, prb_out, metrics = run_sharded(
        data_s, psi0, scan_s, prb, g, mesh, piter=1, recover_prb=True)
    jax.block_until_ready((psi, prb_out, metrics))
    assert psi.shape == g.psi_shape
    assert bool(jnp.isfinite(metrics["minf"][0]))

    if n_devices >= 2:
        # P3 object-domain tiling: one step on a 2-slab ('obj',) mesh
        # (halo ppermute exchange + owner-partitioned positions).
        import numpy as np

        from tikejax.parallel import make_obj_mesh, run_tiled

        g3 = Geometry(nz=64, n=64, nscan=16, ndet=16, nprb=12)
        psi3, _, prb3, _ = make_problem(jax.random.PRNGKey(1), g3)
        # balanced grid: equal positions per slab (tiling requirement)
        ys = np.concatenate([np.linspace(0, 31, 4),
                             np.linspace(32, 52, 4)])
        xs = np.linspace(0, 52, 2)
        yy, xx = np.meshgrid(ys, xs, indexing="ij")
        scan3 = jnp.asarray(
            np.stack([yy.ravel(), xx.ravel()], -1).astype(np.float32)
        )[None]
        from tikejax.models import simulate_intensities

        data3 = simulate_intensities(psi3, scan3, prb3, g3.ndet)
        psi_t, _, m3 = run_tiled(data3, cones(g3.psi_shape), scan3, prb3,
                                 g3, make_obj_mesh(2), piter=1)
        jax.block_until_ready((psi_t, m3))
        assert psi_t.shape == g3.psi_shape
        assert bool(jnp.isfinite(m3["minf"][0]))

    if n_devices >= 4:
        # P3 x P1 composition: one step on a 2-D ('obj', 'scan') mesh
        # (slab gradient psum over 'scan' before the halo exchange).
        from tikejax.parallel import make_obj_scan_mesh

        mesh_c = make_obj_scan_mesh(2, n_devices // 2 if n_devices < 8
                                    else 4)
        psi_c, _, mc = run_tiled(data3, cones(g3.psi_shape), scan3, prb3,
                                 g3, mesh_c, piter=1)
        jax.block_until_ready((psi_c, mc))
        assert psi_c.shape == g3.psi_shape
        assert bool(jnp.isfinite(mc["minf"][0]))

    if n_devices >= 8:
        # Full 3-axis composition: one step on a ('theta', 'obj',
        # 'scan') 2x2x2 mesh -- every parallel axis in one program.
        import dataclasses

        from tikejax.parallel import make_full_mesh

        g4 = dataclasses.replace(g3, ntheta=2)
        psi4 = jnp.concatenate([psi3, psi3])
        prb4 = jnp.concatenate([prb3, prb3])
        scan4 = jnp.concatenate([scan3, scan3])
        data4 = simulate_intensities(psi4, scan4, prb4, g4.ndet)
        psi_f, _, mf = run_tiled(data4, cones(g4.psi_shape), scan4, prb4,
                                 g4, make_full_mesh(2, 2, 2), piter=1)
        jax.block_until_ready((psi_f, mf))
        assert psi_f.shape == g4.psi_shape
        assert bool(jnp.isfinite(mf["minf"][0]))


def main(n_devices: int) -> None:
    """Subprocess entry: pin the CPU platform, then run the dry run."""
    import jax

    # Pin the CPU platform whatever the environment selects; a config
    # update works until the first backend query.
    jax.config.update("jax_platforms", "cpu")
    run_dryrun(n_devices)
    print(f"dryrun_multichip({n_devices}): OK", flush=True)


if __name__ == "__main__":
    import sys

    main(int(sys.argv[1]) if len(sys.argv) > 1 else 8)
