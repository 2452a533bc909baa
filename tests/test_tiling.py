"""P3 object-domain tiling tests (SURVEY.md SS5): the object-sharded
run must match the single-device reconstruction while no device ever
holds the full object."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tikejax import Geometry
from tikejax.models import make_object, make_probe, simulate_intensities
from tikejax.parallel import make_obj_mesh, run_tiled
from tikejax.parallel.tiling import partition_problem
from tikejax.solvers import run


def tiling_problem(n_slabs, nz=96, n=96, nprb=24, ndet=32, rows_per=2,
                   cols=8, ntheta=1):
    """Scan grid with exactly rows_per * cols positions per slab."""
    g0 = Geometry(nz=nz, n=n, nscan=n_slabs * rows_per * cols, ndet=ndet,
                  nprb=nprb, ntheta=ntheta)
    owned = nz // n_slabs
    ys = []
    for d in range(n_slabs):
        lo = d * owned
        hi = min(lo + owned - 1, nz - nprb)
        ys.extend(np.linspace(lo, hi, rows_per))
    xs = np.linspace(0, n - nprb, cols)
    yy, xx = np.meshgrid(np.asarray(ys), xs, indexing="ij")
    grid = np.stack([yy.ravel(), xx.ravel()], -1).astype(np.float32)
    scan = jnp.broadcast_to(jnp.asarray(grid)[None],
                            (ntheta, g0.nscan, 2))
    psi_true = make_object(jax.random.PRNGKey(0), ntheta, nz, n,
                           jnp.complex64)
    prb = make_probe(ntheta, 1, nprb, jnp.complex64)
    data = simulate_intensities(psi_true, scan, prb, ndet)
    psi0 = jnp.ones(g0.psi_shape, jnp.complex64)
    return g0, psi_true, scan, prb, data, psi0


@pytest.mark.parametrize("n_slabs", [2, 3, 4])
def test_tiled_matches_single(n_slabs):
    g, psi_true, scan, prb, data, psi0 = tiling_problem(n_slabs)
    psi_1, _, m_1 = run(data, psi0, scan, prb, g, piter=10)
    mesh = make_obj_mesh(n_slabs)
    psi_t, _, m_t = run_tiled(data, psi0, scan, prb, g, mesh, piter=10)
    assert psi_t.shape == g.psi_shape
    np.testing.assert_allclose(np.asarray(m_1["minf"]),
                               np.asarray(m_t["minf"]), rtol=2e-4)
    assert float(jnp.max(jnp.abs(psi_1 - psi_t))) < 2e-3 * float(
        jnp.max(jnp.abs(psi_1)))


def test_tiled_joint_probe():
    g, psi_true, scan, prb, data, psi0 = tiling_problem(2, ntheta=1)
    mesh = make_obj_mesh(2)
    psi_1, prb_1, m_1 = run(data, psi0, scan, prb * 0.9, g, piter=8,
                            recover_prb=True)
    psi_t, prb_t, m_t = run_tiled(data, psi0, scan, prb * 0.9, g, mesh,
                                  piter=8, recover_prb=True)
    np.testing.assert_allclose(np.asarray(m_1["minf"]),
                               np.asarray(m_t["minf"]), rtol=1e-3)
    assert float(jnp.max(jnp.abs(prb_1 - prb_t))) < 2e-3 * float(
        jnp.max(jnp.abs(prb_1)))


def test_partition_validation():
    g, psi_true, scan, prb, data, psi0 = tiling_problem(2)
    with pytest.raises(ValueError, match="divide"):
        partition_problem(psi0, scan, data, g, 5)  # 96 % 5 != 0
    # slab too thin for the halo
    g2 = Geometry(nz=96, n=96, nscan=g.nscan, ndet=32, nprb=24)
    with pytest.raises(ValueError, match="slab height"):
        partition_problem(psi0, scan, data, g2, 8)  # owned 12 < 23


def test_partition_unequal_counts_padded():
    """Unequal per-slab owner counts are padded with sentinel dummies
    (scan row = -1, zero data) to the global maximum, so real jittered
    scans need no equal split."""
    g, psi_true, scan, prb, data, psi0 = tiling_problem(2)
    # unbalanced: push one slab-0 position into slab 1
    bad = np.asarray(scan).copy()
    bad[0, 0, 0] = 50.0
    slabs, scan_loc, data_p, owned = partition_problem(
        psi0, bad, data, g, 2)
    assert scan_loc.shape[2] == g.nscan // 2 + 1  # padded to the max
    n_valid = (scan_loc[..., 0] >= 0).sum()
    assert n_valid == g.nscan  # every real position owned exactly once
    # dummies carry zero data
    dummy = scan_loc[..., 0] < 0
    assert (data_p[dummy] == 0).all()


@pytest.mark.parametrize("kern", ["xla", "auto"])
def test_tiled_jittered_scan_matches_single(kern):
    """run_tiled on a realistic jittered raster grid (unequal owner
    counts) matches the single-device run."""
    from tikejax.models import raster_scan, simulate_intensities

    g = Geometry(nz=96, n=96, nscan=30, ndet=32, nprb=24)
    scan = raster_scan(jax.random.PRNGKey(3), g, jitter=3.0)
    # Confirm the jitter actually unbalances the owner counts.
    owner = np.floor(np.asarray(scan)[..., 0]).astype(int) // (g.nz // 2)
    counts = [(owner == d).sum() for d in range(2)]
    assert counts[0] != counts[1], f"grid accidentally balanced: {counts}"
    psi_true = make_object(jax.random.PRNGKey(0), 1, g.nz, g.n,
                           jnp.complex64)
    prb = make_probe(1, 1, g.nprb, jnp.complex64)
    data = simulate_intensities(psi_true, scan, prb, g.ndet)
    psi0 = jnp.ones(g.psi_shape, jnp.complex64)

    psi_1, _, m_1 = run(data, psi0, scan, prb, g, piter=10, kernel=kern)
    psi_t, _, m_t = run_tiled(data, psi0, scan, prb, g, make_obj_mesh(2),
                              piter=10, kernel=kern)
    np.testing.assert_allclose(np.asarray(m_1["minf"]),
                               np.asarray(m_t["minf"]), rtol=2e-4)
    assert float(jnp.max(jnp.abs(psi_1 - psi_t))) < 2e-3 * float(
        jnp.max(jnp.abs(psi_1)))


def test_partition_roundtrip():
    g, psi_true, scan, prb, data, psi0 = tiling_problem(3)
    slabs, scan_loc, data_p, owned = partition_problem(
        psi_true, scan, data, g, 3)
    from tikejax.parallel.tiling import stitch

    full = np.asarray(stitch(jnp.asarray(slabs), owned))
    np.testing.assert_array_equal(full, np.asarray(psi_true))
    # halo rows replicate the next slab's top rows
    halo = g.nprb - 1
    np.testing.assert_array_equal(slabs[0, :, owned:],
                                  slabs[1, :, :halo])


@pytest.mark.parametrize("n_slabs,scan_shards", [(2, 4), (4, 2)])
def test_tiled_composed_with_scan_sharding(n_slabs, scan_shards):
    """P3 x P1 composition: a 2-D ('obj', 'scan') mesh shards each
    slab's positions across the scan axis; the result must match the
    single-device reconstruction (the CG core psums the object gradient
    over 'scan' before the halo exchange over 'obj')."""
    from tikejax.parallel import make_obj_scan_mesh

    g, psi_true, scan, prb, data, psi0 = tiling_problem(n_slabs,
                                                        rows_per=2,
                                                        cols=7)
    psi_1, _, m_1 = run(data, psi0, scan, prb, g, piter=10)
    mesh = make_obj_scan_mesh(n_slabs, scan_shards)
    psi_t, _, m_t = run_tiled(data, psi0, scan, prb, g, mesh, piter=10)
    assert psi_t.shape == g.psi_shape
    np.testing.assert_allclose(np.asarray(m_1["minf"]),
                               np.asarray(m_t["minf"]), rtol=2e-4)
    assert float(jnp.max(jnp.abs(psi_1 - psi_t))) < 2e-3 * float(
        jnp.max(jnp.abs(psi_1)))


def test_tiled_composed_joint():
    """Composition under joint probe recovery: probe gradients psum over
    BOTH mesh axes."""
    from tikejax.parallel import make_obj_scan_mesh

    g, psi_true, scan, prb, data, psi0 = tiling_problem(2, cols=7)
    psi_1, prb_1, m_1 = run(data, psi0, scan, prb * 0.9, g, piter=6,
                            recover_prb=True)
    mesh = make_obj_scan_mesh(2, 4)
    psi_t, prb_t, m_t = run_tiled(data, psi0, scan, prb * 0.9, g, mesh,
                                  piter=6, recover_prb=True)
    np.testing.assert_allclose(np.asarray(m_1["minf"]),
                               np.asarray(m_t["minf"]), rtol=1e-3)
    assert float(jnp.max(jnp.abs(prb_1 - prb_t))) < 2e-3 * float(
        jnp.max(jnp.abs(prb_1)))


def test_tiled_full_three_axis_mesh():
    """P2 x P3 x P1: a 3-D ('theta', 'obj', 'scan') mesh shards angles,
    object slabs, and positions simultaneously -- every parallel axis
    the framework offers, composed in one program."""
    from tikejax.parallel import make_full_mesh

    g, psi_true, scan, prb, data, psi0 = tiling_problem(2, cols=7,
                                                        ntheta=2)
    psi_1, _, m_1 = run(data, psi0, scan, prb, g, piter=8)
    mesh = make_full_mesh(2, 2, 2)
    psi_t, _, m_t = run_tiled(data, psi0, scan, prb, g, mesh, piter=8)
    assert psi_t.shape == g.psi_shape
    np.testing.assert_allclose(np.asarray(m_1["minf"]),
                               np.asarray(m_t["minf"]), rtol=2e-4)
    assert float(jnp.max(jnp.abs(psi_1 - psi_t))) < 2e-3 * float(
        jnp.max(jnp.abs(psi_1)))


def test_tiled_carry_state_rejected():
    g, psi_true, scan, prb, data, psi0 = tiling_problem(2)
    with pytest.raises(ValueError, match="carry_state"):
        run_tiled(data, psi0, scan, prb, g, make_obj_mesh(2), piter=2,
                  carry_state=True)
