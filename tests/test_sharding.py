"""Multi-device tests on the virtual 8-device CPU mesh.

Multi-node tests without a cluster (SURVEY.md SS4):
``xla_force_host_platform_device_count=8`` is set in conftest. The
load-bearing check is BASELINE.json config 5's acceptance: the
position-sharded run must match the single-device result.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tikejax import Geometry
from tikejax.models import make_problem
from tikejax.parallel import make_mesh, run_sharded, shard_problem
from tikejax.solvers import run


@pytest.fixture(scope="module")
def problem():
    g = Geometry(nz=96, n=96, nscan=64, ndet=32, nprb=24)
    psi_true, scan, prb, data = make_problem(jax.random.PRNGKey(3), g,
                                             dtype=jnp.complex64)
    psi0 = jnp.ones(g.psi_shape, jnp.complex64)
    return g, psi_true, scan, prb, data, psi0


def test_devices_available():
    assert len(jax.devices()) == 8, (
        "conftest must provide 8 virtual CPU devices")


@pytest.mark.parametrize("ndev", [2, 8])
def test_sharded_matches_single(problem, ndev):
    g, psi_true, scan, prb, data, psi0 = problem
    psi_1, _, m_1 = run(data, psi0, scan, prb, g, piter=12)
    mesh = make_mesh(ndev)
    data_s, scan_s = shard_problem(mesh, data, scan)
    psi_n, _, m_n = run_sharded(data_s, psi0, scan_s, prb, g, mesh, piter=12)
    np.testing.assert_allclose(np.asarray(m_1["minf"]),
                               np.asarray(m_n["minf"]), rtol=2e-4)
    assert float(jnp.max(jnp.abs(psi_1 - psi_n))) < 2e-3 * float(
        jnp.max(jnp.abs(psi_1)))


def test_sharded_uneven_nscan(problem):
    """nscan NOT divisible by the mesh axis: the tail shard is padded
    with sentinel-masked dummies and the result still matches the
    single-device run."""
    g = Geometry(nz=96, n=96, nscan=61, ndet=32, nprb=24)
    psi_true, scan, prb, data = make_problem(jax.random.PRNGKey(5), g,
                                             dtype=jnp.complex64)
    psi0 = jnp.ones(g.psi_shape, jnp.complex64)
    psi_1, _, m_1 = run(data, psi0, scan, prb, g, piter=10)
    mesh = make_mesh(4)  # 61 % 4 != 0
    psi_n, _, m_n = run_sharded(data, psi0, scan, prb, g, mesh, piter=10)
    np.testing.assert_allclose(np.asarray(m_1["minf"]),
                               np.asarray(m_n["minf"]), rtol=2e-4)
    assert float(jnp.max(jnp.abs(psi_1 - psi_n))) < 2e-3 * float(
        jnp.max(jnp.abs(psi_1)))


def test_sharded_joint_multimode_chunked(problem):
    """Sharding composes with probe recovery, multi-mode, minibatching."""
    g = Geometry(nz=96, n=96, nscan=64, ndet=32, nprb=24, nmodes=2)
    psi_true, scan, prb, data = make_problem(jax.random.PRNGKey(4), g,
                                             dtype=jnp.complex64)
    psi0 = jnp.ones(g.psi_shape, jnp.complex64)
    mesh = make_mesh(4)
    data_s, scan_s = shard_problem(mesh, data, scan)
    psi, prb_o, m = run_sharded(data_s, psi0, scan_s, prb * 0.9, g, mesh,
                                piter=8, recover_prb=True, nchunks=2,
                                model="poisson")
    minf = np.asarray(m["minf"])
    assert minf[-1] < minf[0]
    assert not np.isnan(minf).any()


def test_sharded_lbfgs_matches_single(problem):
    """The L-BFGS two-loop recursion is sharding-consistent: every
    inner product psums over the mesh, so the sharded direction (and
    hence the whole trajectory) matches the single-device run."""
    g, psi_true, scan, prb, data, psi0 = problem
    psi_1, _, m_1 = run(data, psi0, scan, prb, g, piter=12,
                        direction="lbfgs:4")
    mesh = make_mesh(4)
    data_s, scan_s = shard_problem(mesh, data, scan)
    psi_n, _, m_n = run_sharded(data_s, psi0, scan_s, prb, g, mesh,
                                piter=12, direction="lbfgs:4")
    np.testing.assert_allclose(np.asarray(m_1["minf"]),
                               np.asarray(m_n["minf"]), rtol=2e-4)
    assert float(jnp.max(jnp.abs(psi_1 - psi_n))) < 2e-3 * float(
        jnp.max(jnp.abs(psi_1)))


def test_sharded_lbfgs_ring_carry_matches_single(problem):
    """The 8-tuple carry_lbfgs cg_state threads through run_sharded
    (the ring entries get their own in_specs): a sharded chained pair
    of runs matches the single-device chained pair."""
    g, psi_true, scan, prb, data, psi0 = problem
    kw = dict(direction="lbfgs:3", carry_state=True, carry_lbfgs=True,
              piter=6)
    psi_a, _, m_a = run(data, psi0, scan, prb, g, **kw)
    psi_b, _, m_b = run(data, psi_a, scan, prb, g,
                        cg_init=m_a["cg_state"], **kw)
    mesh = make_mesh(4)
    data_s, scan_s = shard_problem(mesh, data, scan)
    psi_as, _, m_as = run_sharded(data_s, psi0, scan_s, prb, g, mesh,
                                  **kw)
    assert len(m_as["cg_state"]) == 8
    psi_bs, _, m_bs = run_sharded(data_s, psi_as, scan_s, prb, g, mesh,
                                  cg_init=m_as["cg_state"], **kw)
    np.testing.assert_allclose(np.asarray(m_b["minf"]),
                               np.asarray(m_bs["minf"]), rtol=2e-4)
    assert float(jnp.max(jnp.abs(psi_b - psi_bs))) < 2e-3 * float(
        jnp.max(jnp.abs(psi_b)))


@pytest.mark.parametrize("tshards,sshards", [(2, 4), (4, 2), (2, 1)])
def test_theta_sharded_matches_single(tshards, sshards):
    """P2 angle-axis sharding (SURVEY.md SS5): a 2-D ('theta', 'scan')
    mesh must reproduce the single-device multi-angle run -- psi/prb stay
    per-angle-sharded, scalar statistics are globally psum-ed."""
    g = Geometry(ntheta=4, nz=96, n=96, nscan=32, ndet=32, nprb=24)
    psi_true, scan, prb, data = make_problem(jax.random.PRNGKey(5), g,
                                             dtype=jnp.complex64)
    psi0 = jnp.ones(g.psi_shape, jnp.complex64)
    psi_1, _, m_1 = run(data, psi0, scan, prb, g, piter=10)
    mesh = make_mesh((tshards, sshards))
    data_s, scan_s = shard_problem(mesh, data, scan)
    psi_n, _, m_n = run_sharded(data_s, psi0, scan_s, prb, g, mesh,
                                piter=10)
    np.testing.assert_allclose(np.asarray(m_1["minf"]),
                               np.asarray(m_n["minf"]), rtol=2e-4)
    assert float(jnp.max(jnp.abs(psi_1 - psi_n))) < 2e-3 * float(
        jnp.max(jnp.abs(psi_1)))


def test_theta_sharded_joint_probe():
    """Theta sharding composes with joint probe recovery (probe gradients
    and their Dai-Yuan/line-search scalars stay consistent per angle)."""
    g = Geometry(ntheta=2, nz=96, n=96, nscan=32, ndet=32, nprb=24,
                 nmodes=2)
    psi_true, scan, prb, data = make_problem(jax.random.PRNGKey(6), g,
                                             dtype=jnp.complex64)
    psi0 = jnp.ones(g.psi_shape, jnp.complex64)
    psi_1, prb_1, m_1 = run(data, psi0, scan, prb * 0.9, g, piter=8,
                            recover_prb=True)
    mesh = make_mesh((2, 4))
    data_s, scan_s = shard_problem(mesh, data, scan)
    psi_n, prb_n, m_n = run_sharded(data_s, psi0, scan_s, prb * 0.9, g,
                                    mesh, piter=8, recover_prb=True)
    np.testing.assert_allclose(np.asarray(m_1["minf"]),
                               np.asarray(m_n["minf"]), rtol=2e-4)
    assert float(jnp.max(jnp.abs(prb_1 - prb_n))) < 2e-3 * float(
        jnp.max(jnp.abs(prb_1)))


def test_theta_sharded_validation():
    g = Geometry(ntheta=3, nz=96, n=96, nscan=32, ndet=32, nprb=24)
    psi_true, scan, prb, data = make_problem(jax.random.PRNGKey(7), g,
                                             dtype=jnp.complex64)
    psi0 = jnp.ones(g.psi_shape, jnp.complex64)
    mesh = make_mesh((2, 4))  # ntheta=3 % 2 != 0
    with pytest.raises(ValueError, match="divisible"):
        run_sharded(data, psi0, scan, prb, g, mesh)


def test_sharded_indivisible_nscan_pads(problem):
    """An nscan that does not divide by the mesh axis no longer raises:
    the tail is sentinel-padded and the result matches single-device."""
    g, psi_true, scan, prb, data, psi0 = problem
    mesh = make_mesh(3)  # 64 % 3 != 0
    psi_1, _, m_1 = run(data, psi0, scan, prb, g, piter=8)
    psi_n, _, m_n = run_sharded(data, psi0, scan, prb, g, mesh, piter=8)
    np.testing.assert_allclose(np.asarray(m_1["minf"]),
                               np.asarray(m_n["minf"]), rtol=2e-4)


def test_pad_scan_problem_and_fwd_sharded():
    """pad_scan_problem appends sentinel positions + zero frames so the
    scan axis divides the mesh; fwd_sharded matches the single-device
    forward on the real positions and emits zero frames for sentinels."""
    import numpy as np

    from tikejax.models import make_problem
    from tikejax.ops.diffraction import fwd_raw
    from tikejax.parallel import make_mesh
    from tikejax.parallel.sharding import fwd_sharded, pad_scan_problem

    g = Geometry(nz=64, n=64, nscan=10, ndet=16, nprb=16)
    psi, scan, prb, data = make_problem(jax.random.PRNGKey(0), g)
    d2, s2, g2 = pad_scan_problem(data, scan, g, 4)
    assert g2.nscan == 12 and s2.shape[1] == 12 and d2.shape[1] == 12
    assert np.all(np.asarray(s2)[:, 10:, 0] == -1)
    assert np.all(np.asarray(d2)[:, 10:] == 0)

    mesh = make_mesh(4)
    f_sh = fwd_sharded(psi, s2, prb, g.ndet, "xla", mesh)
    f_ref = fwd_raw(psi, scan, prb, g.ndet, "xla")
    np.testing.assert_allclose(np.asarray(f_sh[:, :10]),
                               np.asarray(f_ref), atol=1e-5)
    np.testing.assert_array_equal(np.asarray(jnp.abs(f_sh[:, 10:])), 0.0)
