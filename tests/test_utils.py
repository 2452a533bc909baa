"""Tests for checkpointing, host IO, and the reference-compat facade."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tikejax import Geometry
from tikejax.models import make_problem
from tikejax.solvers import run
from tikejax.utils import checkpoint, cfull, cones, czeros, to_device, to_host


def test_hostio_complex_roundtrip():
    rng = np.random.default_rng(0)
    x = (rng.normal(size=(3, 5)) + 1j * rng.normal(size=(3, 5))).astype(
        np.complex64)
    np.testing.assert_array_equal(to_host(to_device(x)), x)


def test_hostio_real_roundtrip():
    x = np.arange(12, dtype=np.float32).reshape(3, 4)
    np.testing.assert_array_equal(to_host(to_device(x)), x)


def test_hostio_numpy_scalar_passthrough():
    """Numpy scalars never take the device round-trip: without x64,
    jnp.asarray(np.float64(...)) silently truncates to 32 bits, which
    would corrupt the split-driver checkpoint's float64 target."""
    t = np.float64(2e-6)
    assert float(to_host(t)) == 2e-6
    assert to_host(t).dtype == np.float64
    i = np.int64(2**40 + 3)
    assert int(to_host(i)) == 2**40 + 3


def test_complex_constructors():
    a = cones((2, 3))
    assert a.dtype == jnp.complex64
    np.testing.assert_array_equal(to_host(a), np.ones((2, 3), np.complex64))
    b = cfull((2,), 1 - 2j)
    np.testing.assert_array_equal(to_host(b),
                                  np.full((2,), 1 - 2j, np.complex64))
    assert to_host(czeros((1,))).sum() == 0


def test_checkpoint_roundtrip(tmp_path):
    tree = {
        "psi": jnp.ones((2, 4, 4), jnp.complex64) * (1 + 2j),
        "metrics": {
            "minf": jnp.arange(5, dtype=jnp.float32),
            "gamma": jnp.zeros((5,), jnp.float64),
        },
        "iter": np.int64(7),
    }
    path = str(tmp_path / "state.npz")
    checkpoint.save(path, tree)
    loaded = checkpoint.load(path)
    np.testing.assert_array_equal(loaded["psi"], np.asarray(tree["psi"]))
    np.testing.assert_array_equal(loaded["metrics"]["minf"],
                                  np.arange(5, dtype=np.float32))
    assert loaded["iter"] == 7
    on_dev = checkpoint.load(path, device=True)
    assert on_dev["psi"].dtype == jnp.complex64


def test_checkpoint_resume_cg(rng, tmp_path):
    """Reconstruct 8 iters, checkpoint, resume 8 more: final objective must
    be at least as good as 16 straight iterations within tolerance."""
    from tikejax.solvers import run

    g = Geometry(nz=64, n=64, nscan=36, ndet=32, nprb=20)
    psi_true, scan, prb, data = make_problem(rng, g, dtype=jnp.complex64)
    psi0 = jnp.ones(g.psi_shape, jnp.complex64)

    psi_a, prb_a, m_a = run(data, psi0, scan, prb, g, piter=8)
    path = str(tmp_path / "ck.npz")
    checkpoint.save(path, {"psi": psi_a, "prb": prb_a})
    st = checkpoint.load(path, device=True)
    psi_b, _, m_b = run(data, st["psi"], scan, st["prb"], g, piter=8)

    psi_c, _, m_c = run(data, psi0, scan, prb, g, piter=16)
    # Resumed run restarts the CG direction so it may differ slightly, but
    # must keep descending and land in the same ballpark.
    assert m_b["minf"][-1] < m_a["minf"][-1]
    assert m_b["minf"][-1] < 2.0 * m_c["minf"][-1] + 1e-3


def test_checkpoint_resume_cg_exact(rng, tmp_path):
    """With carry_state, a mid-CG checkpoint resumes the EXACT Dai-Yuan
    trajectory (the plain resume restarts the direction and only lands
    in the same ballpark -- test_checkpoint_resume_cg above)."""
    g = Geometry(nz=64, n=64, nscan=36, ndet=32, nprb=20)
    psi_true, scan, prb, data = make_problem(rng, g, dtype=jnp.complex64)
    psi0 = jnp.ones(g.psi_shape, jnp.complex64)

    psi_a, prb_a, m_a = run(data, psi0, scan, prb, g, piter=8,
                            carry_state=True)
    d, gr, gam, gam0 = m_a["cg_state"]
    path = str(tmp_path / "ck_exact.npz")
    checkpoint.save(path, {"psi": psi_a, "prb": prb_a,
                           "cg": {"d": d, "g": gr, "gamma": gam,
                                  "gamma0": gam0}})
    st = checkpoint.load(path, device=True)
    cg_init = (st["cg"]["d"], st["cg"]["g"], st["cg"]["gamma"],
               st["cg"]["gamma0"])
    _, _, m_b = run(data, st["psi"], scan, st["prb"], g, piter=8,
                    cg_init=cg_init)
    _, _, m_c = run(data, psi0, scan, prb, g, piter=16)
    chained = np.concatenate([np.asarray(m_a["minf"]),
                              np.asarray(m_b["minf"])])
    np.testing.assert_allclose(chained, np.asarray(m_c["minf"]),
                               rtol=1e-6)


def test_compat_solver(rng):
    """Reference-shaped facade: numpy in, numpy out."""
    from tikejax.compat import CGPtychoSolver

    g = Geometry(nz=64, n=64, nscan=36, ndet=32, nprb=20)
    psi_true, scan, prb, data = make_problem(rng, g, dtype=jnp.complex64)
    solver = CGPtychoSolver(ntheta=1, nz=64, n=64, nscan=36, ndet=32,
                            nprb=20)

    farp = solver.fwd(np.asarray(psi_true), np.asarray(scan),
                      np.asarray(prb)[:, 0])  # mode-less probe accepted
    assert isinstance(farp, np.ndarray)
    assert farp.shape == g.farplane_shape

    obj = solver.adj(farp, np.asarray(scan), np.asarray(prb))
    assert obj.shape == g.psi_shape

    out = solver.run(np.asarray(data), np.ones(g.psi_shape, np.complex64),
                     np.asarray(scan), np.asarray(prb), piter=8)
    assert out["psi"].shape == g.psi_shape
    assert out["minf"][-1] < out["minf"][0]
    assert isinstance(out["psi"], np.ndarray)

    with pytest.raises(ValueError, match="shape"):
        solver.fwd(np.zeros((1, 8, 8), np.complex64), np.asarray(scan),
                   np.asarray(prb))


def test_compat_reconstruct(rng):
    """The facade reaches the deep-residual driver:
    reconstruct to a target through the reference-shaped entry point."""
    from tikejax.compat import CGPtychoSolver

    g = Geometry(nz=64, n=64, nscan=36, ndet=32, nprb=20)
    psi_true, scan, prb, data = make_problem(rng, g, dtype=jnp.complex64)
    solver = CGPtychoSolver(ntheta=1, nz=64, n=64, nscan=36, ndet=32,
                            nprb=20)
    out = solver.reconstruct(np.asarray(data),
                             np.ones(g.psi_shape, np.complex64),
                             np.asarray(scan), np.asarray(prb),
                             target_residual=1e-4, segment=64,
                             max_segments=8)
    assert out["psi"].shape == g.psi_shape
    assert isinstance(out["psi"], np.ndarray)
    assert out["residual_last"] <= 1e-4
    assert out["iters_run"] > 1
    assert len(out["stages"]) >= 1


def test_compat_mesh(rng):
    """Opt-in mesh: the facade run executes scan-sharded and matches the
    single-device result."""
    from tikejax.compat import CGPtychoSolver
    from tikejax.parallel import make_mesh

    if len(jax.devices()) < 2:
        pytest.skip("needs >= 2 devices")
    g = Geometry(nz=64, n=64, nscan=36, ndet=32, nprb=20)
    psi_true, scan, prb, data = make_problem(rng, g, dtype=jnp.complex64)
    solver = CGPtychoSolver(ntheta=1, nz=64, n=64, nscan=36, ndet=32,
                            nprb=20)
    args = (np.asarray(data), np.ones(g.psi_shape, np.complex64),
            np.asarray(scan), np.asarray(prb))
    out1 = solver.run(*args, piter=6)
    out2 = solver.run(*args, piter=6, mesh=make_mesh(2))
    np.testing.assert_allclose(out2["psi"], out1["psi"], rtol=2e-4,
                               atol=2e-5)
    np.testing.assert_allclose(out2["minf"], out1["minf"], rtol=2e-4)


def _load_bench():
    import importlib.util
    import os

    spec = importlib.util.spec_from_file_location(
        "bench", os.path.join(os.path.dirname(__file__), "..", "bench.py"))
    bench = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(bench)
    return bench


@pytest.mark.parametrize("gammas,want", [
    ([1.0, 1.0, 1.0], 1.0),            # every start accepted
    ([0.5, 0.5], 2.0),                 # one halving each, regrow to 1
    ([0.25, 1.0], (3 + 1) / 2),        # two halvings, regrow accepted
    ([0.0, 1.0], (17 + 1) / 2),        # failed search, then fresh start
])
def test_bench_ls_evals_per_iter(gammas, want):
    """bench.ls_evals_per_iter recovers evaluations per iteration from
    the accepted steps under the default regrow warm start."""
    bench = _load_bench()
    assert bench.ls_evals_per_iter(np.asarray(gammas)) == pytest.approx(want)


def test_bench_refuses_cpu():
    bench = _load_bench()
    with pytest.raises(SystemExit, match="no GPU"):
        bench.main([])
