"""Reconstruction tests for the Dai-Yuan CG solver.

Mirrors the reference's synthetic reconstruction smoke tests (SURVEY.md SS4
item 2) and the acceptance configs BASELINE.json:8-10 at test-friendly
sizes: simulate data from a known object/probe, reconstruct from a flat
start, assert the objective decreases monotonically (modulo the line
search's gamma=0 stalls) and the reconstruction approaches the truth.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tikejax import Geometry
from tikejax.models import (make_probe, make_problem, relative_object_error,
                            relative_probe_error)
from tikejax.solvers import CGOptions, run


def setup_problem(rng, g, **kw):
    psi_true, scan, prb, data = make_problem(rng, g, dtype=jnp.complex64,
                                             **kw)
    psi0 = jnp.ones(g.psi_shape, jnp.complex64)
    return psi_true, scan, prb, data, psi0


GEOM_SMALL = Geometry(nz=96, n=96, nscan=64, ndet=32, nprb=24)


def assert_decreasing(minf, frac=0.9):
    """Objective decreases across iterations (allow tiny float noise;
    additive tolerance so negative Poisson objectives are handled)."""
    m = np.asarray(minf)
    drops = m[1:] <= m[:-1] + 1e-5 * np.abs(m[:-1]) + 1e-12
    assert drops.mean() >= frac, f"minf not decreasing: {m}"
    assert m[-1] < m[0]


def test_gaussian_object_only(rng):
    """BASELINE.json:8 analogue: Gaussian CG, object-only."""
    psi_true, scan, prb, data, psi0 = setup_problem(rng, GEOM_SMALL)
    psi, prb_out, metrics = run(data, psi0, scan, prb, GEOM_SMALL,
                                piter=48, model="gaussian")
    assert_decreasing(metrics["minf"])
    assert jnp.all(prb_out == prb)  # probe untouched
    err = relative_object_error(psi, psi_true)
    assert err < 0.12, f"reconstruction error too high: {err}"


def test_poisson_object_only(rng):
    psi_true, scan, prb, data, psi0 = setup_problem(rng, GEOM_SMALL)
    psi, _, metrics = run(data, psi0, scan, prb, GEOM_SMALL,
                          piter=48, model="poisson")
    assert_decreasing(metrics["minf"])
    err = relative_object_error(psi, psi_true)
    assert err < 0.25, f"poisson reconstruction error too high: {err}"


def test_poisson_residual_metric_meaningful(rng):
    """The Poisson objective is negative near its
    optimum, so the residual must be measured as the excess over the
    perfect-fit objective value -- a run with a target_residual must
    execute more than one iteration, report a nonzero decreasing
    residual, and stop at the target rather than at a clamped zero."""
    psi_true, scan, prb, data, psi0 = setup_problem(rng, GEOM_SMALL)
    psi, _, metrics = run(data, psi0, scan, prb, GEOM_SMALL,
                          piter=160, model="poisson",
                          target_residual=1e-3)
    ran = int(metrics["iters_run"])
    res = np.asarray(metrics["residual"])[:ran]
    assert ran > 1, "poisson target_residual exited after one iteration"
    # The statistic is meaningful: strictly positive until the target is
    # reached, and it actually decreases.
    assert (res[:-1] > 0).all(), f"zero-clamped poisson residual: {res}"
    assert res[-1] < res[0]
    assert res[-1] <= 1e-3, f"target not honoured: {res[-1]}"
    # And the run converged to a sensible object, not a flat start.
    err = relative_object_error(psi, psi_true)
    assert err < 0.25, f"poisson targeted run error too high: {err}"


def test_poisson_gaussian_residual_scales_comparable(rng):
    """The Poisson residual (normalised generalized KL) tracks the
    gaussian amplitude residual within a small factor on the same
    noise-free data, so target_residual values carry across models."""
    _, scan, prb, data, psi0 = setup_problem(rng, GEOM_SMALL)
    _, _, m_g = run(data, psi0, scan, prb, GEOM_SMALL, piter=24,
                    model="gaussian")
    _, _, m_p = run(data, psi0, scan, prb, GEOM_SMALL, piter=24,
                    model="poisson")
    rg = np.asarray(m_g["residual"])
    rp = np.asarray(m_p["residual"])
    # Compare at matching early iterations (different descent paths
    # diverge later); scales must agree within ~4x (theory: sqrt(2)).
    for i in (0, 1, 2):
        assert rp[i] / rg[i] < 4.0 and rg[i] / rp[i] < 4.0, (
            f"residual scales diverge at iter {i}: {rg[i]} vs {rp[i]}")


@pytest.mark.parametrize("kern", ["xla"])
def test_cg_state_carry_continues_trajectory(rng, kern):
    """Two chained runs with carry_state/cg_init reproduce one long run
    exactly: the second run's first Dai-Yuan step continues the same CG
    trajectory."""
    psi_true, scan, prb, data, psi0 = setup_problem(rng, GEOM_SMALL)
    psi_a, _, m_a = run(data, psi0, scan, prb, GEOM_SMALL, piter=8,
                        kernel=kern, carry_state=True)
    psi_b, _, m_b = run(data, psi_a, scan, prb, GEOM_SMALL, piter=8,
                        kernel=kern, carry_state=True,
                        cg_init=m_a["cg_state"])
    psi_c, _, m_c = run(data, psi0, scan, prb, GEOM_SMALL, piter=16,
                        kernel=kern)
    chained = np.concatenate([np.asarray(m_a["minf"]),
                              np.asarray(m_b["minf"])])
    np.testing.assert_allclose(chained, np.asarray(m_c["minf"]),
                               rtol=1e-6)
    assert float(jnp.max(jnp.abs(psi_b - psi_c))) < 1e-5 * float(
        jnp.max(jnp.abs(psi_c)))
    # Without the carry, the restart breaks the trajectory (sanity that
    # the test can actually fail).
    _, _, m_r = run(data, psi_a, scan, prb, GEOM_SMALL, piter=8,
                    kernel=kern)
    assert not np.allclose(np.asarray(m_r["minf"]),
                           np.asarray(m_b["minf"]), rtol=1e-6)


def test_lbfgs_ring_carry_continues_trajectory(rng):
    """carry_lbfgs hands the FULL (S, Y) ring forward: two chained
    L-BFGS runs reproduce one long run exactly, whereas the default
    4-slot carry (ring rebuilt from the one implicitly-seeded pair)
    diverges once the long run's ring depth exceeds one."""
    from tikejax.solvers.cg import zero_cg_state

    psi_true, scan, prb, data, psi0 = setup_problem(rng, GEOM_SMALL)
    kw = dict(kernel="xla", direction="lbfgs:3", carry_state=True)
    psi_a, _, m_a = run(data, psi0, scan, prb, GEOM_SMALL, piter=8,
                        carry_lbfgs=True, **kw)
    assert len(m_a["cg_state"]) == 8
    assert m_a["cg_state"][4].shape == (3,) + GEOM_SMALL.psi_shape
    psi_b, _, m_b = run(data, psi_a, scan, prb, GEOM_SMALL, piter=8,
                        carry_lbfgs=True, cg_init=m_a["cg_state"], **kw)
    psi_c, _, m_c = run(data, psi0, scan, prb, GEOM_SMALL, piter=16,
                        kernel="xla", direction="lbfgs:3")
    chained = np.concatenate([np.asarray(m_a["minf"]),
                              np.asarray(m_b["minf"])])
    np.testing.assert_allclose(chained, np.asarray(m_c["minf"]),
                               rtol=1e-6)
    assert float(jnp.max(jnp.abs(psi_b - psi_c))) < 1e-5 * float(
        jnp.max(jnp.abs(psi_c)))
    # The 4-slot carry (no ring) does NOT reproduce the long run here
    # (sanity: the ring actually matters on this trajectory).
    psi_a4, _, m_a4 = run(data, psi0, scan, prb, GEOM_SMALL, piter=8,
                          **kw)
    _, _, m_b4 = run(data, psi_a4, scan, prb, GEOM_SMALL, piter=8,
                     cg_init=m_a4["cg_state"], **kw)
    assert not np.allclose(np.asarray(m_b4["minf"]),
                           np.asarray(m_b["minf"]), rtol=1e-6)
    # zero_cg_state == fresh start (the device-side carry-guard
    # invariant solvers.tiered relies on), in the 8-tuple layout too.
    opts = CGOptions(carry_lbfgs=True, **kw)
    z = zero_cg_state(psi0, opts)
    assert len(z) == 8
    _, _, m_z = run(data, psi0, scan, prb, GEOM_SMALL, piter=8,
                    carry_lbfgs=True, cg_init=z, **kw)
    np.testing.assert_allclose(np.asarray(m_z["minf"]),
                               np.asarray(m_a["minf"]), rtol=1e-6)


def test_cg_init_layout_mismatch_diagnostic(rng):
    """Feeding an 8-tuple (L-BFGS ring) cg_state into a run that carries
    only the 4-tuple layout raises a diagnostic ValueError naming
    carry_lbfgs (round-3 advisor: was a raw unpacking error)."""
    from tikejax.solvers.cg import zero_cg_state

    psi_true, scan, prb, data, psi0 = setup_problem(rng, GEOM_SMALL)
    z8 = zero_cg_state(psi0, CGOptions(kernel="xla", direction="lbfgs:3",
                                       carry_state=True, carry_lbfgs=True))
    assert len(z8) == 8
    with pytest.raises(ValueError, match="carry_lbfgs"):
        run(data, psi0, scan, prb, GEOM_SMALL, piter=2, kernel="xla",
            carry_state=True, cg_init=z8)


def test_carry_lbfgs_implies_carry_state(rng):
    """carry_lbfgs without carry_state was silently inert (no cg_state
    in metrics); normalize_options now implies carry_state (round-3
    advisor)."""
    psi_true, scan, prb, data, psi0 = setup_problem(rng, GEOM_SMALL)
    _, _, m = run(data, psi0, scan, prb, GEOM_SMALL, piter=2,
                  kernel="xla", direction="lbfgs:3", carry_lbfgs=True)
    assert len(m["cg_state"]) == 8


def test_joint_probe_recovery(rng):
    """BASELINE.json:9 analogue: joint object+probe."""
    psi_true, scan, prb_true, data, psi0 = setup_problem(rng, GEOM_SMALL)
    # start from a perturbed probe
    prb0 = prb_true * 0.8 + 0.1 * jnp.mean(jnp.abs(prb_true))
    psi, prb, metrics = run(data, psi0, scan, prb0, GEOM_SMALL,
                            piter=64, model="gaussian", recover_prb=True)
    assert_decreasing(metrics["minf"], frac=0.8)
    # joint recovery must beat the frozen-bad-probe reconstruction
    psi_frozen, _, m_frozen = run(data, psi0, scan, prb0, GEOM_SMALL,
                                  piter=64, model="gaussian")
    assert metrics["minf"][-1] < m_frozen["minf"][-1]
    # ... and the recovered probe must actually approach the true probe
    # (scale/phase-aligned), improving substantially on the start.
    err0 = relative_probe_error(prb0, prb_true)
    err = relative_probe_error(prb, prb_true)
    assert err < 0.5 * err0, (
        f"probe error did not improve enough: {err0:.3f} -> {err:.3f}")
    assert err < 0.05, f"recovered probe too far from truth: {err:.3f}"


def test_multimode_probe(rng):
    """BASELINE.json:10 analogue: 4 incoherent probe modes."""
    g = Geometry(nz=96, n=96, nscan=64, ndet=32, nprb=24, nmodes=4)
    psi_true, scan, prb, data, psi0 = setup_problem(rng, g)
    psi, _, metrics = run(data, psi0, scan, prb, g, piter=48)
    assert_decreasing(metrics["minf"])
    err = relative_object_error(psi, psi_true)
    assert err < 0.2, f"multimode reconstruction error too high: {err}"


def test_poisson_noisy_data(rng):
    """Reconstruction from actually Poisson-noised counts (SURVEY.md SS4
    item 2): the Poisson model must converge on
    shot-noise-limited data, and beat the flat start by a wide margin."""
    psi_true, scan, prb, data, psi0 = setup_problem(
        rng, GEOM_SMALL, poisson_photons=1e6)
    psi, _, metrics = run(data, psi0, scan, prb, GEOM_SMALL,
                          piter=64, model="poisson")
    assert_decreasing(metrics["minf"], frac=0.8)
    err = relative_object_error(psi, psi_true)
    err0 = relative_object_error(psi0, psi_true)
    assert err < 0.15, f"noisy poisson reconstruction error: {err}"
    assert err < 0.5 * err0


def test_gaussian_on_noisy_data(rng):
    """Control: the Gaussian (amplitude) model on the same noisy counts
    still converges (it is the wrong noise model but a stable LSQ fit)."""
    psi_true, scan, prb, data, psi0 = setup_problem(
        rng, GEOM_SMALL, poisson_photons=1e6)
    psi, _, metrics = run(data, psi0, scan, prb, GEOM_SMALL,
                          piter=64, model="gaussian")
    assert_decreasing(metrics["minf"], frac=0.8)
    err = relative_object_error(psi, psi_true)
    assert err < 0.15, f"noisy gaussian reconstruction error: {err}"


def test_minibatched_matches_full(rng):
    """nchunks>1 streams positions through lax.scan; results must match the
    monolithic path to float tolerance."""
    psi_true, scan, prb, data, psi0 = setup_problem(rng, GEOM_SMALL)
    psi_a, _, ma = run(data, psi0, scan, prb, GEOM_SMALL, piter=8)
    psi_b, _, mb = run(data, psi0, scan, prb, GEOM_SMALL, piter=8, nchunks=4)
    np.testing.assert_allclose(np.asarray(ma["minf"]), np.asarray(mb["minf"]),
                               rtol=2e-4)
    assert float(jnp.max(jnp.abs(psi_a - psi_b))) < 2e-3 * float(
        jnp.max(jnp.abs(psi_a)))


def test_minibatched_joint_multimode(rng):
    """Streaming + joint probe + multimode all compose."""
    g = Geometry(nz=96, n=96, nscan=64, ndet=32, nprb=24, nmodes=2)
    psi_true, scan, prb, data, psi0 = setup_problem(rng, g)
    prb0 = prb * 0.85
    psi, prb_out, metrics = run(data, psi0, scan, prb0, g, piter=16,
                                nchunks=4, recover_prb=True,
                                model="poisson")
    assert_decreasing(metrics["minf"], frac=0.8)
    assert not jnp.all(prb_out == prb0)


def test_ntheta_batched(rng):
    """ntheta>1 reconstructs independent angles in one batched run."""
    g = Geometry(nz=64, n=64, nscan=36, ndet=32, nprb=20, ntheta=2)
    psi_true, scan, prb, data, psi0 = setup_problem(rng, g)
    psi, _, metrics = run(data, psi0, scan, prb, g, piter=32)
    assert_decreasing(metrics["minf"])


def test_stop_on_stall(rng):
    """A line search that cannot decrease (absurd step, no halvings)
    stalls every iteration; the loop exits after stop_on_stall
    consecutive failures instead of burning the full piter budget."""
    psi_true, scan, prb, data, psi0 = setup_problem(rng, GEOM_SMALL)
    _, _, m = run(data, psi0, scan, prb, GEOM_SMALL, piter=20,
                  step0=1e30, max_halvings=0, adaptive_step=False)
    assert int(m["iters_run"]) == 2
    _, _, m2 = run(data, psi0, scan, prb, GEOM_SMALL, piter=20,
                   step0=1e30, max_halvings=0, adaptive_step=False,
                   stop_on_stall=0)
    assert int(m2["iters_run"]) == 20
    with pytest.raises(ValueError, match="stop_on_stall"):
        run(data, psi0, scan, prb, GEOM_SMALL, piter=2, stop_on_stall=-1)
    with pytest.raises(ValueError, match="step_policy"):
        run(data, psi0, scan, prb, GEOM_SMALL, piter=2, step_policy="bogus")


def test_precondition_options(rng):
    psi_true, scan, prb, data, psi0 = setup_problem(rng, GEOM_SMALL)
    for pre in ["illum", "illum_lowk", "max", "none"]:
        _, _, m = run(data, psi0, scan, prb, GEOM_SMALL, piter=6,
                      precondition=pre)
        assert m["minf"][-1] < m["minf"][0]
    with pytest.raises(ValueError, match="precondition"):
        run(data, psi0, scan, prb, GEOM_SMALL, piter=2, precondition="bogus")
    # illum_lowk is object-only (opt-in for sparse-overlap scans)
    with pytest.raises(ValueError, match="object-only"):
        run(data, psi0, scan, prb, GEOM_SMALL, piter=2,
            precondition="illum_lowk", recover_prb=True)
    with pytest.raises(ValueError, match="lowk_frac"):
        run(data, psi0, scan, prb, GEOM_SMALL, piter=2,
            precondition="illum_lowk", lowk_frac=0.9)


def test_residual_metric(rng):
    psi_true, scan, prb, data, psi0 = setup_problem(rng, GEOM_SMALL)
    _, _, m = run(data, psi0, scan, prb, GEOM_SMALL, piter=8)
    res = np.asarray(m["residual"])
    minf = np.asarray(m["minf"])
    sumd = float(jnp.sum(jnp.maximum(data, 0.0)))
    np.testing.assert_allclose(res, np.sqrt(np.maximum(minf, 0) / sumd),
                               rtol=1e-5)


def test_lbfgs_direction(rng):
    """direction='lbfgs[:m]' converges at least as deep as Dai-Yuan in
    the same iteration budget (CPU-oracle A/B in CGOptions.direction:
    DY 200 vs lbfgs:8 150 iterations to 1e-6 at fp64), the objective
    still decreases monotonically, and bad values are rejected."""
    psi_true, scan, prb, data, psi0 = setup_problem(rng, GEOM_SMALL)
    _, _, m_dy = run(data, psi0, scan, prb, GEOM_SMALL, piter=48)
    _, _, m_lb = run(data, psi0, scan, prb, GEOM_SMALL, piter=48,
                     direction="lbfgs")
    assert_decreasing(m_lb["minf"])
    assert float(np.asarray(m_lb["minf"])[-1]) <= \
        1.05 * float(np.asarray(m_dy["minf"])[-1])
    # explicit memory depth parses and runs
    _, _, m5 = run(data, psi0, scan, prb, GEOM_SMALL, piter=8,
                   direction="lbfgs:5")
    assert_decreasing(m5["minf"])
    for bad in ("bogus", "lbfgs:x", "lbfgs:0", "lbfgs:99"):
        with pytest.raises(ValueError):
            run(data, psi0, scan, prb, GEOM_SMALL, piter=2, direction=bad)


def test_lbfgs_split_operator(rng):
    """L-BFGS composes with split-operator mode (f_base) and descends
    deeper than DY from the same warm iterate (the regime tiered's
    refinement segments run it in)."""
    from tikejax.ops.diffraction import fwd_raw

    psi_true, scan, prb, data, psi0 = setup_problem(rng, GEOM_SMALL)
    psi_b, _, _ = run(data, psi0, scan, prb, GEOM_SMALL, piter=40)
    f_base = fwd_raw(psi_b, scan, prb, GEOM_SMALL.ndet, "xla")
    delta0 = jnp.zeros_like(psi_b)
    _, _, m_dy = run(data, delta0, scan, prb, GEOM_SMALL, piter=32,
                     f_base=f_base)
    _, _, m_lb = run(data, delta0, scan, prb, GEOM_SMALL, piter=32,
                     f_base=f_base, direction="lbfgs")
    assert float(np.asarray(m_lb["minf"])[-1]) <= \
        1.05 * float(np.asarray(m_dy["minf"])[-1])


def test_split_operator_chunked(rng):
    """Split-operator mode (f_base) streams the frozen base farplane
    through nchunks > 1 scan chunks: the chunked run reproduces the
    nchunks=1 trajectory."""
    from tikejax.ops.diffraction import fwd_raw

    psi_true, scan, prb, data, psi0 = setup_problem(rng, GEOM_SMALL)
    psi_b, _, _ = run(data, psi0, scan, prb, GEOM_SMALL, piter=20)
    f_base = fwd_raw(psi_b, scan, prb, GEOM_SMALL.ndet, "xla")
    delta0 = jnp.zeros_like(psi_b)
    _, _, m1 = run(data, delta0, scan, prb, GEOM_SMALL, piter=12,
                   f_base=f_base, kernel="xla")
    _, _, m2 = run(data, delta0, scan, prb, GEOM_SMALL, piter=12,
                   f_base=f_base, kernel="xla", nchunks=4)
    # Chunked accumulation reorders the f32 sums (~4e-5 relative).
    np.testing.assert_allclose(np.asarray(m1["minf"]),
                               np.asarray(m2["minf"]), rtol=1e-3)


def test_lbfgs_poisson(rng):
    """The direction rule is likelihood-agnostic: L-BFGS descends the
    Poisson objective too (gradients/objective come from the same
    residual machinery)."""
    psi_true, scan, prb, data, psi0 = setup_problem(rng, GEOM_SMALL)
    _, _, m = run(data, psi0, scan, prb, GEOM_SMALL, piter=24,
                  model="poisson", direction="lbfgs")
    assert_decreasing(m["minf"])


def test_options_validation():
    g = GEOM_SMALL
    with pytest.raises(ValueError, match="nchunks"):
        run(jnp.zeros(g.data_shape), jnp.zeros(g.psi_shape, jnp.complex64),
            jnp.zeros(g.scan_shape), jnp.zeros(g.prb_shape, jnp.complex64),
            g, nchunks=7)
    with pytest.raises(ValueError, match="model"):
        run(jnp.zeros(g.data_shape), jnp.zeros(g.psi_shape, jnp.complex64),
            jnp.zeros(g.scan_shape), jnp.zeros(g.prb_shape, jnp.complex64),
            g, model="laplace")
