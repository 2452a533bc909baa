"""Tests for early-exit targets, parabolic line search, kernel tiering."""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tikejax import Geometry
from tikejax.models import make_problem
from tikejax.ops import diffraction
from tikejax.solvers import CGOptions, reconstruct, run
from tikejax.solvers.cg import normalize_options

GEOM = Geometry(nz=96, n=96, nscan=64, ndet=32, nprb=24)


@pytest.fixture(scope="module")
def problem():
    psi_true, scan, prb, data = make_problem(jax.random.PRNGKey(11), GEOM,
                                             dtype=jnp.complex64)
    psi0 = jnp.ones(GEOM.psi_shape, jnp.complex64)
    return psi_true, scan, prb, data, psi0


def test_target_residual_early_exit(problem):
    psi_true, scan, prb, data, psi0 = problem
    _, _, m_full = run(data, psi0, scan, prb, GEOM, piter=48)
    res_full = np.asarray(m_full["residual"])
    assert int(m_full["iters_run"]) == 48
    # pick a target the full run reached around halfway
    target = float(res_full[24])
    psi, _, m = run(data, psi0, scan, prb, GEOM, piter=48,
                    target_residual=target)
    k = int(m["iters_run"])
    assert 0 < k < 48
    res = np.asarray(m["residual"])
    assert res[k - 1] <= target
    # the early-exited prefix matches the full run's trajectory
    np.testing.assert_allclose(res[:k], res_full[:k], rtol=1e-5)
    # unexecuted slots stay zero
    assert np.all(res[k:] == 0)


def test_parabolic_linesearch_converges(problem):
    psi_true, scan, prb, data, psi0 = problem
    _, _, m_bt = run(data, psi0, scan, prb, GEOM, piter=24)
    _, _, m_pb = run(data, psi0, scan, prb, GEOM, piter=24,
                     linesearch="parabolic")
    bt = np.asarray(m_bt["minf"])
    pb = np.asarray(m_pb["minf"])
    assert pb[-1] > 0 and np.isfinite(pb).all()
    # parabolic refinement must not lose to plain backtracking by more
    # than noise (it usually wins substantially)
    assert pb[-1] <= 1.05 * bt[-1]
    with pytest.raises(ValueError, match="linesearch"):
        run(data, psi0, scan, prb, GEOM, piter=2, linesearch="golden")


def test_reconstruct_tier_chaining(problem):
    psi_true, scan, prb, data, psi0 = problem
    # two-tier chain on the CPU oracle kernel: a shallow tier that exits
    # at its floor, then a deep tier that finishes the job
    tiers = (("xla", 2e-1, 32), ("xla", 0.0, 64))
    psi, prb_out, stages = reconstruct(data, psi0, scan, prb, GEOM,
                                       target_residual=1e-1, tiers=tiers,
                                       method="tiers")
    assert [k for k, _ in stages] == ["xla", "xla"]
    k0 = int(stages[0][1]["iters_run"])
    k1 = int(stages[1][1]["iters_run"])
    res1 = np.asarray(stages[1][1]["residual"])
    assert res1[k1 - 1] <= 1e-1
    assert k0 <= 32 and k1 <= 64
    # a shallow target runs the first tier only
    _, _, st2 = reconstruct(data, psi0, scan, prb, GEOM,
                            target_residual=3e-1, tiers=tiers,
                            method="tiers")
    assert len(st2) == 1
    with pytest.raises(ValueError, match="target_residual"):
        reconstruct(data, psi0, scan, prb, GEOM, target_residual=0)


def test_split_operator_matches_direct(problem):
    """CG on a correction delta with f_base == G(psi_base) must track CG
    started directly from psi_base (linearity of the forward model)."""
    psi_true, scan, prb, data, psi0 = problem
    from tikejax.ops.diffraction import fwd_raw

    psi_b, _, _ = run(data, psi0, scan, prb, GEOM, piter=12)
    _, _, m_direct = run(data, psi_b, scan, prb, GEOM, piter=10)
    f_base = fwd_raw(psi_b, scan, prb, GEOM.ndet, "xla")
    delta0 = jnp.zeros_like(psi_b)
    delta, _, m_split = run(data, delta0, scan, prb, GEOM, piter=10,
                            f_base=f_base)
    np.testing.assert_allclose(np.asarray(m_direct["minf"]),
                               np.asarray(m_split["minf"]), rtol=1e-4)


def test_split_operator_validation(problem):
    psi_true, scan, prb, data, psi0 = problem
    from tikejax.ops.diffraction import fwd_raw

    f_base = fwd_raw(psi0, scan, prb, GEOM.ndet, "xla")
    # nchunks > 1 with f_base is supported (the base
    # streams through the chunks; equivalence in
    # test_cg.test_split_operator_chunked).
    with pytest.raises(ValueError, match="split-operator"):
        run(data, psi0, scan, prb, GEOM, piter=2, f_base=f_base,
            recover_prb=True)


def test_reconstruct_split_chunked(problem):
    """reconstruct threads nchunks through the split refinement (the
    frozen base streams through the chunks): the chunked
    run reproduces the nchunks=1 reconstruction."""
    psi_true, scan, prb, data, psi0 = problem
    kw = dict(target_residual=1e-4, segment=64, max_segments=12,
              tiers=(("xla", 5e-3, 96),), accelerate=None)
    psi1, _, st1 = reconstruct(data, psi0, scan, prb, GEOM, **kw)
    psi2, _, st2 = reconstruct(data, psi0, scan, prb, GEOM, nchunks=2,
                               **kw)
    assert len(st1) == len(st2)
    r1 = np.asarray(st1[-1][1]["residual"])
    r2 = np.asarray(st2[-1][1]["residual"])
    k1 = int(st1[-1][1]["iters_run"])
    k2 = int(st2[-1][1]["iters_run"])
    assert abs(k1 - k2) <= 2  # f32 resummation can shift the exit by a hair
    np.testing.assert_allclose(r1[max(k1 - 1, 0)], r2[max(k2 - 1, 0)],
                               rtol=1e-2)


def test_reconstruct_split_checkpoint_resume(problem, monkeypatch,
                                             tmp_path):
    """Kill a checkpointed split run mid-refinement (simulated transport
    crash), re-issue the SAME call: it resumes from the last per-segment
    checkpoint and reproduces the reference trajectory exactly -- same
    remaining segment count, same final residual."""
    from tikejax.solvers import cg as cg_mod
    from tikejax.solvers import tiered

    psi_true, scan, prb, data, psi0 = problem
    path = str(tmp_path / "split.ckpt.npz")
    kw = dict(target_residual=1e-4, segment=32, max_segments=12,
              tiers=(("xla", 5e-3, 96),), accelerate="anderson",
              segment_carry=True)
    psi_ref, _, st_ref = reconstruct(data, psi0, scan, prb, GEOM, **kw)
    n_split_ref = sum(1 for n, _ in st_ref if n.startswith("split:"))
    assert n_split_ref >= 3  # need room to crash mid-way

    real_run = cg_mod.run
    calls = {"n": 0}

    def crashing_run(*a, **k):
        calls["n"] += 1
        if calls["n"] == 4:  # stage 1 + two split segments, then die
            raise RuntimeError("simulated transport crash")
        return real_run(*a, **k)

    monkeypatch.setattr(cg_mod, "run", crashing_run)
    with pytest.raises(RuntimeError, match="simulated"):
        reconstruct(data, psi0, scan, prb, GEOM, checkpoint_path=path,
                    checkpoint_every=1, **kw)
    monkeypatch.setattr(cg_mod, "run", real_run)
    assert os.path.exists(path)

    # A mismatched call must refuse the checkpoint.
    with pytest.raises(ValueError, match="DIFFERENT"):
        reconstruct(data, psi0, scan, prb, GEOM, checkpoint_path=path,
                    **{**kw, "target_residual": 3e-4})

    psi_res, _, st_res = reconstruct(data, psi0, scan, prb, GEOM,
                                     checkpoint_path=path,
                                     checkpoint_every=1, **kw)
    # Pre-crash stages are not re-reported; the resumed run covers
    # exactly the remaining reference segments.
    names = [n for n, _ in st_res]
    assert all(n.startswith("split:") for n in names)
    assert len(names) == n_split_ref - 2
    r_ref = np.asarray(st_ref[-1][1]["residual"])
    r_res = np.asarray(st_res[-1][1]["residual"])
    k_ref = int(st_ref[-1][1]["iters_run"])
    k_res = int(st_res[-1][1]["iters_run"])
    assert k_ref == k_res
    np.testing.assert_allclose(r_res[max(k_res - 1, 0)],
                               r_ref[max(k_ref - 1, 0)], rtol=1e-6)
    np.testing.assert_allclose(np.abs(np.asarray(tiered.hostio.to_host(
        psi_res))), np.abs(np.asarray(tiered.hostio.to_host(psi_ref))),
        rtol=1e-5, atol=1e-7)
    # Successful completion removes the checkpoint (re-run = fresh run).
    assert not os.path.exists(path)


def test_reconstruct_split_method(problem):
    psi_true, scan, prb, data, psi0 = problem
    psi, _, stages = reconstruct(data, psi0, scan, prb, GEOM,
                                 target_residual=1e-4, segment=64,
                                 max_segments=12,
                                 tiers=(("xla", 5e-3, 96),))
    names = [n for n, _ in stages]
    assert names[0] == "xla" and all(n == "split:xla" for n in names[1:])
    last = stages[-1][1]
    k = int(last["iters_run"])
    assert np.asarray(last["residual"])[max(k - 1, 0)] <= 1e-4
    with pytest.raises(ValueError, match="method"):
        reconstruct(data, psi0, scan, prb, GEOM, target_residual=1e-4,
                    method="bogus")


def test_reconstruct_joint_then_split(problem):
    """recover_prb=True in split mode runs stage 1 jointly (probe
    actually moves), then freezes the recovered probe for the split
    refinement and still reaches the target."""
    psi_true, scan, prb, data, psi0 = problem
    prb0 = prb * 1.05  # perturbed probe: joint stage must fix it
    psi, prb_out, stages = reconstruct(
        data, psi0, scan, prb0, GEOM, target_residual=1e-3, segment=64,
        max_segments=12, tiers=(("xla", 5e-3, 96),), recover_prb=True)
    names = [n for n, _ in stages]
    assert names[0] == "xla:joint"
    # deep target (1e-3 < stage-1 floor 5e-3): the joint recovery
    # continues (a CHAIN of short dispatches) before the probe is frozen
    k = 1
    while k < len(names) and names[k] == "xla:joint":
        k += 1
    assert k >= 2  # the escalation chain ran
    assert all(n == "split:xla" for n in names[k:])
    assert len(names) > k
    # the probe moved in the joint stage
    assert float(jnp.max(jnp.abs(prb_out - prb0))) > 1e-6
    last = stages[-1][1]
    k = int(last["iters_run"])
    assert np.asarray(last["residual"])[max(k - 1, 0)] <= 1e-3


def test_reconstruct_split_anderson(problem):
    """accelerate='anderson' reaches the same target through the split
    refinement; the safeguarded selection never worsens the final
    residual vs the plain split run."""
    psi_true, scan, prb, data, psi0 = problem
    kw = dict(target_residual=2e-4, segment=24, max_segments=24,
              tiers=(("xla", 5e-3, 96),))
    psi_a, _, st_a = reconstruct(data, psi0, scan, prb, GEOM,
                                 accelerate="anderson", **kw)
    last = st_a[-1][1]
    k = int(last["iters_run"])
    assert np.asarray(last["residual"])[max(k - 1, 0)] <= 2e-4
    # unknown accelerate value is rejected
    with pytest.raises(ValueError):
        reconstruct(data, psi0, scan, prb, GEOM, accelerate="nesterov",
                    **kw)


def test_reconstruct_split_lbfgs_ring_carry(problem):
    """carry_lbfgs=True threads the full 8-tuple cg_state (incl. the
    (S, Y, sy, count) ring) through the split refinement -- segments,
    Anderson masking, and the device-side carry guard all operate on
    the extended layout -- and still reaches the target."""
    psi_true, scan, prb, data, psi0 = problem
    psi, _, stages = reconstruct(data, psi0, scan, prb, GEOM,
                                 target_residual=2e-4, segment=24,
                                 max_segments=24, carry_lbfgs=True,
                                 tiers=(("xla", 5e-3, 96),))
    last = stages[-1][1]
    k = int(last["iters_run"])
    assert np.asarray(last["residual"])[max(k - 1, 0)] <= 2e-4
    # The refinement actually ran multi-segment (the carry had a
    # boundary to cross).
    assert sum(1 for n, _ in stages if n.startswith("split:")) >= 2


def test_direction_auto_resolution(problem):
    """The default direction='auto' resolves to Dai-Yuan in a plain
    run (flat-start basin hazard) and to L-BFGS for the split
    refinement segments: trajectories must be bitwise-identical to the
    explicit settings."""
    psi_true, scan, prb, data, psi0 = problem
    _, _, m_auto = run(data, psi0, scan, prb, GEOM, piter=16)
    _, _, m_dy = run(data, psi0, scan, prb, GEOM, piter=16,
                     direction="dy")
    np.testing.assert_array_equal(np.asarray(m_auto["minf"]),
                                  np.asarray(m_dy["minf"]))

    kw = dict(target_residual=2e-4, segment=24, max_segments=24,
              tiers=(("xla", 5e-3, 96),), accelerate=None)
    _, _, st_auto = reconstruct(data, psi0, scan, prb, GEOM, **kw)
    _, _, st_lb = reconstruct(data, psi0, scan, prb, GEOM,
                              direction="lbfgs", **kw)
    _, _, st_dy = reconstruct(data, psi0, scan, prb, GEOM,
                              direction="dy", **kw)
    tr_auto = [np.asarray(m["minf"]) for _, m in st_auto]
    tr_lb = [np.asarray(m["minf"]) for _, m in st_lb]
    assert len(tr_auto) == len(tr_lb)
    for a, b in zip(tr_auto, tr_lb):
        np.testing.assert_array_equal(a, b)
    # and it genuinely differs from forcing Dai-Yuan refinement
    # (stage 1 is identical by design; compare the first split segment)
    assert len(st_dy) >= 2 and len(st_auto) >= 2
    assert not np.array_equal(np.asarray(st_auto[1][1]["minf"]),
                              np.asarray(st_dy[1][1]["minf"]))


def test_reconstruct_split_poisson(problem):
    """Split refinement (with the Anderson default) composes with the
    Poisson likelihood: the base-offset delta CG descends the KL-excess
    residual to the target."""
    psi_true, scan, prb, data, psi0 = problem
    psi, _, st = reconstruct(data, psi0, scan, prb, GEOM,
                             target_residual=5e-4, segment=32,
                             max_segments=24, tiers=(("xla", 5e-3, 96),),
                             model="poisson")
    last = st[-1][1]
    k = max(int(last["iters_run"]), 1)
    assert np.asarray(last["residual"])[k - 1] <= 5e-4
    assert any(n.startswith("split:") for n, _ in st)


def test_recover_prb_floor_refresh():
    """When the object-only refinement floor-stalls (noise floor above
    the target), split-mode recover_prb re-opens the probe with a joint
    segment; a refresh that is itself flat marks the genuine floor and
    the run stops well before the segment budget."""
    _, scan, prb, data = make_problem(jax.random.PRNGKey(11), GEOM,
                                      dtype=jnp.complex64,
                                      poisson_photons=1e4)
    psi0 = jnp.ones(GEOM.psi_shape, jnp.complex64)
    _, _, st = reconstruct(data, psi0, scan, prb * 1.05, GEOM,
                           target_residual=1e-12, segment=32,
                           max_segments=16, floor_patience=2,
                           tiers=(("xla", 5e-3, 96),), recover_prb=True)
    names = [n for n, _ in st]
    first_split = names.index("split:xla")
    # a joint refresh appears AFTER split segments started
    assert any(n.endswith(":joint") for n in names[first_split:])
    # flat refresh => genuine floor: stop, don't burn the 16-segment
    # budget (joint escalation + refresh are 4-dispatch chains each)
    assert len(st) <= 13


def test_reconstruct_split_multimode():
    """The split refinement and its joint probe-recovery stages compose
    with a multi-mode probe (the frozen base farplane and the joint
    escalation both carry the mode axis)."""
    g = Geometry(nz=96, n=96, nscan=64, ndet=32, nprb=24, nmodes=2)
    psi_true, scan, prb, data = make_problem(jax.random.PRNGKey(7), g,
                                             dtype=jnp.complex64)
    psi0 = jnp.ones(g.psi_shape, jnp.complex64)
    kw = dict(segment=32, max_segments=24, tiers=(("xla", 5e-3, 96),))
    _, _, st = reconstruct(data, psi0, scan, prb, g,
                           target_residual=5e-4, **kw)
    assert any(n.startswith("split:") for n, _ in st)
    last = st[-1][1]
    k = max(int(last["iters_run"]), 1)
    assert np.asarray(last["residual"])[k - 1] <= 5e-4
    # joint recovery of a perturbed 2-mode probe, then split refinement
    prb0 = prb * 1.05
    _, prb_out, st2 = reconstruct(data, psi0, scan, prb0, g,
                                  target_residual=1e-3,
                                  recover_prb=True, **kw)
    names = [n for n, _ in st2]
    assert names[0].endswith(":joint")
    assert any(n.startswith("split:") for n in names)
    assert float(jnp.max(jnp.abs(prb_out - prb0))) > 1e-6
    last = st2[-1][1]
    k = max(int(last["iters_run"]), 1)
    assert np.asarray(last["residual"])[k - 1] <= 1e-3


def test_aitken_probe_floor_detection():
    """The Aitken Δ² early probe-floor detector fires exactly when the
    per-segment residuals geometrically asymptote ABOVE the target and
    stays quiet on healthy (target-reaching) or non-geometric decay."""
    from tikejax.solvers.tiered import _aitken_limit, \
        _probe_floor_predicted

    def geo(limit, c0=1e-5, rho=0.45, n=6):
        return [limit + c0 * rho ** k for k in range(n)]

    # exact geometric sequence: the limit is recovered to rounding
    lim = _aitken_limit(*geo(1.4e-6)[:3])
    assert lim is not None and abs(lim - 1.4e-6) < 1e-9
    # guards: non-monotone, accelerating (rho >= 0.95), increasing
    assert _aitken_limit(3.0, 1.0, 2.0) is None
    assert _aitken_limit(3.0, 2.0, 1.04) is None  # rho ~ 0.96
    assert _aitken_limit(1.0, 2.0, 3.0) is None

    # asymptoting at 1.4x the target: both extrapolations agree -> fire
    assert _probe_floor_predicted(geo(1.4e-6), target=1e-6)
    # healthy run heading BELOW the target: never fire
    assert not _probe_floor_predicted(geo(0.5e-6), target=1e-6)
    # limit above target but inside the 1.2x margin: too close to call
    assert not _probe_floor_predicted(geo(1.1e-6), target=1e-6)
    # too little history
    assert not _probe_floor_predicted(geo(1.4e-6, n=3), target=1e-6)
    # a plateau (flat counter territory) is not a geometric decay
    assert not _probe_floor_predicted([2e-6] * 5, target=1e-6)


def test_floor_stop_prevents_budget_burn():
    """An unreachable target (below the data/operator floor) must stop
    after floor_patience flat segments instead of burning
    max_segments. Shot noise gives the gaussian objective a hard
    positive floor."""
    _, scan, prb, data = make_problem(jax.random.PRNGKey(11), GEOM,
                                      dtype=jnp.complex64,
                                      poisson_photons=1e4)
    psi0 = jnp.ones(GEOM.psi_shape, jnp.complex64)
    kw = dict(target_residual=1e-12, segment=32, max_segments=16,
              tiers=(("xla", 5e-3, 96),))
    _, _, st_burn = reconstruct(data, psi0, scan, prb, GEOM,
                                floor_patience=0, **kw)
    assert len(st_burn) == 17  # fast tier + the full segment budget
    _, _, st_stop = reconstruct(data, psi0, scan, prb, GEOM,
                                floor_patience=2, **kw)
    assert len(st_stop) < len(st_burn)


def test_auto_kernel_resolves_by_target(monkeypatch):
    """On a GPU backend the solver's 'auto' is the XLA path at every
    residual target (there is no other operator implementation)."""
    monkeypatch.setattr(diffraction.jax, "default_backend", lambda: "gpu")
    for target in (0.0, 1e-2, 1e-3, 1e-6):
        o = normalize_options(CGOptions(kernel="auto",
                                        target_residual=target))
        assert o.kernel == "xla"
    assert diffraction.resolve_kernel("auto") == "xla"


def test_auto_kernel_cpu_backend():
    # on CPU 'auto' is the XLA path regardless of target
    assert diffraction.resolve_kernel("auto") == "xla"
    o = normalize_options(CGOptions(kernel="auto", target_residual=1e-6))
    assert o.kernel == "xla"


def test_reconstruct_on_scan_mesh():
    """The deep driver composes with a 1-D position-sharding mesh:
    every stage (fast tier, split segments with carry + frozen base,
    Anderson safeguard) runs through parallel.run_sharded; nscan is
    sentinel-padded to the mesh axis. Must reach the target like the
    single-device driver."""
    from tikejax.models import (make_object, make_probe,
                                simulate_intensities)
    from tikejax.parallel import make_mesh

    g = Geometry(nz=96, n=96, nscan=67, ndet=32, nprb=24)  # 67 % 4 != 0
    rng = np.random.default_rng(1)
    scan = jnp.asarray(np.stack(
        [rng.uniform(0, g.nz - g.nprb, g.nscan),
         rng.uniform(0, g.n - g.nprb, g.nscan)], -1,
        dtype=np.float32))[None]
    psi_true = make_object(jax.random.PRNGKey(0), 1, g.nz, g.n,
                           jnp.complex64)
    prb = make_probe(1, 1, g.nprb, jnp.complex64)
    data = simulate_intensities(psi_true, scan, prb, g.ndet)
    psi0 = jnp.ones(g.psi_shape, jnp.complex64)

    target = 2e-5
    psi_1, _, st1 = reconstruct(data, psi0, scan, prb, g,
                                target_residual=target)
    psi_m, _, stm = reconstruct(data, psi0, scan, prb, g,
                                target_residual=target,
                                mesh=make_mesh(4))

    def final_res(st):
        m = st[-1][1]
        k = max(int(m["iters_run"]) - 1, 0)
        return float(np.asarray(m["residual"])[k])

    assert final_res(stm) <= target
    # Independent float summation orders: the two converged iterates
    # agree loosely, not bitwise.
    err = float(jnp.max(jnp.abs(psi_m - psi_1))
                / jnp.max(jnp.abs(psi_1)))
    assert err < 2e-2


def test_reconstruct_on_theta_scan_mesh():
    """The deep driver composes with 2-D ('theta', 'scan') meshes:
    psi/prb and the carried cg_state's
    object-domain entries stay per-angle sharded through every stage
    (run_sharded splits the carry out of the replicated metrics), and
    the host-side Anderson mixing follows the per-angle sharding. Must
    reach the target and agree with the single-device driver."""
    from tikejax.models import (make_object, make_probe,
                                simulate_intensities)
    from tikejax.parallel import make_mesh

    g = Geometry(ntheta=2, nz=96, n=96, nscan=66, ndet=32, nprb=24)
    rng = np.random.default_rng(5)
    scan = jnp.asarray(np.stack(
        [rng.uniform(0, g.nz - g.nprb, (g.ntheta, g.nscan)),
         rng.uniform(0, g.n - g.nprb, (g.ntheta, g.nscan))], -1,
        dtype=np.float32))
    psi_true = make_object(jax.random.PRNGKey(8), g.ntheta, g.nz, g.n,
                           jnp.complex64)
    prb = make_probe(g.ntheta, 1, g.nprb, jnp.complex64)
    data = simulate_intensities(psi_true, scan, prb, g.ndet)
    psi0 = jnp.ones(g.psi_shape, jnp.complex64)

    target = 1e-4
    psi_1, _, st1 = reconstruct(data, psi0, scan, prb, g,
                                target_residual=target, segment=64,
                                max_segments=16)
    psi_m, _, stm = reconstruct(data, psi0, scan, prb, g,
                                target_residual=target, segment=64,
                                max_segments=16,
                                mesh=make_mesh((2, 4)))  # 66 % 4 != 0

    def final_res(st):
        m = st[-1][1]
        k = max(int(m["iters_run"]) - 1, 0)
        return float(np.asarray(m["residual"])[k])

    assert final_res(stm) <= target
    err = float(jnp.max(jnp.abs(psi_m - psi_1))
                / jnp.max(jnp.abs(psi_1)))
    assert err < 2e-2
    # ntheta must divide by the theta axis.
    with pytest.raises(ValueError, match="divisible"):
        reconstruct(data, psi0, scan, prb, g, target_residual=target,
                    mesh=make_mesh((4, 2)))


def test_reconstruct_on_mesh_recover_prb():
    """Sharded deep driver with joint probe recovery: the joint chains
    and probe refreshes run through run_sharded too."""
    from tikejax.models import (make_object, make_probe,
                                simulate_intensities)
    from tikejax.parallel import make_mesh

    g = Geometry(nz=64, n=64, nscan=36, ndet=24, nprb=16)
    rng = np.random.default_rng(2)
    scan = jnp.asarray(np.stack(
        [rng.uniform(0, g.nz - g.nprb, g.nscan),
         rng.uniform(0, g.n - g.nprb, g.nscan)], -1,
        dtype=np.float32))[None]
    psi_true = make_object(jax.random.PRNGKey(3), 1, g.nz, g.n,
                           jnp.complex64)
    prb = make_probe(1, 1, g.nprb, jnp.complex64)
    data = simulate_intensities(psi_true, scan, prb, g.ndet)
    psi0 = jnp.ones(g.psi_shape, jnp.complex64)

    psi_m, prb_m, stm = reconstruct(data, psi0, scan, prb * 1.05, g,
                                    target_residual=1e-4,
                                    recover_prb=True, max_segments=12,
                                    mesh=make_mesh(4))
    names = [n for n, _ in stm]
    assert names[0].endswith(":joint")
    # Descended across the whole run: final stage's end residual far
    # below the first stage's starting residual.
    res0 = float(np.asarray(stm[0][1]["residual"])[0])
    m = stm[-1][1]
    k = max(int(m["iters_run"]) - 1, 0)
    res_end = float(np.asarray(m["residual"])[k])
    assert res_end < 0.1 * res0
