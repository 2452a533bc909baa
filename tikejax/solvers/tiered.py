"""Deep-residual reconstruction drivers: time-to-target as a feature.

Two schedules (the machinery behind the metric "time to a relative
residual", BASELINE.json):

1. **Stage chaining** (:func:`reconstruct` with ``method='tiers'``):
   each ``(kernel, exit_floor, max_piter)`` stage runs with an
   early-exit ``target_residual`` just above its floor and hands
   (psi, prb) to the next.

2. **Split-operator refinement** (default, ``method='split'``): after
   stage 1 reaches its floor, freeze the object as a base, compute its
   farplane ONCE, and run CG on the small correction ``delta``
   (cg.run's ``f_base``), re-freezing the base between segments, with
   L-BFGS directions and safeguarded Anderson mixing over the segment
   iterates. The schedule was built for operators whose error scales
   with the size of their input; on the XLA path both the base and the
   correction use the same float32 operators, and whether the split
   schedule still pays against one plain run is an open question
   (ROADMAP).

Stage boundaries are async dispatches (no host round-trip); split
segments read back one int32 (iters_run) to decide termination.
"""

from __future__ import annotations

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np

from tikejax.geometry import Geometry
from tikejax.models import likelihoods
from tikejax.ops import diffraction
from tikejax.solvers import cg as _cg
from tikejax.utils import checkpoint as _checkpoint
from tikejax.utils import hostio

# (kernel, exit-residual floor, default max iterations) per stage. The
# first stage's floor and budget are also the split driver's stage 1:
# down to 5e-3 within 256 iterations, then the refinement.
DEFAULT_TIERS = (
    ("xla", 5e-3, 256),
    ("xla", 1e-5, 1024),
    ("xla", 0.0, 8192),
)


_fwd_jit = jax.jit(diffraction.fwd_raw, static_argnums=(3, 4))


def reconstruct(data, psi0, scan, prb0, geometry: Geometry,
                target_residual: float = 1e-6,
                tiers=DEFAULT_TIERS, method: str = "split",
                segment: int = 256, max_segments: int = 48,
                base_kernel: str | None = None,
                fast_kernel: str | None = None,
                joint_kernel: str | None = None,
                segment_carry: bool = True,
                floor_patience: int = 3,
                accelerate: str | None = "anderson",
                mesh=None,
                checkpoint_path: str | None = None,
                checkpoint_every: int = 4,
                options: _cg.CGOptions | None = None, **kw):
    """Reconstruct to a target relative residual.

    Args:
      target_residual: relative amplitude residual sqrt(minf / sum(data))
        to stop at.
      method: 'split' (default; stage 1 to its floor, then
        split-operator refinement) or 'tiers' (run the stages of
        ``tiers`` in turn).
      tiers: sequence of (kernel, exit_floor, max_piter). method='tiers'
        runs them all; method='split' takes stage 1's floor and budget
        from the first entry. Unreachable targets simply exhaust the
        last stage's budget.
      segment / max_segments: split-mode refinement segment length (CG
        iterations between base re-freezes) and budget.
      base_kernel / fast_kernel: split-mode kernels for the base
        re-freeze and the correction segments (default 'xla'; see
        tikejax.ops.diffraction for the accepted names).
      joint_kernel: kernel for the joint escalation / probe-refresh
        chains under recover_prb (default: base_kernel).
      segment_carry: continue the conjugate-gradient trajectory across
        split-segment re-bases (the terminal direction/gradient/step
        state seeds the next segment via cg.run's ``cg_init``) instead
        of restarting each segment from steepest descent. The re-base
        keeps psi_total unchanged, but it DOES shift the effective
        objective by the fast tier's operator error at the old delta,
        so the carry is only consistent when segments are short enough
        that ||delta|| stays small. The defaults pair carry with the
        short segment; segments that end early (stall/target) always
        restart fresh.
      accelerate: 'anderson' (default), 'anderson:<depth>' (history
        depth 2..8), or None — Anderson/AA-II mixing over the
        split-segment iterate sequence (default depth 3): after each
        segment, solve the constrained least-squares problem on the
        Gram matrix of the last segment corrections and form the mixed
        iterate; a device-side safeguard evaluates BOTH candidates'
        residuals with the base kernel and keeps the better one (no
        extra host readbacks — the choice is a jnp.where). A taken mix
        invalidates the carried CG state, which restarts fresh.
        Ignored by method='tiers' (no outer iterate sequence to mix).
      mesh: optional position-sharding mesh (tikejax.parallel.make_mesh):
        every stage -- tier runs, split segments (with CG carry and the
        frozen base farplane), the Anderson safeguard, and the joint
        probe chains -- executes sharded over the scan axis via
        tikejax.parallel.run_sharded, with the base farplane frozen by
        a sharded forward and kept sharded end-to-end. The scan axis is
        sentinel-padded once up front to a multiple of the mesh axis.
        2-D ('theta', 'scan') meshes compose too: psi/prb/the carried
        cg_state's object-domain entries stay sharded per-angle
        end-to-end (run_sharded routes the carry
        as a sharded output), and the host-side Anderson mixing /
        selection / psi updates are plain jits whose sharding follows
        the per-angle operands; ``ntheta`` must divide by the theta
        axis size. Object-tiled ('obj', ...) meshes remain
        run_tiled-only: the driver's host-side iterate algebra works on
        whole-object arrays, not overlapping slabs.
      checkpoint_path / checkpoint_every: split-mode outer-loop
        restartability (the driver runs long host-controlled
        trajectories, and a crashed process would lose the run). With a
        path set, the driver atomically saves
        its complete outer state (psi, prb, segment budget, flat/refresh
        counters, residual history, Anderson history, carried cg_state,
        and the previous segment's termination scalars) via
        utils.checkpoint every ``checkpoint_every`` refinement segments,
        plus once right after the stage-1 chain. Re-calling reconstruct
        with the SAME arguments and the same path resumes from the last
        checkpoint and reproduces the remaining trajectory exactly
        (the save captures everything the host loop carries); stages
        from before the resume point are not re-reported. The file is
        removed on successful completion, so a crash-restart wrapper can
        simply re-run the same call. Geometry/segment/target mismatches
        against the checkpoint raise. Each save forces one device sync
        (it reads back the just-dispatched segment), so small
        ``checkpoint_every`` trades pipelining for durability.
        Split-mode only (method='tiers' stages are single dispatches;
        use utils.checkpoint directly there).
      floor_patience: stop after this many CONSECUTIVE refinement
        segments that each contracted the residual by less than 0.5%
        (the solver is pinned at the base kernel's operator floor or
        the data's noise floor; an unreachable target would otherwise
        burn the whole max_segments budget). The threshold is
        deliberately below a legitimate deep grind's few per cent per
        segment. 0 disables the floor stop.
      options / kw: base CGOptions (piter/kernel/target_residual are
        overridden per stage; everything else -- model, nchunks,
        linesearch, direction -- applies where compatible). NOTE on
        ``direction``: the default 'auto' resolves to two-loop L-BFGS
        (m=8) for the refinement segments, and any requested direction
        applies to the refinement segments only: the early (and joint)
        stages are always forced to Dai-Yuan, because an L-BFGS-warmed
        flat start measurably lands in bad local basins of the
        nonconvex objective (every later optimizer then stalls at
        3.09e-4 on the CPU A/B where DY-warmed runs reach <1e-4). Pass
        direction='dy' to keep Dai-Yuan refinement.
        With recover_prb=True, split mode runs stage 1 as JOINT
        object+probe CG (escalating to the base tier for deep targets),
        then freezes the recovered probe for the split refinement. If
        the object-only refinement floor-stalls above the target --
        detected either by the flat counter or EARLY, by two
        consecutive Aitken extrapolations of the per-segment residuals
        both predicting a limit above 1.2x target (the approach to a
        frozen-probe floor is near-geometric) --
        the probe is re-opened with a chain of joint base-tier
        dispatches and the refinement resumes (alternating
        minimization on demand, up to 4 refreshes); a refresh that
        itself makes no progress marks the genuine floor.

    Returns:
      (psi, prb, stages): stages is a list of (stage_name, metrics);
      metrics['iters_run'] holds each stage's actual iteration count.
      method='tiers' performs no host synchronisation; method='split'
      reads back one scalar per refinement segment.
    """
    options = _cg.make_options(options, **kw)
    if target_residual <= 0:
        raise ValueError("target_residual must be > 0; for fixed-count "
                         "runs use tikejax.solvers.run")
    if method not in ("split", "tiers"):
        raise ValueError(f"unknown method {method!r}")
    for k in [k for k, _, _ in tiers] + [base_kernel or "xla",
                                          fast_kernel or "xla",
                                          joint_kernel or "xla"]:
        diffraction.resolve_kernel(k)
    if checkpoint_path is not None:
        if method != "split":
            raise ValueError("checkpoint_path applies to method='split' "
                             "only (tier stages are single dispatches)")
        if checkpoint_every < 1:
            raise ValueError("checkpoint_every must be >= 1")
    if accelerate is not None:
        if _parse_anderson_depth(accelerate) is None:
            raise ValueError(f"unknown accelerate {accelerate!r}; use "
                             "None, 'anderson', or 'anderson:<depth>'")
    if mesh is not None:
        from tikejax.parallel.sharding import (_axes, pad_scan_problem,
                                               shard_problem)
        theta_ax, scan_ax = _axes(mesh)  # validates 1-D/2-D
        if (theta_ax is not None
                and geometry.ntheta % mesh.shape[theta_ax] != 0):
            raise ValueError(
                f"ntheta ({geometry.ntheta}) must be divisible by the "
                f"theta mesh axis size ({mesh.shape[theta_ax]})")
        data, scan, geometry = pad_scan_problem(
            data, scan, geometry, mesh.shape[scan_ax])
        data, scan = shard_problem(mesh, data, scan)
    run_fn = _make_run_fn(mesh)
    if method == "split":
        return _reconstruct_split(data, psi0, scan, prb0, geometry,
                                  target_residual, segment, max_segments,
                                  base_kernel, fast_kernel, options, tiers,
                                  segment_carry, floor_patience, accelerate,
                                  joint_kernel, mesh, checkpoint_path,
                                  checkpoint_every)

    psi, prb = psi0, prb0
    stages = []
    for tier_i, (kernel, floor, max_piter) in enumerate(tiers):
        tier_target = max(target_residual, floor)
        # Single dispatches are capped at 512 iterations; segments chain
        # asynchronously, and a segment dispatched after the target was
        # already reached exits after one iteration. (The cap dates from
        # a remote device with an execution deadline; what it costs on a
        # local GPU is not measured yet -- ROADMAP.)
        remaining = max_piter
        while remaining > 0:
            seg = min(remaining, 512)
            tier_opts = dataclasses.replace(
                options, kernel=kernel, piter=seg,
                target_residual=tier_target,
                # First tier from the flat start stays Dai-Yuan (see
                # the basin note in _reconstruct_split).
                direction="dy" if tier_i == 0 else options.direction)
            psi, prb, metrics = run_fn(data, psi, scan, prb, geometry,
                                       tier_opts)
            stages.append((kernel, metrics))
            remaining -= seg
        if floor <= target_residual:
            break  # this tier could reach the target; we're done
    return psi, prb, stages


def _make_run_fn(mesh):
    """CG-stage runner: plain single-device cg.run, or run_sharded bound
    to the mesh (identical call signature incl. f_base / cg_init)."""
    if mesh is None:
        return _cg.run

    from tikejax.parallel.sharding import run_sharded

    def run_fn(data, psi0, scan, prb0, geometry, options,
               f_base=None, cg_init=None):
        return run_sharded(data, psi0, scan, prb0, geometry, mesh,
                           options, f_base=f_base, cg_init=cg_init)

    return run_fn


def _reconstruct_split(data, psi0, scan, prb, g, target, segment,
                       max_segments, base_kernel, fast_kernel, options,
                       tiers, segment_carry=True, floor_patience=3,
                       accelerate=None, joint_kernel=None, mesh=None,
                       checkpoint_path=None, checkpoint_every=4):
    """Stage 1 to its floor, then split-operator refinement segments.

    With ``mesh`` (1-D scan mesh; data/scan arrive pre-padded and
    sharded from :func:`reconstruct`), every stage runs through
    parallel.run_sharded and the base farplane is frozen by a sharded
    forward -- it stays sharded over the scan axis end-to-end."""
    fast = fast_kernel or "xla"
    base = base_kernel or "xla"
    joint_kern = joint_kernel or base
    run_fn = _make_run_fn(mesh)
    if mesh is None:
        def fwd_base(psi_, scan_, prb_):
            return _fwd_jit(psi_, scan_, prb_, g.ndet, base)
    else:
        from tikejax.parallel.sharding import fwd_sharded

        def fwd_base(psi_, scan_, prb_):
            return fwd_sharded(psi_, scan_, prb_, g.ndet, base, mesh)
    floor = tiers[0][1] if tiers else DEFAULT_TIERS[0][1]
    stages = []

    # Outer-loop restartability: an existing
    # checkpoint at checkpoint_path means a prior identical call crashed
    # mid-refinement -- validate it and skip straight to the refinement
    # loop with the saved outer state. Stages before the resume point
    # are not re-reported (their arrays died with the crashed process).
    ck = None
    if checkpoint_path is not None and os.path.exists(checkpoint_path):
        ck = _checkpoint.load(checkpoint_path)
        _ckpt_validate(ck, g, segment, target)

    # Stage 1: plain CG down to the stage-1 floor. With recover_prb,
    # this stage recovers the probe JOINTLY; the probe is then frozen
    # for the split refinement (the probe converges long before the
    # object's deep tail; SURVEY SS2/C5 joint recovery composed with the
    # deep-residual driver).
    # The EARLY stage always runs Dai-Yuan regardless of the requested
    # direction: L-BFGS's aggressive early steps (unit-scaled
    # quasi-Newton from a flat start) measurably steer the iterate into
    # bad local basins of the nonconvex phase-retrieval objective --
    # measured on CPU (96^2/64 positions): an L-BFGS-warmed start
    # stalls EVERY later optimizer (dy or lbfgs, direct or split) at
    # 3.09e-4 where the DY-warmed start reaches <1e-4. CG's smaller
    # early steps act as the globalization phase; the user's direction
    # choice applies to the refinement segments, where the basin is
    # settled and L-BFGS's curvature memory shines.
    recover = options.recover_prb
    # Joint escalation/refresh segments run 512 joint iterations as
    # FOUR chained 128-iteration dispatches, dispatched back-to-back
    # asynchronously; early-exited tails cost one iteration each. (The
    # split into four dates from a remote device with an execution
    # deadline; whether one dispatch is faster on a local GPU is not
    # measured yet -- ROADMAP.)
    joint_opts = dataclasses.replace(options, kernel=joint_kern,
                                     piter=128, target_residual=target,
                                     direction="dy")
    if ck is None:
        opts1 = dataclasses.replace(options, kernel=fast, direction="dy",
                                    piter=tiers[0][2] if tiers else 256,
                                    target_residual=max(target, floor))
        psi, prb, m = run_fn(data, psi0, scan, prb, g, opts1)
        stages.append((fast + (":joint" if recover else ""), m))
        if recover and target < floor:
            # Deep target: the frozen probe's error would floor the
            # object refinement at roughly the stage-1 floor (measured
            # in tests: a 5%-perturbed probe frozen there stalls the
            # split phase ~4e-3). Continue the JOINT recovery before
            # freezing.
            psi, prb, _ = _joint_chain(data, psi, scan, prb, g,
                                       joint_opts, stages, run_fn)
        if target >= floor:
            return psi, prb, stages
    else:
        # Resume: the checkpoint was written inside the refinement loop,
        # so stage 1 (and any initial joint escalation) already ran.
        psi = hostio.to_device(ck["psi"])
        prb = hostio.to_device(ck["prb"])
    if recover:
        options = dataclasses.replace(options, recover_prb=False)

    # Stage 2: split-operator refinement. The base farplane is computed
    # once per segment; CG then runs on the small correction delta.
    # direction='auto' resolves to L-BFGS here (and ONLY here): the
    # basin is settled by the Dai-Yuan stage 1. Plain cg.run keeps
    # 'auto'='dy' (flat-start basin hazard).
    refine_dir = ("lbfgs" if options.direction == "auto"
                  else options.direction)
    # The refinement inherits the caller's nchunks: the frozen base
    # farplane streams through the scan chunks alongside data/scan
    # (cg._Engine), so memory-bound configs can chase deep targets by
    # passing nchunks > 1 to reconstruct.
    opts2 = dataclasses.replace(options, kernel=fast, piter=segment,
                                target_residual=target,
                                carry_state=segment_carry,
                                direction=refine_dir)
    # Jitted once, reused for every segment's psi update.
    add = jax.jit(jnp.add)

    state = _cg.zero_cg_state(psi, opts2) if segment_carry else None

    prev = None
    flat = 0
    aa_hist = []  # Anderson history of (segment output, correction)
    res_hist = []  # per-segment end residuals (Aitken floor detection)
    budget = max_segments
    # With recover_prb, a floor stall in the object-only refinement may
    # mean the FROZEN PROBE's error is the floor, not the base kernel's
    # accuracy: alternate back to a joint base-tier segment to re-open
    # the probe, then resume the split refinement (classic alternating
    # minimization, but only triggered on demand). A refresh that itself
    # makes no progress identifies the genuine floor.
    refreshes = 4 if recover else 0
    aa_depth = (_parse_anderson_depth(accelerate) if accelerate is not None
                else 0)
    f_next = None  # chosen farplane handed forward by the Anderson step
    if ck is not None:
        (flat, budget, refreshes, res_hist, prev, aa_hist,
         state) = _ckpt_restore(ck, state)
    elif checkpoint_path is not None:
        # Initial checkpoint right after stage 1: a crash during the
        # first refinement segments resumes without redoing stage 1.
        _ckpt_save(checkpoint_path, g, segment, target, psi, prb, budget,
                   flat, refreshes, res_hist, prev, aa_hist, state)
    seg_i = 0
    while budget > 0:
        budget -= 1
        f_base = (f_next if f_next is not None
                  else fwd_base(psi, scan, prb))
        f_next = None
        delta0 = hostio.czeros(g.psi_shape, psi.dtype)
        delta, _, m = run_fn(data, delta0, scan, prb, g, opts2,
                             f_base=f_base, cg_init=state)
        # Drop the only base-farplane reference as soon as the segment
        # is dispatched (the runtime keeps the buffer alive until the
        # program completes): at scale the base IS the HBM budget, and
        # holding it across the next re-freeze would double the peak.
        f_base = None
        psi = add(psi, delta)
        stages.append((f"split:{fast}", m))
        if segment_carry:
            state = _masked_state(m["cg_state"], m["iters_run"], segment)
        if aa_depth:
            # History stores RAW map evaluations (segment outputs and
            # their corrections) — a taken mix is a combination of
            # them, not a new evaluation, so it never enters history.
            aa_hist.append((psi, delta))
            del aa_hist[:-aa_depth]
            if len(aa_hist) >= 2:
                psi, took, f_next = _anderson_step(
                    [p for p, _ in aa_hist], [d for _, d in aa_hist],
                    data, scan, prb, fwd_base)
                if segment_carry:
                    # A taken mix moves psi off the carried trajectory;
                    # zero the state on device (fresh restart) there.
                    state = _masked_state_flag(state, took)
        # Pipelined termination test: read back the PREVIOUS segment's
        # scalars while the segment just dispatched runs, so the host
        # never waits on the segment it has just queued. (Tuned for a
        # remote device with a slow readback; what it saves on a local
        # GPU is not measured yet -- ROADMAP.) A segment dispatched after
        # the target was already reached exits on device after one
        # iteration (the early-exit while-loop sees the target met), so
        # the one-deep speculation wastes only a base re-freeze.
        if prev is not None:
            reached, contraction, res_end = _segment_status(prev, segment,
                                                            target)
            if reached:
                break
            res_hist.append(res_end)
            can_refresh = refreshes > 0 and budget > 0
            want_refresh = False
            if contraction > _FLOOR_CONTRACTION:
                flat += 1
                # Operator floor: successive segments are not
                # descending; the target is below what the base
                # kernel's accuracy supports -- stop burning budget.
                if floor_patience > 0 and flat >= floor_patience:
                    if not can_refresh:
                        break
                    want_refresh = True
            else:
                flat = 0
            if (not want_refresh and can_refresh
                    and _probe_floor_predicted(res_hist, target)):
                # Early probe-floor detection: re-open the probe now
                # instead of grinding to the flat threshold.
                want_refresh = True
            if want_refresh:
                refreshes -= 1
                budget -= 1
                psi, prb, (r_reached, r_contr) = _joint_chain(
                    data, psi, scan, prb, g, joint_opts, stages, run_fn,
                    target=target)
                if r_reached:
                    _ckpt_done(checkpoint_path)
                    return psi, prb, stages
                if r_contr > _FLOOR_CONTRACTION:
                    break  # probe refresh flat too: genuine floor
                flat, prev = 0, None
                res_hist = []
                aa_hist = []  # joint segment changed the map
                f_next = None  # pending base used the old probe
                state = (_cg.zero_cg_state(psi, opts2) if segment_carry
                         else None)
                continue
        prev = m
        seg_i += 1
        if checkpoint_path is not None and seg_i % checkpoint_every == 0:
            # One sync per save (reads back the just-dispatched segment's
            # scalars and the iterate) -- the documented durability cost.
            _ckpt_save(checkpoint_path, g, segment, target, psi, prb,
                       budget, flat, refreshes, res_hist, prev, aa_hist,
                       state)
    _ckpt_done(checkpoint_path)
    return psi, prb, stages


# Per-segment residual contraction at or above which a segment counts
# as FLAT for the floor stop. Deliberately tight: a legitimate deep
# grind contracts by a few per cent per segment (1e-6 -> 3.2e-7 over 41
# segments on the headline problem), so only truly floor-pinned segments
# (<0.5% progress) count.
_FLOOR_CONTRACTION = 0.995


# Device-side carry guard: an all-zeros state is EXACTLY what run_impl
# builds for cg_init=None (fresh steepest-descent start; an empty
# count=0 L-BFGS ring under carry_lbfgs -- cg.zero_cg_state builds the
# matching layout), so masking the carried tuple keeps the carry
# decision on device (no per-segment readback) and compiles ONE solver
# variant for all segments. Segments that end early (stall or target)
# restart fresh -- a stalled direction is one the line search already
# rejected. Budget-exhausted segments always carry, even when
# per-segment progress is a few percent: no progress-based masking is
# applied.
@jax.jit
def _masked_state(cg_state, iters_run, segment):
    keep = iters_run >= segment
    return jax.tree_util.tree_map(
        lambda x: jnp.where(keep, x, jnp.zeros_like(x)), cg_state)


# Anderson (AA-II) default mixing depth over the split-segment iterate
# sequence. 3 is the classic small-memory choice; the history is a
# python list of device arrays (a few MB at 512²), so depth is cheap to
# change per-call via accelerate='anderson:<depth>'.
_AA_DEPTH = 3


def _parse_anderson_depth(accelerate: str):
    """Depth for 'anderson'/'anderson:<d>' (2..8), else None."""
    if accelerate == "anderson":
        return _AA_DEPTH
    if isinstance(accelerate, str) and accelerate.startswith("anderson:"):
        try:
            d = int(accelerate.split(":", 1)[1])
        except ValueError:
            return None
        if 2 <= d <= 8:
            return d
    return None


def _anderson_step(psis, deltas, data, scan, prb, fwd_base):
    """One safeguarded Anderson mixing step over segment outputs.

    ``psis``/``deltas`` are the last m ≤ _AA_DEPTH segment outputs
    G(x_j) and their corrections r_j = G(x_j) − x_j. Solves the
    constrained least squares min ‖Σ α_j r_j‖, Σ α_j = 1 on the real
    Gram matrix (Tikhonov-regularized), forms x_mix = Σ α_j G(x_j),
    then evaluates BOTH candidates' gaussian amplitude residuals with
    the accurate base forward ``fwd_base`` (plain jitted single-device,
    or shard_map-backed under a mesh -- the farplanes and the residual
    reductions then stay sharded; the selection scalar is global) and
    returns (chosen iterate, took-mix flag, chosen farplane) — all on
    device (the caller's control flow never reads any of it back; the
    farplane is reused as the next segment's base re-freeze). The
    gaussian-scale residual is used as the safeguard statistic for any
    likelihood model (it is a selection heuristic, not the objective).
    """
    psi_mix = _anderson_mix(tuple(psis), tuple(deltas))
    psi_plain = psis[-1]
    f_mix = fwd_base(psi_mix, scan, prb)
    f_plain = fwd_base(psi_plain, scan, prb)
    # The chosen candidate's farplane IS the next segment's base
    # re-freeze (same kernel, same psi) — returning it saves one
    # accurate-tier forward per mixed segment.
    return _anderson_select(psi_mix, psi_plain, f_mix, f_plain, data)


@jax.jit
def _anderson_mix(psis, deltas):
    m = len(deltas)
    R = jnp.stack([d.ravel() for d in deltas])           # (m, N) complex
    # Full float32 precision: the m x m Gram matrix sets the mixing
    # weights, and a GPU's default matmul precision may use TF32.
    G = jnp.real(jnp.matmul(R, jnp.conj(R).T,
                            precision=jax.lax.Precision.HIGHEST))
    Greg = G + (1e-7 * jnp.trace(G) / m + 1e-30) * jnp.eye(m, dtype=G.dtype)
    alpha = jnp.linalg.solve(Greg, jnp.ones((m,), G.dtype))
    alpha = alpha / jnp.sum(alpha)
    return jnp.einsum("i,i...->...", alpha, jnp.stack(psis))


@jax.jit
def _anderson_select(psi_mix, psi_plain, f_mix, f_plain, data):
    sum_d = jnp.sum(jnp.maximum(data, 0.0))

    def res(f):
        return jnp.sqrt(jnp.maximum(
            likelihoods.gaussian_minf(f, data), 0.0) / sum_d)

    take = res(f_mix) < res(f_plain)
    return (jnp.where(take, psi_mix, psi_plain), take,
            jnp.where(take, f_mix, f_plain))


@jax.jit
def _masked_state_flag(cg_state, took_mix):
    return jax.tree_util.tree_map(
        lambda x: jnp.where(took_mix, jnp.zeros_like(x), x), cg_state)


# --- split-driver outer-loop checkpointing -----------------------------------
#
# The refinement loop's control state lives in host Python; these helpers
# round-trip ALL of it through utils.checkpoint (atomic npz, complex-safe)
# so a crashed process costs at most checkpoint_every segments. Saved at a single program
# point (end of a loop iteration, just after ``prev = m``), so a resumed
# process re-enters the loop with bit-identical host state; the device
# trajectory is deterministic from (psi, prb, state), and the one
# non-saved optimization (the Anderson reuse path's forwarded farplane
# f_next) is recomputed by the same kernel from the same iterate.


def _ckpt_save(path, g, segment, target, psi, prb, budget, flat,
               refreshes, res_hist, prev, aa_hist, state):
    tree = {
        "meta": {
            "version": np.int64(1),
            "segment": np.int64(segment),
            "target": np.float64(target),
            "geom": np.asarray([g.ntheta, g.nz, g.n, g.nscan, g.ndet,
                                g.nprb, g.nmodes], np.int64),
        },
        "psi": psi,
        "prb": prb,
        "ctl": {
            "budget": np.int64(budget),
            "flat": np.int64(flat),
            "refreshes": np.int64(refreshes),
            "res_hist": np.asarray(res_hist, np.float64),
            "has_prev": np.int64(prev is not None),
        },
    }
    if prev is not None:
        # Everything _segment_status consumes from the previous segment.
        tree["prev"] = {"iters_run": prev["iters_run"],
                        "residual": prev["residual"]}
    if aa_hist:
        tree["aa"] = {
            "psis": {str(i): p for i, (p, _) in enumerate(aa_hist)},
            "deltas": {str(i): d for i, (_, d) in enumerate(aa_hist)},
        }
    if state is not None:
        tree["state"] = {str(i): x for i, x in enumerate(state)}
    _checkpoint.save(path, tree)


def _ckpt_validate(ck, g, segment, target):
    meta = ck.get("meta")
    geom = np.asarray([g.ntheta, g.nz, g.n, g.nscan, g.ndet, g.nprb,
                       g.nmodes], np.int64)
    if meta is None or "geom" not in meta:
        raise ValueError("checkpoint_path exists but is not a reconstruct "
                         "split-driver checkpoint")
    if (not np.array_equal(np.asarray(meta["geom"]), geom)
            or int(meta["segment"]) != segment
            or float(meta["target"]) != target):
        raise ValueError(
            "existing checkpoint was written by a DIFFERENT reconstruct "
            "call (geometry/segment/target mismatch); remove it or pass "
            "the original arguments to resume")


def _ckpt_restore(ck, state):
    """Loop state from a loaded checkpoint; complex arrays re-uploaded
    to the device. ``state`` is the
    fresh zero state, replaced only when the checkpoint carried one."""
    ctl = ck["ctl"]
    res_hist = [float(x) for x in np.asarray(ctl["res_hist"]).ravel()]
    prev = None
    if int(ctl["has_prev"]):
        # numpy arrays pass straight through hostio.to_host in
        # _segment_status, exactly like freshly-read-back metrics.
        prev = {"iters_run": ck["prev"]["iters_run"],
                "residual": ck["prev"]["residual"]}
    aa_hist = []
    if "aa" in ck:
        psis, deltas = ck["aa"]["psis"], ck["aa"]["deltas"]
        aa_hist = [(hostio.to_device(psis[str(i)]),
                    hostio.to_device(deltas[str(i)]))
                   for i in range(len(psis))]
    if "state" in ck and state is not None:
        st = ck["state"]
        state = tuple(hostio.to_device(st[str(i)]) for i in range(len(st)))
    return (int(ctl["flat"]), int(ctl["budget"]), int(ctl["refreshes"]),
            res_hist, prev, aa_hist, state)


def _ckpt_done(path):
    """Remove the checkpoint on successful completion, so re-running the
    same call starts fresh instead of resuming a finished run."""
    if path is not None and os.path.exists(path):
        os.remove(path)


def _joint_chain(data, psi, scan, prb, g, joint_opts, stages, run_fn,
                 target=None, n=4):
    """Run n chained joint dispatches (async, no host round-trips
    between them), appending each as a ':joint' stage (labelled with
    the kernel the chain ACTUALLY runs -- joint_opts.kernel may differ
    from the base tier via reconstruct's joint_kernel knob). With
    ``target``, returns (reached, contraction-across-the-chain) as the
    third element (two scalar readbacks); else None."""
    ms = []
    for _ in range(n):
        psi, prb, m = run_fn(data, psi, scan, prb, g, joint_opts)
        stages.append((joint_opts.kernel + ":joint", m))
        ms.append(m)
    if target is None:
        return psi, prb, None
    kl = int(hostio.to_host(ms[-1]["iters_run"]))
    rl = hostio.to_host(ms[-1]["residual"])
    res_end = float(rl[max(kl - 1, 0)])
    reached = kl < joint_opts.piter and res_end <= target
    r0 = float(hostio.to_host(ms[0]["residual"])[0])
    return psi, prb, (reached, res_end / max(r0, 1e-300))


def _segment_status(m, segment, target):
    """(reached, contraction, res_end) for a completed split segment.

    Early exit (iters_run < budget) means target reached OR line-search
    stall at the segment's floor (stop_on_stall); only the former sets
    ``reached`` -- a stalled segment gets a fresh base, which is exactly
    the remedy for a stall (the correction restarts from zero against a
    more accurate farplane). ``contraction`` is res_end/res_start, the
    floor-stop statistic.
    """
    ran = int(hostio.to_host(m["iters_run"]))
    res = hostio.to_host(m["residual"])
    res_end = float(res[max(ran - 1, 0)])
    reached = ran < segment and res_end <= target
    contraction = res_end / max(float(res[0]), 1e-300)
    return reached, contraction, res_end


def _aitken_limit(r0, r1, r2):
    """Aitken Δ² estimate of the limit of a near-geometric residual
    sequence, or None when the last three points aren't a decelerating
    monotone decay (ratio outside (0, 0.95))."""
    d1, d2 = r1 - r0, r2 - r1
    if d1 >= 0 or d2 >= 0:
        return None
    rho = d2 / d1
    if not (0.0 < rho < 0.95):
        return None
    return r2 - d2 * d2 / (d2 - d1)


def _probe_floor_predicted(res_hist, target):
    """Early probe-floor detection on the per-segment end residuals.

    The object-only split phase approaches a FROZEN PROBE's error floor
    as a near-geometric sequence, and the flat counter then waits several
    more near-flat segments before firing the probe refresh. Aitken-
    extrapolate the last two residual triples instead: when BOTH predict
    a limit clearly above the target, the refinement is asymptoting at
    probe error, not heading to the target. Double confirmation plus
    the 1.2x margin keep healthy runs (whose limit is below target)
    from misfiring; non-recover runs never consult this (refreshes=0).
    """
    if len(res_hist) < 4:
        return False
    lim1 = _aitken_limit(*res_hist[-4:-1])
    lim2 = _aitken_limit(*res_hist[-3:])
    return (lim1 is not None and lim2 is not None
            and lim1 > 1.2 * target and lim2 > 1.2 * target)
