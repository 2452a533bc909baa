"""Joint object+probe Dai-Yuan conjugate-gradient ptychography solver.

Re-design of the reference CG loop ([R] libtike/cufft/ptycho.py
``run``; SURVEY.md SS2/C5, SS3.1). Same algorithm family -- Dai-Yuan
nonlinear CG with backtracking line search, Gaussian/Poisson likelihoods,
optional joint probe recovery, multi-mode probes, position minibatching --
but the *entire* reconstruction runs inside a single ``jax.jit`` as a
``lax.fori_loop``: zero host round-trips per iteration, versus the
reference's 3-5 host<->device crossings (SURVEY.md SS3.1, north star in
BASELINE.json).

Key departures from the reference, justified by XLA's execution model:

* **Line search on quadratic sufficient statistics.** The forward operator
  is linear in psi (and in prb), so ``|G(psi + gamma*d)|^2`` per pixel is
  ``a + 2*gamma*b + gamma^2*c`` with ``a = sum_m |G psi|^2``,
  ``b = sum_m Re(conj(G psi) * G d)``, ``c = sum_m |G d|^2``. One pass over
  the two farplanes yields (a, b, c); every backtracking step then reads
  three real arrays instead of re-evaluating the forward model (the
  reference exploits linearity the same way but re-reads complex frames).
  The backtracking itself is a ``lax.while_loop`` -- on device, data
  independent of the host.
* **Position minibatching inside jit**: ``nchunks > 1`` streams scan
  chunks through a ``lax.scan``, never materialising the full farplane --
  the gradient pass and the line-search statistics are accumulated
  per-chunk (reference chunks operator calls from the host; SURVEY.md
  SS2/C5 minibatching).
* **Mesh-sharded execution**: with ``axis_name`` set (see
  tikejax.parallel), scalar objectives and the object/probe gradients are
  ``psum``-ed across the scan-sharded mesh axis; everything else is
  replicated arithmetic.
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from tikejax.geometry import Geometry
from tikejax.models import likelihoods
from tikejax.ops import diffraction


@dataclasses.dataclass(frozen=True)
class CGOptions:
    """Static solver configuration (hashable: safe as a jit static arg).

    Attributes:
      piter: number of CG iterations.
      model: 'gaussian' or 'poisson' likelihood.
      recover_prb: jointly update the probe (alternating within each
        iteration, as in the reference).
      step0: initial line-search step.
      step_shrink: backtracking shrink factor.
      max_halvings: bound on backtracking steps (then gamma=0, no move).
      nchunks: scan-position minibatching factor; >1 streams chunks through
        lax.scan without materialising the full farplane. Must divide nscan.
      kernel: operator implementation -- 'auto' (default) or 'xla',
        which both select the XLA gather / batched FFT / scatter path
        (see tikejax.ops.diffraction; removed kernel names raise).
      axis_name: mesh axis name for scan-sharded execution (psum of scalars
        and gradients); None for single-device runs.
      theta_axis_name: mesh axis name sharding the (embarrassingly
        parallel) ``ntheta`` angle axis (SURVEY.md SS5 P2). The object,
        probe and their gradients stay sharded per-angle (no collective);
        only the scalar objective/line-search/Dai-Yuan statistics are
        additionally psum-ed over this axis so every device agrees on the
        global step sizes, matching the single-device solver exactly.
      verbose_every: if >0, jax.debug.print (iter, minf, gamma) every N
        iterations (the reference prints residuals from the host loop).
    """

    piter: int = 32
    model: str = "gaussian"
    recover_prb: bool = False
    step0: float = 1.0
    step_shrink: float = 0.5
    max_halvings: int = 16
    nchunks: int = 1
    kernel: str = "auto"
    axis_name: str | None = None
    theta_axis_name: str | None = None
    # Object-domain tiling (SURVEY.md SS5 P3; tikejax.parallel.tiling):
    # obj_axis_name shards the object row axis into equal slabs, each
    # device holding its owned rows plus obj_halo halo rows BELOW (the
    # probe-window overlap into the next slab). Positions are owner-
    # partitioned; the adjoint's halo rows are ppermute-reduced to their
    # owning device and the halos refreshed every gradient pass, so all
    # object-domain arrays stay halo-consistent. Scalars psum over the
    # axis; object-domain inner products mask the halo rows (they
    # duplicate the neighbour's owned rows). obj_axis_size is the static
    # mesh-axis extent (needed for the ppermute permutations).
    obj_axis_name: str | None = None
    obj_halo: int = 0
    obj_axis_size: int = 1
    verbose_every: int = 0
    # Gradient preconditioner: 'illum' divides the object gradient by the
    # probe-illumination map (and the probe gradient by the object power
    # map) -- pixelwise, the classic ptychography preconditioner, usually
    # much better conditioned than the reference's scalar 1/max|prb|^2
    # ('max'); 'illum_lowk' composes 'illum' with an SPD Fourier filter
    # 1 + lowk_boost*k0^2/(k0^2 + |k|^2) that amplifies smooth gradient
    # components (object-only runs, single device); 'none' disables.
    # 'illum_lowk' is OPT-IN only: it accelerated a sparse-overlap toy
    # (5x lower residual at 48 iters, 64 positions on 96^2); on dense
    # scans the illumination map already equalizes the spectrum.
    precondition: str = "illum"
    # 'illum_lowk' filter parameters: boost amplitude and the crossover
    # frequency k0 as a fraction of Nyquist.
    lowk_boost: float = 4.0
    lowk_frac: float = 0.05
    # Warm-start the backtracking from the previous accepted step
    # (False: always start from step0). The growth policy is
    # step_policy below.
    adaptive_step: bool = True
    # Warm-start regrow factor: each iteration's line search starts from
    # min(step0, step_growth * previous accepted step). A CGOptions
    # field -- not an env knob -- so it participates in the jit cache key.
    step_growth: float = 4.0
    # Warm-start growth policy:
    #   'regrow' -- start from min(step0, 4x previous step) every
    #     iteration (classic): cheap halvings make the extra probes
    #     worthwhile for convergence speed per iteration.
    #   'track'  -- grow 4x only when the previous start was accepted
    #     outright; after halvings, track the previous step exactly;
    #     after a total failure, keep the previous start. The step can
    #     decay smoothly to epsilon at the residual floor without ever
    #     failing outright, so stop_on_stall may never fire. Kept
    #     selectable for experimentation.
    #   'auto'   -- 'regrow'.
    step_policy: str = "auto"
    # Stop early once the relative residual drops to this value
    # (0 disables: the loop always runs piter iterations). The residual
    # is sqrt(max(minf - minf_perfect, 0) / sum(data)): for gaussian
    # minf_perfect = 0 (amplitude misfit scale), for poisson it is the
    # objective's perfect-fit value so the statistic is the normalised
    # generalized KL divergence (comparable scale, see
    # likelihoods.poisson_perfect_minf).
    # With a target set the loop is a lax.while_loop; metrics entries for
    # unexecuted iterations stay 0 and metrics['iters_run'] records the
    # actual count.
    target_residual: float = 0.0
    # Search-direction rule for the OBJECT step: 'auto' (default)
    # resolves to 'dy' here in run() -- a standalone solve must stay
    # globalization-safe (an L-BFGS-warmed FLAT start measurably lands
    # in bad local basins on the CPU A/B) -- while
    # solvers.reconstruct resolves it to 'lbfgs' for the split
    # refinement segments, where the basin is settled. 'dy' is the
    # reference's Dai-Yuan
    # nonlinear CG ([R] libtike/cufft/ptycho.py,
    # SURVEY.md SS2/C5); 'lbfgs' / 'lbfgs:<m>' is two-loop L-BFGS on
    # the preconditioned gradient (ring of the last m (s, y) pairs,
    # default m=8, curvature-guarded: pairs with <s,y> <= 1e-12
    # ||s|| ||y|| are skipped, and a fully-failed line search clears
    # the memory so the next step restarts from steepest descent).
    # The natural step of the H0-scaled direction is 1, so the warm
    # start uses gamma0=1 once history exists. CPU-oracle A/B (fp64,
    # 96^2/128 positions, iterations to 1e-6): DY 200, lbfgs:3 176,
    # lbfgs:5 156, lbfgs:8 150, lbfgs:12 149. The probe step always
    # uses Dai-Yuan (the joint alternation re-bases the probe
    # objective every iteration, which invalidates quasi-Newton
    # curvature pairs).
    direction: str = "auto"
    # Stop after this many CONSECUTIVE iterations whose line searches
    # fully failed (gamma = 0 for the object step and, under joint
    # recovery, the probe step too): the objective cannot be decreased
    # along the search directions even after max_halvings backtracking
    # steps, i.e. the solver is at its (operator-accuracy) floor.
    # Without this, every post-floor iteration burns max_halvings + 1
    # objective evaluations making no progress. 0 disables.
    stop_on_stall: int = 2
    # Line-search policy:
    #   'interp' -- backtracking, but on the FIRST rejection take one
    #     safeguarded quadratic-interpolation step: with f(0),
    #     f'(0) = <grad, d> and f(gamma0), the model minimiser
    #     -f'(0) gamma0^2 / (2 (f(gamma0) - f(0) - f'(0) gamma0)),
    #     clipped to [shrink^2, shrink] * gamma0, replaces the next
    #     halving candidate; plain halving continues from there if
    #     still rejected. Saves ~1 evaluation on the 2-halving pattern
    #     the 4x regrow produces, but accepts slightly smaller steps
    #     than pure halving would.
    #   'backtracking' -- reference-style pure halving until decrease:
    #     best per-iteration descent, more evaluations.
    #   'parabolic' -- backtracking + a vertex refinement of the
    #     ACCEPTED step (~2 extra evaluations; the vertex can chase
    #     objective noise in a deep tail); kept opt-in.
    #   'auto' (default) -- 'interp'. Whether backtracking wins on a
    #     GPU is not measured yet (ROADMAP).
    linesearch: str = "auto"
    # Return the terminal CG carry (direction, previous gradient,
    # accepted step, step start) in metrics['cg_state'] so a follow-up
    # run can continue the SAME conjugate-gradient trajectory via
    # ``cg_init`` instead of restarting from steepest descent --
    # solvers.tiered threads this across split-operator segments so a
    # base re-freeze no longer loses CG momentum (object step only;
    # probe CG state is not carried).
    carry_state: bool = False
    # With carry_state and an L-BFGS direction, also carry the ring of
    # (s, y) curvature pairs in metrics['cg_state'] (8-tuple layout:
    # the 4 scalar/array CG slots + (S, Y, sy, count)) so a follow-up
    # segment re-opens with the full quasi-Newton memory instead of
    # rebuilding it from the one implicitly-seeded cross-segment pair.
    # The same consistency argument as carry_state applies: the re-base
    # shifts the objective by the fast tier's operator error at the old
    # ||delta||, so carried pairs are only as good as segments are
    # short: stale cross-rebase pairs can mislead the natural-step line
    # search exactly where steps are tiny. Kept opt-in, default off.
    carry_lbfgs: bool = False


def _lbfgs_memory(direction: str) -> int:
    """Ring size for direction='lbfgs[:m]'; 0 for 'dy'/'auto' (run()
    resolves 'auto' to Dai-Yuan -- flat-start basin hazard)."""
    if direction in ("dy", "auto"):
        return 0
    base, _, depth = direction.partition(":")
    if base != "lbfgs" or (depth and not depth.isdigit()):
        raise ValueError(f"unknown direction {direction!r}; "
                         "expected 'auto', 'dy', 'lbfgs', or "
                         "'lbfgs:<m>'")
    m = int(depth) if depth else 8
    if not 1 <= m <= 32:
        raise ValueError(f"lbfgs memory must be in [1, 32], got {m}")
    return m


@functools.partial(jax.jit, static_argnums=(1,))
def _zero_cg_state_jit(psi, lbfgs_m):
    zc = jnp.zeros_like(psi)
    zr = jnp.zeros((), jnp.real(psi).dtype)
    state = (zc, zc, zr, zr)
    if lbfgs_m:
        ring = jnp.zeros((lbfgs_m,) + psi.shape, psi.dtype)
        state += (ring, ring, jnp.zeros((lbfgs_m,), zr.dtype),
                  jnp.zeros((), jnp.int32))
    return state


def zero_cg_state(psi, options: CGOptions):
    """All-zeros carry matching metrics['cg_state'] for these options.

    An all-zeros state is EXACTLY what run_impl builds for cg_init=None
    (fresh steepest-descent start; an empty count=0 L-BFGS ring), so
    callers can mask a carried state to zeros on device (tree_map +
    jnp.where) to express 'restart fresh' without a second compiled
    solver variant -- see solvers.tiered."""
    m = _lbfgs_memory(options.direction) if options.carry_lbfgs else 0
    return _zero_cg_state_jit(psi, m)


def _rdot(a, b):
    """Real inner product of (complex) arrays viewed as real vectors.

    Pinned to full float32 precision: these products set every Dai-Yuan
    beta, line-search slope and L-BFGS pair, and a GPU's default matmul
    precision may run them in TF32 (about three decimal digits)."""
    return jnp.real(jnp.vdot(a, b, precision=lax.Precision.HIGHEST))


def _psum(x, axis_name):
    """psum over one axis name, a tuple of axis names, or None (no-op)."""
    if axis_name is None or axis_name == ():
        return x
    return lax.psum(x, axis_name)


def _scalar_axes(o: "CGOptions"):
    """Mesh axes over which scalar statistics are globally summed: the
    scan axis (positions partition the data sum) plus, when set, the
    theta axis (angles partition it too) and the object-tiling axis
    (positions are owner-partitioned across slabs)."""
    axes = tuple(a for a in (o.theta_axis_name, o.axis_name,
                             o.obj_axis_name)
                 if a is not None)
    return axes if axes else None


def _obj_vary_axes(o: "CGOptions"):
    """Mesh axes along which OBJECT-DOMAIN arrays are device-varying:
    per-angle theta sharding and object tiling. Scan-sharded runs keep
    the object replicated (no axis)."""
    axes = tuple(a for a in (o.theta_axis_name, o.obj_axis_name)
                 if a is not None)
    return axes if axes else None


def _grad_prb_axes(o: "CGOptions"):
    """Axes that partition the probe-gradient sum (probe is replicated
    across both the scan and the object-tiling axes)."""
    axes = tuple(a for a in (o.axis_name, o.obj_axis_name)
                 if a is not None)
    return axes if axes else None


def _halo_fix(x, o: "CGOptions"):
    """Reduce-then-refresh the object-tiling halo of a slab-sharded
    object-domain array ``x`` (t, owned + halo, n):

    1. each device's halo rows (partial sums belonging to the NEXT
       device's top rows) are ppermute'd forward and added there;
    2. each device's (now complete) top rows are ppermute'd backward
       into the previous device's halo, restoring the invariant that
       halo rows mirror the neighbour's owned rows.

    The last device's halo becomes zero (it has no successor); its scan
    windows never reach it (global bounds guarantee y_local <=
    owned - nprb there)."""
    axis, halo, size = o.obj_axis_name, o.obj_halo, o.obj_axis_size
    if axis is None or halo == 0 or size <= 1:
        return x
    owned = x.shape[1] - halo
    fwd_perm = [(d, d + 1) for d in range(size - 1)]
    bwd_perm = [(d + 1, d) for d in range(size - 1)]
    recv = lax.ppermute(x[:, owned:], axis, fwd_perm)
    x = x.at[:, :halo].add(recv)
    top = lax.ppermute(x[:, :halo], axis, bwd_perm)
    return x.at[:, owned:].set(top)


def _mask_halo(x, o: "CGOptions"):
    """Owned-rows view of a slab-sharded object-domain array (halo rows
    duplicate the neighbour's owned rows and must not be double-counted
    in inner products)."""
    if o.obj_axis_name is None or o.obj_halo == 0:
        return x
    return x[:, :x.shape[1] - o.obj_halo]


def _pvary(x, axis_names):
    """Mark a replicated value as device-varying along the mesh axes, so it
    can serve as the carry init of accumulations over sharded data inside
    shard_map (JAX tracks 'varying manual axes' and rejects mixing)."""
    if axis_names is None or axis_names == ():
        return x
    if isinstance(axis_names, str):
        axis_names = (axis_names,)
    if hasattr(lax, "pcast"):
        return lax.pcast(x, axis_names, to="varying")
    return lax.pvary(x, axis_names)  # pre-0.9 JAX


def _chunked(x, nchunks):
    """(ntheta, nscan, ...) -> (nchunks, ntheta, nscan/nchunks, ...).
    Applied leaf-wise, so a split-pair base farplane chunks too."""
    def one(x):
        t, s = x.shape[0], x.shape[1]
        return x.reshape(t, nchunks, s // nchunks,
                         *x.shape[2:]).swapaxes(0, 1)

    return jax.tree.map(one, x)


def _quad_stats(fpsi, fd):
    """Per-pixel quadratic coefficients of |fpsi + gamma*fd|^2 summed over
    modes: returns (a, b, c) real arrays of shape (ntheta, nscan, nd, nd)."""
    a = likelihoods.total_intensity(fpsi)
    b = jnp.sum(jnp.real(jnp.conj(fpsi) * fd), axis=2)
    c = likelihoods.total_intensity(fd)
    return a, b, c


def _minf_of_gamma(model, a, b, c, data, gamma):
    """Objective at psi + gamma*d from quadratic statistics."""
    intensity = jnp.maximum(a + 2.0 * gamma * b + gamma * gamma * c, 0.0)
    d = jnp.maximum(data, 0.0)
    if model == "gaussian":
        amp = jnp.sqrt(intensity + 1e-12)
        return jnp.sum((amp - jnp.sqrt(d))**2)
    else:  # poisson
        return jnp.sum(intensity - d * jnp.log(intensity + 1e-8))


class _Engine:
    """Geometry/options-bound internals of the CG loop.

    Every method is pure and traced under jit; the class only carries static
    configuration (shapes, model name, chunking) resolved at trace time.
    """

    def __init__(self, g: Geometry, o: CGOptions, f_base=None):
        if g.nscan % o.nchunks != 0:
            raise ValueError(
                f"nchunks ({o.nchunks}) must divide nscan ({g.nscan})")
        if o.model not in likelihoods.MODELS:
            raise ValueError(f"unknown model {o.model!r}")
        diffraction.resolve_kernel(o.kernel)
        if o.precondition not in ("illum", "illum_lowk", "max", "none"):
            raise ValueError(f"unknown precondition {o.precondition!r}; "
                             "expected 'illum', 'illum_lowk', 'max', or "
                             "'none'")
        if o.precondition == "illum_lowk":
            if o.recover_prb:
                raise ValueError("precondition='illum_lowk' is "
                                 "object-only (the low-k filter has no "
                                 "probe analogue); run joint recovery "
                                 "with 'illum' first")
            if o.obj_axis_name is not None:
                raise ValueError("precondition='illum_lowk' needs the "
                                 "full object spectrum; it does not "
                                 "compose with object-domain tiling")
            if o.lowk_boost < 0 or not (0 < o.lowk_frac <= 0.5):
                raise ValueError("lowk_boost must be >= 0 and lowk_frac "
                                 "in (0, 0.5]")
        if o.linesearch not in ("auto", "interp", "backtracking",
                                "parabolic"):
            raise ValueError(f"unknown linesearch {o.linesearch!r}; "
                             "expected 'auto', 'interp', 'backtracking',"
                             " or 'parabolic'")
        self.ls = "interp" if o.linesearch == "auto" else o.linesearch
        self.lbfgs_m = _lbfgs_memory(o.direction)
        if o.step_policy not in ("auto", "track", "regrow"):
            raise ValueError(f"unknown step_policy {o.step_policy!r}; "
                             "expected 'auto', 'track', or 'regrow'")
        if o.target_residual < 0:
            raise ValueError("target_residual must be >= 0")
        if o.step_growth < 1.0:
            raise ValueError("step_growth must be >= 1 (the warm start "
                             "may only regrow toward step0)")
        if o.stop_on_stall < 0:
            raise ValueError("stop_on_stall must be >= 0")
        self.g = g
        self.o = o
        self.minf_fn, self.resid_fn = likelihoods.get_model(o.model)
        # Split-operator refinement mode: psi is a small correction delta
        # on top of a frozen base object whose farplane f_base was
        # computed once (solvers.tiered). nchunks > 1 streams the base
        # farplane through the scan chunks alongside data/scan.
        self.f_base = f_base
        if f_base is not None and o.recover_prb:
            raise ValueError("split-operator mode (f_base) does not "
                             "support joint probe recovery; rebase "
                             "the probe between segments instead")

    # -- operator shorthands ------------------------------------------------

    def _fwd(self, psi, scan, prb):
        return diffraction.fwd_raw(psi, scan, prb, self.g.ndet, self.o.kernel)

    def _fwd_obj(self, psi, scan, prb, f_base=None):
        """Farplane of the OBJECT estimate: G psi, plus the frozen base
        farplane in split-operator mode (direction farplanes stay _fwd:
        the operator is linear, only the object carries the offset)."""
        fp = self._fwd(psi, scan, prb)
        return fp if f_base is None else fp + f_base

    def _adj(self, farp, scan, prb):
        return diffraction.adj_raw(farp, scan, prb, self.g.nz, self.g.n,
                                   self.o.kernel)

    def _adj_probe(self, farp, scan, psi):
        return diffraction.adj_probe_raw(farp, scan, psi, self.g.nprb,
                                         self.o.kernel)

    def _fwd_dir(self, psi, prb, scan, dpsi, dprb):
        """Farplane of the search direction: G dpsi for an object step,
        G(psi) evaluated with dprb as the probe for a probe step (fwd is
        linear in each)."""
        if dpsi is not None:
            return self._fwd(dpsi, scan, prb)
        return self._fwd(psi, scan, dprb)

    def _chunks(self, scan, data):
        """Scan-chunked (scan, data[, f_base]) inputs for lax.scan."""
        n = self.o.nchunks
        xs = (_chunked(scan, n), _chunked(data, n))
        if self.f_base is not None:
            xs += (_chunked(self.f_base, n),)
        return xs

    # -- gradient passes ----------------------------------------------------

    def grad_pass(self, psi, prb, scan, data, want_psi=True,
                  want_prb=False):
        """One pass over all positions: returns (minf, grad_psi, grad_prb,
        fpsi). Gradients not requested via want_psi/want_prb are None
        (the joint solver requests only what each alternation step uses).

        In streaming mode (nchunks > 1) this is a lax.scan over scan
        chunks with accumulated outputs; the full farplane never exists
        and fpsi is None -- in materialised mode fpsi is returned so the
        line-search pass can reuse it instead of re-running the forward
        model.
        """
        o = self.o
        fpsi = None
        gpsi = gprb = None
        if o.nchunks == 1:
            fpsi = self._fwd_obj(psi, scan, prb, self.f_base)
            with jax.named_scope("likelihood"):
                f0 = self.minf_fn(fpsi, data)
                resid = self.resid_fn(fpsi, data)
            if want_psi:
                gpsi = self._adj(resid, scan, prb)
            if want_prb:
                gprb = self._adj_probe(resid, scan, psi)
        else:
            def step(carry, inp):
                f_acc, gpsi_acc, gprb_acc = carry
                sc, dc = inp[:2]
                fp = self._fwd_obj(psi, sc, prb,
                                   inp[2] if len(inp) > 2 else None)
                with jax.named_scope("likelihood"):
                    f_acc = f_acc + self.minf_fn(fp, dc)
                    r = self.resid_fn(fp, dc)
                if want_psi:
                    gpsi_acc = gpsi_acc + self._adj(r, sc, prb)
                if want_prb:
                    gprb_acc = gprb_acc + self._adj_probe(r, sc, psi)
                return (f_acc, gpsi_acc, gprb_acc), None

            real_dtype = np.empty(0, np.result_type(psi.dtype)).real.dtype
            init = jax.tree.map(
                lambda x: _pvary(x, _scalar_axes(o)),
                (jnp.zeros((), real_dtype),
                 jnp.zeros_like(psi) if want_psi else jnp.zeros(()),
                 jnp.zeros_like(prb) if want_prb else jnp.zeros(())))
            (f0, gpsi, gprb), _ = lax.scan(step, init,
                                           self._chunks(scan, data))
            if not want_psi:
                gpsi = None
            if not want_prb:
                gprb = None
        # Scalars are global sums (scan/theta/obj axes all partition the
        # frame sum); the object gradient is per-theta and per-slab, so
        # it reduces over the scan axis and then has its tiling halo
        # reduced+refreshed; the probe gradient is replicated, so it
        # psums over both position-partitioning axes.
        f0 = _psum(f0, _scalar_axes(o))
        if gpsi is not None:
            gpsi = _halo_fix(_psum(gpsi, o.axis_name), o)
        if gprb is not None:
            gprb = _psum(gprb, _grad_prb_axes(o))
        return f0, gpsi, gprb, fpsi

    def quad_pass(self, psi, prb, scan, data, *, dpsi=None, dprb=None,
                  fpsi=None):
        """Line-search statistics for a step along dpsi (object step) or
        dprb (probe step): returns closure gamma -> global minf(gamma).

        Exploits linearity of the forward model; in streaming mode the
        (a, b, c, data) reduction happens per chunk inside the backtracking
        loop's *setup* pass only -- each backtracking step then reduces the
        accumulated statistics, never re-running the forward model.
        """
        o = self.o
        assert (dpsi is None) != (dprb is None)
        if o.nchunks == 1:
            fp = (fpsi if fpsi is not None
                  else self._fwd_obj(psi, scan, prb, self.f_base))
            fd = self._fwd_dir(psi, prb, scan, dpsi, dprb)
            with jax.named_scope("likelihood"):
                a, b, c = _quad_stats(fp, fd)

            def f_of(gamma):
                with jax.named_scope("likelihood"):
                    return _psum(
                        _minf_of_gamma(o.model, a, b, c, data, gamma),
                        _scalar_axes(o))

            return f_of

        # Streaming: cannot hold (a, b, c) for all positions without
        # defeating the point, but they are 3 real arrays vs 2 complex
        # mode-resolved farplanes -- 3/(4*nmodes) of the memory. For the
        # memory-bound configs (many modes) that is the win that makes
        # in-jit backtracking possible at all; each backtracking step reads
        # the statistics, not the model.
        def step(carry, inp):
            sc = inp[0]
            fp = self._fwd_obj(psi, sc, prb, inp[2] if len(inp) > 2 else None)
            fd = self._fwd_dir(psi, prb, sc, dpsi, dprb)
            with jax.named_scope("likelihood"):
                return carry, _quad_stats(fp, fd)

        xs = self._chunks(scan, data)
        data_c = xs[1]
        _, (a_c, b_c, c_c) = lax.scan(step, None, xs)

        def f_of(gamma):
            def red(carry, inp):
                a, b, c, dc = inp
                return carry + _minf_of_gamma(o.model, a, b, c, dc,
                                              gamma), None

            with jax.named_scope("likelihood"):
                total, _ = lax.scan(
                    red, _pvary(jnp.zeros(()), _scalar_axes(o)),
                    (a_c, b_c, c_c, data_c))
            return _psum(total, _scalar_axes(o))

        return f_of

    # -- line search ----------------------------------------------------

    def step_policy(self) -> str:
        if self.o.step_policy == "auto":
            return "regrow"
        return self.o.step_policy

    def _gamma0(self, dtype, gamma_prev, gamma0_prev):
        """Warm start (see CGOptions.adaptive_step / step_policy):
        ``gamma_prev`` is the last ACCEPTED step (0 on failure),
        ``gamma0_prev`` the start actually used last iteration."""
        o = self.o
        gamma0 = jnp.asarray(o.step0, dtype)
        if not o.adaptive_step or gamma_prev is None:
            return gamma0
        if self.step_policy() == "regrow":
            return jnp.where(gamma_prev > 0,
                             jnp.minimum(gamma0,
                                         o.step_growth * gamma_prev),
                             gamma0).astype(dtype)
        # 'track': step_growth-x growth only when the previous start was
        # accepted outright (fast recovery toward step0), exact tracking
        # after halvings (the envelope is shrinking -- regrowing just
        # buys extra halvings: the always-regrow start measured 3.07
        # evals/iter on the headline trajectory), previous start kept
        # on total failure.
        grown = jnp.where(gamma_prev >= gamma0_prev,
                          o.step_growth * gamma_prev, gamma_prev)
        warm = jnp.where(
            gamma_prev > 0, jnp.minimum(gamma0, grown),
            jnp.where(gamma0_prev > 0, gamma0_prev, gamma0))
        return warm.astype(dtype)

    def lbfgs_gamma0(self, dtype, count, gamma_prev, gamma0_prev):
        """Line-search start for the L-BFGS direction: the H0-scaled
        direction's natural step is 1 once history exists, so the
        default start is 1 (a regrow policy is equivalent -- min(1,
        4x previous) recovers to 1 after any accept above 0.25).
        With step_policy='track', a previous iteration that had to
        backtrack starts the next search at its ACCEPTED step instead
        (ceiling 1; outright accepts and failures restart at 1) --
        the idea was to save the rejection evaluation when the natural
        step is persistently too long, but it took more iterations to
        reach 1e-6 on the headline problem (1247 against 1048: the
        smaller warm starts slow descent more than the saved
        evaluations gain). Kept selectable; the default stays the
        natural step."""
        one = jnp.ones((), dtype)
        if self.step_policy() == "track":
            # Clamp to the natural-step ceiling 1: with step0 > 1 the
            # count==0 iteration may accept a backtracked step above 1,
            # which must not become the quasi-Newton warm start.
            with_hist = jnp.where(
                gamma_prev <= 0, one,
                jnp.where(gamma_prev >= gamma0_prev, one,
                          jnp.minimum(one, gamma_prev.astype(dtype))))
        else:
            with_hist = one
        return jnp.where(count > 0, with_hist,
                         self._gamma0(dtype, gamma_prev, gamma0_prev))

    def _interp_gamma(self, gamma0, f0, fg0, fp0):
        """Safeguarded quadratic-interpolation candidate after the first
        candidate was rejected: minimiser of the quadratic through
        (0, f0) with slope fp0 and (gamma0, fg0), clipped to
        [shrink^2, shrink] * gamma0 -- never beyond what plain halving
        would try next, so deep-tail objective noise degrades gracefully
        to backtracking instead of being chased."""
        o = self.o
        denom = fg0 - f0 - fp0 * gamma0
        good = jnp.logical_and(denom > 0, fp0 < 0)
        gi = jnp.where(good,
                       -fp0 * gamma0 * gamma0
                       / (2.0 * jnp.where(denom > 0, denom, 1.0)),
                       gamma0 * o.step_shrink)
        # Tight safeguard [shrink^2, shrink] * gamma0: the model may
        # only skip ONE halving, never take a tiny step (a noisy model
        # under-steps near the residual floor).
        lo = o.step_shrink * o.step_shrink * gamma0
        return jnp.clip(gi, lo,
                        o.step_shrink * gamma0).astype(gamma0.dtype)

    def line_search(self, f_of, f0, gamma0, fp0=None):
        """Backtracking: largest gamma in {gamma0 * shrink^k} with
        f(gamma) <= f0; gamma = 0 if none within max_halvings (the
        reference's simple-decrease halving search). With
        linesearch='interp' and a directional derivative ``fp0``, the
        first halving candidate is replaced by the safeguarded
        quadratic-interpolation step."""
        o = self.o

        st0 = (gamma0, f_of(gamma0), 0)
        # The interp candidate replaces the FIRST halving, so it is
        # only taken when the policy allows at least one halving.
        if self.ls == "interp" and fp0 is not None and o.max_halvings > 0:
            def do(st):
                gi = self._interp_gamma(gamma0, f0, st[1], fp0)
                return gi, f_of(gi), 1

            st0 = lax.cond(st0[1] > f0, do, lambda st: st, st0)

        def cond(st):
            gamma, fg, k = st
            return jnp.logical_and(fg > f0, k < o.max_halvings)

        def body(st):
            gamma, fg, k = st
            gamma = gamma * o.step_shrink
            return gamma, f_of(gamma), k + 1

        gamma, fg, _ = lax.while_loop(cond, body, st0)
        gamma = jnp.where(fg <= f0, gamma, jnp.zeros_like(gamma))
        if self.ls == "parabolic":
            gamma = self._parabolic_refine(f_of, f0, gamma, fg)
        return gamma

    def _parabolic_refine(self, f_of, f0, gamma, fg):
        """Refine an accepted backtracking step to the vertex of the
        parabola through (0, f0), (gamma/2, fm), (gamma, fg): a near-exact
        line search for two extra statistics reductions. Monotone by
        construction -- the vertex candidate is only taken when it beats
        the sampled points, and a rejected search (gamma = 0) is passed
        through untouched."""
        fm = f_of(gamma * 0.5)
        curv = f0 - 2.0 * fm + fg          # = C * gamma^2 / 2, C = d2f
        vertex = (0.25 * gamma * (3.0 * f0 + fg - 4.0 * fm)
                  / jnp.where(curv > 0, curv, 1.0))
        vertex = jnp.clip(vertex, 0.125 * gamma, 2.0 * gamma)
        fv = f_of(vertex)
        # argmin over the three sampled gammas (f0 anchors the <= f0
        # guarantee: every candidate here already satisfies f <= f0 or
        # loses the argmin to one that does).
        cand_g = jnp.stack([gamma, gamma * 0.5, vertex])
        cand_f = jnp.stack([fg, fm, fv])
        best = jnp.argmin(cand_f)
        ok = jnp.logical_and(gamma > 0, curv > 0)
        refined = jnp.where(cand_f[best] <= fg, cand_g[best], gamma)
        return jnp.where(ok, refined, gamma)

    # -- Dai-Yuan direction ----------------------------------------------

    def _dot(self, a, b, kind):
        """Global real inner product of object- ('psi') or probe-domain
        ('prb') arrays: object arrays may be theta-sharded and slab-
        sharded (halo rows masked to avoid double counting); probe arrays
        are replicated except over theta."""
        o = self.o
        if kind == "psi":
            axes = tuple(ax for ax in (o.theta_axis_name, o.obj_axis_name)
                         if ax is not None) or None
            return _psum(_rdot(_mask_halo(a, o), _mask_halo(b, o)), axes)
        return _psum(_rdot(a, b), o.theta_axis_name)

    def dy_direction(self, grad, grad_prev, d_prev, restart, kind="psi"):
        """d = -g + beta * d_prev, beta = ||g||^2 / <d_prev, g - g_prev>_R
        (Dai-Yuan 1999), with a zero-division guard that yields steepest
        descent on the first iteration (d_prev = 0). ``restart`` (the
        previous line search failed, so the iterate did not move) forces
        steepest descent: the gradient is then recomputed at the same
        point, and on a GPU the atomic scatter-add makes g - g_prev
        rounding noise instead of zero, which would blow beta up along
        the direction that just failed. The inner products are global
        (psum-ed over whichever mesh axes shard the arrays), so beta is
        a global scalar."""
        num = self._dot(grad, grad, kind)
        den = self._dot(d_prev, grad - grad_prev, kind)
        ok = jnp.logical_and(den != 0, jnp.logical_not(restart))
        beta = jnp.where(ok, num / jnp.where(den != 0, den, 1.0), 0.0)
        return -grad + beta.astype(grad.dtype) * d_prev

    # -- L-BFGS direction (direction='lbfgs[:m]') --------------------------

    def lbfgs_init(self, like, real_dtype):
        """Empty L-BFGS state: (S, Y, sy, count) with S/Y rings of m
        arrays shaped like ``like`` (oldest first, newest at index m-1)
        and sy the matching curvature inner products."""
        m = self.lbfgs_m
        z = jnp.zeros((m,) + like.shape, like.dtype)
        # Inherit the object-domain device-varying markers: under a
        # theta (or object-tiling) mesh the (s, y) pairs pushed into the
        # ring vary per device, and an unvarying zero init would fail
        # the while_loop carry typing (surfaced by the 2-D-mesh deep
        # driver). Scalar slots stay replicated (their updates
        # come from psum-ed global dots).
        z = _pvary(z, _obj_vary_axes(self.o))
        return (z, z, jnp.zeros((m,), real_dtype),
                jnp.zeros((), jnp.int32))

    def lbfgs_push(self, lb, s, y, accepted, kind="psi"):
        """Append the (s, y) pair when the previous step was accepted
        AND it passes the curvature guard <s,y> > 1e-12 ||s|| ||y||
        (skipped pairs keep the ring unchanged -- standard damped-free
        L-BFGS update-skip; the guard also rejects the zero pairs a
        fresh start or a rejected step produces)."""
        S, Y, SY, count = lb
        sy = self._dot(s, y, kind)
        ss = self._dot(s, s, kind)
        yy = self._dot(y, y, kind)
        ok = jnp.logical_and(accepted, sy > 1e-12 * jnp.sqrt(ss * yy))

        def push(ring, v):
            rolled = jnp.concatenate([ring[1:], v[None]], axis=0)
            return jnp.where(ok, rolled, ring)

        return (push(S, s), push(Y, y), push(SY, sy.astype(SY.dtype)),
                jnp.where(ok, jnp.minimum(count + 1, self.lbfgs_m),
                          count))

    def lbfgs_direction(self, grad, lb, kind="psi"):
        """Two-loop recursion on the (already preconditioned) gradient.
        H0 = (<s,y>/<y,y>) I from the newest pair scales the direction
        so the natural line-search step is 1. With count = 0 this
        reduces exactly to steepest descent. All inner products are
        global (psum-ed / halo-masked via _dot), so the direction is
        consistent under position sharding and object tiling."""
        S, Y, SY, count = lb
        m = self.lbfgs_m
        rdt = SY.dtype

        def rho(i):
            return jnp.where(SY[i] > 0,
                             1.0 / jnp.maximum(SY[i], 1e-300), 0.0)

        def bwd(j, carry):
            q, al = carry
            i = m - 1 - j
            valid = i >= m - count
            a = jnp.where(valid, rho(i) * self._dot(S[i], q, kind), 0.0)
            q = q - a.astype(q.dtype) * Y[i]
            return q, al.at[i].set(a.astype(rdt))

        q, al = lax.fori_loop(0, m, bwd, (grad, jnp.zeros((m,), rdt)))
        yy = self._dot(Y[m - 1], Y[m - 1], kind)
        h0 = jnp.where(jnp.logical_and(count > 0, yy > 0),
                       SY[m - 1] / jnp.maximum(yy, 1e-300), 1.0)
        q = q * h0.astype(q.dtype)

        def fwdl(i, q):
            valid = i >= m - count
            b = jnp.where(valid, rho(i) * self._dot(Y[i], q, kind), 0.0)
            return q + (al[i] - b).astype(q.dtype) * S[i]

        q = lax.fori_loop(0, m, fwdl, q)
        return -q

    @staticmethod
    def lbfgs_reset_on_stall(lb, gamma):
        """Clear the memory (count -> 0) after a fully-failed line
        search so the next direction restarts from steepest descent
        (the stale rings stay allocated but count masks them out)."""
        S, Y, SY, count = lb
        return (S, Y, SY,
                jnp.where(gamma > 0, count, jnp.zeros_like(count)))


def _precondition(gpsi, prb):
    """Scale the object gradient by 1 / max_pixel(sum_m |prb_m|^2) per angle
    (the reference's 1/max|prb|^2 scaling, SURVEY.md SS2/C5) so the natural
    line-search step is O(1)."""
    power = jnp.sum(jnp.abs(prb)**2, axis=1)  # (ntheta, nprb, nprb)
    pmax = jnp.max(power, axis=(-2, -1))      # (ntheta,)
    scale = (1.0 / jnp.maximum(pmax, 1e-32)).astype(gpsi.dtype)
    return gpsi * scale[:, None, None]


def _lowk_symbol(nz, n, boost, frac):
    """Real positive Fourier symbol 1 + boost*k0^2/(k0^2 + |k|^2) with
    k0 = frac * Nyquist; self-adjoint and positive-definite as a real-
    linear operator, so it is a valid CG preconditioner factor."""
    fy = jnp.fft.fftfreq(nz)[:, None]
    fx = jnp.fft.fftfreq(n)[None, :]
    k2 = fy ** 2 + fx ** 2
    k02 = (0.5 * frac) ** 2
    return 1.0 + boost * k02 / (k02 + k2)


def _illum_denominator(prb, scan_int, nz, n, o: CGOptions):
    """Denominator of the pixelwise object preconditioner: the probe-
    illumination map sum_k T_k(sum_m |prb_m|^2), regularised at 10% of
    its (globally pmax-ed under object tiling) per-angle maximum; halo
    reduce+refreshed like gradients under tiling."""
    from tikejax.ops import patches as _patches

    power = jnp.sum(jnp.abs(prb)**2, axis=1)  # (t, nprb, nprb)
    illum = _patches.illumination_map(scan_int, power, nz, n)
    illum = _halo_fix(_psum(illum, o.axis_name), o)
    m = jnp.max(illum, axis=(-2, -1), keepdims=True)
    if o.obj_axis_name is not None:
        m = lax.pmax(m, o.obj_axis_name)
    return jnp.maximum(illum, 0.1 * m)


def _precondition_psi_illum(gpsi, prb, scan_int, nz, n, o: CGOptions):
    """Pixelwise object preconditioner: divide by the probe-illumination
    map (classic ptychography preconditioner; far better conditioned
    than the scalar scaling when overlap density varies)."""
    denom = _illum_denominator(prb, scan_int, nz, n, o)
    return gpsi / denom.astype(gpsi.dtype)


def _precondition_prb_illum(gprb, psi, scan_int, o: CGOptions):
    """Pixelwise probe preconditioner: divide by the object power seen by
    each probe pixel across all positions, regularised at 10% of max."""
    from tikejax.ops import patches as _patches

    nprb = gprb.shape[-1]
    field_power = jnp.abs(psi)**2  # (t, nz, n)
    seen = _patches.patch_power_map(scan_int, field_power, nprb)
    seen = _psum(seen, _grad_prb_axes(o))
    floor = 0.1 * jnp.max(seen, axis=(-2, -1), keepdims=True)
    return gprb / jnp.maximum(seen, floor)[:, None].astype(gprb.dtype)


def run_impl(geometry: Geometry, options: CGOptions, data, psi0, scan, prb0,
             f_base=None, cg_init=None):
    """Unjitted CG loop body. Called under jit by :func:`run`, or inside
    ``shard_map`` by :mod:`tikejax.parallel` (which sets options.axis_name
    and passes the per-shard geometry). With ``f_base`` set, psi0 is a
    small correction on a frozen base object whose (accurately computed)
    farplane is ``f_base`` -- see _Engine and solvers.tiered.

    ``cg_init`` -- a (direction, previous preconditioned gradient,
    accepted gamma, gamma0) tuple as returned in metrics['cg_state']
    under ``options.carry_state`` (extended by the (S, Y, sy, count)
    L-BFGS ring under ``options.carry_lbfgs``) -- seeds the loop carry
    so the run
    CONTINUES a prior conjugate-gradient trajectory (first Dai-Yuan
    beta computed against the carried direction) instead of opening
    with steepest descent. The caller must hand a state taken at the
    same iterate (e.g. across a split-operator re-base, where psi_total
    is unchanged)."""
    from tikejax.ops import patches as _patches

    eng = _Engine(geometry, options, f_base)
    o = options
    real_dtype = np.empty(0, dtype=np.result_type(psi0.dtype)).real.dtype

    scan_i = _patches.scan_to_int(scan)
    # Relative-residual normalisation: residual =
    # sqrt(max(minf - minf_offset, 0) / sum_data). The gaussian amplitude
    # objective is already a nonnegative misfit (offset 0); the Poisson
    # objective is strongly negative near its optimum (any count > e),
    # so its residual is the excess over the perfect-fit value
    # minf(I = d) -- the generalized KL divergence, zero iff I = d and
    # ~2x the gaussian amplitude misfit near the optimum (see
    # likelihoods.poisson_perfect_minf). Without the offset the old
    # gaussian-scale formula clamped to 0 for the whole Poisson run and
    # tripped target_residual after one iteration.
    sum_data = _psum(jnp.sum(jnp.maximum(data, 0.0)), _scalar_axes(o))
    if o.model == "poisson":
        minf_offset = _psum(likelihoods.poisson_perfect_minf(data),
                            _scalar_axes(o))
    else:
        minf_offset = jnp.zeros((), real_dtype)

    metrics0 = {
        "minf": jnp.zeros((o.piter,), real_dtype),
        "residual": jnp.zeros((o.piter,), real_dtype),
        "gamma": jnp.zeros((o.piter,), real_dtype),
        "grad_norm": jnp.zeros((o.piter,), real_dtype),
        "gamma_prb": jnp.zeros((o.piter,), real_dtype),
    }

    if o.precondition in ("illum", "illum_lowk") and not o.recover_prb:
        # Object-only runs: the probe never changes, so the
        # illumination map (an FFT convolution + a delta scatter over
        # all positions) is loop-INVARIANT. Precompute
        # the divisor once instead of per accepted candidate; XLA does
        # not hoist it out of the fori/while loop body on its own.
        _illum_denom = _illum_denominator(prb0, scan_i, geometry.nz,
                                          geometry.n, o)
        if o.precondition == "illum_lowk":
            # SPD low-frequency boost: multiply the gradient spectrum by
            # the real positive symbol 1 + boost*k0^2/(k0^2 + |k|^2)
            # (self-adjoint under the real inner product, so CG theory
            # still applies). Two 2-D FFTs of the object per
            # preconditioner application -- negligible next to the
            # per-frame work.
            _lowk = _lowk_symbol(geometry.nz, geometry.n, o.lowk_boost,
                                 o.lowk_frac)

            def precond_psi(gpsi, prb):
                gpsi = gpsi / _illum_denom.astype(gpsi.dtype)
                spec = jnp.fft.fft2(gpsi)
                return jnp.fft.ifft2(spec * _lowk.astype(gpsi.dtype))
        else:

            def precond_psi(gpsi, prb):
                return gpsi / _illum_denom.astype(gpsi.dtype)
    else:
        def precond_psi(gpsi, prb):
            if o.precondition == "illum":
                return _precondition_psi_illum(gpsi, prb, scan_i,
                                               geometry.nz, geometry.n, o)
            if o.precondition == "max":
                return _precondition(gpsi, prb)
            return gpsi

    def precond_prb(gprb, psi):
        if o.precondition == "illum":
            return _precondition_prb_illum(gprb, psi, scan_i, o)
        return gprb

    def body(i, st):
        (psi, prb, d_psi, g_psi_prev, d_prb, g_prb_prev, gam_prev,
         gam0_prev, gam_p_prev, gam0_p_prev, *lb_state, metrics) = st

        # ---- object step ----
        f0, gpsi_raw, _, fpsi = eng.grad_pass(psi, prb, scan, data,
                                              want_psi=True,
                                              want_prb=False)
        gpsi = precond_psi(gpsi_raw, prb)
        if eng.lbfgs_m:
            lb = eng.lbfgs_push(tuple(lb_state),
                                gam_prev.astype(psi.dtype) * d_psi,
                                gpsi - g_psi_prev, gam_prev > 0)
            d_psi = eng.lbfgs_direction(gpsi, lb)
            gamma0 = eng.lbfgs_gamma0(real_dtype, lb[3], gam_prev,
                                      gam0_prev)
        else:
            lb = ()
            d_psi = eng.dy_direction(gpsi, g_psi_prev, d_psi,
                                     restart=gam_prev <= 0)
            gamma0 = eng._gamma0(real_dtype, gam_prev, gam0_prev)
        f_of = eng.quad_pass(psi, prb, scan, data, dpsi=d_psi, fpsi=fpsi)
        # Directional derivative of the objective along d: for a real
        # objective of a complex field, f'(0) = 2 Re<grad, d> with the
        # Wirtinger gradient (RAW: the preconditioner rescales grad, not
        # f). Verified against finite differences.
        fp0 = 2.0 * eng._dot(gpsi_raw, d_psi, "psi")
        gamma = eng.line_search(f_of, f0, gamma0, fp0)
        psi = psi + gamma.astype(psi.dtype) * d_psi
        g_psi_prev = gpsi

        gamma_p = jnp.zeros((), real_dtype)
        gamma0_p = gam0_p_prev
        if o.recover_prb:
            # ---- probe step (alternating, reference style) ----
            # Gradient w.r.t. prb at the *updated* psi: recompute the
            # residual pass (the farplane changed with psi).
            f0p, _, gprb_raw, fpsi2 = eng.grad_pass(psi, prb, scan, data,
                                                    want_psi=False,
                                                    want_prb=True)
            gprb = precond_prb(gprb_raw, psi)
            d_prb = eng.dy_direction(gprb, g_prb_prev, d_prb,
                                     restart=gam_p_prev <= 0, kind="prb")
            gamma0_p = eng._gamma0(real_dtype, gam_p_prev, gam0_p_prev)
            f_of_p = eng.quad_pass(psi, prb, scan, data, dprb=d_prb,
                                   fpsi=fpsi2)
            fp0_p = 2.0 * eng._dot(gprb_raw, d_prb, "prb")
            gamma_p = eng.line_search(f_of_p, f0p, gamma0_p, fp0_p)
            prb = prb + gamma_p.astype(prb.dtype) * d_prb
            g_prb_prev = gprb

        if eng.lbfgs_m:
            lb = eng.lbfgs_reset_on_stall(lb, gamma)

        residual = jnp.sqrt(
            jnp.maximum(f0 - minf_offset, 0.0) / sum_data).astype(real_dtype)
        metrics = {
            "minf": metrics["minf"].at[i].set(f0.astype(real_dtype)),
            "residual": metrics["residual"].at[i].set(residual),
            "gamma": metrics["gamma"].at[i].set(gamma),
            "grad_norm": metrics["grad_norm"].at[i].set(jnp.sqrt(
                eng._dot(gpsi, gpsi, "psi")).astype(real_dtype)),
            "gamma_prb": metrics["gamma_prb"].at[i].set(gamma_p),
        }
        if o.verbose_every > 0:
            def _print(_):
                jax.debug.print(
                    "iter {i}: minf={f:.6e} gamma={g:.4f}", i=i, f=f0, g=gamma)
                return 0
            lax.cond(i % o.verbose_every == 0, _print, lambda _: 0, 0)
        return (psi, prb, d_psi, g_psi_prev, d_prb, g_prb_prev, gamma,
                gamma0, gamma_p, gamma0_p, *lb, metrics)

    zscal = jnp.zeros((), real_dtype)
    # L-BFGS ring buffers ride at the tail of the carry (just before
    # metrics), so the cg_state slot indices and the st[-1] metrics
    # access stay put. By default the ring is NOT carried across split
    # segments (cg_init seeds one cross-segment curvature pair
    # implicitly: the first push uses the carried (d, gamma, g)); with
    # options.carry_lbfgs the full ring rides in the 8-tuple cg_state
    # instead.
    ring_carry = bool(eng.lbfgs_m) and o.carry_lbfgs
    lb0 = eng.lbfgs_init(psi0, real_dtype) if eng.lbfgs_m else ()
    if cg_init is not None:
        if ring_carry:
            if len(cg_init) != 8:
                raise ValueError("carry_lbfgs expects the 8-tuple "
                                 "cg_state layout (4 CG slots + the "
                                 f"(S, Y, sy, count) ring); got "
                                 f"{len(cg_init)} entries")
            d_in, g_in, gam_in, gam0_in, S_in, Y_in, sy_in, cnt_in = \
                cg_init
            lb0 = (S_in.astype(psi0.dtype), Y_in.astype(psi0.dtype),
                   sy_in.astype(real_dtype), cnt_in.astype(jnp.int32))
            if lb0[0].shape[0] != eng.lbfgs_m:
                raise ValueError(
                    f"carried L-BFGS ring has m={lb0[0].shape[0]}, "
                    f"options request m={eng.lbfgs_m}")
        else:
            if len(cg_init) != 4:
                raise ValueError(
                    "cg_init has an 8-entry (L-BFGS ring) layout but "
                    "this run carries only the 4-tuple (d, g, gamma, "
                    "gamma0) CG slots -- pass carry_lbfgs=True with an "
                    "L-BFGS direction to consume the ring, or feed the "
                    f"4-tuple state (got {len(cg_init)} entries)")
            d_in, g_in, gam_in, gam0_in = cg_init
        gam_in = gam_in.astype(real_dtype)
        gam0_in = gam0_in.astype(real_dtype)
    else:
        d_in, g_in = jnp.zeros_like(psi0), jnp.zeros_like(psi0)
        gam_in, gam0_in = zscal, zscal
    st0 = (psi0, prb0, d_in, g_in,
           jnp.zeros_like(prb0), jnp.zeros_like(prb0),
           gam_in, gam0_in, zscal, zscal, *lb0, metrics0)
    if o.target_residual > 0 or o.stop_on_stall > 0:
        # Early-exit loop: stop once the previous iteration's relative
        # residual reached the target, or after stop_on_stall
        # consecutive fully-failed line searches (solver at its
        # operator-accuracy floor). Still zero host round-trips -- the
        # stop conditions live on device.
        def wcond(carry):
            i, st = carry
            m = st[-1]
            keep = i < o.piter
            if o.target_residual > 0:
                res = m["residual"][jnp.maximum(i - 1, 0)]
                keep = jnp.logical_and(
                    keep,
                    jnp.logical_or(i == 0, res > o.target_residual))
            if o.stop_on_stall > 0:
                n = o.stop_on_stall
                stalled = i >= n
                for k in range(1, n + 1):
                    idx = jnp.maximum(i - k, 0)
                    moved = jnp.logical_or(m["gamma"][idx] != 0,
                                           m["gamma_prb"][idx] != 0)
                    stalled = jnp.logical_and(
                        stalled, jnp.logical_not(moved))
                keep = jnp.logical_and(keep, jnp.logical_not(stalled))
            return keep

        def wbody(carry):
            i, st = carry
            return i + 1, body(i, st)

        iters_run, st_end = lax.while_loop(
            wcond, wbody, (jnp.zeros((), jnp.int32), st0))
    else:
        st_end = lax.fori_loop(0, o.piter, body, st0)
        iters_run = jnp.asarray(o.piter, jnp.int32)
    psi, prb, metrics = st_end[0], st_end[1], st_end[-1]
    metrics = dict(metrics, iters_run=iters_run)
    if o.carry_state:
        # Terminal CG carry: slot 2 is the last search direction, slot 3
        # the (preconditioned) gradient that built it; the accepted gamma
        # and its start sit at slots 6/7. Feed back via
        # run_impl(cg_init=...).
        cs = (st_end[2], st_end[3], st_end[6], st_end[7])
        if ring_carry:
            # The ring is the 4-slot block just before metrics.
            cs = cs + tuple(st_end[-5:-1])
        metrics["cg_state"] = cs
    return psi, prb, metrics


# Options of earlier releases that selected the removed hand-written
# kernels (fused line search, frameless and merged evaluation, object row
# slabs, kernel frame counts). Passing one raises instead of being ignored.
REMOVED_OPTIONS = ("fused_linesearch", "memory", "merged_linesearch",
                   "obj_slabs", "obj_slabs_partitioned", "obj_slab_rows",
                   "obj_slab_cols", "kernel_frames")


def make_options(options: CGOptions | None = None, **kw) -> CGOptions:
    """CGOptions from a base ``options`` (default: all defaults) with
    keyword overrides -- the shared front of :func:`run`,
    ``solvers.reconstruct`` and the ``parallel`` runners. A removed option
    raises ValueError naming the removal."""
    removed = sorted(set(kw) & set(REMOVED_OPTIONS))
    if removed:
        raise ValueError(
            f"option(s) {removed} were removed together with the "
            "hand-written kernels they selected; the XLA path needs none")
    if options is None:
        return CGOptions(**kw)
    return dataclasses.replace(options, **kw) if kw else options


def run(data, psi0, scan, prb0, geometry: Geometry,
        options: CGOptions | None = None, f_base=None, cg_init=None,
        **kw):
    """Reconstruct object (and optionally probe) from measured intensities.

    The counterpart of the reference's
    ``solver.run(data, psi, scan, prb, piter, model, recover_prb)``
    (SURVEY.md SS3.1). Extra keyword arguments override CGOptions fields.
    For time-to-deep-residual reconstruction prefer
    :func:`tikejax.solvers.reconstruct`.

    Returns:
      (psi, prb, metrics) where metrics is a dict of per-iteration arrays
      {'minf', 'residual', 'gamma', 'grad_norm', 'gamma_prb'} of shape
      (piter,); 'residual' is the relative misfit
      sqrt(max(minf - minf_perfect, 0) / sum(data)) -- the relative
      amplitude misfit under the gaussian model (minf_perfect = 0), the
      normalised generalized KL divergence under poisson (comparable
      scale near the optimum; likelihoods.poisson_perfect_minf).
    """
    options = normalize_options(make_options(options, **kw))
    return _run_cg_jit(geometry, options, data, psi0, scan, prb0, f_base,
                       cg_init)


def normalize_options(options: CGOptions) -> CGOptions:
    """Resolve 'auto' kernel selection (done host-side, before the options
    become a static jit argument), and normalize flag interactions."""
    options = dataclasses.replace(
        options, kernel=diffraction.resolve_kernel(options.kernel))
    # carry_lbfgs extends the carried cg_state with the L-BFGS ring; on
    # its own there is no cg_state to extend, so it implies carry_state.
    if options.carry_lbfgs and not options.carry_state:
        options = dataclasses.replace(options, carry_state=True)
    return options


_run_cg_jit = jax.jit(run_impl, static_argnums=(0, 1))
