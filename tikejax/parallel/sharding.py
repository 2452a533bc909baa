"""Multi-device execution: scan-position sharding over a device mesh.

The reference is strictly single-GPU (SURVEY.md SS5: no NCCL/MPI anywhere);
this module is the new first-class distributed layer (BASELINE.json
config 5):

* **P1 position parallelism** (primary): shard the ``nscan`` axis of
  ``scan``/``data`` across a mesh axis. The object and probe are
  replicated; each device runs the full CG loop on its position shard and
  the object/probe gradients and scalar objectives are ``psum``-ed over
  the interconnect (NVLink between GPUs) every iteration (see
  tikejax.solvers.cg, options.axis_name).
* **P2 angle parallelism**: shard the embarrassingly-parallel ``ntheta``
  axis. Pass a 2-D mesh (``make_mesh((t, s))``, axes ('theta', 'scan'))
  to :func:`run_sharded`: psi/prb/gradients stay sharded per-angle with
  NO collective (angles are independent sub-problems), while the scalar
  objective / line-search / Dai-Yuan statistics are psum-ed over both
  axes so every device agrees on the global step sizes -- the result is
  bit-for-bit the same algorithm as the single-device solver.

Everything is ``jax.shard_map`` + XLA collectives: no communication code
of our own, and the whole sharded CG run is still ONE jitted program with
zero host round-trips.
"""

from __future__ import annotations

import dataclasses

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from tikejax.geometry import Geometry
from tikejax.solvers import cg as _cg


def _call_memoized(make_sharded, *args, cache, key):
    """Run ``jax.jit(make_sharded())(*args)``, memoizing the jitted
    wrapper in ``cache`` under ``key``.

    shard_map's default check_vma=True statically verifies which values
    vary per device and that the out_specs replication claims hold (the
    solver's psums).

    The jitted wrapper is MEMOIZED because a fresh
    ``jit(shard_map(...))`` object re-traces the whole program on every
    call (only the XLA compilation is deduped by jaxpr hash), and the
    deep driver's per-segment calls would otherwise pay full host
    tracing of the solver each segment -- the cached wrapper carries its
    own trace cache like the unsharded _run_cg_jit."""
    if key not in cache:
        cache[key] = jax.jit(make_sharded())
    return cache[key](*args)


# Memoized jit(shard_map(...)) wrappers (see _call_memoized): keyed on
# everything the traced program closes over -- the mesh, the local
# geometry, the resolved options, and which optional args are present.
_SHARDED_CACHE: dict = {}


def make_mesh(n_devices: int | tuple[int, int] | None = None,
              axis: str = "scan", devices=None) -> Mesh:
    """Device mesh for position (1-D) or angle x position (2-D) sharding.

    Args:
      n_devices: number of devices to use (default: all), or a
        ``(ntheta_shards, nscan_shards)`` tuple for a 2-D
        ('theta', 'scan') mesh.
      axis: mesh axis name (1-D meshes).
      devices: explicit device list (default: ``jax.devices()``).
    """
    if devices is None:
        devices = jax.devices()
    if isinstance(n_devices, tuple):
        t, s = n_devices
        if t * s > len(devices):
            raise ValueError(
                f"mesh {n_devices} needs {t * s} devices, have "
                f"{len(devices)}")
        return Mesh(np.asarray(devices[:t * s]).reshape(t, s),
                    ("theta", "scan"))
    if n_devices is not None:
        devices = devices[:n_devices]
    return Mesh(np.asarray(devices), (axis,))


def _axes(mesh: Mesh) -> tuple[str | None, str]:
    """(theta_axis_or_None, scan_axis) for a 1-D or 2-D mesh."""
    names = mesh.axis_names
    if len(names) == 1:
        return None, names[0]
    if len(names) == 2:
        return names[0], names[1]
    raise ValueError(f"expected a 1-D or 2-D mesh, got axes {names}")


def shard_problem(mesh: Mesh, data, scan, axis: str | None = None):
    """Place data/scan sharded over the mesh (device_put).

    1-D meshes shard the scan axis; 2-D ('theta', 'scan') meshes shard
    the leading angle axis too.
    """
    theta_ax, scan_ax = _axes(mesh)
    spec = P(theta_ax, axis or scan_ax)
    data = jax.device_put(data, NamedSharding(mesh, spec))
    scan = jax.device_put(scan, NamedSharding(mesh, spec))
    return data, scan


def pad_scan_problem(data, scan, geometry: Geometry, nsh: int):
    """Pad the scan axis to a multiple of ``nsh`` with sentinel dummy
    positions (scan row -1, zero data; see ops.patches) so every mesh
    shard gets an equal static slice. Returns (data, scan, geometry) --
    unchanged when ``nscan`` already divides."""
    if geometry.nscan % nsh == 0:
        return data, scan, geometry
    import jax.numpy as jnp

    s_pad = -(-geometry.nscan // nsh) * nsh
    extra = s_pad - geometry.nscan
    pad_scan = jnp.zeros((scan.shape[0], extra, 2), scan.dtype).at[
        ..., 0].set(-1)
    scan = jnp.concatenate([jnp.asarray(scan), pad_scan], axis=1)
    pad_data = jnp.zeros(data.shape[:1] + (extra,) + data.shape[2:],
                         data.dtype)
    data = jnp.concatenate([jnp.asarray(data), pad_data], axis=1)
    return data, scan, dataclasses.replace(geometry, nscan=s_pad)


def _fwd_sharded_fn(mesh: Mesh, ndet: int, kernel: str):
    theta_ax, scan_ax = _axes(mesh)
    from tikejax.ops import diffraction

    def body(psi_l, scan_l, prb_l):
        return diffraction.fwd_raw(psi_l, scan_l, prb_l, ndet, kernel)

    def sharded():
        return jax.shard_map(
            body, mesh=mesh,
            in_specs=(P(theta_ax), P(theta_ax, scan_ax), P(theta_ax)),
            out_specs=P(theta_ax, scan_ax))

    return sharded


def fwd_sharded(psi, scan, prb, ndet: int, kernel: str, mesh: Mesh):
    """Position-sharded forward diffraction: scan sharded over the mesh,
    psi/prb replicated (or theta-sharded on 2-D meshes); the returned
    farplane stays sharded over the scan axis. Used by the deep driver
    to freeze split-operator base farplanes on a mesh. The jitted
    wrapper is memoized per (mesh, ndet, kernel)."""
    return _call_memoized(_fwd_sharded_fn(mesh, ndet, kernel),
                         psi, scan, prb, cache=_SHARDED_CACHE,
                         key=("fwd", mesh, ndet, kernel))


def run_sharded(data, psi0, scan, prb0, geometry: Geometry,
                mesh: Mesh, options: _cg.CGOptions | None = None,
                f_base=None, cg_init=None, **kw):
    """Position-sharded CG reconstruction (BASELINE.json config 5).

    Semantics are identical to :func:`tikejax.solvers.run` (up to float
    summation order): the scan axis of ``scan`` and ``data`` is split over
    the mesh, gradients/objectives are globally summed every iteration.

    Args:
      mesh: 1-D mesh (its axis shards scan positions) or 2-D
        ('theta', 'scan') mesh (leading axis additionally shards the
        angle axis of psi/prb/scan/data). ``ntheta`` must be divisible
        by the theta axis size; ``nscan`` need NOT divide by the scan
        axis size -- the tail shard is padded with sentinel-masked dummy
        positions (scan row -1, zero data; see ops.patches), which every
        kernel treats as contributing exactly zero.
      f_base: frozen base farplane for split-operator refinement
        (cg.run's ``f_base``), sharded like the data (the scan axis must
        already be a multiple of the mesh axis -- pre-pad with
        :func:`pad_scan_problem` when composing with the deep driver).
      cg_init: carried CG state tuple (cg.run's ``cg_init``): the
        4-tuple (d, g, gamma, gamma0) CG slots, extended under
        ``options.carry_lbfgs`` by the (S, Y, sy, count) L-BFGS ring to
        the 8-entry layout. Object-domain entries -- d, g, and the
        (m, *psi.shape) S/Y rings at axis 1 -- are replicated on 1-D
        meshes and sharded per-angle on 2-D meshes; gamma/gamma0/sy/
        count are replicated scalars.

    Returns:
      (psi, prb, metrics) -- psi/prb replicated (1-D mesh) or sharded
      per-angle (2-D mesh); metrics replicated.
    """
    options = _cg.normalize_options(_cg.make_options(options, **kw))
    theta_ax, scan_ax = _axes(mesh)
    nsh = mesh.shape[scan_ax]
    if geometry.nscan % nsh != 0:
        if f_base is not None:
            raise ValueError(
                "f_base must match a pre-padded scan axis (a multiple "
                f"of the mesh axis {nsh}); pad with pad_scan_problem "
                "and compute the base farplane on the padded problem")
        data, scan, geometry = pad_scan_problem(data, scan, geometry, nsh)
    # Inside shard_map every device sees its local slice of the sharded
    # axes.
    g_local = dataclasses.replace(geometry, nscan=geometry.nscan // nsh)
    if theta_ax is not None:
        tsh = mesh.shape[theta_ax]
        if geometry.ntheta % tsh != 0:
            raise ValueError(
                f"ntheta ({geometry.ntheta}) must be divisible by the "
                f"theta mesh axis size ({tsh})")
        g_local = dataclasses.replace(g_local,
                                      ntheta=geometry.ntheta // tsh)
    options = dataclasses.replace(options, axis_name=scan_ax,
                                  theta_axis_name=theta_ax)
    # Carried cg_state under a theta mesh: its object-domain entries are
    # per-angle, so it cannot ride in the replicated metrics (out_specs
    # P()). Split it out as a separate sharded output and re-attach it
    # host-side -- the public metrics contract is unchanged.
    split_cs = options.carry_state and theta_ax is not None
    cs_ring = bool(options.carry_lbfgs
                   and _cg._lbfgs_memory(options.direction))

    has_fb, has_ci = f_base is not None, cg_init is not None
    args = [data, psi0, scan, prb0]
    in_specs = [P(theta_ax, scan_ax), P(theta_ax),
                P(theta_ax, scan_ax), P(theta_ax)]
    if has_fb:
        args.append(f_base)
        in_specs.append(P(theta_ax, scan_ax))
    if has_ci:
        ci = tuple(cg_init)
        args.append(ci)
        ci_spec = (P(theta_ax), P(theta_ax), P(), P())
        if len(ci) == 8:
            # carry_lbfgs layout: + (S, Y, sy, count); the rings stack
            # object-domain arrays on a leading memory axis, so theta
            # (if sharded) sits at axis 1.
            ci_spec += (P(None, theta_ax), P(None, theta_ax), P(), P())
        in_specs.append(ci_spec)

    def body(*a):
        d, p, s, pr = a[:4]
        i = 4
        fb = None
        if has_fb:
            fb, i = a[i], i + 1
        ci = a[i] if has_ci else None
        psi, prb, metrics = _cg.run_impl(g_local, options, d, p, s, pr,
                                         fb, ci)
        if split_cs:
            cs = metrics.pop("cg_state")
            return psi, prb, metrics, cs
        return psi, prb, metrics

    out_specs = (P(theta_ax), P(theta_ax), P())
    if split_cs:
        cs_spec = (P(theta_ax), P(theta_ax), P(), P())
        if cs_ring:
            # (S, Y, sy, count): rings stack the object arrays on a
            # leading memory axis, so theta sits at axis 1.
            cs_spec += (P(None, theta_ax), P(None, theta_ax), P(), P())
        out_specs = out_specs + (cs_spec,)

    def sharded():
        return jax.shard_map(body, mesh=mesh, in_specs=tuple(in_specs),
                             out_specs=out_specs)

    out = _call_memoized(sharded, *args, cache=_SHARDED_CACHE,
                        key=("run", mesh, g_local, options, has_fb,
                             len(ci) if has_ci else 0))
    if split_cs:
        psi, prb, metrics, cs = out
        metrics["cg_state"] = cs
        return psi, prb, metrics
    return out
