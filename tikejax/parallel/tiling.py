"""P3 object-domain tiling: shard the object grid with halo exchange.

The stretch parallelism axis from SURVEY.md SS5: when the object
outgrows one device's memory (giant fields of view), shard its ROW axis into
equal slabs over a 1-D ('obj',) mesh. Each device holds its owned rows
plus ``nprb - 1`` halo rows below (the probe-window overlap into the
next slab) and the scan positions whose window TOP row falls in its
slab; the full object never exists on any one device during the
reconstruction. Per CG iteration the only collectives are

* two halo ``ppermute``s of an (ntheta, nprb-1, n) strip (adjoint halo
  reduce + refresh -- see cg._halo_fix), and
* the scalar psums of the objective / line-search / Dai-Yuan
  statistics,

so communication is O(n * nprb) per step while compute is O(nscan/D *
ndet^2 * nprb) -- the surface-to-volume ratio that makes domain tiling
scale. The operators run unchanged on each local slab.

Positions may split UNEQUALLY across slabs (jittered real-world scans
do): `partition_problem` pads every slab's position list to the global
per-slab maximum with sentinel-masked dummy positions (scan row = -1, a
documented operator-level mask -- see ops.patches; zero data frames),
which every kernel treats as contributing exactly zero, so the tiled
run matches the single-device reconstruction bit-for-bit in structure
while keeping static shapes. Remaining restrictions: object rows must
divide by the slab count, each slab must be at least ``nprb - 1`` rows
tall, and `nscan` chunking requires the padded per-slab count to divide
by ``nchunks``.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from tikejax.geometry import Geometry
from tikejax.solvers import cg as _cg
from tikejax.utils import hostio


def make_obj_mesh(n_devices: int | None = None, devices=None) -> Mesh:
    """1-D ('obj',) mesh for object-domain tiling."""
    if devices is None:
        devices = jax.devices()
    if n_devices is not None:
        devices = devices[:n_devices]
    return Mesh(np.asarray(devices), ("obj",))


def make_obj_scan_mesh(n_slabs: int, scan_shards: int,
                       devices=None) -> Mesh:
    """2-D ('obj', 'scan') mesh composing object tiling (P3) with
    position sharding (P1): ``n_slabs`` object slabs, each slab's
    positions further sharded ``scan_shards`` ways. Uses the first
    ``n_slabs * scan_shards`` devices."""
    if devices is None:
        devices = jax.devices()
    need = n_slabs * scan_shards
    if len(devices) < need:
        raise ValueError(f"need {need} devices for a {n_slabs}x"
                         f"{scan_shards} ('obj', 'scan') mesh, have "
                         f"{len(devices)}")
    return Mesh(np.asarray(devices[:need]).reshape(n_slabs, scan_shards),
                ("obj", "scan"))


def make_full_mesh(theta_shards: int, n_slabs: int, scan_shards: int,
                   devices=None) -> Mesh:
    """3-D ('theta', 'obj', 'scan') mesh composing ALL parallel axes:
    P2 angle sharding x P3 object tiling x P1 position sharding."""
    if devices is None:
        devices = jax.devices()
    need = theta_shards * n_slabs * scan_shards
    if len(devices) < need:
        raise ValueError(f"need {need} devices for a {theta_shards}x"
                         f"{n_slabs}x{scan_shards} ('theta', 'obj', "
                         f"'scan') mesh, have {len(devices)}")
    return Mesh(
        np.asarray(devices[:need]).reshape(theta_shards, n_slabs,
                                           scan_shards),
        ("theta", "obj", "scan"))


def partition_problem(psi0, scan, data, geometry: Geometry, n_slabs: int,
                      scan_shards: int = 1):
    """Host-side owner partition of a tiling problem.

    Returns ``(psi_slabs, scan_loc, data_p, owned)`` where
    ``psi_slabs (D, t, owned + halo, n)`` are the extended object slabs
    (halo rows replicate the next slab's top rows; the last slab's halo
    is zero), ``scan_loc (D, t, s_max, 2)`` are slab-local (y, x)
    positions sorted by owner -- padded per (slab, theta) to the global
    maximum owner count ``s_max`` with sentinel dummies (y = -1, masked
    to zero contribution by every kernel) -- and ``data_p`` the matching
    frames (zero for dummies). With ``scan_shards > 1`` (the
    ('obj', 'scan') composed mesh), ``s_max`` is additionally rounded
    up to a multiple of the scan-shard count so the position axis
    splits evenly across the scan mesh axis.

    Raises ValueError when object rows don't split equally or positions
    are out of bounds.
    """
    g = geometry
    D = n_slabs
    if g.nz % D != 0:
        raise ValueError(f"object rows ({g.nz}) must divide by the slab "
                         f"count ({D})")
    owned = g.nz // D
    halo = g.nprb - 1
    if owned < halo:
        raise ValueError(
            f"slab height ({owned}) must be >= nprb - 1 ({halo}): probe "
            "windows may only overlap into the immediate next slab")

    psi0 = np.asarray(hostio.to_host(psi0))
    scan = np.asarray(hostio.to_host(scan), np.float32)
    data = np.asarray(hostio.to_host(data), np.float32)

    # Owner of a position = slab containing its window's top row.
    y_int = np.floor(scan[..., 0]).astype(np.int64)
    if (y_int < 0).any() or (y_int > g.nz - g.nprb).any():
        raise ValueError("scan positions out of bounds; run "
                         "tikejax.models.check_scan first")
    owner = y_int // owned  # (t, s)

    # Pad every (slab, theta) position list to the global maximum owner
    # count with sentinel dummies: static shapes for the kernels, zero
    # contribution by the operator-level mask (ops.patches docstring).
    counts = np.stack([(owner == d).sum(axis=1) for d in range(D)])
    s_loc = int(counts.max())
    s_loc = -(-max(s_loc, 1) // scan_shards) * scan_shards
    scan_loc = np.full((D, g.ntheta, s_loc, 2), -1.0, np.float32)
    scan_loc[..., 1] = 0.0
    data_p = np.zeros((D, g.ntheta, s_loc, g.ndet, g.ndet), np.float32)
    for d in range(D):
        for t in range(g.ntheta):
            idx = np.nonzero(owner[t] == d)[0]
            sc = scan[t, idx].copy()
            sc[:, 0] -= d * owned  # slab-local rows
            scan_loc[d, t, :len(idx)] = sc
            data_p[d, t, :len(idx)] = data[t, idx]

    psi_slabs = np.zeros((D, g.ntheta, owned + halo, g.n), psi0.dtype)
    for d in range(D):
        lo = d * owned
        hi = min(lo + owned + halo, g.nz)
        psi_slabs[d, :, :hi - lo] = psi0[:, lo:hi]
    return psi_slabs, scan_loc, data_p, owned


def stitch(psi_slabs, owned: int):
    """(D, t, owned + halo, n) slabs -> (t, D * owned, n) full object."""
    ownedv = psi_slabs[:, :, :owned]
    return jnp.transpose(ownedv, (1, 0, 2, 3)).reshape(
        ownedv.shape[1], -1, ownedv.shape[3])


def run_tiled(data, psi0, scan, prb0, geometry: Geometry, mesh: Mesh,
              options: _cg.CGOptions | None = None, **kw):
    """Object-tiled CG reconstruction (SURVEY.md SS5 P3), optionally
    composed with position sharding (P1) on a 2-D mesh.

    Semantics match :func:`tikejax.solvers.run` exactly (up to float
    summation order): the object rows and the scan positions are
    partitioned over the mesh's 'obj' axis, the full object never lives
    on one device, and the result is stitched back for the caller.

    With a 2-D ('obj', 'scan') mesh (:func:`make_obj_scan_mesh`), each
    slab's position list is additionally sharded over the 'scan' axis:
    the slab object (+halo) is replicated within its slab's scan group,
    the object gradient is psum-ed over 'scan' before the halo
    exchange over 'obj', and all scalar statistics psum over both axes
    -- the composed configuration for objects that outgrow one chip's
    HBM at position counts that outgrow one chip's compute. The CG core
    composes the two axes natively (cg._scalar_axes / _grad_prb_axes /
    _halo_fix); this wrapper only lays out the data.

    Args:
      data / psi0 / scan / prb0: FULL problem arrays (host or device);
        partitioning happens here.
      mesh: 1-D ('obj',) mesh (make_obj_mesh) or 2-D ('obj', 'scan')
        mesh (make_obj_scan_mesh).

    Returns:
      (psi, prb, metrics) with psi the stitched (ntheta, nz, n) object.
    """
    options = _cg.normalize_options(_cg.make_options(options, **kw))
    g = geometry
    names = mesh.axis_names
    if "obj" not in names:
        raise ValueError("run_tiled expects a mesh with an 'obj' axis; "
                         f"got axes {names}")
    axis = "obj"
    theta_axis = "theta" if "theta" in names else None
    others = [a for a in names if a not in ("obj", "theta")]
    if len(others) > 1:
        raise ValueError("run_tiled supports ('obj',), ('obj', <scan>) "
                         "and ('theta', 'obj', <scan>) meshes; got "
                         f"{names}")
    scan_axis = others[0] if others else None
    D = mesh.shape[axis]
    S = mesh.shape[scan_axis] if scan_axis else 1
    T = mesh.shape[theta_axis] if theta_axis else 1
    if g.ntheta % T != 0:
        raise ValueError(f"ntheta ({g.ntheta}) must divide by the theta "
                         f"mesh axis ({T})")
    psi_slabs, scan_loc, data_p, owned = partition_problem(
        psi0, scan, data, g, D, scan_shards=S)
    halo = g.nprb - 1

    if options.carry_state:
        raise ValueError(
            "carry_state is not supported under object tiling: the "
            "carried cg_state rides in the replicated metrics, but its "
            "object-domain entries are per-slab (use run_sharded on a "
            "1-D scan mesh for carried segments)")
    g_local = dataclasses.replace(g, nz=owned + halo, ntheta=g.ntheta // T,
                                  nscan=scan_loc.shape[2] // S)
    opts = dataclasses.replace(options, obj_axis_name=axis,
                               obj_halo=halo, obj_axis_size=D,
                               axis_name=scan_axis,
                               theta_axis_name=theta_axis)

    # Position-carrying arrays shard over slab (dim 0), theta (dim 1)
    # and local-position (dim 2) axes; the slab objects replicate
    # within a scan group; the probe shards over theta only (P2
    # semantics: per-angle probe, no collective).
    pos_P = P(axis, theta_axis, scan_axis)
    psi_P = P(axis, theta_axis)
    psi_slabs = jax.device_put(jnp.asarray(psi_slabs),
                               NamedSharding(mesh, psi_P))
    scan_loc = jax.device_put(jnp.asarray(scan_loc),
                              NamedSharding(mesh, pos_P))
    data_p = jax.device_put(jnp.asarray(data_p),
                            NamedSharding(mesh, pos_P))
    prb0 = jax.device_put(jnp.asarray(prb0),
                          NamedSharding(mesh, P(theta_axis)))

    def body(data_l, psi_l, scan_l, prb_l):
        psi, prb, metrics = _cg.run_impl(g_local, opts, data_l[0],
                                         psi_l[0], scan_l[0], prb_l)
        return psi[None], prb, metrics

    def sharded():
        return jax.shard_map(
            body, mesh=mesh,
            in_specs=(pos_P, psi_P, pos_P, P(theta_axis)),
            out_specs=(psi_P, P(theta_axis), P()))

    from tikejax.parallel.sharding import _SHARDED_CACHE, _call_memoized
    psi_s, prb, metrics = _call_memoized(
        sharded, data_p, psi_slabs, scan_loc, prb0,
        cache=_SHARDED_CACHE, key=("tiled", mesh, g_local, opts))
    return jax.jit(stitch, static_argnums=1)(psi_s, owned), prb, metrics
