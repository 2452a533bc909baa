"""Patch gather / overlap scatter-add over scan positions (XLA path).

Counterpart of the reference's CUDA gather and atomicAdd scatter kernels
([R] src/cuda/ptychofft.cu, SURVEY.md SS2/C2), and the operator layer's
only implementation. ``.at[iy, ix].add`` lowers to one XLA scatter. On
an NVIDIA GPU that scatter accumulates overlapping patches with atomic
adds, as the reference does, so the order of the float sums -- and with
it the last bits of the result -- can change from run to run. On the CPU
the order is fixed.

Scan positions are float (y, x) top-left corners, floored to integer pixel
offsets exactly like the reference's C cast of float scan coordinates
(SURVEY.md SS2/C1 fwd; no subpixel interpolation). Positions must be
in-bounds: ``0 <= y <= nz - nprb``, ``0 <= x <= n - nprb``. Out-of-bounds
positions would clamp in the gather but drop in the scatter, silently
breaking fwd/adj adjointness -- use :func:`check_scan_in_bounds` in host
code when ingesting untrusted positions.

Exception: a scan ROW < 0 is the documented sentinel for a **masked
dummy position** (used by tikejax.parallel to pad unequal per-shard
position counts to a static shape). Every operator here treats such
positions as contributing exactly zero: gathers return zero patches,
scatters add nothing, the illumination/power preconditioner maps skip
them. fwd/adj remain exact adjoint pairs under the mask.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax


def scan_to_int(scan: jax.Array) -> jax.Array:
    """Floor float (y, x) scan coordinates to int32 pixel offsets."""
    if jnp.issubdtype(scan.dtype, jnp.integer):
        return scan.astype(jnp.int32)
    return jnp.floor(scan).astype(jnp.int32)


def check_scan_in_bounds(scan, nz: int, n: int, nprb: int) -> None:
    """Host-side validation that all scan positions are in-bounds."""
    import numpy as np

    s = np.floor(np.asarray(scan)).astype(np.int64)
    y, x = s[..., 0], s[..., 1]
    if (y < 0).any() or (x < 0).any() or (y > nz - nprb).any() or (
            x > n - nprb).any():
        bad = int(((y < 0) | (x < 0) | (y > nz - nprb) | (x > n - nprb)).sum())
        raise ValueError(
            f"{bad} scan position(s) out of bounds for object {nz}x{n} with "
            f"probe {nprb}: y must be in [0, {nz - nprb}], x in [0, {n - nprb}]")


def gather_patches(psi: jax.Array, scan_int: jax.Array,
                   nprb: int) -> jax.Array:
    """Gather ``nprb x nprb`` object patches at integer scan offsets.

    Args:
      psi: ``(ntheta, nz, n)`` complex object.
      scan_int: ``(ntheta, nscan, 2)`` int32 (y, x) offsets.
      nprb: patch side.

    Returns:
      ``(ntheta, nscan, nprb, nprb)`` patches, same dtype as ``psi``
      (zero for sentinel-masked positions, scan row < 0).
    """

    def per_angle(psi_t, scan_t):
        def per_pos(s):
            # dynamic_slice clamps a negative start to 0; the sentinel
            # mask below zeroes the whole dummy patch.
            return lax.dynamic_slice(psi_t, (s[0], s[1]), (nprb, nprb))

        return jax.vmap(per_pos)(scan_t)

    patches = jax.vmap(per_angle)(psi, scan_int)
    valid = scan_int[..., 0] >= 0
    return patches * valid[..., None, None].astype(patches.dtype)


def _index_grids(scan_int: jax.Array, nprb: int):
    iy = scan_int[..., 0][..., None, None] + jnp.arange(
        nprb, dtype=jnp.int32)[:, None]
    ix = scan_int[..., 1][..., None, None] + jnp.arange(
        nprb, dtype=jnp.int32)[None, :]
    return iy, ix


def scatter_patches_add(patches: jax.Array, scan_int: jax.Array, nz: int,
                        n: int) -> jax.Array:
    """Adjoint of :func:`gather_patches`: sum patches into a zero object.

    Overlapping patches accumulate (the reference resolves this with
    atomicAdd; so does XLA's scatter on a GPU -- SURVEY.md SS3.3).

    Args:
      patches: ``(ntheta, nscan, nprb, nprb)``.
      scan_int: ``(ntheta, nscan, 2)`` int32 offsets.

    Returns:
      ``(ntheta, nz, n)`` accumulated object-domain array.
    """
    nprb = patches.shape[-1]
    valid = scan_int[..., 0] >= 0
    patches = patches * valid[..., None, None].astype(patches.dtype)
    # Clamp sentinel rows so the (zeroed) dummy scatter lands in-bounds.
    iy, ix = _index_grids(jnp.maximum(scan_int, 0), nprb)

    def per_angle(p_t, iy_t, ix_t):
        return jnp.zeros((nz, n), p_t.dtype).at[iy_t, ix_t].add(p_t)

    return jax.vmap(per_angle)(patches, iy, ix)


def illumination_map(scan_int: jax.Array, kernel: jax.Array, nz: int,
                     n: int) -> jax.Array:
    """Sum of a fixed ``(ntheta, nprb, nprb)`` real kernel scattered at all
    scan offsets -- the probe-illumination map ``sum_k T_k(kernel)`` --
    computed as an FFT convolution of the position delta map with the
    kernel: O((nz*n) log) instead of O(nscan * nprb^2) scatter. Used as
    the object-gradient preconditioner denominator.
    """
    ntheta = scan_int.shape[0]
    nprb = kernel.shape[-1]
    h, w = nz + nprb, n + nprb
    tt = jnp.arange(ntheta, dtype=jnp.int32)[:, None]
    # Sentinel-masked dummies (scan row < 0) get zero delta weight.
    valid = (scan_int[..., 0] >= 0).astype(kernel.dtype)
    delta = jnp.zeros((ntheta, h, w), kernel.dtype).at[
        tt, jnp.maximum(scan_int[..., 0], 0),
        jnp.maximum(scan_int[..., 1], 0)].add(valid)
    kpad = jnp.pad(kernel, ((0, 0), (0, h - nprb), (0, w - nprb)))
    conv = jnp.fft.irfft2(
        jnp.fft.rfft2(delta) * jnp.fft.rfft2(kpad), s=(h, w))
    return conv[:, :nz, :n]


def patch_power_map(scan_int: jax.Array, field_power: jax.Array,
                    nprb: int) -> jax.Array:
    """``out[dy, dx] = sum_k field_power[y_k+dy, x_k+dx]`` -- the total
    object power seen by each probe pixel across all scan positions (the
    probe-gradient preconditioner denominator), via FFT cross-correlation
    of the position delta map with the power map.
    """
    ntheta, nz, n = field_power.shape
    h, w = nz + nprb, n + nprb
    tt = jnp.arange(ntheta, dtype=jnp.int32)[:, None]
    # Sentinel-masked dummies (scan row < 0) get zero delta weight.
    valid = (scan_int[..., 0] >= 0).astype(field_power.dtype)
    delta = jnp.zeros((ntheta, h, w), field_power.dtype).at[
        tt, jnp.maximum(scan_int[..., 0], 0),
        jnp.maximum(scan_int[..., 1], 0)].add(valid)
    fpad = jnp.pad(field_power, ((0, 0), (0, nprb), (0, nprb)))
    corr = jnp.fft.irfft2(
        jnp.conj(jnp.fft.rfft2(delta)) * jnp.fft.rfft2(fpad), s=(h, w))
    return corr[:, :nprb, :nprb]


def overlap_counts(scan_int: jax.Array, nz: int, n: int, nprb: int,
                   dtype=jnp.float32) -> jax.Array:
    """Per-pixel patch coverage count: scatter of all-ones patches.

    Useful as a diagnostic and as the denominator of the classic
    probe-illumination preconditioner.
    """
    ntheta, nscan = scan_int.shape[:2]
    ones = jnp.ones((ntheta, nscan, nprb, nprb), dtype)
    return scatter_patches_add(ones, scan_int, nz, n)
