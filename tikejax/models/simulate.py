"""Synthetic ptychography data generation.

Counterpart of the reference's test/example data setup (synthetic object +
probe + raster scan, ``data = |fwd(psi)|^2``; SURVEY.md SS4 item 2). Pure
JAX, jitted, so simulation itself runs on the accelerator.
"""

from __future__ import annotations

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np

from tikejax.geometry import Geometry
from tikejax.ops.diffraction import fwd_raw


def _real_dtype(dtype):
    """Real dtype matching a complex dtype, computed host-side (no device op)."""
    return np.empty(0, dtype=dtype).real.dtype


@functools.partial(jax.jit, static_argnums=(1, 2, 3, 4))
def make_object(key: jax.Array, ntheta: int, nz: int, n: int,
                dtype=jnp.complex64) -> jax.Array:
    """Smooth synthetic complex object: low-pass-filtered random amplitude
    in [0.5, 1] and phase in [-pi/3, pi/3]."""
    k_amp, k_ph = jax.random.split(key)
    real_dtype = _real_dtype(dtype)

    def smooth(k):
        rough = jax.random.uniform(k, (ntheta, nz, n), real_dtype)
        f = jnp.fft.fft2(rough)
        fy = jnp.fft.fftfreq(nz)[:, None]
        fx = jnp.fft.fftfreq(n)[None, :]
        lp = jnp.exp(-((fy**2 + fx**2) / (2 * 0.02**2))).astype(real_dtype)
        s = jnp.real(jnp.fft.ifft2(f * lp))
        lo = jnp.min(s, axis=(-2, -1), keepdims=True)
        hi = jnp.max(s, axis=(-2, -1), keepdims=True)
        return (s - lo) / (hi - lo + 1e-12)

    amp = 0.5 + 0.5 * smooth(k_amp)
    phase = (jnp.pi / 3) * (2 * smooth(k_ph) - 1)
    return (amp * jnp.exp(1j * phase)).astype(dtype)


@functools.partial(jax.jit, static_argnums=(0, 1, 2, 3))
def make_probe(ntheta: int, nmodes: int, nprb: int,
               dtype=jnp.complex64) -> jax.Array:
    """Gaussian-envelope probe with quadratic phase; higher modes are the
    envelope modulated by Hermite-like polynomials (orthogonal-ish incoherent
    modes, power decaying ~4x per mode)."""
    real_dtype = _real_dtype(dtype)
    y = (jnp.arange(nprb, dtype=real_dtype) - nprb / 2 + 0.5) / (nprb / 4)
    yy, xx = jnp.meshgrid(y, y, indexing="ij")
    r2 = yy**2 + xx**2
    env = jnp.exp(-r2 / 2) * jnp.exp(1j * 0.4 * r2.astype(real_dtype))
    modes = []
    for m in range(nmodes):
        # Hermite polynomials H_m along alternating axes give near-orthogonal
        # transverse modes; amplitude 2^-m so mode powers decay.
        h = jnp.ones_like(yy)
        for _ in range(m):
            h = h * (yy if m % 2 else xx)
        modes.append((2.0**-m) * h * env)
    prb = jnp.stack(modes)[None].astype(dtype)  # (1, nmodes, nprb, nprb)
    return jnp.broadcast_to(prb, (ntheta, nmodes, nprb, nprb))


@functools.partial(jax.jit, static_argnums=1,
                   static_argnames=("jitter", "dtype"))
def raster_scan(key: jax.Array, geometry: Geometry, jitter: float = 1.0,
                dtype=jnp.float32) -> jax.Array:
    """Raster grid of ~sqrt(nscan) x sqrt(nscan) positions covering the
    object with random sub-step jitter (breaks the raster-grid pathology,
    standard ptychography practice), clipped in-bounds.

    Returns ``(ntheta, nscan, 2)`` float (y, x) top-left corners.
    """
    g = geometry
    side = math.ceil(math.sqrt(g.nscan))
    rows = math.ceil(g.nscan / side)  # every row survives the truncation
    max_y = g.nz - g.nprb
    max_x = g.n - g.nprb
    ys = jnp.linspace(0, max_y, rows)
    xs = jnp.linspace(0, max_x, side)
    yy, xx = jnp.meshgrid(ys, xs, indexing="ij")
    grid = jnp.stack([yy.ravel(), xx.ravel()], -1)[:g.nscan]  # (nscan, 2)
    scan = jnp.broadcast_to(grid[None], (g.ntheta, g.nscan, 2))
    if jitter:
        scan = scan + jitter * jax.random.uniform(
            key, scan.shape, minval=-1.0, maxval=1.0)
    scan = jnp.clip(scan, 0, jnp.array([max_y, max_x], scan.dtype))
    return scan.astype(dtype)


@functools.partial(jax.jit, static_argnums=3)
def simulate_intensities(psi: jax.Array, scan: jax.Array, prb: jax.Array,
                         ndet: int) -> jax.Array:
    """Noise-free measured intensities: sum over modes of |fwd|^2.

    Chunked over scan positions so the mode-resolved farplane transient
    stays bounded (~1 GiB) even for many-mode / many-position problems.

    Returns ``(ntheta, nscan, ndet, ndet)`` real photon counts.
    """
    t, s = scan.shape[:2]
    nmodes = prb.shape[1]
    farplane_bytes = t * s * nmodes * ndet * ndet * 8
    budget = 1024**3
    nch = 1
    if farplane_bytes > budget:
        want = -(-farplane_bytes // budget)
        # smallest divisor of s that is >= want (falls back to s)
        nch = next((c for c in range(want, s + 1) if s % c == 0), s)

    def intensity(scan_c):
        far = fwd_raw(psi, scan_c, prb, ndet)
        return jnp.sum(jnp.abs(far)**2, axis=2)

    if nch == 1:
        return intensity(scan)
    scan_c = scan.reshape(t, nch, s // nch, 2).swapaxes(0, 1)
    out = jax.lax.map(intensity, scan_c)  # (nch, t, s/nch, nd, nd)
    return out.swapaxes(0, 1).reshape(t, s, ndet, ndet)


def make_problem(key: jax.Array, geometry: Geometry, dtype=jnp.complex64,
                 poisson_photons: float | None = None):
    """Build a full synthetic problem: (psi_true, scan, prb, data).

    If ``poisson_photons`` is given, data is scaled so the mean frame sum is
    that many photons and Poisson shot noise is applied.
    """
    g = geometry
    k_obj, k_scan, k_noise = jax.random.split(key, 3)
    psi = make_object(k_obj, g.ntheta, g.nz, g.n, dtype)
    prb = make_probe(g.ntheta, g.nmodes, g.nprb, dtype)
    scan = raster_scan(k_scan, g)
    data = simulate_intensities(psi, scan, prb, g.ndet)
    if poisson_photons is not None:
        per_frame = jnp.mean(jnp.sum(data, axis=(-2, -1)))
        scale = poisson_photons / per_frame
        data = jax.random.poisson(k_noise, data * scale).astype(
            data.dtype) / scale
    return psi, scan, prb, data
