"""Far-field ptychography diffraction operators: fwd / adj / adj_probe.

Counterpart of the reference operator core ``class ptychofft``
([R] src/cuda/ptychofft.cu|.cuh; SURVEY.md SS2/C1-C3, SS3.2-3.3):

  fwd:        psi, scan, prb  ->  farplane
              gather object patches at scan offsets, multiply by each
              probe mode, zero-pad to the detector frame, unitary 2-D FFT
              batched over (ntheta, nscan, nmodes).
  adj:        farplane, scan, prb  ->  psi-domain accumulation
              unitary inverse FFT, crop, conj(probe) multiply, sum over
              modes, overlap scatter-add into the object.
  adj_probe:  farplane, scan, psi  ->  probe-domain accumulation
              unitary inverse FFT, crop, conj(object patch) multiply,
              sum over scan positions per mode.

All three are C-linear maps and exact Hermitian adjoints of each other
under the inner product ``<a, b> = sum(conj(a) * b)``; tests verify this
against ``jax.vjp`` of the raw forward and a float64 numpy reference
(SURVEY.md SS4 item 1).

``fwd`` carries a ``jax.custom_vjp`` so that ``jax.grad`` of any objective
built on it uses these hand-written adjoints (single scatter) rather than
XLA's generic transpose.

There is one implementation: XLA's gather, batched FFT (cuFFT on NVIDIA
GPUs) and scatter-add -- the structure of the reference. The ``kernel``
argument accepts ``'auto'`` and ``'xla'``, which both select it. Each
step runs under a stable ``jax.named_scope`` (:data:`SCOPES`), so a
profiler trace attributes device time to gather x probe, FFT, IFFT and
scatter-add.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from tikejax.geometry import Geometry
from tikejax.ops import patches as _patches
from tikejax.ops.fft import crop_from_det, fft2o, ifft2o, pad_to_det

KERNELS = ("auto", "xla")

# Kernel names of earlier releases. Their hand-written kernels were
# removed; asking for one raises instead of silently running another path.
REMOVED_KERNELS = ("pallas", "fused", "fused_mp", "fused_hp", "fused_mx",
                   "fused_hx", "fused_am")

# Names of the operator steps as they appear in a profiler trace.
SCOPES = ("gather_probe", "fft", "ifft", "scatter_add", "probe_reduce")


def resolve_kernel(kernel: str) -> str:
    """Validate ``kernel`` and return the implementation it selects
    (always ``'xla'``)."""
    if kernel in REMOVED_KERNELS:
        raise ValueError(
            f"kernel {kernel!r} was removed together with its hand-written "
            "kernels; the XLA path (kernel='auto' or 'xla') is the only "
            "operator implementation")
    if kernel not in KERNELS:
        raise ValueError(f"unknown kernel {kernel!r}; expected one of "
                         f"{KERNELS}")
    return "xla"


def _nearplane_fwd(psi, scan_int, prb):
    """Gather patches at scan offsets and multiply by all probe modes:
    (t, s, m, nprb, nprb)."""
    with jax.named_scope("gather_probe"):
        nprb = prb.shape[-1]
        patches = _patches.gather_patches(psi, scan_int, nprb)
        return patches[:, :, None, :, :] * prb[:, None, :, :, :]


def _adj_object(nearplane, scan_int, prb, nz, n):
    """conj(prb)-multiply, mode-sum, overlap scatter-add into the object."""
    with jax.named_scope("scatter_add"):
        patches = jnp.sum(jnp.conj(prb)[:, None, :, :, :] * nearplane,
                          axis=2)
        return _patches.scatter_patches_add(patches, scan_int, nz, n)


def _adj_probe_acc(nearplane, scan_int, psi):
    """conj(patch)-multiply and reduce over scan positions into the probe."""
    with jax.named_scope("probe_reduce"):
        nprb = nearplane.shape[-1]
        patches = _patches.gather_patches(psi, scan_int, nprb)
        return jnp.sum(jnp.conj(patches)[:, :, None, :, :] * nearplane,
                       axis=1)


def _nearplane_adj(farplane, nprb):
    with jax.named_scope("ifft"):
        return crop_from_det(ifft2o(farplane), nprb)  # (t, s, m, p, p)


# ---------------------------------------------------------------------------
# Raw (non-custom-vjp) implementations. Keep these importable for tests that
# cross-check the hand adjoints against jax.vjp of the raw forward.
# ---------------------------------------------------------------------------


def fwd_raw(psi: jax.Array, scan: jax.Array, prb: jax.Array, ndet: int,
            kernel: str = "xla") -> jax.Array:
    """Forward diffraction. Returns ``(ntheta, nscan, nmodes, ndet, ndet)``."""
    resolve_kernel(kernel)
    scan_int = _patches.scan_to_int(scan)
    nearplane = _nearplane_fwd(psi, scan_int, prb)  # (t, s, m, p, p)
    with jax.named_scope("fft"):
        return fft2o(pad_to_det(nearplane, ndet))


def adj_raw(farplane: jax.Array, scan: jax.Array, prb: jax.Array, nz: int,
            n: int, kernel: str = "xla") -> jax.Array:
    """Adjoint w.r.t. the object. Returns ``(ntheta, nz, n)``."""
    resolve_kernel(kernel)
    scan_int = _patches.scan_to_int(scan)
    nearplane = _nearplane_adj(farplane, prb.shape[-1])
    return _adj_object(nearplane, scan_int, prb, nz, n)


def adj_probe_raw(farplane: jax.Array, scan: jax.Array, psi: jax.Array,
                  nprb: int, kernel: str = "xla") -> jax.Array:
    """Adjoint w.r.t. the probe. Returns ``(ntheta, nmodes, nprb, nprb)``."""
    resolve_kernel(kernel)
    scan_int = _patches.scan_to_int(scan)
    nearplane = _nearplane_adj(farplane, nprb)
    return _adj_probe_acc(nearplane, scan_int, psi)


# ---------------------------------------------------------------------------
# Differentiable forward: custom_vjp wiring AD to the hand adjoints.
# ---------------------------------------------------------------------------


@functools.partial(jax.custom_vjp, nondiff_argnums=(3, 4))
def fwd(psi: jax.Array, scan: jax.Array, prb: jax.Array, ndet: int,
        kernel: str = "xla") -> jax.Array:
    """Differentiable forward diffraction operator.

    ``jax.vjp``/``jax.grad`` through this function use :func:`adj_raw` and
    :func:`adj_probe_raw` as the backward pass. ``scan`` is treated as
    non-differentiable data (zero cotangent) -- positions are measurement
    metadata, as in the reference.
    """
    return fwd_raw(psi, scan, prb, ndet, kernel)


def _fwd_fwd(psi, scan, prb, ndet, kernel):
    return fwd_raw(psi, scan, prb, ndet, kernel), (psi, scan, prb)


def _fwd_bwd(ndet, kernel, res, g):
    # JAX's vjp convention for C-linear maps is the unconjugated transpose
    # A^T (not the Hermitian adjoint A^H): vjp(g) = conj(A^H conj(g)). The
    # physics-facing adjoints adj_raw/adj_probe_raw are A^H; wrap them in
    # conjugations here so jax.grad through `fwd` is bit-identical to AD of
    # the raw forward (verified in tests/test_adjoints.py).
    psi, scan, prb = res
    nz, n = psi.shape[-2:]
    nprb = prb.shape[-1]
    gc = jnp.conj(g)
    dpsi = jnp.conj(adj_raw(gc, scan, prb, nz, n, kernel))
    dprb = jnp.conj(adj_probe_raw(gc, scan, psi, nprb, kernel))
    return dpsi, jnp.zeros_like(scan), dprb


fwd.defvjp(_fwd_fwd, _fwd_bwd)


# ---------------------------------------------------------------------------
# Geometry-bound operator bundle.
# ---------------------------------------------------------------------------


class Ptycho:
    """Geometry-bound diffraction operator bundle.

    The counterpart of the reference's ``ptychofft`` object (SURVEY.md
    SS3.4) -- except there is nothing to allocate or free: the geometry
    is static metadata and XLA owns all buffers.

    >>> op = Ptycho(Geometry(nz=256, n=256, nscan=100, ndet=64, nprb=64))
    >>> farplane = op.fwd(psi, scan, prb)
    """

    def __init__(self, geometry: Geometry, kernel: str = "auto"):
        resolve_kernel(kernel)
        self.g = geometry
        self.kernel = kernel

    def fwd(self, psi, scan, prb):
        return fwd(psi, scan, prb, self.g.ndet, self.kernel)

    def adj(self, farplane, scan, prb):
        return adj_raw(farplane, scan, prb, self.g.nz, self.g.n, self.kernel)

    def adj_probe(self, farplane, scan, psi):
        return adj_probe_raw(farplane, scan, psi, self.g.nprb, self.kernel)
