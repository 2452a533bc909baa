"""Batched 2-D unitary FFTs for far-field propagation.

Counterpart of the reference's single batched cuFFT plan
(``cufftPlanMany`` rank-2 C2C over ``ntheta*nscan`` frames, [R]
src/cuda/ptychofft.cu ctor; SURVEY.md SS2/C3). XLA batches the FFT over
all leading axes and hands it to cuFFT on an NVIDIA GPU -- there is no
plan object to manage.

``norm='ortho'`` makes the transform unitary (the reference scales by
``1/sqrt(ndet^2)``, SURVEY.md SS2/C1 fwd), so ``ifft2o`` is the exact
Hermitian adjoint of ``fft2o`` and adjoint tests close to machine epsilon.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def _unitary_scale(x: jax.Array) -> float:
    # Static Python scalar (shapes are static under XLA), folded into the
    # surrounding fusion as a constant.
    h, w = x.shape[-2], x.shape[-1]
    return 1.0 / float(h * w) ** 0.5


def fft2o(x: jax.Array) -> jax.Array:
    """Unitary 2-D FFT over the last two axes, batched over the rest."""
    return jnp.fft.fft2(x) * _unitary_scale(x)


def ifft2o(x: jax.Array) -> jax.Array:
    """Unitary 2-D inverse FFT; Hermitian adjoint of :func:`fft2o`."""
    # jnp.fft.ifft2 scales by 1/(h*w); multiply back up to the unitary 1/sqrt.
    return jnp.fft.ifft2(x) * (1.0 / _unitary_scale(x))


def pad_to_det(nearplane: jax.Array, ndet: int) -> jax.Array:
    """Zero-pad ``(..., nprb, nprb)`` frames to ``(..., ndet, ndet)``.

    The patch sits in the top-left corner, matching the reference fwd
    kernel's zero-padded border placement (SURVEY.md SS2/C1; the measured
    intensities are invariant to this choice -- padding offset only adds a
    linear phase ramp in the far field).
    """
    nprb = nearplane.shape[-1]
    if nprb == ndet:
        return nearplane
    pad = [(0, 0)] * (nearplane.ndim - 2) + [(0, ndet - nprb), (0, ndet - nprb)]
    return jnp.pad(nearplane, pad)


def crop_from_det(frames: jax.Array, nprb: int) -> jax.Array:
    """Adjoint of :func:`pad_to_det`: crop the top-left ``nprb x nprb``."""
    if frames.shape[-1] == nprb:
        return frames
    return frames[..., :nprb, :nprb]
