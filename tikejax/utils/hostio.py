"""Host <-> device array helpers.

Plain conveniences used by benchmarks, examples, the compat facade and
checkpointing: :func:`to_host` / :func:`to_device` move arrays across the
host boundary (complex included), and :func:`cfull` / :func:`cones` /
:func:`czeros` build complex-filled device arrays.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np


def to_host(x) -> np.ndarray:
    """Device array -> numpy array.

    Already-host numpy arrays AND numpy scalars pass through untouched:
    without JAX's x64 mode a float64/int64 scalar would silently truncate
    to 32 bits on a device round-trip (the split-driver checkpoint keeps
    float64 targets this way)."""
    if isinstance(x, np.ndarray):
        return x
    return np.asarray(x)


def to_device(x, dtype=None) -> jax.Array:
    """Numpy (or any array) -> device array, optionally cast to
    ``dtype`` on the host first."""
    x = np.asarray(x)
    if dtype is not None:
        x = x.astype(dtype, copy=False)
    return jnp.asarray(x)


def scalar(x) -> float:
    """Read back a real scalar from device."""
    return float(np.asarray(x))


def cfull(shape, value, dtype=jnp.complex64) -> jax.Array:
    """Device array of ``shape`` filled with the complex ``value``."""
    return jnp.full(tuple(shape), complex(value), jnp.dtype(dtype))


def cones(shape, dtype=jnp.complex64) -> jax.Array:
    return cfull(shape, 1.0, dtype)


def czeros(shape, dtype=jnp.complex64) -> jax.Array:
    return cfull(shape, 0.0, dtype)
