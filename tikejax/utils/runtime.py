"""Helpers for the entry-point scripts that run on the GPU.

* :func:`enable_compile_cache` -- JAX's persistent compilation cache at a
  fixed path, so repeated runs of the same programs skip compilation.
* :func:`require_gpu` -- refuse to measure anything without a GPU.
* :func:`card_lines` / :func:`parse_card_line` -- the card's name and
  power limit as ``nvidia-smi`` reports them; every timing a script prints
  carries them, since a card set below its maximum power runs slower.
* :func:`nchunks_for` -- a position-chunk count that fits a problem in a
  device's memory.
* :func:`timed` -- wall time of a call, waited on with
  ``jax.block_until_ready``.

Nothing here runs at import time; the library itself never calls these.
"""

from __future__ import annotations

import os
import pathlib
import subprocess
import time

import jax

CACHE_ENV = "JAX_COMPILATION_CACHE_DIR"
SMI_QUERY = ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"]


def checkout_dir() -> pathlib.Path:
    """Root of the source checkout this package was imported from."""
    return pathlib.Path(__file__).resolve().parents[2]


def enable_compile_cache(root=None) -> str:
    """Turn on JAX's persistent compilation cache and return its directory.

    If ``JAX_COMPILATION_CACHE_DIR`` is set, JAX already uses it and
    nothing else is set. Otherwise the cache goes to the fixed
    ``<checkout>/.jax_cache`` (``root`` overrides the checkout): the path
    is part of the cache key, so it must not move between runs."""
    env = os.environ.get(CACHE_ENV)
    if env:
        return env
    path = str(pathlib.Path(root or checkout_dir()) / ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", path)
    return path


def require_gpu(devices=None) -> list:
    """Return ``devices`` (default ``jax.devices()``) if they are GPUs;
    otherwise exit with a non-zero status. There is no CPU fallback."""
    devices = jax.devices() if devices is None else list(devices)
    if not devices or devices[0].platform != "gpu":
        found = devices[0].platform if devices else "none"
        raise SystemExit(f"no GPU found (JAX platform: {found}); this "
                         "script measures the GPU and has no CPU fallback")
    return devices


def parse_card_line(line: str) -> tuple[str, str]:
    """Split one ``nvidia-smi --query-gpu=name,power.limit
    --format=csv,noheader`` line into (name, power limit)."""
    name, sep, power = line.strip().rpartition(",")
    if not sep or not name.strip() or not power.strip():
        raise ValueError(f"not a 'name, power.limit' line: {line!r}")
    return name.strip(), power.strip()


def card_lines() -> list[str]:
    """One ``name, power.limit`` line per card, as nvidia-smi prints it."""
    out = subprocess.run(SMI_QUERY, capture_output=True, text=True,
                         timeout=60, check=True).stdout
    lines = [ln.strip() for ln in out.splitlines() if ln.strip()]
    for ln in lines:
        parse_card_line(ln)
    return lines


def nchunks_for(g, device) -> int:
    """Smallest divisor of ``g.nscan`` whose per-chunk farplanes fit in
    half of ``device``'s memory limit (``memory_stats()['bytes_limit']``).

    The estimate: data and the line-search statistics (4 real frames per
    position) stay whole; about four complex64 mode-resolved farplanes
    are live per chunk."""
    bytes_limit = device.memory_stats()["bytes_limit"]
    fixed = 4 * 4 * g.ntheta * g.nscan * g.ndet ** 2
    frames = 8 * g.ntheta * g.nscan * g.nmodes * g.ndet ** 2
    for nch in range(1, g.nscan + 1):
        if g.nscan % nch == 0 and fixed + 4 * frames / nch <= bytes_limit / 2:
            return nch
    raise ValueError(f"{g} does not fit in {bytes_limit} bytes")


def timed(fn, *args, **kw):
    """(result, seconds) of ``fn(*args, **kw)``, the clock stopped only
    once ``jax.block_until_ready`` returns (dispatch is asynchronous)."""
    t0 = time.perf_counter()
    res = jax.block_until_ready(fn(*args, **kw))
    return res, time.perf_counter() - t0
