"""Tracing / profiling hooks.

The reference has no in-repo profiling (users run nvprof/nsys externally;
SURVEY.md SS5). Here: a context manager around ``jax.profiler`` producing
a Perfetto/TensorBoard-readable trace, a device barrier, and a tiny
wall-clock timer for steady-state measurements.
"""

from __future__ import annotations

import contextlib
import time

import jax


def device_sync(x) -> None:
    """Wait until every array in the pytree ``x`` has been computed
    (``jax.block_until_ready``)."""
    jax.block_until_ready(x)


@contextlib.contextmanager
def trace(logdir: str):
    """Capture a device trace viewable in TensorBoard/Perfetto:

    >>> with trace("/tmp/tikejax-trace"):
    ...     run(...)  # traced
    """
    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


class Timer:
    """Wall-clock timing of jitted calls with proper device sync.

    >>> timer = Timer()
    >>> with timer("cg"):
    ...     out = run(...)        # async dispatch
    ...     jax.block_until_ready(out)
    >>> timer.times["cg"]
    """

    def __init__(self):
        self.times: dict[str, float] = {}

    @contextlib.contextmanager
    def __call__(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.times[name] = time.perf_counter() - t0


def summarize_metrics(metrics, every: int = 1) -> str:
    """Human-readable convergence table from the solver's metric arrays
    (the replacement for the reference's in-loop prints)."""
    from tikejax.utils.hostio import to_host

    minf = to_host(metrics["minf"])
    gamma = to_host(metrics["gamma"])
    gnorm = to_host(metrics["grad_norm"])
    lines = ["iter       minf        gamma    |grad|"]
    for i in range(0, len(minf), every):
        lines.append(
            f"{i:4d}  {minf[i]: .6e}  {gamma[i]:6.3f}  {gnorm[i]:.3e}")
    return "\n".join(lines)
