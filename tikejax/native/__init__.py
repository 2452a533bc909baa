"""Native (C++) host-runtime components, with pure-python fallbacks.

See scanprep.cpp for the rationale: the compute path is JAX/XLA,
but host-side scan conditioning (ingestion validation, coverage maps --
consumed by tikejax.compat and tikejax.models.diagnostics) is native,
like the reference's C++ runtime layer. The library is compiled on
first import (g++, ~1s) and cached next to the source; environments
without a toolchain transparently fall back to numpy.
"""

from tikejax.native.scanprep import (have_native,
                                     overlap_counts_host, validate_scan)

__all__ = ["validate_scan", "overlap_counts_host",
           "have_native"]
