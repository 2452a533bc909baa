"""Problem geometry for far-field ptychography.

Mirrors the capability surface of the reference constructor
``ptychofft(ntheta, nz, n, nscan, ndet, nprb)`` ([R] src/cuda/ptychofft.cuh,
see SURVEY.md SS2/C1), extended with a first-class incoherent probe-mode axis
(``nmodes``) which the reference handles only implicitly (SURVEY.md SS2/C5,
BASELINE.json:10).

Array layout conventions (all shapes static, XLA friendly):

==============  =============================================  =========
array           shape                                          dtype
==============  =============================================  =========
``psi``         ``(ntheta, nz, n)``                            complex
``scan``        ``(ntheta, nscan, 2)`` -- (y, x) top-left      float
                corner of each probe patch, in pixels;
                must satisfy ``0 <= y <= nz - nprb`` and
                ``0 <= x <= n - nprb`` (floored to ints,
                like the reference's C-cast of float coords)
``prb``         ``(ntheta, nmodes, nprb, nprb)``               complex
``farplane``    ``(ntheta, nscan, nmodes, ndet, ndet)``        complex
``data``        ``(ntheta, nscan, ndet, ndet)`` -- photon      real
                counts, i.e. |farplane|^2 summed over modes
==============  =============================================  =========
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class Geometry:
    """Static problem geometry.

    Attributes:
      nz: object grid height (pixels).
      n: object grid width (pixels).
      nscan: number of scan positions per angle.
      ndet: detector frame side (pixels).
      nprb: probe side (pixels); ``nprb <= ndet`` (zero-padded into the
        detector frame before the FFT, as in the reference fwd kernel).
      ntheta: number of projections/angles batched together (1 for plain
        ptychography; >1 for ptycho-tomography style batching).
      nmodes: number of incoherent probe modes.
    """

    nz: int
    n: int
    nscan: int
    ndet: int
    nprb: int
    ntheta: int = 1
    nmodes: int = 1

    def __post_init__(self) -> None:
        if self.nprb > self.ndet:
            raise ValueError(
                f"nprb ({self.nprb}) must be <= ndet ({self.ndet}); the probe "
                "patch is zero-padded into the detector frame")
        if self.nprb > min(self.nz, self.n):
            raise ValueError(
                f"nprb ({self.nprb}) must fit inside the object "
                f"({self.nz} x {self.n})")
        for name in ("nz", "n", "nscan", "ndet", "nprb", "ntheta", "nmodes"):
            if getattr(self, name) < 1:
                raise ValueError(f"{name} must be >= 1")

    @property
    def psi_shape(self) -> tuple[int, int, int]:
        return (self.ntheta, self.nz, self.n)

    @property
    def scan_shape(self) -> tuple[int, int, int]:
        return (self.ntheta, self.nscan, 2)

    @property
    def prb_shape(self) -> tuple[int, int, int, int]:
        return (self.ntheta, self.nmodes, self.nprb, self.nprb)

    @property
    def farplane_shape(self) -> tuple[int, int, int, int, int]:
        return (self.ntheta, self.nscan, self.nmodes, self.ndet, self.ndet)

    @property
    def data_shape(self) -> tuple[int, int, int, int]:
        return (self.ntheta, self.nscan, self.ndet, self.ndet)
