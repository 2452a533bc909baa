"""Reference-compatible solver facade.

A drop-in-shaped equivalent of the reference's solver class
(``CGPtychoSolver`` subclassing the SWIG ``ptychofft``; [R]
libtike/cufft/ptycho.py, SURVEY.md SS2/C5): same constructor geometry
arguments, same ``fwd`` / ``adj`` / ``adj_probe`` / ``run`` methods --
but accepting host numpy or device arrays (no raw GPU pointers), moving
data, and running the jitted engine underneath.

Array layouts (tikejax conventions, documented in tikejax.geometry):
``psi (ntheta, nz, n)``, ``scan (ntheta, nscan, 2)`` float (y, x),
``prb (ntheta, nmodes, nprb, nprb)`` (a mode-less ``(ntheta, nprb,
nprb)`` probe is accepted when nmodes == 1), ``data (ntheta, nscan,
ndet, ndet)``.
"""

from __future__ import annotations

import numpy as np

from tikejax.geometry import Geometry
from tikejax.ops.diffraction import Ptycho
from tikejax.solvers import cg as _cg
from tikejax.utils import hostio


class CGPtychoSolver:
    """Conjugate-gradient ptychography solver, reference-shaped API."""

    def __init__(self, ntheta: int, nz: int, n: int, nscan: int, ndet: int,
                 nprb: int, nmodes: int = 1, kernel: str = "auto"):
        self.geometry = Geometry(ntheta=ntheta, nz=nz, n=n, nscan=nscan,
                                 ndet=ndet, nprb=nprb, nmodes=nmodes)
        self.op = Ptycho(self.geometry, kernel=kernel)
        self.kernel = kernel

    # -- array ingestion -------------------------------------------------

    def _prb(self, prb):
        prb = hostio.to_device(prb, np.complex64)
        if prb.ndim == 3:
            prb = prb[:, None]
        if prb.shape != self.geometry.prb_shape:
            raise ValueError(f"prb shape {prb.shape} != "
                             f"{self.geometry.prb_shape}")
        return prb

    def _psi(self, psi):
        psi = hostio.to_device(psi, np.complex64)
        if psi.shape != self.geometry.psi_shape:
            raise ValueError(f"psi shape {psi.shape} != "
                             f"{self.geometry.psi_shape}")
        return psi

    def _scan(self, scan):
        if scan.shape != self.geometry.scan_shape:
            raise ValueError(f"scan shape {scan.shape} != "
                             f"{self.geometry.scan_shape}")
        if isinstance(scan, np.ndarray):
            # Host-side ingestion validation (native scanprep): the
            # device kernels clamp out-of-bounds windows silently, which
            # would corrupt the fit -- reject bad grids at the boundary.
            from tikejax.models import check_scan

            check_scan(scan, self.geometry)
        return hostio.to_device(scan, np.float32)

    # -- operators -------------------------------------------------------

    def fwd(self, psi, scan, prb):
        """farplane = G(psi); (ntheta, nscan, nmodes, ndet, ndet) numpy."""
        out = self.op.fwd(self._psi(psi), self._scan(scan), self._prb(prb))
        return hostio.to_host(out)

    def adj(self, farplane, scan, prb):
        out = self.op.adj(hostio.to_device(farplane, np.complex64),
                          self._scan(scan), self._prb(prb))
        return hostio.to_host(out)

    def adj_probe(self, farplane, scan, psi):
        out = self.op.adj_probe(hostio.to_device(farplane, np.complex64),
                                self._scan(scan), self._psi(psi))
        return hostio.to_host(out)

    # -- solver ----------------------------------------------------------

    def run(self, data, psi, scan, prb, piter: int = 32,
            model: str = "gaussian", recover_prb: bool = False,
            mesh=None, **kw):
        """Reconstruct; mirrors the reference's ``run`` signature.

        With ``mesh`` (a ``jax.sharding.Mesh`` from
        ``tikejax.parallel.make_mesh``: 1-D scan-position sharding or
        2-D ('theta', 'scan')), the run executes sharded over the mesh
        via :func:`tikejax.parallel.run_sharded` -- same semantics, the
        full multi-chip capability surface behind the reference-shaped
        entry point.

        Returns a dict with numpy arrays: {'psi', 'prb', 'minf', 'gamma',
        'grad_norm', 'gamma_prb'} (the reference prints diagnostics and
        returns arrays; here the per-iteration metrics come back too).
        """
        kw.setdefault("kernel", self.kernel)
        args = (hostio.to_device(data, np.float32), self._psi(psi),
                self._scan(scan), self._prb(prb), self.geometry)
        kw.update(piter=piter, model=model, recover_prb=recover_prb)
        if mesh is not None:
            from tikejax.parallel import run_sharded

            # run_sharded handles placement (and pads uneven nscan with
            # sentinel dummies); no pre-sharding needed at the facade.
            psi_r, prb_r, metrics = run_sharded(
                args[0], args[1], args[2], args[3], self.geometry, mesh,
                **kw)
        else:
            psi_r, prb_r, metrics = _cg.run(*args, **kw)
        out = {"psi": hostio.to_host(psi_r), "prb": hostio.to_host(prb_r)}
        out.update({k: hostio.to_host(v) for k, v in metrics.items()})
        return out

    def reconstruct(self, data, psi, scan, prb,
                    target_residual: float = 1e-6, **kw):
        """Deep-residual reconstruction to a target relative residual
        (the split-operator / tier-chaining driver,
        :func:`tikejax.solvers.reconstruct`) through the
        reference-shaped facade. Extra keywords pass through -- incl.
        ``mesh=`` (a 1-D scan mesh), which runs every stage sharded.

        Returns a dict {'psi', 'prb', 'residual_last', 'iters_run',
        'stages'}: ``stages`` lists (stage_name, iterations) pairs.
        """
        from tikejax.solvers import reconstruct as _reconstruct

        kw.setdefault("kernel", self.kernel)
        if kw.get("kernel") == "auto":
            del kw["kernel"]  # reconstruct chains tiers itself
        psi_r, prb_r, stages = _reconstruct(
            hostio.to_device(data, np.float32), self._psi(psi),
            self._scan(scan), self._prb(prb), self.geometry,
            target_residual=target_residual, **kw)
        total = 0
        names = []
        res_last = None
        for name, m in stages:
            k = int(hostio.to_host(m["iters_run"]))
            total += k
            names.append((name, k))
            if k > 0:
                res_last = float(
                    np.asarray(hostio.to_host(m["residual"]))[k - 1])
        return {"psi": hostio.to_host(psi_r),
                "prb": hostio.to_host(prb_r),
                "residual_last": res_last,
                "iters_run": total,
                "stages": names}
