"""The XLA operator path against a float64 numpy reference.

The reference below is written independently of the library: an explicit
loop over angles and scan positions, ``np.fft`` for the unitary 2-D
transforms, and ``np.add.at`` for the overlap scatter. Every geometry is
chosen to reach a corner of the operator: odd sizes, probe modes with
several angles, a probe side that is not a multiple of 8, a detector
larger than the probe, sentinel (masked) positions, positions on the
object's edges, and fractional positions that floor.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tikejax import Geometry
from tikejax.ops import (adj_probe_raw, adj_raw, fwd_raw, gather_patches,
                         scan_to_int, scatter_patches_add)


def _scan(rng, g, kind):
    hi_y, hi_x = g.nz - g.nprb, g.n - g.nprb
    if kind == "edges":
        corners = [(0, 0), (0, hi_x), (hi_y, 0), (hi_y, hi_x)]
        pts = [corners[i % 4] for i in range(g.nscan)]
        s = np.asarray(pts, np.float64)[None].repeat(g.ntheta, 0)
    else:
        s = np.stack([rng.uniform(0, hi_y + 0.999, (g.ntheta, g.nscan)),
                      rng.uniform(0, hi_x + 0.999, (g.ntheta, g.nscan))],
                     -1)
    if kind == "sentinel":
        s[:, ::3, 0] = -1.0
    return s


# (label, geometry, scan kind)
CASES = [
    ("odd", Geometry(nz=37, n=41, nscan=7, ndet=9, nprb=9), "random"),
    ("modes_theta", Geometry(nz=32, n=30, nscan=5, ndet=8, nprb=8,
                             ntheta=2, nmodes=3), "random"),
    ("nprb13", Geometry(nz=40, n=40, nscan=6, ndet=13, nprb=13), "random"),
    ("ndet_gt_nprb", Geometry(nz=36, n=34, nscan=6, ndet=16, nprb=10,
                              nmodes=2), "random"),
    ("sentinel", Geometry(nz=32, n=32, nscan=9, ndet=12, nprb=8,
                          ntheta=2), "sentinel"),
    ("edges", Geometry(nz=29, n=33, nscan=8, ndet=11, nprb=11,
                       nmodes=2), "edges"),
    ("fractional", Geometry(nz=24, n=24, nscan=11, ndet=10, nprb=7),
     "random"),
]
IDS = [c[0] for c in CASES]


def _complex(rng, shape):
    return rng.normal(size=shape) + 1j * rng.normal(size=shape)


def _inputs(case, seed=0):
    _, g, kind = case
    rng = np.random.default_rng(seed)
    return (g, _complex(rng, g.psi_shape), _scan(rng, g, kind),
            _complex(rng, g.prb_shape), _complex(rng, g.farplane_shape))


def _positions(scan):
    """Integer (y, x) corners of the valid positions, per angle."""
    for t in range(scan.shape[0]):
        for k in range(scan.shape[1]):
            y, x = np.floor(scan[t, k]).astype(int)
            if y >= 0:
                yield t, k, y, x


def ref_fwd(psi, scan, prb, ndet):
    g_t, g_s = scan.shape[:2]
    nm, p = prb.shape[1], prb.shape[-1]
    out = np.zeros((g_t, g_s, nm, ndet, ndet), np.complex128)
    for t, k, y, x in _positions(scan):
        for m in range(nm):
            frame = np.zeros((ndet, ndet), np.complex128)
            frame[:p, :p] = psi[t, y:y + p, x:x + p] * prb[t, m]
            out[t, k, m] = np.fft.fft2(frame, norm="ortho")
    return out


def ref_adj(farp, scan, prb, nz, n):
    p = prb.shape[-1]
    out = np.zeros((scan.shape[0], nz, n), np.complex128)
    for t, k, y, x in _positions(scan):
        for m in range(prb.shape[1]):
            near = np.fft.ifft2(farp[t, k, m], norm="ortho")[:p, :p]
            out[t, y:y + p, x:x + p] += np.conj(prb[t, m]) * near
    return out


def ref_adj_probe(farp, scan, psi, nprb):
    nm = farp.shape[2]
    out = np.zeros((scan.shape[0], nm, nprb, nprb), np.complex128)
    for t, k, y, x in _positions(scan):
        patch = psi[t, y:y + nprb, x:x + nprb]
        for m in range(nm):
            near = np.fft.ifft2(farp[t, k, m], norm="ortho")[:nprb, :nprb]
            out[t, m] += np.conj(patch) * near
    return out


def _j(x):
    return jnp.asarray(x)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_fwd_matches_numpy(case):
    g, psi, scan, prb, _ = _inputs(case)
    got = np.asarray(fwd_raw(_j(psi), _j(scan), _j(prb), g.ndet))
    np.testing.assert_allclose(got, ref_fwd(psi, scan, prb, g.ndet),
                               rtol=0, atol=1e-12)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_adj_matches_numpy(case):
    g, psi, scan, prb, farp = _inputs(case)
    got = np.asarray(adj_raw(_j(farp), _j(scan), _j(prb), g.nz, g.n))
    np.testing.assert_allclose(got, ref_adj(farp, scan, prb, g.nz, g.n),
                               rtol=0, atol=1e-12)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_adj_probe_matches_numpy(case):
    g, psi, scan, prb, farp = _inputs(case)
    got = np.asarray(adj_probe_raw(_j(farp), _j(scan), _j(psi), g.nprb))
    np.testing.assert_allclose(got, ref_adj_probe(farp, scan, psi, g.nprb),
                               rtol=0, atol=1e-12)


@pytest.mark.parametrize("case", CASES, ids=IDS)
@pytest.mark.parametrize("target", ["object", "probe"])
def test_adjoint_identity_complex64(case, target):
    """<A x, y> = <x, A^H y> in complex64; the float32 operators and
    the float32 inner products each carry ~1e-7 relative rounding."""
    g, psi, scan, prb, farp = _inputs(case, seed=1)
    c64 = lambda x: jnp.asarray(x, jnp.complex64)  # noqa: E731
    psi, prb, farp = c64(psi), c64(prb), c64(farp)
    scan = jnp.asarray(scan, jnp.float32)
    lhs = jnp.vdot(fwd_raw(psi, scan, prb, g.ndet), farp)
    if target == "object":
        rhs = jnp.vdot(psi, adj_raw(farp, scan, prb, g.nz, g.n))
    else:
        rhs = jnp.vdot(prb, adj_probe_raw(farp, scan, psi, g.nprb))
    assert abs(complex(lhs - rhs)) / abs(complex(lhs)) < 1e-5


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_scatter_matches_np_add_at(case):
    """The overlap scatter-add equals numpy's unbuffered ``np.add.at``
    over the same index grids (sentinel positions add nothing)."""
    g, _, scan, _, _ = _inputs(case, seed=2)
    rng = np.random.default_rng(3)
    patches = _complex(rng, (g.ntheta, g.nscan, g.nprb, g.nprb))
    got = np.asarray(scatter_patches_add(_j(patches),
                                         scan_to_int(_j(scan)), g.nz, g.n))
    want = np.zeros(g.psi_shape, np.complex128)
    r = np.arange(g.nprb)
    for t, k, y, x in _positions(scan):
        np.add.at(want[t], (y + r[:, None], x + r[None, :]), patches[t, k])
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_gather_zeroes_sentinels(case):
    """Gathered patches equal the object windows; sentinel positions
    (scan row < 0) gather zeros."""
    g, psi, scan, _, _ = _inputs(case, seed=4)
    got = np.asarray(gather_patches(_j(psi), scan_to_int(_j(scan)), g.nprb))
    want = np.zeros((g.ntheta, g.nscan, g.nprb, g.nprb), np.complex128)
    for t, k, y, x in _positions(scan):
        want[t, k] = psi[t, y:y + g.nprb, x:x + g.nprb]
    np.testing.assert_array_equal(got, want)


def test_cases_reach_their_corners():
    """The geometries above really hold what their labels claim."""
    by = {c[0]: c for c in CASES}
    assert by["odd"][1].nz % 2 and by["odd"][1].n % 2
    assert by["modes_theta"][1].nmodes > 1 and by["modes_theta"][1].ntheta > 1
    assert by["nprb13"][1].nprb % 8
    assert by["ndet_gt_nprb"][1].ndet > by["ndet_gt_nprb"][1].nprb
    _, _, scan, _, _ = _inputs(by["sentinel"])
    assert (scan[..., 0] < 0).any()
    g, _, scan, _, _ = _inputs(by["edges"])
    assert scan[..., 0].max() == g.nz - g.nprb
    assert scan[..., 1].max() == g.n - g.nprb
    _, _, scan, _, _ = _inputs(by["fractional"])
    assert (scan != np.floor(scan)).any()
    assert jax.config.jax_enable_x64
