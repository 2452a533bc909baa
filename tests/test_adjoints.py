"""Adjoint-consistency tests for the diffraction operators.

The load-bearing test of the reference ([R] tests/test_ptycho.py,
SURVEY.md SS4 item 1): random psi/prb/g, check
``<fwd(psi), g> == <psi, adj(g)>`` and ``<fwd_prb(prb), g> == <prb,
adj_probe(g)>``. Here additionally cross-checked against ``jax.vjp`` of the
raw forward, in complex128 (1e-12) and complex64 (1e-5), and against the
acceptance config BASELINE.json:7 (256^2 object, 64^2 probe, 100 positions,
<1e-6 relative).
"""

import jax
import jax.numpy as jnp
import pytest

from tikejax import Geometry
from tikejax.models import make_problem
from tikejax.ops import adj_probe_raw, adj_raw, fwd_raw


def inner(a, b):
    return jnp.vdot(a, b)  # sum(conj(a) * b)


def rand_c(key, shape, dtype):
    kr, ki = jax.random.split(key)
    real_dtype = jnp.real(jnp.zeros((), dtype)).dtype
    return (jax.random.normal(kr, shape, real_dtype) +
            1j * jax.random.normal(ki, shape, real_dtype)).astype(dtype)


GEOMS = [
    Geometry(nz=32, n=40, nscan=17, ndet=16, nprb=10, ntheta=1, nmodes=1),
    Geometry(nz=32, n=32, nscan=9, ndet=16, nprb=16, ntheta=2, nmodes=3),
]


def make_inputs(key, g, dtype):
    k1, k2, k3, k4 = jax.random.split(key, 4)
    psi = rand_c(k1, g.psi_shape, dtype)
    prb = rand_c(k2, g.prb_shape, dtype)
    farp = rand_c(k3, g.farplane_shape, dtype)
    real_dtype = jnp.real(jnp.zeros((), dtype)).dtype
    scan = jnp.stack([
        jax.random.uniform(k4, (g.ntheta, g.nscan),
                           minval=0., maxval=g.nz - g.nprb + 0.999),
        jax.random.uniform(jax.random.fold_in(k4, 1), (g.ntheta, g.nscan),
                           minval=0., maxval=g.n - g.nprb + 0.999),
    ], axis=-1).astype(real_dtype)
    return psi, scan, prb, farp


@pytest.mark.parametrize("g", GEOMS)
@pytest.mark.parametrize("dtype,tol", [(jnp.complex128, 1e-12),
                                       (jnp.complex64, 1e-5)])
def test_object_adjoint(rng, g, dtype, tol):
    psi, scan, prb, farp = make_inputs(rng, g, dtype)
    lhs = inner(fwd_raw(psi, scan, prb, g.ndet), farp)
    rhs = inner(psi, adj_raw(farp, scan, prb, g.nz, g.n))
    assert abs(lhs - rhs) / abs(lhs) < tol


@pytest.mark.parametrize("g", GEOMS)
@pytest.mark.parametrize("dtype,tol", [(jnp.complex128, 1e-12),
                                       (jnp.complex64, 1e-5)])
def test_probe_adjoint(rng, g, dtype, tol):
    psi, scan, prb, farp = make_inputs(rng, g, dtype)
    lhs = inner(fwd_raw(psi, scan, prb, g.ndet), farp)
    rhs = inner(prb, adj_probe_raw(farp, scan, psi, g.nprb))
    assert abs(lhs - rhs) / abs(lhs) < tol


@pytest.mark.parametrize("g", GEOMS)
def test_vjp_crosscheck(rng, g):
    """Hand adjoints must equal jax.vjp of the raw forward (complex128).

    JAX's vjp of a C-linear map is the unconjugated transpose A^T, so the
    Hermitian adjoint A^H relates to it by A^H y = conj(A^T conj(y)).
    """
    psi, scan, prb, farp = make_inputs(rng, g, jnp.complex128)
    _, vjp = jax.vjp(lambda ps, pr: fwd_raw(ps, scan, pr, g.ndet), psi, prb)
    dpsi_t, dprb_t = vjp(jnp.conj(farp))
    dpsi = adj_raw(farp, scan, prb, g.nz, g.n)
    dprb = adj_probe_raw(farp, scan, psi, g.nprb)
    assert jnp.max(jnp.abs(jnp.conj(dpsi_t) - dpsi)) < 1e-12 * jnp.max(
        jnp.abs(dpsi))
    assert jnp.max(jnp.abs(jnp.conj(dprb_t) - dprb)) < 1e-12 * jnp.max(
        jnp.abs(dprb))


def test_custom_vjp_matches_native_ad(rng):
    """jax.grad through ops.fwd (custom_vjp) must be numerically identical
    to jax.grad through the raw forward (native XLA AD)."""
    from tikejax.ops import fwd

    g = GEOMS[1]
    psi, scan, prb, farp = make_inputs(rng, g, jnp.complex128)

    def loss(op):
        def f(ps, pr):
            r = op(ps, scan, pr, g.ndet) - farp
            return 0.5 * jnp.sum(jnp.abs(r)**2)
        return f

    dpsi, dprb = jax.grad(loss(fwd), argnums=(0, 1))(psi, prb)
    dpsi_ad, dprb_ad = jax.grad(loss(fwd_raw), argnums=(0, 1))(psi, prb)
    assert jnp.max(jnp.abs(dpsi - dpsi_ad)) < 1e-12 * jnp.max(jnp.abs(dpsi_ad))
    assert jnp.max(jnp.abs(dprb - dprb_ad)) < 1e-12 * jnp.max(jnp.abs(dprb_ad))
    # And the gradient actually descends.
    l0 = loss(fwd_raw)(psi, prb)
    l1 = loss(fwd_raw)(psi - 1e-3 * jnp.conj(dpsi), prb)
    assert l1 < l0


@pytest.mark.parametrize("dtype,tol", [
    # The <1e-6 acceptance criterion (BASELINE.json:7) is on the operator
    # math; complex128 verifies it with orders of magnitude to spare. In
    # complex64 the ~4e5-term inner products themselves carry ~1e-4 of fp32
    # summation noise, so the c64 run checks the fp32 noise floor instead.
    (jnp.complex128, 1e-6),
    (jnp.complex64, 1e-3),
])
def test_acceptance_config_roundtrip(rng, dtype, tol):
    """BASELINE.json:7 — 256^2 object, 64^2 probe, 100 raster positions,
    adjoint dot-product test < 1e-6."""
    g = Geometry(nz=256, n=256, nscan=100, ndet=64, nprb=64)
    psi, scan, prb, _ = make_problem(rng, g, dtype=dtype)
    farp = rand_c(jax.random.fold_in(rng, 7), g.farplane_shape, dtype)
    lhs = inner(fwd_raw(psi, scan, prb, g.ndet), farp)
    rhs_o = inner(psi, adj_raw(farp, scan, prb, g.nz, g.n))
    rhs_p = inner(prb, adj_probe_raw(farp, scan, psi, g.nprb))
    assert abs(lhs - rhs_o) / abs(lhs) < tol
    assert abs(lhs - rhs_p) / abs(lhs) < tol


def test_scatter_is_adjoint_of_gather(rng):
    from tikejax.ops import gather_patches, scatter_patches_add, scan_to_int

    g = GEOMS[0]
    psi, scan, _, _ = make_inputs(rng, g, jnp.complex128)
    si = scan_to_int(scan)
    patches = rand_c(jax.random.fold_in(rng, 3),
                     (g.ntheta, g.nscan, g.nprb, g.nprb), jnp.complex128)
    lhs = inner(gather_patches(psi, si, g.nprb), patches)
    rhs = inner(psi, scatter_patches_add(patches, si, g.nz, g.n))
    assert abs(lhs - rhs) / abs(lhs) < 1e-13


def test_fwd_deterministic(rng):
    """On the CPU the scatter's summation order is fixed, so repeated
    adjoints are bitwise identical (on a GPU the atomic scatter-add,
    like the reference's atomicAdd, may differ in the last bits --
    SURVEY.md SS3.3, ops/patches.py)."""
    g = GEOMS[1]
    psi, scan, prb, farp = make_inputs(rng, g, jnp.complex64)
    a = adj_raw(farp, scan, prb, g.nz, g.n)
    b = adj_raw(farp, scan, prb, g.nz, g.n)
    assert jnp.all(a == b)
