"""The solver's option matrix on the XLA path at tiny shapes: every
combination of likelihood, joint probe recovery, probe modes and search
direction runs and decreases its objective."""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tikejax import Geometry
from tikejax.models import make_problem
from tikejax.solvers import run
from tikejax.solvers.cg import CGOptions, _Engine

MATRIX = list(itertools.product(("gaussian", "poisson"), (False, True),
                                (1, 2), ("dy", "lbfgs")))


@pytest.mark.parametrize("model,recover_prb,nmodes,direction", MATRIX)
def test_run_matrix(model, recover_prb, nmodes, direction):
    g = Geometry(nz=40, n=40, nscan=16, ndet=16, nprb=12, nmodes=nmodes)
    _, scan, prb, data = make_problem(jax.random.PRNGKey(nmodes), g,
                                      dtype=jnp.complex64)
    psi0 = jnp.ones(g.psi_shape, jnp.complex64)
    prb0 = prb * 0.9 if recover_prb else prb
    _, prb_out, m = run(data, psi0, scan, prb0, g, piter=10, model=model,
                        recover_prb=recover_prb, direction=direction,
                        kernel="xla")
    k = int(m["iters_run"])
    minf = np.asarray(m["minf"])[:k]
    assert k >= 2
    assert np.all(np.isfinite(minf))
    assert minf[-1] < minf[0]
    # Each accepted step passed the line search's simple-decrease test.
    assert np.all(np.diff(minf) <= 1e-6 * np.abs(minf[:-1]))
    assert prb_out.shape == g.prb_shape
    if recover_prb:
        assert np.any(np.asarray(m["gamma_prb"])[:k] > 0)


@pytest.mark.parametrize("kind", ["psi", "prb"])
def test_dy_restart_after_failed_step(kind):
    """After a failed line search the iterate does not move, so the next
    gradient is the previous one up to the scatter's rounding. The
    restart flag must give steepest descent, not a beta of
    ||g||^2 / <d_prev, rounding noise>."""
    g = Geometry(nz=16, n=16, nscan=4, ndet=8, nprb=8)
    eng = _Engine(g, CGOptions())
    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(0), 3)
    shape = g.psi_shape if kind == "psi" else g.prb_shape
    grad = jax.random.normal(k1, shape).astype(jnp.complex64)
    noise = 1e-7 * jax.random.normal(k2, shape).astype(jnp.complex64)
    d_prev = jax.random.normal(k3, shape).astype(jnp.complex64)
    d = eng.dy_direction(grad, grad + noise, d_prev, restart=True, kind=kind)
    np.testing.assert_array_equal(np.asarray(d), -np.asarray(grad))
    d = eng.dy_direction(grad, grad + noise, d_prev, restart=False,
                         kind=kind)
    assert float(jnp.max(jnp.abs(d + grad))) > 1e3
    # A zero previous direction (first iteration) is steepest descent
    # either way.
    d = eng.dy_direction(grad, grad, jnp.zeros_like(grad), restart=False,
                         kind=kind)
    np.testing.assert_array_equal(np.asarray(d), -np.asarray(grad))
