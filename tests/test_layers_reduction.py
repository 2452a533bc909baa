"""The trace reduction of ``benchmarks/layers.py``: device events are
attributed to the operator scopes by their HLO op's name stack, and busy
time is the union of kernel intervals. Checked here on compiled CPU
modules and on synthetic events; the GPU trace itself comes from a chip
run."""

import importlib.util
import pathlib

import jax
import pytest

from tikejax import Geometry
from tikejax.models import make_problem
from tikejax.ops import adj_probe_raw, adj_raw, fwd_raw

ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def layers():
    spec = importlib.util.spec_from_file_location(
        "layers", ROOT / "benchmarks" / "layers.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def compiled_ops():
    g = Geometry(nz=32, n=32, nscan=9, ndet=12, nprb=8)
    psi, scan, prb, _ = make_problem(jax.random.PRNGKey(0), g)

    def ops(psi, scan, prb):
        far = fwd_raw(psi, scan, prb, g.ndet)
        return (adj_raw(far, scan, prb, g.nz, g.n),
                adj_probe_raw(far, scan, psi, g.nprb))

    return jax.jit(ops).lower(psi, scan, prb).compile().as_text()


@pytest.mark.parametrize("scope", ["gather_probe", "fft", "ifft",
                                   "scatter_add", "probe_reduce"])
def test_op_name_map_finds_every_scope(layers, compiled_ops, scope):
    op_names = layers.op_name_map(compiled_ops)
    found = {layers.classify({"hlo_op": k}, op_names) for k in op_names}
    assert scope in found


@pytest.mark.parametrize("stats,name,want", [
    ({"name": "jit(run_impl)/while/body/ifft/jit(ifft2)/fft"}, "", "ifft"),
    ({"name": "jit(run_impl)/while/body/fft/fft"}, "", "fft"),
    ({"name": "jit(run_impl)/jit(fft)/fft"}, "", "other"),
    ({"name": "jit(run_impl)/while/body/likelihood/reduce_sum"}, "",
     "likelihood"),
    ({"hlo_op": "input_scatter_fusion.1"}, "", "scatter_add"),
    # Kernels replayed from a CUDA graph: the kernel name carries the
    # instruction name with '_' for '.'.
    ({"hlo_op": "command_buffer"}, "input_scatter_fusion_1",
     "scatter_add"),
    ({"hlo_op": "command_buffer"}, "loop_multiply_fusion", "gather_probe"),
    ({"hlo_op": "unknown_fusion"}, "", "other"),
    ({}, "", "other"),
])
def test_classify(layers, stats, name, want):
    op_names = {"input_scatter_fusion.1":
                "jit(run_impl)/while/body/scatter_add/scatter-add",
                "loop_multiply_fusion":
                "jit(run_impl)/while/body/gather_probe/mul"}
    assert layers.classify(stats, op_names, name) == want


def test_reduce_events(layers):
    ev = [("s", "a", 0, 10, {"name": "x/fft/fft"}),
          ("s", "b", 5, 10, {"name": "x/ifft/fft"}),
          ("s", "c", 30, 5, {}),
          ("s", "d", 31, 2, {"hlo_op": "f"})]
    per_layer, per_kernel, busy, window = layers.reduce_events(
        ev, {"f": "y/scatter_add/add"})
    assert dict(per_layer) == {"fft": 10, "ifft": 10, "other": 5,
                               "scatter_add": 2}
    assert per_kernel[("other", "c")] == 5
    assert busy == 20 and window == 35


@pytest.mark.parametrize("spans,want", [
    ([], 0.0),
    ([(0, 4), (2, 6), (10, 11)], 7.0),
    ([(5, 9), (0, 10)], 10.0),
])
def test_busy_ns(layers, spans, want):
    assert layers.busy_ns(spans) == want


def test_dft_matrix_is_unitary_dft(layers):
    import numpy as np

    f = np.asarray(layers.dft_matrix(8), np.complex128)
    x = np.random.default_rng(0).normal(size=(8, 8))
    np.testing.assert_allclose(f @ x @ f, np.fft.fft2(x, norm="ortho"),
                               atol=1e-6)
