"""What the XLA-only operator layer accepts and refuses, the compile-cache
and device helpers of the GPU scripts, and the pieces of ``chip_smoke.py``
that do not need a card."""

import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import pytest

from tikejax import Geometry, Ptycho
from tikejax.models import make_problem
from tikejax.ops import diffraction
from tikejax.solvers import reconstruct, run
from tikejax.solvers.cg import (REMOVED_OPTIONS, CGOptions, make_options,
                                normalize_options)
from tikejax.utils import runtime

ROOT = pathlib.Path(__file__).resolve().parents[1]
G = Geometry(nz=32, n=32, nscan=9, ndet=8, nprb=8)


@pytest.fixture(scope="module")
def small():
    psi, scan, prb, data = make_problem(jax.random.PRNGKey(0), G)
    return psi, scan, prb, data


@pytest.fixture(scope="module")
def chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("kernel", diffraction.REMOVED_KERNELS)
def test_removed_kernel_raises(kernel, small):
    psi, scan, prb, data = small
    with pytest.raises(ValueError, match="removed"):
        diffraction.resolve_kernel(kernel)
    with pytest.raises(ValueError, match="removed"):
        Ptycho(G, kernel=kernel)
    with pytest.raises(ValueError, match="removed"):
        run(data, psi, scan, prb, G, piter=1, kernel=kernel)


@pytest.mark.parametrize("option", REMOVED_OPTIONS)
def test_removed_option_raises(option, small):
    psi, scan, prb, data = small
    with pytest.raises(ValueError, match="removed"):
        make_options(None, **{option: 1})
    with pytest.raises(ValueError, match="removed"):
        run(data, psi, scan, prb, G, piter=1, **{option: 1})
    with pytest.raises(ValueError, match="removed"):
        reconstruct(data, psi, scan, prb, G, target_residual=1e-3,
                    **{option: 1})


def test_unknown_kernel_raises():
    with pytest.raises(ValueError, match="unknown kernel"):
        diffraction.resolve_kernel("cuda")


def test_removed_kernel_in_reconstruct_stage_raises(small):
    psi, scan, prb, data = small
    with pytest.raises(ValueError, match="removed"):
        reconstruct(data, psi, scan, prb, G, target_residual=1e-3,
                    tiers=(("fused", 5e-3, 8),))


@pytest.mark.parametrize("backend", ["cpu", "gpu"])
def test_auto_resolves_to_xla(backend, monkeypatch):
    monkeypatch.setattr(jax, "default_backend", lambda: backend)
    assert diffraction.resolve_kernel("auto") == "xla"
    assert diffraction.resolve_kernel("xla") == "xla"
    assert normalize_options(CGOptions()).kernel == "xla"
    assert Ptycho(G).kernel == "auto"


@pytest.fixture
def cache_config():
    """Restore JAX's compile-cache setting after a test changes it."""
    before = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", before)


def test_compile_cache_env_set(monkeypatch, tmp_path, cache_config):
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "env"))
    assert runtime.enable_compile_cache(root=tmp_path) == str(tmp_path /
                                                              "env")
    # JAX reads the variable itself; the helper sets nothing.
    assert jax.config.jax_compilation_cache_dir == before


def test_compile_cache_env_unset(monkeypatch, tmp_path, cache_config):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = runtime.enable_compile_cache(root=tmp_path)
    assert path == str(tmp_path / ".jax_cache")
    assert jax.config.jax_compilation_cache_dir == path


def test_compile_cache_path_stable(monkeypatch, cache_config):
    """Without the variable the cache sits at one fixed path in the
    checkout (the path is part of the cache key), listed in .gitignore."""
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    assert runtime.checkout_dir() == ROOT
    first = runtime.enable_compile_cache()
    assert first == runtime.enable_compile_cache() == str(ROOT /
                                                          ".jax_cache")
    ignored = (ROOT / ".gitignore").read_text().split()
    assert ".jax_cache/" in ignored


def test_require_gpu_refuses_cpu():
    assert jax.devices()[0].platform == "cpu"
    with pytest.raises(SystemExit, match="no GPU"):
        runtime.require_gpu()
    with pytest.raises(SystemExit, match="no GPU"):
        runtime.require_gpu([])


def test_chip_smoke_refuses_cpu(chip_smoke):
    with pytest.raises(SystemExit, match="no GPU"):
        chip_smoke.check_device()
    with pytest.raises(SystemExit, match="no GPU"):
        chip_smoke.main([])


def test_chip_smoke_counts_devices(chip_smoke):
    class Gpu:
        platform = "gpu"

    assert len(chip_smoke.check_device([Gpu()] * 4, count=4)) == 4
    with pytest.raises(SystemExit, match="expected 4"):
        chip_smoke.check_device([Gpu()], count=4)


@pytest.mark.parametrize("line,want", [
    ("NVIDIA H100 80GB HBM3, 700.00 W", ("NVIDIA H100 80GB HBM3",
                                         "700.00 W")),
    ("  NVIDIA H100 PCIe, 350.00 W\n", ("NVIDIA H100 PCIe", "350.00 W")),
    ("Card, with comma, [N/A]", ("Card, with comma", "[N/A]")),
])
def test_parse_card_line(line, want):
    assert runtime.parse_card_line(line) == want


@pytest.mark.parametrize("line", ["", "NVIDIA H100", ", 700 W", "H100, "])
def test_parse_card_line_rejects(line):
    with pytest.raises(ValueError):
        runtime.parse_card_line(line)


def test_nchunks_for():
    class Dev:
        def __init__(self, limit):
            self.limit = limit

        def memory_stats(self):
            return {"bytes_limit": self.limit}

    g = Geometry(nz=512, n=512, nscan=16384, ndet=128, nprb=128, nmodes=4)
    gib = 2**30
    # 8.6 GB of c64 farplanes per chunk-less pass, 4.3 GB of data and
    # statistics: a 60 GiB card needs 2 chunks, a huge one none.
    assert runtime.nchunks_for(g, Dev(60 * gib)) == 2
    assert runtime.nchunks_for(g, Dev(10**15)) == 1
    nch = runtime.nchunks_for(g, Dev(16 * gib))
    assert g.nscan % nch == 0 and nch > 2
    with pytest.raises(ValueError, match="does not fit"):
        runtime.nchunks_for(g, Dev(gib))


def test_chip_smoke_check_descent(chip_smoke):
    import numpy as np

    chip_smoke.check_descent("ok", np.array([3.0, 2.0, 2.0, 1.0]), True)
    with pytest.raises(AssertionError, match="rose"):
        chip_smoke.check_descent("up", np.array([3.0, 2.0, 2.5]), True)
    chip_smoke.check_descent("joint", np.array([3.0, 3.5, 1.0]), False)
    with pytest.raises(AssertionError, match="non-finite"):
        chip_smoke.check_descent("nan", np.array([3.0, np.nan]), False)
    with pytest.raises(AssertionError, match="did not decrease"):
        chip_smoke.check_descent("flat", np.array([3.0, 3.0]), False)


def test_fwd_runs_on_default_device(small):
    """The operator bundle runs on whatever device JAX selects; on the
    CPU test platform that is the CPU (no interpreter, no fallback)."""
    psi, scan, prb, _ = small
    out = jax.jit(Ptycho(G).fwd)(psi, scan, prb)
    assert out.shape == G.farplane_shape
    assert out.devices() == {jax.devices()[0]}
    assert jnp.all(jnp.isfinite(jnp.abs(out)))
