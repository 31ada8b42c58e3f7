"""Entry-point set-up: engine validation, the compile-cache rule, the GPU
requirement of the measurement scripts, and the trace reduction."""

import os

import jax
import jax.numpy as jnp
import pytest

from flipviscosity3d.config import SimConfig
from flipviscosity3d.utils import runtime
from flipviscosity3d.utils import trace_stats as ts


@pytest.mark.parametrize("engine", ["table", "stream"])
def test_config_accepts_engines(engine):
    assert SimConfig(particle_engine=engine).particle_engine == engine


@pytest.mark.parametrize("engine", ["pallas", "auto", "Table", ""])
def test_config_rejects_other_engines(engine):
    with pytest.raises(ValueError, match="particle_engine"):
        SimConfig(particle_engine=engine)


@pytest.fixture
def cache_config(monkeypatch):
    """Restore jax's cache directory after the test."""
    before = jax.config.jax_compilation_cache_dir
    yield monkeypatch
    jax.config.update("jax_compilation_cache_dir", before)


@pytest.mark.parametrize("env_dir", [None, "/some/shared/cache"],
                         ids=["unset", "set"])
def test_compile_cache_rule(cache_config, env_dir):
    sentinel = "untouched"
    jax.config.update("jax_compilation_cache_dir", sentinel)
    if env_dir is None:
        cache_config.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        assert runtime.enable_compile_cache() == runtime.DEFAULT_CACHE_DIR
        assert jax.config.jax_compilation_cache_dir == (
            runtime.DEFAULT_CACHE_DIR)
        # <checkout>/.jax_cache: beside the package, inside the checkout
        root = os.path.dirname(runtime.DEFAULT_CACHE_DIR)
        assert os.path.isdir(os.path.join(root, "flipviscosity3d"))
        assert os.path.basename(runtime.DEFAULT_CACHE_DIR) == ".jax_cache"
    else:
        cache_config.setenv("JAX_COMPILATION_CACHE_DIR", env_dir)
        assert runtime.enable_compile_cache() == env_dir
        # jax reads the variable itself; the code sets no other cache
        assert jax.config.jax_compilation_cache_dir == sentinel


@pytest.mark.parametrize("devices", ["cpu", "none"])
def test_chip_smoke_refuses_non_gpu(devices):
    import chip_smoke

    devs = jax.devices("cpu") if devices == "cpu" else []
    with pytest.raises(SystemExit) as exc:
        chip_smoke.runtime.require_gpu(devs)
    assert exc.value.code != 0


def test_shape_bytes_and_stage_of():
    assert ts.shape_bytes("f32[2,3]{1,0}") == 24
    assert ts.shape_bytes("(s32[4], pred[8], f32[])") == 16 + 8 + 4
    assert ts.stage_of("jit(advance)/while/body/pressure/v_cycle/add") == (
        "pressure", True)
    assert ts.stage_of("jit(advance)/while/body/g2p/gather") == (
        "g2p", False)
    assert ts.stage_of("jit(advance)/while/body/mul") == ("other", False)


def test_parse_hlo_maps_scopes_and_bytes():
    @jax.jit
    def f(x):
        with jax.named_scope("pressure"):
            with jax.named_scope("v_cycle"):
                y = jnp.sin(x) * 2.0
        return y + 1.0

    x = jnp.ones((64, 32), jnp.float32)
    hlo = ts.parse_hlo(f.lower(x).compile().as_text())
    scoped = [n for n, i in hlo.items()
              if ts.stage_of(i.op_name) == ("pressure", True)]
    assert scoped
    # an elementwise op over the (64, 32) f32 operand reads and writes it
    assert any(ts.kernel_bytes(hlo, n) >= 2 * 64 * 32 * 4 for n in scoped)
    assert ts.kernel_bytes(hlo, "no-such-instruction") == 0


def test_reduce_kernels_and_busy_time():
    hlo = {
        "a": ts.HloInfo(100, ("b",), "jit(f)/while/body/pressure/v_cycle/x"),
        "b": ts.HloInfo(50, (), "jit(f)/while/body/sort/y"),
    }
    hlo["fusion.3"] = ts.HloInfo(8, (), "jit(f)/while/body/g2p/z")
    kernels = [
        ts.Kernel("k_a", 0, 10, "a"),
        ts.Kernel("k_a", 5, 10, "a"),     # overlaps the first
        ts.Kernel("k_b", 30, 5, "b"),
        ts.Kernel("memcpy", 40, 2, "unknown"),
        # inside a CUDA graph: matched by kernel name
        ts.Kernel("fusion_3", 50, 4, "command_buffer"),
    ]
    stages = ts.reduce_kernels(kernels, hlo)
    assert stages["pressure"] == dict(
        ns=20, launches=2, bytes=300, vcycle_ns=20, vcycle_launches=2)
    assert stages["sort"]["bytes"] == 50
    assert stages["g2p"] == dict(
        ns=4, launches=1, bytes=8, vcycle_ns=0, vcycle_launches=0)
    assert stages["other"]["launches"] == 1
    assert ts.busy_ns(kernels) == 15 + 5 + 2 + 4
