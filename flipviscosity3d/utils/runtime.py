"""Process set-up shared by the entry points (cli, bench.py, chip_smoke.py,
__graft_entry__.py): the persistent compile cache and the GPU check."""

from __future__ import annotations

import os
import subprocess

import jax

# <checkout>/.jax_cache: a fixed path, so every process of one checkout
# finds the programs an earlier one compiled (the path is part of the key)
DEFAULT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))),
    ".jax_cache",
)


def enable_compile_cache() -> str:
    """Turn on JAX's persistent compilation cache and return its directory.

    JAX reads JAX_COMPILATION_CACHE_DIR itself; when it is set, nothing else
    is configured. Otherwise the cache lives at DEFAULT_CACHE_DIR."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    jax.config.update("jax_compilation_cache_dir", DEFAULT_CACHE_DIR)
    return DEFAULT_CACHE_DIR


def require_gpu(devices) -> list:
    """The devices, if they are GPUs; SystemExit (non-zero) otherwise. Speed
    and bring-up checks never fall back to another backend."""
    devices = list(devices)
    if not devices or devices[0].platform != "gpu":
        found = devices[0].platform if devices else "none"
        raise SystemExit(f"a GPU is required, JAX found platform {found!r}")
    return devices


def card_info() -> str:
    """`nvidia-smi --query-gpu=name,power.limit` lines (one per card), run
    as a child process that never touches JAX."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip()


def describe_devices(devices) -> dict:
    """The device as JAX reports it (the keys benchmark output carries)."""
    return {
        "platform": devices[0].platform,
        "kind": devices[0].device_kind,
        "count": len(devices),
    }
