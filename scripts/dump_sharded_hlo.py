#!/usr/bin/env python
"""Audit what XLA SPMD emits for the sharded stencil path.

Jits the 7-point pressure matvec and the coupled viscosity matvec with all
operands sharded P(x, None, None) on an 8-device CPU mesh, then counts the
collective ops in the optimized HLO. The stencil path should lower to
collective-permute halo exchanges (one cell along i), NOT all-gathers.

Run: python scripts/dump_sharded_hlo.py [RES]
"""

from __future__ import annotations

import os
import re
import sys

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax

# point jax at the virtual CPU mesh (same recipe as tests/conftest)
jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp
import numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P

from flipviscosity3d.config import SimConfig
from flipviscosity3d.parallel.sharding import make_mesh
from flipviscosity3d.solvers import pressure as ps
from flipviscosity3d.solvers import viscosity as vs

RES = int(sys.argv[1]) if len(sys.argv) > 1 else 64


def count_collectives(hlo_text):
    counts = {}
    for op in ("collective-permute", "all-gather", "all-reduce",
               "all-to-all", "reduce-scatter"):
        counts[op] = len(re.findall(rf"\b{op}\b", hlo_text))
    return counts


def main():
    cfg = SimConfig(isize=RES, jsize=RES, ksize=RES, dx=1.0 / RES)
    mesh = make_mesh(8)
    shard = NamedSharding(mesh, P("x", None, None))

    rng = np.random.default_rng(0)

    # ---- pressure 7-point matvec: all operands cell-shaped -> all sharded
    shape = cfg.grid_shape
    jj = np.arange(RES, dtype=np.float32) + 0.5
    phi = np.broadcast_to(
        ((jj - 0.55 * RES) / RES)[None, :, None], shape
    ).astype(np.float32).copy()
    fluid = jnp.asarray(phi < 0)
    diag = jnp.asarray(rng.uniform(1, 2, shape).astype(np.float32)) * fluid
    plus = [
        jnp.asarray(-rng.uniform(0, 1, shape).astype(np.float32)) * fluid
        for _ in range(3)
    ]
    b = jnp.asarray(rng.normal(size=shape).astype(np.float32)) * fluid
    sys_p = ps.PressureSystem(
        fluid, diag, plus[0], plus[1], plus[2], b,
        jnp.ones(cfg.u_shape), jnp.ones(cfg.v_shape), jnp.ones(cfg.w_shape),
    )
    x = jax.device_put(b, shard)
    sys_sharded = jax.tree.map(
        lambda a: jax.device_put(
            a, shard if a.shape == shape else NamedSharding(mesh, P())
        ),
        sys_p,
    )

    lowered = jax.jit(ps.apply_pressure_matrix).lower(sys_sharded, x)
    hlo = lowered.compile().as_text()
    print(f"pressure matvec @ {RES}^3, 8 shards on i:")
    for k, v in count_collectives(hlo).items():
        print(f"  {k:20s} {v}")

    # ---- one V-cycle of the pressure MG preconditioner
    precon = ps.solve_pressure  # full solve includes V-cycles + CG dots
    lowered = jax.jit(
        lambda s: precon(s, cfg)
    ).lower(sys_sharded)
    hlo = lowered.compile().as_text()
    print(f"pressure solve (MG-PCG) @ {RES}^3:")
    for k, v in count_collectives(hlo).items():
        print(f"  {k:20s} {v}")


if __name__ == "__main__":
    main()
