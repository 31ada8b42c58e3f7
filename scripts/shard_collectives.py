#!/usr/bin/env python
"""Collective audit of the shard_map substep: compile advance_sharded on the
virtual CPU mesh and report every collective in the HLO with its shape and
per-substep byte volume, which shows the stencil path is halo exchanges,
not all-gathers.

Usage: python scripts/shard_collectives.py [--res 32] [--ndev 4]
"""

from __future__ import annotations

import argparse
import os
import re
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()
os.environ["JAX_PLATFORMS"] = "cpu"

import numpy as np
import jax

# force the CPU mesh the same way tests/conftest.py does
jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp
from jax.sharding import Mesh

from flipviscosity3d import FluidSimulation
from flipviscosity3d.io.trianglemesh import box_mesh
from flipviscosity3d.parallel import shard_step as sh

_DTYPE_BYTES = {"f32": 4, "s32": 4, "u32": 4, "pred": 1, "f64": 8, "s8": 1}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--res", type=int, default=32)
    ap.add_argument("--ndev", type=int, default=4)
    args = ap.parse_args()

    n = args.res
    sim = FluidSimulation()
    sim.initialize(n, n, n, 1.0 / n,
                   pressure_preconditioner="jacobi",
                   viscosity_preconditioner="jacobi")
    sim.add_liquid(box_mesh((0.2, 0.25, 0.2), (0.8, 0.6, 0.8)))
    sim.set_viscosity(1.5)
    sim.set_gravity(0.0, -9.81, 0.0)
    cfg, state = sim.cfg, sim.state
    mesh = Mesh(np.array(jax.devices()[: args.ndev]), (sh.AXIS,))
    spec = sh.make_spec(cfg, args.ndev, n_particles=state.pos.shape[0])
    ss = sh.shard_simstate(state, cfg, spec, mesh)

    lowered = sh.advance_sharded.lower(ss, 0.01, cfg, spec, mesh)
    hlo = lowered.compile().as_text()

    counts = {}
    bytes_per = {}
    pat = re.compile(
        r"(\w[\w-]*) = (\w+)\[([\d,]*)\][^\n]*?"
        r"(collective-permute|all-reduce|all-gather|all-to-all)"
    )
    for m in re.finditer(
        r"([a-z0-9._-]+)\[((?:\d+,?)*)\][^\n]*?"
        r"\b(collective-permute|all-reduce|all-gather|all-to-all)\b",
        hlo,
    ):
        dtype, dims, kind = m.group(1), m.group(2), m.group(3)
        base = dtype.split("[")[0]
        nbytes = _DTYPE_BYTES.get(base, 4)
        for d in filter(None, dims.split(",")):
            nbytes *= int(d)
        counts[kind] = counts.get(kind, 0) + 1
        bytes_per[kind] = bytes_per.get(kind, 0) + nbytes

    # simpler, robust: count op kinds line by line
    kinds = {}
    sizes = {}
    for line in hlo.splitlines():
        for kind in ("collective-permute(", "all-reduce(", "all-gather(",
                     "all-to-all("):
            if kind in line and "=" in line:
                k = kind[:-1]
                kinds[k] = kinds.get(k, 0) + 1
                sm = re.search(r"=\s*(\w+)\[([\d,]*)\]", line)
                if sm:
                    nbytes = _DTYPE_BYTES.get(sm.group(1), 4)
                    for d in filter(None, sm.group(2).split(",")):
                        nbytes *= int(d)
                    sizes[k] = sizes.get(k, 0) + nbytes

    print(f"# shard_map advance at {n}^3 over {args.ndev} shards "
          f"(B={spec.B}, H={spec.H})")
    total = 0
    for k in sorted(kinds):
        print(f"{k:22s} ops={kinds[k]:4d}  bytes/exec={sizes.get(k, 0):,}")
        total += sizes.get(k, 0)
    ag = kinds.get("all-gather", 0)
    print(f"# total collective payload per compiled program: {total:,} bytes")
    print(f"# all-gathers on the path: {ag} "
          f"({'OK - none' if ag == 0 else 'INVESTIGATE'})")


if __name__ == "__main__":
    main()
