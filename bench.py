#!/usr/bin/env python
"""Headline benchmark: simulation substeps per second of
`FluidSimulation.advance` on one GPU, 128^3 grid, ~4.1M particles, with the
full pressure + viscosity pipeline.

Scene: a deep pool of liquid (the bottom ~27% of the open interior, ~4.1M
particles seeded 8 per cell) inside the default domain boundary, viscosity
5.0, gravity -9.81. Each timed frame ends in a host read of its
diagnostics, which waits for the device.

    python bench.py [--engine table|stream] [--resolution 128] [--frames 5]

Prints the device (platform, device_kind, count, card name and power limit)
on stderr and ONE JSON line on stdout. Exits non-zero without a GPU.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import jax

from flipviscosity3d import FluidSimulation
from flipviscosity3d.config import PARTICLE_ENGINES
from flipviscosity3d.io.trianglemesh import box_mesh
from flipviscosity3d.utils import runtime

DT = 0.01
# The pool's peak cell occupancy outgrows 16 in frame 1 and 24 in frame 2
# (8 and 10 overflowed particle-passes on an H100, PERF.md); 32 holds it.
POOL_BUCKET_CAPACITY = 32


def build_pool(res: int = 128, engine: str = "table",
               viscosity: float = 5.0, **cfg_overrides) -> FluidSimulation:
    """The benchmark scene: a liquid pool filling the bottom ~27% of the
    open interior of a res^3 domain (~4.11M particles at 128^3)."""
    sim = FluidSimulation()
    cfg_overrides.setdefault("bucket_capacity", POOL_BUCKET_CAPACITY)
    sim.initialize(res, res, res, 1.0 / res, particle_engine=engine,
                   **cfg_overrides)
    lo = 2.5 / res
    sim.add_liquid(box_mesh((lo, lo, lo), (1.0 - lo, 0.285, 1.0 - lo)))
    sim.set_viscosity(viscosity)
    sim.set_gravity(0.0, -9.81, 0.0)
    return sim


def run(engine: str, res: int, frames: int) -> dict:
    sim = build_pool(res, engine)
    n_particles = sim.particle_positions.shape[0]
    print(f"# bench scene: {res}^3 grid, {n_particles} particles, "
          f"engine={engine}", file=sys.stderr, flush=True)

    t0 = time.perf_counter()
    int(sim.advance(DT).substeps)  # compile + first frame
    print(f"# compile+first frame {time.perf_counter() - t0:.1f} s",
          file=sys.stderr, flush=True)

    substeps = overflow = unconverged = 0
    t0 = time.perf_counter()
    for _ in range(frames):
        diag = sim.advance(DT)
        substeps += int(diag.substeps)  # host read: waits for the device
        overflow += int(diag.bucket_overflow)
        unconverged += int(diag.unconverged_solves)
    wall = time.perf_counter() - t0
    print(f"# substeps={substeps} bucket_overflow={overflow} "
          f"unconverged_solves={unconverged} last-frame iters: "
          f"pressure={int(diag.pressure_iterations)} "
          f"viscosity={int(diag.viscosity_iterations)}",
          file=sys.stderr, flush=True)
    return {
        "metric": f"sim substeps/sec, {res}^3 grid, {n_particles} "
                  f"particles, full pressure+viscosity, engine={engine}",
        "value": substeps / wall,
        "unit": "steps/s",
        "ms_per_frame": wall / frames * 1e3,
    }


def main():
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--engine", choices=PARTICLE_ENGINES, default="table")
    p.add_argument("--resolution", type=int, default=128)
    p.add_argument("--frames", type=int, default=5)
    args = p.parse_args()

    runtime.enable_compile_cache()
    devices = runtime.require_gpu(jax.devices())
    device = runtime.describe_devices(devices)
    print(f"# device: {device}", file=sys.stderr)
    print(f"# card: {runtime.card_info()}", file=sys.stderr, flush=True)

    result = run(args.engine, args.resolution, args.frames)
    result["device"] = device
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
