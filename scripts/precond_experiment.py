#!/usr/bin/env python
"""Compare CG preconditioners (Jacobi vs Galerkin-aggregation multigrid) on
the bench-style free-surface viscous pool scene.

Runs a few frames per configuration and reports per-substep CG iteration
counts for both solvers plus wall time. Env knobs:
  RES (default 64), FRAMES (3), VISCOSITY (5.0),
  MG_PRE, MG_POST, MG_COARSE_ITERS, MG_OMEGA, MG_COARSE_SCALE, MG_MAX_LEVELS
  MODES (comma list of jacobi,multigrid,mixed)
"""

from __future__ import annotations

import dataclasses
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax

from flipviscosity3d import FluidSimulation
from flipviscosity3d.io.trianglemesh import box_mesh
from flipviscosity3d.utils.runtime import enable_compile_cache

enable_compile_cache()

RES = int(os.environ.get("RES", "64"))
FRAMES = int(os.environ.get("FRAMES", "3"))
VISC = float(os.environ.get("VISCOSITY", "5.0"))
DT = 0.01


def make_sim(**cfg_overrides):
    sim = FluidSimulation()
    sim.initialize(RES, RES, RES, 1.0 / RES, **cfg_overrides)
    lo = 2.5 / RES
    pool = box_mesh((lo, lo, lo), (1.0 - lo, 0.285, 1.0 - lo))
    sim.add_liquid(pool)
    sim.set_viscosity(VISC)
    sim.set_gravity(0.0, -9.81, 0.0)
    return sim


def run(name, **cfg_overrides):
    sim = make_sim(**cfg_overrides)
    d = sim.advance(DT)
    _ = int(d.substeps)  # sync after compile
    tot_sub = tot_p = tot_v = 0
    t0 = time.perf_counter()
    for _ in range(FRAMES):
        d = sim.advance(DT)
        tot_sub += int(d.substeps)
        tot_p += int(d.pressure_iterations)
        tot_v += int(d.viscosity_iterations)
    wall = time.perf_counter() - t0
    print(
        f"{name:30s} substeps={tot_sub:3d} "
        f"p_iters/sub={tot_p / max(tot_sub,1):7.1f} "
        f"v_iters/sub={tot_v / max(tot_sub,1):7.1f} "
        f"wall={wall:7.2f}s  ({tot_sub / wall:6.2f} steps/s)",
        flush=True,
    )


def mg_overrides():
    ov = {}
    for env, field in [
        ("MG_PRE", "mg_pre_smooth"),
        ("MG_POST", "mg_post_smooth"),
        ("MG_COARSE_SIZE", "mg_coarse_size"),
        ("MG_MAX_LEVELS", "mg_max_levels"),
    ]:
        if os.environ.get(env):
            ov[field] = int(os.environ[env])
    for env, field in [
        ("MG_OMEGA", "mg_omega"),
        ("MG_COARSE_SCALE", "mg_coarse_scale"),
    ]:
        if os.environ.get(env):
            ov[field] = float(os.environ[env])
    return ov


def main():
    print(f"# scene: {RES}^3 pool, viscosity {VISC}, {FRAMES} frames")
    modes = os.environ.get("MODES", "jacobi,multigrid").split(",")
    for mode in modes:
        if mode == "jacobi":
            run(
                "jacobi/jacobi",
                viscosity_preconditioner="jacobi",
                pressure_preconditioner="jacobi",
            )
        elif mode == "multigrid":
            ov = mg_overrides()
            tag = ",".join(f"{k.split('_')[-1]}={v}" for k, v in ov.items())
            run(
                f"mg/mg {tag}",
                viscosity_preconditioner="multigrid",
                pressure_preconditioner="multigrid",
                **ov,
            )
        elif mode == "mixed":
            run(
                "jacobi-p/mg-v",
                viscosity_preconditioner="multigrid",
                pressure_preconditioner="jacobi",
                **mg_overrides(),
            )


if __name__ == "__main__":
    main()
