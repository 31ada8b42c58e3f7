#!/usr/bin/env python
"""Time the pressure and viscosity CG solves in isolation on a realistic
mid-simulation state, across preconditioner configurations.

Builds the bench pool scene, advances a few frames, reconstructs the two
linear systems exactly as core/step.py does (pass-A buckets -> liquid SDF /
P2G), then times jitted solve-only functions.

Env: RES (64), WARM_FRAMES (2), VISCOSITY (5.0)
"""

from __future__ import annotations

import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax
import jax.numpy as jnp

import dataclasses

from flipviscosity3d import FluidSimulation
from flipviscosity3d.io.trianglemesh import box_mesh
from flipviscosity3d.ops import particle_grid as pg
from flipviscosity3d.ops.buckets import build_buckets
from flipviscosity3d.ops.extrapolate import extrapolate_velocity_field
from flipviscosity3d.ops.grids import (
    face_borders_fluid_u, face_borders_fluid_v, face_borders_fluid_w,
)
from flipviscosity3d.solvers import pressure as psolver
from flipviscosity3d.solvers import viscosity as vsolver
from flipviscosity3d.utils.runtime import enable_compile_cache

enable_compile_cache()

RES = int(os.environ.get("RES", "64"))
WARM = int(os.environ.get("WARM_FRAMES", "2"))
VISC = float(os.environ.get("VISCOSITY", "5.0"))
DT = 0.01


def build_state():
    sim = FluidSimulation()
    cap = int(os.environ.get("BUCKET_CAPACITY", "16" if RES >= 128 else "24"))
    sim.initialize(RES, RES, RES, 1.0 / RES, bucket_capacity=cap)
    lo = 2.5 / RES
    sim.add_liquid(box_mesh((lo, lo, lo), (1.0 - lo, 0.285, 1.0 - lo)))
    sim.set_viscosity(VISC)
    sim.set_gravity(0.0, -9.81, 0.0)
    for _ in range(WARM):
        d = sim.advance(DT)
    _ = int(d.substeps)
    return sim


def build_systems(sim):
    """Replicates core/step.py pass A + system assembly."""
    cfg = sim.cfg
    state = sim.state
    solid = state.solid
    dx = cfg.dx
    shape = cfg.grid_shape

    @jax.jit
    def assemble(state):
        table_a = build_buckets(
            state.pos,
            (state.pos[:, 0], state.pos[:, 1], state.pos[:, 2],
             state.vel[:, 0], state.vel[:, 1], state.vel[:, 2]),
            dx, shape, cfg.bucket_capacity,
        )
        liquid_phi, p2g_sums = pg.p2g_and_sdf(
            table_a, shape, dx, cfg.particle_radius, solid.center_phi,
            (cfg.u_shape, cfg.v_shape, cfg.w_shape),
        )
        fluid = liquid_phi < 0
        bu, bv, bw = (face_borders_fluid_u(fluid),
                      face_borders_fluid_v(fluid),
                      face_borders_fluid_w(fluid))

        def combine(sums, borders):
            vsum, wsum = sums
            is_set = wsum >= 1e-9
            vals = vsum / jnp.maximum(wsum, 1e-9)
            mask = is_set & borders
            return jnp.where(mask, vals, 0.0), mask

        u, vu = combine(p2g_sums[0], bu)
        v, vv = combine(p2g_sums[1], bv)
        w, vw = combine(p2g_sums[2], bw)
        u, v, w, vu, vv, vw = extrapolate_velocity_field(
            u, v, w, vu, vv, vw, cfg.extrapolation_layers
        )
        u = jnp.where(bu, u + state.gravity[0] * DT, u)
        v = jnp.where(bv, v + state.gravity[1] * DT, v)
        w = jnp.where(bw, w + state.gravity[2] * DT, w)

        states = vsolver.FaceStates(solid.solid_u, solid.solid_v, solid.solid_w)
        volumes = vsolver.compute_volume_grids(liquid_phi, cfg)
        vsys = vsolver.build_viscosity_system(
            u, v, w, volumes, states, state.viscosity, DT, cfg
        )
        psys = psolver.build_pressure_system(
            u, v, w, liquid_phi, solid.weight_u, solid.weight_v,
            solid.weight_w, DT, cfg,
        )
        return vsys, psys, (u, v, w)

    return assemble(state)


def timeit(name, fn, *args, n=5):
    r = fn(*args)
    jax.tree.leaves(r)[0].ravel()[0].item()
    t0 = time.perf_counter()
    for _ in range(n):
        r = fn(*args)
        jax.tree.leaves(r)[0].ravel()[0].item()
    dt = (time.perf_counter() - t0) / n * 1e3
    return dt, r


def main():
    sim = build_state()
    vsys, psys, uvw = build_systems(sim)
    base_cfg = sim.cfg
    print(f"# {RES}^3 systems ready; rows p={int(jnp.sum(psys.fluid))} "
          f"v={sum(int(jnp.sum(m)) for m in vsys.in_mat)}", flush=True)

    variants = [
        ("jacobi", dict(viscosity_preconditioner="jacobi",
                        pressure_preconditioner="jacobi")),
        ("mg batched L-auto", dict()),
        ("mg batched L4", dict(mg_max_levels=4)),
        ("mg batched L3", dict(mg_max_levels=3)),
    ]
    extra = os.environ.get("VARIANT")
    if extra:
        kv = dict(p.split("=") for p in extra.split(","))
        variants = [(extra, {
            k: (float(v) if "." in v else int(v)) if k.startswith("mg_") else v
            for k, v in kv.items()})]

    for name, ov in variants:
        cfg = dataclasses.replace(base_cfg, **ov)

        @jax.jit
        def solve_p(psys):
            return psolver.solve_pressure(psys, cfg)

        @jax.jit
        def solve_v(vsys, uvw):
            return vsolver.solve_viscosity(vsys, cfg, warm_start=uvw)

        tp, rp = timeit(f"p {name}", solve_p, psys)
        tv, rv = timeit(f"v {name}", solve_v, vsys, uvw)
        print(
            f"{name:22s} pressure {tp:8.1f} ms / {int(rp.iterations):4d} it "
            f"({tp / max(int(rp.iterations), 1):6.2f} ms/it)   "
            f"viscosity {tv:8.1f} ms / {int(rv.iterations):4d} it "
            f"({tv / max(int(rv.iterations), 1):6.2f} ms/it)",
            flush=True,
        )


if __name__ == "__main__":
    main()
