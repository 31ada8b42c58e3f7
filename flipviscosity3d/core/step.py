"""The FLIP substep and CFL-driven advance loop, fully jitted.

FluidSimulation::advance (/root/reference/src/fluidsimulation.cpp:135-168)
as one pure function `advance(state, dt, cfg)`: the CFL-substep while-loop,
the seven simulation stages, and both linear solves all run inside a single
XLA computation, so the host dispatches exactly once per frame.

Particle work runs on one of two engines (cfg.particle_engine):

- "table" (default): fixed-capacity bucket tables with dense per-slot
  transfers (ops/buckets.py, ops/particle_grid.py) — two table passes (A by
  position, B by RK2 midpoint) plus a gather-based pushback stage.
- "stream": ONE lax.sort per substep; liquid SDF + P2G as segmented scans
  over the sorted stream; G2P / RK2 stage 2 / solid pushback as row-gathers
  of stacked per-cell grid columns keyed by per-particle cell indices
  (ops/stream.py, ops/stream_transfers.py). No capacity limit, no overflow;
  the engine of the shard_map slab pipeline.

Each stage runs under a jax.named_scope ("p2g", "grid_update", "g2p", ...)
so a profiler trace attributes device time per stage.

Divergences from the reference, all documented where they occur:
- MIC(0) preconditioning -> Galerkin-aggregation multigrid / Jacobi
  (parallel), float64 -> float32 with a relative tolerance floor
- the reference applies solid pushback before the AABB clamp
  (fluidsimulation.cpp:322-337); we clamp, push back, and clamp again so the
  pushback's SDF sample is guaranteed home-cell aligned (differs only for
  particles that left the domain box in one substep)
- an overall substep-count cap (cfg.max_substeps) bounds the while loop
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import lax

from ..config import SimConfig
from ..ops import particle_grid as pg
from ..ops import stream_transfers as st
from ..ops.buckets import build_buckets, cell_of_position, gather_results
from ..ops.extrapolate import extrapolate_velocity_field
from ..ops.grids import (
    face_borders_fluid_u,
    face_borders_fluid_v,
    face_borders_fluid_w,
)
from ..ops.stream import stream_sort
from ..solvers import pressure as psolver
from ..solvers import viscosity as vsolver
from .state import SimState, StepDiagnostics

_P2G_EPS = 1e-9  # weight threshold (fluidsimulation.cpp:423-431)


def _clamp_bounds(cfg: SimConfig):
    """Particle containment box: domain AABB expanded by -2dx - 1e-4 (i.e.
    inset dx + 5e-5 per side, fluidsimulation.cpp:319-320, aabb.cpp:118-124)
    with the nearest-point clamp's 1e-6 pullback on the high side
    (aabb.cpp:217-234)."""
    lo = cfg.dx + 0.5e-4
    his = [
        cfg.isize * cfg.dx - cfg.dx - 0.5e-4 - 1e-6,
        cfg.jsize * cfg.dx - cfg.dx - 0.5e-4 - 1e-6,
        cfg.ksize * cfg.dx - cfg.dx - 0.5e-4 - 1e-6,
    ]
    return (
        jnp.array([lo, lo, lo], jnp.float32),
        jnp.array(his, jnp.float32),
    )


def _max_velocity(u, v, w):
    """CFL velocity magnitude (fluidsimulation.cpp:241-269): max component
    magnitude over all faces."""
    return jnp.maximum(
        jnp.max(jnp.abs(u)),
        jnp.maximum(jnp.max(jnp.abs(v)), jnp.max(jnp.abs(w))),
    )


def _grid_update(state: SimState, liquid_phi, p2g_sums, dt, cfg: SimConfig):
    """The grid-side pipeline between P2G and G2P: normalize the transfer,
    extrapolate, body force, viscosity, pressure projection, constrain
    (fluidsimulation.cpp:149-161). Engine-independent."""
    solid = state.solid
    fluid = liquid_phi < 0
    borders_u = face_borders_fluid_u(fluid)
    borders_v = face_borders_fluid_v(fluid)
    borders_w = face_borders_fluid_w(fluid)

    def combine(sums, borders):
        vsum, wsum = sums
        is_set = wsum >= _P2G_EPS
        vals = vsum / jnp.maximum(wsum, _P2G_EPS)
        mask = is_set & borders
        return jnp.where(mask, vals, 0.0), mask

    u, valid_u = combine(p2g_sums[0], borders_u)
    v, valid_v = combine(p2g_sums[1], borders_v)
    w, valid_w = combine(p2g_sums[2], borders_w)

    with jax.named_scope("extrapolate"):
        u, v, w, valid_u, valid_v, valid_w = extrapolate_velocity_field(
            u, v, w, valid_u, valid_v, valid_w, cfg.extrapolation_layers
        )
    saved_u, saved_v, saved_w = u, v, w  # FLIP delta baseline (":518")

    # body force on faces bordering fluid (fluidsimulation.cpp:271-312)
    u = jnp.where(borders_u, u + state.gravity[0] * dt, u)
    v = jnp.where(borders_v, v + state.gravity[1] * dt, v)
    w = jnp.where(borders_w, w + state.gravity[2] * dt, w)

    # viscosity (fluidsimulation.cpp:170-196), skipped when all zero
    states = vsolver.FaceStates(solid.solid_u, solid.solid_v, solid.solid_w)

    def visc_on(uvw):
        uu, vv, ww = uvw
        volumes = vsolver.compute_volume_grids(liquid_phi, cfg)
        sys = vsolver.build_viscosity_system(
            uu, vv, ww, volumes, states, state.viscosity, dt, cfg
        )
        result = vsolver.solve_viscosity(sys, cfg, warm_start=(uu, vv, ww))
        uu, vv, ww = vsolver.apply_viscosity_solution(uu, vv, ww, sys, result, cfg)
        return ((uu, vv, ww), result.iterations, result.residual,
                (~result.converged).astype(jnp.int32))

    def visc_off(uvw):
        return uvw, jnp.int32(0), jnp.float32(0.0), jnp.int32(0)

    with jax.named_scope("viscosity"):
        (u, v, w), visc_iters, visc_res, visc_unconv = lax.cond(
            jnp.any(state.viscosity > 0), visc_on, visc_off, (u, v, w)
        )

    # pressure projection (fluidsimulation.cpp:522-531)
    with jax.named_scope("pressure"):
        psys = psolver.build_pressure_system(
            u, v, w, liquid_phi, solid.weight_u, solid.weight_v,
            solid.weight_w, dt, cfg,
        )
        pres = psolver.solve_pressure(psys, cfg)
        u, v, w, valid_u, valid_v, valid_w = psolver.apply_pressure(
            u, v, w, pres.x, liquid_phi,
            solid.weight_u, solid.weight_v, solid.weight_w, dt, cfg,
        )
    with jax.named_scope("extrapolate"):
        u, v, w, valid_u, valid_v, valid_w = extrapolate_velocity_field(
            u, v, w, valid_u, valid_v, valid_w, cfg.extrapolation_layers
        )

    # constrain: zero both fields at fully-closed faces
    # (fluidsimulation.cpp:696-729)
    u = jnp.where(solid.weight_u == 0, 0.0, u)
    v = jnp.where(solid.weight_v == 0, 0.0, v)
    w = jnp.where(solid.weight_w == 0, 0.0, w)
    saved_u = jnp.where(solid.weight_u == 0, 0.0, saved_u)
    saved_v = jnp.where(solid.weight_v == 0, 0.0, saved_v)
    saved_w = jnp.where(solid.weight_w == 0, 0.0, saved_w)

    solver_diag = dict(
        pressure_iterations=pres.iterations,
        pressure_residual=pres.residual,
        viscosity_iterations=visc_iters,
        viscosity_residual=visc_res,
        liquid_cells=jnp.sum(fluid),
        unconverged_solves=visc_unconv
        + (~pres.converged).astype(jnp.int32),
    )
    return (u, v, w), (saved_u, saved_v, saved_w), fluid, solver_diag


def _step_stream(state: SimState, dt, cfg: SimConfig):
    """One CFL substep on the sorted-stream engine."""
    dx = cfg.dx
    shape = cfg.grid_shape
    solid = state.solid

    # ---------------- PASS A: the substep's one sort ----------------
    with jax.named_scope("sort"):
        stream = stream_sort(
            state.pos,
            (
                state.pos[:, 0], state.pos[:, 1], state.pos[:, 2],
                state.vel[:, 0], state.vel[:, 1], state.vel[:, 2],
            ),
            dx,
            shape,
        )
    spx, spy, spz = stream.sorted[0], stream.sorted[1], stream.sorted[2]
    svx, svy, svz = stream.sorted[3], stream.sorted[4], stream.sorted[5]

    with jax.named_scope("p2g_sdf"):
        liquid_phi, p2g_sums = st.p2g_sdf_stream(
            stream, shape, dx, cfg.particle_radius, solid.center_phi,
            (cfg.u_shape, cfg.v_shape, cfg.w_shape),
        )

    (u, v, w), (saved_u, saved_v, saved_w), fluid, solver_diag = _grid_update(
        state, liquid_phi, p2g_sums, dt, cfg
    )

    # ---------------- G2P + advection ----------------
    # PIC/FLIP velocity update (fluidsimulation.cpp:341-352); one row-gather
    # serves the new and FLIP-saved fields for all three components.
    with jax.named_scope("g2p"):
        (nu, ou), (nv, ov), (nw, ow) = st.sample_mac_at(
            spx, spy, spz, stream.key,
            [u, saved_u], [v, saved_v], [w, saved_w], dx, shape,
        )
        r = jnp.float32(cfg.ratio_pic_flip)
        vel_x = r * nu + (1.0 - r) * (svx + nu - ou)
        vel_y = r * nv + (1.0 - r) * (svy + nv - ov)
        vel_z = r * nw + (1.0 - r) * (svz + nw - ow)

    # RK2 stage 1: midpoint from the *grid* velocity at p
    # (fluidsimulation.cpp:535-541)
    mx = spx + 0.5 * dt * nu
    my = spy + 0.5 * dt * nv
    mz = spz + 0.5 * dt * nw

    # ---------------- stage 2 at the midpoints (no re-sort) ----------------
    with jax.named_scope("rk2_stage2"):
        key_m = cell_of_position(jnp.stack([mx, my, mz], axis=1), dx, shape)
        ext = jnp.array([shape[0] * dx, shape[1] * dx, shape[2] * dx], jnp.float32)
        inside_m = (
            (mx >= 0) & (mx < ext[0])
            & (my >= 0) & (my < ext[1])
            & (mz >= 0) & (mz < ext[2])
        )
        (v2x,), (v2y,), (v2z,) = st.sample_mac_at(
            mx, my, mz, key_m, [u], [v], [w], dx, shape, valid=inside_m,
        )
        npx = spx + dt * v2x
        npy = spy + dt * v2y
        npz = spz + dt * v2z

    # ---------------- clamp + solid pushback (no re-sort) ----------------
    with jax.named_scope("pushback"):
        lo, hi = _clamp_bounds(cfg)
        cpx = jnp.clip(npx, lo[0], hi[0])
        cpy = jnp.clip(npy, lo[1], hi[1])
        cpz = jnp.clip(npz, lo[2], hi[2])
        key_c = cell_of_position(jnp.stack([cpx, cpy, cpz], axis=1), dx, shape)
        dpx, dpy, dpz = st.solid_pushback_at(
            cpx, cpy, cpz, key_c, solid.phi, dx, shape
        )
        fx = jnp.clip(cpx + dpx, lo[0], hi[0])
        fy = jnp.clip(cpy + dpy, lo[1], hi[1])
        fz = jnp.clip(cpz + dpz, lo[2], hi[2])

    new_pos = jnp.stack([fx, fy, fz], axis=1)
    new_vel = jnp.stack([vel_x, vel_y, vel_z], axis=1)

    new_state = state._replace(pos=new_pos, vel=new_vel, u=u, v=v, w=w)
    diag = dict(bucket_overflow=jnp.int32(0), **solver_diag)
    return new_state, diag


def _step_table(state: SimState, dt, cfg: SimConfig):
    """One CFL substep on the round-1 bucket-table engine (three passes)."""
    dx = cfg.dx
    shape = cfg.grid_shape
    solid = state.solid

    # ---------------- PASS A: bucket by position ----------------
    with jax.named_scope("bucket_a"):
        table_a = build_buckets(
            state.pos,
            (
                state.pos[:, 0], state.pos[:, 1], state.pos[:, 2],
                state.vel[:, 0], state.vel[:, 1], state.vel[:, 2],
            ),
            dx,
            shape,
            cfg.bucket_capacity,
        )

    # liquid SDF + P2G transfer, fused over one sweep of the 27 cell offsets
    # (fluidsimulation.cpp:354-362 and :364-519)
    with jax.named_scope("p2g_sdf"):
        liquid_phi, p2g_sums = pg.p2g_and_sdf(
            table_a, shape, dx, cfg.particle_radius, solid.center_phi,
            (cfg.u_shape, cfg.v_shape, cfg.w_shape),
        )

    (u, v, w), (saved_u, saved_v, saved_w), fluid, solver_diag = _grid_update(
        state, liquid_phi, p2g_sums, dt, cfg
    )

    # ---------------- G2P + advection ----------------
    # PIC/FLIP velocity update (fluidsimulation.cpp:341-352); particle
    # positions are unchanged since pass A, so its tables are still aligned.
    with jax.named_scope("g2p"):
        new_u_t, new_v_t, new_w_t = pg.sample_mac_at_table(
            table_a, u, v, w, dx
        )
        old_u_t, old_v_t, old_w_t = pg.sample_mac_at_table(
            table_a, saved_u, saved_v, saved_w, dx
        )

    r = jnp.float32(cfg.ratio_pic_flip)
    pvx, pvy, pvz = table_a.fields[3], table_a.fields[4], table_a.fields[5]
    vel_x = r * new_u_t + (1.0 - r) * (pvx + new_u_t - old_u_t)
    vel_y = r * new_v_t + (1.0 - r) * (pvy + new_v_t - old_v_t)
    vel_z = r * new_w_t + (1.0 - r) * (pvz + new_w_t - old_w_t)

    # RK2 stage 1: midpoint from the *grid* velocity at p
    # (fluidsimulation.cpp:535-541)
    px_t, py_t, pz_t = table_a.fields[0], table_a.fields[1], table_a.fields[2]
    mx = px_t + 0.5 * dt * new_u_t
    my = py_t + 0.5 * dt * new_v_t
    mz = pz_t + 0.5 * dt * new_w_t

    with jax.named_scope("gather_a"):
        spx, spy, spz, svx, svy, svz = table_a.sorted
        flat = gather_results(
            table_a,
            (vel_x, vel_y, vel_z, mx, my, mz),
            fallbacks=(
                svx, svy, svz,
                spx + 0.5 * dt * svx,
                spy + 0.5 * dt * svy,
                spz + 0.5 * dt * svz,
            ),
        )
        fvel_x, fvel_y, fvel_z, fmx, fmy, fmz = flat

    # ---------------- PASS B: bucket by midpoint ----------------
    # Only the midpoints enter the dense tables (sampling needs home-cell
    # aligned positions); the original positions and stage-1 velocities ride
    # the sort and the advection add happens on the flat sorted arrays after
    # the gather — 3 fewer (capacity, n_cells) scatters per substep.
    with jax.named_scope("bucket_b"):
        fm = jnp.stack([fmx, fmy, fmz], axis=1)
        table_b = build_buckets(
            fm,
            (fmx, fmy, fmz, spx, spy, spz, fvel_x, fvel_y, fvel_z),
            dx,
            shape,
            cfg.bucket_capacity,
            n_table_fields=3,
        )

    bmx, bmy, bmz = table_b.fields[0], table_b.fields[1], table_b.fields[2]
    with jax.named_scope("rk2_stage2"):
        ext = jnp.array(
            [shape[0] * dx, shape[1] * dx, shape[2] * dx], jnp.float32
        )
        inside_m = (
            (bmx >= 0) & (bmx < ext[0])
            & (bmy >= 0) & (bmy < ext[1])
            & (bmz >= 0) & (bmz < ext[2])
        )
        v2x, v2y, v2z = pg.sample_mac_at_table(table_b, u, v, w, dx, inside_m)

        sbmx, sbmy, sbmz, sbpx, sbpy, sbpz, sbvx, sbvy, sbvz = table_b.sorted
        # stage-2 velocity per particle; overflow falls back to the particle's
        # own (ballistic) velocity, reproducing new_p = p + dt * v
        fv2x, fv2y, fv2z = gather_results(
            table_b, (v2x, v2y, v2z), fallbacks=(sbvx, sbvy, sbvz)
        )
        fnpx = sbpx + dt * fv2x
        fnpy = sbpy + dt * fv2y
        fnpz = sbpz + dt * fv2z

    # ---------------- clamp + solid pushback (no third bucket pass) ------
    # The pushback's 8 trilinear corners are exactly the clamped position's
    # home-cell nodes, so ONE (N, 8) row-gather of the node SDF keyed by the
    # home cell replaces a third table build (a full sort + 3 table
    # scatters); every particle participates (no overflow fallback on this
    # stage).
    with jax.named_scope("pushback"):
        lo, hi = _clamp_bounds(cfg)
        cpx = jnp.clip(fnpx, lo[0], hi[0])
        cpy = jnp.clip(fnpy, lo[1], hi[1])
        cpz = jnp.clip(fnpz, lo[2], hi[2])
        key_c = cell_of_position(
            jnp.stack([cpx, cpy, cpz], axis=1), dx, shape
        )
        dpx, dpy, dpz = st.solid_pushback_at(
            cpx, cpy, cpz, key_c, solid.phi, dx, shape
        )
        fx = jnp.clip(cpx + dpx, lo[0], hi[0])
        fy = jnp.clip(cpy + dpy, lo[1], hi[1])
        fz = jnp.clip(cpz + dpz, lo[2], hi[2])

    new_pos = jnp.stack([fx, fy, fz], axis=1)
    new_vel = jnp.stack([sbvx, sbvy, sbvz], axis=1)

    new_state = state._replace(pos=new_pos, vel=new_vel, u=u, v=v, w=w)
    diag = dict(
        bucket_overflow=table_a.n_overflow + table_b.n_overflow,
        **solver_diag,
    )
    return new_state, diag


def step(state: SimState, dt, cfg: SimConfig):
    """One CFL substep (the body of the reference's advance loop,
    fluidsimulation.cpp:144-166). Returns (state, diagnostics pieces).
    SimConfig admits only the two engines below."""
    if cfg.particle_engine == "stream":
        return _step_stream(state, dt, cfg)
    return _step_table(state, dt, cfg)


@functools.partial(jax.jit, static_argnames=("cfg",))
def advance(state: SimState, dt, cfg: SimConfig):
    """Advance the simulation by a frame of length dt with CFL substeps
    (fluidsimulation.cpp:135-168). Returns (state, StepDiagnostics)."""
    dt = jnp.asarray(dt, jnp.float32)

    zero_diag = StepDiagnostics(
        substeps=jnp.int32(0),
        pressure_iterations=jnp.int32(0),
        pressure_residual=jnp.float32(0),
        viscosity_iterations=jnp.int32(0),
        viscosity_residual=jnp.float32(0),
        max_velocity=jnp.float32(0),
        bucket_overflow=jnp.int32(0),
        liquid_cells=jnp.int32(0),
        unconverged_solves=jnp.int32(0),
    )

    def cond(carry):
        t, _, n, _ = carry
        return (t < dt) & (n < cfg.max_substeps)

    def body(carry):
        t, st_, n, diag = carry
        maxvel = _max_velocity(st_.u, st_.v, st_.w)
        cfl = jnp.where(
            maxvel > 0,
            jnp.float32(cfg.cfl_number * cfg.dx) / maxvel,
            jnp.float32(jnp.inf),
        )
        substep = jnp.minimum(cfl, dt - t)
        st_, d = step(st_, substep, cfg)
        diag = StepDiagnostics(
            substeps=diag.substeps + 1,
            pressure_iterations=diag.pressure_iterations
            + d["pressure_iterations"],
            pressure_residual=d["pressure_residual"],
            viscosity_iterations=diag.viscosity_iterations
            + d["viscosity_iterations"],
            viscosity_residual=d["viscosity_residual"],
            max_velocity=jnp.maximum(diag.max_velocity, maxvel),
            bucket_overflow=diag.bucket_overflow + d["bucket_overflow"],
            liquid_cells=d["liquid_cells"].astype(jnp.int32),
            unconverged_solves=diag.unconverged_solves
            + d["unconverged_solves"],
        )
        return t + substep, st_, n + 1, diag

    _, state, _, diag = lax.while_loop(
        cond, body, (jnp.float32(0.0), state, jnp.int32(0), zero_diag)
    )
    return state, diag
