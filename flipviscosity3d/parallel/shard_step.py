"""shard_map substep: explicit i-axis slab decomposition of the whole FLIP
pipeline with halo exchange and owner-based particle migration.

This is the explicit-collectives upgrade over the pjit auto-SPMD path
(parallel/sharding.py): grids are stored as per-shard slabs, particles as
per-shard fixed-capacity arrays owned by the shard whose i-slab contains
their home cell, and every collective is a visible lax.ppermute / psum:

- halo exchange (parallel/halo.py) before shifted reads: stencil matvecs,
  extrapolation layers, particle sampling windows;
- halo reduce after scatter-shaped accumulation: P2G sums, particle-SDF
  mins fold onto the owning shard;
- psum/pmax inside CG (solvers/pcg.py reduce_mask + axis_name): iteration
  counts and residuals match the single-device solve exactly (same global
  reductions, up to float reduction order);
- ppermute fixed-capacity migration buffers move particles whose advected
  home cell left the slab (at most one shard per substep: CFL displacement
  <= cfl_number cells << slab width).

Layout invariants:
- every cell-extent array holds rows [s*B - H, s*B + B + H) of the global
  i-axis (B = I / n_shards, H = halo width); node-extent arrays hold one
  extra row.
- the staggered u grid is stored CROPPED to I rows (the global last face
  row I is dropped): that face is forced solid by the domain boundary and
  every pipeline output there is zero (weights are 0, it is never a
  viscosity/pressure row, P2G cannot reach it because particles are clamped
  2dx inside). Cropping makes u slabs shaped exactly like cell slabs, so
  one halo/ownership scheme covers everything and no face is double-counted
  in reductions.

The reference is single-threaded (SURVEY.md §2); this component is
blueprint-defined. Validated by tests/test_shard_step.py: equality with the
single-device engine on the forced multi-device CPU mesh.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..config import SimConfig
from ..core.state import SimState, StepDiagnostics
from ..ops import stream_transfers as st
from ..ops.extrapolate import extrapolate_grid
from ..ops.grids import face_borders_fluid_v, face_borders_fluid_w
from ..ops.levelset import fraction_inside
from ..ops.stream import stream_sort_keys
from ..solvers import pressure as psolver
from ..solvers import viscosity as vsolver
from ..solvers.pcg import jacobi_preconditioner, pcg
from . import halo

AXIS = "x"


class ShardedSim(NamedTuple):
    """Per-shard state; every array leads with the shard axis (n, ...)."""

    pos: jnp.ndarray        # (n, cap, 3)
    vel: jnp.ndarray        # (n, cap, 3)
    alive: jnp.ndarray      # (n, cap) bool
    u: jnp.ndarray          # (n, B+2H, J, K)   cropped faces
    v: jnp.ndarray          # (n, B+2H, J+1, K)
    w: jnp.ndarray          # (n, B+2H, J, K+1)
    # static geometry slabs
    solid_center: jnp.ndarray   # (n, B+2H, J, K)
    solid_phi: jnp.ndarray      # (n, B+2H+1, J+1, K+1)
    weight_u: jnp.ndarray       # cropped faces, like u
    weight_v: jnp.ndarray
    weight_w: jnp.ndarray
    solid_u: jnp.ndarray        # bool face states, like u/v/w
    solid_v: jnp.ndarray
    solid_w: jnp.ndarray
    viscosity: jnp.ndarray      # (n, B+2H+1, J+1, K+1)
    gravity: jnp.ndarray        # (3,)


class SlabSpec(NamedTuple):
    n: int
    B: int
    H: int
    cap: int      # particles per shard
    mig: int      # migration buffer capacity per direction


def make_spec(cfg: SimConfig, n: int, halo_width: int = 6,
              cap_factor: float = 2.0, n_particles: int = 0,
              mig: int | None = None) -> SlabSpec:
    """`mig` overrides the per-direction migration-buffer rows (default
    max(256, per_shard/4)); size it above the worst per-substep face
    crossing of the scene — overflow drops particles (counted in
    bucket_overflow), it never corrupts stayers."""
    if cfg.isize % n:
        raise ValueError(f"isize {cfg.isize} not divisible by {n} shards")
    B = cfg.isize // n
    if B < halo_width:
        raise ValueError(f"slab width {B} < halo {halo_width}")
    if B <= cfg.cfl_number:
        raise ValueError(
            f"slab width {B} <= CFL {cfg.cfl_number}: migration assumes "
            "at most one-shard moves per substep"
        )
    if halo_width < cfg.cfl_number + 1:
        raise ValueError(
            f"halo width {halo_width} < cfl_number + 1 "
            f"({cfg.cfl_number + 1:g}): advected/midpoint positions could "
            "leave the slab halo and the RK2/pushback stencils would "
            "silently sample clamped (wrong) cells"
        )
    per = int(np.ceil(n_particles / n))
    if mig is None:
        mig = max(256, per // 4)
    cap = int(np.ceil(per * cap_factor / 8) * 8) + 2 * mig
    return SlabSpec(n, B, int(halo_width), cap, int(mig))


# --------------------------------------------------------------------------
# setup: global state -> slabs (host side)
# --------------------------------------------------------------------------

def _slab_rows(g: np.ndarray, spec: SlabSpec, node: bool, fill) -> np.ndarray:
    """(n, B+2H(+1), ...) slabs of a global cell/node-extent array."""
    H, B, n = spec.H, spec.B, spec.n
    pad = np.full((H,) + g.shape[1:], fill, g.dtype)
    padded = np.concatenate([pad, np.asarray(g), pad], axis=0)
    rows = B + 2 * H + (1 if node else 0)
    return np.stack([padded[s * B : s * B + rows] for s in range(n)])


def _crop_u(a):
    return np.asarray(a)[:-1]


def shard_simstate(state: SimState, cfg: SimConfig, spec: SlabSpec,
                   mesh: Mesh) -> ShardedSim:
    """Distribute a global SimState into per-shard slabs + particle arrays,
    placed on the mesh (shard axis split, gravity replicated): the layout
    advance_sharded returns, so a frame fed its own output does not
    recompile."""
    pos = np.asarray(state.pos)
    vel = np.asarray(state.vel)
    owner = np.clip(
        (np.floor(pos[:, 0] / cfg.dx).astype(np.int64) // spec.B),
        0, spec.n - 1,
    )
    ppos = np.zeros((spec.n, spec.cap, 3), np.float32)
    pvel = np.zeros((spec.n, spec.cap, 3), np.float32)
    alive = np.zeros((spec.n, spec.cap), bool)
    for s in range(spec.n):
        idx = np.nonzero(owner == s)[0]
        if len(idx) > spec.cap:
            raise ValueError(
                f"shard {s} seeded {len(idx)} > capacity {spec.cap}"
            )
        ppos[s, : len(idx)] = pos[idx]
        pvel[s, : len(idx)] = vel[idx]
        alive[s, : len(idx)] = True

    solid = state.solid
    put = lambda a: jax.device_put(a, NamedSharding(mesh, P(AXIS)))
    cell = lambda g, fill=0.0: _slab_rows(np.asarray(g), spec, False, fill)
    node = lambda g, fill=0.0: _slab_rows(np.asarray(g), spec, True, fill)
    face_u = lambda g, fill=0.0: _slab_rows(_crop_u(g), spec, False, fill)

    return ShardedSim(
        pos=put(ppos),
        vel=put(pvel),
        alive=put(alive),
        u=put(face_u(state.u)),
        v=put(cell(state.v)),
        w=put(cell(state.w)),
        solid_center=put(cell(solid.center_phi, fill=1.0)),
        solid_phi=put(node(solid.phi, fill=1.0)),
        weight_u=put(face_u(solid.weight_u)),
        weight_v=put(cell(solid.weight_v)),
        weight_w=put(cell(solid.weight_w)),
        solid_u=put(face_u(solid.solid_u, fill=True)),
        solid_v=put(cell(solid.solid_v, fill=True)),
        solid_w=put(cell(solid.solid_w, fill=True)),
        viscosity=put(node(state.viscosity)),
        gravity=jax.device_put(state.gravity, NamedSharding(mesh, P())),
    )


def gather_particles(ss: ShardedSim):
    """(N, 3) positions and velocities of all alive particles (host)."""
    alive = np.asarray(ss.alive).reshape(-1)
    pos = np.asarray(ss.pos).reshape(-1, 3)[alive]
    vel = np.asarray(ss.vel).reshape(-1, 3)[alive]
    return pos, vel


def gather_grid_u(ss: ShardedSim, spec: SlabSpec):
    """Reassemble the global (I+1, J, K) u grid (cropped face row -> 0)."""
    H = spec.H
    owned = np.asarray(ss.u)[:, H : H + spec.B]
    full = owned.reshape(-1, *owned.shape[2:])
    last = np.zeros((1,) + full.shape[1:], full.dtype)
    return np.concatenate([full, last], axis=0)


def gather_grid_cell(a, spec: SlabSpec):
    H = spec.H
    owned = np.asarray(a)[:, H : H + spec.B]
    return owned.reshape(-1, *owned.shape[2:])


# --------------------------------------------------------------------------
# slab-local masks
# --------------------------------------------------------------------------

def _i_global(rows: int, spec: SlabSpec):
    s = lax.axis_index(AXIS)
    r = jax.lax.broadcasted_iota(jnp.int32, (rows, 1, 1), 0)
    return s * spec.B - spec.H + r  # (rows,1,1) global i per local row


def _owned_rows(rows: int, spec: SlabSpec, dtype=jnp.float32):
    r = jax.lax.broadcasted_iota(jnp.int32, (rows, 1, 1), 0)
    return ((r >= spec.H) & (r < spec.H + spec.B)).astype(dtype)


def _i_range_mask(rows: int, lo: int, hi: int, spec: SlabSpec):
    """lo <= global_i < hi as a (rows,1,1) bool."""
    g = _i_global(rows, spec)
    return (g >= lo) & (g < hi)


def _jk_range_mask(shape, lo, hi):
    j = jax.lax.broadcasted_iota(jnp.int32, shape, 1)
    k = jax.lax.broadcasted_iota(jnp.int32, shape, 2)
    return (j >= lo[0]) & (j < hi[0]) & (k >= lo[1]) & (k < hi[1])


# --------------------------------------------------------------------------
# the slab substep
# --------------------------------------------------------------------------

def _local_keys(px, py, pz, alive, dx, local_shape):
    """Flat local cell key per particle from SLAB-LOCAL coordinates; dead ->
    n_cells (sorts last, belongs to no run)."""
    li = jnp.floor(px / dx).astype(jnp.int32)
    lj = jnp.floor(py / dx).astype(jnp.int32)
    lk = jnp.floor(pz / dx).astype(jnp.int32)
    dims = jnp.array(local_shape, jnp.int32)
    li = jnp.clip(li, 0, dims[0] - 1)
    lj = jnp.clip(lj, 0, dims[1] - 1)
    lk = jnp.clip(lk, 0, dims[2] - 1)
    key = (li * local_shape[1] + lj) * local_shape[2] + lk
    n_cells = local_shape[0] * local_shape[1] * local_shape[2]
    return jnp.where(alive, key, n_cells)


def _exchange(x, spec: SlabSpec, fill=0.0):
    return halo.halo_exchange(x, AXIS, spec.H, fill=fill)


def _substep(ss_pos, ss_vel, ss_alive, u, v, w, static, dt, cfg: SimConfig,
             spec: SlabSpec):
    """One CFL substep on local slabs. All arrays are shard-local (no
    leading shard axis). Returns updated particle arrays, grids, diag."""
    (solid_center, solid_phi, weight_u, weight_v, weight_w,
     solid_u, solid_v, solid_w, viscosity, gravity) = static
    dx = cfg.dx
    H, B = spec.H, spec.B
    local_shape = (B + 2 * H, cfg.jsize, cfg.ksize)
    face_shapes = (local_shape,
                   (local_shape[0], cfg.jsize + 1, cfg.ksize),
                   (local_shape[0], cfg.jsize, cfg.ksize + 1))
    n_cells = local_shape[0] * local_shape[1] * local_shape[2]

    # The particle pipeline runs in SLAB-LOCAL coordinates: x shifted by the
    # slab origin so local cell indices, decoded home cells, and trilinear
    # fractions are all consistent with the local slabs (the stream-transfer
    # kernels derive home positions from decoded keys). y/z are global.
    s_idx = lax.axis_index(AXIS)
    x_origin = (s_idx * spec.B - H).astype(jnp.float32) * jnp.float32(dx)

    px = ss_pos[:, 0] - x_origin
    py, pz = ss_pos[:, 1], ss_pos[:, 2]
    vx, vy, vz = ss_vel[:, 0], ss_vel[:, 1], ss_vel[:, 2]
    alive = ss_alive
    alive_f = alive.astype(jnp.float32)

    # ---------------- pass A ----------------
    # The slab pipeline always runs the stream engine shard-locally (one
    # local sort + segmented-scan transfers), whatever cfg.particle_engine
    # names for the single-device path.
    max_dist = jnp.float32(3.0 * dx)
    keys = _local_keys(px, py, pz, alive, dx, local_shape)
    stream = stream_sort_keys(keys, (px, py, pz, vx, vy, vz, alive_f),
                              local_shape)
    spx, spy, spz = stream.sorted[0], stream.sorted[1], stream.sorted[2]
    svx, svy, svz = stream.sorted[3], stream.sorted[4], stream.sorted[5]
    salive = stream.sorted[6] > 0.5

    liquid_phi, p2g_sums = st.p2g_sdf_stream(
        stream, local_shape, dx, cfg.particle_radius, solid_center,
        face_shapes, finalize=False,
    )
    # fold scatter-shaped halo contributions onto owners, refresh halos
    liquid_phi = halo.halo_reduce(liquid_phi, AXIS, H, op="min",
                                  reset=max_dist)
    liquid_phi = _exchange(liquid_phi, spec, fill=max_dist)
    p2g_sums = [
        tuple(
            _exchange(halo.halo_reduce(g, AXIS, H, op="sum"), spec)
            for g in pair
        )
        for pair in p2g_sums
    ]
    liquid_phi = st.extrapolate_sdf_into_solid(liquid_phi, solid_center, dx)
    fluid = liquid_phi < 0

    # ---------------- grid update ----------------
    rows = local_shape[0]
    # face-borders-fluid; u is cropped so its rows align with cells
    borders_u = fluid | jnp.concatenate(
        [jnp.zeros((1,) + fluid.shape[1:], bool), fluid[:-1]], axis=0
    )
    borders_v = face_borders_fluid_v(fluid)
    borders_w = face_borders_fluid_w(fluid)

    def combine(sums, borders):
        vsum, wsum = sums
        is_set = wsum >= 1e-9
        vals = vsum / jnp.maximum(wsum, 1e-9)
        mask = is_set & borders
        return jnp.where(mask, vals, 0.0), mask

    u_new, valid_u = combine(p2g_sums[0], borders_u)
    v_new, valid_v = combine(p2g_sums[1], borders_v)
    w_new, valid_w = combine(p2g_sums[2], borders_w)

    # extrapolation with global-aware interior + per-layer halo refresh
    def interior_for(shape, iglobal_hi):
        im = _i_range_mask(shape[0], 1, iglobal_hi, spec)
        jm = _jk_range_mask(shape, (1, 1), (shape[1] - 1, shape[2] - 1))
        return im & jm

    def extrap(g, vmask, iglobal_hi):
        shape = g.shape
        interior = interior_for(shape, iglobal_hi)

        def ex(gg, vv):
            return (_exchange(gg, spec),
                    _exchange(vv.astype(jnp.float32), spec) > 0.5)

        g2, v2 = extrapolate_grid(g, vmask, cfg.extrapolation_layers,
                                  interior=interior, exchange=ex)
        return _exchange(g2, spec), _exchange(
            v2.astype(jnp.float32), spec) > 0.5

    # interior i-ranges: u faces [1, I) (cropped), v/w cells [1, I-1)
    I = cfg.isize
    u_new, valid_u = extrap(u_new, valid_u, I)
    v_new, valid_v = extrap(v_new, valid_v, I - 1)
    w_new, valid_w = extrap(w_new, valid_w, I - 1)
    saved_u, saved_v, saved_w = u_new, v_new, w_new  # FLIP baseline (":518")

    # gravity on faces bordering fluid (fluidsimulation.cpp:271-312)
    u_new = jnp.where(borders_u, u_new + gravity[0] * dt, u_new)
    v_new = jnp.where(borders_v, v_new + gravity[1] * dt, v_new)
    w_new = jnp.where(borders_w, w_new + gravity[2] * dt, w_new)

    # ---------------- viscosity ----------------
    states = vsolver.FaceStates(solid_u, solid_v, solid_w)
    owned_u = _owned_rows(u_new.shape[0], spec) * jnp.ones_like(u_new)
    owned_v = _owned_rows(v_new.shape[0], spec) * jnp.ones_like(v_new)
    owned_w = _owned_rows(w_new.shape[0], spec) * jnp.ones_like(w_new)

    def visc_on(uvw):
        uu, vv, ww = uvw
        volumes = vsolver.compute_volume_grids(liquid_phi, cfg)
        # reference row ranges: i,j,k in [1, size) on each face grid
        row_masks = (
            _i_range_mask(uu.shape[0], 1, I, spec)
            & _jk_range_mask(uu.shape, (1, 1), (cfg.jsize, cfg.ksize)),
            _i_range_mask(vv.shape[0], 1, I, spec)
            & _jk_range_mask(vv.shape, (1, 1), (cfg.jsize, cfg.ksize)),
            _i_range_mask(ww.shape[0], 1, I, spec)
            & _jk_range_mask(ww.shape, (1, 1), (cfg.jsize, cfg.ksize)),
        )
        vsys = vsolver.build_viscosity_system(
            uu, vv, ww, volumes, states, viscosity, dt, cfg,
            row_masks=row_masks,
        )
        warm = tuple(
            jnp.where(m, g, 0.0) for m, g in zip(vsys.in_mat, (uu, vv, ww))
        )
        bnorm = jnp.max(jnp.stack([
            jnp.max(jnp.abs(r) * m)
            for r, m in zip(vsys.rhs, (owned_u, owned_v, owned_w))
        ]))
        bnorm = lax.pmax(bnorm, AXIS)
        tol = jnp.float32(cfg.viscosity_solve_rtol) * bnorm

        def apply_A(x):
            xs = tuple(_exchange(xi, spec) for xi in x)
            return vsolver.apply_viscosity_matrix(vsys, xs, cfg)

        if cfg.viscosity_preconditioner == "multigrid":
            from .slab_mg import slab_viscosity_mg_preconditioner

            precon = slab_viscosity_mg_preconditioner(vsys, spec, cfg, AXIS)
        else:
            precon = jacobi_preconditioner(vsys.diag)
        result = pcg(
            apply_A, vsys.rhs, precon, tol,
            cfg.viscosity_solve_max_iterations, x0=warm,
            axis_name=AXIS,
            reduce_mask=(owned_u, owned_v, owned_w),
        )
        ok = result.converged | (result.residual
                                 < cfg.viscosity_acceptable_error)
        xu, xv, xw = result.x
        uu = jnp.where(ok, jnp.where(vsys.in_mat[0], xu, 0.0), uu)
        vv = jnp.where(ok, jnp.where(vsys.in_mat[1], xv, 0.0), vv)
        ww = jnp.where(ok, jnp.where(vsys.in_mat[2], xw, 0.0), ww)
        return ((_exchange(uu, spec), _exchange(vv, spec),
                 _exchange(ww, spec)),
                result.iterations, result.residual,
                (~result.converged).astype(jnp.int32))

    def visc_off(uvw):
        return uvw, jnp.int32(0), jnp.float32(0.0), jnp.int32(0)

    # predicate must be shard-uniform (collectives inside the branch)
    has_visc = lax.pmax(jnp.max(viscosity), AXIS) > 0
    (u_new, v_new, w_new), visc_iters, visc_res, visc_unconv = lax.cond(
        has_visc, visc_on, visc_off, (u_new, v_new, w_new)
    )

    # ---------------- pressure ----------------
    interior_p = (
        _i_range_mask(rows, 1, I - 1, spec)
        & _jk_range_mask(local_shape, (1, 1),
                         (cfg.jsize - 1, cfg.ksize - 1))
    )
    # build needs a (rows+1)-style weight_u; cropped weights align directly
    psys = _build_pressure_slab(
        u_new, v_new, w_new, liquid_phi, weight_u, weight_v, weight_w,
        dt, cfg, interior_p,
    )
    owned_c = _owned_rows(rows, spec) * jnp.ones_like(liquid_phi)
    bnorm = lax.pmax(jnp.max(jnp.abs(psys.b) * owned_c), AXIS)
    ptol = jnp.maximum(
        jnp.float32(cfg.pressure_solve_tolerance),
        jnp.float32(cfg.pressure_solve_rtol) * bnorm,
    )
    if cfg.pressure_preconditioner == "multigrid":
        from .slab_mg import slab_pressure_mg_preconditioner

        p_precon = slab_pressure_mg_preconditioner(psys, spec, cfg, AXIS)
    else:
        p_precon = jacobi_preconditioner(psys.diag)
    pres = pcg(
        lambda x: psolver.apply_pressure_matrix(
            psys, _exchange(x, spec)),
        psys.b,
        p_precon,
        ptol,
        cfg.pressure_solve_max_iterations,
        axis_name=AXIS,
        reduce_mask=owned_c,
    )
    pressure = _exchange(pres.x, spec)

    u_new, v_new, w_new, valid_u, valid_v, valid_w = _apply_pressure_slab(
        u_new, v_new, w_new, pressure, liquid_phi, weight_u, weight_v,
        weight_w, dt, cfg, spec,
    )

    u_new, valid_u = extrap(u_new, valid_u, I)
    v_new, valid_v = extrap(v_new, valid_v, I - 1)
    w_new, valid_w = extrap(w_new, valid_w, I - 1)

    # constrain (fluidsimulation.cpp:696-729), both fields
    u_new = jnp.where(weight_u == 0, 0.0, u_new)
    v_new = jnp.where(weight_v == 0, 0.0, v_new)
    w_new = jnp.where(weight_w == 0, 0.0, w_new)
    saved_u = jnp.where(weight_u == 0, 0.0, saved_u)
    saved_v = jnp.where(weight_v == 0, 0.0, saved_v)
    saved_w = jnp.where(weight_w == 0, 0.0, saved_w)

    # ---------------- G2P + advection ----------------
    (nu, ou), (nv, ov), (nw, ow) = st.sample_mac_at(
        spx, spy, spz, stream.key,
        [u_new, saved_u], [v_new, saved_v], [w_new, saved_w], dx,
        local_shape,
    )
    r = jnp.float32(cfg.ratio_pic_flip)
    vel_x = r * nu + (1.0 - r) * (svx + nu - ou)
    vel_y = r * nv + (1.0 - r) * (svy + nv - ov)
    vel_z = r * nw + (1.0 - r) * (svz + nw - ow)

    mx = spx + 0.5 * dt * nu
    my = spy + 0.5 * dt * nv
    mz = spz + 0.5 * dt * nw
    ext = jnp.array(
        [cfg.isize * dx, cfg.jsize * dx, cfg.ksize * dx], jnp.float32
    )
    inside_m = (
        (mx + x_origin >= 0) & (mx + x_origin < ext[0])
        & (my >= 0) & (my < ext[1])
        & (mz >= 0) & (mz < ext[2])
    )
    key_m = _local_keys(mx, my, mz, salive, dx, local_shape)
    (v2x,), (v2y,), (v2z,) = st.sample_mac_at(
        mx, my, mz, key_m, [u_new], [v_new], [w_new], dx, local_shape,
        valid=inside_m,
    )
    npx = spx + dt * v2x
    npy = spy + dt * v2y
    npz = spz + dt * v2z

    from ..core.step import _clamp_bounds

    lo, hi = _clamp_bounds(cfg)
    cpx = jnp.clip(npx, lo[0] - x_origin, hi[0] - x_origin)
    cpy = jnp.clip(npy, lo[1], hi[1])
    cpz = jnp.clip(npz, lo[2], hi[2])
    key_c = _local_keys(cpx, cpy, cpz, salive, dx, local_shape)
    dpx, dpy, dpz = st.solid_pushback_at(
        cpx, cpy, cpz, key_c, solid_phi, dx, local_shape
    )
    fx = jnp.clip(cpx + dpx, lo[0] - x_origin, hi[0] - x_origin)
    fy = jnp.clip(cpy + dpy, lo[1], hi[1])
    fz = jnp.clip(cpz + dpz, lo[2], hi[2])

    # ---------------- migration (positions back in GLOBAL frame) --------
    new_pos, new_vel, new_alive, n_lost = _migrate(
        fx + x_origin, fy, fz, vel_x, vel_y, vel_z, salive, dx, spec
    )

    fluid_owned = jnp.sum(
        (fluid & (_owned_rows(rows, spec) > 0)).astype(jnp.int32)
    )
    diag = dict(
        pressure_iterations=pres.iterations,
        pressure_residual=pres.residual,
        viscosity_iterations=visc_iters,
        viscosity_residual=visc_res,
        liquid_cells=lax.psum(fluid_owned, AXIS),
        # particles dropped by full migration buffers
        bucket_overflow=lax.psum(n_lost, AXIS),
        # CG convergence is decided on pmax'd residuals: shard-uniform
        unconverged_solves=visc_unconv
        + (~pres.converged).astype(jnp.int32),
    )
    return new_pos, new_vel, new_alive, u_new, v_new, w_new, diag


def _build_pressure_slab(u, v, w, liquid_phi, weight_u, weight_v, weight_w,
                         dt, cfg, interior):
    """build_pressure_system with cropped-u slabs: the global function
    expects (I+1) u rows; on slabs u/weight_u have cell-extent rows, and
    face i+1 of cell r is face row r+1 == the next cell row. Recreate the
    divergence and face specs with cropped reads."""
    shape = liquid_phi.shape
    fluid = (liquid_phi < 0) & interior
    fluid_f = fluid.astype(jnp.float32)

    def up_u(a):  # value at face i+1 of cell r  == row r+1 (cropped)
        return jnp.concatenate([a[1:], jnp.zeros_like(a[:1])], axis=0)

    div = (
        weight_u * u - up_u(weight_u) * up_u(u)
        + weight_v[:, :-1] * v[:, :-1] - weight_v[:, 1:] * v[:, 1:]
        + weight_w[:, :, :-1] * w[:, :, :-1]
        - weight_w[:, :, 1:] * w[:, :, 1:]
    ) / cfg.dx
    b = div * fluid_f

    scale = jnp.float32(dt / (cfg.dx * cfg.dx))
    fw_u, fw_v, fw_w = _liquid_face_weights_slab(liquid_phi)
    # clamp AFTER any shift: a zero-filled shifted theta would divide to inf
    # on the outermost halo row and inf*0 masking turns into NaN
    th = lambda f: jnp.maximum(f, cfg.minfrac)
    theta_u = th(fw_u)
    theta_v = th(fw_v)
    theta_w = th(fw_w)

    from ..ops.grids import shifted_read

    diag = jnp.zeros(shape, jnp.float32)
    plus = {}
    specs = [
        (0, +1, up_u(weight_u), th(up_u(fw_u))),
        (0, -1, weight_u, theta_u),
        (1, +1, weight_v[:, 1:], theta_v[:, 1:]),
        (1, -1, weight_v[:, :-1], theta_v[:, :-1]),
        (2, +1, weight_w[:, :, 1:], theta_w[:, :, 1:]),
        (2, -1, weight_w[:, :, :-1], theta_w[:, :, :-1]),
    ]
    for axis, sign, wgt, theta in specs:
        off = [0, 0, 0]
        off[axis] = sign
        nphi = shifted_read(liquid_phi, tuple(off), shape, fill=jnp.inf)
        term = wgt * scale
        nb_fluid = nphi < 0
        diag = diag + jnp.where(nb_fluid, term, term / theta) * fluid_f
        if sign == +1:
            plus[axis] = jnp.where(nb_fluid & fluid, -term, 0.0)
    return psolver.PressureSystem(
        fluid, diag, plus[0], plus[1], plus[2], b, theta_u, theta_v, theta_w
    )


def _liquid_face_weights_slab(liquid_phi):
    """liquid_face_weights with cropped-u rows: fw_u row r = fraction at the
    face between cells r-1 and r (global-boundary faces masked by the
    solvers' row ranges, so the edge fill is never read)."""
    fw_u = fraction_inside(
        jnp.concatenate([liquid_phi[:1], liquid_phi[:-1]], axis=0),
        liquid_phi,
    )
    zero_v = jnp.zeros(
        (liquid_phi.shape[0], 1, liquid_phi.shape[2]), liquid_phi.dtype
    )
    fw_v = jnp.concatenate(
        [zero_v, fraction_inside(liquid_phi[:, :-1], liquid_phi[:, 1:]),
         zero_v], axis=1,
    )
    zero_w = jnp.zeros(liquid_phi.shape[:2] + (1,), liquid_phi.dtype)
    fw_w = jnp.concatenate(
        [zero_w, fraction_inside(liquid_phi[:, :, :-1],
                                 liquid_phi[:, :, 1:]), zero_w], axis=2,
    )
    return fw_u, fw_v, fw_w


def _apply_pressure_slab(u, v, w, pressure, liquid_phi, weight_u, weight_v,
                         weight_w, dt, cfg, spec: SlabSpec):
    """apply_pressure with cropped-u slabs and global-aware interiors."""
    dx = cfg.dx
    I = cfg.isize
    fluid = liquid_phi < 0
    fw_u, fw_v, fw_w = _liquid_face_weights_slab(liquid_phi)

    borders_u = fluid | jnp.concatenate(
        [jnp.zeros((1,) + fluid.shape[1:], bool), fluid[:-1]], axis=0
    )
    iu = _i_range_mask(u.shape[0], 1, I, spec)
    theta = jnp.maximum(fw_u, cfg.minfrac)
    grad = pressure - jnp.concatenate(
        [pressure[:1], pressure[:-1]], axis=0
    )
    mask_u = iu & (weight_u > 0) & borders_u
    u_new = jnp.where(mask_u, u - dt * grad / (dx * theta), 0.0)

    borders_v = face_borders_fluid_v(fluid)
    jv = _jk_range_mask(v.shape, (1, 0), (cfg.jsize, cfg.ksize + 1))
    theta = jnp.maximum(fw_v, cfg.minfrac)
    grad = jnp.zeros(v.shape, jnp.float32)
    grad = grad.at[:, 1:-1].set(pressure[:, 1:] - pressure[:, :-1])
    mask_v = jv & (weight_v > 0) & borders_v
    v_new = jnp.where(mask_v, v - dt * grad / (dx * theta), 0.0)

    borders_w = face_borders_fluid_w(fluid)
    jw = _jk_range_mask(w.shape, (0, 1), (cfg.jsize + 1, cfg.ksize))
    theta = jnp.maximum(fw_w, cfg.minfrac)
    grad = jnp.zeros(w.shape, jnp.float32)
    grad = grad.at[:, :, 1:-1].set(
        pressure[:, :, 1:] - pressure[:, :, :-1]
    )
    mask_w = jw & (weight_w > 0) & borders_w
    w_new = jnp.where(mask_w, w - dt * grad / (dx * theta), 0.0)

    return u_new, v_new, w_new, mask_u, mask_v, mask_w


def _migrate(px, py, pz, vx, vy, vz, alive, dx, spec: SlabSpec):
    """Owner-based particle exchange: ship particles whose home cell moved
    to a neighbor slab via fixed-capacity ppermute buffers."""
    s = lax.axis_index(AXIS)
    gi = jnp.floor(px / dx).astype(jnp.int32)
    owner = jnp.clip(gi // spec.B, 0, spec.n - 1)
    shift = jnp.clip(owner - s, -1, 1)
    # categories: 0 left, 1 stay, 2 right, 3 dead
    cat = jnp.where(alive, shift + 1, 3).astype(jnp.int32)
    n = px.shape[0]
    cat_s, spx, spy, spz, svx, svy, svz = lax.sort(
        (cat, px, py, pz, vx, vy, vz), num_keys=1, is_stable=True
    )
    nL = jnp.sum((cat_s == 0).astype(jnp.int32))
    nS = jnp.sum((cat_s == 1).astype(jnp.int32))
    nR = jnp.sum((cat_s == 2).astype(jnp.int32))
    M = spec.mig

    fields = jnp.stack([spx, spy, spz, svx, svy, svz], axis=1)  # (n, 6)

    def window(start, count):
        # (M, 6) rows [start, start+M) with validity i < count
        padded = jnp.concatenate([fields, jnp.zeros((M, 6), fields.dtype)])
        win = lax.dynamic_slice_in_dim(padded, start, M, axis=0)
        valid = (
            jax.lax.broadcasted_iota(jnp.int32, (M, 1), 0)[:, 0]
            < jnp.minimum(count, M)
        )
        return win, valid

    left_buf, left_valid = window(jnp.int32(0), nL)
    right_buf, right_valid = window(nL + nS, nR)
    n_lost = jnp.maximum(nL - M, 0) + jnp.maximum(nR - M, 0)

    perm_l = [(i, i - 1) for i in range(1, spec.n)]
    perm_r = [(i, i + 1) for i in range(spec.n - 1)]
    from_right_buf = lax.ppermute(left_buf, AXIS, perm_l)
    from_right_valid = lax.ppermute(
        left_valid.astype(jnp.int32), AXIS, perm_l) > 0
    from_left_buf = lax.ppermute(right_buf, AXIS, perm_r)
    from_left_valid = lax.ppermute(
        right_valid.astype(jnp.int32), AXIS, perm_r) > 0

    # compact stayers to the front: rotate the sorted arrays left by nL
    doubled = jnp.concatenate([fields, fields], axis=0)
    stay = lax.dynamic_slice_in_dim(doubled, nL, n, axis=0)
    idx = jax.lax.broadcasted_iota(jnp.int32, (n, 1), 0)[:, 0]
    stay_alive = idx < nS

    # place arrivals into the dead region [nS, nS+2M). The write happens on a
    # 2M-row padded copy so dynamic_update_slice never clamps the start index
    # when a skewed scene fills the shard (nS > n - 2M): excess arrival rows
    # land in the padding and are dropped (counted in n_lost) instead of
    # silently overwriting live stayer rows.
    arrivals = jnp.concatenate([from_left_buf, from_right_buf], axis=0)
    arr_valid = jnp.concatenate([from_left_valid, from_right_valid])
    stay_padded = jnp.concatenate([stay, jnp.zeros((2 * M, 6), stay.dtype)])
    out = lax.dynamic_update_slice_in_dim(stay_padded, arrivals, nS, axis=0)[:n]
    arr_alive = (idx >= nS) & (idx < nS + 2 * M)
    arr_idx = jnp.clip(idx - nS, 0, 2 * M - 1)
    alive_out = jnp.where(
        arr_alive, jnp.take(arr_valid, arr_idx), stay_alive
    )
    arr_slot = jax.lax.broadcasted_iota(jnp.int32, (2 * M, 1), 0)[:, 0]
    n_dropped = jnp.sum((arr_valid & (nS + arr_slot >= n)).astype(jnp.int32))
    new_pos = out[:, :3]
    new_vel = out[:, 3:]
    return new_pos, new_vel, alive_out, n_lost + n_dropped


# --------------------------------------------------------------------------
# frame advance under shard_map
# --------------------------------------------------------------------------

def _advance_local(pos, vel, alive, u, v, w, static, dt, cfg: SimConfig,
                   spec: SlabSpec):
    owned_u = _owned_rows(u.shape[0], spec)
    zero_diag = StepDiagnostics(
        substeps=jnp.int32(0),
        pressure_iterations=jnp.int32(0),
        pressure_residual=jnp.float32(0.0),
        viscosity_iterations=jnp.int32(0),
        viscosity_residual=jnp.float32(0.0),
        max_velocity=jnp.float32(0.0),
        bucket_overflow=jnp.int32(0),
        liquid_cells=jnp.int32(0),
        unconverged_solves=jnp.int32(0),
    )

    def maxvel(u, v, w):
        m = jnp.max(jnp.stack([
            jnp.max(jnp.abs(u) * owned_u),
            jnp.max(jnp.abs(v) * _owned_rows(v.shape[0], spec)),
            jnp.max(jnp.abs(w) * _owned_rows(w.shape[0], spec)),
        ]))
        return lax.pmax(m, AXIS)

    def cond(carry):
        t, *_rest, nsub, _diag = carry
        return (t < dt) & (nsub < cfg.max_substeps)

    def body(carry):
        t, pos, vel, alive, u, v, w, nsub, diag = carry
        mv = maxvel(u, v, w)
        cfl = jnp.where(
            mv > 0,
            jnp.float32(cfg.cfl_number * cfg.dx) / mv,
            jnp.float32(jnp.inf),
        )
        substep = jnp.minimum(cfl, dt - t)
        pos, vel, alive, u, v, w, d = _substep(
            pos, vel, alive, u, v, w, static, substep, cfg, spec
        )
        diag = StepDiagnostics(
            substeps=diag.substeps + 1,
            pressure_iterations=diag.pressure_iterations
            + d["pressure_iterations"],
            pressure_residual=d["pressure_residual"],
            viscosity_iterations=diag.viscosity_iterations
            + d["viscosity_iterations"],
            viscosity_residual=d["viscosity_residual"],
            max_velocity=jnp.maximum(diag.max_velocity, mv),
            bucket_overflow=diag.bucket_overflow + d["bucket_overflow"],
            liquid_cells=d["liquid_cells"],
            unconverged_solves=diag.unconverged_solves
            + d["unconverged_solves"],
        )
        return t + substep, pos, vel, alive, u, v, w, nsub + 1, diag

    carry = (jnp.float32(0.0), pos, vel, alive, u, v, w, jnp.int32(0),
             zero_diag)
    carry = lax.while_loop(cond, body, carry)
    _, pos, vel, alive, u, v, w, _, diag = carry
    return pos, vel, alive, u, v, w, diag


@functools.partial(jax.jit, static_argnames=("cfg", "spec", "mesh"))
def advance_sharded(ss: ShardedSim, dt, cfg: SimConfig, spec: SlabSpec,
                    mesh: Mesh):
    """One frame of CFL substeps over the slab decomposition. Diagnostics
    are already psum'd (identical on every shard)."""

    def local(pos, vel, alive, u, v, w, solid_center, solid_phi, weight_u,
              weight_v, weight_w, solid_u, solid_v, solid_w, viscosity,
              gravity, dt):
        sq = lambda a: a[0]
        static = (
            sq(solid_center), sq(solid_phi), sq(weight_u), sq(weight_v),
            sq(weight_w), sq(solid_u), sq(solid_v), sq(solid_w),
            sq(viscosity), gravity,
        )
        pos, vel, alive, u, v, w, diag = _advance_local(
            sq(pos), sq(vel), sq(alive), sq(u), sq(v), sq(w), static, dt,
            cfg, spec,
        )
        exp = lambda a: a[None]
        return (exp(pos), exp(vel), exp(alive), exp(u), exp(v), exp(w),
                diag)

    sharded = P(AXIS)
    rep = P()
    from jax import shard_map

    out = shard_map(
        local,
        mesh=mesh,
        in_specs=(sharded,) * 15 + (rep, rep),
        out_specs=((sharded,) * 6
                   + (jax.tree.map(lambda _: rep, StepDiagnostics(
                       *([0] * len(StepDiagnostics._fields)))),)),
    )(
        ss.pos, ss.vel, ss.alive, ss.u, ss.v, ss.w,
        ss.solid_center, ss.solid_phi, ss.weight_u, ss.weight_v,
        ss.weight_w, ss.solid_u, ss.solid_v, ss.solid_w, ss.viscosity,
        ss.gravity, jnp.float32(dt),
    )
    pos, vel, alive, u, v, w, diag = out
    new_ss = ss._replace(pos=pos, vel=vel, alive=alive, u=u, v=v, w=w)
    return new_ss, diag
