"""Particle<->grid transfers over the sorted stream (no tables).

Reproduces exactly the semantics of ops/particle_grid.py (which operates on
dense bucket tables) with per-particle arrays + segment reductions:

- liquid SDF from particle spheres over the 3x3x3 window
  (/root/reference/src/particlelevelset.cpp:98-139)
- P2G with the Wyvill kernel, weight-normalized
  (/root/reference/src/fluidsimulation.cpp:364-438)
- trilinear MAC sampling with half-dx transverse shifts, out-of-domain -> 0
  (/root/reference/src/macvelocityfield.cpp:455-578)
- solid SDF pushback along the interpolated gradient
  (/root/reference/src/fluidsimulation.cpp:326-333, interpolation.cpp:122-184)
"""

from __future__ import annotations

import itertools

import jax.numpy as jnp

from .grids import shifted_read
from .stream import ParticleStream, decode_cells, rows_at_cells, segment_reduce

_MAC_OFFSETS = {
    "u": (0.0, 0.5, 0.5),
    "v": (0.5, 0.0, 0.5),
    "w": (0.5, 0.5, 0.0),
}

_COMP_AXIS = {"u": 0, "v": 1, "w": 2}


def _windows(component):
    ax = _COMP_AXIS[component]
    return [(0, 1) if a == ax else (-1, 0, 1) for a in range(3)]


def _wyvill_weight(d2, dx):
    """Wyvill kernel (fluidsimulation.cpp:385-413), zero at and beyond r=dx."""
    r2 = jnp.float32(dx * dx)
    c1 = jnp.float32((4.0 / 9.0) / dx**6)
    c2 = jnp.float32((17.0 / 9.0) / dx**4)
    c3 = jnp.float32((22.0 / 9.0) / dx**2)
    w = 1.0 - c1 * d2 * d2 * d2 + c2 * d2 * d2 - c3 * d2
    return jnp.where(d2 < r2, w, 0.0)


def extrapolate_sdf_into_solid(phi, solid_center_phi, dx):
    """Set phi = -0.5dx in near-surface solid cells
    (particlelevelset.cpp:127-139). Split out so the shard_map pipeline can
    halo-fold the raw per-cell mins before this elementwise pass."""
    return jnp.where(
        (phi < 0.5 * dx) & (solid_center_phi < 0), -0.5 * jnp.float32(dx), phi
    )


def p2g_sdf_stream(stream: ParticleStream, grid_shape, dx, radius,
                   solid_center_phi, face_shapes, finalize=True):
    """Fused pass-A transfer: liquid SDF + all three P2G components.

    Builds per-particle quantities for every cell offset (27 SDF distances,
    12 offsets x (weight, weight*velocity) per component), reduces them all
    with ONE segmented-scan pair + ONE row-gather (ops/stream.segment_reduce),
    then places the per-cell results with static shifted accumulation exactly
    like the table engine did.

    Returns (phi, [(val_sum, w_sum) per component]).
    """
    px, py, pz = stream.sorted[0], stream.sorted[1], stream.sorted[2]
    vels = (stream.sorted[3], stream.sorted[4], stream.sorted[5])
    hi, hj, hk = decode_cells(stream.key, grid_shape)
    hx = hi.astype(jnp.float32) * dx
    hy = hj.astype(jnp.float32) * dx
    hz = hk.astype(jnp.float32) * dx
    max_dist = jnp.float32(3.0 * dx)

    offsets = list(itertools.product((-1, 0, 1), repeat=3))
    mins = []
    sums = []
    sum_layout = []  # (comp_index, offset) per (w, wv) pair
    for o in offsets:
        dxp = hx + (o[0] + 0.5) * dx - px
        dyp = hy + (o[1] + 0.5) * dx - py
        dzp = hz + (o[2] + 0.5) * dx - pz
        mins.append(jnp.sqrt(dxp * dxp + dyp * dyp + dzp * dzp) - radius)
        for ci, comp in enumerate("uvw"):
            if o[_COMP_AXIS[comp]] not in (0, 1):
                continue
            off = _MAC_OFFSETS[comp]
            fx = hx + o[0] * dx - (px - off[0] * dx)
            fy = hy + o[1] * dx - (py - off[1] * dx)
            fz = hz + o[2] * dx - (pz - off[2] * dx)
            w = _wyvill_weight(fx * fx + fy * fy + fz * fz, dx)
            sums.append(w)
            sums.append(w * vels[ci])
            sum_layout.append((ci, o))

    sum_cells, min_cells = segment_reduce(stream, sums, mins, max_dist)

    phi = jnp.full(grid_shape, max_dist, jnp.float32)
    for o, m in zip(offsets, min_cells):
        neg = tuple(-v for v in o)
        phi = jnp.minimum(
            phi,
            shifted_read(m.reshape(grid_shape), neg, grid_shape,
                         fill=jnp.inf),
        )
    if finalize:
        phi = extrapolate_sdf_into_solid(phi, solid_center_phi, dx)

    acc = {
        c: (jnp.zeros(fs, jnp.float32), jnp.zeros(fs, jnp.float32))
        for c, fs in zip("uvw", face_shapes)
    }
    for idx, (ci, o) in enumerate(sum_layout):
        comp = "uvw"[ci]
        fs = face_shapes[ci]
        neg = tuple(-v for v in o)
        ws = sum_cells[2 * idx].reshape(grid_shape)
        wv = sum_cells[2 * idx + 1].reshape(grid_shape)
        vs_, ss_ = acc[comp]
        acc[comp] = (
            vs_ + shifted_read(wv, neg, fs),
            ss_ + shifted_read(ws, neg, fs),
        )
    return phi, [acc[c] for c in "uvw"]


def sample_mac_at(px, py, pz, keys, grids_u, grids_v, grids_w, dx,
                  grid_shape, valid=None):
    """Trilinear MAC samples of several grids at per-particle positions.

    grids_u/v/w: lists of same-component grids sharing trilinear weights
    (e.g. the new and FLIP-saved velocity fields). All per-cell columns for
    every (component, grid, offset) stack into ONE row-gather indexed by each
    particle's cell, then combine with per-particle weights.

    Returns (samples_u, samples_v, samples_w): lists of (N,) arrays matching
    the input grid lists. `valid` masks samples to 0 (out-of-domain -> 0,
    macvelocityfield.cpp:353-378 silent zero reads).
    """
    comp_grids = {"u": grids_u, "v": grids_v, "w": grids_w}
    columns = []
    layout = {}
    for comp in "uvw":
        for gi, grid in enumerate(comp_grids[comp]):
            for o in itertools.product(*_windows(comp)):
                layout[(comp, gi, o)] = len(columns)
                columns.append(shifted_read(grid, o, grid_shape).reshape(-1))
    vals = rows_at_cells(columns, keys)

    hi, hj, hk = decode_cells(keys, grid_shape)
    home = (hi, hj, hk)
    ps = (px, py, pz)

    outs = {"u": [], "v": [], "w": []}
    for comp in "uvw":
        off = _MAC_OFFSETS[comp]
        fs, deltas = [], []
        for ax in range(3):
            f = ps[ax] / dx - off[ax]
            b = jnp.floor(f)
            fs.append(f - b)
            deltas.append(b.astype(jnp.int32) - home[ax])
        for gi in range(len(comp_grids[comp])):
            out = jnp.zeros_like(px)
            for o in itertools.product(*_windows(comp)):
                w = jnp.ones_like(px)
                for ax in range(3):
                    corner = o[ax] - deltas[ax]
                    w = w * jnp.where(
                        corner == 0,
                        1.0 - fs[ax],
                        jnp.where(corner == 1, fs[ax], 0.0),
                    )
                out = out + w * vals[layout[(comp, gi, o)]]
            if valid is not None:
                out = jnp.where(valid, out, 0.0)
            outs[comp].append(out)
    return outs["u"], outs["v"], outs["w"]


NODE_CORNERS = tuple(itertools.product((0, 1), repeat=3))


def solid_pushback_at(px, py, pz, keys, phi_node, dx, grid_shape):
    """Per-particle displacement projecting penetrating particles out of
    solids (fluidsimulation.cpp:326-333): if phi<0, p -= phi*normalize(grad),
    with trilinear phi and gradient (interpolation.cpp:122-184).

    Positions must lie inside the domain (keys == floor(p/dx)), so the 8
    trilinear corners are exactly the home cell's nodes (+{0,1}^3), fetched
    as one 8-column row-gather of the node grid."""
    columns = [
        shifted_read(phi_node, o, grid_shape).reshape(-1)
        for o in NODE_CORNERS
    ]
    c = dict(zip(NODE_CORNERS, rows_at_cells(columns, keys)))
    hi, hj, hk = decode_cells(keys, grid_shape)
    tx = px / dx - hi.astype(jnp.float32)
    ty = py / dx - hj.astype(jnp.float32)
    tz = pz / dx - hk.astype(jnp.float32)

    def lerp(a, b, t):
        return (1.0 - t) * a + t * b

    def bilerp(v00, v10, v01, v11, s, t):
        return lerp(lerp(v00, v10, s), lerp(v01, v11, s), t)

    phi = lerp(
        bilerp(c[0, 0, 0], c[0, 1, 0], c[0, 0, 1], c[0, 1, 1], ty, tz),
        bilerp(c[1, 0, 0], c[1, 1, 0], c[1, 0, 1], c[1, 1, 1], ty, tz),
        tx,
    )
    gx = bilerp(
        c[1, 0, 0] - c[0, 0, 0], c[1, 1, 0] - c[0, 1, 0],
        c[1, 0, 1] - c[0, 0, 1], c[1, 1, 1] - c[0, 1, 1], ty, tz,
    )
    gy = bilerp(
        c[0, 1, 0] - c[0, 0, 0], c[1, 1, 0] - c[1, 0, 0],
        c[0, 1, 1] - c[0, 0, 1], c[1, 1, 1] - c[1, 0, 1], tx, tz,
    )
    gz = bilerp(
        c[0, 0, 1] - c[0, 0, 0], c[1, 0, 1] - c[1, 0, 0],
        c[0, 1, 1] - c[0, 1, 0], c[1, 1, 1] - c[1, 1, 0], tx, ty,
    )
    len2 = gx * gx + gy * gy + gz * gz
    inv = jnp.where(len2 > 0, 1.0 / jnp.sqrt(jnp.maximum(len2, 1e-30)), 1.0)
    scale = jnp.where(phi < 0, -phi * inv, 0.0)
    return scale * gx, scale * gy, scale * gz
