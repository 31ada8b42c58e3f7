"""Dense bucketed particle<->grid transfer kernels.

All functions operate on a BucketTable (capacity, n_cells) layout and express
the reference's per-particle scatter/gather loops as dense per-offset
reductions plus static shifted slices (no gathers or scatters in any inner
loop).

Reference semantics reproduced:
- liquid SDF from particle spheres over the 3x3x3 window
  (/root/reference/src/particlelevelset.cpp:98-139)
- P2G velocity transfer with the Wyvill kernel, weight-normalized
  (/root/reference/src/fluidsimulation.cpp:364-438); the kernel radius r=dx
  makes only the 2^3 faces around floor((p-offset)/dx) receive nonzero
  weight, so the per-axis stencil relative to the home cell is {0,1} on the
  component axis and {-1,0,1} transverse
- trilinear MAC sampling with half-dx transverse shifts and out-of-domain -> 0
  (/root/reference/src/macvelocityfield.cpp:455-578)
- solid SDF pushback along the interpolated gradient
  (/root/reference/src/fluidsimulation.cpp:326-333,
  interpolation.cpp:122-184)
"""

from __future__ import annotations

import itertools

import jax.numpy as jnp

from .buckets import BucketTable, cell_coords
from .grids import shifted_read

_MAC_OFFSETS = {
    "u": (0.0, 0.5, 0.5),
    "v": (0.5, 0.0, 0.5),
    "w": (0.5, 0.5, 0.0),
}


def _component_windows(component):
    """Per-axis face-offset windows relative to the home cell."""
    comp_axis = {"u": 0, "v": 1, "w": 2}[component]
    return [
        (0, 1) if ax == comp_axis else (-1, 0, 1) for ax in range(3)
    ], comp_axis


def liquid_sdf_from_particles(table: BucketTable, grid_shape, dx, radius,
                              solid_center_phi):
    """Cell-centered liquid SDF (particlelevelset.cpp:77-139).

    phi(c) = min(3dx, min over particles in the 3x3x3 cell window of
    |center(c) - p| - radius), then phi = -dx/2 inside solids near the
    surface.
    """
    px, py, pz = table.fields[0], table.fields[1], table.fields[2]
    coords = cell_coords(grid_shape).astype(jnp.float32)
    max_dist = jnp.float32(3.0 * dx)

    # One pass over the (capacity, n_cells) tables: squared distances from
    # each source cell's own particles to ALL 27 neighbor centers reduce in
    # a single fused min (the 27-lane broadcast never materializes — XLA
    # fuses it into the capacity reduction). The naive per-offset loop
    # re-reads the tables 27x (~16 GB/substep at 128^3/cap24); this reads
    # them once (~0.6 GB) and sweeps 27 dense (I,J,K) shifted mins after.
    offsets = list(itertools.product((-1, 0, 1), repeat=3))
    ox = jnp.array([o[0] for o in offsets], jnp.float32) * dx
    oy = jnp.array([o[1] for o in offsets], jnp.float32) * dx
    oz = jnp.array([o[2] for o in offsets], jnp.float32) * dx
    ux = (coords[0] + 0.5) * dx - px          # (cap, n_cells)
    uy = (coords[1] + 0.5) * dx - py
    uz = (coords[2] + 0.5) * dx - pz
    d2 = (
        (ux[:, :, None] + ox) ** 2
        + (uy[:, :, None] + oy) ** 2
        + (uz[:, :, None] + oz) ** 2
    )
    m27 = jnp.min(d2, axis=0)                 # (n_cells, 27)
    m27 = jnp.sqrt(m27) - radius

    phi = jnp.full(grid_shape, max_dist, jnp.float32)
    for oi, o in enumerate(offsets):
        m = m27[:, oi].reshape(grid_shape)    # source-cell min for offset o
        # contribution of source cell c lands at target cell c + o:
        # phi[c'] = min(phi[c'], m[c' - o])
        phi = jnp.minimum(
            phi, shifted_read(m, tuple(-v for v in o), grid_shape, fill=jnp.inf)
        )

    # extrapolate into solids (particlelevelset.cpp:127-139)
    phi = jnp.where(
        (phi < 0.5 * dx) & (solid_center_phi < 0), -0.5 * jnp.float32(dx), phi
    )
    return phi


def p2g_and_sdf(table: BucketTable, grid_shape, dx, radius, solid_center_phi,
                face_shapes):
    """Fused pass A transfer: liquid SDF + all three P2G components in one
    sweep over the 27 cell offsets, reading the position/velocity tables once
    per offset instead of four times (the P2G windows are subsets of the SDF
    window: component axis {0,1}, transverse {-1,0,1}).

    Returns (phi, [(val_sum, w_sum) per component]).
    """
    px, py, pz = table.fields[0], table.fields[1], table.fields[2]
    vels = (table.fields[3], table.fields[4], table.fields[5])
    coords = cell_coords(grid_shape).astype(jnp.float32)
    max_dist = jnp.float32(3.0 * dx)

    comp_axes = {"u": 0, "v": 1, "w": 2}
    offs = {c: _MAC_OFFSETS[c] for c in "uvw"}

    phi = jnp.full(grid_shape, max_dist, jnp.float32)
    sums = {c: (jnp.zeros(fs, jnp.float32), jnp.zeros(fs, jnp.float32))
            for c, fs in zip("uvw", face_shapes)}

    # per-axis absolute offset of cells/faces, reused across offsets
    cx = coords[0] * dx
    cy = coords[1] * dx
    cz = coords[2] * dx

    for o in itertools.product((-1, 0, 1), repeat=3):
        neg = tuple(-v for v in o)
        # --- SDF: distance from particles to the offset cell center ---
        dxp = cx[None, :] + (o[0] + 0.5) * dx - px
        dyp = cy[None, :] + (o[1] + 0.5) * dx - py
        dzp = cz[None, :] + (o[2] + 0.5) * dx - pz
        d = jnp.sqrt(dxp * dxp + dyp * dyp + dzp * dzp) - radius
        m = jnp.min(d, axis=0).reshape(grid_shape)
        phi = jnp.minimum(
            phi, shifted_read(m, neg, grid_shape, fill=jnp.inf)
        )

        # --- P2G: components whose window contains this offset ---
        for ci, comp in enumerate("uvw"):
            if o[comp_axes[comp]] not in (0, 1):
                continue
            off = offs[comp]
            fx = cx[None, :] + o[0] * dx - (px - off[0] * dx)
            fy = cy[None, :] + o[1] * dx - (py - off[1] * dx)
            fz = cz[None, :] + o[2] * dx - (pz - off[2] * dx)
            d2 = fx * fx + fy * fy + fz * fz
            w = _wyvill_weight(d2, dx)
            wv = jnp.sum(w * vels[ci], axis=0).reshape(grid_shape)
            ws = jnp.sum(w, axis=0).reshape(grid_shape)
            vs_, ss_ = sums[comp]
            sums[comp] = (
                vs_ + shifted_read(wv, neg, face_shapes[ci]),
                ss_ + shifted_read(ws, neg, face_shapes[ci]),
            )

    phi = jnp.where(
        (phi < 0.5 * dx) & (solid_center_phi < 0), -0.5 * jnp.float32(dx), phi
    )
    return phi, [sums[c] for c in "uvw"]


def _wyvill_weight(d2, dx):
    """Wyvill kernel (fluidsimulation.cpp:385-413), zero at and beyond r=dx."""
    r2 = jnp.float32(dx * dx)
    c1 = jnp.float32((4.0 / 9.0) / dx**6)
    c2 = jnp.float32((17.0 / 9.0) / dx**4)
    c3 = jnp.float32((22.0 / 9.0) / dx**2)
    w = 1.0 - c1 * d2 * d2 * d2 + c2 * d2 * d2 - c3 * d2
    return jnp.where(d2 < r2, w, 0.0)


def p2g_component(table: BucketTable, vel_field, grid_shape, dx, component,
                  face_shape):
    """Scatter one velocity component to its face grid with Wyvill weights.

    vel_field: (capacity, n_cells) table of this component's particle values.
    Returns (value_sum, weight_sum) arrays of `face_shape`.
    """
    px, py, pz = table.fields[0], table.fields[1], table.fields[2]
    off = _MAC_OFFSETS[component]
    windows, _ = _component_windows(component)
    coords = cell_coords(grid_shape).astype(jnp.float32)

    # particle position in the component's shifted frame, per slot
    sx = px - off[0] * dx
    sy = py - off[1] * dx
    sz = pz - off[2] * dx

    val_sum = jnp.zeros(face_shape, jnp.float32)
    w_sum = jnp.zeros(face_shape, jnp.float32)
    for o in itertools.product(*windows):
        dxp = (coords[0] + o[0]) * dx - sx
        dyp = (coords[1] + o[1]) * dx - sy
        dzp = (coords[2] + o[2]) * dx - sz
        d2 = dxp * dxp + dyp * dyp + dzp * dzp
        w = _wyvill_weight(d2, dx)
        wv = jnp.sum(w * vel_field, axis=0).reshape(grid_shape)
        ws = jnp.sum(w, axis=0).reshape(grid_shape)
        # face f = c + o receives cell c's sums
        neg = tuple(-v for v in o)
        val_sum = val_sum + shifted_read(wv, neg, face_shape)
        w_sum = w_sum + shifted_read(ws, neg, face_shape)
    return val_sum, w_sum


def g2p_component(table: BucketTable, grids, dx, component, in_domain=None):
    """Sample one MAC component of several grids at each particle position.

    All grids share the same trilinear weights (e.g. the new and saved
    velocity fields for the PIC/FLIP blend). Positions outside the domain
    sample to 0 when `in_domain` (capacity, n_cells) bool is given.
    Returns a list of (capacity, n_cells) arrays.
    """
    px, py, pz = table.fields[0], table.fields[1], table.fields[2]
    grid_shape = _cell_shape_of(grids[0], component)
    off = _MAC_OFFSETS[component]
    windows, _ = _component_windows(component)
    coords = cell_coords(grid_shape)

    # fractional coordinates in the component frame
    fs = []
    bases = []
    for p, ax in ((px, 0), (py, 1), (pz, 2)):
        f = p / dx - off[ax]
        b = jnp.floor(f)
        fs.append(f - b)  # t in [0,1)
        bases.append(b.astype(jnp.int32))
    deltas = [bases[a] - coords[a][None, :] for a in range(3)]

    outs = [jnp.zeros_like(px) for _ in grids]
    for o in itertools.product(*windows):
        w = jnp.ones_like(px)
        for ax in range(3):
            corner = o[ax] - deltas[ax]
            w = w * jnp.where(
                corner == 0, 1.0 - fs[ax], jnp.where(corner == 1, fs[ax], 0.0)
            )
        for gi, grid in enumerate(grids):
            gv = shifted_read(grid, o, grid_shape).reshape(1, -1)
            outs[gi] = outs[gi] + w * gv
    if in_domain is not None:
        outs = [jnp.where(in_domain, v, 0.0) for v in outs]
    return outs


def _cell_shape_of(grid, component):
    """Recover the cell grid shape from a face grid's shape."""
    s = list(grid.shape)
    ax = {"u": 0, "v": 1, "w": 2}[component]
    s[ax] -= 1
    return tuple(s)


def sample_mac_at_table(table: BucketTable, u, v, w, dx, in_domain=None):
    """Full MAC velocity at every table slot; returns (vx, vy, vz) tables."""
    (vx,) = g2p_component(table, [u], dx, "u", in_domain)
    (vy,) = g2p_component(table, [v], dx, "v", in_domain)
    (vz,) = g2p_component(table, [w], dx, "w", in_domain)
    return vx, vy, vz


def solid_phi_and_gradient_at_table(table: BucketTable, phi_node, dx,
                                    grid_shape):
    """Solid SDF value and trilinear gradient at in-domain table positions.

    Positions must lie inside the domain (home cell == floor(p/dx)), so the
    8 trilinear corners are exactly the home cell's nodes + {0,1}^3 offsets.
    Gradient per interpolation.cpp:122-184.
    """
    px, py, pz = table.fields[0], table.fields[1], table.fields[2]
    coords = cell_coords(grid_shape)
    ts = []
    for p, ax in ((px, 0), (py, 1), (pz, 2)):
        ts.append(p / dx - coords[ax][None, :].astype(jnp.float32))

    corner = {}
    for o in itertools.product((0, 1), repeat=3):
        corner[o] = shifted_read(phi_node, o, grid_shape).reshape(1, -1)

    tx, ty, tz = ts

    def lerp(a, b, t):
        return (1.0 - t) * a + t * b

    def bilerp(v00, v10, v01, v11, s, t):
        return lerp(lerp(v00, v10, s), lerp(v01, v11, s), t)

    phi = lerp(
        bilerp(corner[0, 0, 0], corner[0, 1, 0], corner[0, 0, 1],
               corner[0, 1, 1], ty, tz),
        bilerp(corner[1, 0, 0], corner[1, 1, 0], corner[1, 0, 1],
               corner[1, 1, 1], ty, tz),
        tx,
    )
    gx = bilerp(
        corner[1, 0, 0] - corner[0, 0, 0],
        corner[1, 1, 0] - corner[0, 1, 0],
        corner[1, 0, 1] - corner[0, 0, 1],
        corner[1, 1, 1] - corner[0, 1, 1],
        ty, tz,
    )
    gy = bilerp(
        corner[0, 1, 0] - corner[0, 0, 0],
        corner[1, 1, 0] - corner[1, 0, 0],
        corner[0, 1, 1] - corner[0, 0, 1],
        corner[1, 1, 1] - corner[1, 0, 1],
        tx, tz,
    )
    gz = bilerp(
        corner[0, 0, 1] - corner[0, 0, 0],
        corner[1, 0, 1] - corner[1, 0, 0],
        corner[0, 1, 1] - corner[0, 1, 0],
        corner[1, 1, 1] - corner[1, 1, 0],
        tx, ty,
    )
    return phi, (gx, gy, gz)


def solid_pushback_displacement(table: BucketTable, phi_node, dx, grid_shape):
    """Per-slot displacement projecting penetrating particles out of solids
    (fluidsimulation.cpp:326-333): if phi<0, p -= phi * normalize(grad phi)."""
    phi, (gx, gy, gz) = solid_phi_and_gradient_at_table(
        table, phi_node, dx, grid_shape
    )
    len2 = gx * gx + gy * gy + gz * gz
    inv = jnp.where(len2 > 0, 1.0 / jnp.sqrt(jnp.maximum(len2, 1e-30)), 1.0)
    scale = jnp.where(phi < 0, -phi * inv, 0.0)
    return scale * gx, scale * gy, scale * gz
