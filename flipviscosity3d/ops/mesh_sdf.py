"""Triangle mesh -> signed distance field on grid nodes.

Replaces the reference's three-stage construction
(/root/reference/src/meshlevelset.cpp:138-150):
  1. exact point-triangle distances in a band around each triangle
  2. BFS propagation of closest-triangle indices outward
  3. inside/outside sign from per-column ray-crossing parity

with a data-parallel design: stage 1+2 become one exact brute-force
(node x triangle) distance reduction, vmapped over nodes and scanned over
triangle chunks (exact everywhere, unlike the reference's approximate BFS
propagation outside the band). Stage 3 (sign) keeps the reference's
simulation-of-simplicity ray-parity logic but runs in float64 numpy at scene
setup, where exact orientation predicates matter and performance does not.

Also provides the static solid-boundary quantities derived from the node SDF:
union/negate (meshlevelset.cpp:152-194), cell-center averages
(meshlevelset.cpp:66-76), and 2D-fraction face weights
(meshlevelset.cpp:92-126).
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np

from .levelset import fraction_inside_quad


# --------------------------------------------------------------------------
# exact unsigned distance (JAX)
# --------------------------------------------------------------------------

def _point_segment_dist_sq(p, a, b):
    """Squared distance from points p (N,3) to segments a-b (M,3)."""
    d = b - a  # (M,3)
    m2 = jnp.sum(d * d, axis=-1)  # (M,)
    t = jnp.einsum("mc,nmc->nm", d, p[:, None, :] - a[None, :, :],
                   precision=jax.lax.Precision.HIGHEST)
    t = jnp.clip(t / jnp.maximum(m2, 1e-30), 0.0, 1.0)
    closest = a[None] + t[..., None] * d[None]
    diff = p[:, None, :] - closest
    return jnp.sum(diff * diff, axis=-1)


def _point_triangle_dist_sq(p, v1, v2, v3):
    """Squared point-triangle distance, branchless.

    Same geometry as MeshLevelSet::_pointToTriangleDistance
    (meshlevelset.cpp:350-390): barycentric projection onto the plane, edge
    clamping by which barycentric coordinate is positive.
    p: (N,3); v1,v2,v3: (M,3). Returns (N,M).
    """
    x13 = v1 - v3
    x23 = v2 - v3
    m13 = jnp.sum(x13 * x13, axis=-1)
    m23 = jnp.sum(x23 * x23, axis=-1)
    d = jnp.sum(x13 * x23, axis=-1)
    invdet = 1.0 / jnp.maximum(m13 * m23 - d * d, 1e-30)

    x03 = p[:, None, :] - v3[None, :, :]  # (N,M,3)
    hi = jax.lax.Precision.HIGHEST
    a = jnp.einsum("nmc,mc->nm", x03, x13, precision=hi)
    b = jnp.einsum("nmc,mc->nm", x03, x23, precision=hi)
    w23 = invdet * (m23 * a - d * b)
    w31 = invdet * (m13 * b - d * a)
    w12 = 1.0 - w23 - w31

    proj = (
        w23[..., None] * v1[None]
        + w31[..., None] * v2[None]
        + w12[..., None] * v3[None]
    )
    diff = p[:, None, :] - proj
    d_in = jnp.sum(diff * diff, axis=-1)

    d12 = _point_segment_dist_sq(p, v1, v2)
    d13 = _point_segment_dist_sq(p, v1, v3)
    d23 = _point_segment_dist_sq(p, v2, v3)

    inside = (w23 >= 0) & (w31 >= 0) & (w12 >= 0)
    d_out = jnp.where(
        w23 > 0,
        jnp.minimum(d12, d13),
        jnp.where(w31 > 0, jnp.minimum(d12, d23), jnp.minimum(d13, d23)),
    )
    return jnp.where(inside, d_in, d_out)


@functools.partial(
    jax.jit, static_argnames=("node_shape", "dx", "chunk", "point_block"))
def _min_distance_block(start, tri_verts, node_shape, dx, chunk, point_block):
    """Exact min distance from one block of grid nodes to any triangle; scans
    over triangle chunks so peak memory is O(point_block * chunk). Node
    positions are generated on the device from the flat start index, so no
    host-built point grid is uploaded."""
    m = tri_verts.shape[0]
    n_chunks = m // chunk
    tv = tri_verts.reshape(n_chunks, chunk, 3, 3)

    q = start + jnp.arange(point_block)
    nj, nk = node_shape[1], node_shape[2]
    pi = q // (nj * nk)
    pj = (q // nk) % nj
    pk = q % nk
    points = jnp.stack([pi, pj, pk], axis=-1).astype(jnp.float32) * dx

    def body(carry, tri_chunk):
        d2 = _point_triangle_dist_sq(
            points, tri_chunk[:, 0], tri_chunk[:, 1], tri_chunk[:, 2]
        )
        return jnp.minimum(carry, jnp.min(d2, axis=1)), None

    init = jnp.full((points.shape[0],), jnp.inf, points.dtype)
    best, _ = jax.lax.scan(body, init, tv)
    return jnp.sqrt(best)


def _min_distance_grid(node_shape, dx, tri_verts, chunk: int = 512,
                       point_block: int = 65536):
    """Exact min distance from every grid node to any triangle; returns a
    flat device array of length prod(node_shape).

    Loops point blocks on the host (one modest device program per block,
    setup-time only), which bounds the (block, chunk) temporaries at any
    grid size. Results stay on device.
    """
    n = node_shape[0] * node_shape[1] * node_shape[2]
    out = []
    for lo in range(0, n, point_block):
        out.append(_min_distance_block(
            jnp.int32(lo), tri_verts, node_shape, float(dx), chunk,
            point_block))
    dist = out[0] if len(out) == 1 else jnp.concatenate(out)
    return dist[:n]


# --------------------------------------------------------------------------
# sign via per-column crossing parity (numpy float64, setup-time)
# --------------------------------------------------------------------------

def _orientation(x1, y1, x2, y2):
    """Twice signed area + simulation-of-simplicity sign
    (meshlevelset.cpp:452-469). Vectorized numpy."""
    area = y1 * x2 - x1 * y2
    sign = np.sign(area)
    tie = sign == 0
    sign = np.where(tie & (y2 > y1), 1.0, sign)
    sign = np.where(tie & (y2 < y1), -1.0, sign)
    tie2 = tie & (y2 == y1)
    sign = np.where(tie2 & (x1 > x2), 1.0, sign)
    sign = np.where(tie2 & (x1 < x2), -1.0, sign)
    return sign, area


def _column_crossing_counts(vertices, triangles, node_shape, dx):
    """Ray-parity intersection counts per (i, j, k) node, numpy float64.

    For each triangle, for each integer (j,k) lattice column inside its
    (y,z) bounding box, test containment via SOS barycentric orientation and
    accumulate a crossing at i = ceil(interpolated x/dx)
    (meshlevelset.cpp:246-266, 331-347, 394-432).
    """
    isz, jsz, ksz = node_shape
    counts = np.zeros(node_shape, np.int64)
    v = np.asarray(vertices, np.float64) / dx
    tris = np.asarray(triangles, np.int64)

    for t0, t1, t2 in tris:
        p, q, r = v[t0], v[t1], v[t2]
        j0 = int(np.clip(np.ceil(min(p[1], q[1], r[1])), 0, jsz - 1))
        j1 = int(np.clip(np.floor(max(p[1], q[1], r[1])), 0, jsz - 1))
        k0 = int(np.clip(np.ceil(min(p[2], q[2], r[2])), 0, ksz - 1))
        k1 = int(np.clip(np.floor(max(p[2], q[2], r[2])), 0, ksz - 1))
        if j1 < j0 or k1 < k0:
            continue
        jj, kk = np.meshgrid(
            np.arange(j0, j1 + 1), np.arange(k0, k1 + 1), indexing="ij"
        )
        y1, z1 = p[1] - jj, p[2] - kk
        y2, z2 = q[1] - jj, q[2] - kk
        y3, z3 = r[1] - jj, r[2] - kk
        sa, oa = _orientation(y2, z2, y3, z3)
        sb, ob = _orientation(y3, z3, y1, z1)
        sc, oc = _orientation(y1, z1, y2, z2)
        hit = (sa != 0) & (sb == sa) & (sc == sa)
        if not hit.any():
            continue
        total = oa + ob + oc
        with np.errstate(divide="ignore", invalid="ignore"):
            fa = oa / total
            fb = ob / total
            fc = oc / total
        fi = fa * p[0] + fb * q[0] + fc * r[0]
        interval = np.ceil(fi).astype(np.int64)
        ji = jj[hit]
        ki = kk[hit]
        ii = interval[hit]
        lo = ii < 0
        np.add.at(counts, (np.zeros(lo.sum(), np.int64), ji[lo], ki[lo]), 1)
        ok = (~lo) & (ii < isz)
        np.add.at(counts, (ii[ok], ji[ok], ki[ok]), 1)
    return counts


# --------------------------------------------------------------------------
# public API
# --------------------------------------------------------------------------

@dataclasses.dataclass
class MeshLevelSet:
    """Node-sampled signed distance field: phi has shape
    (isize+1, jsize+1, ksize+1); negative inside the mesh."""

    phi: jnp.ndarray
    dx: float

    @property
    def node_shape(self):
        return self.phi.shape

    def negate(self) -> "MeshLevelSet":
        """CSG complement (meshlevelset.cpp:186-194)."""
        return MeshLevelSet(-self.phi, self.dx)

    def union(self, other: "MeshLevelSet") -> "MeshLevelSet":
        """CSG union = elementwise min (meshlevelset.cpp:152-184)."""
        return MeshLevelSet(jnp.minimum(self.phi, other.phi), self.dx)

    def cell_center_phi(self) -> jnp.ndarray:
        """Average of the 8 surrounding nodes (meshlevelset.cpp:66-76);
        shape (isize, jsize, ksize)."""
        p = self.phi
        return 0.125 * (
            p[:-1, :-1, :-1] + p[1:, :-1, :-1] + p[:-1, 1:, :-1] + p[1:, 1:, :-1]
            + p[:-1, :-1, 1:] + p[1:, :-1, 1:] + p[:-1, 1:, 1:] + p[1:, 1:, 1:]
        )

    def face_weight_u(self) -> jnp.ndarray:
        """2D inside-fraction on every U face (meshlevelset.cpp:92-98);
        shape (isize+1, jsize, ksize)."""
        p = self.phi
        return fraction_inside_quad(
            p[:, :-1, :-1], p[:, 1:, :-1], p[:, :-1, 1:], p[:, 1:, 1:]
        )

    def face_weight_v(self) -> jnp.ndarray:
        """(meshlevelset.cpp:104-110); shape (isize, jsize+1, ksize)."""
        p = self.phi
        return fraction_inside_quad(
            p[:-1, :, :-1], p[:-1, :, 1:], p[1:, :, :-1], p[1:, :, 1:]
        )

    def face_weight_w(self) -> jnp.ndarray:
        """(meshlevelset.cpp:116-122); shape (isize, jsize, ksize+1)."""
        p = self.phi
        return fraction_inside_quad(
            p[:-1, :-1, :], p[:-1, 1:, :], p[1:, :-1, :], p[1:, 1:, :]
        )


def mesh_to_sdf(vertices, triangles, grid_shape, dx, chunk: int = 512) -> MeshLevelSet:
    """Compute the signed distance field of a triangle mesh on grid nodes.

    grid_shape is in cells (isize, jsize, ksize); the node grid has one more
    sample per axis. Distances are exact everywhere (an upgrade over the
    reference's banded-exact + BFS-propagated field); signs use the
    reference's ray-parity rule.
    """
    isz, jsz, ksz = grid_shape
    node_shape = (isz + 1, jsz + 1, ksz + 1)
    verts = np.asarray(vertices, np.float32)
    tris = np.asarray(triangles, np.int64)

    tv = verts[tris]  # (M,3,3)
    m_pad = (-len(tv)) % chunk
    if m_pad:
        far = np.full((m_pad, 3, 3), 1e9, np.float32)
        tv = np.concatenate([tv, far], axis=0)

    dist = _min_distance_grid(node_shape, dx, jnp.asarray(tv), chunk=chunk)
    dist = dist.reshape(node_shape)

    counts = _column_crossing_counts(verts, tris, node_shape, dx)
    # upload only the 1-byte parity mask; phi is composed on device from
    # the device-resident distances
    inside = ((np.cumsum(counts, axis=0) % 2) == 1).astype(np.uint8)
    phi = jnp.where(jnp.asarray(inside).astype(bool), -dist, dist)
    return MeshLevelSet(phi, float(dx))
