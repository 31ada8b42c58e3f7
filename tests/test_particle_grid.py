"""Bucketed dense particle<->grid kernels vs direct per-particle oracles."""

import functools

import jax
import jax.numpy as jnp
import numpy as np

from flipviscosity3d.ops import buckets, interp
from flipviscosity3d.ops import particle_grid as pg

N = 8
DX = 1.0 / N
SHAPE = (N, N, N)
CAP = 16
RADIUS = DX * 1.01 * np.sqrt(3) / 2


def _particles(n=300, seed=0, lo=1.2, hi=6.8):
    rng = np.random.default_rng(seed)
    pos = rng.uniform(lo * DX, hi * DX, size=(n, 3)).astype(np.float32)
    vel = rng.normal(size=(n, 3)).astype(np.float32)
    return pos, vel


@functools.partial(jax.jit, static_argnames=())
def _table(pos, vel):
    return buckets.build_buckets(
        pos,
        (pos[:, 0], pos[:, 1], pos[:, 2], vel[:, 0], vel[:, 1], vel[:, 2]),
        DX,
        SHAPE,
        CAP,
    )


def test_liquid_sdf_matches_oracle():
    pos, vel = _particles()
    t = _table(jnp.asarray(pos), jnp.asarray(vel))
    solid_center = np.full(SHAPE, 1.0, np.float32)  # no solids
    got = np.asarray(
        jax.jit(pg.liquid_sdf_from_particles, static_argnames=("grid_shape",))(
            t, SHAPE, DX, RADIUS, jnp.asarray(solid_center)
        )
    )

    # oracle: particlelevelset.cpp:98-125
    want = np.full(SHAPE, 3.0 * DX, np.float32)
    for p in pos:
        g = np.floor(p / DX).astype(int)
        lo = np.maximum(g - 1, 0)
        hi = np.minimum(g + 1, np.array(SHAPE) - 1)
        for i in range(lo[0], hi[0] + 1):
            for j in range(lo[1], hi[1] + 1):
                for k in range(lo[2], hi[2] + 1):
                    c = (np.array([i, j, k]) + 0.5) * DX
                    d = np.linalg.norm(c - p) - RADIUS
                    want[i, j, k] = min(want[i, j, k], d)
    np.testing.assert_allclose(got, want, atol=1e-6)


def test_sdf_solid_extrapolation():
    pos, vel = _particles(50)
    t = _table(jnp.asarray(pos), jnp.asarray(vel))
    # solid everywhere: every near-surface cell becomes -dx/2
    solid_center = np.full(SHAPE, -1.0, np.float32)
    got = np.asarray(
        jax.jit(pg.liquid_sdf_from_particles, static_argnames=("grid_shape",))(
            t, SHAPE, DX, RADIUS, jnp.asarray(solid_center)
        )
    )
    mask = got < 0.5 * DX
    np.testing.assert_allclose(got[mask], -0.5 * DX)


def _p2g_oracle(pos, vel_comp, offset, grid_shape):
    """fluidsimulation.cpp:364-438."""
    field = np.zeros(grid_shape, np.float64)
    weights = np.zeros(grid_shape, np.float64)
    r2 = DX * DX
    c1 = (4.0 / 9.0) / DX**6
    c2 = (17.0 / 9.0) / DX**4
    c3 = (22.0 / 9.0) / DX**2
    for p, vc in zip(pos, vel_comp):
        ps = p - np.asarray(offset) * DX
        g = np.floor(ps / DX).astype(int)
        lo = np.maximum(g - 1, 0)
        hi = np.minimum(g + 1, np.array(grid_shape) - 1)
        for i in range(lo[0], hi[0] + 1):
            for j in range(lo[1], hi[1] + 1):
                for k in range(lo[2], hi[2] + 1):
                    gpos = np.array([i, j, k]) * DX
                    d2 = float(np.sum((gpos - ps) ** 2))
                    if d2 < r2:
                        w = 1.0 - c1 * d2**3 + c2 * d2**2 - c3 * d2
                        field[i, j, k] += w * vc
                        weights[i, j, k] += w
    return field, weights


def test_p2g_matches_oracle():
    pos, vel = _particles(250, seed=3)
    t = _table(jnp.asarray(pos), jnp.asarray(vel))
    for comp, face_shape, off, vidx in (
        ("u", (N + 1, N, N), (0.0, 0.5, 0.5), 3),
        ("v", (N, N + 1, N), (0.5, 0.0, 0.5), 4),
        ("w", (N, N, N + 1), (0.5, 0.5, 0.0), 5),
    ):
        vs, ws = jax.jit(
            pg.p2g_component,
            static_argnames=("grid_shape", "component", "face_shape"),
        )(t, t.fields[vidx], SHAPE, DX, comp, face_shape)
        want_v, want_w = _p2g_oracle(pos, vel[:, vidx - 3], off, face_shape)
        np.testing.assert_allclose(np.asarray(ws), want_w, atol=1e-4,
                                   err_msg=comp)
        np.testing.assert_allclose(np.asarray(vs), want_v, atol=1e-4,
                                   err_msg=comp)


def test_g2p_matches_gather_sampling():
    pos, vel = _particles(200, seed=4)
    rng = np.random.default_rng(5)
    u = rng.normal(size=(N + 1, N, N)).astype(np.float32)
    v = rng.normal(size=(N, N + 1, N)).astype(np.float32)
    w = rng.normal(size=(N, N, N + 1)).astype(np.float32)
    t = _table(jnp.asarray(pos), jnp.asarray(vel))

    @jax.jit
    def run(t, u, v, w):
        vx, vy, vz = pg.sample_mac_at_table(t, u, v, w, DX)
        return buckets.gather_results(t, (vx, vy, vz))

    got = np.stack(
        [np.asarray(a) for a in run(t, jnp.asarray(u), jnp.asarray(v), jnp.asarray(w))],
        axis=1,
    )
    # the sorted particle order defines correspondence
    pos_sorted = np.stack([np.asarray(s) for s in t.sorted[:3]], axis=1)
    want = np.asarray(
        jax.jit(interp.sample_mac_linear, static_argnames=("grid_shape",))(
            jnp.asarray(u), jnp.asarray(v), jnp.asarray(w),
            jnp.asarray(pos_sorted), DX, SHAPE
        )
    )
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_pushback_matches_gather_oracle():
    pos, vel = _particles(200, seed=6)
    rng = np.random.default_rng(7)
    phi_node = rng.normal(size=(N + 1, N + 1, N + 1)).astype(np.float32) * DX
    t = _table(jnp.asarray(pos), jnp.asarray(vel))

    @jax.jit
    def run(t, phin):
        dx_, dy_, dz_ = pg.solid_pushback_displacement(t, phin, DX, SHAPE)
        return buckets.gather_results(t, (dx_, dy_, dz_))

    got = np.stack(
        [np.asarray(a) for a in run(t, jnp.asarray(phi_node))], axis=1
    )
    pos_sorted = np.stack([np.asarray(s) for s in t.sorted[:3]], axis=1)

    phi = np.asarray(
        jax.jit(interp.trilinear)(jnp.asarray(phi_node),
                                  jnp.asarray(pos_sorted), DX)
    )
    grad = np.asarray(
        jax.jit(interp.trilinear_gradient)(jnp.asarray(phi_node),
                                           jnp.asarray(pos_sorted), DX)
    )
    norm = np.linalg.norm(grad, axis=1, keepdims=True)
    ghat = np.where(norm > 0, grad / np.maximum(norm, 1e-30), grad)
    want = np.where((phi < 0)[:, None], -phi[:, None] * ghat, 0.0)
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_fused_p2g_and_sdf_matches_separate():
    pos, vel = _particles(250, seed=8)
    t = _table(jnp.asarray(pos), jnp.asarray(vel))
    solid_center = np.full(SHAPE, 1.0, np.float32)
    face_shapes = ((N + 1, N, N), (N, N + 1, N), (N, N, N + 1))

    phi_f, sums = jax.jit(
        pg.p2g_and_sdf, static_argnames=("grid_shape", "face_shapes")
    )(t, SHAPE, DX, RADIUS, jnp.asarray(solid_center), face_shapes)

    phi_s = jax.jit(
        pg.liquid_sdf_from_particles, static_argnames=("grid_shape",)
    )(t, SHAPE, DX, RADIUS, jnp.asarray(solid_center))
    np.testing.assert_allclose(np.asarray(phi_f), np.asarray(phi_s), atol=1e-6)

    for ci, comp in enumerate("uvw"):
        vs_, ws_ = jax.jit(
            pg.p2g_component,
            static_argnames=("grid_shape", "component", "face_shape"),
        )(t, t.fields[3 + ci], SHAPE, DX, comp, face_shapes[ci])
        np.testing.assert_allclose(
            np.asarray(sums[ci][0]), np.asarray(vs_), atol=1e-5, err_msg=comp
        )
        np.testing.assert_allclose(
            np.asarray(sums[ci][1]), np.asarray(ws_), atol=1e-5, err_msg=comp
        )
