"""Interpolation conventions vs analytic fields and the reference's
out-of-range semantics."""

import jax
import jax.numpy as jnp
import numpy as np

from flipviscosity3d.ops import interp

DX = 0.25


def test_trilinear_linear_field_exact():
    """Trilinear interpolation reproduces a linear field exactly away from
    borders."""
    shape = (8, 9, 10)
    ii, jj, kk = np.meshgrid(*(np.arange(s) for s in shape), indexing="ij")
    grid = jnp.asarray((2.0 * ii + 3.0 * jj - kk) * DX, jnp.float32)

    rng = np.random.default_rng(0)
    pos = rng.uniform(DX, 6 * DX, size=(64, 3)).astype(np.float32)
    got = jax.jit(interp.trilinear, static_argnames=())(
        grid, jnp.asarray(pos), DX
    )
    want = 2.0 * pos[:, 0] + 3.0 * pos[:, 1] - pos[:, 2]
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-5, atol=1e-5)


def test_trilinear_out_of_range_zero():
    """Out-of-range corners contribute 0 (interpolation.cpp:78-105)."""
    grid = jnp.ones((4, 4, 4), jnp.float32)
    f = jax.jit(interp.trilinear)
    # far outside: all corners out of range
    assert float(f(grid, jnp.array([-10.0, 0.1, 0.1]), DX)) == 0.0
    # halfway off the low edge in x: base = -1, only the x=0 corners count
    val = float(f(grid, jnp.array([-0.5 * DX, 0.5 * DX, 0.5 * DX]), DX))
    assert abs(val - 0.5) < 1e-6


def test_gradient_of_linear_field():
    shape = (8, 8, 8)
    ii, jj, kk = np.meshgrid(*(np.arange(s) for s in shape), indexing="ij")
    grid = jnp.asarray((2.0 * ii + 3.0 * jj - kk) * DX, jnp.float32)
    pos = jnp.asarray([[3.3 * DX, 2.7 * DX, 4.1 * DX]], jnp.float32)
    g = jax.jit(interp.trilinear_gradient)(grid, pos, DX)
    # the reference gradient is in units of value per *cell*, not per length
    np.testing.assert_allclose(
        np.asarray(g)[0], [2.0 * DX, 3.0 * DX, -1.0 * DX], rtol=1e-5
    )


def test_mac_sampling_constant_field():
    """A constant MAC field samples to that constant inside the domain and to
    zero outside (macvelocityfield.cpp:455-578)."""
    shape = (6, 6, 6)
    u = jnp.full((7, 6, 6), 2.0, jnp.float32)
    v = jnp.full((6, 7, 6), -3.0, jnp.float32)
    w = jnp.full((6, 6, 7), 4.0, jnp.float32)
    f = jax.jit(lambda p: interp.sample_mac_linear(u, v, w, p, DX, shape))

    inside = jnp.asarray([[3.0 * DX, 3.0 * DX, 3.0 * DX]])
    np.testing.assert_allclose(np.asarray(f(inside))[0], [2.0, -3.0, 4.0], rtol=1e-6)

    outside = jnp.asarray([[-0.1, 3.0 * DX, 3.0 * DX]])
    np.testing.assert_allclose(np.asarray(f(outside))[0], [0.0, 0.0, 0.0])

    # near the transverse edge the half-dx shift reads out-of-range zeros:
    # U at y < dx/2 only sees the j=0 row with weight (0.5 + y/dx)
    edge = jnp.asarray([[3.0 * DX, 0.0, 3.0 * DX]])
    val = np.asarray(f(edge))[0]
    assert abs(val[0] - 2.0 * 0.5) < 1e-5


def test_tricubic_constant_field():
    grid = jnp.full((8, 8, 8), 5.0, jnp.float32)
    pos = jnp.asarray([[3.4 * DX, 3.6 * DX, 3.2 * DX]])
    val = float(jax.jit(interp.tricubic)(grid, pos, DX)[0])
    assert abs(val - 5.0) < 1e-5
