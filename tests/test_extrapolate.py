"""Velocity extrapolation semantics (layered averaging, border exclusion)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np

from flipviscosity3d.ops.extrapolate import extrapolate_grid


@functools.partial(jax.jit, static_argnames=("layers",))
def _run(grid, valid, layers):
    return extrapolate_grid(grid, valid, layers)


def test_single_seed_spreads_in_layers():
    shape = (9, 9, 9)
    grid = jnp.zeros(shape).at[4, 4, 4].set(5.0)
    valid = jnp.zeros(shape, bool).at[4, 4, 4].set(True)

    g1, v1 = _run(grid, valid, 1)
    v1 = np.asarray(v1)
    # exactly the 6-neighbors become known after one layer
    assert v1.sum() == 7
    assert v1[3, 4, 4] and v1[5, 4, 4] and v1[4, 3, 4]
    np.testing.assert_allclose(np.asarray(g1)[3, 4, 4], 5.0)

    g2, v2 = _run(grid, valid, 2)
    # Manhattan-distance-2 ball (minus nothing at this size)
    assert np.asarray(v2).sum() == 1 + 6 + 18


def test_border_never_filled():
    shape = (5, 5, 5)
    grid = jnp.zeros(shape).at[1, 1, 1].set(2.0)
    valid = jnp.zeros(shape, bool).at[1, 1, 1].set(True)
    g, v = _run(grid, valid, 10)
    v = np.asarray(v)
    # all interior filled, border untouched
    assert v[1:-1, 1:-1, 1:-1].all()
    assert not v[0].any() and not v[-1].any()
    assert not v[:, 0].any() and not v[:, -1].any()
    np.testing.assert_allclose(np.asarray(g)[1:-1, 1:-1, 1:-1], 2.0)


def test_average_of_known_neighbors():
    shape = (7, 7, 7)
    grid = jnp.zeros(shape).at[2, 3, 3].set(1.0).at[4, 3, 3].set(3.0)
    valid = (
        jnp.zeros(shape, bool).at[2, 3, 3].set(True).at[4, 3, 3].set(True)
    )
    g, v = _run(grid, valid, 1)
    # the cell between the two seeds averages them
    assert abs(float(g[3, 3, 3]) - 2.0) < 1e-6


def test_border_valid_contributes_but_does_not_discover():
    """A KNOWN cell on the border contributes to averages but cannot by
    itself cause a neighbor to be filled (the reference's discovery loop
    scans interior cells only, macvelocityfield.cpp:604-606)."""
    shape = (5, 5, 5)
    # single valid cell ON the border
    grid = jnp.zeros(shape).at[0, 2, 2].set(9.0)
    valid = jnp.zeros(shape, bool).at[0, 2, 2].set(True)
    g, v = _run(grid, valid, 3)
    # nothing is ever discovered
    assert np.asarray(v).sum() == 1

    # border cell + interior cell: border value contributes to the average
    grid = jnp.zeros(shape).at[0, 2, 2].set(9.0).at[1, 3, 2].set(3.0)
    valid = (
        jnp.zeros(shape, bool).at[0, 2, 2].set(True).at[1, 3, 2].set(True)
    )
    g, v = _run(grid, valid, 1)
    # cell (1,2,2): neighbors known = (0,2,2)[border] and (1,3,2)[interior]
    # discovered by the interior one; value = mean(9, 3) = 6
    assert bool(v[1, 2, 2])
    assert abs(float(g[1, 2, 2]) - 6.0) < 1e-6
