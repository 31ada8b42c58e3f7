"""Bucketed particle tables: correctness of sort/rank/scatter/gather."""

import functools

import jax
import jax.numpy as jnp
import numpy as np

from flipviscosity3d.ops import buckets

DX = 0.25
SHAPE = (4, 4, 4)


@functools.partial(jax.jit, static_argnames=("capacity",))
def _build(pos, vel, capacity):
    return buckets.build_buckets(
        pos,
        (pos[:, 0], pos[:, 1], pos[:, 2], vel[:, 0], vel[:, 1], vel[:, 2]),
        DX,
        SHAPE,
        capacity,
    )


def test_table_contains_all_particles():
    rng = np.random.default_rng(0)
    n = 200
    pos = rng.uniform(0, 1.0, size=(n, 3)).astype(np.float32)
    vel = rng.normal(size=(n, 3)).astype(np.float32)
    t = _build(jnp.asarray(pos), jnp.asarray(vel), 16)

    assert int(t.n_overflow) == 0
    # every particle appears exactly once in the table
    px = np.asarray(t.fields[0])
    real = px < 1e7
    assert real.sum() == n
    np.testing.assert_allclose(
        np.sort(px[real]), np.sort(pos[:, 0]), rtol=1e-6
    )

    # table column == home cell of the stored particle
    cells = np.floor(pos / DX).astype(np.int64)
    flat = (cells[:, 0] * 4 + cells[:, 1]) * 4 + cells[:, 2]
    counts = np.bincount(flat, minlength=64)
    table_counts = real.sum(axis=0)
    np.testing.assert_array_equal(table_counts, counts)


def test_overflow_drops_and_counts():
    # 40 particles all in one cell, capacity 16
    pos = np.full((40, 3), 0.1, np.float32)
    vel = np.zeros((40, 3), np.float32)
    t = _build(jnp.asarray(pos), jnp.asarray(vel), 16)
    assert int(t.n_overflow) == 24
    real = np.asarray(t.fields[0]) < 1e7
    assert real.sum() == 16


def test_gather_results_roundtrip_and_fallback():
    rng = np.random.default_rng(1)
    pos = rng.uniform(0, 1.0, size=(100, 3)).astype(np.float32)
    vel = rng.normal(size=(100, 3)).astype(np.float32)
    t = _build(jnp.asarray(pos), jnp.asarray(vel), 16)
    # gathering the position fields back must reproduce the sorted positions
    got = jax.jit(buckets.gather_results)(t, (t.fields[0], t.fields[1]))
    np.testing.assert_allclose(np.asarray(got[0]), np.asarray(t.sorted[0]))
    np.testing.assert_allclose(np.asarray(got[1]), np.asarray(t.sorted[1]))


def test_gather_fallback_on_overflow():
    pos = np.full((20, 3), 0.1, np.float32)
    pos[:, 0] = np.linspace(0.01, 0.24, 20)  # same cell, distinct values
    vel = np.zeros((20, 3), np.float32)
    t = _build(jnp.asarray(pos), jnp.asarray(vel), 16)
    fallback = jnp.full((20,), -7.0)
    (got,) = jax.jit(buckets.gather_results)(
        t, (t.fields[0],), fallbacks=(fallback,)
    )
    got = np.asarray(got)
    assert (got == -7.0).sum() == 4  # the 4 overflowed particles
    # the others returned their own x position
    ok = got != -7.0
    np.testing.assert_allclose(got[ok], np.asarray(t.sorted[0])[ok])


def test_cell_coords():
    c = np.asarray(buckets.cell_coords((2, 3, 4)))
    assert c.shape == (3, 24)
    # flat index (i*3 + j)*4 + k
    assert (c[0] * 12 + c[1] * 4 + c[2] == np.arange(24)).all()


def test_overflow_end_to_end_bounded_motion():
    """The documented overflow contract (config.on_bucket_overflow): with a
    deliberately tiny capacity the sim reports n_overflow > 0 and the
    overflowed particles take the ballistic fallback — motion stays finite,
    bounded, and inside the domain clamp box."""
    import pytest

    from flipviscosity3d import FluidSimulation
    from flipviscosity3d.io.trianglemesh import box_mesh

    res = 12
    sim = FluidSimulation()
    sim.initialize(res, res, res, 1.0 / res, bucket_capacity=2)
    sim.add_liquid(box_mesh((0.2, 0.2, 0.2), (0.8, 0.6, 0.8)))
    sim.set_viscosity(0.0)
    sim.set_gravity(0.0, -9.81, 0.0)

    total_overflow = 0
    for _ in range(3):
        d = sim.advance(0.01)
        total_overflow += int(d.bucket_overflow)
        pos = sim.particle_positions
        vel = sim.particle_velocities
        assert np.isfinite(pos).all() and np.isfinite(vel).all()
        dx = 1.0 / res
        assert (pos >= dx * 0.99).all() and (pos <= 1.0 - dx * 0.99).all()
        assert np.abs(vel).max() < 10.0  # bounded by gravity over 3 frames
    # seeding put 8/cell; capacity 2 must overflow every pass
    assert total_overflow > 0

    # "error" mode raises instead of silently degrading
    sim2 = FluidSimulation()
    sim2.initialize(
        res, res, res, 1.0 / res, bucket_capacity=2,
        on_bucket_overflow="error",
    )
    sim2.add_liquid(box_mesh((0.2, 0.2, 0.2), (0.8, 0.6, 0.8)))
    sim2.set_viscosity(0.0)
    with pytest.raises(RuntimeError, match="bucket overflow"):
        sim2.advance(0.01)
