"""Sorted-stream particle engine: equivalence against the table engine.

The table engine (ops/buckets.py + ops/particle_grid.py) was oracle-tested
against the reference in round 1; the stream engine must reproduce it to
float-accumulation-order tolerance on every transfer and end-to-end.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from flipviscosity3d import FluidSimulation
from flipviscosity3d.config import SimConfig
from flipviscosity3d.io.trianglemesh import box_mesh
from flipviscosity3d.ops import particle_grid as pg
from flipviscosity3d.ops import stream_transfers as st
from flipviscosity3d.ops.buckets import build_buckets, cell_of_position
from flipviscosity3d.ops.stream import cell_runs, stream_sort

DX = 1.0 / 12
SHAPE = (12, 12, 12)
RADIUS = DX * 1.01 * np.sqrt(3) / 2


def _particles(n=3000, seed=0):
    rng = np.random.default_rng(seed)
    pos = rng.uniform(DX, 1.0 - DX, size=(n, 3)).astype(np.float32)
    vel = rng.normal(size=(n, 3)).astype(np.float32)
    return jnp.asarray(pos), jnp.asarray(vel)


def test_cell_runs_matches_numpy():
    rng = np.random.default_rng(1)
    key_s = np.sort(rng.integers(0, 64, size=500).astype(np.int32))
    new_run, starts, counts = jax.jit(
        functools.partial(cell_runs, n_cells=64)
    )(jnp.asarray(key_s))
    starts = np.asarray(starts)
    counts = np.asarray(counts)
    expect_starts = np.searchsorted(key_s, np.arange(65))
    np.testing.assert_array_equal(starts, expect_starts)
    np.testing.assert_array_equal(counts, np.bincount(key_s, minlength=64))


def test_p2g_sdf_stream_matches_table():
    pos, vel = _particles()
    solid_phi = jnp.ones(SHAPE, jnp.float32)
    face_shapes = ((13, 12, 12), (12, 13, 12), (12, 12, 13))
    payload = (pos[:, 0], pos[:, 1], pos[:, 2],
               vel[:, 0], vel[:, 1], vel[:, 2])

    @jax.jit
    def run_table(pos, payload):
        table = build_buckets(pos, payload, DX, SHAPE, 64)
        return pg.p2g_and_sdf(table, SHAPE, DX, RADIUS, solid_phi,
                              face_shapes)

    @jax.jit
    def run_stream(pos, payload):
        s = stream_sort(pos, payload, DX, SHAPE)
        return st.p2g_sdf_stream(s, SHAPE, DX, RADIUS, solid_phi,
                                 face_shapes)

    phi_t, sums_t = run_table(pos, payload)
    phi_s, sums_s = run_stream(pos, payload)
    np.testing.assert_allclose(
        np.asarray(phi_t), np.asarray(phi_s), atol=2e-6
    )
    for (vt, wt), (vs, ws) in zip(sums_t, sums_s):
        np.testing.assert_allclose(
            np.asarray(wt), np.asarray(ws), rtol=2e-4, atol=1e-5
        )
        np.testing.assert_allclose(
            np.asarray(vt), np.asarray(vs), rtol=2e-4, atol=1e-5
        )


def test_sample_mac_matches_table_g2p():
    pos, vel = _particles(n=2000, seed=2)
    rng = np.random.default_rng(3)
    u = jnp.asarray(rng.normal(size=(13, 12, 12)).astype(np.float32))
    v = jnp.asarray(rng.normal(size=(12, 13, 12)).astype(np.float32))
    w = jnp.asarray(rng.normal(size=(12, 12, 13)).astype(np.float32))
    payload = (pos[:, 0], pos[:, 1], pos[:, 2])

    @jax.jit
    def run_table(pos, payload):
        table = build_buckets(pos, payload, DX, SHAPE, 64)
        sx, sy, sz = pg.sample_mac_at_table(table, u, v, w, DX)
        # map back through the slot structure to sorted order
        from flipviscosity3d.ops.buckets import gather_results

        return gather_results(table, (sx, sy, sz)), table.sorted

    @jax.jit
    def run_stream(pos, payload):
        s = stream_sort(pos, payload, DX, SHAPE)
        (su,), (sv,), (sw,) = st.sample_mac_at(
            s.sorted[0], s.sorted[1], s.sorted[2], s.key, [u], [v], [w],
            DX, SHAPE,
        )
        return (su, sv, sw), s.sorted

    (tx, ty, tz), sorted_t = run_table(pos, payload)
    (sx, sy, sz), sorted_s = run_stream(pos, payload)
    np.testing.assert_allclose(np.asarray(sorted_t[0]),
                               np.asarray(sorted_s[0]), atol=0)
    np.testing.assert_allclose(np.asarray(tx), np.asarray(sx), atol=5e-6)
    np.testing.assert_allclose(np.asarray(ty), np.asarray(sy), atol=5e-6)
    np.testing.assert_allclose(np.asarray(tz), np.asarray(sz), atol=5e-6)


def test_pushback_matches_table():
    pos, _ = _particles(n=1500, seed=4)
    rng = np.random.default_rng(5)
    phi_node = jnp.asarray(rng.normal(size=(13, 13, 13)).astype(np.float32))
    payload = (pos[:, 0], pos[:, 1], pos[:, 2])

    @jax.jit
    def run_table(pos, payload):
        table = build_buckets(pos, payload, DX, SHAPE, 64)
        d = pg.solid_pushback_displacement(table, phi_node, DX, SHAPE)
        from flipviscosity3d.ops.buckets import gather_results

        return gather_results(table, d)

    @jax.jit
    def run_stream(pos, payload):
        s = stream_sort(pos, payload, DX, SHAPE)
        return st.solid_pushback_at(
            s.sorted[0], s.sorted[1], s.sorted[2], s.key, phi_node, DX, SHAPE
        )

    dt_ = run_table(pos, payload)
    ds_ = run_stream(pos, payload)
    for a, b in zip(dt_, ds_):
        np.testing.assert_allclose(
            np.asarray(a), np.asarray(b), atol=5e-6
        )


def _advance_scene(engine, frames=3):
    sim = FluidSimulation()
    sim.initialize(
        16, 16, 16, 1.0 / 16,
        particle_engine=engine,
        bucket_capacity=48,  # no overflow -> table engine is exact
    )
    sim.add_liquid(box_mesh((0.2, 0.25, 0.2), (0.8, 0.6, 0.8)))
    sim.set_viscosity(2.0)
    sim.set_gravity(0.0, -9.81, 0.0)
    diags = []
    for _ in range(frames):
        diags.append(sim.advance(0.01))
    return sim, diags


def test_stream_engine_end_to_end_matches_table():
    sim_s, diag_s = _advance_scene("stream")
    sim_t, diag_t = _advance_scene("table")
    for ds, dt_ in zip(diag_s, diag_t):
        assert int(ds.substeps) == int(dt_.substeps)
        assert int(ds.bucket_overflow) == 0
        assert int(dt_.bucket_overflow) == 0
    # particle sets match as sets (sort orders may differ inside cells);
    # tolerance covers float accumulation-order differences between the
    # engines' reductions over 3 frames
    a = np.sort(np.asarray(sim_s.particle_positions), axis=0)
    b = np.sort(np.asarray(sim_t.particle_positions), axis=0)
    np.testing.assert_allclose(a, b, atol=5e-4)
    np.testing.assert_allclose(
        np.asarray(sim_s.state.u), np.asarray(sim_t.state.u), atol=5e-4
    )
    np.testing.assert_allclose(
        np.asarray(sim_s.state.v), np.asarray(sim_t.state.v), atol=5e-4
    )
