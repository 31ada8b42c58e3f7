"""End-to-end integration: a small dam-break settles sanely, state
checkpoints round-trip, CFL substepping engages."""

import numpy as np
import pytest

from flipviscosity3d import FluidSimulation
from flipviscosity3d.io.trianglemesh import box_mesh
from flipviscosity3d.utils.checkpoint import load_state, save_state

N = 16


@pytest.fixture(scope="module")
def sim():
    s = FluidSimulation()
    s.initialize(N, N, N, 1.0 / N)
    # liquid column against one wall
    s.add_liquid(box_mesh((0.15, 0.15, 0.15), (0.5, 0.7, 0.85)))
    s.set_viscosity(0.0)
    s.set_gravity(0.0, -9.81, 0.0)
    return s


def test_dam_break_sane(sim):
    n0 = sim.particle_positions.shape[0]
    assert n0 > 500

    com0 = sim.particle_positions.mean(axis=0)
    for _ in range(8):
        diag = sim.advance(0.01)

    pos = sim.particle_positions
    vel = sim.particle_velocities
    # particle count conserved (fixed-shape engine)
    assert pos.shape[0] == n0
    # everything stays in the clamp box
    dx = 1.0 / N
    assert pos.min() >= dx
    assert pos.max() <= 1.0 - dx
    assert np.isfinite(pos).all() and np.isfinite(vel).all()
    # the column is falling and spreading: center of mass dropped
    com = pos.mean(axis=0)
    assert com[1] < com0[1] - 0.005
    # velocities bounded by free-fall speed
    assert np.abs(vel).max() < 9.81 * 0.01 * 8 * 2.0 + 1.0

    d = sim.last_diagnostics
    assert int(d.pressure_iterations) > 0
    assert int(d.bucket_overflow) == 0
    assert int(d.liquid_cells) > 100


def test_cfl_substepping(sim):
    """With a long frame dt and nonzero velocities, the CFL condition forces
    multiple substeps (fluidsimulation.cpp:138-143): substep = cfl*dx/maxvel,
    so dt must exceed that. After ~8 fall frames maxvel ~1.5, cfl*dx ~0.31."""
    diag = sim.advance(0.4)
    assert float(diag.max_velocity) > 5.0 * sim.cfg.dx / 0.4
    assert int(diag.substeps) >= 2


def test_checkpoint_roundtrip(sim, tmp_path):
    p = str(tmp_path / "ckpt.npz")
    save_state(p, sim.state)
    restored = load_state(p)
    np.testing.assert_array_equal(
        np.asarray(restored.pos), np.asarray(sim.state.pos)
    )
    np.testing.assert_array_equal(
        np.asarray(restored.u), np.asarray(sim.state.u)
    )
    np.testing.assert_array_equal(
        np.asarray(restored.solid.weight_u),
        np.asarray(sim.state.solid.weight_u),
    )
    # resuming from the checkpoint advances identically to the live state
    sim2 = FluidSimulation()
    sim2.initialize(N, N, N, 1.0 / N)
    sim2._state = restored
    sim2.cfg = sim.cfg
    d1 = sim.advance(0.01)
    d2 = sim2.advance(0.01)
    assert int(d1.substeps) == int(d2.substeps)
    np.testing.assert_allclose(
        sim.particle_positions, sim2.particle_positions, atol=1e-6
    )


def test_solid_obstacle_excludes_particles():
    """Non-inverted add_boundary: a solid box inside the domain seeds no
    particles inside itself and keeps fluid from penetrating deeply."""
    s = FluidSimulation()
    s.initialize(N, N, N, 1.0 / N)
    s.add_boundary(box_mesh((0.4, 0.1, 0.4), (0.6, 0.45, 0.6)))
    s.add_liquid(box_mesh((0.2, 0.55, 0.2), (0.8, 0.8, 0.8)))
    s.set_viscosity(0.0)
    s.set_gravity(0.0, -9.81, 0.0)

    pos0 = s.particle_positions
    inside0 = (
        (np.abs(pos0[:, 0] - 0.5) < 0.09)
        & (pos0[:, 1] > 0.11) & (pos0[:, 1] < 0.44)
        & (np.abs(pos0[:, 2] - 0.5) < 0.09)
    )
    assert inside0.sum() == 0

    for _ in range(6):
        s.advance(0.01)
    pos = s.particle_positions
    # no particle ends up well inside the obstacle (allow a cell of slop at
    # the SDF surface)
    deep = (
        (np.abs(pos[:, 0] - 0.5) < 0.1 - 2.0 / N)
        & (pos[:, 1] > 0.1 + 2.0 / N) & (pos[:, 1] < 0.45 - 2.0 / N)
        & (np.abs(pos[:, 2] - 0.5) < 0.1 - 2.0 / N)
    )
    assert deep.sum() == 0, f"{deep.sum()} particles inside the obstacle"


def test_variable_viscosity_grid():
    """setViscosity(Array3d&) equivalent: a per-node viscosity grid runs and
    engages the solve (fluidsimulation.cpp:110-124)."""
    s = FluidSimulation()
    s.initialize(N, N, N, 1.0 / N)
    s.add_liquid(box_mesh((0.2, 0.3, 0.2), (0.8, 0.7, 0.8)))
    grid = np.linspace(0.5, 8.0, (N + 1) ** 3).reshape(
        (N + 1, N + 1, N + 1)
    ).astype(np.float32)
    s.set_viscosity(grid)
    s.set_gravity(0.0, -9.81, 0.0)
    d = s.advance(0.01)
    assert int(d.viscosity_iterations) > 0
    assert np.isfinite(s.particle_positions).all()

    import pytest

    with pytest.raises(ValueError):
        s.set_viscosity(-1.0)
    with pytest.raises(ValueError):
        s.set_viscosity(np.ones((3, 3, 3), np.float32))
