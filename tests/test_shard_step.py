"""shard_map slab pipeline vs the single-device engine.

The slab decomposition (parallel/shard_step.py) must reproduce the
single-device step: same substep count, same CG iteration counts (the
masked psum reductions make the CG trajectories identical up to float
reduction order), same particle cloud, same grids on owned rows.
"""

import dataclasses

import numpy as np
import pytest
import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from flipviscosity3d import FluidSimulation
from flipviscosity3d.core import step as step_mod
from flipviscosity3d.io.trianglemesh import box_mesh
from flipviscosity3d.parallel import shard_step as sh

N = 32
NDEV = 4
FRAMES = 2


@pytest.fixture(scope="module")
def scene():
    sim = FluidSimulation()
    # jacobi on both sides: the slab path uses jacobi (multigrid is a
    # single-device construct), so iteration counts only match with jacobi
    sim.initialize(
        N, N, N, 1.0 / N,
        pressure_preconditioner="jacobi",
        viscosity_preconditioner="jacobi",
    )
    sim.add_liquid(box_mesh((0.2, 0.25, 0.2), (0.8, 0.6, 0.8)))
    sim.set_viscosity(1.5)
    sim.set_gravity(0.0, -9.81, 0.0)
    return sim.cfg, sim.state


def test_shard_step_matches_single_device(scene):
    cfg, state = scene
    mesh = Mesh(np.array(jax.devices()[:NDEV]), (sh.AXIS,))
    spec = sh.make_spec(cfg, NDEV, n_particles=state.pos.shape[0])
    ss = sh.shard_simstate(state, cfg, spec, mesh)

    sstate = state
    for _ in range(FRAMES):
        sstate, sdiag = step_mod.advance(sstate, 0.01, cfg)
        ss, mdiag = sh.advance_sharded(ss, 0.01, cfg, spec, mesh)
        assert int(sdiag.substeps) == int(mdiag.substeps)
        assert int(mdiag.bucket_overflow) == 0
        # CG sees the same global reductions -> identical iteration counts
        assert abs(
            int(sdiag.pressure_iterations) - int(mdiag.pressure_iterations)
        ) <= 1
        assert abs(
            int(sdiag.viscosity_iterations) - int(mdiag.viscosity_iterations)
        ) <= 2

    pos_m, _ = sh.gather_particles(ss)
    pos_s = np.asarray(sstate.pos)
    assert pos_m.shape == pos_s.shape
    a = np.sort(pos_s, axis=0)
    b = np.sort(pos_m, axis=0)
    np.testing.assert_allclose(a, b, atol=5e-4)

    u_m = sh.gather_grid_u(ss, spec)
    np.testing.assert_allclose(
        u_m, np.asarray(sstate.u), atol=5e-4,
    )
    v_m = sh.gather_grid_cell(ss.v, spec)
    np.testing.assert_allclose(
        v_m, np.asarray(sstate.v), atol=5e-4,
    )


def test_shard_step_multigrid_matches_single_device(scene):
    """With the distributed slab V-cycle (parallel/slab_mg.py) both sides
    precondition with the SAME exact-Galerkin hierarchy (the slab build is
    provably the global P^T A P), so multigrid iteration counts must match
    the single-device multigrid counts, not just stay within 1.5x."""
    cfg, state = scene
    cfg = dataclasses.replace(
        cfg,
        pressure_preconditioner="multigrid",
        viscosity_preconditioner="multigrid",
    )
    mesh = Mesh(np.array(jax.devices()[:NDEV]), (sh.AXIS,))
    spec = sh.make_spec(cfg, NDEV, n_particles=state.pos.shape[0])
    ss = sh.shard_simstate(state, cfg, spec, mesh)

    sstate, sdiag = step_mod.advance(state, 0.01, cfg)
    ss, mdiag = sh.advance_sharded(ss, 0.01, cfg, spec, mesh)
    assert int(sdiag.substeps) == int(mdiag.substeps)
    s_p, m_p = int(sdiag.pressure_iterations), int(mdiag.pressure_iterations)
    s_v, m_v = int(sdiag.viscosity_iterations), int(mdiag.viscosity_iterations)
    assert abs(s_p - m_p) <= max(2, s_p // 4), (s_p, m_p)
    assert abs(s_v - m_v) <= max(2, s_v // 4), (s_v, m_v)
    # multigrid must actually help vs the jacobi fixture counts
    pos_m, _ = sh.gather_particles(ss)
    a = np.sort(np.asarray(sstate.pos), axis=0)
    b = np.sort(pos_m, axis=0)
    np.testing.assert_allclose(a, b, atol=5e-4)


def test_migration_moves_particles(scene):
    """Particles straddling a slab boundary with inbound velocity MUST
    migrate: per-shard occupancy changes, the migration count is nonzero,
    nothing is lost, and the cloud still matches the single-device engine.

    This exercises the ppermute buffer machinery in shard_step._migrate
    (the code the reference's serial particle loop never needs,
    /root/reference/src/fluidsimulation.cpp:315-339)."""
    cfg, state = scene
    # uniform +x velocity: divergence-free in the interior, so the pressure
    # projection preserves the bulk drift and particles cross slab faces
    vel = np.zeros_like(np.asarray(state.vel))
    vel[:, 0] = 2.0
    state = state._replace(vel=jnp.asarray(vel))
    cfg = dataclasses.replace(cfg)

    mesh = Mesh(np.array(jax.devices()[:NDEV]), (sh.AXIS,))
    spec = sh.make_spec(cfg, NDEV, n_particles=state.pos.shape[0])
    ss = sh.shard_simstate(state, cfg, spec, mesh)
    occ0 = np.asarray(ss.alive).sum(axis=1)

    sstate = state
    migrated_total = 0
    for _ in range(3):
        sstate, _ = step_mod.advance(sstate, 0.01, cfg)
        occ_before = np.asarray(ss.alive).sum(axis=1)
        ss, mdiag = sh.advance_sharded(ss, 0.01, cfg, spec, mesh)
        assert int(mdiag.bucket_overflow) == 0  # no migration drops
        occ_after = np.asarray(ss.alive).sum(axis=1)
        migrated_total += int(np.abs(occ_after - occ_before).sum()) // 2

    occ1 = np.asarray(ss.alive).sum(axis=1)
    assert occ1.sum() == occ0.sum(), "particles lost in migration"
    assert migrated_total > 0, (
        f"no particles migrated (occupancy {occ0} -> {occ1}); the +x drift "
        "must push particles across slab faces"
    )
    # ownership invariant: every alive particle sits inside its shard's rows
    pos_sh = np.asarray(ss.pos)
    alive_sh = np.asarray(ss.alive)
    for s in range(NDEV):
        xs = pos_sh[s, alive_sh[s], 0]
        gi = np.floor(xs / cfg.dx).astype(int) // spec.B
        np.testing.assert_array_equal(np.clip(gi, 0, NDEV - 1), s)
    # and the cloud still matches the single-device engine
    pos_m, _ = sh.gather_particles(ss)
    a = np.sort(np.asarray(sstate.pos), axis=0)
    b = np.sort(pos_m, axis=0)
    np.testing.assert_allclose(a, b, atol=5e-4)


def test_shard_step_inviscid(scene):
    """Inviscid path (viscosity cond off) also matches."""
    cfg, state = scene
    cfg0 = dataclasses.replace(cfg)
    state0 = state._replace(viscosity=jnp.zeros_like(state.viscosity))
    mesh = Mesh(np.array(jax.devices()[:NDEV]), (sh.AXIS,))
    spec = sh.make_spec(cfg0, NDEV, n_particles=state0.pos.shape[0])
    ss = sh.shard_simstate(state0, cfg0, spec, mesh)

    sstate, sdiag = step_mod.advance(state0, 0.01, cfg0)
    ss, mdiag = sh.advance_sharded(ss, 0.01, cfg0, spec, mesh)
    assert int(sdiag.substeps) == int(mdiag.substeps)
    assert int(mdiag.viscosity_iterations) == 0
    pos_m, _ = sh.gather_particles(ss)
    a = np.sort(np.asarray(sstate.pos), axis=0)
    b = np.sort(pos_m, axis=0)
    np.testing.assert_allclose(a, b, atol=5e-4)


def test_dcn_slab_mesh_matches_flat_mesh(scene):
    """docs/DCN.md plumbing: the host-major slab mesh (make_slab_mesh,
    2 virtual hosts x 4 chips standing in for a multi-host pod) must run
    the identical shard_map program — same substeps, same iteration
    counts, same particles — as the flat single-host mesh. On real
    hardware only device PLACEMENT differs (host boundaries ride DCN)."""
    from flipviscosity3d.parallel.sharding import make_slab_mesh

    cfg, state = scene
    mesh_flat = Mesh(np.array(jax.devices()[:NDEV]), (sh.AXIS,))
    mesh_dcn = make_slab_mesh(2, NDEV // 2, axis=sh.AXIS)
    assert mesh_dcn.shape[sh.AXIS] == NDEV

    spec = sh.make_spec(cfg, NDEV, n_particles=state.pos.shape[0])
    ss_f = sh.shard_simstate(state, cfg, spec, mesh_flat)
    ss_d = sh.shard_simstate(state, cfg, spec, mesh_dcn)

    ss_f, diag_f = sh.advance_sharded(ss_f, 0.01, cfg, spec, mesh_flat)
    ss_d, diag_d = sh.advance_sharded(ss_d, 0.01, cfg, spec, mesh_dcn)
    assert int(diag_f.substeps) == int(diag_d.substeps)
    assert int(diag_f.pressure_iterations) == int(diag_d.pressure_iterations)
    pos_f, _ = sh.gather_particles(ss_f)
    pos_d, _ = sh.gather_particles(ss_d)
    np.testing.assert_allclose(
        np.sort(pos_f, axis=0), np.sort(pos_d, axis=0), atol=1e-5)


def test_state_on_mesh_compiles_once(scene):
    """shard_simstate places every array in the layout advance_sharded
    returns, so a frame fed its own output reuses the compiled program."""
    cfg, state = scene
    mesh = Mesh(np.array(jax.devices()[:NDEV]), (sh.AXIS,))
    spec = sh.make_spec(cfg, NDEV, n_particles=state.pos.shape[0])
    ss = sh.shard_simstate(state, cfg, spec, mesh)
    assert ss.u.sharding.spec == jax.sharding.PartitionSpec(sh.AXIS)
    ss, _ = sh.advance_sharded(ss, 0.01, cfg, spec, mesh)
    compiled = sh.advance_sharded._cache_size()
    ss, _ = sh.advance_sharded(ss, 0.01, cfg, spec, mesh)
    assert sh.advance_sharded._cache_size() == compiled
