"""Multi-chip: the sharded step must match the single-device step bitwise-ish
on the virtual 8-device CPU mesh (the fake-backend strategy from SURVEY §4).
"""

import os

import numpy as np
import pytest
import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from flipviscosity3d import FluidSimulation
from flipviscosity3d.core import step as step_mod
from flipviscosity3d.io.trianglemesh import box_mesh

# default 16 keeps the suite fast; the 64^3 validation run
# is SHARD_TEST_RES=64 python -m pytest tests/test_sharding.py -x -q
N = int(os.environ.get("SHARD_TEST_RES", "16"))
NDEV = 8


@pytest.fixture(scope="module")
def scene():
    sim = FluidSimulation()
    sim.initialize(N, N, N, 1.0 / N)
    sim.add_liquid(box_mesh((0.2, 0.25, 0.2), (0.8, 0.6, 0.8)))
    sim.set_viscosity(1.0)
    # fix the particle count to a multiple of NDEV for clean sharding
    state = sim.state
    n = (state.pos.shape[0] // NDEV) * NDEV
    state = state._replace(pos=state.pos[:n], vel=state.vel[:n])
    return sim.cfg, state


def test_sharded_step_matches_single_device(scene):
    from flipviscosity3d.parallel.sharding import make_mesh, shard_state

    cfg, state = scene
    single_state, single_diag = step_mod.advance(state, 0.01, cfg)

    mesh = make_mesh(NDEV)
    sharded_in, shardings = shard_state(state, mesh, cfg)
    sharded_state, sharded_diag = jax.jit(
        lambda s, dt: step_mod.advance(s, dt, cfg),
        in_shardings=(shardings, NamedSharding(mesh, P())),
        out_shardings=(shardings, NamedSharding(mesh, P())),
    )(sharded_in, jnp.float32(0.01))

    assert int(single_diag.substeps) == int(sharded_diag.substeps)
    assert int(single_diag.pressure_iterations) == int(
        sharded_diag.pressure_iterations
    )
    # particle sets match as SETS (sort order inside a cell may differ across
    # partitioned sorts); compare sorted flattened positions
    a = np.sort(np.asarray(single_state.pos).round(6).view("f4").reshape(-1, 3),
                axis=0)
    b = np.sort(np.asarray(sharded_state.pos).round(6).view("f4").reshape(-1, 3),
                axis=0)
    np.testing.assert_allclose(a, b, atol=5e-6)
    np.testing.assert_allclose(
        np.asarray(single_state.u), np.asarray(sharded_state.u), atol=1e-5
    )
    np.testing.assert_allclose(
        np.asarray(single_state.v), np.asarray(sharded_state.v), atol=1e-5
    )


def test_stencil_path_lowers_to_halo_exchanges_not_allgathers():
    """Under the unified i-axis decomposition, the 7-point matvec must
    partition into collective-permute halo exchanges; an all-gather on the
    stencil path would mean SPMD is materializing whole grids per device."""
    import re

    from flipviscosity3d.config import SimConfig
    from flipviscosity3d.parallel.sharding import make_mesh
    from flipviscosity3d.solvers import pressure as ps

    res = 16
    cfg = SimConfig(isize=res, jsize=res, ksize=res, dx=1.0 / res)
    mesh = make_mesh(NDEV)
    shard = NamedSharding(mesh, P("x", None, None))
    shape = cfg.grid_shape

    rng = np.random.default_rng(0)
    jj = np.arange(res, dtype=np.float32) + 0.5
    phi = np.broadcast_to(
        ((jj - 0.55 * res) / res)[None, :, None], shape
    ).astype(np.float32).copy()
    fluid = jnp.asarray(phi < 0)
    diag = jnp.asarray(rng.uniform(1, 2, shape).astype(np.float32)) * fluid
    plus = [
        jnp.asarray(-rng.uniform(0, 1, shape).astype(np.float32)) * fluid
        for _ in range(3)
    ]
    b = jnp.asarray(rng.normal(size=shape).astype(np.float32)) * fluid
    sys_p = ps.PressureSystem(
        fluid, diag, plus[0], plus[1], plus[2], b,
        jnp.ones(cfg.u_shape), jnp.ones(cfg.v_shape), jnp.ones(cfg.w_shape),
    )
    sys_sharded = jax.tree.map(
        lambda a: jax.device_put(
            a, shard if a.shape == shape else NamedSharding(mesh, P())
        ),
        sys_p,
    )
    x = jax.device_put(b, shard)
    hlo = jax.jit(ps.apply_pressure_matrix).lower(
        sys_sharded, x
    ).compile().as_text()
    n_permute = len(re.findall(r"\bcollective-permute\b", hlo))
    n_allgather = len(re.findall(r"\ball-gather\b", hlo))
    assert n_allgather == 0, f"stencil path emitted {n_allgather} all-gathers"
    assert n_permute >= 2, f"expected halo exchanges, got {n_permute}"
