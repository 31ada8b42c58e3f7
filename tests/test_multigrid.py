"""Galerkin-aggregation multigrid preconditioner: symmetry, convergence to
the same solution, and iteration-count improvement over Jacobi on a
free-surface viscous system (the round-1 failure mode was precisely
free-surface partial-volume rows)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from flipviscosity3d.config import SimConfig
from flipviscosity3d.solvers import multigrid as mg
from flipviscosity3d.solvers import pressure as ps
from flipviscosity3d.solvers import viscosity as vs

N = 16
DT = 0.01


def _setup():
    cfg_j = SimConfig(
        isize=N, jsize=N, ksize=N, dx=1.0 / N,
        viscosity_preconditioner="jacobi",
        pressure_preconditioner="jacobi",
    )
    cfg_m = SimConfig(
        isize=N, jsize=N, ksize=N, dx=1.0 / N,
        viscosity_preconditioner="multigrid",
        pressure_preconditioner="multigrid",
    )
    # liquid pool filling the lower half -> a real free surface at j~N/2,
    # a solid floor, and partial-volume rows near the interface
    jj = np.arange(N, dtype=np.float32) + 0.5
    phi = np.broadcast_to(
        ((jj - 0.53 * N) / N)[None, :, None], (N, N, N)
    ).astype(np.float32).copy()
    solid_center = np.ones((N, N, N), np.float32)
    solid_center[:, :2, :] = -1.0
    visc = np.full((N + 1, N + 1, N + 1), 5.0, np.float32)
    rng = np.random.default_rng(0)
    u = rng.normal(size=(N + 1, N, N)).astype(np.float32)
    v = rng.normal(size=(N, N + 1, N)).astype(np.float32)
    w = rng.normal(size=(N, N, N + 1)).astype(np.float32)
    states = jax.jit(lambda s: vs.compute_face_states(s, cfg_j))(
        jnp.asarray(solid_center)
    )

    @jax.jit
    def build(uu, vv, ww, p, vis):
        volumes = vs.compute_volume_grids(p, cfg_j)
        vsys = vs.build_viscosity_system(
            uu, vv, ww, volumes, states, vis, DT, cfg_j
        )
        wu = jnp.ones(cfg_j.u_shape, jnp.float32)
        wv = jnp.ones(cfg_j.v_shape, jnp.float32)
        ww_ = jnp.ones(cfg_j.w_shape, jnp.float32)
        psys = ps.build_pressure_system(uu, vv, ww, p, wu, wv, ww_, DT, cfg_j)
        return vsys, psys

    vsys, psys = build(
        jnp.asarray(u), jnp.asarray(v), jnp.asarray(w), jnp.asarray(phi),
        jnp.asarray(visc),
    )
    return cfg_j, cfg_m, vsys, psys


def test_viscosity_mg_free_surface_faster_same_solution():
    cfg_j, cfg_m, vsys, _ = _setup()

    res_j = jax.jit(lambda s: vs.solve_viscosity(s, cfg_j))(vsys)
    res_m = jax.jit(lambda s: vs.solve_viscosity(s, cfg_m))(vsys)

    assert bool(res_j.converged)
    assert bool(res_m.converged), (
        f"MG-preconditioned CG failed: {int(res_m.iterations)} iters, "
        f"residual {float(res_m.residual)}"
    )
    it_j, it_m = int(res_j.iterations), int(res_m.iterations)
    for a, b in zip(res_j.x, res_m.x):
        np.testing.assert_allclose(
            np.asarray(a), np.asarray(b), atol=5e-4, rtol=1e-3
        )
    # the point of MG: materially fewer iterations, ON a free-surface system
    assert it_m * 2 <= it_j, (it_m, it_j)


def test_pressure_mg_free_surface_faster_same_solution():
    cfg_j, cfg_m, _, psys = _setup()

    res_j = jax.jit(lambda s: ps.solve_pressure(s, cfg_j))(psys)
    res_m = jax.jit(lambda s: ps.solve_pressure(s, cfg_m))(psys)
    assert bool(res_j.converged)
    assert bool(res_m.converged)
    it_j, it_m = int(res_j.iterations), int(res_m.iterations)
    np.testing.assert_allclose(
        np.asarray(res_j.x), np.asarray(res_m.x), atol=5e-4, rtol=1e-3
    )
    assert it_m * 2 <= it_j, (it_m, it_j)


def test_vcycle_preconditioner_is_symmetric():
    """CG requires a symmetric PSD preconditioner: probe <M r1, r2> ==
    <r1, M r2> and <r, M r> > 0 on in-mask random vectors."""
    cfg_j, cfg_m, vsys, psys = _setup()
    rng = np.random.default_rng(1)

    apply_p = jax.jit(lambda r: mg.pressure_mg_preconditioner(psys, cfg_m)(r))
    fluid = np.asarray(psys.fluid)
    r1 = jnp.asarray(rng.normal(size=fluid.shape).astype(np.float32) * fluid)
    r2 = jnp.asarray(rng.normal(size=fluid.shape).astype(np.float32) * fluid)
    a = float(jnp.vdot(apply_p(r1), r2))
    b = float(jnp.vdot(r1, apply_p(r2)))
    np.testing.assert_allclose(a, b, rtol=2e-4)
    assert float(jnp.vdot(r1, apply_p(r1))) > 0

    apply_v = jax.jit(
        lambda r: mg.viscosity_mg_preconditioner(vsys, cfg_m)(r)
    )
    m = [np.asarray(x) for x in vsys.in_mat]
    t1 = tuple(
        jnp.asarray(rng.normal(size=mi.shape).astype(np.float32) * mi)
        for mi in m
    )
    t2 = tuple(
        jnp.asarray(rng.normal(size=mi.shape).astype(np.float32) * mi)
        for mi in m
    )
    dot = lambda x, y: sum(float(jnp.vdot(a, b)) for a, b in zip(x, y))
    a = dot(apply_v(t1), t2)
    b = dot(t1, apply_v(t2))
    np.testing.assert_allclose(a, b, rtol=2e-4)
    assert dot(t1, apply_v(t1)) > 0


def test_galerkin_coarsening_is_exact_rap():
    """The closed-form coarse level must equal P^T A P computed densely."""
    rng = np.random.default_rng(2)
    shape = (4, 4, 4)
    n = 64
    diag = jnp.asarray(rng.uniform(1.0, 3.0, size=shape).astype(np.float32))
    links = []
    for ax in range(3):
        L = rng.uniform(0.0, 1.0, size=shape).astype(np.float32)
        # zero boundary links (as mask gating guarantees at level 0)
        sl = [slice(None)] * 3
        sl[ax] = -1
        L[tuple(sl)] = 0.0
        links.append(jnp.asarray(L))
    level = mg._level(diag, tuple(links))

    # dense fine operator
    A = np.zeros((n, n), np.float32)
    strides = (16, 4, 1)
    dflat = np.asarray(diag).ravel()
    A[np.arange(n), np.arange(n)] = dflat
    for ax in range(3):
        L = np.asarray(links[ax]).ravel()
        for c in range(n):
            j = c + strides[ax]
            if L[c] != 0.0:
                A[c, j] -= L[c]
                A[j, c] -= L[c]

    # dense P: fine cell -> its 2x2x2 aggregate (piecewise constant)
    P = np.zeros((n, 8), np.float32)
    for i in range(4):
        for j in range(4):
            for k in range(4):
                f = (i * 4 + j) * 4 + k
                c = ((i // 2) * 2 + (j // 2)) * 2 + (k // 2)
                P[f, c] = 1.0
    Ac_dense = P.T @ A @ P

    lc = mg._coarsen(level)
    Ac = np.zeros((8, 8), np.float32)
    Ac[np.arange(8), np.arange(8)] = np.asarray(lc.diag).ravel()
    cstrides = (4, 2, 1)
    for ax in range(3):
        L = np.asarray(lc.links[ax]).ravel()
        for c in range(8):
            j = c + cstrides[ax]
            if j < 8 and L[c] != 0.0:
                Ac[c, j] -= L[c]
                Ac[j, c] -= L[c]
    np.testing.assert_allclose(Ac, Ac_dense, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize(
    "shape", [(17, 18, 17), (3, 17, 18, 17), (15, 13, 11)],
    ids=["odd", "odd-batched", "odd-uneven"],
)
def test_vcycle_symmetric_at_odd_sizes(shape):
    """Odd extents pool their last aggregate from one row (_half_onehot)
    and prolong it back cropped; the V(1,1) cycle must stay a symmetric
    positive linear map there, unbatched and batched (the CG contract)."""
    rng = np.random.default_rng(7)
    diag = jnp.asarray(rng.uniform(1, 2, shape).astype(np.float32))
    links = []
    for ax in range(3):
        L = rng.uniform(0, 0.25, shape).astype(np.float32)
        sl = [slice(None)] * len(shape)
        sl[len(shape) - 3 + ax] = -1
        L[tuple(sl)] = 0.0  # no link leaves the grid (premasked systems)
        links.append(jnp.asarray(L))
    cfg = SimConfig(isize=16, jsize=16, ksize=16, dx=1.0 / 16)
    hier = mg.build_hierarchy(diag, tuple(links), cfg)
    assert len(hier.levels) >= 2
    cycle = jax.jit(lambda b: mg.v_cycle(hier, b, 1, 1, 0.8, 1.4))
    r1 = jnp.asarray(rng.normal(size=shape).astype(np.float32))
    r2 = jnp.asarray(rng.normal(size=shape).astype(np.float32))
    out1, out2 = cycle(r1), cycle(r2)
    assert out1.shape == shape
    dot = lambda x, y: float(
        jnp.vdot(x, y, precision=jax.lax.Precision.HIGHEST))
    np.testing.assert_allclose(dot(out1, r2), dot(r1, out2), rtol=2e-4)
    assert dot(r1, out1) > 0
