"""Pressure solver: matrix-free operator vs direct dense assembly, solve
quality, and pressure application.

The oracle assembles the variational ghost-fluid system with plain numpy
loops following the reference's rules exactly
(/root/reference/src/pressuresolver.cpp:196-322); the matrix-free stencil
must agree to float32 roundoff.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from flipviscosity3d.config import SimConfig
from flipviscosity3d.solvers import pressure as ps

N = 8
CFG = SimConfig(isize=N, jsize=N, ksize=N, dx=1.0 / N)
DT = 0.01


def oracle_fraction_inside(l, r):
    if l < 0 and r < 0:
        return 1.0
    if l < 0 <= r:
        return l / (l - r)
    if r < 0 <= l:
        return r / (r - l)
    return 0.0


def _make_scene(seed=0):
    rng = np.random.default_rng(seed)
    # liquid blob: sphere of radius 0.3 at center, plus noise
    ii, jj, kk = np.meshgrid(*(np.arange(N),) * 3, indexing="ij")
    c = (np.stack([ii, jj, kk], -1) + 0.5) / N
    phi = (
        np.linalg.norm(c - 0.5, axis=-1) - 0.3 + rng.normal(0, 0.02, c.shape[:-1])
    ).astype(np.float32)
    u = rng.normal(size=(N + 1, N, N)).astype(np.float32)
    v = rng.normal(size=(N, N + 1, N)).astype(np.float32)
    w = rng.normal(size=(N, N, N + 1)).astype(np.float32)
    wu = rng.uniform(0, 1, size=(N + 1, N, N)).astype(np.float32)
    wv = rng.uniform(0, 1, size=(N, N + 1, N)).astype(np.float32)
    ww = rng.uniform(0, 1, size=(N, N, N + 1)).astype(np.float32)
    return phi, u, v, w, wu, wv, ww


def _oracle_system(phi, u, v, w, wu, wv, ww):
    """Dense assembly per pressuresolver.cpp:196-322."""
    dx = CFG.dx
    scale = DT / (dx * dx)
    cells = [
        (i, j, k)
        for k in range(1, N - 1)
        for j in range(1, N - 1)
        for i in range(1, N - 1)
        if phi[i, j, k] < 0
    ]
    index = {c: n for n, c in enumerate(cells)}
    m = len(cells)
    A = np.zeros((m, m))
    b = np.zeros(m)

    def face_theta(axis, fi, fj, fk):
        if axis == 0:
            val = oracle_fraction_inside(phi[fi - 1, fj, fk], phi[fi, fj, fk])
        elif axis == 1:
            val = oracle_fraction_inside(phi[fi, fj - 1, fk], phi[fi, fj, fk])
        else:
            val = oracle_fraction_inside(phi[fi, fj, fk - 1], phi[fi, fj, fk])
        return max(val, CFG.minfrac)

    for (i, j, k), row in index.items():
        div = 0.0
        div -= wu[i + 1, j, k] * u[i + 1, j, k]
        div += wu[i, j, k] * u[i, j, k]
        div -= wv[i, j + 1, k] * v[i, j + 1, k]
        div += wv[i, j, k] * v[i, j, k]
        div -= ww[i, j, k + 1] * w[i, j, k + 1]
        div += ww[i, j, k] * w[i, j, k]
        b[row] = div / dx

        neighbors = [
            (wu[i + 1, j, k], (i + 1, j, k), (0, i + 1, j, k)),
            (wu[i, j, k], (i - 1, j, k), (0, i, j, k)),
            (wv[i, j + 1, k], (i, j + 1, k), (1, i, j + 1, k)),
            (wv[i, j, k], (i, j - 1, k), (1, i, j, k)),
            (ww[i, j, k + 1], (i, j, k + 1), (2, i, j, k + 1)),
            (ww[i, j, k], (i, j, k - 1), (2, i, j, k)),
        ]
        for wgt, nb, face in neighbors:
            term = wgt * scale
            if phi[nb] < 0:
                A[row, row] += term
                if nb in index:
                    A[row, index[nb]] -= term
            else:
                A[row, row] += term / face_theta(*face)
    return cells, index, A, b


@functools.partial(jax.jit, static_argnames=())
def _build(phi, u, v, w, wu, wv, ww):
    return ps.build_pressure_system(u, v, w, phi, wu, wv, ww, DT, CFG)


def test_matrix_free_matches_dense_oracle():
    phi, u, v, w, wu, wv, ww = _make_scene()
    cells, index, A, b = _oracle_system(phi, u, v, w, wu, wv, ww)
    assert len(cells) > 50

    sys = _build(*(jnp.asarray(x) for x in (phi, u, v, w, wu, wv, ww)))

    # RHS match
    b_grid = np.asarray(sys.b)
    for c, row in index.items():
        assert b_grid[c] == pytest.approx(b[row], rel=1e-4, abs=1e-5)

    # operator match on random vectors
    rng = np.random.default_rng(1)
    apply_fn = jax.jit(lambda x: ps.apply_pressure_matrix(sys, x))
    for _ in range(3):
        xv = rng.normal(size=len(cells))
        x_grid = np.zeros((N, N, N), np.float32)
        for c, row in index.items():
            x_grid[c] = xv[row]
        y_grid = np.asarray(apply_fn(jnp.asarray(x_grid)))
        y_dense = A @ xv
        for c, row in index.items():
            assert y_grid[c] == pytest.approx(
                y_dense[row], rel=2e-3, abs=2e-4
            ), c
    # off-row outputs are zero
    mask = np.asarray(sys.fluid)
    y = np.asarray(apply_fn(jnp.asarray(np.ones((N, N, N), np.float32) * mask)))
    assert (y[~mask] == 0).all()

    # dense matrix is symmetric positive (semi)definite
    np.testing.assert_allclose(A, A.T, atol=1e-8)
    eigs = np.linalg.eigvalsh(A)
    assert eigs.min() > -1e-8


def test_solve_reduces_divergence():
    phi, u, v, w, wu, wv, ww = _make_scene(seed=2)
    # fully open weights: classic free-surface projection
    wu[:], wv[:], ww[:] = 1.0, 1.0, 1.0
    arrs = tuple(jnp.asarray(x) for x in (phi, u, v, w, wu, wv, ww))
    sys = _build(*arrs)
    res = jax.jit(lambda s: ps.solve_pressure(s, CFG))(sys)
    # the solve converged well below the rhs magnitude
    assert float(res.residual) < 1e-4 * float(jnp.max(jnp.abs(sys.b)) + 1e-9)

    # applying the pressure makes the weighted divergence on rows ~ 0
    un, vn, wn, *_ = jax.jit(
        lambda p, u, v, w: ps.apply_pressure(
            u, v, w, p, arrs[0], arrs[4], arrs[5], arrs[6], DT, CFG
        )
    )(res.x, arrs[1], arrs[2], arrs[3])
    un, vn, wn = np.asarray(un), np.asarray(vn), np.asarray(wn)
    fluid = np.asarray(sys.fluid)
    div = (
        un[:-1] - un[1:] + vn[:, :-1] - vn[:, 1:] + wn[:, :, :-1] - wn[:, :, 1:]
    ) / CFG.dx
    # interior fluid cells whose entire 6-face set is "live": small residual
    # divergence (ghost-fluid faces at the surface carry theta corrections)
    deep = fluid.copy()
    for ax in range(3):
        deep &= np.roll(fluid, 1, ax) & np.roll(fluid, -1, ax)
    if deep.any():
        assert np.abs(div[deep]).max() < 5e-3


def test_apply_pressure_zeroes_invalid_faces():
    phi, u, v, w, wu, wv, ww = _make_scene(seed=3)
    arrs = tuple(jnp.asarray(x) for x in (phi, u, v, w, wu, wv, ww))
    sys = _build(*arrs)
    res = jax.jit(lambda s: ps.solve_pressure(s, CFG))(sys)
    un, vn, wn, vu, vv_, vw = jax.jit(
        lambda p, u, v, w: ps.apply_pressure(
            u, v, w, p, arrs[0], arrs[4], arrs[5], arrs[6], DT, CFG
        )
    )(res.x, arrs[1], arrs[2], arrs[3])
    un = np.asarray(un)
    vu = np.asarray(vu)
    assert (un[~vu] == 0).all()
    # boundary faces are always invalid (i in {0, I})
    assert not vu[0].any() and not vu[-1].any()
