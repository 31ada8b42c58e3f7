"""Viscosity solver: volume grids and the coupled operator vs dense oracles.

Oracle 1 recomputes the 7 control-volume grids with literal trilinear corner
sampling (the reference's formulation, viscositysolver.cpp:180-270).
Oracle 2 assembles the full sparse system with plain loops following
viscositysolver.cpp:374-664 (states, factors, 14 couplings, solid RHS terms)
and checks the matrix-free apply + RHS entrywise.
"""



import jax
import jax.numpy as jnp
import numpy as np
import pytest

from flipviscosity3d.config import SimConfig
from flipviscosity3d.solvers import viscosity as vs
from tests.test_levelset import oracle_volume_fraction_cube

N = 6
CFG = SimConfig(isize=N, jsize=N, ksize=N, dx=1.0 / N)
DT = 0.01
DX = CFG.dx


def _liquid_phi(seed=0):
    rng = np.random.default_rng(seed)
    ii, jj, kk = np.meshgrid(*(np.arange(N),) * 3, indexing="ij")
    c = (np.stack([ii, jj, kk], -1) + 0.5) / N
    return (
        np.linalg.norm(c - 0.5, axis=-1) - 0.32
        + rng.normal(0, 0.02, c.shape[:-1])
    ).astype(np.float32)


def _oracle_liquid_sample(phi, pos):
    """trilinear at pos - dx/2 with out-of-range corners = 0
    (particlelevelset.cpp:88-92, interpolation.cpp:68-108)."""
    f = np.asarray(pos) / DX - 0.5
    base = np.floor(f).astype(int)
    t = f - base
    total = 0.0
    for di in (0, 1):
        for dj in (0, 1):
            for dk in (0, 1):
                idx = base + [di, dj, dk]
                if all(0 <= idx[a] < N for a in range(3)):
                    v = phi[tuple(idx)]
                else:
                    v = 0.0
                w = (
                    (t[0] if di else 1 - t[0])
                    * (t[1] if dj else 1 - t[1])
                    * (t[2] if dk else 1 - t[2])
                )
                total += w * v
    return total


def _oracle_volumes(phi):
    """viscositysolver.cpp:135-270 with literal corner sampling."""
    valid = np.zeros((N + 1, N + 1, N + 1), bool)
    valid[:N, :N, :N] = phi < 0
    for _ in range(2):
        grown = valid.copy()
        for ax in range(3):
            for s in (1, -1):
                sh = np.roll(valid, s, axis=ax)
                if s == 1:
                    sh[tuple([slice(None)] * ax + [0])] = False
                else:
                    sh[tuple([slice(None)] * ax + [-1])] = False
                grown |= sh
        valid = grown

    h = 0.5 * DX
    starts = {
        "center": (h, h, h), "u": (0, h, h), "v": (h, 0, h), "w": (h, h, 0),
        "edge_u": (h, 0, 0), "edge_v": (0, h, 0), "edge_w": (0, 0, h),
    }
    shapes = {
        "center": (N, N, N), "u": (N + 1, N, N), "v": (N, N + 1, N),
        "w": (N, N, N + 1), "edge_u": (N, N + 1, N + 1),
        "edge_v": (N + 1, N, N + 1), "edge_w": (N + 1, N + 1, N),
    }
    out = {}
    for name, cs in starts.items():
        grid = np.zeros(shapes[name], np.float32)
        for i in range(shapes[name][0]):
            for j in range(shapes[name][1]):
                for k in range(shapes[name][2]):
                    if not valid[i, j, k]:
                        continue
                    centre = np.array(cs) + (np.array([i, j, k]) + 0.5) * DX
                    corners = []
                    for dz in (-h, h):
                        for dy in (-h, h):
                            for dx_ in (-h, h):
                                corners.append(
                                    _oracle_liquid_sample(
                                        phi, centre + [dx_, dy, dz]
                                    )
                                )
                    # order collected: (z,y,x) loops ->
                    # [(-,-,-),(-,-,+),(-,+,-),(-,+,+),(+,-,-)...] in
                    # (x fastest); map to (p000,p100,p010,p110,p001,...)
                    p = corners
                    grid[i, j, k] = oracle_volume_fraction_cube(
                        [p[0], p[1], p[2], p[3], p[4], p[5], p[6], p[7]]
                    )
        out[name] = grid
    return out


def test_volume_grids_match_oracle():
    phi = _liquid_phi()
    got = jax.jit(
        lambda p: vs.compute_volume_grids(p, CFG)
    )(jnp.asarray(phi))
    want = _oracle_volumes(phi)
    for name in want:
        g = np.asarray(getattr(got, name))
        np.testing.assert_allclose(
            g, want[name], atol=2e-5, err_msg=name
        )


# ---------------------------------------------------------------------------
# dense assembly oracle for the coupled system
# ---------------------------------------------------------------------------

def _oracle_assemble(phi, solid_center, visc, u, v, w, volumes):
    """Literal transcription of the reference assembly
    (viscositysolver.cpp:80-123, 276-366, 374-664) in index dictionaries."""
    FLUID, SOLID = 1, 2
    state = {}
    shapes = {"u": (N + 1, N, N), "v": (N, N + 1, N), "w": (N, N, N + 1)}
    for comp, shp in shapes.items():
        s = np.zeros(shp, np.int8)
        for i in range(shp[0]):
            for j in range(shp[1]):
                for k in range(shp[2]):
                    ax = {"u": 0, "v": 1, "w": 2}[comp]
                    idx = (i, j, k)
                    edge = idx[ax] == 0 or idx[ax] == shp[ax] - 1
                    if not edge:
                        prev = list(idx)
                        prev[ax] -= 1
                        tot = solid_center[tuple(prev)] + solid_center[idx]
                    if edge or tot <= 0:
                        s[idx] = SOLID
                    else:
                        s[idx] = FLUID
        state[comp] = s

    vol = volumes

    def vol7(comp, i, j, k):
        if comp == "u":
            return [
                vol["u"][i, j, k], vol["center"][i, j, k],
                vol["center"][i - 1, j, k], vol["edge_w"][i, j + 1, k],
                vol["edge_w"][i, j, k], vol["edge_v"][i, j, k + 1],
                vol["edge_v"][i, j, k],
            ]
        if comp == "v":
            return [
                vol["v"][i, j, k], vol["edge_w"][i + 1, j, k],
                vol["edge_w"][i, j, k], vol["center"][i, j, k],
                vol["center"][i, j - 1, k], vol["edge_u"][i, j, k + 1],
                vol["edge_u"][i, j, k],
            ]
        return [
            vol["w"][i, j, k], vol["edge_v"][i + 1, j, k],
            vol["edge_v"][i, j, k], vol["edge_u"][i, j + 1, k],
            vol["edge_u"][i, j, k], vol["center"][i, j, k],
            vol["center"][i, j, k - 1],
        ]

    rows = {}
    for comp in ("u", "v", "w"):
        for k in range(1, N):
            for j in range(1, N):
                for i in range(1, N):
                    if state[comp][i, j, k] != FLUID:
                        continue
                    if any(x > 0 for x in vol7(comp, i, j, k)):
                        rows[(comp, i, j, k)] = len(rows)

    m = len(rows)
    A = np.zeros((m, m))
    rhs = np.zeros(m)
    factor = DT / (DX * DX)
    vel = {"u": u, "v": v, "w": w}

    def add(row, comp, idx, coeff):
        """matrix.add when FLUID+in-matrix; RHS -= coeff*vel when SOLID."""
        st = state[comp][idx]
        if st == FLUID:
            col = rows.get((comp,) + idx)
            if col is not None:
                A[row, col] += coeff
        elif st == SOLID:
            rhs[row] -= coeff * vel[comp][idx]

    for (comp, i, j, k), row in rows.items():
        if comp == "u":
            v_r = visc[i, j, k]
            v_l = visc[i - 1, j, k]
            v_t = 0.25 * (visc[i - 1, j + 1, k] + visc[i - 1, j, k]
                          + visc[i, j + 1, k] + visc[i, j, k])
            v_b = 0.25 * (visc[i - 1, j, k] + visc[i - 1, j - 1, k]
                          + visc[i, j, k] + visc[i, j - 1, k])
            v_f = 0.25 * (visc[i - 1, j, k + 1] + visc[i - 1, j, k]
                          + visc[i, j, k + 1] + visc[i, j, k])
            v_k = 0.25 * (visc[i - 1, j, k] + visc[i - 1, j, k - 1]
                          + visc[i, j, k] + visc[i, j, k - 1])
            vols = vol7("u", i, j, k)
            fr = 2 * factor * v_r * vols[1]
            fl = 2 * factor * v_l * vols[2]
            ft = factor * v_t * vols[3]
            fb = factor * v_b * vols[4]
            ff = factor * v_f * vols[5]
            fk = factor * v_k * vols[6]
            A[row, row] += vols[0] + fr + fl + ft + fb + ff + fk
            rhs[row] += vols[0] * u[i, j, k]
            add(row, "u", (i + 1, j, k), -fr)
            add(row, "u", (i - 1, j, k), -fl)
            add(row, "u", (i, j + 1, k), -ft)
            add(row, "u", (i, j - 1, k), -fb)
            add(row, "u", (i, j, k + 1), -ff)
            add(row, "u", (i, j, k - 1), -fk)
            add(row, "v", (i, j + 1, k), -ft)
            add(row, "v", (i - 1, j + 1, k), ft)
            add(row, "v", (i, j, k), fb)
            add(row, "v", (i - 1, j, k), -fb)
            add(row, "w", (i, j, k + 1), -ff)
            add(row, "w", (i - 1, j, k + 1), ff)
            add(row, "w", (i, j, k), fk)
            add(row, "w", (i - 1, j, k), -fk)
        elif comp == "v":
            v_r = 0.25 * (visc[i, j - 1, k] + visc[i + 1, j - 1, k]
                          + visc[i, j, k] + visc[i + 1, j, k])
            v_l = 0.25 * (visc[i, j - 1, k] + visc[i - 1, j - 1, k]
                          + visc[i, j, k] + visc[i - 1, j, k])
            v_t = visc[i, j, k]
            v_b = visc[i, j - 1, k]
            v_f = 0.25 * (visc[i, j - 1, k] + visc[i, j - 1, k + 1]
                          + visc[i, j, k] + visc[i, j, k + 1])
            v_k = 0.25 * (visc[i, j - 1, k] + visc[i, j - 1, k - 1]
                          + visc[i, j, k] + visc[i, j, k - 1])
            vols = vol7("v", i, j, k)
            fr = factor * v_r * vols[1]
            fl = factor * v_l * vols[2]
            ft = 2 * factor * v_t * vols[3]
            fb = 2 * factor * v_b * vols[4]
            ff = factor * v_f * vols[5]
            fk = factor * v_k * vols[6]
            A[row, row] += vols[0] + fr + fl + ft + fb + ff + fk
            rhs[row] += vols[0] * v[i, j, k]
            add(row, "v", (i + 1, j, k), -fr)
            add(row, "v", (i - 1, j, k), -fl)
            add(row, "v", (i, j + 1, k), -ft)
            add(row, "v", (i, j - 1, k), -fb)
            add(row, "v", (i, j, k + 1), -ff)
            add(row, "v", (i, j, k - 1), -fk)
            add(row, "u", (i + 1, j, k), -fr)
            add(row, "u", (i + 1, j - 1, k), fr)
            add(row, "u", (i, j, k), fl)
            add(row, "u", (i, j - 1, k), -fl)
            add(row, "w", (i, j, k + 1), -ff)
            add(row, "w", (i, j - 1, k + 1), ff)
            add(row, "w", (i, j, k), fk)
            add(row, "w", (i, j - 1, k), -fk)
        else:
            v_r = 0.25 * (visc[i, j, k] + visc[i, j, k - 1]
                          + visc[i + 1, j, k] + visc[i + 1, j, k - 1])
            v_l = 0.25 * (visc[i, j, k] + visc[i, j, k - 1]
                          + visc[i - 1, j, k] + visc[i - 1, j, k - 1])
            v_t = 0.25 * (visc[i, j, k] + visc[i, j, k - 1]
                          + visc[i, j + 1, k] + visc[i, j + 1, k - 1])
            v_b = 0.25 * (visc[i, j, k] + visc[i, j, k - 1]
                          + visc[i, j - 1, k] + visc[i, j - 1, k - 1])
            v_f = visc[i, j, k]
            v_k = visc[i, j, k - 1]
            vols = vol7("w", i, j, k)
            fr = factor * v_r * vols[1]
            fl = factor * v_l * vols[2]
            ft = factor * v_t * vols[3]
            fb = factor * v_b * vols[4]
            ff = 2 * factor * v_f * vols[5]
            fk = 2 * factor * v_k * vols[6]
            A[row, row] += vols[0] + fr + fl + ft + fb + ff + fk
            rhs[row] += vols[0] * w[i, j, k]
            add(row, "w", (i + 1, j, k), -fr)
            add(row, "w", (i - 1, j, k), -fl)
            add(row, "w", (i, j + 1, k), -ft)
            add(row, "w", (i, j - 1, k), -fb)
            add(row, "w", (i, j, k + 1), -ff)
            add(row, "w", (i, j, k - 1), -fk)
            add(row, "u", (i + 1, j, k), -fr)
            add(row, "u", (i + 1, j, k - 1), fr)
            add(row, "u", (i, j, k), fl)
            add(row, "u", (i, j, k - 1), -fl)
            add(row, "v", (i, j + 1, k), -ft)
            add(row, "v", (i, j + 1, k - 1), ft)
            add(row, "v", (i, j, k), fb)
            add(row, "v", (i, j, k - 1), -fb)
    return state, rows, A, rhs


def test_coupled_operator_matches_dense_oracle():
    rng = np.random.default_rng(5)
    phi = _liquid_phi(5)
    # a solid floor: solid below y = 1.5 cells
    ii, jj, kk = np.meshgrid(*(np.arange(N),) * 3, indexing="ij")
    solid_center = ((jj + 0.5) * DX - 1.5 * DX).astype(np.float32)
    visc = rng.uniform(0.5, 5.0, size=(N + 1, N + 1, N + 1)).astype(np.float32)
    u = rng.normal(size=(N + 1, N, N)).astype(np.float32)
    v = rng.normal(size=(N, N + 1, N)).astype(np.float32)
    w = rng.normal(size=(N, N, N + 1)).astype(np.float32)

    volumes_j = jax.jit(lambda p: vs.compute_volume_grids(p, CFG))(
        jnp.asarray(phi)
    )
    volumes_np = {f: np.asarray(getattr(volumes_j, f)) for f in volumes_j._fields}

    state, rows, A, rhs = _oracle_assemble(
        phi, solid_center, visc, u, v, w, volumes_np
    )
    assert len(rows) > 100

    states_j = jax.jit(lambda s: vs.compute_face_states(s, CFG))(
        jnp.asarray(solid_center)
    )
    # face states agree
    np.testing.assert_array_equal(
        np.asarray(states_j.solid_u), np.asarray(state["u"]) == 2
    )
    np.testing.assert_array_equal(
        np.asarray(states_j.solid_v), np.asarray(state["v"]) == 2
    )

    sys = jax.jit(
        lambda uu, vv, ww, vol, vis: vs.build_viscosity_system(
            uu, vv, ww, vol, states_j, vis, DT, CFG
        )
    )(jnp.asarray(u), jnp.asarray(v), jnp.asarray(w), volumes_j,
      jnp.asarray(visc))

    # row masks agree
    got_rows = {
        "u": np.asarray(sys.in_mat[0]),
        "v": np.asarray(sys.in_mat[1]),
        "w": np.asarray(sys.in_mat[2]),
    }
    want_rows = {c: np.zeros_like(got_rows[c]) for c in got_rows}
    for (comp, i, j, k) in rows:
        want_rows[comp][i, j, k] = True
    for c in got_rows:
        np.testing.assert_array_equal(got_rows[c], want_rows[c], err_msg=c)

    # RHS matches
    rhs_got = {c: np.asarray(r) for c, r in zip("uvw", sys.rhs)}
    for (comp, i, j, k), row in rows.items():
        assert rhs_got[comp][i, j, k] == pytest.approx(
            rhs[row], rel=2e-3, abs=2e-4
        ), (comp, i, j, k)

    # operator matches on random vectors
    apply_fn = jax.jit(lambda x: vs.apply_viscosity_matrix(sys, x, CFG))
    for trial in range(2):
        xv = rng.normal(size=len(rows))
        xg = {c: np.zeros_like(rhs_got[c]) for c in "uvw"}
        for (comp, i, j, k), row in rows.items():
            xg[comp][i, j, k] = xv[row]
        ys = apply_fn(tuple(jnp.asarray(xg[c]) for c in "uvw"))
        y_dense = A @ xv
        yg = {c: np.asarray(y) for c, y in zip("uvw", ys)}
        for (comp, i, j, k), row in rows.items():
            assert yg[comp][i, j, k] == pytest.approx(
                y_dense[row], rel=3e-3, abs=3e-4
            ), (trial, comp, i, j, k)

    # the dense system is symmetric
    np.testing.assert_allclose(A, A.T, atol=1e-6)


def test_viscous_damping_sanity():
    """A shear velocity profile in a fully-liquid box must be smoothed (the
    operator acts like implicit diffusion) and the solve must converge."""
    phi = np.full((N, N, N), -1.0, np.float32)  # all liquid
    solid_center = np.full((N, N, N), 1.0, np.float32)  # no solids
    visc = np.full((N + 1, N + 1, N + 1), 2.0, np.float32)
    jjj = np.arange(N)[None, :, None] * np.ones((N + 1, 1, N))
    u = np.sin(jjj / N * 2 * np.pi).astype(np.float32)
    v = np.zeros((N, N + 1, N), np.float32)
    w = np.zeros((N, N, N + 1), np.float32)

    states = jax.jit(lambda s: vs.compute_face_states(s, CFG))(
        jnp.asarray(solid_center)
    )

    @jax.jit
    def run(uu, vv, ww, p, vis):
        volumes = vs.compute_volume_grids(p, CFG)
        sys = vs.build_viscosity_system(uu, vv, ww, volumes, states, vis, DT, CFG)
        res = vs.solve_viscosity(sys, CFG)
        return vs.apply_viscosity_solution(uu, vv, ww, sys, res, CFG), res

    (un, vn, wn), res = run(
        jnp.asarray(u), jnp.asarray(v), jnp.asarray(w), jnp.asarray(phi),
        jnp.asarray(visc),
    )
    assert bool(res.converged)
    un = np.asarray(un)
    # interior shear amplitude decreased, sign structure preserved
    inner = un[2:-2, 1:-1, 1:-1]
    orig = u[2:-2, 1:-1, 1:-1]
    assert np.abs(inner).max() < np.abs(orig).max()
    mask = np.abs(orig) > 0.5
    assert (np.sign(inner[mask]) == np.sign(orig[mask])).all()
