"""Galerkin aggregation multigrid V-cycle preconditioner for 7-point blocks.

The reference preconditions both solvers with MIC(0)
(/root/reference/src/pcgsolver/pcgsolver.h:62-178,
/root/reference/src/pressuresolver.cpp:324-462) — a sequential triangular
solve. This module is the data-parallel replacement: a
multigrid V-cycle used as the CG preconditioner for the pressure system and
for the three diagonal blocks of the coupled viscosity system.

Why aggregation (piecewise-constant) transfers: with P = "each fine cell
takes its coarse parent's value" over 2x2x2 blocks and R = P^T, the Galerkin
coarse operator A_c = P^T A P of any 7-point operator is again *exactly* a
7-point operator (cells of edge/corner-adjacent blocks are never face
neighbors), so every level can be computed in closed form as sum-poolings of
the fine diagonal and link grids:

    L_c[I -> I+ax] = sum of fine links crossing the block face
                     (odd-index links, 1x2x2 pooled)
    diag_c[I]      = sum of fine diagonals in the block
                     - 2 * sum of links internal to the block

This makes every level the exact P^T A P — in particular the ghost-fluid /
partial-volume free-surface rows are *summed*, not rediscretized, which is
what the round-1 semi-geometric coarsening got wrong (it rescaled pooled
links as a resized Laplacian and stalled on free-surface scenes). A_c is SPD
whenever A is PSD, so the V-cycle with symmetric smoothing is a valid SPD
preconditioner at any depth.

Pure aggregation transfers underestimate smooth corrections (the classical
O(1-1/cycle) aggregation deficiency), compensated here the standard way with
an over-correction factor on the prolongated coarse update (cfg.mg_coarse_scale,
~1.4-1.9 optimal for 3D Poisson-like operators) — the scaling keeps the
preconditioner symmetric.

Shape notes: every operation here treats the LAST THREE axes as spatial
and broadcasts over leading batch axes. The three viscosity component blocks
are padded to a common shape and stacked into one (3, I', J', K') hierarchy,
so the many small kernels of the deep levels launch once for all three
components instead of three times. The coarsest level is solved with an
explicit (batched) dense inverse instead of many tiny smoothing sweeps.
Every f32 contraction here passes Precision.HIGHEST, so the preconditioner
is the same fixed linear map on every backend (no TF32 rounding).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

_AXES = (0, 1, 2)  # spatial axes, counted from the end (ndim-3 + ax)


def _shift(x, off3, fill=0.0):
    """x shifted by (oi,oj,ok) on its last three axes, `fill` out of range.
    Batched generalization of ops.grids.shifted_read (same semantics)."""
    nb = x.ndim - 3
    pads = [(0, 0)] * nb
    slices = [slice(None)] * nb
    for ax in range(3):
        o = int(off3[ax])
        n = x.shape[nb + ax]
        lo = max(0, -o)
        hi = min(n, n - o)
        hi = max(hi, lo)
        slices.append(slice(lo + o, hi + o))
        pads.append((lo, n - hi))
    block = x[tuple(slices)]
    if any(p != (0, 0) for p in pads):
        block = jnp.pad(block, pads, constant_values=fill)
    return block


def _off(axis, sign):
    o = [0, 0, 0]
    o[axis] = sign
    return tuple(o)


class MGLevel(NamedTuple):
    diag: jnp.ndarray
    links: tuple       # per axis: L[c] >= 0 couples c <-> c+ax_hat, A[c,c+ax] = -L[c]
    inv_diag: jnp.ndarray


def _level(diag, links):
    inv = jnp.where(diag > 0, 1.0 / jnp.where(diag == 0, 1.0, diag), 0.0)
    return MGLevel(diag, links, inv)


def _apply(level: MGLevel, x):
    """y = diag*x - sum_ax (L*x(+ax) + shifted(L*x)). Symmetric by design."""
    y = level.diag * x
    for ax in _AXES:
        L = level.links[ax]
        y = y - L * _shift(x, _off(ax, +1))
        y = y - _shift(L * x, _off(ax, -1))
    return y


def _half_onehot(n, dtype):
    """(n, ceil(n/2)) 0/1 matrix M[j, m] = 1 where j//2 == m. For odd n the
    last aggregate sees one row — pooling an odd extent zero-pads for
    free, so callers never jnp.pad the minor dims."""
    j = jax.lax.broadcasted_iota(jnp.int32, (n, (n + 1) // 2), 0)
    m = jax.lax.broadcasted_iota(jnp.int32, (n, (n + 1) // 2), 1)
    return (j // 2 == m).astype(dtype)


def _pool_sum(a):
    """2x2x2 sum pooling = R (restriction) for piecewise-constant aggregates.

    The two MINOR axes pool via one-hot contractions, not reshape+sum.
    Two successive dots restore the axis order with no transpose (contract
    j -> (..., i/2, k, j/2), then the now-minor k -> (..., i/2, j/2, k/2));
    the major i axis reshapes, and odd minor extents fold into the one-hot
    (no jnp.pad). HIGHEST keeps the f32 sums exact (the one-hot is 0/1).
    Whether the plain reshape+sum form is faster on a GPU is an open
    measurement (ROADMAP, Design 3)."""
    s = a.shape
    lead = s[:-3]
    i, j, k = s[-3], s[-2], s[-1]
    if i % 2:
        a = jnp.pad(a, [(0, 0)] * (a.ndim - 3) + [(0, 1), (0, 0), (0, 0)])
        i += 1
    a = a.reshape(lead + (i // 2, 2, j, k)).sum(axis=-3)
    for n in (j, k):
        a = jax.lax.dot_general(
            a, _half_onehot(n, a.dtype),
            (((a.ndim - 2,), (0,)), ((), ())),
            precision=jax.lax.Precision.HIGHEST,
        )
    return a


def _prolong(a, fine_spatial):
    """P: replicate each coarse cell into its 2x2x2 block (R^T exactly).

    The two MINOR axes replicate via one-hot contractions (the exact
    transpose of _pool_sum's trick, same axis-order restoration); only the
    MAJOR i axis uses broadcast+reshape. Each one-hot row holds exactly one
    1, so HIGHEST reproduces the replication bit-exactly."""
    lead = a.shape[:-3]
    i, j, k = a.shape[-3], a.shape[-2], a.shape[-1]
    fi, fj, fk = fine_spatial
    b = jnp.broadcast_to(
        a[..., :, None, :, :], lead + (i, 2, j, k)
    ).reshape(lead + (2 * i, j, k))[..., :fi, :, :]
    for n_f in (fj, fk):
        b = jax.lax.dot_general(
            b, _half_onehot(n_f, b.dtype),
            (((b.ndim - 2,), (1,)), ((), ())),
            precision=jax.lax.Precision.HIGHEST,
        )
    return b


def _parity_mask(x, spatial_axis):
    """1.0 at odd indices along the given spatial axis (0..2 from the end),
    broadcastable against x (links crossing an aggregate face)."""
    ax = x.ndim - 3 + spatial_axis
    n = x.shape[ax]
    idx = jnp.arange(n, dtype=jnp.int32) % 2
    view = [1] * x.ndim
    view[ax] = n
    return idx.reshape(view).astype(x.dtype)


def _coarsen(level: MGLevel) -> MGLevel:
    """Exact Galerkin A_c = P^T A P, in closed form (see module docstring)."""
    diag, links = level.diag, level.links
    new_links = []
    internal_total = 0.0
    for ax in _AXES:
        L = links[ax]
        odd = _parity_mask(L, ax)
        new_links.append(_pool_sum(L * odd))
        internal_total = internal_total + _pool_sum(L * (1.0 - odd))
    diag_c = _pool_sum(diag) - 2.0 * internal_total
    return _level(diag_c, tuple(new_links))


def _dense_coarse_inverse(level: MGLevel):
    """Explicit symmetric inverse of the coarsest operator (a few hundred
    rows per batch entry). Off-mask rows (diag == 0 after coarsening) get an
    identity row so the inverse exists; they only ever see zero residuals.
    Computed once per solve; each V-cycle's coarse solve is then a single
    small matmul instead of dozens of tiny smoothing kernels.
    """
    spatial = level.diag.shape[-3:]
    lead = level.diag.shape[:-3]
    n = spatial[0] * spatial[1] * spatial[2]
    diag_flat = level.diag.reshape(lead + (n,))
    eye = jnp.arange(n)

    def build_one(dflat, links_flat):
        A = jnp.zeros((n, n), level.diag.dtype)
        # 1e-5 relative diagonal shift (Tikhonov): a fully enclosed liquid
        # (no free surface) makes the pressure system pure-Neumann, so the
        # Galerkin coarse operator is exactly singular (constant nullspace)
        # and a plain inverse would inject inf/NaN into every solve. The
        # shifted inverse stays SPD and is still an excellent preconditioner.
        A = A.at[eye, eye].set(jnp.where(dflat > 0, dflat * (1.0 + 1e-5), 1.0))
        strides = (spatial[1] * spatial[2], spatial[2], 1)
        for ax in _AXES:
            # boundary links are zero by construction, so the wrapped flat
            # index of the last cell along `ax` only ever adds zeros
            L = links_flat[ax]
            j = eye + strides[ax]
            valid = j < n
            jc = jnp.where(valid, j, 0)
            Lv = jnp.where(valid, L, 0.0)
            A = A.at[eye, jc].add(-Lv)
            A = A.at[jc, eye].add(-Lv)
        inv = jnp.linalg.inv(A)
        return 0.5 * (inv + inv.T)  # exact symmetry for CG

    links_flat = tuple(L.reshape(lead + (n,)) for L in level.links)
    if not lead:
        return build_one(diag_flat, links_flat)
    fn = build_one
    for _ in lead:
        fn = jax.vmap(fn)
    return fn(diag_flat, links_flat)


class MGHierarchy(NamedTuple):
    levels: tuple
    coarse_inv: jnp.ndarray | None  # None -> smooth the coarsest level


_DENSE_COARSE_MAX_CELLS = 4096


def build_hierarchy(diag, links, cfg) -> MGHierarchy:
    """Level hierarchy from the premasked fine operator; coarsening stops
    once the grid fits a direct dense solve (min dim <= mg_coarse_size).
    If the caller caps mg_max_levels before the grid is that small, the
    coarsest level falls back to smoothing sweeps (a dense inverse of a big
    level would be quadratic in its cell count)."""
    levels = [_level(diag, links)]
    for _ in range(cfg.mg_max_levels - 1):
        if min(levels[-1].diag.shape[-3:]) <= cfg.mg_coarse_size:
            break
        levels.append(_coarsen(levels[-1]))
    coarse = levels[-1]
    n_coarse = int(
        coarse.diag.shape[-3] * coarse.diag.shape[-2] * coarse.diag.shape[-1]
    )
    inv = (
        _dense_coarse_inverse(coarse)
        if n_coarse <= _DENSE_COARSE_MAX_CELLS
        else None
    )
    return MGHierarchy(tuple(levels), inv)


def _smooth(level: MGLevel, x, b, iters: int, omega: float):
    for _ in range(iters):
        r = b - _apply(level, x)
        x = x + omega * level.inv_diag * r
    return x


def _coarse_solve(hier: MGHierarchy, b, pre, post, omega):
    level = hier.levels[-1]
    if hier.coarse_inv is None:
        return _smooth(level, jnp.zeros_like(b), b, 2 * (pre + post), omega)
    spatial = b.shape[-3:]
    lead = b.shape[:-3]
    n = spatial[0] * spatial[1] * spatial[2]
    bf = b.reshape(lead + (n,))
    xf = jnp.einsum("...ij,...j->...i", hier.coarse_inv, bf,
                    precision=jax.lax.Precision.HIGHEST)
    return xf.reshape(b.shape)


def v_cycle(hier: MGHierarchy, b, pre: int, post: int, omega: float,
            coarse_scale: float):
    """One V(pre,post) cycle from x=0; symmetric linear operator in b.
    Runs under the "v_cycle" named scope (trace attribution)."""
    levels = hier.levels

    def cycle(lvl: int, b):
        level = levels[lvl]
        if lvl == len(levels) - 1:
            return _coarse_solve(hier, b, pre, post, omega)
        x = _smooth(level, jnp.zeros_like(b), b, pre, omega)
        r = b - _apply(level, x)
        xc = cycle(lvl + 1, _pool_sum(r))
        x = x + coarse_scale * _prolong(xc, b.shape[-3:])
        x = _smooth(level, x, b, post, omega)
        return x

    with jax.named_scope("v_cycle"):
        return cycle(0, b)


def component_links(dir_factors, mask):
    """Undirected link grids of one component's own 7-point block.

    dir_factors holds the premasked directional factor grids {"r","l","t",
    "b","f","k"}; for an in-mask pair the '+' directional factor equals the
    neighbor's '-' one (the system is symmetric,
    /root/reference/src/viscositysolver.cpp:397-446), so the link is the '+'
    factor gated by both masks.
    """
    mask_f = mask.astype(dir_factors["r"].dtype)
    plus_keys = ("r", "t", "f")
    return tuple(
        dir_factors[k] * mask_f * _shift(mask_f, _off(ax, +1))
        for ax, k in zip(_AXES, plus_keys)
    )


def _pad_to(a, spatial):
    pads = [(0, 0)] * (a.ndim - 3) + [
        (0, spatial[i] - a.shape[a.ndim - 3 + i]) for i in range(3)
    ]
    if any(p != (0, 0) for p in pads):
        a = jnp.pad(a, pads)
    return a


def viscosity_mg_preconditioner(sys, cfg):
    """Block-diagonal multigrid preconditioner for the coupled viscosity
    system: each velocity component is preconditioned by a V-cycle on its own
    7-point diagonal block (cross-component couplings are left to the outer
    CG; they are bounded by the same-component ones, so the block V-cycle
    still collapses the stiff dt*mu/dx^2 spectrum that drives iteration
    counts).

    The three blocks are padded to the common (I+1, J+1, K+1) staggered
    superset shape and stacked on a leading batch axis: one hierarchy, one
    set of V-cycle kernels for all three components (a third of the
    launches). Padding rows carry zero diagonal and links, so
    they stay exactly zero through the cycle."""
    common = (cfg.isize + 1, cfg.jsize + 1, cfg.ksize + 1)
    diags = []
    links3 = []
    for c in range(3):
        links = component_links(sys.factors[c], sys.in_mat[c])
        diags.append(_pad_to(sys.diag[c], common))
        links3.append(tuple(_pad_to(L, common) for L in links))
    diag_b = jnp.stack(diags)
    links_b = tuple(jnp.stack([links3[c][ax] for c in range(3)])
                    for ax in _AXES)
    hier = build_hierarchy(diag_b, links_b, cfg)

    def apply_M(r):
        rb = jnp.stack([
            _pad_to(jnp.where(m, ri, 0.0), common)
            for ri, m in zip(r, sys.in_mat)
        ])
        xb = v_cycle(
            hier, rb, cfg.mg_pre_smooth, cfg.mg_post_smooth,
            cfg.mg_omega, cfg.mg_coarse_scale,
        )
        return tuple(
            jnp.where(
                m,
                xb[c][: m.shape[0], : m.shape[1], : m.shape[2]],
                0.0,
            )
            for c, m in enumerate(sys.in_mat)
        )

    return apply_M


def pressure_mg_preconditioner(sys, cfg):
    """Multigrid preconditioner for the 7-point ghost-fluid pressure system
    (the reference uses MIC(0) here, pressuresolver.cpp:324-462). plus_*
    grids store A[c, c+ax] (negative for fluid-fluid couplings); gate by the
    row mask on both sides so links only couple actual rows."""
    fluid_f = sys.fluid.astype(sys.diag.dtype)
    links = tuple(
        (-plus) * fluid_f * _shift(fluid_f, _off(ax, +1))
        for ax, plus in zip(_AXES, (sys.plus_i, sys.plus_j, sys.plus_k))
    )
    diag = jnp.where(sys.fluid, sys.diag, 0.0)
    hier = build_hierarchy(diag, links, cfg)

    def apply_M(r):
        return jnp.where(
            sys.fluid,
            v_cycle(
                hier, jnp.where(sys.fluid, r, 0.0),
                cfg.mg_pre_smooth, cfg.mg_post_smooth,
                cfg.mg_omega, cfg.mg_coarse_scale,
            ),
            0.0,
        )

    return apply_M
