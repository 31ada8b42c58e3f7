"""Matrix-free preconditioned conjugate gradient over grid pytrees.

The reference uses two CPU-sequential MIC(0)-preconditioned CG solvers
(/root/reference/src/pressuresolver.cpp:521-567 and
/root/reference/src/pcgsolver/pcgsolver.h:241-295). MIC(0) factorization and
its triangular solves are inherently sequential, so this build keeps the
same CG iteration structure but swaps in fully-parallel preconditioners
(multigrid or Jacobi); each iteration is a stencil apply + reductions under
one jit.

Operands are pytrees of grids (a single array for pressure; a (u, v, w)
tuple for the coupled viscosity system), so the same loop serves both.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp
from jax import lax


def _tree_dot(a, b, axis_name=None, mask=None):
    leaves_a = jax.tree.leaves(a)
    leaves_b = jax.tree.leaves(b)
    if mask is None:
        # HIGHEST: a default-precision f32 dot may round its inputs
        # (TF32 on tensor-core GPUs), which would perturb CG's alpha/beta
        d = sum(
            jnp.vdot(x, y, precision=lax.Precision.HIGHEST)
            for x, y in zip(leaves_a, leaves_b)
        )
    else:
        # where-based masking: halo rows may hold inf/NaN garbage and
        # multiplying by a 0 mask would keep NaN (0*inf)
        leaves_m = jax.tree.leaves(mask)
        d = sum(
            jnp.sum(jnp.where(m > 0, x * y, 0.0))
            for x, y, m in zip(leaves_a, leaves_b, leaves_m)
        )
    if axis_name is not None:
        d = lax.psum(d, axis_name)
    return d


def _tree_absmax(a, axis_name=None, mask=None):
    leaves = jax.tree.leaves(a)
    if mask is None:
        m = jnp.max(jnp.stack([jnp.max(jnp.abs(x)) for x in leaves]))
    else:
        leaves_m = jax.tree.leaves(mask)
        m = jnp.max(
            jnp.stack([
                jnp.max(jnp.where(mm > 0, jnp.abs(x), 0.0))
                for x, mm in zip(leaves, leaves_m)
            ])
        )
    if axis_name is not None:
        m = lax.pmax(m, axis_name)
    return m


def _tree_axpy(alpha, x, y):
    return jax.tree.map(lambda xi, yi: yi + alpha * xi, x, y)


class PCGResult(NamedTuple):
    x: object           # solution pytree
    iterations: jnp.ndarray
    residual: jnp.ndarray  # final inf-norm of the residual
    converged: jnp.ndarray


def pcg(
    apply_A: Callable,
    b,
    apply_M: Callable,
    tol,
    max_iterations: int,
    x0=None,
    axis_name=None,
    reduce_mask=None,
) -> PCGResult:
    """Solve A x = b with preconditioned CG.

    Follows the reference CG structure (pressuresolver.cpp:521-567):
    convergence test is on the residual inf-norm against an absolute `tol`
    (callers fold relative scaling into tol). Runs under lax.while_loop with
    an iteration cap; always returns the current iterate (the reference also
    returns the partial solution when the pressure solve hits max
    iterations).

    Unlike the reference (which always starts from zero), callers may pass a
    warm-start x0; CG converges to the same solution with fewer iterations
    when x0 is close (e.g. the pre-solve velocity field for the viscosity
    system).

    When running shard-local operands inside shard_map, pass `axis_name`:
    the CG reductions (dots, inf-norm) become psum/pmax collectives while
    apply_A/apply_M stay whatever halo-exchanging callables the caller built.
    `reduce_mask` (a pytree of 0/1 float arrays matching b) restricts the
    reductions to locally-OWNED rows so halo rows are not double-counted.
    """
    tol = jnp.asarray(tol, jnp.float32)
    if x0 is None:
        x0 = jax.tree.map(jnp.zeros_like, b)
        r0 = b
    else:
        Ax0 = apply_A(x0)
        r0 = jax.tree.map(lambda bi, ai: bi - ai, b, Ax0)
    z0 = apply_M(r0)
    sigma0 = _tree_dot(z0, r0, axis_name, reduce_mask)
    res0 = _tree_absmax(r0, axis_name, reduce_mask)

    def cond(state):
        _, _, _, _, it, res = state
        return (res > tol) & (it < max_iterations)

    def body(state):
        x, r, s, sigma, it, _ = state
        As = apply_A(s)
        denom = _tree_dot(s, As, axis_name, reduce_mask)
        alpha = sigma / jnp.where(denom == 0, 1.0, denom)
        x = _tree_axpy(alpha, s, x)
        r = _tree_axpy(-alpha, As, r)
        z = apply_M(r)
        sigma_new = _tree_dot(z, r, axis_name, reduce_mask)
        beta = sigma_new / jnp.where(sigma == 0, 1.0, sigma)
        s = _tree_axpy(beta, s, z)
        res = _tree_absmax(r, axis_name, reduce_mask)
        return x, r, s, sigma_new, it + 1, res

    x, r, s, sigma, it, res = lax.while_loop(
        cond, body, (x0, r0, z0, sigma0, jnp.int32(0), res0)
    )
    return PCGResult(x, it, res, res <= tol)


def jacobi_preconditioner(diag_tree):
    """M^-1 = 1/diag elementwise, identity where diag == 0 (off-mask)."""

    def apply_M(r):
        return jax.tree.map(
            lambda ri, di: jnp.where(di > 0, ri / jnp.where(di == 0, 1.0, di), 0.0),
            r,
            diag_tree,
        )

    return apply_M
