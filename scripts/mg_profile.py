#!/usr/bin/env python
"""Time the multigrid V-cycle building blocks at RES^3 on the active backend.

Each op is iterated K times inside one jit (lax.fori_loop over data-dependent
chains) so the host dispatch cost amortizes away.
"""

from __future__ import annotations

import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from flipviscosity3d.config import SimConfig
from flipviscosity3d.solvers import multigrid as mg
from flipviscosity3d.utils.runtime import enable_compile_cache

enable_compile_cache()

RES = int(os.environ.get("RES", "128"))
K = int(os.environ.get("K", "50"))


def timeit_chain(name, op, x0, k=K, n=3):
    """Time k data-dependent applications of op inside one jit."""

    @jax.jit
    def chain(x):
        def body(_, x):
            y = op(x)
            # keep shapes fixed: fold result back into an x-shaped array
            if y.shape != x.shape:
                return x * 0.999 + jnp.sum(y) * 1e-12
            return y
        return lax.fori_loop(0, k, body, x)

    r = chain(x0)
    r.ravel()[0].item()
    t0 = time.perf_counter()
    for _ in range(n):
        r = chain(x0)
        r.ravel()[0].item()
    dt = (time.perf_counter() - t0) / n
    print(f"{name:28s} {dt / k * 1e3:8.3f} ms/op", flush=True)


def main():
    shape = (RES, RES, RES)
    rng = np.random.default_rng(0)
    diag = jnp.asarray(rng.uniform(1, 2, shape).astype(np.float32))
    links = tuple(
        jnp.asarray(rng.uniform(0, 0.3, shape).astype(np.float32))
        for _ in range(3)
    )
    level = mg._level(diag, links)
    b = jnp.asarray(rng.normal(size=shape).astype(np.float32))

    print(f"# {RES}^3 amortized op timings (K={K}; subtract the identity row "
          "= dispatch/K floor)")
    timeit_chain("identity mul", lambda x: x * 1.000001, b)
    timeit_chain("7pt apply", lambda x: mg._apply(level, x), b)
    timeit_chain("smooth x1", lambda x: mg._smooth(level, x, b, 1, 0.8), b)
    timeit_chain("pool_sum", mg._pool_sum, b)
    pooled = mg._pool_sum(b)
    timeit_chain("prolong", lambda a: mg._prolong(a, shape), pooled, k=K)
    timeit_chain(
        "restrict+prolong round trip",
        lambda x: x - 0.1 * mg._prolong(mg._pool_sum(x), shape), b,
    )

    for levels in (2, 3, 5, 16):
        cfg = SimConfig(
            isize=RES, jsize=RES, ksize=RES, dx=1.0 / RES,
            mg_max_levels=levels,
        )
        hier = mg.build_hierarchy(diag, links, cfg)
        timeit_chain(
            f"v_cycle L{len(hier.levels)}"
            + (" dense" if hier.coarse_inv is not None else " smooth"),
            lambda x, h=hier: mg.v_cycle(h, x, 1, 1, 0.8, 1.4),
            b, k=K,
        )

    # ---- batched (3, R+2, R+2, R+2) = the viscosity block hierarchy ----
    bshape = (3, RES + 2, RES + 2, RES + 2)
    diag_b = jnp.asarray(rng.uniform(1, 2, bshape).astype(np.float32))
    links_b = tuple(
        jnp.asarray(rng.uniform(0, 0.3, bshape).astype(np.float32))
        for _ in range(3)
    )
    level_b = mg._level(diag_b, links_b)
    bb = jnp.asarray(rng.normal(size=bshape).astype(np.float32))
    print(f"# batched {bshape}")
    timeit_chain("b identity mul", lambda x: x * 1.000001, bb)
    timeit_chain("b 7pt apply", lambda x: mg._apply(level_b, x), bb)
    timeit_chain("b smooth x1",
                 lambda x: mg._smooth(level_b, x, bb, 1, 0.8), bb)
    timeit_chain("b pool_sum", mg._pool_sum, bb)
    pooled_b = mg._pool_sum(bb)
    timeit_chain("b prolong",
                 lambda a: mg._prolong(a, bshape[-3:]), pooled_b)
    for levels in (2, 3, 5, 16):
        cfg = SimConfig(
            isize=RES, jsize=RES, ksize=RES, dx=1.0 / RES,
            mg_max_levels=levels,
        )
        hier = mg.build_hierarchy(diag_b, links_b, cfg)
        timeit_chain(
            f"b v_cycle L{len(hier.levels)}"
            + (" dense" if hier.coarse_inv is not None else " smooth"),
            lambda x, h=hier: mg.v_cycle(h, x, 1, 1, 0.8, 1.4),
            bb, k=K,
        )


if __name__ == "__main__":
    main()
