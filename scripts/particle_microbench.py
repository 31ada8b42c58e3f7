#!/usr/bin/env python
"""Stream vs table particle-engine microbench on the active backend.

Times the particle-side passes of one substep at RES^3 / ~NP particles for
both engines (cfg.particle_engine), with the grid-side pipeline stubbed out:
the timing isolates the bucket sort/scatter passes of the table engine
against the sorted-stream engine.

Usage: RES=128 python scripts/particle_microbench.py
"""

from __future__ import annotations

import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax
import jax.numpy as jnp
import numpy as np

from flipviscosity3d.config import SimConfig
from flipviscosity3d.ops import particle_grid as pg
from flipviscosity3d.ops import stream_transfers as st
from flipviscosity3d.ops.buckets import (
    build_buckets, cell_of_position, gather_results,
)
from flipviscosity3d.ops.stream import stream_sort
from flipviscosity3d.utils.runtime import enable_compile_cache

enable_compile_cache()

RES = int(os.environ.get("RES", "128"))
FILL = float(os.environ.get("FILL", "0.25"))  # fraction of domain with liquid
# match bench.py's seeded particle count so kernel shapes (and the persistent
# compile cache) line up with the headline benchmark
NP_OVERRIDE = int(os.environ.get("NP", "4111806"))
WITH_TABLE = os.environ.get("WITH_TABLE", "0") == "1"


def timeit(name, fn, *args, n=3):
    r = fn(*args)
    jax.tree.leaves(r)[0].ravel()[0].item()
    t0 = time.perf_counter()
    for _ in range(n):
        r = fn(*args)
        jax.tree.leaves(r)[0].ravel()[0].item()
    dt = (time.perf_counter() - t0) / n * 1e3
    print(f"{name:44s} {dt:9.2f} ms", flush=True)
    return r


def main():
    cfg = SimConfig(isize=RES, jsize=RES, ksize=RES, dx=1.0 / RES)
    rng = np.random.default_rng(0)
    # ~8 particles per cell in the filled band, like seeding
    n = NP_OVERRIDE if NP_OVERRIDE > 0 else int(8 * FILL * RES**3)
    pos = rng.uniform(0.02, 0.98, size=(n, 3)).astype(np.float32)
    pos[:, 1] *= FILL
    pos = jnp.asarray(pos)
    vel = jnp.asarray(rng.normal(size=(n, 3)).astype(np.float32) * 0.5)
    shape = cfg.grid_shape
    dx = cfg.dx
    solid_phi = jnp.ones(shape, jnp.float32)
    face_shapes = (cfg.u_shape, cfg.v_shape, cfg.w_shape)
    u = jnp.zeros(cfg.u_shape, jnp.float32)
    v = jnp.zeros(cfg.v_shape, jnp.float32)
    w = jnp.zeros(cfg.w_shape, jnp.float32)
    node_phi = jnp.ones(cfg.node_shape, jnp.float32)
    print(f"# {RES}^3, {n} particles, cap {cfg.bucket_capacity}", flush=True)

    payload6 = lambda p, vl: (p[:, 0], p[:, 1], p[:, 2],
                              vl[:, 0], vl[:, 1], vl[:, 2])

    # ---------------- table engine (round-1 numbers known; opt-in) --------
    if WITH_TABLE:
        tbl = timeit(
            "table: build_buckets (pass A)",
            jax.jit(lambda p, vl: build_buckets(
                p, payload6(p, vl), dx, shape, cfg.bucket_capacity)),
            pos, vel,
        )
        print(f"#   overflow: {int(tbl.n_overflow)}", flush=True)
        timeit(
            "table: p2g_and_sdf",
            jax.jit(lambda t: pg.p2g_and_sdf(
                t, shape, dx, cfg.particle_radius, solid_phi, face_shapes)),
            tbl,
        )
        timeit(
            "table: g2p x2 grids + gather6",
            jax.jit(lambda t: (
                pg.sample_mac_at_table(t, u, v, w, dx),
                pg.sample_mac_at_table(t, u, v, w, dx),
                gather_results(t, t.fields),
            )),
            tbl,
        )

    # ---------------- stream engine ----------------
    strm = timeit(
        "stream: stream_sort (pass A)",
        jax.jit(lambda p, vl: stream_sort(p, payload6(p, vl), dx, shape)),
        pos, vel,
    )
    timeit(
        "stream: p2g_sdf_stream",
        jax.jit(lambda s: st.p2g_sdf_stream(
            s, shape, dx, cfg.particle_radius, solid_phi, face_shapes)),
        strm,
    )
    timeit(
        "stream: sample_mac x2 grids",
        jax.jit(lambda s: st.sample_mac_at(
            s.sorted[0], s.sorted[1], s.sorted[2], s.key,
            [u, u], [v, v], [w, w], dx, shape)),
        strm,
    )
    timeit(
        "stream: midpoint sample + pushback",
        jax.jit(lambda s: (
            st.sample_mac_at(s.sorted[0], s.sorted[1], s.sorted[2],
                             s.key, [u], [v], [w], dx, shape),
            st.solid_pushback_at(s.sorted[0], s.sorted[1], s.sorted[2],
                                 s.key, node_phi, dx, shape),
        )),
        strm,
    )


if __name__ == "__main__":
    main()
