#!/usr/bin/env python
"""Bring-up check of the simulator on NVIDIA GPUs.

    python chip_smoke.py               # one card: phases 1-5 below
    python chip_smoke.py --four-cards  # four cards: the slab pipeline only

One card, all in one process:

1. device   -- JAX must find a GPU; prints the card's name and power limit.
2. pool     -- the 128^3 viscous pool of bench.py (~4.11M particles, bucket
               capacity 32) through FluidSimulation with the default table
               engine and multigrid CG: compile time (first, and again from
               the persistent cache), 3 frames with diagnostics, peak
               device memory. Checks finite state, particles inside
               [0,1]^3, no bucket overflow, every CG solve converged.
3. stream   -- one frame of the stream engine from the table engine's state
               after frame 1, compared with the table engine's frame 2.
4. cpu      -- one frame of a small viscous scene on the GPU and on the
               host CPU from one state, compared.
5. inviscid -- one 64^3 frame at viscosity 0 (the branch that skips the
               viscosity solve).

--four-cards runs parallel/shard_step.advance_sharded over a flat 4-GPU
mesh against single-card advance (both on the stream engine) on the 128^3
pool with gravity along the sharded axis, for 2 frames.

Every phase prints what it found. The last stdout line is one JSON object,
{"ok": true, "device": {"platform", "kind", "count"}}; any failed check
raises, so the script exits non-zero and prints no such line.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import jax
import jax.numpy as jnp
import numpy as np

import bench
from flipviscosity3d import FluidSimulation
from flipviscosity3d.core import step as step_mod
from flipviscosity3d.io.trianglemesh import box_mesh
from flipviscosity3d.utils import runtime

DT = bench.DT

# Tolerances, each in cells (dx) for positions. They compare particle
# clouds column-wise after sorting each coordinate, since the engines and
# devices order particles differently. Sources of difference, all float32:
# - table vs stream: the same arithmetic summed in another order (dense
#   per-slot table sweeps vs segmented scans), so the CG solves stop at
#   slightly different iterates inside their 1e-6 relative tolerance;
# - GPU vs CPU: scatter-adds on the GPU are atomics in no fixed order, and
#   XLA fuses and reassociates reductions differently per backend. Every
#   f32 dot passes Precision.HIGHEST, so no TF32 rounding enters (checked on
#   the CPU by tests/test_precision.py).
# None of these moves a particle by more than a small fraction of a cell in
# one frame; a wrong kernel moves particles by cells.
STREAM_POS_TOL_DX = 0.02
STREAM_VEL_TOL = 2e-3       # m/s, against pool speeds of ~0.1-1 m/s
CPU_POS_TOL_DX = 0.02
CPU_ITER_SLACK = 3          # CG iterations per frame, either solve
SLAB_POS_TOL_DX = 0.05      # 2 frames, halo-exchanged reductions


def log(msg: str) -> None:
    print(msg, flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(f"check failed: {what}")
    log(f"  ok: {what}")


def diag_dict(diag) -> dict:
    d = jax.device_get(diag)
    return {k: (float(v) if "residual" in k or k == "max_velocity"
                else int(v)) for k, v in d._asdict().items()}


def sorted_cols_maxdiff(a, b) -> float:
    """Largest difference of two (N, 3) clouds compared per sorted
    column (order-free)."""
    a, b = np.asarray(a), np.asarray(b)
    if a.shape != b.shape:
        return float("inf")
    return float(np.max(np.abs(np.sort(a, axis=0) - np.sort(b, axis=0))))


def check_state(pos, vel, what: str) -> None:
    pos, vel = np.asarray(pos), np.asarray(vel)
    check(bool(np.isfinite(pos).all() and np.isfinite(vel).all()),
          f"{what}: positions and velocities finite")
    check(bool((pos >= 0).all() and (pos <= 1).all()),
          f"{what}: all particles in [0,1]^3")


def check_diag(d: dict, what: str) -> None:
    check(d["bucket_overflow"] == 0, f"{what}: bucket_overflow == 0")
    check(d["unconverged_solves"] == 0,
          f"{what}: every CG solve reached its tolerance (pressure "
          f"residual {d['pressure_residual']:.3g}, viscosity residual "
          f"{d['viscosity_residual']:.3g})")


def compile_times(state, cfg):
    """(first s, again s, compiled): the first compile of advance in this
    process (cold unless the persistent cache already holds it), then the
    same compile after dropping in-memory caches (a persistent-cache
    hit)."""
    t0 = time.perf_counter()
    compiled = step_mod.advance.lower(state, DT, cfg).compile()
    cold = time.perf_counter() - t0
    jax.clear_caches()
    t0 = time.perf_counter()
    compiled = step_mod.advance.lower(state, DT, cfg).compile()
    warm = time.perf_counter() - t0
    return cold, warm, compiled


# --------------------------------------------------------------------------
# phases
# --------------------------------------------------------------------------

def phase_device(n_cards: int):
    devices = runtime.require_gpu(jax.devices())
    if len(devices) < n_cards:
        raise SystemExit(f"need {n_cards} GPUs, JAX found {len(devices)}")
    log(f"[device] card: {runtime.card_info()}")
    log(f"[device] platform={devices[0].platform} "
        f"device_kind={devices[0].device_kind} count={len(devices)}")
    return devices


def phase_pool(res: int = 128, frames: int = 3):
    """The real scene on the table engine; returns (cfg, states, diags):
    the state before each frame and after the last, and each frame's
    diagnostics."""
    log(f"[pool] {res}^3 viscous pool, table engine, multigrid CG")
    sim = bench.build_pool(res, "table")
    state0 = sim.state
    cfg = sim.cfg
    n = state0.pos.shape[0]
    log(f"[pool] particles={n} bucket_capacity={cfg.bucket_capacity}")

    first, again, compiled = compile_times(state0, cfg)
    log(f"[pool] compile first={first:.1f} s again={again:.1f} s "
        f"(persistent cache {jax.config.jax_compilation_cache_dir})")
    mem = compiled.memory_analysis()
    if mem is not None:
        log(f"[pool] memory_analysis: args={mem.argument_size_in_bytes} "
            f"out={mem.output_size_in_bytes} "
            f"temp={mem.temp_size_in_bytes} "
            f"code={mem.generated_code_size_in_bytes} bytes")

    states, diags = [state0], []
    for f in range(frames):
        t0 = time.perf_counter()
        d = diag_dict(sim.advance(DT))
        wall = time.perf_counter() - t0
        log(f"[pool] frame {f}: wall_ms={wall * 1e3:.1f} "
            f"substeps_per_s={d['substeps'] / wall:.3f} {json.dumps(d)}")
        check_diag(d, f"pool frame {f}")
        states.append(sim.state)
        diags.append(d)
    check_state(sim.state.pos, sim.state.vel, "pool after 3 frames")
    stats = jax.devices()[0].memory_stats() or {}
    log(f"[pool] peak_bytes_in_use={stats.get('peak_bytes_in_use')}")
    return cfg, states, diags


def phase_stream(cfg, states, diags):
    """One stream-engine frame from the table engine's state after frame 1
    (liquid in motion), against the table engine's frame 2."""
    start, table_next, table_d = states[1], states[2], diags[1]
    log("[stream] frame 2 of the pool on the stream engine")
    cfg_s = dataclasses.replace(cfg, particle_engine="stream")
    t0 = time.perf_counter()
    s1, d = step_mod.advance(start, DT, cfg_s)
    d = diag_dict(d)
    log(f"[stream] compile+frame {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    s1, d = step_mod.advance(start, DT, cfg_s)
    d = diag_dict(d)
    wall = time.perf_counter() - t0
    log(f"[stream] frame: wall_ms={wall * 1e3:.1f} "
        f"substeps_per_s={d['substeps'] / wall:.3f} {json.dumps(d)}")
    check_diag(d, "stream frame")
    check_state(s1.pos, s1.vel, "stream frame")
    check(d["substeps"] == table_d["substeps"],
          f"stream substeps {d['substeps']} == table {table_d['substeps']}")
    dpos = sorted_cols_maxdiff(s1.pos, table_next.pos) / cfg.dx
    dvel = sorted_cols_maxdiff(s1.vel, table_next.vel)
    log(f"[stream] vs table: max |dpos| = {dpos:.3g} dx, "
        f"max |dvel| = {dvel:.3g} m/s")
    check(dpos <= STREAM_POS_TOL_DX, f"dpos <= {STREAM_POS_TOL_DX} dx")
    check(dvel <= STREAM_VEL_TOL, f"dvel <= {STREAM_VEL_TOL} m/s")


def small_viscous_scene(res: int = 24):
    """A viscous block in free fall, spinning about the vertical axis at
    4 rad/s, so the frame moves every particle."""
    sim = FluidSimulation()
    sim.initialize(res, res, res, 1.0 / res)
    sim.add_liquid(box_mesh((0.2, 0.3, 0.2), (0.8, 0.75, 0.8)))
    sim.set_viscosity(5.0)
    state = sim.state
    r = state.pos - 0.5
    swirl = 4.0 * jnp.stack([r[:, 2], jnp.zeros_like(r[:, 0]), -r[:, 0]], 1)
    return state._replace(vel=swirl), sim.cfg


def phase_cpu(gpu, res: int = 24):
    log(f"[cpu] one {res}^3 viscous frame on the GPU and on the host CPU")
    cpu = jax.devices("cpu")[0]
    with jax.default_device(cpu):
        state, cfg = small_viscous_scene(res)
    out = {}
    for name, dev in (("gpu", gpu), ("cpu", cpu)):
        s = jax.device_put(state, dev)
        s1, d = step_mod.advance(s, DT, cfg)
        out[name] = (s1, diag_dict(d))
        log(f"[cpu] {name} ({dev.platform}): {json.dumps(out[name][1])}")
    (sg, dg), (sc, dc) = out["gpu"], out["cpu"]
    check(dg["substeps"] == dc["substeps"], "equal substeps")
    for k in ("pressure_iterations", "viscosity_iterations"):
        check(abs(dg[k] - dc[k]) <= CPU_ITER_SLACK,
              f"{k} within {CPU_ITER_SLACK}: gpu {dg[k]} cpu {dc[k]}")
    check_diag(dg, "gpu frame")
    dpos = sorted_cols_maxdiff(sg.pos, sc.pos) / cfg.dx
    log(f"[cpu] max |dpos| gpu vs cpu = {dpos:.3g} dx")
    check(dpos <= CPU_POS_TOL_DX, f"dpos <= {CPU_POS_TOL_DX} dx")


def phase_inviscid(res: int = 64):
    log(f"[inviscid] one {res}^3 frame at viscosity 0")
    sim = bench.build_pool(res, "table", viscosity=0.0)
    t0 = time.perf_counter()
    d = diag_dict(sim.advance(DT))
    log(f"[inviscid] compile+frame {time.perf_counter() - t0:.1f} s "
        f"{json.dumps(d)}")
    check(d["viscosity_iterations"] == 0, "viscosity solve skipped")
    check(d["pressure_iterations"] > 0, "pressure solve ran")
    check_diag(d, "inviscid frame")
    check_state(sim.state.pos, sim.state.vel, "inviscid frame")


def phase_four_cards(devices, res: int = 128, frames: int = 2):
    from jax.sharding import Mesh

    from flipviscosity3d.parallel import shard_step as sh

    n_dev = 4
    log(f"[slab] {res}^3 pool over a flat {n_dev}-GPU mesh vs one card, "
        "stream engine, gravity along the sharded axis")
    sim = bench.build_pool(res, "stream")
    cfg = sim.cfg
    state = sim.state._replace(
        gravity=jnp.array([9.81, 0.0, 0.0], jnp.float32))
    n = state.pos.shape[0]
    # all-to-all NVLink: a flat 1-D mesh, no host-major layout
    mesh = Mesh(np.array(devices[:n_dev]), (sh.AXIS,))
    spec = sh.make_spec(cfg, n_dev, n_particles=n)
    ss = sh.shard_simstate(state, cfg, spec, mesh)
    log(f"[slab] particles={n} spec={spec}")

    # compile + one discarded frame on each path, so the timed frames below
    # start warm
    t0 = time.perf_counter()
    jax.block_until_ready(sh.advance_sharded(ss, DT, cfg, spec, mesh))
    log(f"[slab] sharded compile+frame {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    jax.block_until_ready(step_mod.advance(state, DT, cfg))
    log(f"[slab] single compile+frame {time.perf_counter() - t0:.1f} s")

    occ0 = np.asarray(ss.alive).sum(axis=1)
    migrated = 0
    for f in range(frames):
        t0 = time.perf_counter()
        state, sd = step_mod.advance(state, DT, cfg)
        sd = diag_dict(sd)
        t_single = time.perf_counter() - t0
        occ_before = np.asarray(ss.alive).sum(axis=1)
        t0 = time.perf_counter()
        ss, md = sh.advance_sharded(ss, DT, cfg, spec, mesh)
        md = diag_dict(md)
        t_sharded = time.perf_counter() - t0
        occ = np.asarray(ss.alive).sum(axis=1)
        migrated += int(np.abs(occ - occ_before).sum()) // 2
        log(f"[slab] frame {f}: single wall_ms={t_single * 1e3:.1f} "
            f"sharded wall_ms={t_sharded * 1e3:.1f} occupancy={occ.tolist()}")
        log(f"[slab]   single {json.dumps(sd)}")
        log(f"[slab]   sharded {json.dumps(md)}")
        check(md["substeps"] == sd["substeps"],
              f"frame {f}: equal substeps ({md['substeps']})")
        check(int(occ.sum()) == n, f"frame {f}: {n} particles conserved")
        check(md["bucket_overflow"] == 0,
              f"frame {f}: no migration-buffer drops")
        check(md["unconverged_solves"] == 0 and sd["unconverged_solves"] == 0,
              f"frame {f}: every CG solve converged")
    check(migrated > 0, f"{migrated} particles migrated across slabs "
          f"(occupancy {occ0.tolist()} -> {occ.tolist()})")
    pos_m, vel_m = sh.gather_particles(ss)
    check_state(pos_m, vel_m, "sharded after frames")
    dpos = sorted_cols_maxdiff(pos_m, state.pos) / cfg.dx
    log(f"[slab] max |dpos| sharded vs single = {dpos:.3g} dx")
    check(dpos <= SLAB_POS_TOL_DX, f"dpos <= {SLAB_POS_TOL_DX} dx")


def main():
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--four-cards", action="store_true",
                   help="run only the 4-GPU slab-pipeline phase")
    args = p.parse_args()

    runtime.enable_compile_cache()
    devices = phase_device(4 if args.four_cards else 1)
    if args.four_cards:
        phase_four_cards(devices)
    else:
        cfg, states, diags = phase_pool()
        phase_stream(cfg, states, diags)
        del states
        phase_cpu(devices[0])
        phase_inviscid()
    print(json.dumps({"ok": True,
                      "device": runtime.describe_devices(jax.devices())}),
          flush=True)


if __name__ == "__main__":
    main()
