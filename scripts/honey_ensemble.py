#!/usr/bin/env python
"""Bound the honey-coil divergence with a reference seed ensemble.

The coiling-rod scene (rod.ply in sphere_large, viscosity 20, 64^3) is
chaotic once the coil buckles (~frame 90): round 2 documented the JAX engine's run
diverging from the C++ reference there and *attributed* it to chaotic
amplification of seeding differences. This script turns that claim into a
measurement: run the reference N times with perturbed rand() seeds
(scripts/ref_baseline/parity_scene_main.cpp argv[8] -> srand), compute each
perturbed run's center-of-mass divergence from the baseline reference run,
and check the engine run's divergence lies inside that ensemble envelope.

Usage:
  1. build + run the ensemble (see parity_scene_main.cpp usage)
  2. python scripts/honey_ensemble.py --ref-root .ref_build \
         --seeds 1,2,3,4,5,6,7,8 --frames 300
"""

from __future__ import annotations

import argparse
import json
import os
import struct
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np


def load_ref_frame(path):
    with open(path, "rb") as f:
        (n,) = struct.unpack("<i", f.read(4))
        return np.frombuffer(f.read(12 * n), "<f4").reshape(n, 3)


def run_stats(dirpath, frames):
    coms, ystds = [], []
    for f in range(frames):
        pos = load_ref_frame(os.path.join(dirpath, f"ref_{f:04d}.bin"))
        coms.append(pos.mean(axis=0))
        ystds.append(pos[:, 1].std())
    return np.array(coms), np.array(ystds)


def engine_stats(frames, res=64, viscosity=20.0, engine="table"):
    from flipviscosity3d import FluidSimulation
    from flipviscosity3d.io import trianglemesh as tm
    from flipviscosity3d.utils.runtime import enable_compile_cache

    enable_compile_cache()
    print(f"# engine honey run: engine={engine}", flush=True)
    sim = FluidSimulation()
    sim.initialize(res, res, res, 1.0 / res, bucket_capacity=24,
                   particle_engine=engine)
    sim.add_boundary(
        tm.load_ply("/root/reference/sample_meshes/sphere_large.ply"),
        inverted=True)
    sim.add_liquid(tm.load_ply("/root/reference/sample_meshes/rod.ply"))
    sim.set_viscosity(viscosity)
    sim.set_gravity(0.0, -9.81, 0.0)

    coms, ystds = [], []
    for _ in range(frames):
        pos = np.asarray(sim.particle_positions)
        coms.append(pos.mean(axis=0))
        ystds.append(pos[:, 1].std())
        sim.advance(0.01)
    return np.array(coms), np.array(ystds)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--ref-root", default=".ref_build")
    ap.add_argument("--baseline-dir", default="honey64")
    ap.add_argument("--seeds", default="1,2,3,4,5,6,7,8")
    ap.add_argument("--frames", type=int, default=300)
    ap.add_argument("--resolution", type=int, default=64)
    ap.add_argument("--skip-engine", action="store_true")
    ap.add_argument("--engine", default="table",
                    help="particle engine of the JAX run (table|stream)")
    ap.add_argument(
        "--saved-envelope", default=None,
        help="reuse a previously-computed ensemble envelope JSON (the "
        "7-seed reference runs are ~70 CPU-minutes; the envelope is a "
        "property of the REFERENCE and its seeds, not of our engine, so "
        "an engine re-validation only needs the baseline run + this file")
    ap.add_argument("--out", default="docs/honey_ensemble.json")
    args = ap.parse_args()

    res = args.resolution
    base_com, base_ystd = run_stats(
        os.path.join(args.ref_root, args.baseline_dir), args.frames)

    if args.saved_envelope:
        with open(args.saved_envelope) as f:
            saved = json.load(f)
        env_max = np.array(
            saved.get("ref_envelope_max_cells") or saved["ref_env_max"])
        env_med = np.array(
            saved.get("ref_envelope_median_cells") or saved["ref_env_med"])
        ystd_env = np.array(
            [saved["ref_ystd_min"], saved["ref_ystd_max"]])
        n_seeds = saved["n_seeds"]
    else:
        seeds = [int(s) for s in args.seeds.split(",")]
        env = []       # (n_seeds, frames) COM divergence from base, cells
        ystd_env = []  # (n_seeds, frames) sigma_y of each perturbed run
        for s in seeds:
            com, ystd = run_stats(
                os.path.join(args.ref_root, f"honey64_s{s}"), args.frames)
            env.append(np.linalg.norm(com - base_com, axis=1) * res)
            ystd_env.append(ystd)
        env = np.array(env)
        ystd_env = np.array(ystd_env)
        env_max = env.max(axis=0)
        env_med = np.median(env, axis=0)
        n_seeds = len(seeds)

    out = dict(
        frames=args.frames,
        n_seeds=n_seeds,
        ref_envelope_max_cells=[round(float(v), 3) for v in env_max],
        ref_envelope_median_cells=[round(float(v), 3) for v in env_med],
        ref_ystd_min=[round(float(v), 4) for v in ystd_env.min(axis=0)],
        ref_ystd_max=[round(float(v), 4) for v in ystd_env.max(axis=0)],
        base_ystd=[round(float(v), 4) for v in base_ystd],
    )

    if not args.skip_engine:
        engine_com, engine_ystd = engine_stats(args.frames, res,
                                               engine=args.engine)
        d_engine = np.linalg.norm(engine_com - base_com, axis=1) * res
        inside = d_engine <= np.maximum(env_max, 0.5)  # 0.5-cell floor pre-chaos
        first_out = int(np.argmin(inside)) if not inside.all() else args.frames
        out.update(
            engine_div_cells=[round(float(v), 3) for v in d_engine],
            engine_ystd=[round(float(v), 4) for v in engine_ystd],
            frames_inside_envelope=first_out,
            frac_inside=round(float(inside.mean()), 4),
        )
        ysig_in = (engine_ystd >= ystd_env.min(axis=0) - 0.005) & (
            engine_ystd <= ystd_env.max(axis=0) + 0.005)
        out["ystd_frac_inside"] = round(float(ysig_in.mean()), 4)
        print(json.dumps(dict(
            frames_inside_envelope=first_out,
            frac_inside=out["frac_inside"],
            ystd_frac_inside=out["ystd_frac_inside"],
            env_max_late=round(float(env_max[args.frames // 2:].mean()), 2),
            engine_div_late=round(float(d_engine[args.frames // 2:].mean()), 2),
        )))

    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f)
    print(f"wrote {args.out}", flush=True)


if __name__ == "__main__":
    main()
