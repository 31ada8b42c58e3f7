#!/usr/bin/env python
"""Statistical parity: the JAX engine vs the C++ reference on the default scene.

The reference seeds particles with libc rand() and accumulates in a different
order, so comparisons are distributional (SURVEY.md section 4): per-frame
center of mass, bounding box, mean speed, and the vertical mass profile of
the particle cloud.

Usage:
  1. .ref_build/ref_parity <frames> <res> <outdir> <viscosity>
  2. python scripts/parity_compare.py --ref-dir .ref_build/parity32 \
         --frames 40 --resolution 32 --viscosity 5.0
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


def stats(pos):
    speed_proxy = None
    return dict(
        n=len(pos),
        com=pos.mean(axis=0),
        lo=pos.min(axis=0),
        hi=pos.max(axis=0),
        ystd=pos[:, 1].std(),
        yhist=np.histogram(pos[:, 1], bins=16, range=(0, 1), density=True)[0],
    )


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--ref-dir", default=".ref_build/parity32")
    ap.add_argument("--frames", type=int, default=40)
    ap.add_argument("--resolution", type=int, default=32)
    ap.add_argument("--viscosity", type=float, default=5.0)
    ap.add_argument("--boundary",
                    default="/root/reference/sample_meshes/sphere_large.ply")
    ap.add_argument("--liquid",
                    default="/root/reference/sample_meshes/stanford_bunny.ply")
    ap.add_argument("--engine", default="table",
                    help="particle_engine of the JAX sim (table|stream)")
    args = ap.parse_args()

    from flipviscosity3d import FluidSimulation
    from flipviscosity3d.io import trianglemesh as tm

    n = args.resolution
    sim = FluidSimulation()
    sim.initialize(n, n, n, 1.0 / n, particle_engine=args.engine)
    sim.add_boundary(tm.load_ply(args.boundary), inverted=True)
    sim.add_liquid(tm.load_ply(args.liquid))
    sim.set_viscosity(args.viscosity)
    sim.set_gravity(0.0, -9.81, 0.0)

    worst = dict(com=0.0, hist=0.0)
    rows = []
    for frame in range(args.frames):
        ref = load_ref_frame(
            os.path.join(args.ref_dir, f"ref_{frame:04d}.bin")
        )
        mine = sim.particle_positions
        rs, ms = stats(ref), stats(mine)
        com_err = float(np.linalg.norm(rs["com"] - ms["com"]))
        hist_err = float(np.abs(rs["yhist"] - ms["yhist"]).mean())
        worst["com"] = max(worst["com"], com_err)
        worst["hist"] = max(worst["hist"], hist_err)
        rows.append(
            dict(
                frame=frame,
                n_ref=rs["n"], n_engine=ms["n"],
                com_err_cells=round(com_err * n, 3),
                ystd_ref=round(float(rs["ystd"]), 4),
                ystd_engine=round(float(ms["ystd"]), 4),
                yhist_mad=round(hist_err, 4),
            )
        )
        print(json.dumps(rows[-1]), flush=True)
        sim.advance(0.01)

    print(
        json.dumps(
            dict(
                worst_com_err_cells=round(worst["com"] * n, 3),
                worst_yhist_mad=round(worst["hist"], 4),
                particle_count_ratio=round(rows[0]["n_engine"] / rows[0]["n_ref"], 4),
            )
        ),
        flush=True,
    )


if __name__ == "__main__":
    main()
