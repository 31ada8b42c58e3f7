"""Scene-driver CLI.

The reference's main.cpp (/root/reference/src/main.cpp:42-90) as a
configurable command: bunny-in-sphere default scene, per-frame OBJ/PLY
particle export, JSON-line diagnostics.
"""


from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np

from flipviscosity3d import FluidSimulation
from flipviscosity3d.io import trianglemesh as tm
from flipviscosity3d.utils.runtime import enable_compile_cache

SAMPLE_MESHES = "/root/reference/sample_meshes"


def parse_args():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--resolution", type=int, default=64)
    p.add_argument("--frames", type=int, default=300)
    p.add_argument("--dt", type=float, default=0.01)
    p.add_argument("--viscosity", type=float, default=5.0)
    p.add_argument("--gravity", type=float, nargs=3, default=(0.0, -9.81, 0.0))
    p.add_argument(
        "--boundary-mesh", default=f"{SAMPLE_MESHES}/sphere_large.ply"
    )
    p.add_argument("--no-invert-boundary", action="store_true",
                   help="treat the boundary mesh as a solid, not a container")
    p.add_argument("--liquid-mesh", default=f"{SAMPLE_MESHES}/stanford_bunny.ply")
    p.add_argument("--output-dir", default="bakefiles")
    p.add_argument("--export", choices=("obj", "ply", "both", "none"),
                   default="obj")
    p.add_argument("--checkpoint-every", type=int, default=0,
                   help="save an exact-resume npz every N frames")
    p.add_argument("--resume", default=None,
                   help="restore SimState from a checkpoint npz")
    p.add_argument("--profile-dir", default=None,
                   help="capture a jax.profiler trace of frames 2-4")
    p.add_argument("--scene", default=None,
                   help="JSON scene spec; keys mirror the CLI flags "
                        "(resolution, frames, dt, viscosity, gravity, "
                        "boundary_mesh, invert_boundary, liquid_meshes, "
                        "output_dir, export) plus SimConfig overrides under "
                        "'config'")
    args = p.parse_args()
    if args.scene:
        with open(args.scene) as f:
            spec = json.load(f)
        defaults = {a.dest: a.default for a in p._actions}
        for key, val in spec.items():
            if key in ("config", "liquid_meshes", "invert_boundary"):
                continue
            # explicit command-line flags win over the scene file
            if getattr(args, key, None) == defaults.get(key):
                setattr(args, key, val)
        args.scene_spec = spec
    else:
        args.scene_spec = {}
    return args


def export_particles(frame, positions, outdir, fmt):
    mesh = tm.TriangleMesh(vertices=np.asarray(positions, np.float32))
    name = f"{frame:04d}"
    if fmt in ("obj", "both"):
        tm.save_obj(os.path.join(outdir, name + ".obj"), mesh)
    if fmt in ("ply", "both"):
        tm.save_ply(os.path.join(outdir, name + ".ply"), mesh)


def main():
    args = parse_args()
    enable_compile_cache()
    os.makedirs(args.output_dir, exist_ok=True)

    n = args.resolution
    dx = 1.0 / n
    sim = FluidSimulation()
    sim.initialize(n, n, n, dx, **args.scene_spec.get("config", {}))

    boundary = tm.load_ply(args.boundary_mesh)
    inverted = args.scene_spec.get(
        "invert_boundary", not args.no_invert_boundary
    )
    sim.add_boundary(boundary, inverted=inverted)

    for mesh_path in args.scene_spec.get("liquid_meshes", [args.liquid_mesh]):
        sim.add_liquid(tm.load_ply(mesh_path))

    sim.set_viscosity(args.viscosity)
    sim.set_gravity(*args.gravity)

    if args.resume:
        from flipviscosity3d.utils.checkpoint import load_state

        sim._state = load_state(args.resume)

    n_particles = sim.particle_positions.shape[0]
    print(f"initialized: {n}^3 grid, {n_particles} particles", flush=True)

    profiling = False
    for frame in range(args.frames):
        if args.export != "none":
            export_particles(
                frame, sim.particle_positions, args.output_dir, args.export
            )
        if args.checkpoint_every and frame and frame % args.checkpoint_every == 0:
            from flipviscosity3d.utils.checkpoint import save_state

            save_state(
                os.path.join(args.output_dir, f"ckpt_{frame:04d}.npz"),
                sim.state,
            )
        if args.profile_dir and frame == 2:
            import jax

            jax.profiler.start_trace(args.profile_dir)
            profiling = True
        if profiling and frame == 5:
            import jax

            jax.profiler.stop_trace()
            profiling = False
        t0 = time.perf_counter()
        diag = sim.advance(args.dt)
        # the host read waits for the device, so wall covers the frame
        substeps = int(diag.substeps)
        wall = time.perf_counter() - t0
        print(
            json.dumps(
                dict(
                    frame=frame,
                    wall_s=round(wall, 4),
                    substeps=substeps,
                    pressure_iters=int(diag.pressure_iterations),
                    pressure_residual=float(diag.pressure_residual),
                    viscosity_iters=int(diag.viscosity_iterations),
                    viscosity_residual=float(diag.viscosity_residual),
                    max_velocity=round(float(diag.max_velocity), 4),
                    liquid_cells=int(diag.liquid_cells),
                    bucket_overflow=int(diag.bucket_overflow),
                )
            ),
            flush=True,
        )


if __name__ == "__main__":
    main()
