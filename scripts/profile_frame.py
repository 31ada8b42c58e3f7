#!/usr/bin/env python
"""Device time per stage of one frame of the bench pool, from a
jax.profiler trace, on one GPU.

    python scripts/profile_frame.py [--resolution 128] [--engines table,stream]
                                    [--out chiprun_out/profile]

For each engine: build bench.py's pool, run two frames (compile + warm-up),
trace the third, and print per stage its device time, kernel launches, the
bytes its kernels' results and operands occupy, and the least time those
bytes take at the card's HBM bandwidth (H100 SXM data sheet: 3.35 TB/s).
The V-cycle rows give launches and device time per preconditioner
application (CG iterations + 1 per solve). Also prints the frame's device
busy share. Writes the numbers and the 40 longest kernels as JSON under
--out.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import shutil
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))

import jax

import bench
from flipviscosity3d.core import step as step_mod
from flipviscosity3d.utils import runtime
from flipviscosity3d.utils import trace_stats as ts

# bytes/s of HBM, keyed by device_kind (published data sheet figures);
# an unknown card is an error, not a default
HBM_BYTES_PER_S = {"NVIDIA H100 80GB HBM3": 3.35e12}


def profile_engine(engine: str, res: int, out_dir: str, bw: float) -> dict:
    sim = bench.build_pool(res, engine)
    for _ in range(2):
        int(sim.advance(bench.DT).substeps)
    state, cfg = sim.state, sim.cfg
    t0 = time.perf_counter()
    int(step_mod.advance(state, bench.DT, cfg)[1].substeps)
    wall = time.perf_counter() - t0

    trace_dir = os.path.join(out_dir, f"trace_{engine}")
    with jax.profiler.trace(trace_dir):  # the same frame again
        d = jax.device_get(step_mod.advance(state, bench.DT, cfg)[1])
    path = sorted(glob.glob(
        os.path.join(trace_dir, "plugins", "profile", "*", "*.xplane.pb")))[-1]
    kernels = ts.device_kernels(jax.profiler.ProfileData.from_file(path))
    shutil.rmtree(trace_dir)  # tens of MB; the reduction below is kept
    hlo = ts.parse_hlo(
        step_mod.advance.lower(state, bench.DT, cfg).compile().as_text())
    stages = ts.reduce_kernels(kernels, hlo)
    by_kernel = ts.kernel_names(hlo)
    ops = [ts.resolve(k, hlo, by_kernel) for k in kernels]

    total_ns = sum(s["ns"] for s in stages.values())
    window = (max(k.start_ns + k.duration_ns for k in kernels)
              - min(k.start_ns for k in kernels))
    busy = ts.busy_ns(kernels)
    substeps = int(d.substeps)
    cycles = {
        "pressure": int(d.pressure_iterations) + substeps,
        "viscosity": int(d.viscosity_iterations) + substeps,
    }
    print(f"## engine={engine} {res}^3 particles={state.pos.shape[0]} "
          f"substeps={substeps} untraced wall_ms={wall * 1e3:.1f} "
          f"kernels={len(kernels)} by_hlo_op="
          f"{sum(k.hlo_op in hlo for k in kernels)} "
          f"by_name={sum(op is not None for op in ops)} "
          f"device_ms={total_ns / 1e6:.2f} window_ms={window / 1e6:.2f} "
          f"busy_share={busy / window:.3f}", flush=True)
    print(f"{'stage':12s} {'dev_ms':>9s} {'share':>6s} {'launch':>7s} "
          f"{'GB':>8s} {'hbm_ms':>8s} {'bound':>6s}")
    rows = {}
    for name in ts.STAGES + ("other",):
        s = stages.get(name)
        if not s:
            continue
        hbm_ms = s["bytes"] / bw * 1e3
        rows[name] = dict(s, ms=s["ns"] / 1e6, hbm_ms=hbm_ms)
        print(f"{name:12s} {s['ns'] / 1e6:9.2f} {s['ns'] / total_ns:6.3f} "
              f"{s['launches']:7d} {s['bytes'] / 1e9:8.3f} {hbm_ms:8.3f} "
              f"{hbm_ms / max(s['ns'] / 1e6, 1e-9):6.3f}")
    for solve, n_cycles in cycles.items():
        s = stages.get(solve)
        if s and s["vcycle_launches"]:
            print(f"v_cycle[{solve}]: {n_cycles} cycles, "
                  f"{s['vcycle_launches'] / n_cycles:.1f} launches/cycle, "
                  f"{s['vcycle_ns'] / n_cycles / 1e3:.1f} us/cycle, "
                  f"{s['vcycle_ns'] / s['ns']:.3f} of the solve's time")
    top = {}
    for k, op in zip(kernels, ops):
        t = top.setdefault(op or k.name, [k.name, 0, 0])
        t[1] += k.duration_ns
        t[2] += 1
    longest = sorted(top.items(), key=lambda kv: -kv[1][1])[:40]
    unresolved = {}
    for k, op in zip(kernels, ops):
        if op is None:
            unresolved[k.name] = unresolved.get(k.name, 0) + k.duration_ns
    # cuBLAS kernels inside command buffers name no instruction; say where
    # the program's GEMM custom calls sit instead
    gemm_ns = sum(ns for n, ns in unresolved.items() if "gemm" in n)
    gemm_sites = {}
    for info in hlo.values():
        if "gemm" in info.opcode:
            key = "/".join(map(str, ts.stage_of(info.op_name)))
            gemm_sites[key] = gemm_sites.get(key, 0) + 1
    print(f"unattributed cuBLAS GEMM kernels: {gemm_ns / 1e6:.2f} ms; "
          f"GEMM call sites by (stage/in v_cycle): {gemm_sites}")
    result = dict(
        engine=engine, resolution=res, particles=int(state.pos.shape[0]),
        substeps=substeps, wall_ms=wall * 1e3, device_ms=total_ns / 1e6,
        window_ms=window / 1e6, busy_share=busy / window, cycles=cycles,
        diagnostics={k: float(v) for k, v in d._asdict().items()},
        stages=rows,
        longest=[dict(hlo_op=op, kernel=v[0], ms=v[1] / 1e6, launches=v[2],
                      stage=ts.stage_of(hlo[op].op_name)[0]
                      if op in hlo else "other",
                      bytes=ts.kernel_bytes(hlo, op))
                 for op, v in longest],
        gemm_ms=gemm_ns / 1e6, gemm_sites=gemm_sites,
        unresolved_ms={n: ns / 1e6 for n, ns in sorted(
            unresolved.items(), key=lambda kv: -kv[1])[:20]},
    )
    with open(os.path.join(out_dir, f"profile_{engine}.json"), "w") as f:
        json.dump(result, f, indent=1)
    return result


def main():
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--resolution", type=int, default=128)
    p.add_argument("--engines", default="table,stream")
    p.add_argument("--out", default="chiprun_out/profile")
    args = p.parse_args()

    runtime.enable_compile_cache()
    devices = runtime.require_gpu(jax.devices())
    kind = devices[0].device_kind
    print(f"# device: {runtime.describe_devices(devices)}")
    print(f"# card: {runtime.card_info()}", flush=True)
    if kind not in HBM_BYTES_PER_S:
        raise SystemExit(f"no HBM bandwidth on record for {kind!r}")
    os.makedirs(args.out, exist_ok=True)
    for engine in args.engines.split(","):
        profile_engine(engine, args.resolution, args.out,
                       HBM_BYTES_PER_S[kind])


if __name__ == "__main__":
    main()
