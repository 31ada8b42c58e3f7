"""Reduce a jax.profiler trace of one jitted frame to device time per stage.

Stages are the jax.named_scope names that core/step.py and the solvers put
on their ops. A kernel event names its HLO instruction (the "hlo_op" stat);
the optimized HLO text of the program maps that instruction to its scope
path (metadata op_name) and to the bytes its result and operands occupy,
which bound the kernel's time from below at the card's memory bandwidth.

Kernels that XLA runs inside a command buffer (a CUDA graph) carry
"command_buffer" as their hlo_op; they are matched by kernel name instead,
which is the instruction name with '.' written as '_'. XLA reuses one
kernel for identical fusions, so such a kernel is charged to the first
instruction that compiled it: the stage split is exact outside command
buffers and close inside them (identical fusions mostly sit in one stage).
"""

from __future__ import annotations

import re
from typing import NamedTuple

# outermost-first: a kernel belongs to the first of these in its scope path
STAGES = (
    "sort", "bucket_a", "p2g_sdf", "viscosity", "pressure", "extrapolate",
    "g2p", "gather_a", "bucket_b", "rk2_stage2", "pushback",
)
VCYCLE = "v_cycle"

_DTYPE_BYTES = {
    "pred": 1, "s8": 1, "u8": 1, "s16": 2, "u16": 2, "f16": 2, "bf16": 2,
    "s32": 4, "u32": 4, "f32": 4, "s64": 8, "u64": 8, "f64": 8,
}
_SHAPE = re.compile(r"\b(" + "|".join(_DTYPE_BYTES) + r")\[([0-9,]*)\]")
_INSTR = re.compile(r"^\s*(?:ROOT\s+)?%([\w.\-]+)\s*=\s*(.+?)\s+([\w\-]+)\(")
_OPERAND = re.compile(r"%([\w.\-]+)")
_OP_NAME = re.compile(r'op_name="([^"]*)"')
_TARGET = re.compile(r'custom_call_target="([^"]*)"')


class HloInfo(NamedTuple):
    out_bytes: int
    operands: tuple
    op_name: str
    opcode: str = ""   # custom calls: their target (e.g. __cublas$gemm)


def shape_bytes(text: str) -> int:
    """Bytes of every array shape written in `text` (tuples sum)."""
    total = 0
    for dtype, dims in _SHAPE.findall(text):
        n = 1
        for d in filter(None, dims.split(",")):
            n *= int(d)
        total += n * _DTYPE_BYTES[dtype]
    return total


def parse_hlo(text: str) -> dict:
    """{instruction name: HloInfo} over every computation of an HLO module
    text (instruction names are unique within a module)."""
    out = {}
    for line in text.splitlines():
        m = _INSTR.match(line)
        if not m:
            continue
        name, shape, opcode = m.groups()
        args = line[m.end():].split(")", 1)[0]
        op = _OP_NAME.search(line)
        target = _TARGET.search(line)
        out[name] = HloInfo(
            shape_bytes(shape), tuple(_OPERAND.findall(args)),
            op.group(1) if op else "", target.group(1) if target else opcode,
        )
    return out


def kernel_names(hlo: dict) -> dict:
    """{kernel name: instruction name} ('.' -> '_', as XLA names kernels)."""
    return {name.replace(".", "_"): name for name in hlo}


def resolve(kernel, hlo: dict, by_kernel: dict) -> str | None:
    """The HLO instruction a kernel event ran, or None."""
    if kernel.hlo_op in hlo:
        return kernel.hlo_op
    return by_kernel.get(kernel.name)


def kernel_bytes(hlo: dict, name: str) -> int:
    """Result plus operand bytes of one instruction (0 if unknown)."""
    info = hlo.get(name)
    if info is None:
        return 0
    return info.out_bytes + sum(
        hlo[o].out_bytes for o in info.operands if o in hlo)


def stage_of(op_name: str) -> tuple[str, bool]:
    """(stage, inside a V-cycle) of one scope path."""
    parts = op_name.split("/")
    stage = next((p for p in parts if p in STAGES), "other")
    return stage, VCYCLE in parts


class Kernel(NamedTuple):
    name: str
    start_ns: int
    duration_ns: int
    hlo_op: str


def device_kernels(profile_data) -> list:
    """Kernel events of the GPU planes of a jax.profiler ProfileData. Only
    the per-stream lines count; derived summary lines would count each
    kernel twice."""
    kernels = []
    for plane in profile_data.planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        lines = [ln for ln in plane.lines if "Stream" in ln.name]
        for line in lines or list(plane.lines):
            for ev in line.events:
                stats = dict(ev.stats)
                kernels.append(Kernel(
                    ev.name, int(ev.start_ns), int(ev.duration_ns),
                    str(stats.get("hlo_op", ev.name)),
                ))
    return kernels


def busy_ns(kernels) -> int:
    """Length of the union of the kernels' intervals."""
    total, end = 0, None
    for k in sorted(kernels, key=lambda k: k.start_ns):
        lo, hi = k.start_ns, k.start_ns + k.duration_ns
        if end is None or lo >= end:
            total += hi - lo
            end = hi
        elif hi > end:
            total += hi - end
            end = hi
    return total


def reduce_kernels(kernels, hlo: dict) -> dict:
    """Per-stage totals: device ns, kernel launches, result+operand bytes,
    and the V-cycle share of each stage."""
    stages = {}
    by_kernel = kernel_names(hlo)
    for k in kernels:
        op = resolve(k, hlo, by_kernel)
        stage, in_cycle = stage_of(hlo[op].op_name if op else "")
        s = stages.setdefault(stage, dict(
            ns=0, launches=0, bytes=0, vcycle_ns=0, vcycle_launches=0))
        s["ns"] += k.duration_ns
        s["launches"] += 1
        s["bytes"] += kernel_bytes(hlo, op) if op else 0
        if in_cycle:
            s["vcycle_ns"] += k.duration_ns
            s["vcycle_launches"] += 1
    return stages
