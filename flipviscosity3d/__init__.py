"""flipviscosity3d — a JAX FLIP liquid simulator with variational pressure
and viscosity solves.

A from-scratch JAX/XLA rebuild with the capabilities of
rlguy/FLIPViscosity3D: FLIP on a staggered MAC grid, mesh SDF scene setup,
ghost-fluid variational pressure projection, and the Batty-Bridson
variational viscosity solve — redesigned as one jitted, fixed-shape
computation per frame.
"""

from .config import SimConfig
from .core.sim import FluidSimulation
from .core.state import SimState, StepDiagnostics

__version__ = "0.1.0"

__all__ = [
    "FluidSimulation",
    "SimConfig",
    "SimState",
    "StepDiagnostics",
]
