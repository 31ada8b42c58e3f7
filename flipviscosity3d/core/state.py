"""Simulation state pytrees."""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp


class SolidBoundary(NamedTuple):
    """Everything derived from the (static) solid SDF, precomputed once per
    boundary change. The reference recomputes face weights and face states
    every substep (fluidsimulation.cpp:549-582, viscositysolver.cpp:80-123)
    even though its solid geometry never changes after setup; hoisting them
    here is behavior-preserving."""

    phi: jnp.ndarray            # node SDF (I+1,J+1,K+1)
    center_phi: jnp.ndarray     # cell-center average (I,J,K)
    weight_u: jnp.ndarray       # solid-open face fractions, clamped [0,1]
    weight_v: jnp.ndarray
    weight_w: jnp.ndarray
    solid_u: jnp.ndarray        # viscosity face-state solid masks (bool)
    solid_v: jnp.ndarray
    solid_w: jnp.ndarray


class SimState(NamedTuple):
    """Complete dynamic state of the simulation (one pytree, fixed shapes)."""

    pos: jnp.ndarray            # (N,3) particle positions
    vel: jnp.ndarray            # (N,3) particle velocities
    u: jnp.ndarray              # MAC velocity (I+1,J,K)
    v: jnp.ndarray              # (I,J+1,K)
    w: jnp.ndarray              # (I,J,K+1)
    solid: SolidBoundary
    viscosity: jnp.ndarray      # node grid (I+1,J+1,K+1)
    gravity: jnp.ndarray        # (3,)


class StepDiagnostics(NamedTuple):
    """Per-advance observability (stands in for the reference's per-solve
    stdout reports, pressuresolver.cpp:550-566, viscositysolver.cpp:676-689).
    """

    substeps: jnp.ndarray
    pressure_iterations: jnp.ndarray
    pressure_residual: jnp.ndarray
    viscosity_iterations: jnp.ndarray
    viscosity_residual: jnp.ndarray
    max_velocity: jnp.ndarray
    bucket_overflow: jnp.ndarray
    liquid_cells: jnp.ndarray
    # pressure + viscosity solves of the frame that stopped at their
    # iteration cap above tolerance (0 when every solve converged)
    unconverged_solves: jnp.ndarray
