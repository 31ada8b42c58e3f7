"""FluidSimulation — the public engine API.

Mirrors the reference's public surface (/root/reference/src/fluidsimulation.h:53-63):
initialize / addBoundary / resetBoundary / addLiquid / setViscosity /
setGravity / advance, plus particle access. Scene setup (mesh SDFs, particle
seeding) runs host-side once; `advance` dispatches the single jitted
computation in core/step.py.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from ..config import SimConfig
from ..io.trianglemesh import TriangleMesh, box_mesh
from ..ops import interp
from ..ops.mesh_sdf import MeshLevelSet, mesh_to_sdf
from ..solvers.viscosity import compute_face_states
from . import step as step_mod
from .state import SimState, SolidBoundary, StepDiagnostics


class FluidSimulation:
    """Host-side driver owning a SimState pytree."""

    def __init__(self):
        self.cfg: SimConfig | None = None
        self._solid_sdf: MeshLevelSet | None = None
        self._particles_pos: list[np.ndarray] = []
        self._state: SimState | None = None
        self._viscosity: jnp.ndarray | None = None
        self._gravity = np.array([0.0, -9.81, 0.0], np.float32)
        self._rng = np.random.default_rng(0)
        self.last_diagnostics: StepDiagnostics | None = None

    # ---------------- setup API ----------------

    def initialize(self, isize: int, jsize: int, ksize: int, dx: float,
                   **cfg_overrides):
        """(fluidsimulation.cpp:26-43)"""
        self.cfg = SimConfig(
            isize=isize, jsize=jsize, ksize=ksize, dx=float(dx), **cfg_overrides
        )
        self._viscosity = jnp.ones(self.cfg.node_shape, jnp.float32)
        self._initialize_boundary()

    def _domain_boundary_sdf(self) -> MeshLevelSet:
        """Default solid boundary: the negated SDF of the domain box expanded
        by -3dx - 1e-6 (i.e. inset 1.5dx + 5e-7 per side,
        fluidsimulation.cpp:225-239, aabb.cpp:118-124)."""
        cfg = self.cfg
        inset = 0.5 * (3.0 * cfg.dx + 1e-6)
        pmin = (inset, inset, inset)
        pmax = (
            cfg.isize * cfg.dx - inset,
            cfg.jsize * cfg.dx - inset,
            cfg.ksize * cfg.dx - inset,
        )
        mesh = box_mesh(pmin, pmax)
        sdf = mesh_to_sdf(mesh.vertices, mesh.triangles, cfg.grid_shape, cfg.dx)
        return sdf.negate()

    def _initialize_boundary(self):
        self._solid_sdf = self._domain_boundary_sdf()
        self._state = None

    def reset_boundary(self):
        """(fluidsimulation.cpp:60-62)"""
        self._initialize_boundary()

    def add_boundary(self, mesh: TriangleMesh, inverted: bool = False):
        """Union a solid obstacle (or inverted container) into the boundary
        SDF (fluidsimulation.cpp:45-58)."""
        cfg = self.cfg
        self._assert_in_domain(mesh)
        sdf = mesh_to_sdf(mesh.vertices, mesh.triangles, cfg.grid_shape, cfg.dx)
        if inverted:
            sdf = sdf.negate()
        self._solid_sdf = self._solid_sdf.union(sdf)
        self._state = None

    def _assert_in_domain(self, mesh: TriangleMesh):
        cfg = self.cfg
        lo, hi = mesh.aabb()
        dom_hi = np.array(
            [cfg.isize * cfg.dx, cfg.jsize * cfg.dx, cfg.ksize * cfg.dx]
        )
        if (lo < 0).any() or (hi >= dom_hi).any():
            raise ValueError("mesh extends outside the simulation domain")

    def add_liquid(self, mesh: TriangleMesh):
        """Seed 8 jittered particles per cell inside the mesh SDF and outside
        solids (fluidsimulation.cpp:64-97).

        Candidate generation, jitter, and the SDF tests all run on the
        device (16.7M candidates, ~200 MB, at 128^3); only per-block keep
        COUNTS cross to the host."""
        cfg = self.cfg
        self._assert_in_domain(mesh)
        mesh_sdf = mesh_to_sdf(mesh.vertices, mesh.triangles, cfg.grid_shape, cfg.dx)

        ppc = cfg.particles_per_cell
        total = cfg.isize * cfg.jsize * cfg.ksize * ppc
        # one host RNG draw keeps per-sim determinism (two sims constructed
        # alike seed identically); the jitter itself is drawn on device
        seed = int(self._rng.integers(0, 2**31 - 1))
        base_key = jax.random.PRNGKey(seed)

        # blockwise: 8 samples/cell at 256^3 is 134M candidate positions,
        # which overflows HBM if generated + interpolated in one shot
        block = 4_194_304

        @jax.jit
        def candidates(key, start, mphi, sphi):
            q = start + jnp.arange(block)
            cell = q // ppc
            ci = cell // (cfg.jsize * cfg.ksize)
            cj = (cell // cfg.ksize) % cfg.jsize
            ck = cell % cfg.ksize
            base = jnp.stack([ci, cj, ck], axis=-1).astype(jnp.float32)
            jitter = jax.random.uniform(key, (block, 3), jnp.float32,
                                        0.0, cfg.dx)
            p = base * cfg.dx + jitter
            phi_mesh = interp.trilinear(mphi, p, cfg.dx)
            phi_solid = interp.trilinear(sphi, p, cfg.dx)
            keep = (phi_mesh < 0) & (phi_solid >= 0) & (q < total)
            return p, keep

        kept = []
        for bi, lo in enumerate(range(0, total, block)):
            p, keep = candidates(jax.random.fold_in(base_key, bi),
                                 jnp.int32(lo), mesh_sdf.phi,
                                 self._solid_sdf.phi)
            count = int(keep.sum())
            if count:
                idx = jnp.nonzero(keep, size=count)[0]
                kept.append(p[idx])
        if kept:
            self._particles_pos.append(
                kept[0] if len(kept) == 1 else jnp.concatenate(kept, axis=0))
        self._state = None

    def set_viscosity(self, value):
        """Uniform scalar or full (I+1,J+1,K+1) node grid
        (fluidsimulation.cpp:99-124)."""
        cfg = self.cfg
        value = np.asarray(value, np.float32)
        if value.ndim == 0:
            if value < 0:
                raise ValueError("viscosity must be non-negative")
            self._viscosity = jnp.full(cfg.node_shape, value, jnp.float32)
        else:
            if value.shape != cfg.node_shape:
                raise ValueError(
                    f"viscosity grid must have shape {cfg.node_shape}"
                )
            if (value < 0).any():
                raise ValueError("viscosity must be non-negative")
            self._viscosity = jnp.asarray(value)
        if self._state is not None:
            self._state = self._state._replace(viscosity=self._viscosity)

    def set_gravity(self, gx, gy, gz):
        """(fluidsimulation.cpp:126-132)"""
        self._gravity = np.array([gx, gy, gz], np.float32)
        if self._state is not None:
            self._state = self._state._replace(
                gravity=jnp.asarray(self._gravity)
            )

    # ---------------- state assembly ----------------

    def _build_solid_boundary(self) -> SolidBoundary:
        cfg = self.cfg
        sdf = self._solid_sdf
        center_phi = sdf.cell_center_phi()
        weight_u = jnp.clip(1.0 - sdf.face_weight_u(), 0.0, 1.0)
        weight_v = jnp.clip(1.0 - sdf.face_weight_v(), 0.0, 1.0)
        weight_w = jnp.clip(1.0 - sdf.face_weight_w(), 0.0, 1.0)
        states = compute_face_states(center_phi, cfg)
        return SolidBoundary(
            phi=sdf.phi,
            center_phi=center_phi,
            weight_u=weight_u,
            weight_v=weight_v,
            weight_w=weight_w,
            solid_u=states.solid_u,
            solid_v=states.solid_v,
            solid_w=states.solid_w,
        )

    @property
    def state(self) -> SimState:
        if self._state is None:
            cfg = self.cfg
            if self._particles_pos:
                # entries are device arrays (add_liquid) or host numpy
                # (readiness scripts poke _particles_pos directly)
                arrs = [jnp.asarray(a) for a in self._particles_pos]
                pos = arrs[0] if len(arrs) == 1 else jnp.concatenate(arrs, 0)
            else:
                pos = jnp.zeros((0, 3), jnp.float32)
            self._state = SimState(
                pos=pos,
                vel=jnp.zeros_like(pos),
                u=jnp.zeros(cfg.u_shape, jnp.float32),
                v=jnp.zeros(cfg.v_shape, jnp.float32),
                w=jnp.zeros(cfg.w_shape, jnp.float32),
                solid=self._build_solid_boundary(),
                viscosity=self._viscosity,
                gravity=jnp.asarray(self._gravity),
            )
        return self._state

    # ---------------- simulation ----------------

    def advance(self, dt: float) -> StepDiagnostics:
        """Advance one frame with CFL substeps (fluidsimulation.cpp:135-168).
        """
        state = self.state
        if state.pos.shape[0] == 0:
            raise RuntimeError("no liquid particles; call add_liquid first")
        new_state, diag = step_mod.advance(state, float(dt), self.cfg)
        self._state = new_state
        self.last_diagnostics = diag
        if (
            self.cfg.on_bucket_overflow == "error"
            and int(diag.bucket_overflow) > 0
        ):
            raise RuntimeError(
                f"bucket overflow: {int(diag.bucket_overflow)} particle-pass "
                f"slots exceeded bucket_capacity={self.cfg.bucket_capacity}; "
                "raise bucket_capacity or accept the ballistic fallback "
                "(on_bucket_overflow='fallback')"
            )
        return diag

    @property
    def particle_positions(self) -> np.ndarray:
        return np.asarray(self.state.pos)

    @property
    def particle_velocities(self) -> np.ndarray:
        return np.asarray(self.state.vel)
