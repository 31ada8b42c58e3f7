"""Simulation configuration.

The reference hardcodes all numerical parameters as private members scattered
through the code (see /root/reference/src/fluidsimulation.h:121-130,
pressuresolver.h:224-226, viscositysolver.h:200-202, fluidsimulation.cpp:36,79).
Here they live in one frozen, hashable dataclass so the whole parameter set can
be a static argument to jitted functions.
"""

from __future__ import annotations

import dataclasses

PARTICLE_ENGINES = ("table", "stream")


@dataclasses.dataclass(frozen=True)
class SimConfig:
    """All numerical constants of the FLIP solver.

    Defaults reproduce the reference's hardcoded values.
    """

    # Grid (cells per axis) and cell width.
    isize: int = 64
    jsize: int = 64
    ksize: int = 64
    dx: float = 1.0 / 64.0

    # CFL condition number: substep dt = cfl * dx / max|u|
    # (fluidsimulation.h:128, fluidsimulation.cpp:241-269)
    cfl_number: float = 5.0

    # PIC/FLIP blend: v = r*PIC + (1-r)*FLIP (fluidsimulation.h:130)
    ratio_pic_flip: float = 0.05

    # Free-surface ghost-fluid minimum fraction theta clamp
    # (fluidsimulation.h:129, pressuresolver.h:226)
    minfrac: float = 0.01

    # Mesh->SDF exact computation band, in cells (fluidsimulation.h:121)
    mesh_levelset_exact_band: int = 3

    # Particle radius = dx * 1.01 * sqrt(3)/2 (fluidsimulation.cpp:36)
    particle_radius_factor: float = 1.01 * (3.0 ** 0.5) / 2.0

    # Jittered seeding samples per cell (fluidsimulation.cpp:79)
    particles_per_cell: int = 8

    # Velocity extrapolation layers = ceil(cfl) + 2 (fluidsimulation.cpp:690-694).
    # The reference recomputes this per call; here it must be a static python
    # int, so None (the default) derives ceil(cfl_number) + 2 at construction
    # and an explicit int overrides it.
    extrapolation_layers: int | None = None

    # Pressure solve (pressuresolver.h:224-225). The reference uses an absolute
    # inf-norm tolerance of 1e-9 with MICCG in float64; in float32 we use
    # a relative tolerance floor instead (documented divergence).
    pressure_solve_max_iterations: int = 200
    pressure_solve_tolerance: float = 1e-9       # absolute floor
    pressure_solve_rtol: float = 1e-6            # relative to ||b||_inf

    # Viscosity solve (viscositysolver.h:200-202). Reference: relative 1e-6,
    # 700 iters, and results accepted if final abs error < 10.0.
    viscosity_solve_max_iterations: int = 700
    viscosity_solve_rtol: float = 1e-6
    viscosity_acceptable_error: float = 10.0

    # Particle engine. "table" (default): fixed-capacity bucket tables with
    # dense per-slot transfers (ops/buckets.py, ops/particle_grid.py).
    # "stream": one sort per substep and sorted-stream segment reductions —
    # no capacity limit, no overflow; the engine of the shard_map slab
    # pipeline. Which of the two is faster on a given card and particle
    # count is a measurement (PERF.md), not a rule.
    particle_engine: str = "table"

    # Bucketed particle-engine capacity: max particles tracked per grid cell.
    # Seeding places 8 per cell; FLIP compression packs more (the 64^3 bunny
    # scene peaks above 16/cell), so 24 keeps overflow at zero in practice.
    bucket_capacity: int = 24

    # Bucket-overflow contract. Particles beyond bucket_capacity in one cell
    # skip that pass's grid transfers and take the documented ballistic
    # fallback instead (ops/buckets.gather_results: advect with the particle's
    # own velocity, clamped to the domain and still counted in diagnostics).
    # "fallback" keeps that policy silently; "error" makes
    # FluidSimulation.advance raise as soon as a frame reports overflow > 0.
    on_bucket_overflow: str = "fallback"

    # Safety bound on CFL substeps per advance() call (reference has no cap;
    # its while-loop runs until t reaches dt).
    max_substeps: int = 64

    # CG preconditioners: "jacobi" (parallel baseline) or "multigrid"
    # (Galerkin aggregation V-cycle, solvers/multigrid.py). The reference's
    # MIC(0) is an inherently sequential triangular solve; the V-cycle is
    # the data-parallel replacement and the default for both systems.
    viscosity_preconditioner: str = "multigrid"
    pressure_preconditioner: str = "multigrid"

    # Multigrid V-cycle shape (see solvers/multigrid.py). Coarsening is
    # exact Galerkin over 2x2x2 aggregates; mg_coarse_scale over-corrects
    # the prolongated update (the standard fix for piecewise-constant
    # transfer deficiency; keeps the preconditioner symmetric). The coarsest
    # level (min dim <= mg_coarse_size) is solved with an explicit dense
    # inverse instead of many tiny smoothing sweeps.
    mg_max_levels: int = 16          # auto-stops at mg_coarse_size
    mg_coarse_size: int = 8
    mg_pre_smooth: int = 1
    mg_post_smooth: int = 1
    mg_omega: float = 0.8
    mg_coarse_scale: float = 1.4

    def __post_init__(self):
        if self.particle_engine not in PARTICLE_ENGINES:
            raise ValueError(
                f"particle_engine must be one of {PARTICLE_ENGINES}, "
                f"got {self.particle_engine!r}"
            )
        if self.extrapolation_layers is None:
            import math

            object.__setattr__(
                self, "extrapolation_layers",
                int(math.ceil(self.cfl_number)) + 2,
            )

    @property
    def grid_shape(self) -> tuple[int, int, int]:
        return (self.isize, self.jsize, self.ksize)

    @property
    def n_cells(self) -> int:
        return self.isize * self.jsize * self.ksize

    @property
    def particle_radius(self) -> float:
        return self.dx * self.particle_radius_factor

    @property
    def u_shape(self) -> tuple[int, int, int]:
        return (self.isize + 1, self.jsize, self.ksize)

    @property
    def v_shape(self) -> tuple[int, int, int]:
        return (self.isize, self.jsize + 1, self.ksize)

    @property
    def w_shape(self) -> tuple[int, int, int]:
        return (self.isize, self.jsize, self.ksize + 1)

    @property
    def node_shape(self) -> tuple[int, int, int]:
        return (self.isize + 1, self.jsize + 1, self.ksize + 1)
