"""Every f32 contraction of the frame and of the mesh SDF passes
Precision.HIGHEST. A default-precision f32 dot may round its inputs to TF32
on tensor-core GPUs (about 10 mantissa bits), which would make the multigrid
preconditioner a different linear map per call and perturb CG. The jaxpr
is walked on the CPU; what it says holds for every backend."""

import jax
import jax.numpy as jnp
import pytest
from jax.extend import core as jcore

from flipviscosity3d import FluidSimulation
from flipviscosity3d.core import step as step_mod
from flipviscosity3d.io.trianglemesh import box_mesh
from flipviscosity3d.ops import mesh_sdf


def _subjaxprs(eqn):
    for v in eqn.params.values():
        for x in v if isinstance(v, (tuple, list)) else (v,):
            if isinstance(x, jcore.ClosedJaxpr):
                yield x.jaxpr
            elif isinstance(x, jcore.Jaxpr):
                yield x


def _f32_dots(jaxpr, out):
    """(precision, operand avals) of every f32 dot_general, recursing into
    while/cond/scan/pjit bodies."""
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "dot_general" and any(
            v.aval.dtype == jnp.float32 for v in eqn.invars
        ):
            out.append((eqn.params["precision"],
                        [str(v.aval) for v in eqn.invars]))
        for sub in _subjaxprs(eqn):
            _f32_dots(sub, out)
    return out


def _is_highest(precision):
    if precision is None:
        return False
    pair = precision if isinstance(precision, tuple) else (precision,) * 2
    return all(p == jax.lax.Precision.HIGHEST for p in pair)


@pytest.mark.parametrize("engine", ["table", "stream"])
@pytest.mark.parametrize("viscosity", [5.0, 0.0], ids=["viscous", "inviscid"])
def test_advance_dots_are_highest(engine, viscosity):
    sim = FluidSimulation()
    sim.initialize(12, 12, 12, 1.0 / 12, particle_engine=engine)
    sim.add_liquid(box_mesh((0.3, 0.3, 0.3), (0.7, 0.6, 0.7)))
    sim.set_viscosity(viscosity)
    jaxpr = jax.make_jaxpr(
        lambda s: step_mod.advance(s, 0.01, sim.cfg))(sim.state)
    dots = _f32_dots(jaxpr.jaxpr, [])
    # multigrid pool/prolong, the dense coarse solve and the CG dots
    assert len(dots) > 10
    bad = [d for d in dots if not _is_highest(d[0])]
    assert not bad, bad


def test_mesh_sdf_dots_are_highest():
    mesh = box_mesh((0.2, 0.2, 0.2), (0.7, 0.6, 0.8))
    tv = jnp.asarray(mesh.vertices[mesh.triangles])
    jaxpr = jax.make_jaxpr(
        lambda t: mesh_sdf._min_distance_block(
            jnp.int32(0), t, (9, 9, 9), 0.125, 12, 729))(tv)
    dots = _f32_dots(jaxpr.jaxpr, [])
    assert len(dots) == 5  # three edge projections, two barycentric dots
    bad = [d for d in dots if not _is_highest(d[0])]
    assert not bad, bad
