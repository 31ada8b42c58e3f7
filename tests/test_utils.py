"""AABB and debug utility coverage."""

import numpy as np

from flipviscosity3d.utils.aabb import AABB
from flipviscosity3d.utils.debug import validate_state


def test_aabb_from_points_and_expand():
    pts = np.array([[0.1, 0.2, 0.3], [0.5, 0.8, 0.4], [0.3, 0.1, 0.9]])
    box = AABB.from_points(pts)
    np.testing.assert_allclose(box.get_min_point(), [0.1, 0.1, 0.3])
    np.testing.assert_allclose(box.get_max_point(), [0.5, 0.8, 0.9])

    # expand grows by v/2 per side (aabb.cpp:118-124)
    grown = box.expand(0.2)
    np.testing.assert_allclose(grown.get_min_point(), [0.0, 0.0, 0.2])
    np.testing.assert_allclose(grown.get_max_point(), [0.6, 0.9, 1.0])
    shrunk = box.expand(-0.2)
    np.testing.assert_allclose(shrunk.get_min_point(), [0.2, 0.2, 0.4])


def test_aabb_containment_halfopen_and_clamp():
    box = AABB.from_extents(0, 0, 0, 1, 1, 1)
    assert box.is_point_inside([0.0, 0.0, 0.0])
    assert not box.is_point_inside([1.0, 0.5, 0.5])  # half-open
    inside = box.nearest_point_inside([1.5, -0.5, 0.5])
    np.testing.assert_allclose(inside, [1.0 - 1e-6, 0.0, 0.5])
    # points already inside pass through unchanged
    np.testing.assert_allclose(
        box.nearest_point_inside([0.3, 0.3, 0.3]), [0.3, 0.3, 0.3]
    )


def test_aabb_line_intersection():
    box = AABB.from_extents(0, 0, 0, 1, 1, 1)
    assert box.is_line_intersecting([-1, 0.5, 0.5], [2, 0.5, 0.5])
    assert not box.is_line_intersecting([-1, 2, 2], [2, 2, 2])
    # diagonal grazing the corner region
    assert box.is_line_intersecting([0.5, 0.5, 0.5], [0.6, 0.6, 0.6])


def test_validate_state_flags_problems():
    import jax.numpy as jnp

    from flipviscosity3d.config import SimConfig
    from flipviscosity3d.core.state import SimState, SolidBoundary

    cfg = SimConfig(isize=4, jsize=4, ksize=4, dx=0.25)
    solid = SolidBoundary(*(jnp.zeros((2, 2, 2)) for _ in range(8)))
    good = SimState(
        pos=jnp.full((5, 3), 0.5),
        vel=jnp.zeros((5, 3)),
        u=jnp.zeros(cfg.u_shape), v=jnp.zeros(cfg.v_shape),
        w=jnp.zeros(cfg.w_shape),
        solid=solid, viscosity=jnp.zeros(cfg.node_shape),
        gravity=jnp.zeros(3),
    )
    assert validate_state(good, cfg) == []

    bad = good._replace(pos=good.pos.at[0, 0].set(jnp.nan))
    problems = validate_state(bad, cfg)
    assert any("non-finite" in p for p in problems)

    out = good._replace(pos=good.pos.at[0, 0].set(9.0))
    problems = validate_state(out, cfg)
    assert any("outside" in p for p in problems)
