"""Geometric level-set fraction utilities, vectorized and branchless.

Computes "fraction of a segment / square face / triangle / tetrahedron / cube
that lies inside the level set phi < 0" from signed distance samples at the
corners. Semantics match the reference implementation
(/root/reference/src/levelsetutils.cpp:15-251 and the templates in
levelsetutils.h:39-77), but every case analysis is rewritten as data-parallel
`where`-selects over all rotations/orderings so the functions vectorize over
whole grids. All functions accept arrays of any (broadcastable) shape.
"""

from __future__ import annotations

import jax.numpy as jnp


def _safe_div(num, den):
    """num/den where den is guaranteed nonzero in the selected branch.

    jnp.where evaluates both branches, so unselected branches must not
    produce inf/nan that could poison gradients or debug-nan checks.
    """
    den_safe = jnp.where(den == 0, 1.0, den)
    return num / den_safe


def fraction_inside(phi_left, phi_right):
    """1D: fraction of the segment between two samples with phi < 0.

    Reference: levelsetutils.cpp:15-27.
    """
    phi_left = jnp.asarray(phi_left)
    phi_right = jnp.asarray(phi_right)
    in_l = phi_left < 0
    in_r = phi_right < 0
    frac_l = _safe_div(phi_left, phi_left - phi_right)
    frac_r = _safe_div(phi_right, phi_right - phi_left)
    return jnp.where(
        in_l & in_r,
        1.0,
        jnp.where(in_l, frac_l, jnp.where(in_r, frac_r, 0.0)),
    ).astype(jnp.result_type(phi_left, phi_right))


def fraction_inside_quad(phi_bl, phi_br, phi_tl, phi_tr):
    """2D: fraction of a square face inside phi < 0 (marching-squares cases).

    Argument order matches the reference call signature
    fractionInside(phibl, phibr, phitl, phitr); internally the corners are
    walked cyclically as [bl, br, tr, tl] exactly like the reference's
    `list` array (levelsetutils.cpp:38-119). The reference rotates the list
    until a case-specific head condition holds; here every rotation's result
    is computed and the one the reference would have stopped at is selected
    arithmetically.
    """
    l0 = jnp.asarray(phi_bl)
    l1, l2, l3 = jnp.broadcast_arrays(
        jnp.asarray(phi_br), jnp.asarray(phi_tr), jnp.asarray(phi_tl)
    )
    l0 = jnp.broadcast_to(l0, l1.shape)
    corners = (l0, l1, l2, l3)
    inside = [c < 0 for c in corners]
    count = sum(i.astype(jnp.int32) for i in inside)

    rotations = [tuple(corners[(r + s) % 4] for s in range(4)) for r in range(4)]

    zero = jnp.zeros_like(l0)

    # count == 3: unique rotation with head >= 0.
    res3 = zero
    for a0, a1, a2, a3 in rotations:
        sel = (a0 >= 0).astype(l0.dtype)
        side0 = 1.0 - fraction_inside(a0, a3)
        side1 = 1.0 - fraction_inside(a0, a1)
        res3 = res3 + sel * (1.0 - 0.5 * side0 * side1)

    # count == 1: unique rotation with head < 0.
    res1 = zero
    for a0, a1, a2, a3 in rotations:
        sel = (a0 < 0).astype(l0.dtype)
        res1 = res1 + sel * (0.5 * fraction_inside(a0, a3) * fraction_inside(a0, a1))

    # count == 2, matching signs adjacent: unique rotation with a0<0 and a1<0.
    res2_adj = zero
    adjacent = jnp.zeros_like(inside[0])
    for a0, a1, a2, a3 in rotations:
        hit = (a0 < 0) & (a1 < 0)
        adjacent = adjacent | hit
        res2_adj = res2_adj + hit.astype(l0.dtype) * 0.5 * (
            fraction_inside(a0, a3) + fraction_inside(a1, a2)
        )

    # count == 2, diagonal: two rotations qualify and give identical results
    # (the formula is invariant under rotation by 2), so sum and halve.
    mid = 0.25 * (l0 + l1 + l2 + l3)
    res2_diag = zero
    for a0, a1, a2, a3 in rotations:
        sel = ((a0 < 0) & (a1 >= 0) & (a2 < 0) & (a3 >= 0)).astype(l0.dtype)
        area_neg = (
            1.0
            - 0.5 * (1.0 - fraction_inside(a0, a3)) * (1.0 - fraction_inside(a2, a3))
            - 0.5 * (1.0 - fraction_inside(a2, a1)) * (1.0 - fraction_inside(a0, a1))
        )
        area_pos = 0.5 * fraction_inside(a0, a1) * fraction_inside(a0, a3) + (
            0.5 * fraction_inside(a2, a1) * fraction_inside(a2, a3)
        )
        res2_diag = res2_diag + sel * jnp.where(mid < 0, area_neg, area_pos)
    res2_diag = 0.5 * res2_diag

    res2 = jnp.where(adjacent, res2_adj, res2_diag)
    return jnp.where(
        count == 4,
        1.0,
        jnp.where(
            count == 3,
            res3,
            jnp.where(count == 2, res2, jnp.where(count == 1, res1, 0.0)),
        ),
    )


def _sorted_triangle_fraction(phi0, phi1, phi2):
    """Area fraction when phi0 has the lone sign (levelsetutils.h:40-43)."""
    return _safe_div(phi0 * phi0, 2.0 * (phi0 - phi1) * (phi0 - phi2))


def area_fraction_triangle(phi0, phi1, phi2):
    """Fraction of a triangle inside phi < 0 (levelsetutils.cpp:121-145)."""
    phi0, phi1, phi2 = jnp.broadcast_arrays(
        jnp.asarray(phi0), jnp.asarray(phi1), jnp.asarray(phi2)
    )
    n0, n1, n2 = phi0 < 0, phi1 < 0, phi2 < 0
    count = n0.astype(jnp.int32) + n1 + n2

    # count == 1: lone negative at position p -> sortedTriangleFraction(p, others)
    c1 = jnp.where(
        n0,
        _sorted_triangle_fraction(phi0, phi1, phi2),
        jnp.where(
            n1,
            _sorted_triangle_fraction(phi1, phi2, phi0),
            _sorted_triangle_fraction(phi2, phi0, phi1),
        ),
    )
    # count == 2: lone positive at position p -> 1 - sortedTriangleFraction(p, ...)
    c2 = jnp.where(
        ~n0,
        1.0 - _sorted_triangle_fraction(phi0, phi1, phi2),
        jnp.where(
            ~n1,
            1.0 - _sorted_triangle_fraction(phi1, phi2, phi0),
            1.0 - _sorted_triangle_fraction(phi2, phi0, phi1),
        ),
    )
    return jnp.where(
        count == 3,
        # NOTE: the reference returns 0 for the all-inside triangle case
        # (levelsetutils.cpp:124-126) -- an upstream quirk reproduced here.
        0.0,
        jnp.where(count == 2, c2, jnp.where(count == 1, c1, 0.0)),
    )


def area_fraction_quad(phi00, phi10, phi01, phi11):
    """Fraction of a square inside phi < 0 via centre-point fan decomposition
    (levelsetutils.cpp:173-179)."""
    mid = 0.25 * (phi00 + phi10 + phi01 + phi11)
    return 0.25 * (
        area_fraction_triangle(phi00, phi10, mid)
        + area_fraction_triangle(phi10, phi11, mid)
        + area_fraction_triangle(phi11, phi01, mid)
        + area_fraction_triangle(phi01, phi00, mid)
    )


def _sort4(a, b, c, d):
    """Sorting network matching levelsetutils.h:_sort (5 compare-swaps)."""
    a, b = jnp.minimum(a, b), jnp.maximum(a, b)
    c, d = jnp.minimum(c, d), jnp.maximum(c, d)
    a, c = jnp.minimum(a, c), jnp.maximum(a, c)
    b, d = jnp.minimum(b, d), jnp.maximum(b, d)
    b, c = jnp.minimum(b, c), jnp.maximum(b, c)
    return a, b, c, d


def _sorted_tet_fraction(phi0, phi1, phi2, phi3):
    """phi0 lone-signed corner of a tet (levelsetutils.h:45-50)."""
    return _safe_div(
        phi0 * phi0 * phi0, (phi0 - phi1) * (phi0 - phi2) * (phi0 - phi3)
    )


def _sorted_prism_fraction(phi0, phi1, phi2, phi3):
    """phi0,phi1 < 0 <= phi2,phi3 prism case (levelsetutils.h:52-59)."""
    a = _safe_div(phi0, phi0 - phi2)
    b = _safe_div(phi0, phi0 - phi3)
    c = _safe_div(phi1, phi1 - phi3)
    d = _safe_div(phi1, phi1 - phi2)
    return a * b * (1.0 - d) + b * (1.0 - c) * d + c * d


def volume_fraction_tet(phi0, phi1, phi2, phi3):
    """Fraction of a tetrahedron inside phi < 0 (levelsetutils.cpp:189-202)."""
    p0, p1, p2, p3 = _sort4(
        *jnp.broadcast_arrays(
            jnp.asarray(phi0), jnp.asarray(phi1), jnp.asarray(phi2), jnp.asarray(phi3)
        )
    )
    all_in = p3 <= 0
    three_in = p2 <= 0
    two_in = p1 <= 0
    one_in = p0 <= 0
    res_three = 1.0 - _sorted_tet_fraction(p3, p2, p1, p0)
    res_two = _sorted_prism_fraction(p0, p1, p2, p3)
    res_one = _sorted_tet_fraction(p0, p1, p2, p3)
    return jnp.where(
        all_in,
        1.0,
        jnp.where(
            three_in,
            res_three,
            jnp.where(two_in, res_two, jnp.where(one_in, res_one, 0.0)),
        ),
    )


def volume_fraction_cube(
    phi000, phi100, phi010, phi110, phi001, phi101, phi011, phi111
):
    """Fraction of a cube inside phi < 0: average of the two 5-tet
    decompositions (levelsetutils.cpp:219-235)."""
    return (
        volume_fraction_tet(phi000, phi001, phi101, phi011)
        + volume_fraction_tet(phi000, phi101, phi100, phi110)
        + volume_fraction_tet(phi000, phi010, phi011, phi110)
        + volume_fraction_tet(phi101, phi011, phi111, phi110)
        + 2.0 * volume_fraction_tet(phi000, phi011, phi101, phi110)
        + volume_fraction_tet(phi100, phi101, phi001, phi111)
        + volume_fraction_tet(phi100, phi001, phi000, phi010)
        + volume_fraction_tet(phi100, phi110, phi111, phi010)
        + volume_fraction_tet(phi001, phi111, phi011, phi010)
        + 2.0 * volume_fraction_tet(phi100, phi111, phi001, phi010)
    ) / 12.0
