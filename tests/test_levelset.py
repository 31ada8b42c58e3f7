"""Level-set fraction utilities vs a scalar oracle.

The oracle follows the published Batty level-set fraction algorithms (the
same math as /root/reference/src/levelsetutils.cpp) written directly in
Python; the vectorized branchless versions must agree on every sign pattern.
"""

import jax
import numpy as np
import pytest

from flipviscosity3d.ops import levelset as _ls_mod


class _Jitted:
    """Eager per-op dispatch is ~10ms/op in this environment; always test
    through jit (cached so each function compiles once)."""

    _cache: dict = {}

    def __getattr__(self, name):
        if name not in self._cache:
            self._cache[name] = jax.jit(getattr(_ls_mod, name))
        return self._cache[name]


ls = _Jitted()


# ---------------- scalar oracle ----------------

def oracle_fraction_inside(l, r):
    if l < 0 and r < 0:
        return 1.0
    if l < 0 <= r:
        return l / (l - r)
    if r < 0 <= l:
        return r / (r - l)
    return 0.0


def oracle_fraction_inside_quad(bl, br, tl, tr):
    lst = [bl, br, tr, tl]
    inside = sum(1 for v in lst if v < 0)
    fi = oracle_fraction_inside

    def cycle(a):
        return a[1:] + a[:1]

    if inside == 4:
        return 1.0
    if inside == 3:
        while lst[0] < 0:
            lst = cycle(lst)
        s0 = 1 - fi(lst[0], lst[3])
        s1 = 1 - fi(lst[0], lst[1])
        return 1.0 - 0.5 * s0 * s1
    if inside == 2:
        while lst[0] >= 0 or not (lst[1] < 0 or lst[2] < 0):
            lst = cycle(lst)
        if lst[1] < 0:
            return 0.5 * (fi(lst[0], lst[3]) + fi(lst[1], lst[2]))
        mid = 0.25 * sum(lst)
        if mid < 0:
            area = 0.5 * (1 - fi(lst[0], lst[3])) * (1 - fi(lst[2], lst[3]))
            area += 0.5 * (1 - fi(lst[2], lst[1])) * (1 - fi(lst[0], lst[1]))
            return 1.0 - area
        area = 0.5 * fi(lst[0], lst[1]) * fi(lst[0], lst[3])
        area += 0.5 * fi(lst[2], lst[1]) * fi(lst[2], lst[3])
        return area
    if inside == 1:
        while lst[0] >= 0:
            lst = cycle(lst)
        return 0.5 * fi(lst[0], lst[3]) * fi(lst[0], lst[1])
    return 0.0


def oracle_sorted_tet(p0, p1, p2, p3):
    return p0 ** 3 / ((p0 - p1) * (p0 - p2) * (p0 - p3))


def oracle_sorted_prism(p0, p1, p2, p3):
    a = p0 / (p0 - p2)
    b = p0 / (p0 - p3)
    c = p1 / (p1 - p3)
    d = p1 / (p1 - p2)
    return a * b * (1 - d) + b * (1 - c) * d + c * d


def oracle_volume_fraction_tet(p0, p1, p2, p3):
    p0, p1, p2, p3 = sorted([p0, p1, p2, p3])
    if p3 <= 0:
        return 1.0
    if p2 <= 0:
        return 1.0 - oracle_sorted_tet(p3, p2, p1, p0)
    if p1 <= 0:
        return oracle_sorted_prism(p0, p1, p2, p3)
    if p0 <= 0:
        return oracle_sorted_tet(p0, p1, p2, p3)
    return 0.0


def oracle_volume_fraction_cube(c):
    (p000, p100, p010, p110, p001, p101, p011, p111) = c
    t = oracle_volume_fraction_tet
    return (
        t(p000, p001, p101, p011) + t(p000, p101, p100, p110)
        + t(p000, p010, p011, p110) + t(p101, p011, p111, p110)
        + 2 * t(p000, p011, p101, p110)
        + t(p100, p101, p001, p111) + t(p100, p001, p000, p010)
        + t(p100, p110, p111, p010) + t(p001, p111, p011, p010)
        + 2 * t(p100, p111, p001, p010)
    ) / 12.0


# ---------------- tests (vectorized: one jax call per function) ----------------

def _cases(rng, n_args, per_pattern=40):
    """All 2^n sign patterns x random magnitudes, as (N, n_args) float64."""
    rows = []
    for pattern in range(2 ** n_args):
        signs = [(pattern >> b) & 1 for b in range(n_args)]
        mags = rng.uniform(0.05, 2.0, size=(per_pattern, n_args))
        rows.append(np.where(np.asarray(signs)[None, :], mags, -mags))
    return np.concatenate(rows, axis=0)


def test_fraction_inside_1d():
    rng = np.random.default_rng(0)
    cases = _cases(rng, 2, 100)
    got = np.asarray(ls.fraction_inside(cases[:, 0], cases[:, 1]))
    want = np.array([oracle_fraction_inside(*c) for c in cases])
    np.testing.assert_allclose(got, want, atol=1e-6)
    # plane at x=0.25 of a unit segment
    assert float(ls.fraction_inside(-0.25, 0.75)) == pytest.approx(0.25)


def test_fraction_inside_quad():
    rng = np.random.default_rng(1)
    cases = _cases(rng, 4, 100)
    got = np.asarray(
        ls.fraction_inside_quad(cases[:, 0], cases[:, 1], cases[:, 2], cases[:, 3])
    )
    want = np.array([oracle_fraction_inside_quad(*c) for c in cases])
    np.testing.assert_allclose(got, want, atol=1e-5)

    # vertical halfplane + degenerate full/empty
    vals = np.asarray(
        ls.fraction_inside_quad(
            np.array([-1.0, -1.0, 1.0]),
            np.array([1.0, -2.0, 2.0]),
            np.array([-1.0, -3.0, 3.0]),
            np.array([1.0, -4.0, 4.0]),
        )
    )
    np.testing.assert_allclose(vals, [0.5, 1.0, 0.0], atol=1e-6)


def test_volume_fraction_tet():
    rng = np.random.default_rng(2)
    cases = _cases(rng, 4, 100)
    got = np.asarray(
        ls.volume_fraction_tet(cases[:, 0], cases[:, 1], cases[:, 2], cases[:, 3])
    )
    want = np.array([oracle_volume_fraction_tet(*c) for c in cases])
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_volume_fraction_cube():
    rng = np.random.default_rng(3)
    cases = rng.uniform(-1, 1, size=(500, 8))
    got = np.asarray(ls.volume_fraction_cube(*(cases[:, i] for i in range(8))))
    want = np.array([oracle_volume_fraction_cube(list(c)) for c in cases])
    np.testing.assert_allclose(got, want, atol=1e-5)

    # axis-aligned halfplane phi = x - a gives fraction a; corner order
    # (x-major): p000,p100,p010,p110,p001,p101,p011,p111
    planes = np.array(
        [[x - a for z in (0, 1) for y in (0, 1) for x in (0, 1)]
         for a in (0.25, 0.5, 0.75)]
    )
    got = np.asarray(ls.volume_fraction_cube(*(planes[:, i] for i in range(8))))
    np.testing.assert_allclose(got, [0.25, 0.5, 0.75], atol=1e-6)


def test_area_fraction_triangle_quirk():
    # the upstream all-inside triangle case returns 0 (levelsetutils.cpp:124)
    assert float(ls.area_fraction_triangle(-1.0, -1.0, -1.0)) == 0.0
    # lone negative corner of an equal-magnitude triangle covers 1/8
    assert float(ls.area_fraction_triangle(-1.0, 1.0, 1.0)) == pytest.approx(0.125)
