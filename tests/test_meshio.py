"""Mesh I/O: loading and round-trips of meshes written from the
procedural primitives (io/primitives.py)."""

import numpy as np
import pytest

from flipviscosity3d.io import primitives as prim
from flipviscosity3d.io import trianglemesh as tm

@pytest.fixture
def written(tmp_path):
    """Write a procedural mesh (io/primitives.py) as binary PLY, the format
    of the reference's sample meshes; return (path, mesh)."""

    def write(mesh, name):
        path = tmp_path / f"{name}.ply"
        tm.save_ply(str(path), mesh)
        return str(path), mesh

    return write


def test_load_sample_ply(written):
    """A container sphere like the default scene's: loads whole and fits
    the unit domain, as the default scene asserts."""
    path, src = written(prim.sphere((0.5, 0.5, 0.5), 0.45), "sphere_large")
    mesh = tm.load_ply(path)
    assert len(mesh.vertices) > 100
    assert len(mesh.triangles) > 100
    assert mesh.triangles.max() < len(mesh.vertices)
    np.testing.assert_array_equal(mesh.triangles, src.triangles)
    lo, hi = mesh.aabb()
    assert (hi > lo).all()
    assert (lo >= 0).all() and (hi <= 1.0).all()


def test_ply_roundtrip(tmp_path, written):
    path, _ = written(prim.cube((0.5, 0.5, 0.5), 0.4), "cube")
    mesh = tm.load_ply(path)
    p = tmp_path / "out.ply"
    tm.save_ply(str(p), mesh)
    back = tm.load_ply(str(p))
    np.testing.assert_allclose(back.vertices, mesh.vertices)
    np.testing.assert_array_equal(back.triangles, mesh.triangles)


def test_ply_roundtrip_with_colors(tmp_path, written):
    path, _ = written(prim.cube((0.5, 0.5, 0.5), 0.4), "cube")
    mesh = tm.load_ply(path)
    colors = np.random.default_rng(0).integers(
        0, 256, size=(len(mesh.vertices), 3), dtype=np.uint8
    )
    p = tmp_path / "out.ply"
    tm.save_ply(str(p), mesh, vertex_colors=colors)
    back = tm.load_ply(str(p))
    np.testing.assert_allclose(back.vertices, mesh.vertices)
    np.testing.assert_array_equal(back.triangles, mesh.triangles)


def test_obj_roundtrip(tmp_path, written):
    path, _ = written(prim.cone((0.5, 0.2, 0.5), 0.15, 0.5), "cone")
    mesh = tm.load_ply(path)
    p = tmp_path / "out.obj"
    tm.save_obj(str(p), mesh)
    back = tm.load_obj(str(p))
    np.testing.assert_allclose(back.vertices, mesh.vertices, rtol=1e-5)
    np.testing.assert_array_equal(back.triangles, mesh.triangles)




def test_obj_face_formats(tmp_path):
    p = tmp_path / "f.obj"
    p.write_text(
        "v 0 0 0\nv 1 0 0\nv 0 1 0\nv 0 0 1\n"
        "f 1 2 3\nf 1/1 2/2 4/4\nf 1//1 3//3 4//4\nf 2/2/2 3/3/3 4/4/4\n"
    )
    mesh = tm.load_obj(str(p))
    assert mesh.triangles.shape == (4, 3)
    np.testing.assert_array_equal(mesh.triangles[0], [0, 1, 2])
    np.testing.assert_array_equal(mesh.triangles[3], [1, 2, 3])


def test_bobj_roundtrip(tmp_path, written):
    path, _ = written(prim.rod((0.5, 0.5, 0.5), 0.1, 0.6, axis=0), "rod")
    mesh = tm.load_ply(path)
    p = tmp_path / "out.bobj"
    tm.save_bobj(str(p), mesh)
    back = tm.load_bobj(str(p))
    np.testing.assert_allclose(back.vertices, mesh.vertices)
    np.testing.assert_array_equal(back.triangles, mesh.triangles)


def test_box_mesh():
    mesh = tm.box_mesh((0, 0, 0), (1, 2, 3))
    assert mesh.vertices.shape == (8, 3)
    assert mesh.triangles.shape == (12, 3)
    mesh.translate((1, 1, 1))
    lo, hi = mesh.aabb()
    np.testing.assert_allclose(lo, [1, 1, 1])
    np.testing.assert_allclose(hi, [2, 3, 4])


def test_primitives():
    s = prim.sphere((0.5, 0.5, 0.5), 0.2, subdivisions=2)
    r = np.linalg.norm(s.vertices - 0.5, axis=1)
    np.testing.assert_allclose(r, 0.2, atol=1e-6)
    assert len(s.triangles) == 20 * 4 ** 2

    c = prim.cube((0.5, 0.5, 0.5), 0.4)
    lo, hi = c.aabb()
    np.testing.assert_allclose(lo, 0.3, atol=1e-6)
    np.testing.assert_allclose(hi, 0.7, atol=1e-6)

    rod = prim.rod((0.5, 0.5, 0.5), 0.1, 0.6, axis=0)
    lo, hi = rod.aabb()
    np.testing.assert_allclose(hi[0] - lo[0], 0.6, atol=1e-6)
    np.testing.assert_allclose(hi[1] - lo[1], 0.2, atol=1e-2)

    sht = prim.sheet((0.5, 0.5, 0.5), 0.6, 0.4, 0.05, normal_axis=1)
    lo, hi = sht.aabb()
    np.testing.assert_allclose(hi[1] - lo[1], 0.05, atol=1e-6)

    cn = prim.cone((0.5, 0.2, 0.5), 0.15, 0.5)
    lo, hi = cn.aabb()
    np.testing.assert_allclose(hi[1] - lo[1], 0.5, atol=1e-6)
