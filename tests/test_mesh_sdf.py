"""Mesh -> SDF vs analytic signed distances."""

import numpy as np

from flipviscosity3d.io import trianglemesh as tm
from flipviscosity3d.io.primitives import sphere
from flipviscosity3d.ops.mesh_sdf import mesh_to_sdf

DX = 1.0 / 16.0
SHAPE = (16, 16, 16)


def test_sphere_sdf_matches_analytic():
    center = np.array([0.5, 0.5, 0.5])
    radius = 0.3
    mesh = sphere(center, radius, subdivisions=3)
    sdf = mesh_to_sdf(mesh.vertices, mesh.triangles, SHAPE, DX)
    phi = np.asarray(sdf.phi)

    ii, jj, kk = np.meshgrid(*(np.arange(s + 1) for s in SHAPE), indexing="ij")
    pts = np.stack([ii, jj, kk], -1) * DX
    analytic = np.linalg.norm(pts - center, axis=-1) - radius
    # icosphere subdiv-3 approximates the sphere to ~2e-3; grid nodes near
    # the surface see facet error
    assert np.abs(phi - analytic).max() < 0.01
    # signs must agree away from the surface band
    far = np.abs(analytic) > 0.02
    assert (np.sign(phi[far]) == np.sign(analytic[far])).all()


def test_box_sdf_inside_outside():
    mesh = tm.box_mesh((0.25, 0.25, 0.25), (0.75, 0.75, 0.75))
    sdf = mesh_to_sdf(mesh.vertices, mesh.triangles, SHAPE, DX)
    phi = np.asarray(sdf.phi)
    # node (8,8,8) = center (0.5,0.5,0.5): inside, distance 0.25 to faces
    assert abs(phi[8, 8, 8] + 0.25) < 1e-5
    # node (0,0,0): outside, nearest point is the box corner
    want = np.linalg.norm([0.25, 0.25, 0.25])
    assert abs(phi[0, 0, 0] - want) < 1e-5
    # negation flips signs (container semantics)
    neg = sdf.negate()
    assert abs(np.asarray(neg.phi)[8, 8, 8] - 0.25) < 1e-5


def test_union_is_min():
    m1 = tm.box_mesh((0.2, 0.2, 0.2), (0.5, 0.5, 0.5))
    m2 = tm.box_mesh((0.5, 0.5, 0.5), (0.8, 0.8, 0.8))
    s1 = mesh_to_sdf(m1.vertices, m1.triangles, SHAPE, DX)
    s2 = mesh_to_sdf(m2.vertices, m2.triangles, SHAPE, DX)
    u = s1.union(s2)
    np.testing.assert_allclose(
        np.asarray(u.phi), np.minimum(np.asarray(s1.phi), np.asarray(s2.phi))
    )


def test_face_weights_fully_open_fully_closed():
    """A solid SDF that is uniformly deep inside gives fraction 1 (fully
    solid face -> open weight 0 after the 1-x clamp in the simulation)."""
    mesh = tm.box_mesh((0.2, 0.2, 0.2), (0.8, 0.8, 0.8))
    sdf = mesh_to_sdf(mesh.vertices, mesh.triangles, SHAPE, DX)
    wu = np.asarray(sdf.face_weight_u())
    assert wu.shape == (17, 16, 16)
    # deep inside the box the face is fully inside phi<0 -> fraction 1
    assert abs(wu[8, 7, 7] - 1.0) < 1e-6
    # far outside -> fraction 0
    assert wu[1, 1, 1] == 0.0

    cc = np.asarray(sdf.cell_center_phi())
    assert cc.shape == (16, 16, 16)
    assert cc[8, 8, 8] < 0 < cc[0, 0, 0]
