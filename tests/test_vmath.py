"""vec3/mat3/quat math (API parity with the reference vmath namespace)."""

import jax.numpy as jnp
import numpy as np

from flipviscosity3d.utils import vmath as vm


def test_vec_ops():
    rng = np.random.default_rng(0)
    a = rng.normal(size=(5, 3)).astype(np.float32)
    b = rng.normal(size=(5, 3)).astype(np.float32)
    np.testing.assert_allclose(
        np.asarray(vm.dot(a, b)), (a * b).sum(-1), rtol=1e-6
    )
    np.testing.assert_allclose(
        np.asarray(vm.cross(a, b)), np.cross(a, b), rtol=1e-5, atol=1e-6
    )
    n = np.asarray(vm.normalize(a))
    np.testing.assert_allclose(
        np.linalg.norm(n, axis=-1), 1.0, rtol=1e-5
    )
    assert bool(vm.equals(a[0], a[0] + 1e-8, 1e-6))


def test_mat3_ops():
    rng = np.random.default_rng(1)
    m1 = rng.normal(size=(3, 3)).astype(np.float32)
    m2 = rng.normal(size=(3, 3)).astype(np.float32)
    v = rng.normal(size=(3,)).astype(np.float32)
    np.testing.assert_allclose(
        np.asarray(vm.mat3_mult(m1, m2)), m1 @ m2, rtol=1e-5, atol=1e-6
    )
    np.testing.assert_allclose(
        np.asarray(vm.mat3_vec(m1, v)), m1 @ v, rtol=1e-5, atol=1e-6
    )
    np.testing.assert_allclose(np.asarray(vm.transpose(m1)), m1.T)
    np.testing.assert_allclose(
        np.asarray(vm.mat3_inverse(m1)) @ m1, np.eye(3), atol=1e-5
    )


def test_quat_axis_angle_rotation():
    # 90 degrees about z maps x-hat to y-hat
    q = vm.quat_from_axis_angle(np.pi / 2, jnp.array([0.0, 0.0, 1.0]))
    v = vm.quat_rotate(q, jnp.array([1.0, 0.0, 0.0]))
    np.testing.assert_allclose(
        np.asarray(v), [0.0, 1.0, 0.0], atol=1e-6
    )
    # mat3_cast of the identity quat is the identity matrix
    np.testing.assert_allclose(
        np.asarray(vm.quat_to_mat3(vm.quat_identity())), np.eye(3), atol=1e-7
    )


def test_quat_mult_composes_rotations():
    rng = np.random.default_rng(2)
    ax1 = rng.normal(size=3).astype(np.float32)
    ax2 = rng.normal(size=3).astype(np.float32)
    q1 = vm.quat_from_axis_angle(0.7, jnp.asarray(ax1))
    q2 = vm.quat_from_axis_angle(-1.3, jnp.asarray(ax2))
    q12 = vm.quat_mult(q1, q2)
    v = rng.normal(size=3).astype(np.float32)
    direct = vm.quat_rotate(q12, jnp.asarray(v))
    composed = vm.quat_rotate(q1, vm.quat_rotate(q2, jnp.asarray(v)))
    np.testing.assert_allclose(
        np.asarray(direct), np.asarray(composed), rtol=1e-4, atol=1e-5
    )
    # Hamilton product of unit quats stays unit after normalize
    np.testing.assert_allclose(
        float(jnp.sum(vm.quat_normalize(q12) ** 2)), 1.0, rtol=1e-6
    )
