"""Vector / 3x3-matrix / quaternion math over batched jnp arrays.

API-parity analogue of the reference's vmath namespace
(/root/reference/src/vmath.h:39-225): vec3 dot/cross/length/normalize,
mat3 products and transpose, and quaternions (axis-angle construction,
Hamilton product — the reference calls it `cross` — normalization, and
rotation-matrix cast, vmath.h:166-225).

The reference simulator itself never calls mat3/quat outside vmath (this
module exists for API completeness), so the idiomatic representation is
plain arrays, batchable and jit/vmap-friendly:
    vec3  -> float32[..., 3]
    mat3  -> float32[..., 3, 3]   (row-major rows, m @ v semantics)
    quat  -> float32[..., 4]      as (w, x, y, z)
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

# ---------------- vec3 ----------------


def dot(a, b):
    return jnp.sum(a * b, axis=-1)


def cross(a, b):
    return jnp.cross(a, b)


def lengthsq(a):
    return jnp.sum(a * a, axis=-1)


def length(a):
    return jnp.sqrt(lengthsq(a))


def normalize(a, eps: float = 0.0):
    """v / |v|; `eps` guards the zero vector (the reference divides by the
    raw length, vmath.h:95-98 — pass eps=0 for exact parity)."""
    n = length(a)[..., None]
    if eps:
        n = jnp.maximum(n, eps)
    return a / n


def equals(a, b, eps):
    return jnp.all(jnp.abs(a - b) <= eps, axis=-1)


# ---------------- mat3 ----------------


def mat3_identity(dtype=jnp.float32):
    return jnp.eye(3, dtype=dtype)


def mat3_mult(m1, m2):
    """Matrix product (vmath.h:126, operator*(mat3, mat3))."""
    return jnp.matmul(m1, m2, precision=jax.lax.Precision.HIGHEST)


def mat3_vec(m, v):
    """m @ v (vmath.h:127, operator*(mat3, vec3))."""
    return jnp.einsum(
        "...ij,...j->...i", m, v, precision=jax.lax.Precision.HIGHEST
    )


def transpose(m):
    return jnp.swapaxes(m, -1, -2)


def mat3_det(m):
    return jnp.linalg.det(m)


def mat3_inverse(m):
    return jnp.linalg.inv(m)


# ---------------- quat (w, x, y, z) ----------------


def quat_identity(dtype=jnp.float32):
    return jnp.array([1.0, 0.0, 0.0, 0.0], dtype=dtype)


def quat_from_axis_angle(rads, axis):
    """quat(rads, v): rotation of `rads` about `axis` (vmath.h quat ctor;
    axis is normalized like the reference's usage assumes)."""
    rads = jnp.asarray(rads)
    axis = normalize(jnp.asarray(axis))
    half = 0.5 * rads
    w = jnp.cos(half)
    xyz = axis * jnp.sin(half)[..., None]
    return jnp.concatenate(
        [jnp.broadcast_to(w[..., None], xyz.shape[:-1] + (1,)), xyz], axis=-1
    )


def quat_normalize(q):
    """(vmath.h:194-207)"""
    return q / jnp.sqrt(jnp.sum(q * q, axis=-1))[..., None]


def quat_mult(q1, q2):
    """Hamilton product — the reference names this `cross(quat, quat)`
    (vmath.h:209-225): scalar = s1*s2 - v1.v2, vector = s1*v2 + s2*v1 + v1xv2.
    """
    s1, v1 = q1[..., :1], q1[..., 1:]
    s2, v2 = q2[..., :1], q2[..., 1:]
    scalar = s1 * s2 - dot(v1, v2)[..., None]
    vect = s1 * v2 + s2 * v1 + cross(v1, v2)
    return jnp.concatenate([scalar, vect], axis=-1)


def quat_to_mat3(q):
    """mat3_cast (vmath.h:181-192). Note the reference builds its mat3 in
    column-major constructor order; this returns the standard row-major
    rotation matrix R with R @ v rotating v, numerically identical to
    applying the reference's matrix to a vector."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    r00 = 1 - 2 * (y * y + z * z)
    r01 = 2 * (x * y - z * w)
    r02 = 2 * (x * z + y * w)
    r10 = 2 * (x * y + z * w)
    r11 = 1 - 2 * (x * x + z * z)
    r12 = 2 * (y * z - x * w)
    r20 = 2 * (x * z - y * w)
    r21 = 2 * (y * z + x * w)
    r22 = 1 - 2 * (x * x + y * y)
    return jnp.stack(
        [
            jnp.stack([r00, r01, r02], axis=-1),
            jnp.stack([r10, r11, r12], axis=-1),
            jnp.stack([r20, r21, r22], axis=-1),
        ],
        axis=-2,
    )


def quat_rotate(q, v):
    """Rotate vec3 v by unit quaternion q."""
    return mat3_vec(quat_to_mat3(q), v)
