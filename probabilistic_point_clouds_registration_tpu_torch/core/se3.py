"""SE(3) rigid-transform math (port of the JAX package's ``core/se3.py``).

Quaternion convention is (w, x, y, z), matching the reference's Ceres usage
(include/prob_point_cloud_registration/error_term.hpp:31 uses
``ceres::QuaternionRotatePoint``, whose rotation operator normalizes a
general quaternion before rotating).

The tensor functions work in the dtype and on the device of their inputs
and are batched over leading dimensions (a quaternion is the last axis of
4, a point or translation the last axis of 3), where the JAX package calls
its single-transform functions under ``vmap``. The host helpers work on
numpy float64 so the transform history is exact.

TF32 is switched off for this process when the module is imported:
``quat_rotate_points`` is a HIGHEST-precision product in the JAX package,
and a TF32 matmul keeps only ~10 mantissa bits, which would move LiDAR-scale
coordinates by millimetres and change neighbor selection.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


class SE3(NamedTuple):
    """A rigid transform ``p -> R(q) p + t``; q is (w, x, y, z), t is (3,)."""

    q: torch.Tensor
    t: torch.Tensor

    @staticmethod
    def identity(dtype=torch.float32, device=None) -> "SE3":
        return SE3(
            q=torch.tensor([1.0, 0.0, 0.0, 0.0], dtype=dtype, device=device),
            t=torch.zeros(3, dtype=dtype, device=device),
        )


def quat_normalize(q):
    """Return q / ||q|| (over the last axis)."""
    return q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)


def unit_quat_rotate(q, v):
    """Rotate 3-vector(s) ``v`` by a *unit* quaternion ``q`` (w, x, y, z).

    ``v' = v + 2 (w (u x v) + u x (u x v))`` with u the vector part.
    Broadcasts over leading dims of ``q`` and ``v``.
    """
    w = q[..., :1]
    u = q[..., 1:4].expand_as(v)
    uv = torch.linalg.cross(u, v)
    return v + 2.0 * (w * uv + torch.linalg.cross(u, uv))


def quat_rotate(q, v):
    """Rotate by a general (possibly non-unit) quaternion: normalizes first,
    like the reference's rotation operator (error_term.hpp:31)."""
    return unit_quat_rotate(quat_normalize(q), v)


def quat_rotate_points(q, pts):
    """Rotate an (N, 3) point array by ``q`` as one (N, 3) @ (3, 3) product
    (with a pair axis, (B, N, 3) by (B, 4): that product for each pair).

    The JAX package's layout (a full-precision 3x3 contraction); TF32 is off
    (module docstring), so the product runs in full float32 on the card.
    Rounding differs from ``quat_rotate`` in the last bits.
    """
    if q.dim() > 1:  # a pair axis: pair by pair, whatever the batch
        return torch.stack([quat_rotate_points(qb, pb) for qb, pb in zip(q, pts)])
    m_t = quat_rotate(q, torch.eye(3, dtype=pts.dtype, device=pts.device))
    return pts @ m_t


def quat_multiply(a, b):
    """Hamilton product a*b, both (w, x, y, z)."""
    aw, ax, ay, az = a.unbind(-1)
    bw, bx, by, bz = b.unbind(-1)
    return torch.stack(
        [
            aw * bw - ax * bx - ay * by - az * bz,
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
        ],
        dim=-1,
    )


def quat_conjugate(q):
    return torch.cat([q[..., :1], -q[..., 1:]], dim=-1)


def quat_to_matrix(q):
    """Unit-normalize ``q`` and return the (..., 3, 3) rotation matrix."""
    w, x, y, z = quat_normalize(q).unbind(-1)
    rows = [
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ]
    return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)


def matrix_to_quat(m):
    """(..., 3, 3) rotation matrix -> quaternion (w, x, y, z), Shepperd's
    form: the candidate with the largest pivot, unit norm, w >= 0."""
    m = torch.as_tensor(m)
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    tr = m00 + m11 + m22
    # cands[..., c, :] is candidate c as (w, x, y, z).
    cands = torch.stack(
        [
            torch.stack([1.0 + tr, m21 - m12, m02 - m20, m10 - m01], dim=-1),
            torch.stack([m21 - m12, 1.0 + m00 - m11 - m22, m01 + m10, m02 + m20], dim=-1),
            torch.stack([m02 - m20, m01 + m10, 1.0 - m00 + m11 - m22, m12 + m21], dim=-1),
            torch.stack([m10 - m01, m02 + m20, m12 + m21, 1.0 - m00 - m11 + m22], dim=-1),
        ],
        dim=-2,
    )
    pivots = torch.stack(
        [1.0 + tr, 1.0 + m00 - m11 - m22, 1.0 - m00 + m11 - m22, 1.0 - m00 - m11 + m22],
        dim=-1,
    )
    best = torch.argmax(pivots, dim=-1)
    q = torch.gather(cands, -2, best[..., None, None].expand(*best.shape, 1, 4))[..., 0, :]
    q = quat_normalize(q)
    return torch.where(q[..., :1] < 0, -q, q)


def se3_apply(tf: SE3, points):
    """Apply ``tf`` to points of shape (..., 3)."""
    return quat_rotate(tf.q, points) + tf.t


def se3_compose(a: SE3, b: SE3) -> SE3:
    """Return the transform equal to applying ``b`` first, then ``a``."""
    qa = quat_normalize(a.q)
    qb = quat_normalize(b.q)
    return SE3(q=quat_multiply(qa, qb), t=unit_quat_rotate(qa, b.t) + a.t)


def se3_inverse(tf: SE3) -> SE3:
    q = quat_normalize(tf.q)
    qinv = quat_conjugate(q)
    return SE3(q=qinv, t=-unit_quat_rotate(qinv, tf.t))


def se3_to_matrix(tf: SE3):
    """(..., 4, 4) homogeneous matrix."""
    r = quat_to_matrix(tf.q)
    top = torch.cat([r, tf.t[..., :, None]], dim=-1)
    bottom = torch.zeros(top.shape[:-2] + (1, 4), dtype=top.dtype, device=top.device)
    bottom[..., 0, 3] = 1.0
    return torch.cat([top, bottom], dim=-2)


def se3_from_matrix(m) -> SE3:
    m = torch.as_tensor(m)
    return SE3(q=matrix_to_quat(m[..., :3, :3]), t=m[..., :3, 3])


def euler_zyx_to_quat(roll, pitch, yaw):
    """ZYX composition: q = Rz(yaw) * Ry(pitch) * Rx(roll), batched over the
    angles' shape.

    Matches the reference's ``euler2Quaternion`` (utilities.hpp:252-263),
    which composes yawAngle * pitchAngle * rollAngle about unit Z, Y, X.
    """
    roll, pitch, yaw = (torch.as_tensor(a) for a in (roll, pitch, yaw))

    def axis_angle(axis, angle):
        half = 0.5 * angle
        s = torch.sin(half)
        vec = torch.tensor(axis, dtype=s.dtype, device=s.device) * s[..., None]
        return torch.cat([torch.cos(half)[..., None], vec], dim=-1)

    qz = axis_angle([0.0, 0.0, 1.0], yaw)
    qy = axis_angle([0.0, 1.0, 0.0], pitch)
    qx = axis_angle([1.0, 0.0, 0.0], roll)
    return quat_multiply(quat_multiply(qz, qy), qx)


# ---------------------------------------------------------------------------
# Host-side (numpy float64) helpers, copied from the JAX package.
# ---------------------------------------------------------------------------


def np_matrix_to_quat(m: np.ndarray) -> np.ndarray:
    """Rotation matrix -> unit quaternion (Shepperd pivot, w >= 0)."""
    m = np.asarray(m, dtype=np.float64)
    m00, m01, m02 = m[0]
    m10, m11, m12 = m[1]
    m20, m21, m22 = m[2]
    tr = m00 + m11 + m22
    pivots = np.array(
        [1.0 + tr, 1.0 + m00 - m11 - m22, 1.0 - m00 + m11 - m22, 1.0 - m00 - m11 + m22]
    )
    cands = np.array(
        [
            [1.0 + tr, m21 - m12, m02 - m20, m10 - m01],
            [m21 - m12, 1.0 + m00 - m11 - m22, m01 + m10, m02 + m20],
            [m02 - m20, m01 + m10, 1.0 - m00 + m11 - m22, m12 + m21],
            [m10 - m01, m02 + m20, m12 + m21, 1.0 - m00 - m11 + m22],
        ]
    )
    q = cands[int(np.argmax(pivots))]
    q = q / np.linalg.norm(q)
    return -q if q[0] < 0 else q


def np_quat_to_matrix(q: np.ndarray) -> np.ndarray:
    """3x3 rotation matrix of a unit quaternion (w, x, y, z)."""
    w, x, y, z = np.asarray(q, dtype=np.float64)
    return np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        ]
    )


def np_se3_matrix(q: np.ndarray, t: np.ndarray) -> np.ndarray:
    """4x4 homogeneous matrix from a (normalized) quaternion + translation."""
    out = np.eye(4)
    out[:3, :3] = np_quat_to_matrix(q)
    out[:3, 3] = np.asarray(t, dtype=np.float64)
    return out


def matrix_euler_xyz(m):
    """Extract (a0, a1, a2) with R = Rx(a0) @ Ry(a1) @ Rz(a2), a0 in [0, pi].

    Reproduces the angle-range normalization of Eigen's
    ``eulerAngles(0, 1, 2)``, which the reference's CSV report columns
    roll/pitch/yaw come from (src/prob_point_cloud_registration.cc:123).
    """
    m = np.asarray(m, dtype=np.float64)
    res0 = np.arctan2(m[1, 2], m[2, 2])
    c2 = np.hypot(m[0, 0], m[0, 1])
    if res0 > 0:
        res0 = res0 - np.pi
        res1 = np.arctan2(-m[0, 2], -c2)
    else:
        res1 = np.arctan2(-m[0, 2], c2)
    s0, c0 = np.sin(res0), np.cos(res0)
    res2 = np.arctan2(s0 * m[2, 0] - c0 * m[1, 0], c0 * m[1, 1] - s0 * m[2, 1])
    return np.array([-res0, -res1, -res2])


def compose_matrices(delta: np.ndarray, base: np.ndarray) -> np.ndarray:
    """Left-compose: returns delta @ base (numpy float64 4x4 matrices).

    The reference accumulates ``current = iteration_transform * history.back()``
    (src/prob_point_cloud_registration.cc:101-107).
    """
    return np.asarray(delta, dtype=np.float64) @ np.asarray(base, dtype=np.float64)
