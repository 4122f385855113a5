"""Numpy SE(3) helpers for HOST-side bookkeeping (frozen copy of
spslam_tpu_torch/geometry/np_lie.py).

A torch op on a CUDA tensor is a kernel launch, and reading its result is a
device sync; the tracker/system/mapper host shells therefore do single-pose
algebra in numpy, and device code uses geometry/lie.py.  Same [w,x,y,z]
quaternion convention.
"""

from __future__ import annotations

import numpy as np


def quat_mul(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    aw, ax, ay, az = a[..., 0], a[..., 1], a[..., 2], a[..., 3]
    bw, bx, by, bz = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    return np.stack(
        [
            aw * bw - ax * bx - ay * by - az * bz,
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
        ],
        axis=-1,
    )


def quat_conj(q: np.ndarray) -> np.ndarray:
    return q * np.array([1.0, -1.0, -1.0, -1.0], dtype=q.dtype)


def quat_rotate(q: np.ndarray, v: np.ndarray) -> np.ndarray:
    qw = q[..., 0:1]
    qv = q[..., 1:4]
    t = 2.0 * np.cross(qv, v)
    return v + qw * t + np.cross(qv, t)


def quat_normalize(q: np.ndarray) -> np.ndarray:
    return q / np.maximum(np.linalg.norm(q, axis=-1, keepdims=True), 1e-12)


def se3_compose(A: np.ndarray, B: np.ndarray) -> np.ndarray:
    q = quat_mul(A[..., 0:4], B[..., 0:4])
    t = quat_rotate(A[..., 0:4], B[..., 4:7]) + A[..., 4:7]
    return np.concatenate([quat_normalize(q), t], axis=-1).astype(np.float32)


def se3_inverse(T: np.ndarray) -> np.ndarray:
    qi = quat_conj(T[..., 0:4])
    ti = -quat_rotate(qi, T[..., 4:7])
    return np.concatenate([qi, ti], axis=-1).astype(np.float32)


def se3_apply(T: np.ndarray, x: np.ndarray) -> np.ndarray:
    return quat_rotate(T[..., 0:4], x) + T[..., 4:7]


def quat_to_mat(q: np.ndarray) -> np.ndarray:
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    xx, yy, zz = x * x, y * y, z * z
    wx, wy, wz = w * x, w * y, w * z
    xy, xz, yz = x * y, x * z, y * z
    m = np.stack(
        [
            1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
            2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx),
            2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy),
        ],
        axis=-1,
    )
    return m.reshape(q.shape[:-1] + (3, 3))


def camera_center(T_cw: np.ndarray) -> np.ndarray:
    """C = -R^T t."""
    return -quat_rotate(quat_conj(T_cw[..., 0:4]), T_cw[..., 4:7])
