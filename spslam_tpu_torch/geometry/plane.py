"""Plane landmark geometry (port of spslam_tpu/geometry/plane.py): Hesse
form ``pi = [nx, ny, nz, d]`` with ``|n| = 1`` and ``n . x + d = 0``, the
minimal (azimuth, elevation, d) chart of the BA plane vertices, transforms.

The torch functions broadcast over leading dims and run on the device.
`normalize_plane_np` and `transform_plane_np` are float32 numpy twins for
host code that handles one plane at a time (the plane mapper's keyframe
loop), where a torch call on a CUDA tensor would cost a device round trip.

The chart is singular at elevation +-90 deg (normal along +-z), where
azimuth is atan2(0, 0): the reference has the same chart and the port
keeps it (its Jacobians there are huge or NaN in both packages).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import np_lie
from .lie import quat_rotate, se3_q, se3_t


def normalize_plane(pi: torch.Tensor) -> torch.Tensor:
    """Scale so the normal is unit length (the sign of n is kept)."""
    n = torch.linalg.norm(pi[..., 0:3], dim=-1, keepdim=True)
    return pi / torch.clamp_min(n, 1e-12)


def plane_point_distance(pi: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Signed point-to-plane distance, broadcast over leading dims."""
    return torch.sum(pi[..., 0:3] * x, dim=-1) + pi[..., 3]


def transform_plane(T_ab: torch.Tensor, pi_b: torch.Tensor) -> torch.Tensor:
    """Plane from frame b to frame a, T_ab mapping x_a = R x_b + t:
    pi_a = [R n_b, d_b - t . (R n_b)]."""
    n_a = quat_rotate(se3_q(T_ab), pi_b[..., 0:3])
    d_a = pi_b[..., 3] - torch.sum(se3_t(T_ab) * n_a, dim=-1)
    return torch.cat([n_a, d_a[..., None]], dim=-1)


def plane_to_azel(pi: torch.Tensor) -> torch.Tensor:
    """Hesse form -> [azimuth, elevation, d]."""
    pi = normalize_plane(pi)
    n = pi[..., 0:3]
    az = torch.atan2(n[..., 1], n[..., 0])
    el = torch.atan2(n[..., 2], torch.linalg.norm(n[..., 0:2], dim=-1))
    return torch.stack([az, el, pi[..., 3]], dim=-1)


def azel_to_plane(tau: torch.Tensor) -> torch.Tensor:
    az, el, d = tau[..., 0], tau[..., 1], tau[..., 2]
    ce = torch.cos(el)
    n = torch.stack([ce * torch.cos(az), ce * torch.sin(az), torch.sin(el)], dim=-1)
    return torch.cat([n, d[..., None]], dim=-1)


def plane_retract(pi: torch.Tensor, delta: torch.Tensor) -> torch.Tensor:
    """Apply a 3-vector update in the (az, el, d) chart."""
    return azel_to_plane(plane_to_azel(pi) + delta)


def plane_error(pi_obs: torch.Tensor, pi_pred: torch.Tensor) -> torch.Tensor:
    """3-vector plane-to-plane error in the chart, azimuth difference
    wrapped to [-pi, pi)."""
    diff = plane_to_azel(pi_obs) - plane_to_azel(pi_pred)
    # (a 0-dim operand here would make forward-mode autodiff's tangent
    # float64: slices keep a trailing dim)
    wrap = torch.remainder(diff[..., 0:1] + math.pi, 2 * math.pi) - math.pi
    return torch.cat([wrap, diff[..., 1:3]], dim=-1)


def angle_between_normals(n1: torch.Tensor, n2: torch.Tensor) -> torch.Tensor:
    """Unsigned angle between unit normals (radians), broadcast."""
    c = torch.clamp(torch.sum(n1 * n2, dim=-1), -1.0, 1.0)
    return torch.arccos(c)


def normalize_plane_np(pi: np.ndarray) -> np.ndarray:
    """normalize_plane for one float32 numpy plane."""
    pi = np.asarray(pi, np.float32)
    n = np.linalg.norm(pi[..., 0:3], axis=-1, keepdims=True)
    return (pi / np.maximum(n, np.float32(1e-12))).astype(np.float32)


def transform_plane_np(T_ab: np.ndarray, pi_b: np.ndarray) -> np.ndarray:
    """transform_plane for float32 numpy operands."""
    T_ab = np.asarray(T_ab, np.float32)
    pi_b = np.asarray(pi_b, np.float32)
    n_a = np_lie.quat_rotate(T_ab[..., 0:4], pi_b[..., 0:3])
    d_a = pi_b[..., 3] - np.sum(T_ab[..., 4:7] * n_a, axis=-1)
    return np.concatenate([n_a, d_a[..., None]], axis=-1).astype(np.float32)
