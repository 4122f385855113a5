"""Pinhole camera model (frozen copy of spslam_tpu_torch/geometry/camera.py).

`Intrinsics` holds plain Python floats, so it is hashable like the
original and its fields enter the arithmetic as scalars.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class Intrinsics(NamedTuple):
    """Pinhole + radial-tangential distortion (reference YAML names)."""

    fx: float
    fy: float
    cx: float
    cy: float
    k1: float = 0.0
    k2: float = 0.0
    p1: float = 0.0
    p2: float = 0.0
    k3: float = 0.0
    bf: float = 40.0  # baseline*fx for the RGB-D virtual right coordinate
    width: int = 640
    height: int = 480

    @property
    def K(self) -> torch.Tensor:
        """float32 [3, 3] camera matrix on the host (a property takes no
        device): callers move it with `.to(device)`."""
        return torch.tensor(
            [[self.fx, 0.0, self.cx], [0.0, self.fy, self.cy], [0.0, 0.0, 1.0]],
            dtype=torch.float32,
        )

    @property
    def has_distortion(self) -> bool:
        return any(abs(v) > 0 for v in (self.k1, self.k2, self.p1, self.p2, self.k3))


def project(intr: Intrinsics, xc: torch.Tensor) -> torch.Tensor:
    """Camera-frame 3D points [..., 3] -> pixel coords [..., 2] (no
    distortion: keypoints are undistorted)."""
    z = torch.clamp_min(xc[..., 2:3], 1e-6)
    u = intr.fx * xc[..., 0:1] / z + intr.cx
    v = intr.fy * xc[..., 1:2] / z + intr.cy
    return torch.cat([u, v], dim=-1)


def project_with_depth(intr: Intrinsics, xc: torch.Tensor) -> torch.Tensor:
    """-> [..., 3] = (u, v, z)."""
    return torch.cat([project(intr, xc), xc[..., 2:3]], dim=-1)


def unproject(intr: Intrinsics, uv: torch.Tensor, depth: torch.Tensor) -> torch.Tensor:
    """Pixel coords [..., 2] + depth [...] -> camera-frame 3D [..., 3]."""
    d = depth[..., None]
    x = (uv[..., 0:1] - intr.cx) / intr.fx * d
    y = (uv[..., 1:2] - intr.cy) / intr.fy * d
    return torch.cat([x, y, d], dim=-1)


def distort_normalized(intr: Intrinsics, xn: torch.Tensor) -> torch.Tensor:
    x, y = xn[..., 0], xn[..., 1]
    r2 = x * x + y * y
    radial = 1.0 + r2 * (intr.k1 + r2 * (intr.k2 + r2 * intr.k3))
    xd = x * radial + 2.0 * intr.p1 * x * y + intr.p2 * (r2 + 2.0 * x * x)
    yd = y * radial + intr.p1 * (r2 + 2.0 * y * y) + 2.0 * intr.p2 * x * y
    return torch.stack([xd, yd], dim=-1)


def undistort_points(intr: Intrinsics, uv: torch.Tensor, iters: int = 8) -> torch.Tensor:
    """Fixed-point undistortion (cv2.undistortPoints style), `iters` steps."""
    if not intr.has_distortion:
        return uv
    xd = torch.stack(
        [(uv[..., 0] - intr.cx) / intr.fx, (uv[..., 1] - intr.cy) / intr.fy], dim=-1
    )
    xn = xd
    for _ in range(iters):
        delta = distort_normalized(intr, xn) - xn
        xn = xd - delta
    return torch.stack(
        [xn[..., 0] * intr.fx + intr.cx, xn[..., 1] * intr.fy + intr.cy], dim=-1
    )


def virtual_right_u(intr: Intrinsics, u: torch.Tensor, depth: torch.Tensor) -> torch.Tensor:
    """uR = u - bf/z; -1 where the depth is not positive."""
    valid = depth > 1e-6
    return torch.where(valid, u - intr.bf / torch.clamp_min(depth, 1e-6), -1.0)


def in_image(intr: Intrinsics, uv: torch.Tensor, border: float = 0.0) -> torch.Tensor:
    return (
        (uv[..., 0] >= border)
        & (uv[..., 0] < intr.width - border)
        & (uv[..., 1] >= border)
        & (uv[..., 1] < intr.height - border)
    )
