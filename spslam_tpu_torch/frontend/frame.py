"""Frame construction: image + depth -> keypoints, descriptors, 3D backing
(port of spslam_tpu/frontend/frame.py)."""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..geometry.camera import Intrinsics, in_image, undistort_points, unproject, virtual_right_u
from ..ops.brief import describe_levels, unpack_bits
from ..ops.fast import detect_levels, level_feature_counts
from ..ops.pyramid import PyramidSpec, build_pyramid_levels


class FrameData(NamedTuple):
    """Per-frame feature bundle (fixed budget N with validity masks)."""

    uv: torch.Tensor        # [N, 2] undistorted level-0 pixel coords
    uv_raw: torch.Tensor    # [N, 2] raw (distorted) level-0 pixel coords
    octave: torch.Tensor    # [N] int32
    angle: torch.Tensor     # [N] float32 radians
    score: torch.Tensor     # [N] float32 FAST response
    desc: torch.Tensor      # [N, 8] int32 holding uint32 rBRIEF words
    bits: torch.Tensor      # [N, 256] float32 {0,1} unpacked
    depth: torch.Tensor     # [N] float32 (0 where invalid)
    u_right: torch.Tensor   # [N] float32 virtual right u (-1 where invalid)
    xyz_cam: torch.Tensor   # [N, 3] camera-frame 3D point (0 where no depth)
    valid: torch.Tensor     # [N] bool keypoint exists
    has_depth: torch.Tensor # [N] bool valid AND depth > 0


def _sample_depth(depth_img: torch.Tensor, uv: torch.Tensor, full_hw: tuple) -> torch.Tensor:
    """Nearest depth sample at keypoint coords; the depth image may be
    subsampled relative to the gray image (full_hw)."""
    H, W = depth_img.shape
    sx = W / full_hw[1]
    sy = H / full_hw[0]
    x = torch.clamp(torch.round(uv[..., 0] * sx).long(), 0, W - 1)
    y = torch.clamp(torch.round(uv[..., 1] * sy).long(), 0, H - 1)
    return depth_img[y, x]


def build_frame(gray: torch.Tensor, depth_img: torch.Tensor, spec: PyramidSpec,
                intr: Intrinsics, n_features: int = 1024, th_high: float = 20.0,
                th_low: float = 7.0) -> FrameData:
    """gray: [H, W] float32 0..255; depth_img: [h, w] float32 meters (0 = none)."""
    levels, levels_blur = build_pyramid_levels(gray, spec, blur=True)
    det = detect_levels(levels, spec, n_features=n_features, th_high=th_high, th_low=th_low)
    counts = level_feature_counts(spec, n_features)
    angle, desc = describe_levels(levels_blur, det["xy_level"], counts)

    uv_raw = det["xy"]
    uv = undistort_points(intr, uv_raw)
    valid = det["valid"] & in_image(intr, uv)

    d = _sample_depth(depth_img, uv_raw, (gray.shape[0], gray.shape[1]))
    has_depth = valid & (d > 1e-6)
    d = torch.where(has_depth, d, 0.0)
    xyz = unproject(intr, uv, d)
    xyz = torch.where(has_depth[:, None], xyz, 0.0)
    ur = virtual_right_u(intr, uv[..., 0], d)

    return FrameData(
        uv=uv, uv_raw=uv_raw, octave=det["octave"], angle=angle,
        score=det["score"], desc=desc, bits=unpack_bits(desc), depth=d,
        u_right=ur, xyz_cam=xyz, valid=valid, has_depth=has_depth,
    )
