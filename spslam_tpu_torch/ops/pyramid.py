"""True-size image pyramid (port of spslam_tpu/ops/pyramid.py).

Every level is resampled from the base image with bilinear interpolation
and kept at its real [h_l, w_l] shape; downstream FAST, blur and patch
gathers work per level.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch


class PyramidSpec(NamedTuple):
    """Static pyramid description (hashable)."""

    n_levels: int
    scale_factor: float
    height: int
    width: int

    @property
    def scales(self) -> Tuple[float, ...]:
        return tuple(self.scale_factor ** i for i in range(self.n_levels))

    @property
    def level_sizes(self) -> Tuple[Tuple[int, int], ...]:
        return tuple(
            (int(round(self.height / s)), int(round(self.width / s)))
            for s in self.scales
        )


def _resize_bilinear(img: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """Bilinear resize, pixel-center convention (align_corners=False)."""
    h, w = img.shape
    sy = h / out_h
    sx = w / out_w
    dev = img.device
    ys = (torch.arange(out_h, dtype=torch.float32, device=dev) + 0.5) * sy - 0.5
    xs = (torch.arange(out_w, dtype=torch.float32, device=dev) + 0.5) * sx - 0.5
    y0 = torch.clamp(torch.floor(ys), 0, h - 1)
    x0 = torch.clamp(torch.floor(xs), 0, w - 1)
    y1 = torch.clamp(y0 + 1, 0, h - 1)
    x1 = torch.clamp(x0 + 1, 0, w - 1)
    wy = torch.clamp(ys - y0, 0.0, 1.0)[:, None]
    wx = torch.clamp(xs - x0, 0.0, 1.0)[None, :]
    y0i, y1i, x0i, x1i = y0.long(), y1.long(), x0.long(), x1.long()
    a = img[y0i][:, x0i]
    b = img[y0i][:, x1i]
    c = img[y1i][:, x0i]
    d = img[y1i][:, x1i]
    top = a * (1 - wx) + b * wx
    bot = c * (1 - wx) + d * wx
    return top * (1 - wy) + bot * wy


def gaussian_blur7(img: torch.Tensor, sigma: float = 2.0) -> torch.Tensor:
    """Separable 7x7 Gaussian blur with edge (replicate) padding."""
    r = 3
    H, W = img.shape
    xs = torch.arange(-r, r + 1, dtype=torch.float32, device=img.device)
    k = torch.exp(-0.5 * (xs / sigma) ** 2)
    k = k / torch.sum(k)
    rows = torch.clamp(torch.arange(-r, H + r, device=img.device), 0, H - 1)
    pad = img[rows]
    v = sum(pad[i : i + H, :] * k[i] for i in range(2 * r + 1))
    cols = torch.clamp(torch.arange(-r, W + r, device=img.device), 0, W - 1)
    pad = v[:, cols]
    return sum(pad[:, i : i + W] * k[i] for i in range(2 * r + 1))


def build_pyramid_levels(img: torch.Tensor, spec: PyramidSpec, blur: bool = True):
    """Returns (levels, levels_blur) as tuples of [h_l, w_l] float32 tensors
    (levels_blur is () when blur=False)."""
    img = img.to(torch.float32)
    levels = []
    blurs = []
    for (h_l, w_l) in spec.level_sizes:
        lvl = _resize_bilinear(img, h_l, w_l) if (h_l, w_l) != tuple(img.shape) else img
        levels.append(lvl)
        if blur:
            blurs.append(gaussian_blur7(lvl))
    return tuple(levels), tuple(blurs)
