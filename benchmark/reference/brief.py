"""Oriented rBRIEF: intensity-centroid angle + steered 256-bit descriptors
(frozen copy of spslam_tpu_torch/ops/brief.py).

The tables are rebuilt with the reference's numpy code (same seed), so
they equal the JAX arrays.  Both products, [N,1089]x[1089,2] for the
moments and [N,1089]x[1089,7680] for every steering bin's bit tests, stay
`torch.matmul` in float32 (TF32 is off, see the package __init__).

Descriptors are [N, 8] int32 tensors holding the uint32 words' bits
(PyTorch's uint32 support is partial); the host views them as uint32.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

PATCH_R = 16          # gathered patch radius (patch is 33x33)
ORIENT_R = 15         # intensity-centroid radius
N_BITS = 256
PATTERN_CLIP = 13.0   # keep rotated samples inside the gathered patch
N_ANGLE_BINS = 30     # steering bins of 2*pi/30


def _make_pattern(seed: int = 7) -> np.ndarray:
    """[256, 2, 2] float32 — per bit, two (x, y) offsets."""
    rng = np.random.default_rng(seed)
    sigma = 31.0 / 5.0
    pts = rng.normal(0.0, sigma, size=(N_BITS, 2, 2))
    r = np.linalg.norm(pts, axis=-1, keepdims=True)
    scale = np.minimum(1.0, PATTERN_CLIP / np.maximum(r, 1e-9))
    return (pts * scale).astype(np.float32)


BRIEF_PATTERN = _make_pattern()

_yy, _xx = np.mgrid[-ORIENT_R : ORIENT_R + 1, -ORIENT_R : ORIENT_R + 1]
_CIRC = (_yy ** 2 + _xx ** 2 <= ORIENT_R ** 2).astype(np.float32)
# the orientation disc and its coordinates, [31, 31] float32 host tensors
ORIENT_MASK = torch.from_numpy(_CIRC)
ORIENT_X = torch.from_numpy(_xx.astype(np.float32))
ORIENT_Y = torch.from_numpy(_yy.astype(np.float32))


def _make_moment_matrix() -> np.ndarray:
    """[1089, 2]: masked x / y moment weights in full-patch layout."""
    size = 2 * PATCH_R + 1
    M = np.zeros((size, size, 2), np.float32)
    lo = PATCH_R - ORIENT_R
    hi = PATCH_R + ORIENT_R + 1
    M[lo:hi, lo:hi, 0] = _xx * _CIRC
    M[lo:hi, lo:hi, 1] = _yy * _CIRC
    return M.reshape(size * size, 2)


def _make_diff_matrix() -> np.ndarray:
    """[1089, 30*256]: column b*256+s holds +1 at the rotated first sample
    and -1 at the second, for steering bin b."""
    size = 2 * PATCH_R + 1
    c = PATCH_R
    pat = _make_pattern()
    D = np.zeros((size * size, N_ANGLE_BINS * N_BITS), np.float32)
    for b in range(N_ANGLE_BINS):
        th = 2.0 * np.pi * b / N_ANGLE_BINS
        ca, sa = np.cos(th), np.sin(th)
        rx = ca * pat[..., 0] - sa * pat[..., 1]
        ry = sa * pat[..., 0] + ca * pat[..., 1]
        ix = np.clip(np.round(rx).astype(np.int64) + c, 0, size - 1)
        iy = np.clip(np.round(ry).astype(np.int64) + c, 0, size - 1)
        flat = iy * size + ix
        cols = b * N_BITS + np.arange(N_BITS)
        np.add.at(D, (flat[:, 0], cols), 1.0)
        np.add.at(D, (flat[:, 1], cols), -1.0)
    return D


MOMENT_MATRIX = _make_moment_matrix()
# [1089, 7680] float32 host tensor (33 MB, ~20 ms to build)
BRIEF_DIFF_MATRIX = torch.from_numpy(_make_diff_matrix())


@functools.lru_cache(maxsize=None)
def _tables(device: torch.device):
    """(MOMENT_MATRIX, BRIEF_DIFF_MATRIX) as tensors on `device`."""
    return torch.from_numpy(MOMENT_MATRIX).to(device), BRIEF_DIFF_MATRIX.to(device)


def ic_angle(patches: torch.Tensor) -> torch.Tensor:
    """Intensity-centroid orientation [N] of [N, 33, 33] patches."""
    n = patches.shape[0]
    moment, _ = _tables(patches.device)
    m = patches.reshape(n, -1) @ moment
    return torch.atan2(m[:, 1], m[:, 0])


def pack_words(bits: torch.Tensor) -> torch.Tensor:
    """[N, 32*k] {0,1} -> [N, k] int32 holding the uint32 words' bits
    (bit j of word w = bits[:, 32*w + j])."""
    n = bits.shape[0]
    shifts = torch.arange(32, dtype=torch.int64, device=bits.device)
    words = torch.sum(bits.to(torch.int64).reshape(n, -1, 32) << shifts, dim=-1)
    return to_int32_bits(words)


def to_int32_bits(v: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> int32 with the same low 32 bits."""
    return torch.where(v >= 2 ** 31, v - 2 ** 32, v).to(torch.int32)


def brief_descriptors(patches: torch.Tensor, angles: torch.Tensor) -> torch.Tensor:
    """Steered BRIEF: [N, 33, 33] blurred patches, [N] radians -> [N, 8] int32."""
    n = patches.shape[0]
    _, diff_m = _tables(patches.device)
    diff_all = (patches.reshape(n, -1) @ diff_m).reshape(n, N_ANGLE_BINS, N_BITS)
    step = 2.0 * np.pi / N_ANGLE_BINS
    # round() is half-to-even like jnp.round; remainder is floor modulo
    bin_idx = torch.remainder(torch.round(angles / step).to(torch.int64), N_ANGLE_BINS)
    diff = diff_all[torch.arange(n, device=patches.device), bin_idx]   # [N, 256]
    return pack_words(diff < 0)


def unpack_bits(desc: torch.Tensor) -> torch.Tensor:
    """[N, 8] int32 (uint32 bits) -> [N, 256] {0,1} float32."""
    shifts = torch.arange(32, dtype=torch.int32, device=desc.device)
    bits = (desc[:, :, None] >> shifts) & 1
    return bits.reshape(desc.shape[0], 256).to(torch.float32)


def gather_patches_level(img: torch.Tensor, xy: torch.Tensor, r: int = PATCH_R) -> torch.Tensor:
    """[n, 2r+1, 2r+1] patches from one level image at rounded xy, clamped
    so the patch stays inside the image."""
    H, W = img.shape
    cx = torch.clamp(torch.round(xy[:, 0]).long(), r, W - r - 1)
    cy = torch.clamp(torch.round(xy[:, 1]).long(), r, H - r - 1)
    off = torch.arange(-r, r + 1, device=img.device)
    rows = (cy[:, None] + off)[:, :, None]
    cols = (cx[:, None] + off)[:, None, :]
    return img[rows, cols]


def describe_levels(levels_blur, xy_level: torch.Tensor, counts: tuple):
    """(angles [N], desc [N, 8] int32) over keypoints grouped by level with
    the static per-level `counts`."""
    patches = []
    start = 0
    for lvl, c in enumerate(counts):
        if c == 0:
            continue
        patches.append(gather_patches_level(levels_blur[lvl], xy_level[start : start + c]))
        start += c
    patches = torch.cat(patches)
    angles = ic_angle(patches)
    return angles, brief_descriptors(patches, angles)
