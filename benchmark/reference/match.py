"""Descriptor matching by one Hamming-distance matmul (frozen copy of
spslam_tpu_torch/ops/match.py).

A 256-bit Hamming distance is |a| + |b| - 2 a.b over {0,1} vectors, so the
whole distance matrix is one float32 matmul (exact: integers <= 256).
Window/octave gates are masks on that matrix.

argmin ties: distances are integers, so equal values are common; JAX takes
the first index and so does `torch.argmin` (documented, CPU and CUDA).

`rotation_consistency` (ORBmatcher's CheckOrientation) votes the matches'
angle differences into a 30-bin histogram of integer counts, so equal bins
are common; `lax.top_k` ranks them by the lower index, and so does the
stable descending sort used here (`torch.topk` promises no tie order).
The tracking path calls the matcher without angles (no rotation check);
relocalization and the loop check pass them.
"""

from __future__ import annotations

import math

from typing import NamedTuple

import torch

BIG = 1e9
HISTO_BINS = 30

# Reference-family thresholds (ORBmatcher.cc TH_LOW/TH_HIGH).
TH_LOW = 50.0
TH_HIGH = 100.0


def hamming_matrix(bits_a: torch.Tensor, bits_b: torch.Tensor) -> torch.Tensor:
    """[Na, 256] x [Nb, 256] {0,1} float32 -> [Na, Nb] Hamming distances."""
    dots = bits_a @ bits_b.T
    pa = torch.sum(bits_a, dim=-1, keepdim=True)
    pb = torch.sum(bits_b, dim=-1, keepdim=True)
    return pa + pb.T - 2.0 * dots


class MatchResult(NamedTuple):
    idx: torch.Tensor    # [Na] int32 best column per row (-1 if no match)
    dist: torch.Tensor   # [Na] float32 best distance (BIG if none)
    valid: torch.Tensor  # [Na] bool


def _top2(dist: torch.Tensor):
    """Row-wise best, its (first) index, and second-best."""
    best = torch.amin(dist, dim=-1)
    best_idx = torch.argmin(dist, dim=-1).to(torch.int32)
    onehot = torch.nn.functional.one_hot(best_idx.long(), dist.shape[-1]).to(dist.dtype)
    second = torch.amin(dist + BIG * onehot, dim=-1)
    return best, best_idx, second


def rotation_consistency(angle_a: torch.Tensor, angle_b_matched: torch.Tensor,
                         valid: torch.Tensor) -> torch.Tensor:
    """Keep the matches whose angle difference falls in the 3 most popular
    of 30 bins.  Returns the refined validity mask."""
    diff = angle_a - angle_b_matched
    frac = torch.remainder(diff / (2.0 * math.pi), 1.0)
    bins = torch.clamp((frac * HISTO_BINS).to(torch.int32), 0, HISTO_BINS - 1)
    onehot = torch.nn.functional.one_hot(bins.long(), HISTO_BINS).to(torch.float32)
    hist = torch.sum(onehot * valid[:, None].to(torch.float32), dim=0)
    top3 = torch.argsort(-hist, stable=True)[:3]
    in_top3 = (bins.long()[:, None] == top3[None, :]).any(dim=-1)
    return valid & in_top3


def match_descriptors(bits_a: torch.Tensor, bits_b: torch.Tensor,
                      valid_a: torch.Tensor, valid_b: torch.Tensor,
                      angles_a: torch.Tensor | None = None,
                      angles_b: torch.Tensor | None = None,
                      max_dist: float = TH_LOW, ratio: float = 0.9,
                      check_rotation: bool = True,
                      gate: torch.Tensor | None = None) -> MatchResult:
    """Gated mutual-best matcher with a ratio test; with both angle arrays
    and check_rotation, the rotation-histogram check too."""
    d = hamming_matrix(bits_a, bits_b)
    mask = valid_a[:, None] & valid_b[None, :]
    if gate is not None:
        mask = mask & gate
    d = torch.where(mask, d, BIG)

    best, best_idx, second = _top2(d)
    ok = (best <= max_dist) & (best < ratio * second)
    col_best_row = torch.argmin(d, dim=0).to(torch.int32)           # [Nb]
    rows = torch.arange(d.shape[0], dtype=torch.int32, device=d.device)
    mutual = col_best_row[best_idx.long()] == rows
    ok = ok & mutual & valid_a
    if check_rotation and angles_a is not None and angles_b is not None:
        ok = rotation_consistency(angles_a, angles_b[best_idx.long()], ok)
    return MatchResult(
        idx=torch.where(ok, best_idx, -1),
        dist=torch.where(ok, best, BIG),
        valid=ok,
    )


def window_gate(uv_a: torch.Tensor, uv_b: torch.Tensor, radius_a: torch.Tensor,
                octave_a: torch.Tensor | None = None, octave_b: torch.Tensor | None = None,
                octave_slack: int = 1) -> torch.Tensor:
    """[Na, Nb] bool: b inside a's window, octaves within +-octave_slack."""
    d2 = torch.sum((uv_a[:, None, :] - uv_b[None, :, :]) ** 2, dim=-1)
    g = d2 <= (radius_a[:, None] ** 2)
    if octave_a is not None and octave_b is not None:
        diff = octave_b[None, :] - octave_a[:, None]
        g = g & (diff >= -octave_slack) & (diff <= octave_slack)
    return g


def search_by_projection(proj_uv, proj_bits, proj_valid, proj_octave,
                         kp_uv, kp_bits, kp_valid, kp_octave, radius,
                         max_dist: float = TH_HIGH, ratio: float = 0.9,
                         octave_slack: int = 1, kp_angles: torch.Tensor | None = None,
                         proj_angles: torch.Tensor | None = None,
                         check_rotation: bool = True) -> MatchResult:
    """Projected map points (rows) against frame keypoints (cols) within
    per-point windows — the reference's SearchByProjection.  The angle
    arguments are keywords here (positional before `radius` in the
    reference); without them there is no rotation check."""
    gate = window_gate(proj_uv, kp_uv, radius, proj_octave, kp_octave,
                       octave_slack=octave_slack)
    return match_descriptors(proj_bits, kp_bits, proj_valid, kp_valid, proj_angles, kp_angles,
                             max_dist=max_dist, ratio=ratio, check_rotation=check_rotation,
                             gate=gate)
