"""Descriptor matching by one Hamming-distance matmul (port of
spslam_tpu/ops/match.py).

A 256-bit Hamming distance is |a| + |b| - 2 a.b over {0,1} vectors, so the
whole distance matrix is one float32 matmul (exact: integers <= 256).
Window/octave gates are masks on that matrix.

argmin ties: distances are integers, so equal values are common; JAX takes
the first index and so does `torch.argmin` (documented, CPU and CUDA).
`rotation_consistency` is not here: the tracking path calls the matcher
with check_rotation=False; it comes with relocalization.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

BIG = 1e9

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


def match_descriptors(bits_a: torch.Tensor, bits_b: torch.Tensor,
                      valid_a: torch.Tensor, valid_b: torch.Tensor,
                      max_dist: float = TH_LOW, ratio: float = 0.9,
                      gate: torch.Tensor | None = None) -> MatchResult:
    """Gated mutual-best matcher with a ratio test (check_rotation=False
    form of the reference's match_descriptors)."""
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
                         octave_slack: int = 1) -> MatchResult:
    """Projected map points (rows) against frame keypoints (cols) within
    per-point windows — the reference's SearchByProjection."""
    gate = window_gate(proj_uv, kp_uv, radius, proj_octave, kp_octave,
                       octave_slack=octave_slack)
    return match_descriptors(proj_bits, kp_bits, proj_valid, kp_valid,
                             max_dist=max_dist, ratio=ratio, gate=gate)
