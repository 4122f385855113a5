"""FAST-9/16 corners + 3x3 NMS + tiled top-k (port of spslam_tpu/ops/fast.py).

`fast_score_map` and `nms3x3` are the plain PyTorch versions of the fused
kernel in ops/fast_cuda.py; `detect_levels` calls the dispatch
`fast_cuda.fast_nms_scores_levels` once for all levels, which launches the
CUDA kernel once for CUDA tensors and uses these plain versions only for
CPU tensors.  The detection border is part of that function.

Top-k ties: FAST scores of u8 images are integer-valued, so equal scores
are common.  `jax.lax.top_k` returns the lower index first among equals;
`torch.topk` promises no order, so the selections here use a STABLE
descending sort and slice, which gives the same order.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .pyramid import PyramidSpec

# Bresenham circle of radius 3 (same order as OpenCV FAST_9_16), (dx, dy).
CIRCLE_OFFSETS = (
    (0, 3), (1, 3), (2, 2), (3, 1), (3, 0), (3, -1), (2, -2), (1, -3),
    (0, -3), (-1, -3), (-2, -2), (-3, -1), (-3, 0), (-3, 1), (-2, 2), (-1, 3),
)

ARC_LEN = 9  # FAST_9_16 contiguity requirement
SCORE_BONUS = 1e6  # added to corners passing the high threshold


def _shift2d(img: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    """out[y, x] = img[y + dy, x + dx] with wrap-around (border masked later)."""
    return torch.roll(img, shifts=(-dy, -dx), dims=(0, 1))


def fast_score_map(img: torch.Tensor, th_low: float, th_high: float) -> torch.Tensor:
    """Per-pixel FAST-9/16 score: max over bright/dark of the best
    9-contiguous arc-min; 0 unless > th_low; +SCORE_BONUS where > th_high."""
    ring = torch.stack([_shift2d(img, dy, dx) for (dx, dy) in CIRCLE_OFFSETS])
    diff = ring - img[None]

    def arc_min_max(d):
        # circular sliding-window min of length 9 by log-doubling, then max
        w2 = torch.minimum(d, torch.roll(d, -1, dims=0))
        w4 = torch.minimum(w2, torch.roll(w2, -2, dims=0))
        w8 = torch.minimum(w4, torch.roll(w4, -4, dims=0))
        w9 = torch.minimum(w8, torch.roll(d, -8, dims=0))
        return torch.amax(w9, dim=0)

    score = torch.maximum(arc_min_max(diff), arc_min_max(-diff))
    out = torch.where(score > th_low, score, 0.0)
    return out + torch.where(score > th_high, SCORE_BONUS, 0.0)


def compass_reject(img: torch.Tensor, th_low: float) -> torch.Tensor:
    """Plain version of the kernel's exact early reject: True where
    `fast_score_map` is certainly 0.  Any 9-arc of the ring holds two
    neighbouring compass pixels (ring positions 0, 4, 8, 12), one of
    north/south and one of east/west, so a score above th_low needs
    max(n, s) and max(e, w) above th_low (a bright arc) or min(n, s) and
    min(e, w) below -th_low (a dark one)."""
    n, e, s, w = (_shift2d(img, *CIRCLE_OFFSETS[k][::-1]) - img for k in (0, 4, 8, 12))
    hi = torch.minimum(torch.maximum(n, s), torch.maximum(e, w))
    lo = torch.maximum(torch.minimum(n, s), torch.minimum(e, w))
    return ~((hi > th_low) | (lo < -th_low))


def nms3x3(score: torch.Tensor) -> torch.Tensor:
    """Keep 3x3 local maxima: strict > against raster-earlier neighbours,
    >= against later ones."""
    keep = torch.ones_like(score, dtype=torch.bool)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dy == 0 and dx == 0:
                continue
            nb = _shift2d(score, dy, dx)
            if (dy, dx) < (0, 0) or ((dy, dx) == (0, -1)):
                keep &= score > nb
            else:
                keep &= score >= nb
    return torch.where(keep, score, 0.0)


def _topk_stable(x: torch.Tensor, k: int):
    """Top-k along the last dim, lower index first among equal values."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


class LevelKeypoints(NamedTuple):
    xy: torch.Tensor     # [N, 2] float32 (x, y) in level pixel coords
    score: torch.Tensor  # [N] float32 (bonus removed)
    valid: torch.Tensor  # [N] bool


def select_tiled_topk(score: torch.Tensor, n_out: int, tile: int = 32,
                      k_per_tile: int = 8) -> LevelKeypoints:
    """Top-k per tile, then global top-n over the tile winners."""
    H, W = score.shape
    ph = (-H) % tile
    pw = (-W) % tile
    s = torch.nn.functional.pad(score, (0, pw, 0, ph))
    Hp, Wp = H + ph, W + pw
    ty, tx = Hp // tile, Wp // tile
    tiles = s.reshape(ty, tile, tx, tile).permute(0, 2, 1, 3).reshape(ty * tx, tile * tile)
    vals, idx = _topk_stable(tiles, k_per_tile)              # [T, k]
    t = torch.arange(ty * tx, device=score.device)
    yy = (t // tx)[:, None] * tile + idx // tile
    xx = (t % tx)[:, None] * tile + idx % tile
    flat_vals = vals.reshape(-1)
    n_out = min(n_out, flat_vals.shape[0])
    top_vals, top_i = _topk_stable(flat_vals, n_out)
    sel_y = yy.reshape(-1)[top_i].to(torch.float32)
    sel_x = xx.reshape(-1)[top_i].to(torch.float32)
    valid = top_vals > 0.0
    score_clean = torch.where(top_vals >= SCORE_BONUS, top_vals - SCORE_BONUS, top_vals)
    xy = torch.stack([sel_x, sel_y], dim=-1)
    return LevelKeypoints(xy=xy, score=torch.where(valid, score_clean, 0.0), valid=valid)


def level_feature_counts(spec: PyramidSpec, n_features: int) -> tuple:
    """Per-level feature budgets, geometric in 1/scale_factor."""
    inv = 1.0 / spec.scale_factor
    counts = []
    acc = 0
    ndesired = n_features * (1 - inv) / (1 - inv ** spec.n_levels)
    for lvl in range(spec.n_levels - 1):
        c = int(round(ndesired * inv ** lvl))
        counts.append(c)
        acc += c
    counts.append(max(n_features - acc, 0))
    return tuple(counts)


def detect_levels(levels, spec: PyramidSpec, n_features: int = 1024,
                  th_high: float = 20.0, th_low: float = 7.0, border: int = 19,
                  tile: int = 32, k_per_tile: int = 8):
    """FAST + NMS + tiled top-k over a true-size level tuple; keypoints stay
    grouped by level with the static counts of `level_feature_counts`."""
    from .fast_cuda import fast_nms_scores_levels

    counts = level_feature_counts(spec, n_features)
    out_xy_l, out_xy0, out_score, out_oct, out_valid = [], [], [], [], []
    for lvl in range(spec.n_levels):
        h_l, w_l = spec.level_sizes[lvl]
        cap = (-(-h_l // tile)) * (-(-w_l // tile)) * k_per_tile
        if counts[lvl] > cap:
            raise ValueError(
                f"level {lvl}: budget {counts[lvl]} exceeds tile capacity {cap} "
                f"({h_l}x{w_l}, tile={tile}, k_per_tile={k_per_tile})"
            )
    # FAST + NMS + border of all levels: one kernel launch on the card
    scores = fast_nms_scores_levels(levels[: spec.n_levels], th_low, th_high, border)
    for lvl, score in enumerate(scores):
        kps = select_tiled_topk(score, counts[lvl], tile=tile, k_per_tile=k_per_tile)
        s = spec.scale_factor ** lvl
        out_xy_l.append(kps.xy)
        out_xy0.append(kps.xy * s)
        out_score.append(kps.score)
        out_oct.append(torch.full((kps.xy.shape[0],), lvl, dtype=torch.int32,
                                  device=score.device))
        out_valid.append(kps.valid)
    return {
        "xy_level": torch.cat(out_xy_l),
        "xy": torch.cat(out_xy0),
        "score": torch.cat(out_score),
        "octave": torch.cat(out_oct),
        "valid": torch.cat(out_valid),
    }
