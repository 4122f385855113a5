"""Plane segmentation from a depth image (port of spslam_tpu/ops/plane_seg.py):
block PCA seeding, gated region merging on the block grid, per-segment
least-squares refit, top-K segments by support.

1. unproject the depth image to an organized cloud;
2. per-block (8x8) moments -> batched 3x3 eigh -> seed normals, curvature
   and a sensor-noise gate;
3. connected components on the block grid by iterated min-label
   propagation with pointer jumping, gated on normal agreement and mutual
   point-to-plane distance (a fixed number of iterations);
4. per-segment moment sums (index_add_) -> smallest eigenvector of the
   segment scatter, top-K by pixel support, segment residual gate.

Precision: every moment is an elementwise float32 product and sum, never a
matmul, so TF32 cannot reach them on the card.  The block covariance is
taken from centred coordinates; only the segment refit uses E[xx] - mu mu^T,
where the reference does.  (The reference asks for HIGHEST matmul
precision at the same places: bf16 moments shattered the segmentation on
its TPU.)

Divergences from the reference, each giving the same result up to float
summation order:
* the segment sums are `index_add_` (atomics in run-dependent order on
  CUDA) where the reference scatter-adds; pixel counts stay exact;
* `lax.top_k` becomes a stable descending sort, which keeps its
  lowest-index-first order among equal supports (unsupported segments
  all tie at 0).
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from ..geometry.camera import Intrinsics

_INF = 1 << 30   # label of a block that belongs to no segment


class FramePlanes(NamedTuple):
    coef: torch.Tensor         # [K, 4] plane (n, d) in the camera frame, n.x + d = 0
    n_inliers: torch.Tensor    # [K] int32 supporting pixel count
    centroid: torch.Tensor     # [K, 3] mean of the supporting points
    valid: torch.Tensor        # [K] bool
    block_label: torch.Tensor  # [BH, BW] int32 segment index per block (-1 none)


def _outer_sym(a: torch.Tensor, b: torch.Tensor, dims=None) -> torch.Tensor:
    """a_i b_j as [..., 3, 3], summed over `dims` when given, by elementwise
    products (the 6 distinct entries of a symmetric result)."""
    e = {}
    for i in range(3):
        for j in range(i, 3):
            prod = a[..., i] * b[..., j]
            e[i, j] = e[j, i] = prod if dims is None else torch.sum(prod, dim=dims)
    return torch.stack([torch.stack([e[i, j] for j in range(3)], dim=-1)
                        for i in range(3)], dim=-2)


def _block_moments(xyz: torch.Tensor, valid: torch.Tensor, bs: int):
    """Per-block (count [BH,BW], mean [BH,BW,3], covariance [BH,BW,3,3])
    from centred coordinates."""
    H, W, _ = xyz.shape
    BH, BW = H // bs, W // bs
    v = valid[: BH * bs, : BW * bs].reshape(BH, bs, BW, bs).to(xyz.dtype)
    p = xyz[: BH * bs, : BW * bs].reshape(BH, bs, BW, bs, 3) * v[..., None]
    cnt = v.sum((1, 3))
    s1 = p.sum((1, 3))
    safe = torch.clamp_min(cnt, 1.0)
    mean = s1 / safe[..., None]
    pc = (p - mean[:, None, :, None, :]) * v[..., None]
    cov = _outer_sym(pc, pc, (1, 3)) / safe[..., None, None]
    return cnt, mean, cov


def _plane_from_cov(mean: torch.Tensor, cov: torch.Tensor):
    """Smallest-eigenvector normal oriented toward the camera, d, curvature,
    residual and the disc-vs-rod shape gate; batched."""
    w, V = torch.linalg.eigh(cov)              # ascending eigenvalues
    normal = V[..., :, 0]
    # a planar patch has two significant spread axes (a depth-noise rod
    # along the viewing ray has lambda1 << lambda2)
    disc = w[..., 1] > 0.05 * w[..., 2]
    flip = torch.sum(normal * mean, dim=-1, keepdim=True) > 0
    normal = torch.where(flip, -normal, normal)
    d = -torch.sum(normal * mean, dim=-1)
    curvature = w[..., 0] / torch.clamp_min(w.sum(-1), 1e-12)
    mse = w[..., 0]
    return normal, d, curvature, mse, disc


def _propagate_labels(labels: torch.Tensor, ok_r: torch.Tensor, ok_d: torch.Tensor,
                      n_iters: int) -> torch.Tensor:
    """Min-label connected components on the block grid with edge gates:
    ok_r[h, w] gates (h,w)-(h,w+1), ok_d gates (h,w)-(h+1,w).  Each
    iteration is one 4-neighbour min pass and two pointer-jumping hops."""
    BH, BW = labels.shape
    okl = F.pad(ok_r[:, :-1], (1, 0))
    oku = F.pad(ok_d[:-1, :], (0, 0, 1, 0))
    lab = labels
    for _ in range(n_iters):
        P = F.pad(lab, (1, 1, 1, 1), value=_INF)
        m = lab
        m = torch.minimum(m, torch.where(ok_r, P[1:-1, 2:], _INF))
        m = torch.minimum(m, torch.where(okl, P[1:-1, :-2], _INF))
        m = torch.minimum(m, torch.where(ok_d, P[2:, 1:-1], _INF))
        m = torch.minimum(m, torch.where(oku, P[:-2, 1:-1], _INF))
        m = torch.where(lab < _INF, m, lab)
        flat = m.reshape(-1)
        hop = torch.where(flat < _INF, flat[torch.clamp_max(flat, BH * BW - 1).long()], flat)
        hop2 = torch.where(hop < _INF, hop[torch.clamp_max(hop, BH * BW - 1).long()], hop)
        lab = hop2.reshape(BH, BW)
    return lab


def segment_planes(depth: torch.Tensor, intr: Intrinsics, block: int = 8,
                   max_planes: int = 8, n_prop_iters: int = 24, max_depth: float = 8.0,
                   curvature_th: float = 0.01, mse_th: float = 4e-4,
                   angle_cos_th: float = 0.95, dist_th: float = 0.05, min_blocks: int = 30,
                   depth_sigma_frac: float = 0.008) -> FramePlanes:
    """Segment the dominant planes of a depth image [H, W] (float32 meters)
    on its device; no host sync besides what `torch.linalg.eigh` does.

    Gates as in the reference: per-block planarity by curvature + MSE, or a
    residual the sensor's fractional depth noise (depth_sigma_frac of z)
    explains; merges by normal angle and mutual centroid-to-plane distance;
    segments of >= min_blocks blocks whose refit residual stays within
    twice the noise level.
    """
    H, W = depth.shape
    dev = depth.device
    ys = torch.arange(H, dtype=torch.float32, device=dev)[:, None]
    xs = torch.arange(W, dtype=torch.float32, device=dev)[None, :]
    z = depth
    valid = (z > 1e-3) & (z < max_depth)
    x = (xs - intr.cx) / intr.fx * z
    y = (ys - intr.cy) / intr.fy * z
    xyz = torch.stack([x, y, z], dim=-1)

    cnt, mean, cov = _block_moments(xyz, valid, block)
    normal, d, curvature, mse, disc = _plane_from_cov(mean, cov)
    BH, BW = cnt.shape
    zs = torch.clamp_min(mean[..., 2], 1.0)
    sigma = depth_sigma_frac * zs
    clean_ok = (curvature < curvature_th) & (mse < mse_th * zs ** 2)
    noise_ok = mse < (1.5 * sigma) ** 2
    planar = (cnt >= 0.8 * block * block) & (clean_ok | noise_ok) & disc

    def edge_ok(na, ca, nb, cb, pa, pb):
        cos = torch.sum(na * nb, dim=-1)
        dist_ab = torch.abs(torch.sum(na * (cb - ca), dim=-1))
        dist_ba = torch.abs(torch.sum(nb * (ca - cb), dim=-1))
        scale = torch.clamp_min(torch.maximum(ca[..., 2], cb[..., 2]), 1.0)
        return (pa & pb & (cos > angle_cos_th)
                & (dist_ab < dist_th * scale) & (dist_ba < dist_th * scale))

    ok_r = F.pad(edge_ok(normal[:, :-1], mean[:, :-1], normal[:, 1:], mean[:, 1:],
                         planar[:, :-1], planar[:, 1:]), (0, 1))
    ok_d = F.pad(edge_ok(normal[:-1], mean[:-1], normal[1:], mean[1:],
                         planar[:-1], planar[1:]), (0, 0, 0, 1))
    nb = BH * BW
    init = torch.where(planar, torch.arange(nb, dtype=torch.int32, device=dev).reshape(BH, BW),
                       _INF)
    labels = _propagate_labels(init, ok_r, ok_d, n_prop_iters)

    # --- per-segment aggregation ------------------------------------------
    flat = labels.reshape(-1)
    seg_valid = flat < _INF
    seg_ids = torch.where(seg_valid, flat, 0).long()
    cnt_f = cnt.reshape(-1)
    mean_f = mean.reshape(-1, 3)
    w_blk = torch.where(seg_valid, cnt_f, 0.0)
    sum_w = torch.zeros(nb, device=dev).index_add_(0, seg_ids, w_blk)
    sum_x = torch.zeros(nb, 3, device=dev).index_add_(0, seg_ids, mean_f * w_blk[:, None])
    # block scatter = cnt * (cov + mean mean^T)
    blk_s2 = cnt_f[:, None, None] * (cov.reshape(-1, 3, 3) + _outer_sym(mean_f, mean_f))
    sum_xx = torch.zeros(nb, 3, 3, device=dev).index_add_(
        0, seg_ids, torch.where(seg_valid[:, None, None], blk_s2, 0.0))
    blocks_per_seg = torch.zeros(nb, device=dev).index_add_(0, seg_ids, seg_valid.to(cnt_f.dtype))

    support = torch.where(blocks_per_seg >= min_blocks, sum_w, 0.0)
    top_support, top_seg = torch.sort(support, descending=True, stable=True)
    top_support, top_seg = top_support[:max_planes], top_seg[:max_planes]
    k_valid = top_support > 0

    seg_w = torch.clamp_min(sum_w[top_seg], 1.0)
    seg_mean = sum_x[top_seg] / seg_w[:, None]
    seg_cov = sum_xx[top_seg] / seg_w[:, None, None] - _outer_sym(seg_mean, seg_mean)
    n_k, d_k, _, seg_mse, _ = _plane_from_cov(seg_mean, seg_cov)
    coef = torch.cat([n_k, d_k[:, None]], dim=-1)
    # segment residual gate: a fold chained from blended edge blocks has a
    # refit residual that grows with its extent, a true plane's stays at
    # the noise level
    sigma_seg = depth_sigma_frac * torch.clamp_min(seg_mean[..., 2], 1.0)
    k_valid = k_valid & (seg_mse < torch.clamp_min((2.0 * sigma_seg) ** 2, 1e-5))

    remap = torch.full((nb + 1,), -1, dtype=torch.int32, device=dev)
    remap[top_seg] = torch.where(
        k_valid, torch.arange(max_planes, dtype=torch.int32, device=dev), -1)
    block_label = torch.where(seg_valid, remap[seg_ids], -1).reshape(BH, BW)
    return FramePlanes(coef=coef, n_inliers=top_support.to(torch.int32), centroid=seg_mean,
                       valid=k_valid, block_label=block_label)
