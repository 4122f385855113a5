"""Batched Horn-alignment RANSAC for loop-closure and relocalization
geometric verification (port of spslam_tpu/loop/sim3.py).  Scale is fixed
to 1 for RGB-D.

All hypotheses (256) are evaluated in one batch: closed-form Horn per
triple (batched 3x3 SVD), inliers as one [H, N] distance matrix, the best
hypothesis (first maximum, as `jnp.argmax`) refined over its inliers in
two reweighted rounds.

The hypothesis draw is split from the evaluation: `draw_hypotheses` takes
triples uniformly with replacement among the valid matches from an
explicit CPU `torch.Generator` (the reference's `jax.random.categorical`
stream cannot be reproduced), and `ransac_align` takes the triples, so a
test can feed it the reference's draw.  A triple that repeats an index
makes Horn degenerate, where the SVD's factors are not unique: its
hypothesis may differ between the packages.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..geometry.lie import mat_to_quat, se3_make

N_HYP = 256


class AlignResult(NamedTuple):
    T_ba: torch.Tensor       # [7] SE3: x_b = R x_a + t
    inliers: torch.Tensor    # [N] bool
    n_inliers: torch.Tensor  # [] int


def _det3(M: torch.Tensor) -> torch.Tensor:
    return (M[..., 0, 0] * (M[..., 1, 1] * M[..., 2, 2] - M[..., 1, 2] * M[..., 2, 1])
            - M[..., 0, 1] * (M[..., 1, 0] * M[..., 2, 2] - M[..., 1, 2] * M[..., 2, 0])
            + M[..., 0, 2] * (M[..., 1, 0] * M[..., 2, 1] - M[..., 1, 1] * M[..., 2, 0]))


def _horn(pa: torch.Tensor, pb: torch.Tensor, w: torch.Tensor):
    """Weighted closed-form rigid alignment pa -> pb, batched: pa/pb
    [..., N, 3], w [..., N].  Returns R [..., 3, 3], t [..., 3]."""
    ws = torch.clamp_min(torch.sum(w, dim=-1, keepdim=True), 1e-9)
    ca = torch.sum(pa * w[..., None], dim=-2) / ws
    cb = torch.sum(pb * w[..., None], dim=-2) / ws
    A = ((pb - cb[..., None, :]) * w[..., None]).transpose(-1, -2) @ (pa - ca[..., None, :])
    U, _, Vt = torch.linalg.svd(A)
    sgn = torch.sign(_det3(U @ Vt))
    S = torch.ones(A.shape[:-1], dtype=A.dtype, device=A.device)
    S = torch.cat([S[..., :2], sgn[..., None]], dim=-1)
    R = (U * S[..., None, :]) @ Vt
    t = cb - (R @ ca[..., None])[..., 0]
    return R, t


def draw_hypotheses(valid: np.ndarray, generator: torch.Generator,
                    n_hyp: int = N_HYP) -> torch.Tensor:
    """[n_hyp, 3] int64 indices drawn uniformly with replacement among the
    valid rows (the caller ensures there are some)."""
    p = torch.from_numpy(np.asarray(valid, np.float64))
    return torch.multinomial(p, n_hyp * 3, replacement=True,
                             generator=generator).reshape(n_hyp, 3)


def ransac_align(pa: torch.Tensor, pb: torch.Tensor, valid: torch.Tensor,
                 idx: torch.Tensor, inlier_th: float = 0.08) -> AlignResult:
    """RANSAC rigid alignment of matched 3D point pairs over the drawn
    triples idx [H, 3].  pa, pb: [N, 3] (a = current keyframe's camera
    frame, b = candidate's); valid: [N] match exists."""
    idx = idx.to(pa.device).long()
    Rs, ts = _horn(pa[idx], pb[idx], torch.ones(idx.shape, dtype=pa.dtype, device=pa.device))
    pred = torch.einsum("hij,nj->hni", Rs, pa) + ts[:, None, :]
    err = torch.linalg.norm(pred - pb[None], dim=-1)                 # [H, N]
    inl = (err < inlier_th) & valid[None, :]
    counts = inl.sum(-1)
    best = torch.argmax(counts)

    w = inl[best].to(torch.float32)
    R, t = _horn(pa, pb, w)
    for _ in range(2):
        e = torch.linalg.norm((pa @ R.T + t) - pb, dim=-1)
        w = ((e < inlier_th) & valid).to(torch.float32)
        R, t = _horn(pa, pb, w)
    e = torch.linalg.norm((pa @ R.T + t) - pb, dim=-1)
    final_inl = (e < inlier_th) & valid
    return AlignResult(T_ba=se3_make(mat_to_quat(R), t), inliers=final_inl,
                       n_inliers=final_inl.sum())
