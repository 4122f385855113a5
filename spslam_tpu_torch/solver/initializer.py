"""Monocular two-view initialization: essential-matrix RANSAC,
decomposition and triangulation (port of spslam_tpu/solver/initializer.py,
the reference's Initializer; unwired there too, kept for API parity and
monocular use).

All hypotheses at once: each 8-point sample gives E by a batched SVD,
scored by the symmetric epipolar error over every match; the best is
refined twice over all its inliers, decomposed into the four (R, t)
candidates, and the one with most points in front of both cameras wins.
Scale is unobservable: the returned translation is unit-norm.

SVD signs are not unique (LAPACK and cuSOLVER differ): E comes out up to
sign and scale, which changes neither the epipolar errors nor the
cheirality choice, so R, the direction of t and the inliers do not depend
on them.  The hypothesis draw is injectable (`draw=`), as the loop
closer's RANSAC draw is.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..geometry.camera import Intrinsics
from ..geometry.lie import mat_to_quat, se3_make


class InitResult(NamedTuple):
    T_21: torch.Tensor      # [7] SE3 pose of view 2 w.r.t. view 1 (unit t)
    points: torch.Tensor    # [N, 3] triangulated points in view-1 frame
    inliers: torch.Tensor   # [N] bool
    n_inliers: torch.Tensor


def _normalized(intr: Intrinsics, uv):
    return torch.stack([(uv[..., 0] - intr.cx) / intr.fx, (uv[..., 1] - intr.cy) / intr.fy],
                       dim=-1)


def _null_vector(A):
    """Right singular vector of the smallest singular value, batched
    (all 9 columns even with fewer rows)."""
    Vh = torch.linalg.svd(A, full_matrices=A.shape[-2] < A.shape[-1])[2]
    return Vh[..., -1, :]


def _eight_point(x1, x2, w=None):
    """E from >= 8 normalized correspondences (x1, x2: [..., K, 2]),
    optional per-row weights (the all-inlier refinement)."""
    u1, v1 = x1[..., 0], x1[..., 1]
    u2, v2 = x2[..., 0], x2[..., 1]
    A = torch.stack([u2 * u1, u2 * v1, u2, v2 * u1, v2 * v1, v2, u1, v1, torch.ones_like(u1)],
                    dim=-1)
    if w is not None:
        A = A * w[..., None]
    E = _null_vector(A).reshape(A.shape[:-2] + (3, 3))
    # project to the essential manifold: two equal singular values
    U, s, Vt = torch.linalg.svd(E)
    s_mean = (s[..., 0] + s[..., 1]) / 2.0
    diag = torch.tensor([1.0, 1.0, 0.0], dtype=E.dtype, device=E.device)
    return (U * (diag * s_mean[..., None])[..., None, :]) @ Vt


def _epipolar_error(E, x1, x2):
    """Symmetric squared epipolar distance (normalized coords); E [..., 3,
    3] against x [N, 2] -> [..., N]."""
    ones = torch.ones_like(x1[..., :1])
    h1 = torch.cat([x1, ones], dim=-1)
    h2 = torch.cat([x2, ones], dim=-1)
    Ex1 = h1 @ E.mT            # lines in image 2
    Etx2 = h2 @ E              # lines in image 1
    num = torch.sum(h2 * Ex1, dim=-1) ** 2
    d1 = num / torch.clamp_min(Ex1[..., 0] ** 2 + Ex1[..., 1] ** 2, 1e-12)
    d2 = num / torch.clamp_min(Etx2[..., 0] ** 2 + Etx2[..., 1] ** 2, 1e-12)
    return d1 + d2


def _triangulate(R, t, x1, x2):
    """DLT triangulation in the view-1 frame (P1 = [I|0], P2 = [R|t]),
    batched over the matches; x normalized."""
    N = x1.shape[0]
    e = torch.eye(4, dtype=x1.dtype, device=x1.device)
    P2 = torch.cat([R, t[:, None]], dim=1)                       # [3, 4]
    A = torch.stack([
        e[0] - x1[:, 0:1] * e[2],
        e[1] - x1[:, 1:2] * e[2],
        P2[0] - x2[:, 0:1] * P2[2],
        P2[1] - x2[:, 1:2] * P2[2],
    ], dim=1)                                                    # [N, 4, 4]
    X = _null_vector(A)
    w = X[:, 3]
    return X[:, :3] / torch.where(torch.abs(w) < 1e-12, 1e-12, w)[:, None]


def draw_init_hypotheses(valid: torch.Tensor, generator: torch.Generator,
                         n_hyp: int = 128) -> torch.Tensor:
    """[n_hyp, 8] indices drawn uniformly (with replacement) from the valid
    matches, on the host generator; the reference's categorical draw over
    the same support."""
    ids = torch.nonzero(valid.cpu())[:, 0]
    pick = torch.randint(len(ids), (n_hyp, 8), generator=generator)
    return ids[pick].to(valid.device)


def initialize_two_view(uv1, uv2, valid, intr: Intrinsics, n_hyp: int = 128,
                        inlier_th_px: float = 2.0, draw=None,
                        generator: torch.Generator | None = None) -> InitResult:
    """Relative pose + structure from matched keypoints of two views.

    uv1/uv2: [N, 2] matched pixel coords; valid: [N] match exists.  draw:
    optional `(valid) -> [n_hyp, 8]` hypothesis indices (default:
    `draw_init_hypotheses` on `generator`, seeded 0 when None)."""
    x1 = _normalized(intr, uv1)
    x2 = _normalized(intr, uv2)
    th = (inlier_th_px / intr.fx) ** 2 * 2.0
    if draw is None:
        gen = generator if generator is not None else torch.Generator().manual_seed(0)
        idx = draw_init_hypotheses(valid, gen, n_hyp)
    else:
        idx = draw(valid)
    idx = idx.to(x1.device).long()

    Es = _eight_point(x1[idx], x2[idx])                          # [H, 3, 3]
    inl = (_epipolar_error(Es, x1, x2) < th) & valid[None, :]
    best = torch.argmax(inl.sum(-1))
    inliers = inl[best]
    # all-inlier weighted refinement (two rounds)
    E = Es[best]
    for _ in range(2):
        E = _eight_point(x1, x2, inliers.to(x1.dtype))
        inliers = (_epipolar_error(E, x1, x2) < th) & valid

    # decompose: 4 candidate (R, t), the one with most points in front wins
    U, _, Vt = torch.linalg.svd(E)
    U = U * torch.sign(torch.linalg.det(U @ Vt))              # proper rotations
    W = torch.tensor([[0.0, -1, 0], [1, 0, 0], [0, 0, 1]], dtype=E.dtype, device=E.device)
    R1 = U @ W @ Vt
    R2 = U @ W.T @ Vt
    tvec = U[:, 2]
    cands = [(R1, tvec), (R1, -tvec), (R2, tvec), (R2, -tvec)]
    counts, Xs, oks = [], [], []
    for R, t in cands:
        X = _triangulate(R, t, x1, x2)
        z2 = (X @ R.T + t)[:, 2]
        ok = (X[:, 2] > 1e-3) & (z2 > 1e-3) & inliers
        counts.append(ok.sum())
        Xs.append(X)
        oks.append(ok)
    k = torch.argmax(torch.stack(counts))
    Rbest = torch.stack([c[0] for c in cands])[k]
    tbest = torch.stack([c[1] for c in cands])[k]
    ok = torch.stack(oks)[k]
    T = se3_make(mat_to_quat(Rbest), tbest)
    return InitResult(T_21=T, points=torch.stack(Xs)[k], inliers=ok, n_inliers=ok.sum())
