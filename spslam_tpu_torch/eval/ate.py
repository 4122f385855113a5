"""Trajectory evaluation: ATE RMSE after Horn/Umeyama alignment (numpy
copy of spslam_tpu/eval/ate.py)."""

from __future__ import annotations

from typing import Tuple

import numpy as np


def camera_centers(poses_cw: np.ndarray) -> np.ndarray:
    """[F,7] T_cw -> [F,3] camera centers in world: C = -R^T t."""
    from ..geometry.np_lie import quat_to_mat

    R = quat_to_mat(np.asarray(poses_cw[:, :4]))
    t = poses_cw[:, 4:7]
    return -np.einsum("fij,fi->fj", R, t)


def horn_align(src: np.ndarray, dst: np.ndarray, with_scale: bool = False):
    """Least-squares rigid (or similarity) alignment src -> dst.

    Returns (s, R, t) with dst ~ s * R @ src + t  (Umeyama).
    """
    mu_s = src.mean(axis=0)
    mu_d = dst.mean(axis=0)
    xs = src - mu_s
    xd = dst - mu_d
    cov = xd.T @ xs / len(src)
    U, D, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    if with_scale:
        var_s = (xs ** 2).sum() / len(src)
        s = np.trace(np.diag(D) @ S) / var_s
    else:
        s = 1.0
    t = mu_d - s * R @ mu_s
    return s, R, t


def ate_rmse(
    poses_est_cw: np.ndarray,
    poses_gt_cw: np.ndarray,
    with_scale: bool = False,
) -> Tuple[float, np.ndarray]:
    """Absolute trajectory error after Horn alignment of camera centers.

    Returns (rmse_meters, per-frame translational errors).
    """
    est = camera_centers(poses_est_cw)
    gt = camera_centers(poses_gt_cw)
    s, R, t = horn_align(est, gt, with_scale)
    est_aligned = (s * (R @ est.T)).T + t
    err = np.linalg.norm(est_aligned - gt, axis=-1)
    return float(np.sqrt(np.mean(err ** 2))), err


def rpe_rmse(poses_est_cw: np.ndarray, poses_gt_cw: np.ndarray, delta: int = 1):
    """Relative pose error: the translational drift over `delta` frames.

    Returns (rmse_meters, per-pair errors [F - delta])."""
    from ..geometry.np_lie import se3_compose, se3_inverse

    est, gt = np.asarray(poses_est_cw), np.asarray(poses_gt_cw)
    m = len(est) - delta
    de = se3_compose(est[delta:], se3_inverse(est[:m]))
    dg = se3_compose(gt[delta:], se3_inverse(gt[:m]))
    errs = np.linalg.norm(se3_compose(de, se3_inverse(dg))[:, 4:7], axis=-1)
    return float(np.sqrt(np.mean(errs ** 2))), errs
