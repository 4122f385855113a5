"""The arithmetic of the end-to-end metrics.

`camera_centers` and `horn_align` are frozen copies of the port's ATE
arithmetic (`spslam_tpu_torch/eval/ate.py`).
"""

from __future__ import annotations

from typing import Iterable, List, Optional, Sequence

import numpy as np

from .scene import quat_to_mat


def camera_centers(poses_cw: np.ndarray) -> np.ndarray:
    """[F, 7] T_cw -> [F, 3] camera centres in the world: C = -R^T t."""
    R = quat_to_mat(np.asarray(poses_cw[:, :4]))
    return -np.einsum("fij,fi->fj", R, poses_cw[:, 4:7])


def horn_align(src: np.ndarray, dst: np.ndarray):
    """Least-squares rigid alignment src -> dst: (R, t) with dst ~ R src + t."""
    mu_s, mu_d = src.mean(axis=0), dst.mean(axis=0)
    xs, xd = src - mu_s, dst - mu_d
    U, _, Vt = np.linalg.svd(xd.T @ xs / len(src))
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    return R, mu_d - R @ mu_s


def ate_errors(poses_est_cw: np.ndarray, poses_gt_cw: np.ndarray) -> np.ndarray:
    """Per-frame camera-centre errors (m) after the session's rigid Horn
    alignment."""
    est, gt = camera_centers(poses_est_cw), camera_centers(poses_gt_cw)
    R, t = horn_align(est, gt)
    return np.linalg.norm(est @ R.T + t - gt, axis=-1)


def pooled_ate_mm(sessions: Iterable[tuple]) -> float:
    """RMSE in mm over every frame of every (poses_est, poses_gt) session,
    each session aligned on its own."""
    errs = np.concatenate([ate_errors(est, gt) for est, gt in sessions])
    return float(np.sqrt(np.mean(errs ** 2)) * 1e3)


def frames_per_s(t_resolved: Sequence[Optional[float]], t_open: float, t_close: float) -> float:
    """Frames resolved inside [t_open, t_close] over the window's seconds:
    all the work over all the time."""
    n = sum(1 for t in t_resolved if t is not None and t <= t_close)
    return n / (t_close - t_open)


def latency_p90_ms(t_start: Sequence[float], t_resolved: Sequence[float]) -> float:
    """90th percentile (linear between order statistics) over every frame of
    the time from the start of the call that handed it in to the end of the
    call or flush that resolved it."""
    lat = np.asarray(t_resolved, np.float64) - np.asarray(t_start, np.float64)
    return float(np.percentile(lat, 90) * 1e3)


def resolved_times(t_call_end: List[float], n_traj: List[int]) -> List[float]:
    """The time each frame of a session resolved, read from the growth of
    System.trajectory: after call j (ending at t_call_end[j]) the trajectory
    holds n_traj[j] frames, in the order they were handed in."""
    out: List[float] = []
    for t, n in zip(t_call_end, n_traj):
        out.extend([t] * (n - len(out)))
    return out
