"""Sharded bundle adjustment: landmarks and their observations split into
shards, camera poses replicated, the reduced camera system summed over the
shards once per LM iteration (port of spslam_tpu/parallel/dist_ba.py).

Each point's observations stay on its shard, so every Schur pair term is
shard-local; the reduced system S = Hcc - W Hpp^-1 W^T is assembled per
shard and summed, and the small dense solve of S runs on every process.
The reference's `shard_map` + `psum` become two levels of reduction:

* a process holds the shards it was given on a list of torch devices
  (devices may repeat: 8 shards on "cpu", or 4 on "cuda:0") and sums
  their (S, b) in shard order;
* when a `torch.distributed` group is up, one `all_reduce` of (S, b),
  packed into one [6M+1, 6M] buffer, finishes the sum across processes
  (for M = 256 poses that is 9.4 MB per iteration), and one all_reduce of
  the new cost makes every rank take the same accept/reject branch.

The LM loop reads nothing back to the host: accept/reject is a
`torch.where` on the device, as in the reference's `fori_loop`.

    prob = partition_problem(poses, fixed, points, obs_cam, obs_pt, obs_uv,
                             obs_ur, obs_is2, n_shards=4)
    poses, points, cost = dist_bundle_adjust(prob, intr, ["cuda:0"] * 4)

Several processes (one GPU each, NCCL; or gloo on the CPU): set
SPSLAM_COORDINATOR=host:port, SPSLAM_NUM_PROCESSES and SPSLAM_PROCESS_ID
(or run under torchrun with them), call `init_distributed()`, and give each
rank its block of shards (`local_shards(prob, rank, world)`).
"""

from __future__ import annotations

import logging
import os
from typing import NamedTuple

import numpy as np
import torch

from ..geometry.camera import Intrinsics
from ..geometry.lie import se3_retract
from ..solver.ba import _huber_cost, cho_solve, point_obs_residuals
from ..solver.robust import CHI2_2D, CHI2_3D, huber_weight


class DistBAProblem(NamedTuple):
    """Leading axis of the sharded fields = shard axis (size D); numpy
    arrays from `partition_problem`, or tensors."""

    poses: np.ndarray          # [M, 7] replicated
    pose_fixed: np.ndarray     # [M] bool
    pose_valid: np.ndarray     # [M] bool
    points: np.ndarray         # [D, Ps, 3] landmark blocks
    point_valid: np.ndarray    # [D, Ps]
    obs_cam: np.ndarray        # [D, Rs] global camera index
    obs_pt: np.ndarray         # [D, Rs] LOCAL point index within the shard
    obs_uv: np.ndarray         # [D, Rs, 2]
    obs_ur: np.ndarray         # [D, Rs]
    obs_inv_sigma2: np.ndarray  # [D, Rs]
    obs_valid: np.ndarray      # [D, Rs]
    pt_obs: np.ndarray         # [D, Ps, O] LOCAL observation table


_REPLICATED = ("poses", "pose_fixed", "pose_valid")


def local_shards(prob: DistBAProblem, rank: int, world: int) -> DistBAProblem:
    """The contiguous block of shards that process `rank` of `world` holds
    (the shard count must be a multiple of `world`)."""
    D = prob.points.shape[0]
    if D % world:
        raise ValueError(f"{D} shards do not split over {world} processes")
    per = D // world
    sl = slice(rank * per, (rank + 1) * per)
    return prob._replace(**{k: getattr(prob, k)[sl] for k in prob._fields
                            if k not in _REPLICATED})


def _scatter_block_add(S, rows, cols, blocks):
    """S[rows_i + a, cols_i + b] += blocks[i, a, b] on a square S, as one
    flat `index_add_` (the reference's `.at[].add`)."""
    A, B = blocks.shape[1], blocks.shape[2]
    n = S.shape[1]
    r = rows[:, None] + torch.arange(A, dtype=rows.dtype, device=rows.device)[None, :]
    c = cols[:, None] + torch.arange(B, dtype=cols.dtype, device=cols.device)[None, :]
    flat = (r[:, :, None] * n + c[:, None, :]).reshape(-1)
    return S.reshape(-1).index_add_(0, flat, blocks.reshape(-1)).reshape(S.shape)


def _scatter_vec_add(b, rows, vecs):
    A = vecs.shape[1]
    r = rows[:, None] + torch.arange(A, dtype=rows.dtype, device=rows.device)[None, :]
    return b.index_add_(0, r.reshape(-1), vecs.reshape(-1))


def _shard_reduced_system(poses, points, obs_cam, obs_pt, obs_uv, obs_ur, obs_is2, obs_valid,
                          point_valid, pt_obs, lam, intr: Intrinsics, M: int):
    """One shard's contribution to the reduced system (before the sum).

    Returns (S [6M, 6M], b [6M], Hpp_inv, W_p, cam_p, bp); the last four
    are shard-local intermediates of the back-substitution."""
    dim = 6 * M
    DUMP = dim
    dev, dt = poses.device, poses.dtype

    e, J_c, J_p, chi2 = point_obs_residuals(poses, points, obs_cam, obs_pt, obs_uv, obs_ur,
                                            obs_is2, intr)
    delta2 = torch.where(obs_ur >= 0, CHI2_3D, CHI2_2D)
    w = obs_is2 * huber_weight(chi2, delta2) * obs_valid.to(e.dtype)

    Ps = points.shape[0]
    JpW = J_p * w[:, None, None]
    Hpp = torch.zeros((Ps, 3, 3), dtype=dt, device=dev).index_add_(
        0, obs_pt, torch.einsum("rai,raj->rij", JpW, J_p))
    bp = torch.zeros((Ps, 3), dtype=dt, device=dev).index_add_(
        0, obs_pt, -torch.einsum("rai,ra->ri", JpW, e))
    eye3 = torch.eye(3, dtype=dt, device=dev)
    Hpp = Hpp + (lam * torch.diag_embed(torch.diagonal(Hpp, dim1=-2, dim2=-1)) + 1e-6 * eye3)
    # LU, as the reference's jnp.linalg.inv (the closed-form adjugate of
    # solver/ba.py puts a point seen once 1.2e-3 m from the reference's)
    Hpp_inv = torch.where(point_valid[:, None, None], torch.linalg.inv_ex(Hpp)[0], 0.0)

    JcW = J_c * w[:, None, None]
    S = torch.zeros((dim + 6, dim + 6), dtype=dt, device=dev)
    b = torch.zeros((dim + 6,), dtype=dt, device=dev)
    cam_off = torch.where(obs_valid, obs_cam * 6, DUMP)
    S = _scatter_block_add(S, cam_off, cam_off, torch.einsum("rai,raj->rij", JcW, J_c))
    b = _scatter_vec_add(b, cam_off, -torch.einsum("rai,ra->ri", JcW, e))

    pair_valid = pt_obs >= 0
    safe_idx = torch.clamp_min(pt_obs, 0)
    W_terms = torch.einsum("rai,raj->rij", JcW, J_p)
    W_p = W_terms[safe_idx] * pair_valid[..., None, None]      # [Ps,O,6,3]
    cam_p = obs_cam[safe_idx]
    bp_corr = torch.einsum("pij,pj->pi", Hpp_inv, bp)
    bred = -torch.einsum("poij,pj->poi", W_p, bp_corr)
    rows = torch.where(pair_valid, cam_p * 6, DUMP)
    b = _scatter_vec_add(b, rows.reshape(-1), bred.reshape(-1, 6))

    WHinv = torch.einsum("poij,pjk->poik", W_p, Hpp_inv)
    Spairs = -torch.einsum("poik,pqjk->poqij", WHinv, W_p)
    pv2 = pair_valid[:, :, None] & pair_valid[:, None, :]
    r2 = torch.where(pv2, cam_p[:, :, None] * 6, DUMP)
    c2 = torch.where(pv2, cam_p[:, None, :] * 6, DUMP)
    S = _scatter_block_add(S, r2.reshape(-1), c2.reshape(-1), Spairs.reshape(-1, 6, 6))
    return S[:dim, :dim], b[:dim], Hpp_inv, W_p, cam_p, bp


def _shard_cost(poses, points, obs_cam, obs_pt, obs_uv, obs_ur, obs_is2, obs_valid, intr):
    _, _, _, chi2 = point_obs_residuals(poses, points, obs_cam, obs_pt, obs_uv, obs_ur,
                                        obs_is2, intr)
    delta2 = torch.where(obs_ur >= 0, CHI2_3D, CHI2_2D)
    return torch.sum(_huber_cost(chi2, delta2) * obs_valid)


def _group_up() -> bool:
    return torch.distributed.is_available() and torch.distributed.is_initialized()


def dist_bundle_adjust(prob: DistBAProblem, intr: Intrinsics, devices=None, n_iters: int = 10,
                       group=None, stats: dict | None = None):
    """LM loop with the reduced Schur system summed over the shards once
    per iteration.

    `prob` holds the shards of THIS process; `devices` gives each shard
    its device (default: all on the current CUDA device).  With a
    `torch.distributed` group up (`group`, default the world), (S, b) and
    the cost are all-reduced over it.  `stats`, when given, receives the
    number of all_reduce calls and the bytes they carried.

    Returns (poses [M, 7], points [D, Ps, 3], cost scalar) on devices[0];
    points are this process's shards."""
    from .. import resolve_device

    D = prob.points.shape[0]
    devices = [resolve_device(d) for d in (devices or [None] * D)]
    if len(devices) != D:
        raise ValueError(f"{len(devices)} devices for {D} shards")
    dev0 = devices[0]
    reduce = _group_up()
    M = prob.poses.shape[0]

    def up(x, d, dtype=None):
        return torch.as_tensor(np.asarray(x) if not isinstance(x, torch.Tensor) else x,
                               device=d, dtype=dtype)

    shards = []
    for i, d in enumerate(devices):
        shards.append(dict(
            dev=d,
            points=up(prob.points[i], d, torch.float32),
            point_valid=up(prob.point_valid[i], d, torch.bool),
            obs_cam=up(prob.obs_cam[i], d, torch.int64),
            obs_pt=up(prob.obs_pt[i], d, torch.int64),
            obs_uv=up(prob.obs_uv[i], d, torch.float32),
            obs_ur=up(prob.obs_ur[i], d, torch.float32),
            obs_is2=up(prob.obs_inv_sigma2[i], d, torch.float32),
            obs_valid=up(prob.obs_valid[i], d, torch.bool),
            pt_obs=up(prob.pt_obs[i], d, torch.int64),
        ))
    poses = up(prob.poses, dev0, torch.float32)
    free = up(prob.pose_valid, dev0, torch.bool) & ~up(prob.pose_fixed, dev0, torch.bool)
    free6 = free.repeat_interleave(6).to(torch.float32)
    n_reduce = [0, 0]

    def all_reduce(x):
        if reduce:
            torch.distributed.all_reduce(x, group=group)
            n_reduce[0] += 1
            n_reduce[1] += x.numel() * x.element_size()
        return x

    def on_each(x):
        """x copied once to every distinct shard device."""
        return {d: (x if d == dev0 else x.to(d)) for d in {s["dev"] for s in shards}}

    def cost(po_on, pts):
        c = sum(_shard_cost(po_on[s["dev"]], p, s["obs_cam"], s["obs_pt"], s["obs_uv"],
                            s["obs_ur"], s["obs_is2"], s["obs_valid"], intr).to(dev0)
                for s, p in zip(shards, pts))
        return all_reduce(c.reshape(1))[0]

    points = [s["points"] for s in shards]
    lam = torch.full((), 1e-4, dtype=torch.float32, device=dev0)
    cur = cost(on_each(poses), points)
    eye_free = torch.diag(1.0 - free6)
    for _ in range(n_iters):
        po_on, lam_on = on_each(poses), on_each(lam)
        buf, parts = None, []
        for s, p in zip(shards, points):
            S_i, b_i, *rest = _shard_reduced_system(
                po_on[s["dev"]], p, s["obs_cam"], s["obs_pt"], s["obs_uv"], s["obs_ur"],
                s["obs_is2"], s["obs_valid"], s["point_valid"], s["pt_obs"], lam_on[s["dev"]],
                intr, M)
            packed = torch.cat([S_i, b_i[None]], 0).to(dev0)   # [6M+1, 6M]
            buf = packed if buf is None else buf + packed
            parts.append(rest)
        buf = all_reduce(buf)                  # ONE collective of (S, b)
        S, b = buf[:-1], buf[-1]
        S = S * free6[:, None] * free6[None, :]
        b = b * free6
        S = S + torch.diag(lam * torch.diagonal(S) + 1e-6) + eye_free
        dx_cam = cho_solve(S, b).reshape(M, 6)
        dx_on = on_each(dx_cam)
        points_new = []
        for s, p, (Hpp_inv, W_p, cam_p, bp) in zip(shards, points, parts):
            Wt_dx = torch.einsum("poij,poi->pj", W_p, dx_on[s["dev"]][cam_p])
            dp = torch.einsum("pij,pj->pi", Hpp_inv, bp - Wt_dx) * s["point_valid"][:, None]
            points_new.append(p + dp)
        poses_new = se3_retract(poses, dx_cam)
        c_new = cost(on_each(poses_new), points_new)
        better = c_new < cur
        poses = torch.where(better, poses_new, poses)
        better_on = on_each(better)
        points = [torch.where(better_on[s["dev"]], pn, p)
                  for s, p, pn in zip(shards, points, points_new)]
        lam = torch.where(better, lam * 0.5, lam * 4.0)
        cur = torch.where(better, c_new, cur)
    if stats is not None:
        stats.update(all_reduce_calls=n_reduce[0], all_reduce_bytes=n_reduce[1])
    return poses, torch.stack([p.to(dev0) for p in points]), cur


# ---------------------------------------------------------------------------
# Host-side partitioning (numpy, the reference's code)
# ---------------------------------------------------------------------------


def _cumcount(keys: np.ndarray) -> np.ndarray:
    """Occurrence index of each element within its key group (vectorized)."""
    if len(keys) == 0:
        return np.zeros(0, np.int64)
    order = np.argsort(keys, kind="stable")
    sk = keys[order]
    new_group = np.r_[True, sk[1:] != sk[:-1]]
    group_start = np.maximum.accumulate(np.where(new_group, np.arange(len(sk)), 0))
    cc = np.arange(len(sk)) - group_start
    out = np.empty(len(keys), np.int64)
    out[order] = cc
    return out


def assign_segments(pt_ref_kf: np.ndarray, n_kfs: int, n_shards: int) -> np.ndarray:
    """Trajectory-segment / map-block partitioning: the keyframe trajectory
    is split into n_shards contiguous segments balanced by the number of
    map points each owns, and every point goes to its owning keyframe's
    segment.  Returns shard_of_pt [P]."""
    pt_ref_kf = np.clip(np.asarray(pt_ref_kf, np.int64), 0, n_kfs - 1)
    counts = np.bincount(pt_ref_kf, minlength=n_kfs)
    cum = np.cumsum(counts)
    total = max(int(cum[-1]), 1)
    # a keyframe joins the segment its point-mass midpoint falls into
    mid = cum - counts / 2.0
    segment_of_kf = np.minimum((mid * n_shards / total).astype(np.int64), n_shards - 1)
    return segment_of_kf[pt_ref_kf]


def partition_problem(poses, pose_fixed, points, obs_cam, obs_pt, obs_uv, obs_ur,
                      obs_inv_sigma2, n_shards: int, obs_per_point: int = 16,
                      pt_ref_kf=None, strategy: str = "segments",
                      return_mapping: bool = False):
    """Partition landmarks (with their observations) into shards.

    strategy="segments" (default): each point lands on the shard of its
    owning keyframe (`assign_segments`; pt_ref_kf defaults to each
    point's first observing camera).  strategy="round_robin": point i on
    shard i % D.  With return_mapping=True returns (prob, shard_of_pt [P],
    local_idx [P]) to scatter solved points back."""
    n_pts = len(points)
    D = n_shards
    obs_cam = np.asarray(obs_cam, np.int32)
    obs_pt = np.asarray(obs_pt, np.int64)

    if strategy == "segments":
        if pt_ref_kf is None:
            pt_ref_kf = np.zeros(n_pts, np.int64)
            first = np.full(n_pts, len(obs_cam), np.int64)
            np.minimum.at(first, obs_pt, np.arange(len(obs_cam)))
            seen = first < len(obs_cam)
            pt_ref_kf[seen] = obs_cam[first[seen]]
        shard_of_pt = assign_segments(pt_ref_kf, len(poses), D)
    elif strategy == "round_robin":
        shard_of_pt = np.arange(n_pts) % D
    else:
        raise ValueError(f"unknown partition strategy: {strategy}")

    local_idx = _cumcount(shard_of_pt)
    counts_sh = np.bincount(shard_of_pt, minlength=D)
    Ps = max(int(counts_sh.max()), 1)
    pts_sh = np.zeros((D, Ps, 3), np.float32)
    ptv_sh = np.zeros((D, Ps), bool)
    pts_sh[shard_of_pt, local_idx] = points
    ptv_sh[shard_of_pt, local_idx] = True

    # observations follow their point's shard
    shard_of_obs = shard_of_pt[obs_pt]
    j = _cumcount(shard_of_obs)
    Rs = max(int(np.bincount(shard_of_obs, minlength=D).max()), 1)
    oc = np.zeros((D, Rs), np.int32)
    op = np.zeros((D, Rs), np.int32)
    ouv = np.zeros((D, Rs, 2), np.float32)
    our = np.full((D, Rs), -1.0, np.float32)
    ois = np.ones((D, Rs), np.float32)
    ov = np.zeros((D, Rs), bool)
    oc[shard_of_obs, j] = obs_cam
    op[shard_of_obs, j] = local_idx[obs_pt]
    ouv[shard_of_obs, j] = obs_uv
    our[shard_of_obs, j] = obs_ur
    ois[shard_of_obs, j] = obs_inv_sigma2
    ov[shard_of_obs, j] = True

    # per-point observation table (the Schur pair terms)
    pt_obs = np.full((D, Ps, obs_per_point), -1, np.int32)
    occ = _cumcount(obs_pt)
    keep = occ < obs_per_point
    n_dropped = int(len(occ) - keep.sum())
    if n_dropped:
        logging.getLogger(__name__).info(
            "dist BA partition: dropped %d observations beyond the %d-per-point "
            "Schur-pair cap", n_dropped, obs_per_point)
    pt_obs[shard_of_obs[keep], local_idx[obs_pt[keep]], occ[keep]] = j[keep]

    prob = DistBAProblem(
        poses=np.asarray(poses, np.float32), pose_fixed=np.asarray(pose_fixed, bool),
        pose_valid=np.ones(len(poses), bool),
        points=pts_sh, point_valid=ptv_sh, obs_cam=oc, obs_pt=op, obs_uv=ouv, obs_ur=our,
        obs_inv_sigma2=ois, obs_valid=ov, pt_obs=pt_obs,
    )
    if return_mapping:
        return prob, shard_of_pt, local_idx
    return prob


# ---------------------------------------------------------------------------
# Several processes
# ---------------------------------------------------------------------------


def init_distributed(coordinator: str | None = None, num_processes: int | None = None,
                     process_id: int | None = None) -> bool:
    """`torch.distributed.init_process_group` over tcp://coordinator.

    Reads SPSLAM_COORDINATOR (host:port) / SPSLAM_NUM_PROCESSES /
    SPSLAM_PROCESS_ID when arguments are omitted; a no-op returning False
    without a coordinator.  Backend: NCCL when CUDA is there (each process
    takes GPU process_id % count), gloo on the CPU.  Returns True when the
    group is (already) up."""
    if _group_up():
        return True
    coordinator = coordinator or os.environ.get("SPSLAM_COORDINATOR")
    if not coordinator:
        return False
    num_processes = num_processes or int(os.environ.get("SPSLAM_NUM_PROCESSES", "0"))
    if process_id is None:
        process_id = int(os.environ.get("SPSLAM_PROCESS_ID", "0"))
    if not num_processes:
        return False
    backend = "nccl" if torch.cuda.is_available() else "gloo"
    if backend == "nccl":
        torch.cuda.set_device(process_id % torch.cuda.device_count())
    torch.distributed.init_process_group(backend=backend, init_method=f"tcp://{coordinator}",
                                         world_size=num_processes, rank=process_id)
    return True


def global_mesh(device=None) -> list:
    """This process's devices.  `device=None` means the card, as for every
    entry point (raises without CUDA): its one GPU when a group of several
    processes is up, else every visible GPU.  Any other device gives
    [that device], so the CPU is asked for explicitly."""
    from .. import resolve_device

    dev = resolve_device(device)
    if device is not None:
        return [dev]
    if _group_up() and torch.distributed.get_world_size() > 1:
        return [torch.device("cuda", torch.cuda.current_device())]
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
