"""Joint point-plane-pose bundle adjustment with Schur landmark
elimination (port of spslam_tpu/solver/ba.py).

Fixed-shape problem (M poses, P points, R observations, L planes, Q plane
observations, E plane-plane edges, all padded with validity masks), two LM
stages with a chi2 gate in between, point blocks inverted in closed form,
and the reduced camera + plane system (6M + 3L) solved densely.  Planes are
vertices in the (azimuth, elevation, d) chart; pose-plane edges and
parallel / perpendicular structural edges add to the reduced system.

Plane Jacobians are forward-mode autodiff of the residual under a stacked
perturbation (`torch.func.jacfwd` under `torch.func.vmap`), as the
reference takes them with `jax.jacfwd` under `jax.vmap`.  Near the chart's
pole they are huge in both (the padding plane [0, 0, 1, 0] retracts to a
normal 4.4e-8 off +z: an azimuth derivative of ~-2.3e7).  Invalid rows are
routed to a dump row of the system (a mask by x0 would keep a NaN or an
inf), and a Cholesky factorization that fails gives NaN, as JAX's does,
so such a step is rejected alike.  torch.func is not thread-safe in
forward mode, so the Jacobians go through `batched_jacfwd` (one lock).

Differences in summation order: the camera and plane blocks are
scatter-added (on the CPU a flat `index_add` in index order, on CUDA an
accumulating `index_put`), where the reference contracts one-hot matrices
for the camera blocks.
"""

from __future__ import annotations

import threading
from typing import NamedTuple

import numpy as np
import torch
from torch.func import jacfwd, vmap

from ..geometry.camera import Intrinsics
from ..geometry.lie import quat_rotate, quat_to_mat, se3_q, se3_retract, se3_t
from ..geometry.plane import plane_error, plane_retract, transform_plane
from .robust import CHI2_2D, CHI2_3D, huber_weight


# torch.func's forward-mode AD levels are process-global and must be
# released in LIFO order, so two threads may not run jacfwd at once (the
# post-loop global BA runs on a worker beside the mapper's local BA and the
# loop closer's pose graph): every batched Jacobian takes this lock
_JACFWD_LOCK = threading.Lock()


def batched_jacfwd(f, argnums, *args):
    """vmap(jacfwd(f, argnums))(*args), one thread at a time."""
    with _JACFWD_LOCK:
        return vmap(jacfwd(f, argnums=argnums))(*args)


class BAProblem(NamedTuple):
    """Fixed-shape BA problem; -1 / False marks padding."""

    poses: torch.Tensor        # [M, 7] T_cw
    pose_fixed: torch.Tensor   # [M] bool (gauge / boundary KFs)
    pose_valid: torch.Tensor   # [M] bool
    points: torch.Tensor       # [P, 3] world points
    point_valid: torch.Tensor  # [P] bool
    obs_cam: torch.Tensor      # [R] int -> M
    obs_pt: torch.Tensor       # [R] int -> P
    obs_uv: torch.Tensor       # [R, 2]
    obs_ur: torch.Tensor       # [R] virtual-right u, <0 if mono
    obs_inv_sigma2: torch.Tensor  # [R]
    obs_valid: torch.Tensor    # [R] bool
    pt_obs: torch.Tensor       # [P, OMAX] int -> R (-1 pad) observation table
    planes: torch.Tensor       # [L, 4] world planes (n, d)
    plane_valid: torch.Tensor  # [L] bool
    pobs_cam: torch.Tensor     # [Q] int -> M
    pobs_plane: torch.Tensor   # [Q] int -> L
    pobs_pi: torch.Tensor      # [Q, 4]
    pobs_w: torch.Tensor       # [Q]
    pobs_valid: torch.Tensor   # [Q] bool
    pp_a: torch.Tensor         # [E] int -> L
    pp_b: torch.Tensor         # [E] int -> L
    pp_type: torch.Tensor      # [E] int: 0 parallel, 1 perpendicular
    pp_w: torch.Tensor         # [E]
    pp_valid: torch.Tensor     # [E] bool


class BAResult(NamedTuple):
    poses: torch.Tensor
    points: torch.Tensor
    planes: torch.Tensor
    obs_inlier: torch.Tensor   # [R] bool post-gating classification
    pobs_inlier: torch.Tensor  # [Q] bool
    cost: torch.Tensor         # final robust cost


def point_obs_residuals(poses, points, obs_cam, obs_pt, obs_uv, obs_ur,
                        obs_inv_sigma2, intr: Intrinsics):
    """e [R,3], J_c [R,3,6] (pose), J_p [R,3,3] (point), chi2 [R]."""
    T = poses[obs_cam]
    X = points[obs_pt]
    q, t = se3_q(T), se3_t(T)
    xc = quat_rotate(q, X) + t
    x, y, z = xc[..., 0], xc[..., 1], torch.clamp_min(xc[..., 2], 1e-6)
    iz = 1.0 / z
    iz2 = iz * iz
    u = intr.fx * x * iz + intr.cx
    v = intr.fy * y * iz + intr.cy
    ur = u - intr.bf * iz

    has_r = obs_ur >= 0
    e = torch.stack(
        [obs_uv[..., 0] - u, obs_uv[..., 1] - v, torch.where(has_r, obs_ur - ur, 0.0)],
        dim=-1,
    )
    zeros, ones = torch.zeros_like(z), torch.ones_like(z)
    du = torch.stack([intr.fx * iz, zeros, -intr.fx * x * iz2], dim=-1)
    dv = torch.stack([zeros, intr.fy * iz, -intr.fy * y * iz2], dim=-1)
    dr = du + torch.stack([zeros, zeros, intr.bf * iz2], dim=-1)
    dproj = torch.stack([du, dv, dr], dim=-2)
    dxc_dxi = torch.stack(
        [
            torch.stack([ones, zeros, zeros, zeros, z, -y], dim=-1),
            torch.stack([zeros, ones, zeros, -z, zeros, x], dim=-1),
            torch.stack([zeros, zeros, ones, y, -x, zeros], dim=-1),
        ],
        dim=-2,
    )
    J_c = -(dproj @ dxc_dxi)
    J_p = -(dproj @ quat_to_mat(q))   # dxc/dXw = R_cw

    row_mask = torch.stack([ones, ones, has_r.to(e.dtype)], dim=-1)
    e = e * row_mask
    J_c = J_c * row_mask[..., None]
    J_p = J_p * row_mask[..., None]
    chi2 = torch.sum(e * e, dim=-1) * obs_inv_sigma2
    return e, J_c, J_p, chi2


def _point_residuals(poses, points, prob: BAProblem, intr: Intrinsics):
    return point_obs_residuals(poses, points, prob.obs_cam, prob.obs_pt, prob.obs_uv,
                               prob.obs_ur, prob.obs_inv_sigma2, intr)


def _plane_obs_resid(z, T, piw, piobs):
    """Pose-plane observation residual [3] in the chart under the stacked
    perturbation z = (xi [6], dpl [3])."""
    pred = transform_plane(se3_retract(T, z[..., :6]), plane_retract(piw, z[..., 6:9]))
    return plane_error(piobs, pred)


def _plane_obs_residuals(poses, planes, prob: BAProblem, with_jac: bool = True):
    """e [Q,3], J_c [Q,3,6], J_pl [Q,3,3], chi2 [Q] of the pose-plane
    observations (J_c, J_pl None unless with_jac)."""
    T = poses[prob.pobs_cam.long()]
    piw = planes[prob.pobs_plane.long()]
    z = torch.zeros(T.shape[0], 9, dtype=poses.dtype, device=poses.device)
    e = _plane_obs_resid(z, T, piw, prob.pobs_pi)
    chi2 = torch.sum(e * e, dim=-1) * prob.pobs_w
    if not with_jac:
        return e, None, None, chi2
    J = batched_jacfwd(_plane_obs_resid, 0, z, T, piw, prob.pobs_pi)   # [Q,3,9]
    return e, J[..., :6], J[..., 6:9], chi2


def _plane_plane_resid(da, db, pa, pb, typ):
    """Structural edge residual [1]: parallel 1 - |na . nb|, perpendicular
    na . nb, at the planes moved by da, db in the chart."""
    dot = torch.sum(plane_retract(pa, da)[..., 0:3] * plane_retract(pb, db)[..., 0:3],
                    dim=-1, keepdim=True)
    return torch.where(typ[..., None] == 0, 1.0 - torch.abs(dot), dot)


def _plane_plane_residuals(planes, prob: BAProblem, with_jac: bool = True):
    """e [E,1], J_a [E,1,3], J_b [E,1,3] of the structural edges (J_a, J_b
    None unless with_jac)."""
    pa = planes[prob.pp_a.long()]
    pb = planes[prob.pp_b.long()]
    z = torch.zeros_like(pa[:, :3])
    e = _plane_plane_resid(z, z, pa, pb, prob.pp_type)
    if not with_jac:
        return e, None, None
    J_a, J_b = batched_jacfwd(_plane_plane_resid, (0, 1), z, z, pa, pb, prob.pp_type)
    return e, J_a, J_b


def _scatter_block_add(S, rows, cols, blocks):
    """S[rows_i + a, cols_i + b] += blocks[i, a, b] (accumulating; invalid
    terms are sent to a dump row/col beyond the trimmed system).  On the
    CPU one flat `index_add`, which adds in index order: an accumulating
    `index_put` there adds from several threads in run-dependent order, so
    the same problem gave another result on every call."""
    A, B = blocks.shape[1], blocks.shape[2]
    r = rows[:, None] + torch.arange(A, dtype=rows.dtype, device=rows.device)[None, :]
    c = cols[:, None] + torch.arange(B, dtype=cols.dtype, device=cols.device)[None, :]
    r, c = torch.broadcast_tensors(r[:, :, None], c[:, None, :])
    if S.device.type == "cpu":
        flat = (r * S.shape[1] + c).reshape(-1)
        return S.reshape(-1).index_add(0, flat, blocks.reshape(-1)).reshape(S.shape)
    return S.index_put((r, c), blocks, accumulate=True)


def _scatter_vec_add(b, rows, vecs):
    A = vecs.shape[1]
    r = rows[:, None] + torch.arange(A, dtype=rows.dtype, device=rows.device)[None, :]
    if b.device.type == "cpu":
        return b.index_add(0, r.reshape(-1), vecs.reshape(-1))
    return b.index_put((r,), vecs, accumulate=True)


def _inv3x3(A):
    """Batched closed-form 3x3 inverse; blocks singular relative to their
    trace^3 get a zero inverse."""
    a, b, c = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    d, e, f = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    g, h, i = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    A00 = e * i - f * h
    A01 = c * h - b * i
    A02 = b * f - c * e
    A10 = f * g - d * i
    A11 = a * i - c * g
    A12 = c * d - a * f
    A20 = d * h - e * g
    A21 = b * g - a * h
    A22 = a * e - b * d
    det = a * A00 + b * A10 + c * A20
    scale = torch.clamp_min((a + e + i) / 3.0, 1e-12)
    singular = torch.abs(det) <= 1e-10 * scale ** 3
    inv_det = torch.where(singular, 0.0, 1.0 / torch.where(singular, 1.0, det))
    adj = torch.stack(
        [
            torch.stack([A00, A01, A02], -1),
            torch.stack([A10, A11, A12], -1),
            torch.stack([A20, A21, A22], -1),
        ],
        -2,
    )
    return adj * inv_det[..., None, None]


def _solve_ba_iteration(poses, points, planes, prob: BAProblem, intr, lam, obs_w_extra,
                        pobs_w_extra):
    """One damped GN step.  Returns (dx_poses [M,6], dp [P,3], dpl [L,3])."""
    M = poses.shape[0]
    L = planes.shape[0]
    P = points.shape[0]
    dim = 6 * M + 3 * L
    DUMP = dim  # scratch rows/cols for masked scatter terms
    dev = poses.device

    e, J_c, J_p, chi2 = _point_residuals(poses, points, prob, intr)
    delta2 = torch.where(prob.obs_ur >= 0, CHI2_3D, CHI2_2D)
    w = (prob.obs_inv_sigma2 * huber_weight(chi2, delta2) * obs_w_extra
         * prob.obs_valid.to(e.dtype))

    # --- landmark blocks, gathered through the per-point observation table
    pair_valid = prob.pt_obs >= 0
    safe_idx = torch.clamp_min(prob.pt_obs, 0).long()          # [P, OMAX]
    JpW = J_p * w[:, None, None]
    Hpp_terms = torch.einsum("rai,raj->rij", JpW, J_p)        # [R,3,3]
    bp_terms = -torch.einsum("rai,ra->ri", JpW, e)            # [R,3]
    pv = pair_valid[..., None, None].to(e.dtype)
    Hpp = torch.sum(Hpp_terms[safe_idx] * pv, dim=1)          # [P,3,3]
    bp = torch.sum(bp_terms[safe_idx] * pair_valid[..., None], dim=1)
    eye3 = torch.eye(3, dtype=e.dtype, device=dev)
    Hpp = Hpp + (lam * torch.diag_embed(torch.diagonal(Hpp, dim1=-2, dim2=-1)) + 1e-6 * eye3)
    Hpp_inv = torch.where(prob.point_valid[:, None, None], _inv3x3(Hpp), 0.0)

    # --- camera blocks: block-diagonal, scatter-added per observation ----
    cam6 = torch.where(prob.obs_valid, prob.obs_cam.long() * 6, DUMP)
    JcW = J_c * w[:, None, None]
    S = torch.zeros((dim + 6, dim + 6), dtype=e.dtype, device=dev)
    S = _scatter_block_add(S, cam6, cam6, torch.einsum("rai,raj->rij", JcW, J_c))
    b = torch.zeros((dim + 6,), dtype=e.dtype, device=dev)
    b = _scatter_vec_add(b, cam6, -torch.einsum("rai,ra->ri", JcW, e))

    # --- Schur reduction via the per-point stacked W -------------------
    W_terms = torch.einsum("rai,raj->rij", JcW, J_p)          # [R,6,3] = Hcp
    W_p = W_terms[safe_idx] * pair_valid[..., None, None]      # [P,OMAX,6,3]
    cam_p = prob.obs_cam[safe_idx].long()                      # [P,OMAX]
    bp_corr = torch.einsum("pij,pj->pi", Hpp_inv, bp)
    oh_p = (
        (cam_p[..., None] == torch.arange(M, device=dev)[None, None, :])
        & pair_valid[..., None]
    ).to(e.dtype)                                              # [P,OMAX,M]
    Y = torch.einsum("pom,poib->pmib", oh_p, W_p).reshape(P, M * 6, 3)
    b[: 6 * M] -= torch.einsum("pab,pb->a", Y, bp_corr)
    Z = torch.einsum("pab,pbc->pac", Y, Hpp_inv)
    S[: 6 * M, : 6 * M] -= torch.einsum("pac,pbc->ab", Z, Y)

    # --- plane observation edges (planes live in the reduced system) ----
    ep, Jpc, Jppl, chi2p = _plane_obs_residuals(poses, planes, prob)
    wq = (prob.pobs_w * huber_weight(chi2p, CHI2_3D) * pobs_w_extra
          * prob.pobs_valid.to(e.dtype))
    JpcW = Jpc * wq[:, None, None]
    JpplW = Jppl * wq[:, None, None]
    cam_q = torch.where(prob.pobs_valid, prob.pobs_cam.long() * 6, DUMP)
    pl_q = torch.where(prob.pobs_valid, 6 * M + prob.pobs_plane.long() * 3, DUMP)
    S = _scatter_block_add(S, cam_q, cam_q, torch.einsum("qai,qaj->qij", JpcW, Jpc))
    S = _scatter_block_add(S, pl_q, pl_q, torch.einsum("qai,qaj->qij", JpplW, Jppl))
    cross = torch.einsum("qai,qaj->qij", JpcW, Jppl)
    S = _scatter_block_add(S, cam_q, pl_q, cross)
    S = _scatter_block_add(S, pl_q, cam_q, cross.transpose(-1, -2))
    b = _scatter_vec_add(b, cam_q, -torch.einsum("qai,qa->qi", JpcW, ep))
    b = _scatter_vec_add(b, pl_q, -torch.einsum("qai,qa->qi", JpplW, ep))

    # --- plane-plane structural edges -----------------------------------
    epp, Ja, Jb = _plane_plane_residuals(planes, prob)
    we = prob.pp_w * prob.pp_valid.to(e.dtype)
    a_off = torch.where(prob.pp_valid, 6 * M + prob.pp_a.long() * 3, DUMP)
    b_off = torch.where(prob.pp_valid, 6 * M + prob.pp_b.long() * 3, DUMP)
    JaW = Ja * we[:, None, None]
    JbW = Jb * we[:, None, None]
    S = _scatter_block_add(S, a_off, a_off, torch.einsum("eai,eaj->eij", JaW, Ja))
    S = _scatter_block_add(S, b_off, b_off, torch.einsum("eai,eaj->eij", JbW, Jb))
    cr = torch.einsum("eai,eaj->eij", JaW, Jb)
    S = _scatter_block_add(S, a_off, b_off, cr)
    S = _scatter_block_add(S, b_off, a_off, cr.transpose(-1, -2))
    b = _scatter_vec_add(b, a_off, -torch.einsum("eai,ea->ei", JaW, epp))
    b = _scatter_vec_add(b, b_off, -torch.einsum("eai,ea->ei", JbW, epp))

    # --- trim dump, damp, pin fixed/invalid entries ---------------------
    S = S[:dim, :dim]
    b = b[:dim]
    pose_free = prob.pose_valid & ~prob.pose_fixed
    free = torch.cat([pose_free.repeat_interleave(6),
                      prob.plane_valid.repeat_interleave(3)]).to(e.dtype)
    S = S * free[:, None] * free[None, :]
    b = b * free
    S = S + torch.diag(lam * torch.diagonal(S) + 1e-6) + torch.diag(1.0 - free)

    dx = cho_solve(S, b)
    dx_cam = dx[: 6 * M].reshape(M, 6)
    dx_pl = dx[6 * M:].reshape(L, 3)

    # back-substitute landmarks: dp = Hpp^{-1}(bp - W^T dxc)
    Wt_dx = torch.einsum("poij,poi->pj", W_p, dx_cam[cam_p])
    dp = torch.einsum("pij,pj->pi", Hpp_inv, bp - Wt_dx)
    return dx_cam, dp * prob.point_valid[:, None], dx_pl


def cho_solve(S: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """S^{-1} b by Cholesky without a host sync: `cholesky_ex` checks
    nothing on the host, a failed factorization is turned into NaNs on the
    device (as the reference's cho_factor gives them, so the step is
    rejected), and the two triangular solves replace `cholesky_solve`,
    which reads its info on the host."""
    L_fac, info = torch.linalg.cholesky_ex(S)
    L_fac = torch.where(info == 0, L_fac, float("nan"))
    y = torch.linalg.solve_triangular(L_fac, b[:, None], upper=False)
    return torch.linalg.solve_triangular(L_fac.mT, y, upper=True)[:, 0]


def _huber_cost(chi2, delta2):
    return torch.where(chi2 <= delta2, chi2,
                       2.0 * torch.sqrt(delta2 * torch.clamp_min(chi2, 1e-12)) - delta2)


def _total_cost(poses, points, planes, prob, intr, obs_w_extra, pobs_w_extra):
    _, _, _, chi2 = _point_residuals(poses, points, prob, intr)
    delta2 = torch.where(prob.obs_ur >= 0, CHI2_3D, CHI2_2D)
    c1 = torch.sum(_huber_cost(chi2, delta2) * prob.obs_valid * obs_w_extra)
    _, _, _, chi2p = _plane_obs_residuals(poses, planes, prob, with_jac=False)
    c2 = torch.sum(_huber_cost(chi2p, CHI2_3D) * prob.pobs_valid * pobs_w_extra)
    epp, _, _ = _plane_plane_residuals(planes, prob, with_jac=False)
    c3 = torch.sum(epp[:, 0] ** 2 * prob.pp_w * prob.pp_valid)
    return c1 + c2 + c3


def bundle_adjust(prob: BAProblem, intr: Intrinsics, stage1_iters: int = 5,
                  stage2_iters: int = 10) -> BAResult:
    """Two-stage LM with a chi2 outlier gate in between (the reference's
    LocalBundleAdjustment schedule).  Fixed iteration counts, accept/reject
    by `torch.where`: no host sync inside the solve."""

    def lm_stage(poses, points, planes, n_iters, obs_w_extra, pobs_w_extra):
        lam = torch.full((), 1e-4, dtype=torch.float32, device=poses.device)
        cost = _total_cost(poses, points, planes, prob, intr, obs_w_extra, pobs_w_extra)
        for _ in range(n_iters):
            dxc, dp, dpl = _solve_ba_iteration(poses, points, planes, prob, intr, lam,
                                               obs_w_extra, pobs_w_extra)
            poses_new = se3_retract(poses, dxc)
            points_new = points + dp
            planes_new = plane_retract(planes, dpl)
            c_new = _total_cost(poses_new, points_new, planes_new, prob, intr, obs_w_extra,
                                pobs_w_extra)
            better = c_new < cost
            poses = torch.where(better, poses_new, poses)
            points = torch.where(better, points_new, points)
            planes = torch.where(better, planes_new, planes)
            lam = torch.where(better, lam * 0.5, lam * 4.0)
            cost = torch.where(better, c_new, cost)
        return poses, points, planes

    def gates(poses, points, planes):
        _, _, _, chi2 = _point_residuals(poses, points, prob, intr)
        _, _, _, chi2p = _plane_obs_residuals(poses, planes, prob, with_jac=False)
        return (chi2 <= delta2) & prob.obs_valid, (chi2p <= CHI2_3D) & prob.pobs_valid

    delta2 = torch.where(prob.obs_ur >= 0, CHI2_3D, CHI2_2D)
    poses, points, planes = lm_stage(prob.poses, prob.points, prob.planes, stage1_iters,
                                     torch.ones_like(prob.obs_inv_sigma2),
                                     torch.ones_like(prob.pobs_w))
    obs_inl, pobs_inl = gates(poses, points, planes)
    poses, points, planes = lm_stage(poses, points, planes, stage2_iters,
                                     obs_inl.to(torch.float32), pobs_inl.to(torch.float32))
    obs_inl, pobs_inl = gates(poses, points, planes)
    cost = _total_cost(poses, points, planes, prob, intr, obs_inl.to(torch.float32),
                       pobs_inl.to(torch.float32))
    return BAResult(poses=poses, points=points, planes=planes, obs_inlier=obs_inl,
                    pobs_inlier=pobs_inl, cost=cost)


def refine_alternating(poses, pose_fixed, points, point_valid, obs_cam, obs_pt, obs_uv, obs_ur,
                       obs_inv_sigma2, obs_valid, intr: Intrinsics, n_iters: int = 8):
    """Alternating resection-intersection refinement, the settle before the
    post-loop global BA's Newton stage: per iteration all per-point 3x3 GN
    solves with the poses fixed, then all per-pose 6x6 solves with the
    points fixed.  obs_valid is a float weight.  Returns (poses, points).

    The batched solves are `torch.linalg.solve_ex`: no host check of the
    factorization (`torch.linalg.solve` raises on a singular block, where
    the reference's solve returns inf/NaN without a word)."""
    M, P = poses.shape[0], points.shape[0]
    dt, dev = poses.dtype, poses.device
    free = (~pose_fixed).to(dt)
    obs_pt_l, obs_cam_l = obs_pt.long(), obs_cam.long()
    delta2 = torch.where(obs_ur >= 0, CHI2_3D, CHI2_2D)
    eye3 = torch.eye(3, dtype=dt, device=dev)
    eye6 = torch.eye(6, dtype=dt, device=dev)

    def weights(chi2):
        # gate wild residuals (points behind or near the camera plane)
        sane = (chi2 < 1e4) & torch.isfinite(chi2)
        return obs_inv_sigma2 * huber_weight(chi2, delta2) * obs_valid * sane

    for _ in range(n_iters):
        # intersection: points, poses fixed
        e, _, J_p, chi2 = point_obs_residuals(poses, points, obs_cam, obs_pt, obs_uv, obs_ur,
                                              obs_inv_sigma2, intr)
        JpW = J_p * weights(chi2)[:, None, None]
        Hpp = torch.zeros((P, 3, 3), dtype=dt, device=dev).index_add_(
            0, obs_pt_l, torch.einsum("rai,raj->rij", JpW, J_p))
        bp = torch.zeros((P, 3), dtype=dt, device=dev).index_add_(
            0, obs_pt_l, -torch.einsum("rai,ra->ri", JpW, e))
        # Marquardt damping relative to the diagonal scale
        diag_p = torch.einsum("pii->p", Hpp) / 3.0
        Hpp = Hpp + (0.05 * diag_p[:, None, None] + 1e-3) * eye3
        dp = torch.linalg.solve_ex(Hpp, bp[..., None])[0][..., 0]
        dp = torch.clamp(dp, -0.5, 0.5)
        points = points + dp * point_valid[:, None]
        # resection: poses, points fixed
        e, J_c, _, chi2 = point_obs_residuals(poses, points, obs_cam, obs_pt, obs_uv, obs_ur,
                                              obs_inv_sigma2, intr)
        JcW = J_c * weights(chi2)[:, None, None]
        Hcc = torch.zeros((M, 6, 6), dtype=dt, device=dev).index_add_(
            0, obs_cam_l, torch.einsum("rai,raj->rij", JcW, J_c))
        bc = torch.zeros((M, 6), dtype=dt, device=dev).index_add_(
            0, obs_cam_l, -torch.einsum("rai,ra->ri", JcW, e))
        diag_c = torch.einsum("mii->m", Hcc) / 6.0
        Hcc = Hcc + (0.05 * diag_c[:, None, None] + 1e-3) * eye6
        dx = torch.linalg.solve_ex(Hcc, bc[..., None])[0][..., 0] * free[:, None]
        poses = se3_retract(poses, torch.clamp(dx, -0.2, 0.2))
    return poses, points


def build_point_obs_table(obs_pt, n_points: int, omax: int) -> np.ndarray:
    """Host helper: per-point observation index table [P, OMAX] (-1 pad)
    from obs_pt [R] (-1 for padding); observations beyond OMAX per point
    are dropped.  Each point's row lists its observations in index order."""
    obs_pt = np.asarray(obs_pt)
    table = np.full((n_points, omax), -1, dtype=np.int32)
    r = np.nonzero(obs_pt >= 0)[0]
    r = r[np.argsort(obs_pt[r], kind="stable")]
    p = obs_pt[r]
    rank = np.arange(len(p)) - np.searchsorted(p, p, side="left")
    keep = rank < omax
    table[p[keep], rank[keep]] = r[keep]
    return table
