"""Motion-only pose optimization (port of spslam_tpu/solver/pose_opt.py).

LM on one SE(3) vertex with mono + virtual-right reprojection rows, Huber
kernel and the reference's chi2 re-gating rounds; the joint version adds
plane-to-plane rows (SP-SLAM's tracking plane edges).

Early exit: the reference's inner loop is a `lax.while_loop` that stops
once an accepted step is tiny (step2 <= 1e-10).  Testing that on the host
would cost one device sync per iteration, so the port runs the fixed
n_iters with an `active` mask: once the while loop would have exited, T
and lam stop changing, which yields the same T.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..geometry.camera import Intrinsics
from ..geometry.lie import hat, quat_rotate, se3_q, se3_retract, se3_t
from .robust import CHI2_2D, CHI2_3D, huber_weight, solve6


class PoseOptResult(NamedTuple):
    T_cw: torch.Tensor      # [7] optimized pose
    inliers: torch.Tensor   # [N] bool final inlier classification
    n_inliers: torch.Tensor # [] int32
    chi2: torch.Tensor      # [] float32 final robust cost


def _residuals_and_jac(T_cw, pts_w, uv_obs, ur_obs, intr: Intrinsics):
    """Residuals [N,3] (u, v, uR) and Jacobians [N,3,6] wrt a left se3
    perturbation; row 2 is active only where ur_obs >= 0."""
    xc = quat_rotate(se3_q(T_cw), pts_w) + se3_t(T_cw)
    x, y, z = xc[..., 0], xc[..., 1], xc[..., 2]
    z = torch.clamp_min(z, 1e-6)
    iz = 1.0 / z
    iz2 = iz * iz
    u = intr.fx * x * iz + intr.cx
    v = intr.fy * y * iz + intr.cy
    ur = u - intr.bf * iz

    e_u = uv_obs[..., 0] - u
    e_v = uv_obs[..., 1] - v
    e_r = torch.where(ur_obs >= 0, ur_obs - ur, 0.0)
    e = torch.stack([e_u, e_v, e_r], dim=-1)

    zeros = torch.zeros_like(z)
    ones = torch.ones_like(z)
    du = torch.stack([intr.fx * iz, zeros, -intr.fx * x * iz2], dim=-1)
    dv = torch.stack([zeros, intr.fy * iz, -intr.fy * y * iz2], dim=-1)
    dr = du + torch.stack([zeros, zeros, intr.bf * iz2], dim=-1)
    dproj = torch.stack([du, dv, dr], dim=-2)                   # [N,3,3]
    dxc = torch.stack(
        [
            torch.stack([ones, zeros, zeros, zeros, z, -y], dim=-1),
            torch.stack([zeros, ones, zeros, -z, zeros, x], dim=-1),
            torch.stack([zeros, zeros, ones, y, -x, zeros], dim=-1),
        ],
        dim=-2,
    )                                                           # [N,3,6]
    J = -(dproj @ dxc)
    depth_active = (ur_obs >= 0).to(e.dtype)
    row_mask = torch.stack([torch.ones_like(depth_active), torch.ones_like(depth_active),
                           depth_active], -1)
    return e * row_mask, J * row_mask[..., None], z


def _plane_residuals_and_jac(T_cw, pl_w, pl_obs_c, pl_w_valid):
    """Plane-to-plane residuals [L,4] and Jacobians [L,4,6] wrt a left se3
    perturbation.  pl_w: world planes; pl_obs_c: matched observations in
    the camera frame, sign-aligned to the prediction n_c = R n_w,
    d_c = d_w - n_c . t before differencing."""
    n_c = quat_rotate(se3_q(T_cw)[None, :], pl_w[:, :3])
    d_c = pl_w[:, 3] - torch.sum(n_c * se3_t(T_cw)[None, :], dim=-1)
    flip = torch.sum(n_c * pl_obs_c[:, :3], dim=-1) < 0
    obs = torch.where(flip[:, None], -pl_obs_c, pl_obs_c)
    e = torch.cat([obs[:, :3] - n_c, (obs[:, 3] - d_c)[:, None]], dim=-1)
    # e = obs - pred: dn_c/dphi = -[n_c]x, dd_c/drho = -n_c
    skew = hat(n_c)
    J_n = torch.cat([torch.zeros_like(skew), skew], dim=-1)
    J_d = torch.cat([n_c, torch.zeros_like(n_c)], dim=-1)[:, None, :]
    J = torch.cat([J_n, J_d], dim=-2)
    m = pl_w_valid.to(e.dtype)
    return e * m[:, None], J * m[:, None, None]


# chi2 gate for the 4-dof plane residual at the working information weights
CHI2_PLANE = 9.49  # 95% of chi2(4)


def pose_optimization_joint(T_cw_init: torch.Tensor, pts_w: torch.Tensor,
                            uv_obs: torch.Tensor, ur_obs: torch.Tensor,
                            inv_sigma2: torch.Tensor, valid: torch.Tensor,
                            pl_w: torch.Tensor, pl_obs_c: torch.Tensor,
                            pl_valid: torch.Tensor, pl_info: torch.Tensor,
                            intr: Intrinsics, n_rounds: int = 2,
                            n_iters: int = 5) -> PoseOptResult:
    """Joint point + plane motion-only LM: pose_optimization with the plane
    rows of pl_w [L,4] / pl_obs_c [L,4] (valid where pl_valid) added to H
    and b, weighted by pl_info [L]; plane outliers are re-gated between
    rounds like points.  Fixed iteration counts (module doc)."""
    delta2 = torch.where(ur_obs >= 0, CHI2_3D, CHI2_2D)
    validf = valid.to(torch.float32)
    pl_validf = pl_valid.to(torch.float32)
    dev = pts_w.device
    eye6 = torch.eye(6, dtype=torch.float32, device=dev)

    def chi2s(T):
        e, _, _ = _residuals_and_jac(T, pts_w, uv_obs, ur_obs, intr)
        e_p, _ = _plane_residuals_and_jac(T, pl_w, pl_obs_c, pl_valid)
        return torch.sum(e * e, dim=-1) * inv_sigma2, torch.sum(e_p * e_p, dim=-1) * pl_info

    def cost(chi2, chi2_p, inliers, pl_inliers):
        return (torch.sum(torch.minimum(chi2, delta2 * 10) * inliers * validf)
                + torch.sum(torch.clamp_max(chi2_p, CHI2_PLANE * 10) * pl_inliers))

    def lm_round(T, inliers, pl_inliers):
        lam = torch.tensor(1e-3, dtype=torch.float32, device=dev)
        active = torch.ones((), dtype=torch.bool, device=dev)
        for _ in range(n_iters):
            e, J, _ = _residuals_and_jac(T, pts_w, uv_obs, ur_obs, intr)
            chi2 = torch.sum(e * e, dim=-1) * inv_sigma2
            w = inv_sigma2 * huber_weight(chi2, delta2) * inliers * validf
            Jw = J * w[:, None, None]
            H = torch.einsum("nri,nrj->ij", Jw, J)
            b = -torch.einsum("nri,nr->i", Jw, e)
            e_p, J_p = _plane_residuals_and_jac(T, pl_w, pl_obs_c, pl_valid)
            chi2_p = torch.sum(e_p * e_p, dim=-1) * pl_info
            w_p = pl_info * huber_weight(chi2_p, CHI2_PLANE) * pl_inliers * pl_validf
            Jpw = J_p * w_p[:, None, None]
            H = H + torch.einsum("nri,nrj->ij", Jpw, J_p)
            b = b - torch.einsum("nri,nr->i", Jpw, e_p)
            H = H + lam * torch.diag(torch.diag(H)) + 1e-8 * eye6
            dx = solve6(H, b)
            T_new = se3_retract(T, dx)
            better = (cost(*chi2s(T_new), inliers, pl_inliers)
                      < cost(chi2, chi2_p, inliers, pl_inliers))
            T = torch.where(active & better, T_new, T)
            lam = torch.where(active, torch.where(better, lam * 0.5, lam * 4.0), lam)
            step2 = torch.where(better, torch.sum(dx * dx), 1e9)
            active = active & (step2 > 1e-10)
        return T

    T = T_cw_init
    inliers = validf
    pl_inl = pl_validf
    for _ in range(n_rounds):
        T = lm_round(T, inliers, pl_inl)
        chi2, chi2_p = chi2s(T)
        inliers = (chi2 <= delta2).to(torch.float32) * validf
        pl_inl = (chi2_p <= CHI2_PLANE).to(torch.float32) * pl_validf

    final_inl = inliers > 0
    chi2, _ = chi2s(T)
    return PoseOptResult(
        T_cw=T,
        inliers=final_inl,
        n_inliers=torch.sum(final_inl, dtype=torch.int32),
        chi2=torch.sum(torch.where(final_inl, chi2, 0.0)),
    )


def pose_optimization(T_cw_init: torch.Tensor, pts_w: torch.Tensor, uv_obs: torch.Tensor,
                      ur_obs: torch.Tensor, inv_sigma2: torch.Tensor, valid: torch.Tensor,
                      intr: Intrinsics, n_rounds: int = 4, n_iters: int = 10) -> PoseOptResult:
    """Optimize one camera pose against fixed 3D points (no host sync)."""
    is_stereo = ur_obs >= 0
    delta2 = torch.where(is_stereo, CHI2_3D, CHI2_2D)
    validf = valid.to(torch.float32)
    eye6 = torch.eye(6, dtype=torch.float32, device=pts_w.device)

    def obs_chi2(T):
        e, _, _ = _residuals_and_jac(T, pts_w, uv_obs, ur_obs, intr)
        return torch.sum(e * e, dim=-1) * inv_sigma2

    def robust_cost(chi2, inliers):
        rho = torch.where(
            chi2 <= delta2, chi2,
            2.0 * torch.sqrt(delta2 * torch.clamp_min(chi2, 1e-12)) - delta2,
        )
        return torch.sum(rho * inliers * validf)

    def lm_round(T, inliers):
        lam = torch.tensor(1e-3, dtype=torch.float32, device=pts_w.device)
        active = torch.ones((), dtype=torch.bool, device=pts_w.device)
        for _ in range(n_iters):
            e, J, _ = _residuals_and_jac(T, pts_w, uv_obs, ur_obs, intr)
            chi2 = torch.sum(e * e, dim=-1) * inv_sigma2
            w = inv_sigma2 * huber_weight(chi2, delta2) * inliers * validf
            Jw = J * w[:, None, None]
            H = torch.einsum("nri,nrj->ij", Jw, J)
            b = -torch.einsum("nri,nr->i", Jw, e)
            H = H + lam * torch.diag(torch.diag(H)) + 1e-8 * eye6
            dx = solve6(H, b)
            T_new = se3_retract(T, dx)
            cost_cur = robust_cost(chi2, inliers)
            e_new, _, _ = _residuals_and_jac(T_new, pts_w, uv_obs, ur_obs, intr)
            cost_new = robust_cost(torch.sum(e_new * e_new, dim=-1) * inv_sigma2, inliers)
            better = cost_new < cost_cur
            T = torch.where(active & better, T_new, T)
            lam = torch.where(active, torch.where(better, lam * 0.5, lam * 4.0), lam)
            step2 = torch.where(better, torch.sum(dx * dx), 1e9)
            active = active & (step2 > 1e-10)
        return T

    T = T_cw_init
    inliers = validf
    for _ in range(n_rounds):
        T = lm_round(T, inliers)
        inliers = (obs_chi2(T) <= delta2).to(torch.float32) * validf

    final_inl = inliers > 0
    chi2 = obs_chi2(T)
    return PoseOptResult(
        T_cw=T,
        inliers=final_inl,
        n_inliers=torch.sum(final_inl, dtype=torch.int32),
        chi2=torch.sum(torch.where(final_inl, chi2, 0.0)),
    )
