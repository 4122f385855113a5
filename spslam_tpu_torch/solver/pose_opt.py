"""Motion-only pose optimization (port of spslam_tpu/solver/pose_opt.py,
point terms; the joint point+plane version comes with the planes slice).

LM on one SE(3) vertex with mono + virtual-right reprojection rows, Huber
kernel and the reference's chi2 re-gating rounds.

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
from ..geometry.lie import quat_rotate, se3_q, se3_retract, se3_t
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
