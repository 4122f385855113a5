"""The plain reference of a loop closure's correction: the essential graph
solved by damped Gauss-Newton on SE(3), then the map points moved with
their reference keyframes.  Plain PyTorch in float32; it imports nothing
of the program.

It takes the essential graph as the program builds it
(`LoopCloser._optimize_graph` in spslam_tpu_torch/loop/loop_closer.py):
the poses T_cw of every keyframe slot [K, 7], the fixed and valid masks
[K], and the edges' ends i, j [E], measured relative poses T_i . T_j^{-1}
[E, 7], weights [E] and valid mask [E].  The solve:

    residual     r_e = log(T_meas . (T_i . T_j^{-1})^{-1})      (lie.se3_log)
    update       T <- exp(xi) . T, a left perturbation           (lie.se3_retract)
    Jacobians    reverse-mode autodiff (torch.autograd.functional.jacobian)
                 of the sum over the edges of r_e at xi = 0: each r_e
                 depends on its own edge's 12 numbers alone, so the sum's
                 Jacobian holds every edge's 6 x 12 block
    system       the dense Jacobian J [6 E, 6 F] over the F free poses
                 (valid, not fixed) and the normal equations
                 [H | g] = J^T W [J | r] in one matrix product
    step         (H + diag(lam * diag(H) + 1e-6)) dx = -g by Cholesky
    accept       when sum_e w_e |r_e|^2 falls: lam * 0.5, else lam * 4,
                 from lam = 1e-6; n_iters iterations (a failed
                 factorisation is a rejected step)

and the point correction X' = T_new^{-1} . T_old . X through each point's
reference keyframe (keyframe 0 where that one is no longer valid).

`precision="tf32"` is the control: the normal equations' product in TF32,
the nearest precision below float32.  On a CUDA card it sets
`torch.backends.cuda.matmul.allow_tf32` (the float32 runs set it and the
cuDNN flag False); on the CPU, which has no TF32, the product's operands
are rounded to TF32's 10-bit mantissa (to nearest) first.

Departures from ORB-SLAM2's `Optimizer::OptimizeEssentialGraph` (as read
from its source; none of them is the program's fault, each is the
program's design and is the same here):
* SE(3) vertices, where ORB-SLAM2 uses Sim3 vertices with the scale free
  in the optimisation (RGB-D only fixes it in the loop's Sim3 estimate);
* the first valid keyframe is fixed, where ORB-SLAM2 fixes the loop
  (matched) keyframe;
* the edges are the program's: the spanning tree, up to 5 covisibility
  edges a keyframe of weight >= 30 (ORB-SLAM2: every covisibility edge of
  weight >= 100) and the loop edges at weight 10 (ORB-SLAM2: identity
  information on every edge);
* the initial poses are those before the correction, where ORB-SLAM2
  first propagates the loop's correction to the current keyframe's
  covisible keyframes and their points and starts from those;
* this damped Gauss-Newton rule, where g2o's Levenberg adds lambda to the
  diagonal from a user initial lambda of 1e-16 and updates it by the gain
  ratio;
* every point is moved through its reference keyframe, where ORB-SLAM2
  moves a point it already corrected through the keyframe that corrected
  it; planes are not corrected here (the configurations that take this
  reference run no planes).
"""

from __future__ import annotations

import contextlib

import torch

from . import lie


def _round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to nearest at TF32's 10-bit mantissa."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


@contextlib.contextmanager
def _precision(device: torch.device, precision: str):
    if precision not in ("float32", "tf32"):
        raise ValueError(f"precision {precision!r}")
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    on = precision == "tf32"
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = on
        torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def edge_residuals(Ti: torch.Tensor, Tj: torch.Tensor, Tm: torch.Tensor) -> torch.Tensor:
    """[E, 6]: log(T_meas . (T_i . T_j^{-1})^{-1})."""
    rel = lie.se3_compose(Ti, lie.se3_inverse(Tj))
    return lie.se3_log(lie.se3_compose(Tm, lie.se3_inverse(rel)))


def edge_jacobians(Ti: torch.Tensor, Tj: torch.Tensor, Tm: torch.Tensor) -> torch.Tensor:
    """[E, 6, 12]: each edge's residual by its (xi_i, xi_j) at zero."""
    z = torch.zeros(Ti.shape[0], 12, dtype=Ti.dtype, device=Ti.device)

    def total(x):
        return edge_residuals(lie.se3_retract(Ti, x[:, :6]), lie.se3_retract(Tj, x[:, 6:]),
                              Tm).sum(0)

    return torch.autograd.functional.jacobian(total, z).permute(1, 0, 2)


def _cost(poses, i, j, Tm, w) -> torch.Tensor:
    r = edge_residuals(poses[i], poses[j], Tm)
    return torch.sum(torch.sum(r * r, dim=-1) * w)


def solve(poses, fixed, valid, edge_i, edge_j, edge_T, edge_w, edge_valid,
          n_iters: int = 20, precision: str = "float32") -> torch.Tensor:
    """The essential graph's optimised poses [K, 7]; fixed and invalid
    slots keep theirs."""
    dev = poses.device
    free = valid & ~fixed
    fidx = torch.nonzero(free)[:, 0]
    F = int(fidx.numel())
    col = torch.full((poses.shape[0],), -1, dtype=torch.long, device=dev)
    col[fidx] = torch.arange(F, device=dev)
    sel = torch.nonzero(edge_valid)[:, 0]
    i, j = edge_i.long()[sel], edge_j.long()[sel]
    Tm, w = edge_T[sel], edge_w[sel]
    E = int(sel.numel())
    rows = torch.arange(E, device=dev)
    lam = 1e-6
    with _precision(dev, precision):
        cost = _cost(poses, i, j, Tm, w)
        for _ in range(n_iters):
            r = edge_residuals(poses[i], poses[j], Tm)
            Je = edge_jacobians(poses[i], poses[j], Tm)
            J = torch.zeros(E, F, 6, 6, dtype=poses.dtype, device=dev)   # [edge, pose, row, col]
            for ends, block in ((col[i], Je[:, :, :6]), (col[j], Je[:, :, 6:])):
                on = ends >= 0
                J[rows[on], ends[on]] += block[on]
            J = J.permute(0, 2, 1, 3).reshape(6 * E, 6 * F)
            A = torch.cat([J, r.reshape(-1, 1)], dim=1)
            JtW = (J * w.repeat_interleave(6)[:, None]).T
            if precision == "tf32" and dev.type == "cpu":
                JtW, A = _round_tf32(JtW), _round_tf32(A)
            N = JtW @ A
            H, g = N[:, :-1], N[:, -1]
            H = H + torch.diag(lam * torch.diagonal(H) + 1e-6)
            L, info = torch.linalg.cholesky_ex(H)
            if int(info) != 0:
                lam *= 4.0
                continue
            dx = -torch.cholesky_solve(g[:, None], L)[:, 0]
            new = poses.clone()
            new[fidx] = lie.se3_retract(poses[fidx], dx.reshape(F, 6))
            c_new = _cost(new, i, j, Tm, w)
            if bool(c_new < cost):
                poses, cost, lam = new, c_new, lam * 0.5
            else:
                lam *= 4.0
    return poses


def correct_points(points: torch.Tensor, ref_kf: torch.Tensor, kf_valid: torch.Tensor,
                   old_poses: torch.Tensor, new_poses: torch.Tensor) -> torch.Tensor:
    """[N, 3]: each point moved with its reference keyframe,
    T_new^{-1} . T_old . X (keyframe 0 where the reference is invalid)."""
    K = old_poses.shape[0]
    ref = ref_kf.long()
    ok = (ref >= 0) & (ref < K) & kf_valid[ref.clamp(0, K - 1)]
    ref = torch.where(ok, ref, torch.zeros_like(ref))
    Xc = lie.se3_apply(old_poses[ref], points)
    return lie.se3_apply(lie.se3_inverse(new_poses[ref]), Xc)
