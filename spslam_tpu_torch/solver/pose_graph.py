"""Pose-graph (essential-graph) optimization over SE(3) (port of
spslam_tpu/solver/pose_graph.py).

Edge residual r_ij = log(T_meas . rel^{-1}) with rel = T_i . T_j^{-1};
structural edges measure rel on the pre-loop poses, loop edges take the
computed loop transform.  6x6 edge Jacobians by forward-mode autodiff of
the retraction (`torch.func.vmap(jacfwd)` through solver/ba.py's
`batched_jacfwd`, as the reference's `jax.vmap(jax.jacfwd)`); the first iteration linearizes every structural
edge at exactly zero residual, where `so3_log` takes its small-angle
branch (geometry/lie.py keeps its tangent free of NaN).  Damped GN on the
dense 6K x 6K system: block scatter-adds (`solver/ba._scatter_block_add`),
solver/ba.py's `cho_solve` (a failed factorization gives NaN on the device,
as the reference's `cho_factor` does, and the step is rejected), and the
accept/reject as a device `where`: no host sync inside the solve.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..geometry.lie import se3_compose, se3_inverse, se3_log, se3_retract
from .ba import _scatter_block_add, _scatter_vec_add, batched_jacfwd, cho_solve


class PoseGraphProblem(NamedTuple):
    poses: torch.Tensor       # [K, 7] current T_cw estimates
    fixed: torch.Tensor       # [K] bool
    valid: torch.Tensor       # [K] bool
    edge_i: torch.Tensor      # [E] int
    edge_j: torch.Tensor      # [E] int
    edge_T: torch.Tensor      # [E, 7] measured T_i . T_j^{-1}
    edge_w: torch.Tensor      # [E] weight
    edge_valid: torch.Tensor  # [E] bool


def _edge_residual(Ti, Tj, Tmeas):
    rel = se3_compose(Ti, se3_inverse(Tj))
    return se3_log(se3_compose(Tmeas, se3_inverse(rel)))


def _edge_r(xi_i, xi_j, Ti, Tj, Tm):
    return _edge_residual(se3_retract(Ti, xi_i), se3_retract(Tj, xi_j), Tm)


def edge_terms(poses: torch.Tensor, prob: PoseGraphProblem):
    """Residuals [E, 6] and Jacobians J_i, J_j [E, 6, 6] at the current
    poses (derivatives at zero perturbation)."""
    Ti = poses[prob.edge_i.long()]
    Tj = poses[prob.edge_j.long()]
    z = torch.zeros(Ti.shape[0], 6, dtype=poses.dtype, device=poses.device)
    e = _edge_residual(Ti, Tj, prob.edge_T)
    Ji, Jj = batched_jacfwd(_edge_r, (0, 1), z, z, Ti, Tj, prob.edge_T)
    return e, Ji, Jj


def _cost(poses, prob: PoseGraphProblem):
    e = _edge_residual(poses[prob.edge_i.long()], poses[prob.edge_j.long()], prob.edge_T)
    return torch.sum(torch.sum(e * e, dim=-1) * prob.edge_w * prob.edge_valid)


def optimize_pose_graph(prob: PoseGraphProblem, n_iters: int = 20) -> torch.Tensor:
    """Damped GN on the pose graph.  Returns the optimized poses [K, 7]."""
    poses = prob.poses
    K = poses.shape[0]
    dim = 6 * K
    dev = poses.device
    free6 = (prob.valid & ~prob.fixed).repeat_interleave(6).to(poses.dtype)
    w = (prob.edge_w * prob.edge_valid)[:, None, None]
    io = torch.where(prob.edge_valid, prob.edge_i.long() * 6, dim)
    jo = torch.where(prob.edge_valid, prob.edge_j.long() * 6, dim)
    lam = torch.full((), 1e-6, dtype=poses.dtype, device=dev)
    cost = _cost(poses, prob)
    for _ in range(n_iters):
        e, Ji, Jj = edge_terms(poses, prob)
        JiW = Ji * w
        JjW = Jj * w
        S = torch.zeros((dim + 6, dim + 6), dtype=poses.dtype, device=dev)
        b = torch.zeros((dim + 6,), dtype=poses.dtype, device=dev)
        S = _scatter_block_add(S, io, io, torch.einsum("eai,eaj->eij", JiW, Ji))
        S = _scatter_block_add(S, jo, jo, torch.einsum("eai,eaj->eij", JjW, Jj))
        cr = torch.einsum("eai,eaj->eij", JiW, Jj)
        S = _scatter_block_add(S, io, jo, cr)
        S = _scatter_block_add(S, jo, io, cr.transpose(-1, -2))
        b = _scatter_vec_add(b, io, -torch.einsum("eai,ea->ei", JiW, e))
        b = _scatter_vec_add(b, jo, -torch.einsum("eai,ea->ei", JjW, e))
        S = S[:dim, :dim] * free6[:, None] * free6[None, :]
        b = b[:dim] * free6
        S = S + torch.diag(lam * torch.diagonal(S) + 1e-6) + torch.diag(1.0 - free6)
        dx = cho_solve(S, b)
        poses_new = se3_retract(poses, dx.reshape(K, 6))
        c_new = _cost(poses_new, prob)
        better = c_new < cost
        poses = torch.where(better, poses_new, poses)
        lam = torch.where(better, lam * 0.5, lam * 4.0)
        cost = torch.where(better, c_new, cost)
    return poses
