"""The fused tracking step (frozen copy of spslam_tpu_torch/tracking/tracker.py:
`track_frame_step`, `_pack_frame` and the stages they call).

One frame through pose prediction, frame build, coarse motion-model match
with a 2x5 LM, the global descriptor fallback, tight local-map match with a
4x10 LM and, given a map-plane snapshot, segmentation and the 2x5 joint
point+plane LM; returns the two packed output buffers in the program's
layouts (see `track_frame_step`).  Plain PyTorch on any device: FAST+NMS
runs as `fast.fast_nms_scores_levels_plain`.
"""

from __future__ import annotations

import math

import torch

from .brief import to_int32_bits, unpack_bits
from .camera import Intrinsics, in_image
from .frame import FrameData, build_frame
from .lie import quat_rotate, se3_compose, se3_inverse, se3_q, se3_t
from .match import TH_HIGH, TH_LOW, match_descriptors, search_by_projection
from .plane import transform_plane
from .plane_seg import segment_planes
from .pose_opt import pose_optimization, pose_optimization_joint
from .pyramid import PyramidSpec
from .robust import octave_inv_sigma2

# Frustum-gate slacks (the reference's IsInFrustum uses 0.8 / 1.2)
DIST_SLACK_LO = 0.8
DIST_SLACK_HI = 1.2
OCTAVE_SLACK = 1  # +- pyramid levels around the predicted octave

# the global fallback's result only counts when the motion-model stage
# tracked fewer inliers than this
FALLBACK_SEED_GATE = 60


def project_points(T_cw, pos, normal, min_dist, max_dist, valid, intr: Intrinsics):
    """Project local map points with the reference's frustum gates; also
    returns the predicted pyramid octave and the camera depth."""
    q, t = se3_q(T_cw), se3_t(T_cw)
    xc = quat_rotate(q, pos) + t
    z = xc[..., 2]
    u = intr.fx * xc[..., 0] / torch.clamp_min(z, 1e-6) + intr.cx
    v = intr.fy * xc[..., 1] / torch.clamp_min(z, 1e-6) + intr.cy
    uv = torch.stack([u, v], dim=-1)

    C = -quat_rotate(torch.cat([q[:1], -q[1:]]), t)
    vec = pos - C
    dist = torch.linalg.norm(vec, dim=-1)
    view_cos = torch.sum(vec * normal, dim=-1) / torch.clamp_min(dist, 1e-9)
    ok = (
        valid
        & (z > 0.05)
        & in_image(intr, uv, border=1.0)
        & (dist >= DIST_SLACK_LO * min_dist)
        & (dist <= DIST_SLACK_HI * max_dist)
        & (view_cos > 0.5)
    )
    ratio = torch.clamp_min(max_dist, 1e-9) / torch.clamp_min(dist, 1e-9)
    log_scale = torch.log(torch.tensor(1.2, dtype=torch.float32, device=pos.device))
    oct_pred = torch.clamp(torch.ceil(torch.log(ratio) / log_scale).to(torch.int32), 0, 7)
    return uv, ok, oct_pred, z


def _match_and_optimize(T_init, pt_pos, pt_normal, pt_min_dist, pt_max_dist, pt_bits,
                        pt_valid, frame: FrameData, radius_base, max_dist_hamming,
                        intr: Intrinsics, n_rounds: int = 4, n_iters: int = 10):
    """Project -> gated match -> pose optimization.
    Returns (opt_result, match_idx [PL] kp index or -1, matched [PL])."""
    uv, ok, oct_pred, _ = project_points(
        T_init, pt_pos, pt_normal, pt_min_dist, pt_max_dist, pt_valid, intr
    )
    radius = radius_base * torch.pow(1.2, oct_pred.to(torch.float32))
    res = search_by_projection(
        uv, pt_bits, ok, oct_pred, frame.uv, frame.bits, frame.valid, frame.octave,
        radius, max_dist=max_dist_hamming, ratio=0.95, octave_slack=OCTAVE_SLACK,
    )
    kp_idx = torch.clamp_min(res.idx, 0).long()
    matched = res.valid
    ur_obs = torch.where(matched, frame.u_right[kp_idx], -1.0)
    opt = _compact_pose_opt(
        T_init, pt_pos, frame.uv[kp_idx], ur_obs, octave_inv_sigma2(frame.octave[kp_idx]),
        matched, frame.uv.shape[0], intr, n_rounds, n_iters,
    )
    return opt, torch.where(matched, res.idx, -1), matched


def _compact_pose_opt(T_init, pt_pos, uv_obs, ur_obs, inv_s2, matched,
                      n_kp: int, intr: Intrinsics, n_rounds: int, n_iters: int):
    """Pose optimization over the matched rows only: at most n_kp of the
    PL snapshot rows can match, so the stable argsort on the mask moves
    them first and the LM runs on n_kp rows; the inlier mask is scattered
    back to the PL layout."""
    PL = pt_pos.shape[0]
    if PL <= n_kp:
        return pose_optimization(T_init, pt_pos, uv_obs, ur_obs, inv_s2, matched, intr,
                                 n_rounds=n_rounds, n_iters=n_iters)
    sel = torch.argsort(torch.logical_not(matched).to(torch.int8), stable=True)[:n_kp]
    opt_c = pose_optimization(
        T_init, pt_pos[sel], uv_obs[sel], ur_obs[sel], inv_s2[sel], matched[sel], intr,
        n_rounds=n_rounds, n_iters=n_iters,
    )
    inliers_full = torch.zeros_like(matched)
    inliers_full[sel] = opt_c.inliers
    return opt_c._replace(inliers=inliers_full & matched)


def _compact_joint_opt(T_init, pt_pos, uv_obs, ur_obs, inv_s2, matched,
                       pl_w, pl_obs, pl_valid, pl_info,
                       n_kp: int, intr: Intrinsics, n_rounds: int, n_iters: int):
    """pose_optimization_joint over the matched point rows (compacted as in
    _compact_pose_opt) plus the plane rows."""
    sel = torch.argsort(torch.logical_not(matched).to(torch.int8), stable=True)[:n_kp]
    opt_c = pose_optimization_joint(
        T_init, pt_pos[sel], uv_obs[sel], ur_obs[sel], inv_s2[sel], matched[sel],
        pl_w, pl_obs, pl_valid, pl_info, intr, n_rounds=n_rounds, n_iters=n_iters,
    )
    inliers_full = torch.zeros_like(matched)
    inliers_full[sel] = opt_c.inliers
    return opt_c._replace(inliers=inliers_full & matched)


def _plane_refine(opt2, frame: FrameData, depth, full_height: int, match_idx, matched,
                  pt_pos, pl_pack, intr: Intrinsics, plane_info: float,
                  plane_assoc_cos: float, plane_assoc_dist: float, plane_min_support: int):
    """Segment the frame's planes from the depth upload, associate them
    with the map-plane snapshot pl_pack [PLANE_CAP, 5] (world coef | valid)
    at the point-stage pose, and refine the pose jointly (2x5 LM)."""
    s = full_height // depth.shape[0]
    intr_d = intr._replace(fx=intr.fx / s, fy=intr.fy / s, cx=intr.cx / s, cy=intr.cy / s,
                           width=intr.width // s, height=intr.height // s) if s > 1 else intr
    fp = segment_planes(depth, intr_d)
    pl_w = pl_pack[:, 0:4]
    pl_wvalid = pl_pack[:, 4] > 0.5
    pi_pred = transform_plane(opt2.T_cw, pl_w)                           # [L,4]
    cos = torch.sum(pi_pred[:, None, :3] * fp.coef[None, :, :3], dim=-1)  # [L,K]
    sgn = torch.where(cos >= 0, 1.0, -1.0)
    dd = torch.abs(pi_pred[:, 3:4] - sgn * fp.coef[None, :, 3])
    okm = (pl_wvalid[:, None] & fp.valid[None, :]
           & (fp.n_inliers[None, :] >= plane_min_support)
           & (torch.abs(cos) > plane_assoc_cos) & (dd < plane_assoc_dist))
    score = torch.where(okm, torch.abs(cos), -1.0)
    best = torch.argmax(score, dim=1)                                    # first max, as jnp
    has_match = torch.take_along_dim(score, best[:, None], 1)[:, 0] > 0
    obs = fp.coef[best] * torch.take_along_dim(sgn, best[:, None], 1)    # sign-aligned
    # information proportional to the observed plane's pixel support
    # (1000 px at the upload resolution is the nominal support)
    sup = fp.n_inliers[best].to(torch.float32)
    pl_info_vec = plane_info * torch.clamp(sup / 1000.0, 0.5, 8.0)
    kp_j = torch.clamp_min(match_idx, 0).long()
    return _compact_joint_opt(
        opt2.T_cw, pt_pos, frame.uv[kp_j], torch.where(matched, frame.u_right[kp_j], -1.0),
        octave_inv_sigma2(frame.octave[kp_j]), matched, pl_w, obs, has_match, pl_info_vec,
        frame.uv.shape[0], intr, 2, 5,
    )


def decode_depth(frame_depth: torch.Tensor, depth_factor: float) -> torch.Tensor:
    """Depth in meters from float meters, or from raw integer units (u16
    raw depth travels as int16 bits)."""
    if frame_depth.is_floating_point():
        return frame_depth.to(torch.float32)
    raw = frame_depth.to(torch.int32)
    if frame_depth.dtype == torch.int16:
        raw = raw & 0xFFFF
    return raw.to(torch.float32) / depth_factor


def track_frame_step(frame_gray, frame_depth, T_prev, T_prev2, has_vel, pt_pack, pt_desc,
                     radius_motion: float, radius2: float, th_depth: float,
                     spec: PyramidSpec, intr: Intrinsics, n_features: int,
                     th_high: float = 20.0, th_low: float = 7.0,
                     depth_factor: float = 5000.0, pl_pack=None,
                     plane_info: float = 1e5, plane_assoc_cos: float = 0.94,
                     plane_assoc_dist: float = 0.2, plane_min_support: int = 300):
    """One frame through the whole device pipeline (see module doc).

    frame_gray: [H, W] uint8 or float32; frame_depth: [h, w] float32 meters
    or raw integer units; T_prev/T_prev2: [7]; has_vel: bool tensor;
    pt_pack: [PL, 9] float32 (pos | normal | min_d | max_d | valid);
    pt_desc: [PL, 8] int32 (uint32 bits); pl_pack: None for point-only
    tracking, else the map-plane snapshot [PLANE_CAP, 5] float32
    (world coef | valid), which turns the plane refinement on.

    Returns (frame, out_small [12+PL] int32, out_big [10N] int32), the
    reference's uint32 layouts bit for bit (decode with unpack_track_small /
    unpack_track_big after viewing the host copies as uint32):
      out_small: scal f32[12] = T_cw[0:7], n_seed, n2, n_close_tracked,
                 close_avail, n_fallback (-1 when its gate did not pass);
                 then match_pack i32[PL] = -1 or kp_idx + (inlier << 20).
      out_big:   w0 = u*16 | v*16 << 16; w1 = raw depth | (octave | valid
                 << 7) << 16 | angle/256 << 24; then desc [N, 8].
    """
    vel = se3_compose(T_prev, se3_inverse(T_prev2))
    T_pred = torch.where(has_vel, se3_compose(vel, T_prev), T_prev)
    radius1 = torch.where(has_vel, radius_motion, 2.0 * radius_motion)
    gray = frame_gray.to(torch.float32)
    depth = decode_depth(frame_depth, depth_factor)
    pt_pos = pt_pack[:, 0:3]
    pt_normal = pt_pack[:, 3:6]
    pt_mind = pt_pack[:, 6]
    pt_maxd = pt_pack[:, 7]
    pt_valid = pt_pack[:, 8] > 0.5
    pt_bits = unpack_bits(pt_desc)
    frame = build_frame(gray, depth, spec, intr, n_features=n_features,
                        th_high=th_high, th_low=th_low)
    opt1, _, _ = _match_and_optimize(
        T_pred, pt_pos, pt_normal, pt_mind, pt_maxd, pt_bits, pt_valid,
        frame, radius1, TH_HIGH, intr, n_rounds=2, n_iters=5,
    )
    # window-free global descriptor fallback, computed every frame and
    # selected below (the reference's lax.cond skips it on strong seeds)
    res_fb = match_descriptors(pt_bits, frame.bits, pt_valid, frame.valid,
                               max_dist=TH_LOW, ratio=0.85)
    kp_fb = torch.clamp_min(res_fb.idx, 0).long()
    opt_fb = _compact_pose_opt(
        T_prev, pt_pos, frame.uv[kp_fb],
        torch.where(res_fb.valid, frame.u_right[kp_fb], -1.0),
        octave_inv_sigma2(frame.octave[kp_fb]),
        res_fb.valid, frame.uv.shape[0], intr, 2, 5,
    )
    run_fb = opt1.n_inliers < FALLBACK_SEED_GATE
    T_fb = torch.where(run_fb, opt_fb.T_cw, T_prev)
    n_fb = torch.where(run_fb, opt_fb.n_inliers, -1).to(torch.int32)
    use_mm = opt1.n_inliers >= n_fb
    T_seed = torch.where(use_mm, opt1.T_cw, T_fb)
    n_seed = torch.maximum(opt1.n_inliers, n_fb)
    opt2, match_idx, matched = _match_and_optimize(
        T_seed, pt_pos, pt_normal, pt_mind, pt_maxd, pt_bits, pt_valid,
        frame, radius2, TH_HIGH, intr, n_rounds=4, n_iters=10,
    )
    if pl_pack is not None:
        opt2 = _plane_refine(opt2, frame, depth, frame_gray.shape[0], match_idx, matched,
                             pt_pos, pl_pack, intr, plane_info, plane_assoc_cos,
                             plane_assoc_dist, plane_min_support)
    out_small, out_big = _pack_frame(frame, opt2, match_idx, matched, n_seed, n_fb, th_depth,
                                     depth_factor)
    return frame, out_small, out_big


def _pack_frame(frame: FrameData, opt2, match_idx, matched, n_seed, n_fb, th_depth,
                depth_factor: float):
    """The fused step's two output buffers (track_frame_step's layouts):
    out_small from the tight stage's result (opt2, match_idx, matched), the
    seed stage's inlier counts and the keyframe statistics; out_big, the
    frame's host fields packed so a keyframe download is one transfer (the
    counterpart of the reference's `_pack_frame`, which packs the frame
    only)."""
    kp_idx = torch.clamp_min(match_idx, 0).long()
    kp_depth = frame.depth[kp_idx]
    close = (kp_depth > 1e-3) & (kp_depth < th_depth)
    n_close_tracked = torch.sum(opt2.inliers & close, dtype=torch.int32)
    close_avail = torch.sum(
        frame.valid & (frame.depth > 1e-3) & (frame.depth < th_depth), dtype=torch.int32
    )
    scal = torch.cat([
        opt2.T_cw,
        torch.stack([n_seed, opt2.n_inliers, n_close_tracked, close_avail, n_fb]
                    ).to(torch.float32),
    ])
    match_pack = torch.where(
        matched, kp_idx.to(torch.int32) + torch.where(opt2.inliers, 1 << 20, 0), -1,
    ).to(torch.int32)
    out_small = torch.cat([scal.view(torch.int32), match_pack])

    def q16(x):
        return torch.clamp(torch.round(x * 16.0), 0, 65535).to(torch.int64)

    w0 = q16(frame.uv[:, 0]) | (q16(frame.uv[:, 1]) << 16)
    two_pi = 2.0 * math.pi
    ang_b = torch.remainder(
        torch.round(torch.remainder(frame.angle, two_pi) / two_pi * 256.0).to(torch.int64), 256
    )
    oct_b = (frame.octave.to(torch.int64) & 0x7F) | torch.where(frame.valid, 0x80, 0)
    w1 = (
        torch.clamp(torch.round(frame.depth * depth_factor), 0, 65535).to(torch.int64)
        | (oct_b << 16)
        | (ang_b << 24)
    )
    out_big = torch.cat([to_int32_bits(w0), to_int32_bits(w1), frame.desc.reshape(-1)])
    return out_small, out_big
