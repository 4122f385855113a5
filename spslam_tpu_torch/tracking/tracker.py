"""Per-frame tracking (port of spslam_tpu/tracking/tracker.py).

`track_frame_step` is the whole per-frame device pipeline in one call:
pose prediction from the two previous device-resident poses, frame build,
coarse motion-model match + 2x5 LM, global descriptor fallback, tight
local-map match + 4x10 LM, with planes on: plane segmentation of the depth
upload, association with the map-plane snapshot and a 2x5 joint
point+plane LM, then keyframe statistics and the two packed output
buffers.  It has no `.item()`, no boolean indexing and no data-dependent
Python branch; the one host sync is `torch.linalg.eigh`'s info check in
the plane segmentation (twice per step on CUDA, planes on only).

Divergences from the JAX step, each giving the same outputs:
* the fallback is computed every frame and selected with `torch.where`
  (the reference skips it with `lax.cond` when the motion seed has >= 60
  inliers); a host `if` would sync in the middle of the step;
* LM loops, the joint one too, run their fixed iteration count under an
  `active` mask (solver/pose_opt.py).

The `Tracker` class is the host shell: state machine, keyframe decision
and insertion, the local-map snapshot cache, relocalization against the
loop closer's keyframe database, and the software pipeline
(`process_pipelined`), whose device->host copies go to pinned host tensors
with `non_blocking=True` and are awaited through one CUDA event per
dispatch (on the CPU the same code runs synchronously).  A loop closure
calls `external_pose_correction`, which drops the device pose chain at the
next dispatch; with async mapping the loop closer calls
`correct_map_frame` from the worker instead, and the tracker carries its
pose and the frames in flight with its reference keyframe.

With the span recorder on (`tracing.py`), each dispatch and resolve is a
span (`tracker.dispatch_frame`, `tracker.resolve_frame`), the fused step's
stages are its children (`step.build`, `step.coarse`, `step.fallback`,
`step.tight`, `step.planes`, `step.pack`) and, with `Tracker.perf` on, each
section is one too (`tracker.<section>`).
"""

from __future__ import annotations

import math
import threading
from dataclasses import dataclass
from enum import Enum
from typing import Optional

import numpy as np
import torch

from .. import resolve_device, tracing
from ..frontend.frame import FrameData, build_frame
from ..geometry import np_lie
from ..geometry.camera import Intrinsics, in_image, unproject
from ..geometry.lie import quat_rotate, se3_compose, se3_inverse, se3_q, se3_t
from ..geometry.plane import transform_plane
from ..loop.sim3 import draw_hypotheses, ransac_align
from ..map.store import MapStore
from ..ops.brief import to_int32_bits, unpack_bits
from ..ops.match import TH_HIGH, TH_LOW, match_descriptors, search_by_projection
from ..ops.plane_seg import segment_planes
from ..ops.pyramid import PyramidSpec
from ..solver.pose_opt import pose_optimization, pose_optimization_joint
from ..solver.robust import octave_inv_sigma2


class TrackState(Enum):
    NOT_INITIALIZED = 0
    OK = 1
    LOST = 2


@dataclass(frozen=True)
class TrackerConfig:
    """Same fields and defaults as the reference's TrackerConfig."""

    n_features: int = 1024
    n_levels: int = 8
    scale_factor: float = 1.2
    th_fast_high: float = 20.0
    th_fast_low: float = 7.0
    th_depth: float = 3.2          # meters: close/far split
    local_points_cap: int = 4096   # padded local-map snapshot size
    motion_search_radius: float = 22.0
    local_search_radius: float = 6.0
    min_inliers_motion: int = 20
    min_inliers_track: int = 30
    kf_max_interval: int = 30
    kf_min_interval: int = 1
    kf_tracked_ratio: float = 0.75
    kf_min_inliers: int = 15
    new_kf_close_points: int = 100
    max_new_points_per_kf: int = 360
    # pose-jump gate against the constant-velocity prediction
    jump_gate_t: float = 0.25
    jump_gate_r: float = 0.35
    kf_queue_cap: int = 3
    # in-flight fused dispatches before the oldest resolves (System caps
    # it at 2 with planes on)
    pipeline_depth: int = 3
    # tracking-level plane refinement (read when the Tracker's use_planes
    # is set): information base per plane, scaled by its pixel support,
    # and the association gates at the point-stage pose
    plane_info: float = 1e5
    plane_assoc_cos: float = 0.94
    plane_assoc_dist: float = 0.2
    plane_min_support: int = 300   # pixels at the depth upload resolution
    # depth upload stride (keypoint depth lookup lands <= 1 px off at full res)
    depth_upload_stride: int = 2
    # urgent keyframe when the inlier count projected pipeline_depth frames
    # ahead falls below this
    kf_urgent_cover: int = 100


@dataclass
class FrameRecord:
    """Resolved per-frame result handed back to the System."""
    ts: float
    T: np.ndarray          # T_cw at resolution time
    state: "TrackState"
    ref_kf: int            # reference keyframe at resolution time
    new_kf: int            # keyframe id created for this frame, or -1
    gray: np.ndarray
    depth: np.ndarray


# Frustum-gate slacks (the reference's IsInFrustum uses 0.8 / 1.2)
DIST_SLACK_LO = 0.8
DIST_SLACK_HI = 1.2
OCTAVE_SLACK = 1  # +- pyramid levels around the predicted octave

# the global fallback's result only counts when the motion-model stage
# tracked fewer inliers than this
FALLBACK_SEED_GATE = 60

# deferred map-point statistics are applied at keyframe churn or after this
# many ordinary frames, whichever comes first
STATS_FLUSH_FRAMES = 8

# rows of the map-plane snapshot (top planes by support), a fixed shape
PLANE_CAP = 64


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
    with tracing.span("step.build"):
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
    with tracing.span("step.coarse"):
        opt1, _, _ = _match_and_optimize(
            T_pred, pt_pos, pt_normal, pt_mind, pt_maxd, pt_bits, pt_valid,
            frame, radius1, TH_HIGH, intr, n_rounds=2, n_iters=5,
        )
    # window-free global descriptor fallback, computed every frame and
    # selected below (the reference's lax.cond skips it on strong seeds)
    with tracing.span("step.fallback"):
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
    with tracing.span("step.tight"):
        opt2, match_idx, matched = _match_and_optimize(
            T_seed, pt_pos, pt_normal, pt_mind, pt_maxd, pt_bits, pt_valid,
            frame, radius2, TH_HIGH, intr, n_rounds=4, n_iters=10,
        )
    if pl_pack is not None:
        with tracing.span("step.planes"):
            opt2 = _plane_refine(opt2, frame, depth, frame_gray.shape[0], match_idx, matched,
                                 pt_pos, pl_pack, intr, plane_info, plane_assoc_cos,
                                 plane_assoc_dist, plane_min_support)
    with tracing.span("step.pack"):
        out_small, out_big = _pack_frame(frame, opt2, match_idx, matched, n_seed, n_fb,
                                         th_depth, depth_factor)
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


def unpack_track_small(buf: np.ndarray, n_local: int):
    """Host decode of track_frame_step's small buffer (uint32 view):
    returns (scal f32[12], match_pack i32[PL])."""
    if buf.size != 12 + n_local:
        raise ValueError(
            f"track_frame_step small-output layout mismatch: buffer has "
            f"{buf.size} words, expected 12 + {n_local}"
        )
    return buf[:12].view(np.float32), buf[12:12 + n_local].view(np.int32)


def unpack_track_big(buf: np.ndarray, n_kp: int, intr: Intrinsics,
                     depth_factor: float) -> dict:
    """Host decode of the compact keyframe bundle (uint32 view) into the
    keyframe-insertion dict; u_right and xyz_cam are recomputed from the
    dequantized uv + depth."""
    if buf.size != 10 * n_kp:
        raise ValueError(
            f"track_frame_step big-output layout mismatch: buffer has "
            f"{buf.size} words, expected 10*{n_kp}"
        )
    w0 = buf[:n_kp]
    w1 = buf[n_kp : 2 * n_kp]
    desc = buf[2 * n_kp :].reshape(n_kp, 8)
    u = (w0 & 0xFFFF).astype(np.float32) / 16.0
    v = (w0 >> 16).astype(np.float32) / 16.0
    depth = (w1 & 0xFFFF).astype(np.float32) / depth_factor
    octave = ((w1 >> 16) & 0x7F).astype(np.int32)
    valid = ((w1 >> 16) & 0x80) > 0
    angle = ((w1 >> 24) & 0xFF).astype(np.float32) * (2.0 * np.pi / 256.0)
    has_d = depth > 1e-6
    ur = np.where(has_d, u - intr.bf / np.maximum(depth, 1e-6), -1.0).astype(np.float32)
    x = (u - intr.cx) / intr.fx * depth
    y = (v - intr.cy) / intr.fy * depth
    return dict(
        uv=np.stack([u, v], -1), octave=octave, angle=angle, depth=depth,
        u_right=ur, valid=valid,
        xyz_cam=np.stack([x, y, depth], -1).astype(np.float32), desc=desc,
    )


def frame_to_numpy(frame: FrameData) -> dict:
    """The host fields of a FrameData as numpy (descriptors as uint32)."""
    return dict(
        uv=frame.uv.cpu().numpy(),
        octave=frame.octave.cpu().numpy().astype(np.int32),
        angle=frame.angle.cpu().numpy(),
        depth=frame.depth.cpu().numpy(),
        u_right=frame.u_right.cpu().numpy(),
        valid=frame.valid.cpu().numpy(),
        xyz_cam=frame.xyz_cam.cpu().numpy(),
        desc=frame.desc.cpu().numpy().view(np.uint32),
    )


def _to_host_async(t: torch.Tensor) -> torch.Tensor:
    """Start a device->host copy into pinned memory (no-op on the CPU)."""
    if t.device.type != "cuda":
        return t
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t, non_blocking=True)
    return host


class Tracker:
    def __init__(self, cfg: TrackerConfig, intr: Intrinsics, store: MapStore, device=None):
        self.cfg = cfg
        self.intr = intr
        self.store = store
        self.device = resolve_device(device)
        self.spec = PyramidSpec(n_levels=cfg.n_levels, scale_factor=cfg.scale_factor,
                                height=intr.height, width=intr.width)
        self.state = TrackState.NOT_INITIALIZED
        self.T_cw = np.array([1, 0, 0, 0, 0, 0, 0], np.float32)
        self.velocity: Optional[np.ndarray] = None
        self.ref_kf: int = -1
        self.last_kf: int = -1
        self.frames_since_kf = 0
        self.frame_id = 0
        self.last_inliers = 0
        self.metrics = []
        # (Vocabulary, KeyFrameDatabase) of the loop closer, set by System
        # (enable_reloc or use_loop); None means LOST frames stay LOST until
        # tracking recovers on its own
        self.relocalizer = None
        # hypothesis draw of the relocalization RANSAC: (valid [N] numpy) ->
        # [256, 3] indices; an explicit generator seeded 23 where the
        # reference splits PRNGKey(23); a test may replace it
        self._reloc_gen = torch.Generator().manual_seed(23)
        self.reloc_draw = lambda valid: draw_hypotheses(valid, self._reloc_gen)
        # () -> queued + in-flight keyframes of the async mapper (System sets
        # it with async_mapping); None means mapping is synchronous
        self.mapper_queue_fn = None
        # set (possibly from another thread) when a loop closure rewrote the
        # current pose: the next dispatch rebuilds the device pose chain
        self._pose_corrected = threading.Event()
        # a map correction published by the async worker (correct_map_frame)
        # and not yet applied: T_cw <- T_cw . D
        self._correction = None
        self._corr_lock = threading.Lock()
        self.pipeline_depth = cfg.pipeline_depth
        self._pending: list[dict] = []
        self._chain = None                         # (T_N, T_{N-1}) device poses
        self._hv = (torch.tensor(False, device=self.device),
                    torch.tensor(True, device=self.device))
        self.jump_gate_t = cfg.jump_gate_t
        self.jump_gate_r = cfg.jump_gate_r
        # raw-depth divisor, applied on device when integer depth is fed
        self.depth_factor = 5000.0
        self.n_fused = 0                           # frames through track_frame_step
        # plane refinement in the fused step against a snapshot of the top
        # PLANE_CAP map planes (System sets it with use_planes)
        self.use_planes = False
        self._snapshot_cache = None
        self._ref_tracked_cache = None
        # deferred map-point statistics (ids_seen, ids_found) per frame
        self._stat_batch: list[tuple[np.ndarray, np.ndarray]] = []
        # per-section host-time accounting (tools/profile_host.py, see _pt):
        # None = off, a dict turns it on
        self.perf: Optional[dict] = None

    def _pt(self, key: str, t0: tuple) -> tuple:
        """Add the host seconds since t0 (a `tracing.stamp()`) to section
        `key` of self.perf and return the current stamp; with the span
        recorder on, the same two clock readings also record the section
        as the span `tracker.<key>`, with the thread's CPU time in it.

        The sections of the pipelined path, summed over frames: upload,
        snapshot and dispatch in _dispatch; wait_small, decode, need_kf,
        kf_fetch, kf_insert and stats_flush in _resolve, with n_frames
        counting the frames resolved from the fused step (under
        process_pipelined a frame's sections fall in later calls).  On the
        card `upload` times the enqueue of the copies and `dispatch` the
        kernel launches; the device's time shows up in `wait_small`, the
        wait for the frame's small output, as with the reference's async
        dispatch.  With perf None each section costs one `is not None`
        test and no sync is added."""
        t1 = tracing.stamp()
        self.perf[key] = self.perf.get(key, 0.0) + (t1[0] - t0[0]) * 1e-9
        tracing.section("tracker." + key, t0, t1)
        return t1

    def _flush_stats(self):
        """Apply the deferred map-point statistics in one batch."""
        if not self._stat_batch:
            return
        batch, self._stat_batch = self._stat_batch, []
        mp = np.concatenate([b[0] for b in batch])
        mids = np.concatenate([b[1] for b in batch])
        seen = mids[mp >= 0]
        seen = seen[seen >= 0]
        found = mids[mp >= (1 << 20)]
        found = found[found >= 0]
        with self.store.lock:
            np.add.at(self.store.pt_visible, seen, 1)
            np.add.at(self.store.pt_found, found, 1)

    def external_pose_correction(self, T_cw: np.ndarray):
        """A loop closure rewrote the current pose: reset the motion model
        and the device prediction chain."""
        self.T_cw = np.asarray(T_cw, np.float32).copy()
        self.velocity = None
        self._pose_corrected.set()

    def correct_map_frame(self, old_poses: np.ndarray, new_poses: np.ndarray, kf: int):
        """The loop closer moved the keyframes from old_poses to new_poses
        (from the mapping or gba thread, under the store's lock).  Publish
        the move of the reference keyframe (kf if that is gone) for the
        tracker's thread, which applies it at its next step:
        T_cw <- T_cw . T_ref_old^-1 . T_ref_new, the same for each frame
        in flight.  The velocity, a relative motion, stays."""
        ref = self.ref_kf if self.ref_kf >= 0 and self.store.kf_valid[self.ref_kf] else kf
        D = np_lie.se3_compose(np_lie.se3_inverse(old_poses[ref]), new_poses[ref])
        with self._corr_lock:
            self._correction = D if self._correction is None else np_lie.se3_compose(
                self._correction, D)

    def _take_correction(self, current: dict | None = None):
        """Apply a published map correction to the pose, the frames in
        flight (and `current`, popped for resolving) and the device chain."""
        if self._correction is None:
            return
        with self._corr_lock:
            D, self._correction = self._correction, None
        self.T_cw = np_lie.se3_compose(self.T_cw, D).astype(np.float32)
        for q in self._pending + ([current] if current is not None else []):
            q["corr"] = D if q.get("corr") is None else np_lie.se3_compose(q["corr"], D)
        self._chain = None

    # -----------------------------------------------------------------
    def _depth_meters(self, depth: np.ndarray) -> torch.Tensor:
        d = np.ascontiguousarray(depth)
        if d.dtype == np.uint16:
            d = d.view(np.int16)   # raw u16 units travel as int16 bits
        elif d.dtype.kind in "iu":
            d = d.astype(np.int32)
        return decode_depth(torch.from_numpy(d).to(self.device), self.depth_factor)

    def process(self, gray: np.ndarray, depth: np.ndarray, ts: float):
        """Track one RGB-D frame synchronously; returns (T_cw [7], state)."""
        self._take_correction()
        gray_t = torch.from_numpy(np.ascontiguousarray(gray)).to(self.device)
        frame = build_frame(
            gray_t.to(torch.float32), self._depth_meters(depth), self.spec, self.intr,
            n_features=self.cfg.n_features,
            th_high=self.cfg.th_fast_high, th_low=self.cfg.th_fast_low,
        )
        if self.state == TrackState.NOT_INITIALIZED:
            self._initialize(frame, ts)
        else:
            self._track(frame, ts)
        self.frame_id += 1
        return self.T_cw.copy(), self.state

    def _upload_frame(self, gray: np.ndarray, depth: np.ndarray):
        """Upload gray as uint8 and depth as raw uint16 units (carried as
        int16 bits, decoded on device), depth at cfg.depth_upload_stride."""
        g = gray if gray.dtype == np.uint8 else np.clip(gray, 0, 255).astype(np.uint8)
        d = (
            depth if depth.dtype == np.uint16
            else np.clip(depth * self.depth_factor, 0, 65535).astype(np.uint16)
        )
        s = self.cfg.depth_upload_stride
        if s > 1:
            d = d[::s, ::s]
        g_t = torch.from_numpy(np.ascontiguousarray(g)).to(self.device, non_blocking=True)
        d_t = torch.from_numpy(np.ascontiguousarray(d).view(np.int16)).to(
            self.device, non_blocking=True)
        return g_t, d_t

    def _dispatch(self, gray: np.ndarray, depth: np.ndarray, ts: float) -> dict:
        """Launch the fused step for one frame without waiting for it; the
        device->host copies of its outputs start right away."""
        cfg = self.cfg
        perf = self.perf
        if perf is not None:
            t = tracing.stamp()
        gray_t, depth_t = self._upload_frame(gray, depth)
        if perf is not None:
            t = self._pt("upload", t)
        self._take_correction()
        ids, pack, desc, pl_pack = self._local_snapshot()
        if perf is not None:
            t = self._pt("snapshot", t)
        if self._pose_corrected.is_set():
            self._chain = None
            self._pose_corrected.clear()
        if self._chain is not None:
            T_prev, T_prev2, has_vel = self._chain[0], self._chain[1], True
        elif self.velocity is not None:
            # re-prime the chain from host state: advance the constant-
            # velocity model over the frames still in flight
            Tp = self.T_cw
            for _ in range(len(self._pending)):
                Tp = np_lie.se3_compose(self.velocity, Tp)
            T_prev = torch.tensor(Tp, device=self.device)
            T_prev2 = torch.tensor(
                np_lie.se3_compose(np_lie.se3_inverse(self.velocity), Tp), device=self.device
            )
            has_vel = True
        else:
            T_prev = T_prev2 = torch.tensor(self.T_cw, device=self.device)
            has_vel = False
        frame, out_small, out_big = track_frame_step(
            gray_t, depth_t, T_prev, T_prev2, self._hv[int(has_vel)], pack, desc,
            cfg.motion_search_radius, cfg.local_search_radius, cfg.th_depth,
            self.spec, self.intr, cfg.n_features, cfg.th_fast_high, cfg.th_fast_low,
            depth_factor=self.depth_factor, pl_pack=pl_pack,
            plane_info=cfg.plane_info, plane_assoc_cos=cfg.plane_assoc_cos,
            plane_assoc_dist=cfg.plane_assoc_dist, plane_min_support=cfg.plane_min_support,
        )
        self.n_fused += 1
        T_new = out_small[0:7].view(torch.float32)
        host_small = _to_host_async(out_small)
        host_big = _to_host_async(out_big)
        event = None
        if out_small.device.type == "cuda":
            event = torch.cuda.Event()
            event.record()
        self._chain = (T_new, T_prev)
        if perf is not None:
            self._pt("dispatch", t)
        p = dict(frame=frame, out=host_small, out_big=host_big, event=event, ids=ids,
                 ts=ts, gray=gray, depth=depth, frame_id=self.frame_id, force_robust=False)
        self.frame_id += 1
        return p

    def _record(self, p: dict, prev_kf: int) -> FrameRecord:
        return FrameRecord(
            ts=p["ts"], T=self.T_cw.copy(), state=self.state, ref_kf=self.ref_kf,
            new_kf=self.last_kf if self.last_kf != prev_kf else -1,
            gray=p["gray"], depth=p["depth"],
        )

    def _resolve(self, p: dict) -> FrameRecord:
        """Host-process one dispatched frame: pose/velocity update, map-point
        statistics, keyframe decision/insertion; replays the frame through
        the robust sync path on tracking anomalies."""
        cfg = self.cfg
        frame = p["frame"]
        prev_kf = self.last_kf
        fid_after = self.frame_id
        self.frame_id = p["frame_id"]
        perf = self.perf
        if perf is not None:
            t = tracing.stamp()
        if p["event"] is not None:
            p["event"].synchronize()
        self._take_correction(p)
        if p["force_robust"]:
            # an earlier frame failed after this one was dispatched from its
            # bad pose; rerun matching + optimization from the corrected pose
            self._chain = None
            self._track(frame, p["ts"])
            self.frame_id = fid_after
            return self._record(p, prev_kf)
        buf = p["out"].numpy().view(np.uint32)
        if perf is not None:
            t = self._pt("wait_small", t)
        scal, mp = unpack_track_small(buf, cfg.local_points_cap)
        T_new = scal[0:7]
        if p.get("corr") is not None:
            # dispatched before a map correction: carry its pose along
            T_new = np_lie.se3_compose(T_new, p["corr"])
        n1, n2 = int(scal[7]), int(scal[8])
        n_close_tracked, close_avail = int(scal[9]), int(scal[10])
        # pose-jump gate against the constant-velocity prediction
        jumped = False
        if self.velocity is not None:
            T_pred_h = np_lie.se3_compose(self.velocity, self.T_cw)
            dT = np_lie.se3_compose(T_new, np_lie.se3_inverse(T_pred_h))
            jump_t = float(np.linalg.norm(dT[4:7]))
            jump_r = 2.0 * float(np.arccos(np.clip(abs(dT[0]), 0.0, 1.0)))
            jumped = jump_t > self.jump_gate_t or jump_r > self.jump_gate_r
        if jumped or n1 < cfg.min_inliers_motion or n2 < cfg.kf_min_inliers:
            for q in self._pending:
                q["force_robust"] = True
            self._chain = None
            self._track(frame, p["ts"])
            self.frame_id = fid_after
            return self._record(p, prev_kf)

        self.velocity = np_lie.se3_compose(T_new, np_lie.se3_inverse(self.T_cw))
        self.T_cw = np.array(T_new)
        self.state = TrackState.OK
        self.frames_since_kf += 1
        n2_prev = self.last_inliers
        self.last_inliers = n2
        mids = np.asarray(p["ids"])
        self._stat_batch.append((mp, mids))
        if perf is not None:
            t = self._pt("decode", t)

        need_kf = self._need_new_kf(n2, n_close_tracked, close_avail, n2_prev=n2_prev)
        if perf is not None:
            t = self._pt("need_kf", t)
        if need_kf:
            self._flush_stats()
            matched = mp >= 0
            match_idx = np.where(matched, mp & ((1 << 20) - 1), -1)
            inl = mp >= (1 << 20)
            frame_np = unpack_track_big(
                p["out_big"].numpy().view(np.uint32), cfg.n_features, self.intr,
                self.depth_factor,
            )
            if perf is not None:
                t = self._pt("kf_fetch", t)
            kf = self._insert_keyframe(
                frame, p["ts"], matches_pt_ids=np.where(inl, mids, -1),
                match_kp_idx=match_idx, frame_np=frame_np,
            )
            self.ref_kf = kf
            self.last_kf = kf
            self.frames_since_kf = 0
            if perf is not None:
                t = self._pt("kf_insert", t)
        elif len(self._stat_batch) >= STATS_FLUSH_FRAMES:
            self._flush_stats()
            if perf is not None:
                t = self._pt("stats_flush", t)
        self.metrics.append(dict(frame=p["frame_id"], state="OK", inliers=n2, kf=int(need_kf)))
        if perf is not None:
            perf["n_frames"] = perf.get("n_frames", 0) + 1
        self.frame_id = fid_after
        return FrameRecord(
            ts=p["ts"], T=self.T_cw.copy(), state=self.state, ref_kf=self.ref_kf,
            new_kf=self.last_kf if need_kf else -1, gray=p["gray"], depth=p["depth"],
        )

    def process_pipelined(self, gray: np.ndarray, depth: np.ndarray, ts: float):
        """Dispatch frame N, then resolve frame N - pipeline_depth.  Returns
        the FrameRecords resolved during this call, in frame order."""
        records = []
        if self.state in (TrackState.NOT_INITIALIZED, TrackState.LOST):
            records.extend(self.flush_pipeline())
            if self.state in (TrackState.NOT_INITIALIZED, TrackState.LOST):
                prev_kf = self.last_kf
                T, state = self.process(gray, depth, ts)
                self._chain = None
                records.append(FrameRecord(
                    ts=ts, T=T, state=state, ref_kf=self.ref_kf,
                    new_kf=self.last_kf if self.last_kf != prev_kf else -1,
                    gray=gray, depth=depth,
                ))
                return records
        with tracing.span("tracker.dispatch_frame"):
            p = self._dispatch(gray, depth, ts)
        self._pending.append(p)
        while len(self._pending) > self.pipeline_depth:
            records.append(self._resolve_next())
        return records

    def flush_pipeline(self):
        """Resolve all in-flight frames."""
        records = []
        while self._pending:
            records.append(self._resolve_next())
        self._flush_stats()
        return records

    def _resolve_next(self) -> FrameRecord:
        """Resolve the oldest in-flight frame."""
        with tracing.span("tracker.resolve_frame"):
            return self._resolve(self._pending.pop(0))

    # -----------------------------------------------------------------
    def _initialize(self, frame: FrameData, ts: float):
        n_depth = int(torch.sum(frame.has_depth))
        if n_depth < 100:
            return  # wait for a frame with enough depth
        self.T_cw = np.array([1, 0, 0, 0, 0, 0, 0], np.float32)
        # a map point for EVERY depth-backed keypoint (StereoInitialization)
        kf = self._insert_keyframe(frame, ts, matches_pt_ids=None, match_kp_idx=None,
                                   unlimited=True)
        self.ref_kf = kf
        self.last_kf = kf
        self.state = TrackState.OK
        self.frames_since_kf = 0
        self.last_inliers = n_depth

    # -----------------------------------------------------------------
    def _local_snapshot(self):
        """(ids [PL], pack [PL,9], desc [PL,8] int32, pl_pack) of the local
        map around ref_kf on the device; pl_pack is the map-plane snapshot
        [PLANE_CAP, 5] with planes on, else None.  The point-set selection
        depends only on map topology (store.topo_version); value-only
        updates (store.version, which every plane writer bumps) re-gather
        the same rows."""
        st = self.store
        key_topo = (st.topo_version, self.ref_kf)
        cached = self._snapshot_cache
        if cached is not None and cached[0] == key_topo:
            if cached[1] == st.version:
                return cached[2]
            with st.lock:
                ids = cached[2][0]
                snap = (ids, *self._snapshot_gather(ids, desc_cached=cached[2][2]))
                ver = st.version
            self._snapshot_cache = (key_topo, ver, snap)
            return snap
        with st.lock:
            snap = self._local_snapshot_build()
            self._snapshot_cache = (key_topo, st.version, snap)
        return snap

    def refresh_snapshot_values(self):
        """Bring the local-map snapshot cache up to the current store, from
        the async mapper's thread after its write-back, so the tracker's
        next dispatch does not pay the gather.  The cache tuple is replaced
        whole, so a concurrent move of ref_kf only makes this a no-op."""
        with tracing.span("tracker.refresh_snapshot"):
            st = self.store
            cached = self._snapshot_cache
            if cached is None:
                return
            if cached[0] != (st.topo_version, self.ref_kf):
                with st.lock:
                    key_topo = (st.topo_version, self.ref_kf)
                    snap = self._local_snapshot_build()
                    self._snapshot_cache = (key_topo, st.version, snap)
                return
            if cached[1] == st.version:
                return
            with st.lock:
                ids = cached[2][0]
                snap = (ids, *self._snapshot_gather(ids, desc_cached=cached[2][2]))
                ver = st.version
            self._snapshot_cache = (cached[0], ver, snap)

    def _snapshot_gather(self, ids: np.ndarray, desc_cached=None):
        """Upload pack (+ desc unless the cached device copy is passed: for
        a fixed id set descriptors change only by the distinctive-descriptor
        refresh, a topology change re-uploads them) and, with planes on, the
        top PLANE_CAP valid map planes by support."""
        st = self.store
        sel = np.maximum(ids, 0)
        pack_np = np.concatenate(
            [
                st.pt_pos[sel],
                st.pt_normal[sel],
                st.pt_min_dist[sel][:, None],
                st.pt_max_dist[sel][:, None],
                ((ids >= 0) & st.pt_valid[sel]).astype(np.float32)[:, None],
            ],
            axis=-1,
        ).astype(np.float32)
        desc = (
            desc_cached if desc_cached is not None
            else torch.from_numpy(st.pt_desc[sel].view(np.int32)).to(self.device)
        )
        pl_pack = None
        if self.use_planes:
            pl_np = np.zeros((PLANE_CAP, 5), np.float32)
            pls = np.nonzero(st.pl_valid)[0]
            if len(pls) > PLANE_CAP:
                pls = pls[np.argsort(-st.pl_n_pts[pls], kind="stable")[:PLANE_CAP]]
            pl_np[: len(pls), 0:4] = st.pl_coef[pls]
            pl_np[: len(pls), 4] = 1.0
            pl_pack = torch.from_numpy(pl_np).to(self.device)
        return torch.from_numpy(pack_np).to(self.device), desc, pl_pack

    def _local_snapshot_build(self):
        st = self.store
        kfs = st.local_keyframes(self.ref_kf, min_weight=5)
        pts = st.local_points(kfs)
        cap = self.cfg.local_points_cap
        if len(pts) > cap:
            # keep points seen by the newest keyframes first
            newest_obs = st.pt_obs_kf[pts].max(axis=1)
            order = np.argsort(
                -(newest_obs.astype(np.int64) * 64 + np.minimum(st.pt_n_obs[pts], 63)),
                kind="stable",
            )
            pts = pts[order[:cap]]
        pad = cap - len(pts)
        ids = np.concatenate([pts, np.full(pad, -1, np.int32)])
        return (ids, *self._snapshot_gather(ids))

    def _track(self, frame: FrameData, ts: float):
        """Robust synchronous tracking of an already-built frame."""
        cfg = self.cfg
        ids, pack, desc, _ = self._local_snapshot()
        pos, normal = pack[:, 0:3], pack[:, 3:6]
        mind, maxd = pack[:, 6], pack[:, 7]
        valid = pack[:, 8] > 0.5
        bits = unpack_bits(desc)

        # --- step 1: motion model (or last pose) coarse alignment ---------
        if self.velocity is not None:
            T_pred = np_lie.se3_compose(self.velocity, self.T_cw)
            radius1 = cfg.motion_search_radius
        else:
            T_pred = self.T_cw
            radius1 = 2.0 * cfg.motion_search_radius
        opt, _, _ = _match_and_optimize(
            torch.tensor(T_pred, dtype=torch.float32, device=self.device),
            pos, normal, mind, maxd, bits, valid, frame, radius1, TH_HIGH, self.intr,
        )
        n1 = int(opt.n_inliers)
        if n1 >= cfg.min_inliers_motion:
            T_cur = opt.T_cw
        else:
            # --- fallback: global descriptor match against the local map --
            res = match_descriptors(bits, frame.bits, valid, frame.valid,
                                    max_dist=TH_LOW, ratio=0.85)
            kp_idx = torch.clamp_min(res.idx, 0).long()
            opt_fb = _compact_pose_opt(
                torch.tensor(self.T_cw, device=self.device), pos, frame.uv[kp_idx],
                torch.where(res.valid, frame.u_right[kp_idx], -1.0),
                octave_inv_sigma2(frame.octave[kp_idx]),
                res.valid, cfg.n_features, self.intr, 4, 10,
            )
            if int(opt_fb.n_inliers) < cfg.kf_min_inliers:
                T_reloc = self._relocalize(frame)
                if T_reloc is None:
                    self.state = TrackState.LOST
                    self.velocity = None
                    self.metrics.append(dict(frame=self.frame_id, state="LOST", inliers=0))
                    return
                T_cur = torch.tensor(T_reloc, device=self.device)
            else:
                T_cur = opt_fb.T_cw

        # --- step 2: track local map (tight radius) -----------------------
        opt2, match_idx, matched = _match_and_optimize(
            T_cur, pos, normal, mind, maxd, bits, valid, frame,
            cfg.local_search_radius, TH_HIGH, self.intr,
        )
        n2 = int(opt2.n_inliers)
        if n2 < cfg.kf_min_inliers:
            self.state = TrackState.LOST
            self.velocity = None
            self.metrics.append(dict(frame=self.frame_id, state="LOST", inliers=n2))
            return

        T_new = opt2.T_cw.cpu().numpy()
        self.velocity = np_lie.se3_compose(T_new, np_lie.se3_inverse(self.T_cw))
        self.T_cw = T_new
        self.state = TrackState.OK
        self.frames_since_kf += 1
        n2_prev = self.last_inliers
        self.last_inliers = n2

        inl = opt2.inliers.cpu().numpy()
        match_idx = match_idx.cpu().numpy()
        mids = np.asarray(ids)
        seen = mids[matched.cpu().numpy()]
        found = mids[inl]
        with self.store.lock:
            self.store.pt_visible[seen[seen >= 0]] += 1
            self.store.pt_found[found[found >= 0]] += 1

        # --- step 3: keyframe decision ------------------------------------
        frame_np = frame_to_numpy(frame)
        d_inl = frame_np["depth"][match_idx[inl]]
        n_close_tracked = int(np.sum((d_inl > 0) & (d_inl < cfg.th_depth)))
        close_avail = int(np.sum(
            (frame_np["depth"] > 0) & (frame_np["depth"] < cfg.th_depth) & frame_np["valid"]
        ))
        need_kf = self._need_new_kf(n2, n_close_tracked, close_avail, n2_prev=n2_prev)
        if need_kf:
            kf = self._insert_keyframe(
                frame, ts, matches_pt_ids=np.where(inl, mids, -1),
                match_kp_idx=match_idx, frame_np=frame_np,
            )
            self.ref_kf = kf
            self.last_kf = kf
            self.frames_since_kf = 0
        self.metrics.append(dict(frame=self.frame_id, state="OK", inliers=n2, kf=int(need_kf)))

    # -----------------------------------------------------------------
    def _need_new_kf(self, n2: int, n_close_tracked: int, close_avail: int,
                     n2_prev: int | None = None) -> bool:
        """The reference's Tracking::NeedNewKeyFrame (RGB-D) gates, with the
        inlier count extrapolated over the frames in flight."""
        cfg = self.cfg
        st = self.store
        key = (self.ref_kf, st.topo_version)
        cached = self._ref_tracked_cache
        if cached is not None and cached[0] == key:
            ref_tracked = cached[1]
        else:
            min_obs = 3 if int(st.kf_valid.sum()) > 2 else 2
            ref_pts = st.kf_obs[self.ref_kf]
            ref_pts = ref_pts[ref_pts >= 0]
            # RGB-D observations count double (MapPoint::AddObservation)
            obs_kf = st.pt_obs_kf[ref_pts]
            obs_slot = st.pt_obs_slot[ref_pts]
            has = obs_kf >= 0
            stereo = has & (st.kf_ur[np.maximum(obs_kf, 0), np.maximum(obs_slot, 0)] >= 0)
            n_obs_w = (has.astype(np.int32) + stereo.astype(np.int32)).sum(axis=1)
            ref_tracked = int(np.sum(n_obs_w >= min_obs))
            self._ref_tracked_cache = (key, ref_tracked)
        need_close = (
            n_close_tracked < cfg.new_kf_close_points
            and close_avail - n_close_tracked > 70
        )
        n2_proj = n2
        if n2_prev is not None and n2 < n2_prev:
            n2_proj = n2 + self.pipeline_depth * (n2 - n2_prev)
        urgent = n2_proj < cfg.kf_urgent_cover
        weak = n2 < 0.25 * ref_tracked
        queue_len = 0 if self.mapper_queue_fn is None else self.mapper_queue_fn()
        mapper_idle = queue_len == 0
        # c1a (max interval) | c1b (min interval + mapper idle) | c1c (weak
        # tracking / urgent close points), all under c2
        c1a = self.frames_since_kf >= cfg.kf_max_interval
        c1b = self.frames_since_kf >= cfg.kf_min_interval and mapper_idle
        c1c = weak or need_close or urgent
        # with async mapping an urgent keyframe skips the ratio to the
        # reference keyframe: the worker adds the observations that make
        # its young points count only later, and after a weak frame the
        # ratio stays out of reach while the view turns off the map
        c2 = (
            (n2 < cfg.kf_tracked_ratio * ref_tracked or need_close
             or (urgent and self.mapper_queue_fn is not None))
            and n2 > cfg.kf_min_inliers
        )
        if not (c1a or ((c1b or c1c) and c2)):
            return False
        # with a busy mapper, insert while its queue is short (RGB-D), or
        # when due or urgent: the keyframe itself extends the local map
        return mapper_idle or queue_len < cfg.kf_queue_cap or c1a or urgent

    def _relocalize(self, frame: FrameData):
        """Global relocalization against the keyframe database: BoW
        candidates, then descriptor matching (rotation-checked) and 3D-3D
        Horn RANSAC per candidate (RGB-D has depth on both sides, so Horn
        takes the role of the reference's EPnP).  Returns T_cw or None."""
        if self.relocalizer is None:
            return None
        vocab, kfdb = self.relocalizer
        if not vocab.trained:
            return None
        st = self.store
        dev = self.device
        valid = frame.valid.cpu().numpy()
        bow = vocab.bow_vector(frame.desc.cpu().numpy().view(np.uint32)[valid])
        cands = kfdb.query(bow, exclude=set(), min_score=0.01, max_results=5)
        for cand, _score in cands:
            if not st.kf_valid[cand]:
                continue
            bits_b = unpack_bits(torch.from_numpy(st.kf_desc[cand].view(np.int32)).to(dev))
            valid_b = torch.from_numpy(st.kf_kp_valid[cand] & (st.kf_depth[cand] > 1e-3)).to(dev)
            res = match_descriptors(
                frame.bits, bits_b, frame.valid & frame.has_depth, valid_b,
                frame.angle, torch.from_numpy(st.kf_angle[cand]).to(dev),
                max_dist=64.0, ratio=0.85,
            )
            m = res.valid.cpu().numpy()
            if m.sum() < 20:
                continue
            idx = np.maximum(res.idx.cpu().numpy(), 0)
            pb = unproject(self.intr, torch.from_numpy(st.kf_uv[cand][idx]).to(dev),
                           torch.from_numpy(st.kf_depth[cand][idx]).to(dev))
            align = ransac_align(frame.xyz_cam, pb, res.valid, self.reloc_draw(m))
            if int(align.n_inliers) < 20:
                continue
            # x_cand = T_ba x_frame  =>  T_cw_frame = T_ba^{-1} . T_cw_cand
            T_cw = np_lie.se3_compose(np_lie.se3_inverse(align.T_ba.cpu().numpy()),
                                      st.kf_pose[cand])
            self.ref_kf = int(cand)
            self.metrics.append(dict(frame=self.frame_id, state="RELOC", cand=int(cand)))
            return T_cw
        return None

    def _insert_keyframe(self, frame: FrameData, ts, matches_pt_ids, match_kp_idx,
                         frame_np=None, unlimited: bool = False) -> int:
        """Create a keyframe: bind tracked points to kp slots, then create new
        map points from depth-backed unmatched keypoints, nearest first.  The
        whole insertion holds the store's lock, so a map correction lands
        wholly before it (and moves T_cw here first) or after it."""
        st = self.store
        frame_np = frame_np or frame_to_numpy(frame)
        with st.lock:
            self._take_correction()
            kf = st.add_keyframe(self.T_cw, ts, frame_np, self.frame_id, parent=self.ref_kf)

            taken = np.zeros(self.cfg.n_features, bool)
            if matches_pt_ids is not None:
                sel = (matches_pt_ids >= 0) & (match_kp_idx >= 0)
                kps = match_kp_idx[sel]
                pids = matches_pt_ids[sel]
                uniq, first = np.unique(kps, return_index=True)
                st.add_observations_bulk(pids[first], kf, uniq)
                taken[uniq] = True

            d = frame_np["depth"]
            cand = np.nonzero(
                frame_np["valid"] & ~taken & (d > 1e-3) & (d < self.cfg.th_depth * 2)
            )[0]
            order = cand[np.argsort(d[cand], kind="stable")]
            if not unlimited:
                n_close = int(np.sum(d[order] <= self.cfg.th_depth))
                n_keep = max(n_close, min(len(order), self.cfg.max_new_points_per_kf))
                order = order[:n_keep]
            if len(order):
                T_wc = np_lie.se3_inverse(self.T_cw)
                pos_w = np_lie.se3_apply(T_wc, frame_np["xyz_cam"][order])
                C = T_wc[4:7]
                vec = pos_w - C
                dist = np.linalg.norm(vec, axis=-1)
                normal = vec / np.maximum(dist[:, None], 1e-9)
                st.add_points_bulk(
                    pos_w, frame_np["desc"][order], normal, dist, kf, order,
                    octave=frame_np["octave"][order],
                )
            return kf
