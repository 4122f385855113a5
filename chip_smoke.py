#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (spslam_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

1. Builds the port's CUDA kernel (csrc/fast_nms.cu) with nvcc.
2. Kernel phase: the FAST+NMS kernel against its plain PyTorch version on
   the card.  (a) One level at a time without a border, at every level
   shape of the 640x480 8-level pyramid and at (101, 131): bit-exact
   inside 19 px.  (b) All 8 levels in one launch with the 19-px detection
   border: bit-exact on every whole level; this is the per-frame time.
   (c) The same with a 4-px border and with a 4-level table.  Times are
   device time from the CUDA profiler and CUDA-event time around single
   calls (median of 60); the host's time per call is taken too.  The
   bound is the larger of the bytes over the card's memory rate and the
   lane operations over its peak rate (the min/max rate measured here),
   the ring counted on every scored pixel; the count with the ring only
   where this run's images pass the kernel's compass test is printed too.
3. Frame phase: build_frame of one frame on the card against the CPU.
4. Path phase: the port's System (point-only tracking + local BA) on a
   20-frame 640x480 synthetic sequence, 1024 features, 8 levels, from the
   entry point a user calls; asserts no LOST frame, ATE < 0.02 m and
   exactly one kernel launch per frame.
5. Segmentation phase: segment_planes on the card against the CPU on
   frame 2 of that sequence, at 640x480 (the plane mapper's input) and at
   the 320x240 stride-2 depth (the fused step's): equal valid counts, the
   same planes in the same order, normal dot > 0.9999994, |dd| < 2e-3
   (the gate the JAX package holds its TPU run to).  Prints the TF32
   flags, the device time of one call and its host syncs.
6. Planes path phase: System(use_planes=True) on the low-texture,
   noisy-depth 30-frame sequence of the planes lane (seed 7, 0.8% depth
   noise, u8 gray and u16 depth, pipeline depth 2, th_depth 3.2): asserts
   >= 4 map planes, ATE < 0.02 m, no more LOST frames than the JAX
   package's CPU run of the same frames (0) and one kernel launch per
   frame; the point-only System runs on the first 15 frames for the ATE
   ratio over those, which is printed (one launch per frame there too).
7. Loop ops phase: on the card against the CPU on the same inputs,
   `quantize` of one frame's 1024 descriptors against the in-repo
   4096-word vocabulary (exact), `ransac_align` on one hypothesis draw
   (T_ba within 1e-4, equal inlier counts) and `optimize_pose_graph` on a
   drifted 32-keyframe loop (poses within 1e-4); prints each call's device
   host and device time, kernels and host syncs, and the pose graph's at
   the production size (512 keyframes).
8. Loop path phase: after the loop warm-up (loop/precompile.py),
   System(use_loop=True, local_ba=True) on the reference's 64-frame loop
   sequence (0.4% depth noise, u8 gray and u16 depth): asserts >= 1 loop
   closure, ATE < 0.04 m, no more LOST frames than the JAX package's CPU
   run of the same frames (0) and one kernel launch per frame.  Prints per
   closure the keyframes, inliers, assembly / pose-graph / correction ms
   and the GBA worker's ms, then replays each closure from a copy of the
   map taken just before it, under the profiler, for its kernels and host
   syncs (closure, and its global BA apart); and the steady median and
   largest ms per track_rgbd call.
9. Relocalization phase: the scenario of
   tests/integration/test_failure_paths.py (40-frame loop sequence, 28 lead
   frames, 4 blank frames, then frames 2-11 again) after the sync-tracking
   warm-up: asserts RELOC in the metrics, final state OK, the recovered
   pose within 0.3 m of truth and one kernel launch per frame.
10. Prints the kernel table as one JSON line (launches counted over all
   the paths' runs), the script's wall time, the card's name and power limit,
   and as the last line {"ok": true, "device": {...}}.

Exits non-zero (and prints no result) without CUDA, or when any phase
fails.  Imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory rate (NVIDIA data sheet)
# H100 SXM float32 lane operations per second outside the tensor cores:
# 132 SMs x 128 lanes x 1.98 GHz, the data sheet's boost clock (its
# 67 TFLOP/s counts a multiply-add twice; this kernel has none)
LANE_OPS_PER_S = 132 * 128 * 1.98e9
BORDER = 19                 # detect_levels' detection border
RATIO_FRAMES = 15           # the planes phase's point-only run, for the ATE ratio
# the JAX package's LOST frames on the planes phase's frames, on the CPU
REF_LOWTEX_LOST = 0
# the JAX package's LOST frames on the loop phase's frames (u8 feed), on the
# CPU: `python -m tests.torch_cpu_runs loop64 --which jax`
REF_LOOP_LOST = 0
SYNC_KEYS = ("aten::item", "aten::_local_scalar_dense")


def _card_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader", "-i", "0"],
        capture_output=True, text=True, timeout=60,
    )
    return res.stdout.strip() or f"nvidia-smi failed: {res.stderr.strip()}"


def _image(h, w, seed):
    """Smooth blobs + noise: realistic corner density at several scales."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    img = np.zeros((h, w), np.float32)
    for _ in range(24):
        cy, cx = rng.uniform(0, h), rng.uniform(0, w)
        s = rng.uniform(2, 18)
        a = rng.uniform(30, 120)
        img += a * np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / (2 * s * s))
    img += rng.normal(0, 4.0, (h, w))
    return np.clip(img, 0, 255).astype(np.float32)


def _timed_ms(fn, n=60, warmup=5):
    """(device ms per call, event ms per call).

    Device time is the sum of the call's kernel durations from the CUDA
    profiler (CUPTI); event time is the median of CUDA-event pairs around
    single calls, which also holds the host's launch latency whenever the
    kernels are shorter than it.  Device time is None if the profiler
    reports none."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    dev_us = sum(
        float(getattr(ev, "self_device_time_total", 0.0) or 0.0)
        for ev in prof.key_averages() if "CUDA" in str(ev.device_type)
    )
    return (dev_us / 1e3 / n if dev_us > 0 else None), float(np.median(times))


def _profiled(fn):
    """(kernels, host syncs by name, device ms) of one call of fn under the
    profiler; the call's result is dropped."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    evs = prof.key_averages()
    syncs = {e.key: e.count for e in evs if "Synchronize" in e.key or e.key in SYNC_KEYS}
    dev = [e for e in evs if "CUDA" in str(e.device_type)
           and float(getattr(e, "self_device_time_total", 0.0) or 0.0) > 0]
    return (sum(e.count for e in dev), syncs,
            sum(float(e.self_device_time_total) for e in dev) / 1e3)


def _u8_u16(frames):
    return [(np.clip(g, 0, 255).astype(np.uint8), np.clip(d * 5000.0, 0, 65535).astype(np.uint16))
            for g, d in frames]


def _us(x):
    return "n/a" if x is None else f"{x * 1e3:8.2f}"


def _bound(work, minmax_rate):
    """(bound ms, bound by, bytes ms, operations ms) of a FastNmsWork."""
    bytes_ms = work.bytes / HBM_BYTES_PER_S * 1e3
    ops_ms = max(work.ops / LANE_OPS_PER_S,
                 work.minmax_ops / min(LANE_OPS_PER_S, minmax_rate)) * 1e3
    return (max(bytes_ms, ops_ms), "operations" if ops_ms > bytes_ms else "bytes",
            bytes_ms, ops_ms)


def _ring_px(levels, border):
    """Scored pixels of these levels that pass the kernel's compass test."""
    from spslam_tpu_torch.ops import fast_cuda
    from spslam_tpu_torch.ops.fast import compass_reject

    return sum(int((~compass_reject(img, 7.0))[fast_cuda.scored_region(*img.shape, border)].sum())
               for img in levels)


def _check_levels(levels, border, label):
    """One launch over `levels` against the plain version; bit-exact on
    every whole level (border >= 4).  Returns the corner count."""
    import torch

    from spslam_tpu_torch.ops import fast_cuda

    got = fast_cuda.fast_nms_scores_levels_cuda(levels, 7.0, 20.0, border)
    want = fast_cuda.fast_nms_scores_levels_plain(levels, 7.0, 20.0, border)
    torch.cuda.synchronize()
    n_corner = 0
    for lvl, (g, w) in enumerate(zip(got, want)):
        n_diff = g.numel() if g.shape != w.shape else int((g != w).sum())
        if n_diff:
            raise AssertionError(f"fast_nms {label}: level {lvl} {tuple(g.shape)} differs from "
                                 f"plain at {n_diff} px")
        n_corner += int((w > 0).sum())
    print(f"  fast_nms {label}: {len(levels)} levels, border {border}, one launch, "
          f"bit-exact on every whole level, corners={n_corner}")
    return n_corner


def kernel_phase(spec, frame_gray):
    import torch

    from spslam_tpu_torch.ops import fast_cuda
    from spslam_tpu_torch.ops.fast import fast_score_map, nms3x3
    from spslam_tpu_torch.ops.pyramid import PyramidSpec, build_pyramid_levels

    clocks = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm,clocks.sm", "--format=csv,noheader", "-i", "0"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    rates = [fast_cuda.measure_rate(kind) for kind in (0, 1, 2)]
    minmax_rate = rates[2]
    print(f"  lane operations/s in a register-only loop: float32 add {rates[0]:.4g}, "
          f"float32 min/max {rates[1]:.4g}, int32 min3/max3 {rates[2]:.4g}; "
          f"data-sheet float32 rate {LANE_OPS_PER_S:.4g}; SM clocks max, now: {clocks}")

    # (a) one level per launch, no border
    max_err = 0.0
    shapes = list(spec.level_sizes) + [(101, 131)]
    for (h, w) in shapes:
        img = torch.from_numpy(_image(h, w, seed=h * 1000 + w)).cuda()
        got = fast_cuda.fast_nms_scores_cuda(img, 7.0, 20.0)
        want = nms3x3(fast_score_map(img, 7.0, 20.0))
        torch.cuda.synchronize()
        inner = (slice(BORDER, h - BORDER), slice(BORDER, w - BORDER))
        err = float((got[inner] - want[inner]).abs().max())
        n_diff = int((got[inner] != want[inner]).sum())
        n_corner = int((want[inner] > 0).sum())
        if n_diff:
            raise AssertionError(f"fast_nms kernel differs from plain at {n_diff} px "
                                 f"inside the border of {h}x{w} (max abs {err})")
        k_dev, k_ev = _timed_ms(lambda: fast_cuda.fast_nms_scores_cuda(img, 7.0, 20.0))
        p_dev, p_ev = _timed_ms(lambda: nms3x3(fast_score_map(img, 7.0, 20.0)))
        bound_ms, by, bytes_ms, ops_ms = _bound(fast_cuda.fast_nms_work([(h, w)], 0),
                                                minmax_rate)
        data_ops_ms = _bound(fast_cuda.fast_nms_work([(h, w)], 0, _ring_px([img], 0)),
                             minmax_rate)[3]
        max_err = max(max_err, err)
        print(f"  fast_nms {h:4d}x{w:<4d} corners={n_corner:5d} max_abs_err={err} "
              f"kernel device {_us(k_dev)} us (event {_us(k_ev)})  "
              f"plain device {_us(p_dev)} us (event {_us(p_ev)})  bound {bound_ms * 1e3:6.3f} us "
              f"by {by} (bytes {bytes_ms * 1e3:.3f}, operations {ops_ms * 1e3:.3f}; "
              f"{data_ops_ms * 1e3:.3f} with the ring on this image's candidates only)")

    # (b) the frame's one launch: all 8 levels, detection border inside
    levels = [torch.from_numpy(_image(h, w, seed=h * 1000 + w)).cuda()
              for (h, w) in spec.level_sizes]
    _check_levels(levels, BORDER, "smoke images")
    k_dev, k_ev = _timed_ms(
        lambda: fast_cuda.fast_nms_scores_levels_cuda(levels, 7.0, 20.0, BORDER))
    p_dev, p_ev = _timed_ms(
        lambda: fast_cuda.fast_nms_scores_levels_plain(levels, 7.0, 20.0, BORDER))
    n_host = 300
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n_host):
        fast_cuda.fast_nms_scores_levels_cuda(levels, 7.0, 20.0, BORDER)
    host_us = (time.perf_counter() - t0) / n_host * 1e6
    torch.cuda.synchronize()
    # the bound counts the ring on every scored pixel; beside it, the count
    # with the ring only where this run's images pass the compass test
    work = fast_cuda.fast_nms_work(spec.level_sizes, BORDER)
    bound_ms, by, bytes_ms, ops_ms = _bound(work, minmax_rate)
    data = fast_cuda.fast_nms_work(spec.level_sizes, BORDER, _ring_px(levels, BORDER))
    data_ms, data_by, _, data_ops_ms = _bound(data, minmax_rate)
    print(f"  fast_nms frame (8 levels, border {BORDER}, one launch): kernel device {_us(k_dev)} us "
          f"(event {_us(k_ev)}), host {host_us:.2f} us per call, plain device {_us(p_dev)} us "
          f"(event {_us(p_ev)})")
    print(f"  fast_nms frame bound {bound_ms * 1e3:.3f} us by {by}: bytes {work.bytes} -> "
          f"{bytes_ms * 1e3:.3f} us; operations {work.ops} ({work.minmax_ops} min/max class), "
          f"ring on all {work.scored_px} scored px -> {ops_ms * 1e3:.3f} us; "
          f"with the ring on the {data.ring_px} px that pass the compass test: operations "
          f"{data.ops} ({data.minmax_ops}) -> {data_ops_ms * 1e3:.3f} us, "
          f"{data_ms * 1e3:.3f} us by {data_by}")

    # the same launch on the pyramid of a rendered frame of the path phase
    gray = torch.from_numpy(frame_gray).cuda()
    real, _ = build_pyramid_levels(gray, spec, blur=False)
    _check_levels(real, BORDER, "rendered frame")
    r_dev, r_ev = _timed_ms(
        lambda: fast_cuda.fast_nms_scores_levels_cuda(real, 7.0, 20.0, BORDER))
    print(f"  fast_nms frame on a rendered frame's pyramid: kernel device {_us(r_dev)} us "
          f"(event {_us(r_ev)})")

    # (c) a 4-px border, and a 4-level table
    _check_levels(levels, 4, "smoke images")
    spec4 = PyramidSpec(n_levels=4, scale_factor=1.2, height=240, width=320)
    levels4 = [torch.from_numpy(_image(h, w, seed=h * 1000 + w)).cuda()
               for (h, w) in spec4.level_sizes]
    _check_levels(levels4, BORDER, "4-level table")
    _check_levels(levels4, 4, "4-level table")

    return dict(
        max_abs_err=max_err,
        ms=k_dev if k_dev is not None else k_ev,
        plain_ms=p_dev if p_dev is not None else p_ev,
        bound_ms=bound_ms, bound_by=by, host_us=host_us,
    )


def frame_phase(seq):
    """build_frame of one frame on the card against the CPU."""
    import torch

    from spslam_tpu_torch.frontend.frame import build_frame
    from spslam_tpu_torch.ops.pyramid import PyramidSpec

    gray, depth = seq.frames[3]
    spec = PyramidSpec(8, 1.2, seq.intr.height, seq.intr.width)
    out = {}
    for dev in ("cuda", "cpu"):
        f = build_frame(torch.from_numpy(gray).to(dev), torch.from_numpy(depth).to(dev),
                        spec, seq.intr, n_features=1024)
        out[dev] = {k: getattr(f, k).cpu().numpy() for k in ("uv", "valid", "desc", "depth")}
    g, c = out["cuda"], out["cpu"]
    if g["uv"].shape != (1024, 2) or not np.isfinite(g["uv"]).all():
        raise AssertionError(f"build_frame on the card: bad uv {g['uv'].shape}")
    same_kp = float(np.mean(np.all(g["uv"] == c["uv"], axis=1) & (g["valid"] == c["valid"])))
    same_desc = float(np.mean(np.all(g["desc"] == c["desc"], axis=1)))
    print(f"  build_frame cuda vs cpu: keypoints equal {same_kp:.4f}, "
          f"descriptors equal {same_desc:.4f}, valid {int(g['valid'].sum())}")
    if same_kp < 0.99 or same_desc < 0.97:
        raise AssertionError("build_frame on the card disagrees with the CPU")


def path_phase(seq):
    import torch

    from spslam_tpu_torch.eval.ate import ate_rmse
    from spslam_tpu_torch.ops import fast_cuda
    from spslam_tpu_torch.system import System, SystemConfig
    from spslam_tpu_torch.tracking.tracker import TrackState

    frames = [
        (np.clip(g, 0, 255).astype(np.uint8), np.clip(d * 5000.0, 0, 65535).astype(np.uint16))
        for g, d in seq.frames
    ]
    sys_ = System(SystemConfig(intr=seq.intr, local_ba=True, enable_reloc=False),
                  device="cuda")
    fast_cuda.LAUNCHES = 0
    times = []
    t_all = time.perf_counter()
    for (gray, depth), ts in zip(frames, seq.timestamps):
        t0 = time.perf_counter()
        sys_.track_rgbd(gray, depth, ts)
        times.append(time.perf_counter() - t0)
    sys_.shutdown()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t_all
    launches = fast_cuda.LAUNCHES
    n_fused = sys_.tracker.n_fused

    poses = sys_.poses()
    ate, _ = ate_rmse(poses, seq.poses_gt)
    n_lost = sum(1 for m in sys_.tracker.metrics if m["state"] == "LOST")
    steady_ms = float(np.median(times[5:])) * 1e3
    print(f"  path: {len(frames)} frames, fused {n_fused}, kernel launches {launches}, "
          f"LOST {n_lost}, state {sys_.tracker.state.name}, keyframes {sys_.store.n_kf}, "
          f"points {int(sys_.store.pt_valid.sum())}")
    print(f"  path: median steady {steady_ms:.3f} ms/frame (track_rgbd, frames 5..), "
          f"wall {wall * 1e3 / len(frames):.3f} ms/frame incl. shutdown, "
          f"ATE {ate * 1e3:.3f} mm")
    if poses.shape != (len(frames), 7) or not np.isfinite(poses).all():
        raise AssertionError(f"bad trajectory {poses.shape}")
    if n_lost or sys_.tracker.state != TrackState.OK:
        raise AssertionError(f"tracking lost: {n_lost} LOST, final {sys_.tracker.state}")
    if sys_.store.n_kf < 2:
        raise AssertionError(f"only {sys_.store.n_kf} keyframes")
    if not ate < 0.02:
        raise AssertionError(f"ATE {ate} m >= 0.02 m")
    # one launch per frame, through the fused step or an initialisation
    if n_fused == 0 or launches != len(frames):
        raise AssertionError(f"kernel launched {launches} times for {len(frames)} frames "
                             f"({n_fused} through the fused step)")
    return dict(launches=launches, n_fused=n_fused, ate=ate, steady_ms=steady_ms)


def segmentation_phase(seq):
    """segment_planes of frame 2 on the card against the CPU."""
    import torch

    from spslam_tpu_torch.ops.plane_seg import segment_planes

    print(f"  TF32: cuda.matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32} "
          f"float32_matmul_precision={torch.get_float32_matmul_precision()}")
    depth = seq.frames[2][1]
    out = {}
    for s in (1, 2):
        intr = seq.intr._replace(fx=seq.intr.fx / s, fy=seq.intr.fy / s, cx=seq.intr.cx / s,
                                 cy=seq.intr.cy / s, width=seq.intr.width // s,
                                 height=seq.intr.height // s)
        d = np.ascontiguousarray(depth[::s, ::s])
        d_gpu = torch.from_numpy(d).cuda()
        g = segment_planes(d_gpu, intr)
        c = segment_planes(torch.from_numpy(d), intr)
        vg, vc = g.valid.cpu().numpy(), c.valid.numpy()
        cg, cc = g.coef.cpu().numpy()[vg], c.coef.numpy()[vc]
        ng, nc = g.n_inliers.cpu().numpy(), c.n_inliers.numpy()
        if vg.sum() != vc.sum() or vg.sum() == 0:
            raise AssertionError(f"segment_planes {d.shape}: {vg.sum()} planes on the card, "
                                 f"{vc.sum()} on the CPU")
        worst_dot, worst_dd = 1.0, 0.0
        for a, b in zip(cg, cc):
            b = -b if np.dot(a[:3], b[:3]) < 0 else b
            worst_dot = min(worst_dot, float(np.dot(a[:3], b[:3])))
            worst_dd = max(worst_dd, float(abs(a[3] - b[3])))
        if not (worst_dot > 0.9999994 and worst_dd < 2e-3):
            raise AssertionError(f"segment_planes {d.shape}: card vs CPU normal dot {worst_dot}, "
                                 f"|dd| {worst_dd}")
        dev_ms, ev_ms = _timed_ms(lambda: segment_planes(d_gpu, intr), n=20, warmup=3)
        n_kernels, syncs, _ = _profiled(lambda: segment_planes(d_gpu, intr))
        print(f"  segment_planes {d.shape[1]}x{d.shape[0]}: {int(vg.sum())} planes on both, "
              f"n_inliers equal {bool(np.array_equal(ng, nc))}, worst normal dot {worst_dot:.9f}, "
              f"worst |dd| {worst_dd:.3g} m; device {_us(dev_ms)} us (event {_us(ev_ms)}) per "
              f"call, {n_kernels} kernels, host syncs in one call {syncs}")
        out[s] = dict(ms=dev_ms if dev_ms is not None else ev_ms, syncs=syncs)
    return out


def planes_path_phase():
    """The point+plane path on the low-texture sequence, and the point-only
    path on its first RATIO_FRAMES frames for the ATE ratio over those."""
    import torch

    from spslam_tpu_torch.eval.ate import ate_rmse
    from spslam_tpu_torch.io.synthetic import make_sequence
    from spslam_tpu_torch.ops import fast_cuda
    from spslam_tpu_torch.system import System, SystemConfig
    from spslam_tpu_torch.tracking.tracker import TrackerConfig

    t0 = time.perf_counter()
    seq = make_sequence(n_frames=30, low_texture=True, depth_noise=0.008, seed=7)
    frames = [
        (np.clip(g, 0, 255).astype(np.uint8), np.clip(d * 5000.0, 0, 65535).astype(np.uint16))
        for g, d in seq.frames
    ]
    print(f"  rendered the 30 low-texture frames in {time.perf_counter() - t0:.1f} s")
    res = {}
    for use_planes in (True, False):
        n = len(frames) if use_planes else RATIO_FRAMES
        sys_ = System(SystemConfig(intr=seq.intr, local_ba=True, enable_reloc=False,
                                   use_planes=use_planes,
                                   tracker=TrackerConfig(th_depth=3.2, pipeline_depth=2)),
                      device="cuda")
        fast_cuda.LAUNCHES = 0
        times = []
        for (gray, depth), ts in zip(frames[:n], seq.timestamps):
            t1 = time.perf_counter()
            sys_.track_rgbd(gray, depth, ts)
            times.append(time.perf_counter() - t1)
        sys_.shutdown()
        torch.cuda.synchronize()
        launches = fast_cuda.LAUNCHES
        poses = sys_.poses()
        if poses.shape != (n, 7) or not np.isfinite(poses).all():
            raise AssertionError(f"bad trajectory {poses.shape}")
        ate, _ = ate_rmse(poses, seq.poses_gt[:n])
        r = dict(ate=ate, launches=launches, poses=poses, steady_ms=float(np.median(times[5:])) * 1e3,
                 n_kf=int(sys_.store.n_kf), n_planes=int(sys_.store.pl_valid.sum()),
                 n_lost=sum(1 for m in sys_.tracker.metrics if m["state"] == "LOST"),
                 n_fused=sys_.tracker.n_fused, edges=len(sys_.store.ppe_a))
        res[use_planes] = r
        print(f"  {'planes' if use_planes else 'points'}, {n} frames: ATE {ate * 1e3:.3f} mm, LOST "
              f"{r['n_lost']}, keyframes {r['n_kf']}, map planes {r['n_planes']}, structural "
              f"edges {r['edges']}, fused {r['n_fused']}, kernel launches {launches}, median "
              f"steady {r['steady_ms']:.3f} ms per track_rgbd call (frames 5..)")
        if use_planes:
            if r["n_planes"] < 4:
                raise AssertionError(f"only {r['n_planes']} map planes")
            if not ate < 0.02:
                raise AssertionError(f"planes ATE {ate} m >= 0.02 m")
            if r["n_lost"] > REF_LOWTEX_LOST:
                raise AssertionError(f"{r['n_lost']} LOST frames, the reference has "
                                     f"{REF_LOWTEX_LOST}")
        if launches != n:
            raise AssertionError(f"kernel launched {launches} times for {n} frames")
    ate_planes = ate_rmse(res[True]["poses"][:RATIO_FRAMES], seq.poses_gt[:RATIO_FRAMES])[0]
    print(f"  planes / points ATE ratio over frames 0..{RATIO_FRAMES - 1}: "
          f"{ate_planes / res[False]['ate']:.3f} ({ate_planes * 1e3:.3f} / "
          f"{res[False]['ate'] * 1e3:.3f} mm)")
    return dict(res[True], launches=res[True]["launches"] + res[False]["launches"])


def _drifted_loop(K=32, seed=10):
    """A K-keyframe loop of odometry with noise, its odometry edges and one
    loop edge with the true relative pose (as tests/unit/test_loop_components.py).
    Returns (the problem's arrays, the true poses)."""
    import torch

    from spslam_tpu_torch.geometry import np_lie
    from spslam_tpu_torch.geometry.lie import se3_compose, se3_exp

    rng = np.random.default_rng(seed)
    step = se3_exp(torch.tensor([0.2, 0.0, 0.0, 0.0, 2 * np.pi / K, 0.0]))
    true = [torch.tensor([1.0, 0, 0, 0, 0, 0, 0])]
    for _ in range(K - 1):
        true.append(se3_compose(step, true[-1]))
    true = torch.stack(true).numpy()
    drift = [true[0]]
    for i in range(1, K):
        rel = np_lie.se3_compose(true[i], np_lie.se3_inverse(true[i - 1]))
        noise = se3_exp(torch.from_numpy(rng.normal(0, 0.01, 6).astype(np.float32))).numpy()
        drift.append(np_lie.se3_compose(np_lie.se3_compose(noise, rel), drift[-1]))
    drift = np.stack(drift).astype(np.float32)
    ei = list(range(K - 1)) + [0]
    ej = list(range(1, K)) + [K - 1]
    eT = np.concatenate([np_lie.se3_compose(drift[:-1], np_lie.se3_inverse(drift[1:])),
                         np_lie.se3_compose(true[:1], np_lie.se3_inverse(true[-1:]))])
    ew = np.array([1.0] * (K - 1) + [5.0], np.float32)
    return dict(poses=drift, fixed=np.arange(K) == 0, valid=np.ones(K, bool),
                edge_i=np.array(ei), edge_j=np.array(ej), edge_T=eT.astype(np.float32),
                edge_w=ew, edge_valid=np.ones(K, bool)), true


def loop_ops_phase(seq):
    """quantize, ransac_align and optimize_pose_graph on the card against
    the CPU on the same inputs."""
    import torch

    from spslam_tpu_torch.frontend.frame import build_frame
    from spslam_tpu_torch.loop.sim3 import draw_hypotheses, ransac_align
    from spslam_tpu_torch.loop.vocab import DEFAULT_VOCAB_PATH, quantize
    from spslam_tpu_torch.ops.brief import unpack_bits
    from spslam_tpu_torch.ops.pyramid import PyramidSpec
    from spslam_tpu_torch.solver.pose_graph import PoseGraphProblem, optimize_pose_graph

    out = {}

    def host_ms(fn):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t1) * 1e3

    def report(name, fn):
        """One (warm) call timed on the host clock, synchronised, one
        between CUDA events and one under the profiler: the sum of its
        kernels' times, the kernels and the host syncs."""
        ms = host_ms(fn)
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        n_k, syncs, dev_ms = _profiled(fn)
        print(f"  {name}: one call {ms:.3f} ms on the host clock, {a.elapsed_time(b):.3f} ms "
              f"between events, kernels {dev_ms:.3f} ms on the device (profiler), {n_k} "
              f"kernels, host syncs {syncs}")
        out[name] = dict(host_ms=ms, ms=dev_ms, kernels=n_k, syncs=syncs)

    # quantize: one frame's descriptors against the 4096-word vocabulary
    gray, depth = seq.frames[5]
    spec = PyramidSpec(8, 1.2, seq.intr.height, seq.intr.width)
    f = build_frame(torch.from_numpy(gray).cuda(), torch.from_numpy(depth).cuda(), spec,
                    seq.intr, n_features=1024)
    with np.load(os.path.join(os.path.dirname(os.path.abspath(__file__)), DEFAULT_VOCAB_PATH)) as v:
        vocab = torch.from_numpy(np.asarray(v["vocab"], np.float32))
    bits = unpack_bits(f.desc)
    quantize(bits, vocab.cuda(), f.valid)             # warm
    words = quantize(bits, vocab.cuda(), f.valid).cpu().numpy()
    words_cpu = quantize(bits.cpu(), vocab, f.valid.cpu()).numpy()
    n_diff = int((words != words_cpu).sum())
    print(f"  quantize {tuple(bits.shape)} x {tuple(vocab.shape)}: {int((words >= 0).sum())} "
          f"words, {n_diff} differ from the CPU")
    if n_diff:
        raise AssertionError(f"quantize: {n_diff} words differ between the card and the CPU")
    vocab_gpu = vocab.cuda()
    report("quantize", lambda: quantize(bits, vocab_gpu, f.valid))

    # RANSAC: 256 hypotheses from one draw, 30% outliers
    rng = np.random.default_rng(0)
    N = 1024
    pa = (rng.uniform(-2, 2, (N, 3)) + [0, 0, 3]).astype(np.float32)
    ang = 0.3
    R = np.array([[np.cos(ang), 0, np.sin(ang)], [0, 1, 0], [-np.sin(ang), 0, np.cos(ang)]])
    pb = pa @ R.T + [0.2, -0.1, 0.3] + rng.normal(0, 0.01, (N, 3))
    out_idx = rng.choice(N, N * 3 // 10, replace=False)
    pb[out_idx] += rng.uniform(0.5, 2.0, (len(out_idx), 3))
    pb = pb.astype(np.float32)
    valid = rng.uniform(size=N) > 0.1
    idx = draw_hypotheses(valid, torch.Generator().manual_seed(17))
    args_gpu = [torch.from_numpy(a).cuda() for a in (pa, pb, valid)]
    ransac_align(*args_gpu, idx)                        # warm
    g = ransac_align(*args_gpu, idx)
    c = ransac_align(torch.from_numpy(pa), torch.from_numpy(pb), torch.from_numpy(valid), idx)
    err = float(np.abs(g.T_ba.cpu().numpy() - c.T_ba.numpy()).max())
    print(f"  ransac_align {N} matches, 256 hypotheses: inliers {int(g.n_inliers)} on the card, "
          f"{int(c.n_inliers)} on the CPU, T_ba max abs diff {err:.3g}")
    if int(g.n_inliers) != int(c.n_inliers) or not err < 1e-4:
        raise AssertionError("ransac_align: the card disagrees with the CPU")
    report("ransac_align", lambda: ransac_align(*args_gpu, idx))

    # pose graph: the drifted 32-keyframe loop, then the production size
    arrs, true = _drifted_loop()
    g = optimize_pose_graph(PoseGraphProblem(**{k: torch.from_numpy(v).cuda()
                                                for k, v in arrs.items()})).cpu().numpy()
    c = optimize_pose_graph(PoseGraphProblem(**{k: torch.from_numpy(v)
                                                for k, v in arrs.items()})).numpy()
    err = float(np.abs(g - c).max())
    print(f"  optimize_pose_graph K=32, 20 iterations: poses max abs diff card vs CPU {err:.3g}; "
          f"last pose {np.linalg.norm(g[-1, 4:] - true[-1, 4:]):.4f} m from truth after, "
          f"{np.linalg.norm(arrs['poses'][-1, 4:] - true[-1, 4:]):.4f} m before")
    if not err < 1e-4:
        raise AssertionError(f"optimize_pose_graph: card vs CPU {err}")
    prob32 = PoseGraphProblem(**{k: torch.from_numpy(v).cuda() for k, v in arrs.items()})
    report("optimize_pose_graph K=32", lambda: optimize_pose_graph(prob32))
    # the production size, on the host clock only (the loop path phase
    # profiles it inside a closure)
    K, E = 512, 256
    pad = dict(arrs)
    pad["poses"] = np.concatenate([arrs["poses"], np.tile(arrs["poses"][:1], (K - 32, 1))])
    pad["fixed"] = np.arange(K) == 0
    pad["valid"] = np.arange(K) < 32
    for k, fill in (("edge_i", 0), ("edge_j", 0), ("edge_w", 0.0), ("edge_valid", False)):
        pad[k] = np.concatenate([arrs[k], np.full(E - 32, fill, arrs[k].dtype)])
    pad["edge_T"] = np.concatenate([arrs["edge_T"], np.tile(arrs["poses"][:1], (E - 32, 1))])
    prob512 = PoseGraphProblem(**{k: torch.from_numpy(v).cuda() for k, v in pad.items()})
    print(f"  optimize_pose_graph K=512 E=256: one call "
          f"{host_ms(lambda: optimize_pose_graph(prob512)):.3f} ms on the host clock")
    return out


def _store_copy(st):
    """A MapStore holding a copy of st's map (for the closure replay)."""
    import dataclasses

    from spslam_tpu_torch.map.store import SAVED_ARRAYS, SAVED_COUNTS, MapStore

    with st.lock:
        c = MapStore.from_numpy({k: np.array(getattr(st, k)) for k in SAVED_ARRAYS + SAVED_COUNTS},
                                dataclasses.replace(st.cfg))
        c.ppe_a, c.ppe_b, c.ppe_type = st.ppe_a.copy(), st.ppe_b.copy(), st.ppe_type.copy()
    return c


def loop_path_phase():
    """System(use_loop=True) on the 64-frame loop sequence; each closure
    replayed under the profiler from a copy of the map taken before it."""
    import torch

    from spslam_tpu_torch.eval.ate import ate_rmse
    from spslam_tpu_torch.io.synthetic import make_sequence
    from spslam_tpu_torch.loop.loop_closer import LoopCloser, LoopConfig
    from spslam_tpu_torch.loop.precompile import warm_loop_machinery
    from spslam_tpu_torch.ops import fast_cuda
    from spslam_tpu_torch.system import System, SystemConfig

    t0 = time.perf_counter()
    seq = make_sequence(n_frames=64, trajectory="loop", depth_noise=0.004)
    frames = _u8_u16(seq.frames)
    print(f"  rendered the 64 loop frames in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    warm_loop_machinery(seq.intr, device="cuda")
    print(f"  loop warm-up (loop/precompile.py) {time.perf_counter() - t0:.2f} s")

    sys_ = System(SystemConfig(intr=seq.intr, local_ba=True, use_loop=True), device="cuda")
    lc = sys_.loop_closer
    # the geometric check reads the map and draws hypotheses: when it
    # passes, the map is still as it was before the closure, so a copy
    # taken then (with the draw's generator state from before the check)
    # lets the closure be replayed
    snaps, snap_ms = [], []
    geometric_check = lc._geometric_check

    def check_and_keep(kf, cand, inlier_scale=1.0):
        gen_state = lc._gen.get_state()
        ok, T = geometric_check(kf, cand, inlier_scale)
        if ok:
            t1 = time.perf_counter()
            snaps.append((kf, cand, inlier_scale, _store_copy(sys_.store), list(lc.loop_edges),
                          gen_state))
            snap_ms.append((time.perf_counter() - t1) * 1e3)
        return ok, T

    lc._geometric_check = check_and_keep
    fast_cuda.LAUNCHES = 0
    times = []
    for (gray, depth), ts in zip(frames, seq.timestamps):
        t1 = time.perf_counter()
        sys_.track_rgbd(gray, depth, ts)
        times.append(time.perf_counter() - t1)
    t1 = time.perf_counter()
    sys_.shutdown()
    shutdown_ms = (time.perf_counter() - t1) * 1e3
    torch.cuda.synchronize()
    launches = fast_cuda.LAUNCHES
    poses = sys_.poses()
    if poses.shape != (len(frames), 7) or not np.isfinite(poses).all():
        raise AssertionError(f"bad trajectory {poses.shape}")
    ate, _ = ate_rmse(poses, seq.poses_gt)
    n_lost = sum(1 for m in sys_.tracker.metrics if m["state"] == "LOST")
    steady = float(np.median(times[5:])) * 1e3
    worst = int(np.argmax(times))
    print(f"  loop: ATE {ate * 1e3:.3f} mm, closures {lc.n_loops_closed}, LOST {n_lost}, "
          f"keyframes {sys_.store.n_kf}, fused {sys_.tracker.n_fused}, kernel launches "
          f"{launches}, median steady {steady:.3f} ms per track_rgbd call (frames 5..), largest "
          f"{times[worst] * 1e3:.3f} ms (call {worst}), shutdown {shutdown_ms:.1f} ms "
          f"(its final global BA included); map snapshots for the replay "
          f"{', '.join(f'{x:.1f}' for x in snap_ms)} ms inside the closure calls")
    for e in lc.events:
        if e["kind"] in ("closed", "gba"):
            print(f"    {e}")
    for kf, cand, scale, store, edges, gen_state in snaps:
        lc2 = LoopCloser(seq.intr, store, lc.vocab, cfg=LoopConfig(gba_async=False),
                         device="cuda")
        lc2.loop_edges = edges
        lc2._gen.set_state(gen_state)
        lc2._global_refine = lambda: None
        ok = []
        n_k, syncs, dev_ms = _profiled(lambda: ok.append(lc2._close_loop(kf, cand, scale)))
        g_k, g_syncs, g_ms = _profiled(lc2._run_gba)
        print(f"    closure kf {kf} <- cand {cand} replayed (closed again: {ok[0]}, inliers "
              f"{lc2.last_inliers}): {n_k} kernels, {dev_ms:.3f} ms on the device, host syncs "
              f"{syncs}; its global BA: {g_k} kernels, {g_ms:.3f} ms on the device, host syncs "
              f"{g_syncs}")
    if lc.n_loops_closed < 1:
        raise AssertionError("no loop closure fired")
    if not ate < 0.04:
        raise AssertionError(f"loop ATE {ate} m >= 0.04 m")
    if n_lost > REF_LOOP_LOST:
        raise AssertionError(f"{n_lost} LOST frames, the reference has {REF_LOOP_LOST}")
    if launches != len(frames):
        raise AssertionError(f"kernel launched {launches} times for {len(frames)} frames")
    return dict(launches=launches, ate=ate, steady_ms=steady)


def reloc_phase():
    """LOST through blank frames, then recovery through the keyframe
    database on earlier views."""
    import torch

    from spslam_tpu_torch.geometry import np_lie
    from spslam_tpu_torch.io.synthetic import make_sequence
    from spslam_tpu_torch.loop.precompile import warm_sync_tracking
    from spslam_tpu_torch.ops import fast_cuda
    from spslam_tpu_torch.system import System, SystemConfig
    from spslam_tpu_torch.tracking.tracker import TrackState

    seq = make_sequence(n_frames=40, trajectory="loop")
    t0 = time.perf_counter()
    warm_sync_tracking(seq.intr, seq.frames[:4], seq.timestamps[:4], device="cuda")
    print(f"  sync-tracking warm-up (loop/precompile.py) {time.perf_counter() - t0:.2f} s")
    sys_ = System(SystemConfig(intr=seq.intr, enable_reloc=True), device="cuda")
    fast_cuda.LAUNCHES = 0
    n_fed = 0
    for t in range(28):
        sys_.track_rgbd(*seq.frames[t], float(seq.timestamps[t]))
        n_fed += 1
    blank = np.zeros((seq.intr.height, seq.intr.width), np.float32)
    for k in range(4):
        sys_.track_rgbd(blank, blank, 10.0 + 0.1 * k)
        n_fed += 1
    sys_.tracker.flush_pipeline()
    lost = sys_.tracker.state == TrackState.LOST
    times = []
    for t in range(2, 12):
        t1 = time.perf_counter()
        sys_.track_rgbd(*seq.frames[t], 20.0 + float(seq.timestamps[t]))
        times.append(time.perf_counter() - t1)
        n_fed += 1
    sys_.shutdown()
    torch.cuda.synchronize()
    launches = fast_cuda.LAUNCHES
    states = [m.get("state") for m in sys_.tracker.metrics]
    T_gt = np_lie.se3_compose(seq.poses_gt[11], np_lie.se3_inverse(seq.poses_gt[0]))
    err = float(np.linalg.norm(np_lie.se3_compose(sys_.tracker.T_cw,
                                                  np_lie.se3_inverse(T_gt))[4:7]))
    reloc = [m for m in sys_.tracker.metrics if m.get("state") == "RELOC"]
    print(f"  reloc: LOST after the blank frames {lost}, RELOC events {reloc}, LOST frames "
          f"{states.count('LOST')}, final {sys_.tracker.state.name}, recovered pose {err:.4f} m "
          f"from truth, kernel launches {launches} for {n_fed} frames, revisit calls "
          f"{', '.join(f'{x * 1e3:.1f}' for x in times)} ms")
    if not lost or not reloc or sys_.tracker.state != TrackState.OK or not err < 0.3:
        raise AssertionError("relocalization did not recover")
    if launches != n_fed:
        raise AssertionError(f"kernel launched {launches} times for {n_fed} frames")
    return dict(launches=launches)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from spslam_tpu_torch.io.synthetic import make_sequence
    from spslam_tpu_torch.ops import fast_cuda
    from spslam_tpu_torch.ops.pyramid import PyramidSpec

    t_start = time.perf_counter()
    card = _card_line()
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    t0 = time.perf_counter()
    fast_cuda.build(verbose=True)
    print(f"kernel build {time.perf_counter() - t0:.2f} s")

    spec = PyramidSpec(n_levels=8, scale_factor=1.2, height=480, width=640)
    t0 = time.perf_counter()
    seq = make_sequence(n_frames=20)
    print(f"rendered 20 frames in {time.perf_counter() - t0:.1f} s")
    def phase(name, fn, *args):
        print(f"{name} phase")
        t1 = time.perf_counter()
        out = fn(*args)
        print(f"  ({name} phase: {time.perf_counter() - t1:.1f} s)")
        return out

    kern = phase("kernel", kernel_phase, spec,
                 np.clip(seq.frames[3][0], 0, 255).astype(np.uint8).astype(np.float32))
    phase("frame", frame_phase, seq)
    path = phase("path", path_phase, seq)
    phase("segmentation", segmentation_phase, seq)
    planes = phase("planes path", planes_path_phase)
    phase("loop ops", loop_ops_phase, seq)
    loop = phase("loop path", loop_path_phase)
    reloc = phase("relocalization", reloc_phase)

    kernels = [dict(
        name="fast_nms", route="cuda", source="spslam_tpu_torch/csrc/fast_nms.cu",
        replaces="spslam_tpu/ops/fast_pallas.py:99",
        # the point, planes, loop and relocalization paths' runs
        launches=path["launches"] + planes["launches"] + loop["launches"] + reloc["launches"],
        max_abs_err=kern["max_abs_err"],
        # per frame: the one launch over the 8 levels of a pyramid
        ms=kern["ms"], plain_ms=kern["plain_ms"],
        # the ring counted on every scored pixel, whatever the data
        bound_ms=kern["bound_ms"], bound_by=kern["bound_by"],
        library_ms=None, host_us_per_call=kern["host_us"],
    )]
    print(json.dumps({"kernels": kernels}))
    print(f"chip_smoke wall time {time.perf_counter() - t_start:.1f} s")
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
