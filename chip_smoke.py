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
   frame; the point-only System runs on the same frames for the ATE ratio,
   which is printed.
7. Prints the kernel table as one JSON line (launches counted over both
   paths), the card's name and power limit, and as the last line
   {"ok": true, "device": {...}}.

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
# the JAX package's LOST frames on the planes phase's frames, on the CPU
REF_LOWTEX_LOST = 0


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
    from torch.profiler import ProfilerActivity, profile

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
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            segment_planes(d_gpu, intr)
            torch.cuda.synchronize()
        evs = prof.key_averages()
        syncs = {e.key: e.count for e in evs if "Synchronize" in e.key
                 or e.key in ("aten::item", "aten::_local_scalar_dense")}
        n_kernels = sum(e.count for e in evs if "CUDA" in str(e.device_type)
                        and float(getattr(e, "self_device_time_total", 0.0) or 0.0) > 0)
        print(f"  segment_planes {d.shape[1]}x{d.shape[0]}: {int(vg.sum())} planes on both, "
              f"n_inliers equal {bool(np.array_equal(ng, nc))}, worst normal dot {worst_dot:.9f}, "
              f"worst |dd| {worst_dd:.3g} m; device {_us(dev_ms)} us (event {_us(ev_ms)}) per "
              f"call, {n_kernels} kernels, host syncs in one call {syncs}")
        out[s] = dict(ms=dev_ms if dev_ms is not None else ev_ms, syncs=syncs)
    return out


def planes_path_phase():
    """The point+plane path on the low-texture sequence, and the point-only
    path on the same frames for the ATE ratio."""
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
        sys_ = System(SystemConfig(intr=seq.intr, local_ba=True, enable_reloc=False,
                                   use_planes=use_planes,
                                   tracker=TrackerConfig(th_depth=3.2, pipeline_depth=2)),
                      device="cuda")
        fast_cuda.LAUNCHES = 0
        times = []
        for (gray, depth), ts in zip(frames, seq.timestamps):
            t1 = time.perf_counter()
            sys_.track_rgbd(gray, depth, ts)
            times.append(time.perf_counter() - t1)
        sys_.shutdown()
        torch.cuda.synchronize()
        launches = fast_cuda.LAUNCHES
        poses = sys_.poses()
        if poses.shape != (len(frames), 7) or not np.isfinite(poses).all():
            raise AssertionError(f"bad trajectory {poses.shape}")
        ate, _ = ate_rmse(poses, seq.poses_gt)
        r = dict(ate=ate, launches=launches, steady_ms=float(np.median(times[5:])) * 1e3,
                 n_kf=int(sys_.store.n_kf), n_planes=int(sys_.store.pl_valid.sum()),
                 n_lost=sum(1 for m in sys_.tracker.metrics if m["state"] == "LOST"),
                 n_fused=sys_.tracker.n_fused, edges=len(sys_.store.ppe_a))
        res[use_planes] = r
        print(f"  {'planes' if use_planes else 'points'}: ATE {ate * 1e3:.3f} mm, LOST "
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
            if launches != len(frames):
                raise AssertionError(f"kernel launched {launches} times for {len(frames)} frames")
    print(f"  planes / points ATE ratio {res[True]['ate'] / res[False]['ate']:.3f}")
    return res[True]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from spslam_tpu_torch.io.synthetic import make_sequence
    from spslam_tpu_torch.ops import fast_cuda
    from spslam_tpu_torch.ops.pyramid import PyramidSpec

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
    print("kernel phase")
    kern = kernel_phase(spec, np.clip(seq.frames[3][0], 0, 255).astype(np.uint8)
                        .astype(np.float32))
    print("frame phase")
    frame_phase(seq)
    print("path phase")
    path = path_phase(seq)
    print("segmentation phase")
    segmentation_phase(seq)
    print("planes path phase")
    planes = planes_path_phase()

    kernels = [dict(
        name="fast_nms", route="cuda", source="spslam_tpu_torch/csrc/fast_nms.cu",
        replaces="spslam_tpu/ops/fast_pallas.py:99",
        # the point path's and the planes path's runs
        launches=path["launches"] + planes["launches"],
        max_abs_err=kern["max_abs_err"],
        # per frame: the one launch over the 8 levels of a pyramid
        ms=kern["ms"], plain_ms=kern["plain_ms"],
        # the ring counted on every scored pixel, whatever the data
        bound_ms=kern["bound_ms"], bound_by=kern["bound_by"],
        library_ms=None, host_us_per_call=kern["host_us"],
    )]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
