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
   exactly one kernel launch per frame.  Then the BA graph phase: three
   successive local-BA windows of that map, the third with two planes and
   a structural edge added, through mapping/ba_graph.py with a cache of
   its own: each replay bit-equal to bundle_adjust run eagerly (or within
   1e-6 m with the same inliers), one capture for the three; prints host
   ms of eager and replayed BAs and the device ms of each under the
   profiler.  Then the fuse graph phase: every block the path phase's
   fusion matched (recorded as it ran), through mapping/fuse_graph.py with
   a cache of its own: each replay's matched slots and distances bit-equal
   to _fuse_match_batch run eagerly, one capture, no failed capture (in
   the path phase's process cache too); prints host ms of one block eager
   and replayed and the device ms of each under the profiler.
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
   largest ms per track_rgbd call.  tools/debug_loop's gate tracer rides
   along on the System's LoopCloser: the keyframes it traced, its own host
   time, and the gates of those with a geometric check or a closure print;
   every closure was seen by it.
9. Relocalization phase: the scenario of
   tests/integration/test_failure_paths.py (40-frame loop sequence, 28 lead
   frames, 4 blank frames, then frames 2-11 again) after the sync-tracking
   warm-up: asserts RELOC in the metrics, final state OK, the recovered
   pose within 0.3 m of truth and one kernel launch per frame.
10. Loop lane phase: one paced pass of the bench's loop lane (the 128-frame
   loop sequence, rendered into the bench's cache by a niced process beside
   the earlier phases; async mapping, use_loop, local BA, th_depth 3.2, u8
   gray and u16 depth at 30 fps) through tools/loop_lane_debug, after the
   warm-ups of the two phases before it: the LoopCloser's event log, per
   closure its frames and the ground-truth view gap against the half field
   of view and its loop edge's error against the ground truth, per global
   BA the keyframes added while it ran; asserts no error logged by the
   mapping worker, every loop edge within 50 mm and 1 degree of the truth
   (a closure past the half field of view is no fault: both packages
   accept such closures with true alignments) and one kernel launch per
   frame.
11. Dist BA phase: parallel/dist_ba.dist_bundle_adjust at 256 keyframes,
   32,768 points, 16 observations a point at most, in 4 shards on cuda:0
   (a post-loop-shaped map: keyframes orbiting the points): the cost must
   fall below 0.1x; D = 1 vs D = 4 on the card, poses within 1e-4; card vs
   CPU on the CPU tests' problem (poses 1e-4, points 1e-3); the same run
   through a world-size-1 NCCL group equal to the run without one (1e-4).
   Prints ms per LM iteration by part, host syncs per iteration, the
   all_reduce's bytes per iteration and time, and peak memory.
12. Dist GBA phase: dist_global_bundle_adjust(n_shards=4, 4 x cuda:0) on a
   copy of the loop path phase's map (finite, loop ATE re-read < 0.04 m),
   and auto mode with GBA_MAX_Y_ELEMS lowered, which declines the sharded
   solver on one card and settles 3x longer.
13. Async path phase: System(async_mapping=True) on the 20-frame orbit:
   ATE < 0.03 m, no LOST frame, every submitted keyframe processed, no
   error logged by the mapping worker, one kernel launch per frame; ms
   per call beside the synchronous path's.
14. Dp phase: parallel/dp_eval.evaluate_sequences on the 10-frame orbit of
   seeds 0 and 7 (two Systems on the card, deterministic algorithms on): each ATE
   < 0.02 m, sequence 1 batched equal to alone to 1e-6, one launch per
   frame per System; aggregate frames/s.
15. Cli and native phase: a TUM-layout directory of the first 10 frames written
   with the script's own PNG writer, then `python -m spslam_tpu_torch.cli
   --tum DIR --config DIR/settings.yaml --loop --async-mapping` in a
   subprocess (exit 0, the JSON line with ATE < 0.04 m, one launch per
   frame); the port's C++ library built in the checkout and the loop
   phase's keyframe database native.
16. Vocab phase: loop/train_vocab.collect_training_descriptors at full
   size (4 rooms x 12 views of 640x480, 8 levels, 1,024 features) on the
   card: exactly one kernel launch per view (48); room 0 built on the card
   again (equal) and on the CPU (>= 99% of the descriptor rows in common);
   train_vocabulary of 4,096 words on the card and on the CPU from the same
   pool and draw: vocabulary bits and idf equal exactly; the saved file read
   back with equal words.  Prints the collect and k-means times, the
   descriptor count and the file size.
17. Api phase: sim3_exp, sim3_log, sim3_compose, sim3_inverse,
   se3_matrix and se3_from_matrix on the card against the CPU at 1e-5
   (sim3_exp and sim3_log rows with |sigma| >= 1e-6 plus two ulps of the
   reference's (e^sigma - 1)/sigma cancellation), project_with_depth at
   6.4e-4 px + 1e-6 relative, and rpe_rmse of the path phase's run beside
   its ATE.
18. Bench phase: `python -m spslam_tpu_torch.bench` in a subprocess with
   BENCH_FRAMES=20 BENCH_PASSES=1 BENCH_LOWTEX=0 BENCH_LOOP=0: the point
   and planes lanes on the 20-frame orbit (the bench's own is 40; 12-frame
   warm-ups, async mapping).  A niced single-threaded process renders this
   orbit, and the planes, loop and loop lane phases' sequences, into the
   bench's cache beside the earlier phases.  Parses its JSON line: the
   reference bench's keys, both ATEs < 20 mm, one kernel launch per frame
   fed (64).
19. Host sections phase: tools/profile_host's profile of the path phase's
   first 10 frames (its warm-up on the same frames, 1 pass, async
   mapping): the section table with every key of the reference's tracker,
   only those keys accumulated, the per-frame ones on every resolved
   frame, the accounted sum within the pass's wall time, one launch per
   frame (20).
20. Weak scaling phase: tools/weak_scaling's sweep at D = 1, 2, 4 on the
   visible cards (shards round-robin; on one card all on cuda:0), its
   problem of 16,384 points and 64 cameras with the points moved by 5 cm
   noise so that there is a cost to bring down: the cost falls at every D,
   the JSON line prints (and the caveat when shards share a card).
21. Recall phase: tools/vocab_recall's sweep on the card at --quick's
   sizes (4,096 and 16,384 words), cut to what the run already rendered:
   the eval set is the loop path phase's 64-frame loop sequence every 4th
   frame (--quick renders a 96-frame one), the training pool the vocab
   phase's 49,152 descriptors of 4 other rooms (--quick renders a 40-frame
   orbit).  The curve prints, recall and precision lie in [0, 1] with
   queries > 0, one launch per built frame (16).
22. Tools phase: tools/ate_debug on the first 8 frames of the orbit (sync
   ATE < 20 mm, async < 30 mm), profile_frame, profile_fused, profile_ab
   (and its replica once against the real step, bit equality printed),
   profile_pipeline at n = 3, profile_tunnel and profile_xfer, in-process:
   every time finite and positive, one kernel launch per frame each tool
   builds.
23. Prints the kernel table as one JSON line (launches counted over all
   the paths' runs), the script's wall time, the card's name and power limit,
   and as the last line {"ok": true, "device": {...}}.

Exits non-zero (and prints no result) without CUDA, or when any phase
fails.  Imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import copy
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
TOOL_N = 3                  # the tools phase's repetitions
ATE_FRAMES = 8              # the tools phase's ate_debug orbit (the tool's is 40)
# the dp, CLI and host sections phases' orbit: the path phase's first frames
# (cut from its 20 to keep the script inside its time limit)
SHORT_FRAMES = 10
BENCH_FRAMES = 20           # the bench phase's orbit (the bench's own is 40; cut for time)
# a loop lane closure's edge against the ground-truth relative pose: every
# edge measured on the lane (card and CPU, both packages) lies within 20 mm
# and 0.44 degrees
LANE_EDGE_MM, LANE_EDGE_DEG = 50.0, 1.0


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

    from spslam_tpu_torch.tools.profile_frame import device_work, trace_events

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    # the trace's raw events: key_averages() takes a minute a closure
    evs = trace_events(prof)
    syncs = {}
    for name, on_device, _ in evs:
        if not on_device and ("Synchronize" in name or name in SYNC_KEYS):
            syncs[name] = syncs.get(name, 0) + 1
    n_k, dev_us = device_work(evs)
    return n_k, syncs, dev_us / 1e3


def _head(seq, n):
    """A copy of seq holding its first n frames."""
    out = copy.copy(seq)
    out.frames, out.poses_gt, out.timestamps = seq.frames[:n], seq.poses_gt[:n], seq.timestamps[:n]
    return out


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
    from spslam_tpu_torch.mapping import fuse_graph
    from spslam_tpu_torch.ops import fast_cuda
    from spslam_tpu_torch.system import System, SystemConfig
    from spslam_tpu_torch.tracking.tracker import TrackState

    frames = [
        (np.clip(g, 0, 255).astype(np.uint8), np.clip(d * 5000.0, 0, 65535).astype(np.uint16))
        for g, d in seq.frames
    ]
    sys_ = System(SystemConfig(intr=seq.intr, local_ba=True, enable_reloc=False),
                  device="cuda")
    # every block fusion matches, kept for the fuse graph phase
    fuse_blocks = []
    run = fuse_graph.GRAPHS.run

    def recorded(key, device, inputs, *a):
        fuse_blocks.append(tuple(x.clone() for x in inputs))
        return run(key, device, inputs, *a)

    fuse_graph.GRAPHS.run = recorded
    fast_cuda.LAUNCHES = 0
    times = []
    t_all = time.perf_counter()
    try:
        for (gray, depth), ts in zip(frames, seq.timestamps):
            t0 = time.perf_counter()
            sys_.track_rgbd(gray, depth, ts)
            times.append(time.perf_counter() - t0)
        sys_.shutdown()
    finally:
        del fuse_graph.GRAPHS.run
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
    return dict(launches=launches, n_fused=n_fused, ate=ate, steady_ms=steady_ms,
                poses=poses, poses_gt=seq.poses_gt, mapper=sys_.mapper,
                fuse_blocks=fuse_blocks)


# two perpendicular world planes (a floor and a wall) and their weights,
# added to the BA graph phase's third window
BA_PLANES = np.array([[0.0, 1.0, 0.0, 1.2], [1.0, 0.0, 0.0, 2.0]], np.float32)
BA_PLANE_W, BA_EDGE_W = 50.0, 10.0


def _with_planes(prob):
    """The host problem `prob` with BA_PLANES (their distances 2 cm off)
    observed from each of its valid poses, and a perpendicular edge."""
    import torch

    from spslam_tpu_torch.geometry.plane import transform_plane_np

    rng = np.random.default_rng(11)
    a = {k: v.numpy().copy() for k, v in prob._asdict().items()}
    poses = a["poses"][a["pose_valid"]]
    a["planes"][:2] = BA_PLANES + np.array([0, 0, 0, 0.02], np.float32)
    a["plane_valid"][:2] = True
    q = 0
    for cam, T in enumerate(poses):
        for l, pi in enumerate(BA_PLANES):
            if q < len(a["pobs_cam"]):
                a["pobs_cam"][q], a["pobs_plane"][q] = cam, l
                a["pobs_pi"][q] = transform_plane_np(T, pi) + rng.normal(0, 1e-3, 4)
                a["pobs_w"][q], a["pobs_valid"][q] = BA_PLANE_W, True
                q += 1
    a["pp_a"][0], a["pp_b"][0], a["pp_type"][0] = 0, 1, 1
    a["pp_w"][0], a["pp_valid"][0] = BA_EDGE_W, True
    return type(prob)(**{k: torch.from_numpy(v) for k, v in a.items()})


def ba_graph_phase(path):
    """Three successive local-BA windows of the path phase's map, the third
    with two planes and a structural edge added (the plane terms' batched
    Jacobians inside the graph): mapping/ba_graph.py with a cache of its
    own against bundle_adjust run eagerly on the same problems."""
    import torch

    from spslam_tpu_torch.cuda_graphs import CapturedCalls
    from spslam_tpu_torch.mapping import ba_graph
    from spslam_tpu_torch.solver.ba import bundle_adjust

    mapper = path["mapper"]
    cfg, intr, dev = mapper.cfg, mapper.intr, mapper.device
    print(f"  the path phase's process cache: {ba_graph.GRAPHS.captures} capture(s), "
          f"{ba_graph.GRAPHS.replays} replays, {ba_graph.GRAPHS.failures} failed captures")
    kfs = np.nonzero(mapper.store.kf_valid)[0][-3:]
    probs = [mapper._host_problem(int(kf)) for kf in kfs]
    if len(probs) < 3 or any(p is None for p in probs):
        raise AssertionError(f"keyframes {kfs}: not three local-BA windows")
    probs = [p[0] for p in probs]
    probs[2] = _with_planes(probs[2])

    def eager(p):
        return ba_graph.fetch(bundle_adjust(ba_graph.to_device(p, dev), intr,
                                            cfg.ba_stage1_iters, cfg.ba_stage2_iters))

    def timed(fn, *a):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*a)
        return out, (time.perf_counter() - t0) * 1e3

    graphs = CapturedCalls("mapper.ba")
    want, eager_ms = zip(*(timed(eager, p) for p in probs))
    first, first_ms = timed(ba_graph.solve, probs[0], intr, cfg, dev, graphs)
    print(f"  first call (eager on the static tensors, then the capture): {first_ms:.1f} ms; "
          f"captures {graphs.captures}, failed {graphs.failures}")
    got, replay_ms = zip(*(timed(ba_graph.solve, p, intr, cfg, dev, graphs) for p in probs))
    names = ("poses", "points", "planes", "obs_inlier")
    for i, (g, w) in enumerate(zip((first,) + got, (want[0],) + want)):
        exact = all(np.array_equal(a, b) for a, b in zip(g, w))
        gap = max(float(np.abs(a - b).max()) for a, b in zip(g[:3], w[:3]))
        flips = int((g[3] != w[3]).sum())
        label = "first call" if i == 0 else f"window {i} replay"
        print(f"  {label}: {'bit-equal to eager' if exact else 'differs from eager'}, "
              f"largest gap {gap:.3g} m, inlier flips {flips}")
        if not exact and (gap > 1e-6 or flips):
            raise AssertionError(f"{label}: {names} off eager by {gap} m, {flips} inlier flips")
    if np.array_equal(want[2][2][:2], probs[2].planes.numpy()[:2]):
        raise AssertionError("the third window's planes did not move")
    if (graphs.captures, graphs.failures, graphs.replays) != (1, 0, 3):
        raise AssertionError(f"captures {graphs.captures}, failed {graphs.failures}, "
                             f"replays {graphs.replays}: one capture and three replays expected")
    n_e, _, dev_e = _profiled(lambda: eager(probs[1]))
    n_r, _, dev_r = _profiled(lambda: ba_graph.solve(probs[1], intr, cfg, dev, graphs))
    print(f"  a local BA at {ba_graph.problem_dims(probs[0])}: eager host "
          + ", ".join(f"{x:.1f}" for x in eager_ms) + " ms, replay host "
          + ", ".join(f"{x:.1f}" for x in replay_ms) + f" ms; device {dev_e:.2f} ms in "
          f"{n_e} events eager, {dev_r:.2f} ms in {n_r} replayed")


def fuse_graph_phase(path):
    """Every block the path phase's fusion matched, through
    mapping/fuse_graph.py with a cache of its own, against
    _fuse_match_batch run eagerly on the same block."""
    import torch

    from spslam_tpu_torch.cuda_graphs import CapturedCalls
    from spslam_tpu_torch.mapping import fuse_graph
    from spslam_tpu_torch.mapping.fuse import _fuse_match_batch

    blocks = path["fuse_blocks"]
    intr, dev = path["mapper"].intr, path["mapper"].device
    g = fuse_graph.GRAPHS
    print(f"  the path phase's process cache: {g.captures} capture(s), {g.replays} replays, "
          f"{g.failures} failed captures; {len(blocks)} blocks recorded")
    if g.failures or not g.captures or len(blocks) < 2:
        raise AssertionError("the path phase's fusion did not replay a captured match")

    def fetch(out):
        return out[0].cpu().numpy(), out[1].cpu().numpy()

    def eager(b):
        return fetch(_fuse_match_batch(*(x.to(dev) for x in b), intr))

    def timed(fn, *a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*a, **kw)
        return out, (time.perf_counter() - t0) * 1e3

    graphs = CapturedCalls("mapper.fuse")
    want, eager_ms = zip(*(timed(eager, b) for b in blocks))
    first, first_ms = timed(fuse_graph.match, blocks[0], intr, dev, graphs, fetch)
    print(f"  first call (eager on the static tensors, then the capture): {first_ms:.1f} ms; "
          f"captures {graphs.captures}, failed {graphs.failures}")
    got, replay_ms = zip(*(timed(fuse_graph.match, b, intr, dev, graphs, fetch)
                           for b in blocks))
    differ = [i for i, (a, b) in enumerate(zip((first,) + got, (want[0],) + want))
              if not (np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1]))]
    n_match = int(sum((w[0] >= 0).sum() for w in want))
    print(f"  {len(blocks)} blocks replayed, {n_match} matches eager: "
          + ("every replay bit-equal to eager" if not differ
             else f"{len(differ)} calls differ from eager (first at {differ[0]})"))
    if differ:
        raise AssertionError(f"fusion's replayed match differs from eager in calls {differ}")
    if (graphs.captures, graphs.failures, graphs.replays) != (1, 0, len(blocks)):
        raise AssertionError(f"captures {graphs.captures}, failed {graphs.failures}, "
                             f"replays {graphs.replays}: one capture and {len(blocks)} "
                             f"replays expected")
    n_e, _, dev_e = _profiled(lambda: eager(blocks[1]))
    n_r, _, dev_r = _profiled(lambda: fuse_graph.match(blocks[1], intr, dev, graphs))
    print(f"  one block [{blocks[0][0].shape[0]} x {blocks[0][5].shape[0]}]: host ms median "
          f"eager {np.median(eager_ms):.2f}, replayed {np.median(replay_ms):.2f} (largest "
          f"{max(eager_ms):.2f}, {max(replay_ms):.2f}); device {dev_e:.3f} ms in {n_e} "
          f"events eager, {dev_r:.3f} ms in {n_r} replayed")


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
    from spslam_tpu_torch.ops import fast_cuda
    from spslam_tpu_torch.system import System, SystemConfig
    from spslam_tpu_torch.tracking.tracker import TrackerConfig

    seq = _rendered(0)
    frames = _u8_u16(seq.frames)
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
    from spslam_tpu_torch.loop.loop_closer import LoopCloser, LoopConfig
    from spslam_tpu_torch.loop.precompile import warm_loop_machinery
    from spslam_tpu_torch.ops import fast_cuda
    from spslam_tpu_torch.system import System, SystemConfig
    from spslam_tpu_torch.tools.debug_loop import GateTracer

    seq = _rendered(1)
    frames = _u8_u16(seq.frames)
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
    # tools/debug_loop's tracer of the detector's gates rides along
    gate_lines = []
    with GateTracer(lc, gate_lines.append) as tracer:
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
    rows = tracer.rows
    print(f"  debug_loop's gate tracer: {len(rows)} keyframes traced with a trained "
          f"vocabulary, {sum(len(r['geo']) for r in rows)} geometric checks "
          f"({sum(ok for r in rows for _, _, ok in r['geo'])} passed), its own host time "
          f"{tracer.seconds * 1e3:.1f} ms inside the calls above; the keyframes with a "
          f"check or a closure:")
    traced = {r["kf"] for r in rows if r["geo"] or r["closed"]}
    show = False
    for line in gate_lines:
        if line.startswith("KF "):
            show = int(line.split()[1].rstrip(":")) in traced
        if show:
            print("    " + line)
    if not rows or any(r["covis_min"] is not None and r["min_score"] < r["covis_min"] - 1e-12
                       for r in rows):
        raise AssertionError("debug_loop's tracer saw no keyframe or a bad min-score gate")
    if sum(r["closed"] for r in rows) != lc.n_loops_closed:
        raise AssertionError("debug_loop's tracer missed a closure")
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
    return dict(launches=launches, ate=ate, steady_ms=steady, system=sys_, seq=seq)


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


def loop_lane_phase(prerender):
    """One paced pass of the bench's 128-frame loop lane through
    tools/loop_lane_debug, after the loop path and relocalization phases'
    warm-ups (the same machinery the bench warms)."""
    import torch

    from spslam_tpu_torch.ops import fast_cuda
    from spslam_tpu_torch.tools import loop_lane_debug as lld

    t0 = time.perf_counter()
    rc = prerender.wait(timeout=600)
    print(f"  the prerender process ended with {rc}; waited {time.perf_counter() - t0:.1f} s")
    seq = _rendered(2)
    seq.frames = _u8_u16(seq.frames)
    fast_cuda.LAUNCHES = 0
    res = lld.run_pass(lld.lane_system(seq, "cuda"), seq)
    torch.cuda.synchronize()
    launches = fast_cuda.LAUNCHES
    lld.report(0, res, lld.half_fov_deg(seq.intr))
    n_false = sum(not c["true_revisit"] for c in res["closures"])
    print(f"  lane: {res['loops']} closures ({n_false} beyond the half field of view), "
          f"{len(res['worker_errors'])} worker errors, kernel launches {launches} for "
          f"{len(seq.frames)} frames")
    if res["worker_errors"]:
        raise AssertionError(f"mapping worker logged: {res['worker_errors'][0]}")
    if launches != len(seq.frames) or res["launches"] != launches:
        raise AssertionError(f"kernel launched {launches} times for {len(seq.frames)} frames")
    if not np.isfinite(res["ate_mm"]):
        raise AssertionError(f"lane ATE {res['ate_mm']}")
    # a closure at a wrong pose is a fault; one past the half field of view
    # with a true alignment is not (both packages accept those)
    wrong = [c for c in res["closures"] if not (c["edge_err_mm"] < LANE_EDGE_MM
                                                and c["edge_err_deg"] < LANE_EDGE_DEG)]
    if wrong:
        raise AssertionError(f"closures at a wrong pose: {wrong}")
    return dict(launches=launches)


# ---------------------------------------------------------------------------
# The sharded BA, async mapping, data-parallel evaluation, CLI and native
# library (the phases after the relocalization phase)
# ---------------------------------------------------------------------------


def _ba_problem(M, P, O, seed):
    """A sharded-BA problem shaped like a map after a loop closure: M
    keyframes on 1.25 turns of a 4 m circle, looking at its centre; P
    points within 1.5 m of it, each seen by 2..O keyframes spread over up
    to 90 degrees of the orbit from its reference keyframe on (0.5 px
    noise, stereo coordinate); then the poses (all but the first) and the
    points perturbed."""
    import torch

    from spslam_tpu_torch.geometry import lie, np_lie
    from spslam_tpu_torch.geometry.camera import Intrinsics

    intr = Intrinsics(fx=525.0, fy=525.0, cx=319.5, cy=239.5, bf=40.0, width=640, height=480)
    rng = np.random.default_rng(seed)
    th = 2.5 * np.pi * np.arange(M) / M
    c = np.stack([4.0 * np.cos(th), 0.1 * np.sin(3 * th), 4.0 * np.sin(th)], -1)
    z = -c / np.linalg.norm(c, axis=1, keepdims=True)               # look at the centre
    x = np.cross(np.array([0.0, 1.0, 0.0]), z)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    R = np.stack([x, np.cross(z, x), z], 1)                          # rows: camera axes
    q = lie.mat_to_quat(torch.from_numpy(R.astype(np.float32))).numpy()
    T = np.concatenate([q, -np.einsum("mij,mj->mi", R, c)], -1).astype(np.float32)
    r = 1.5 * np.sqrt(rng.uniform(0, 1, P))
    a = rng.uniform(0, 2 * np.pi, P)
    X = np.stack([r * np.cos(a), rng.uniform(-0.8, 0.8, P), r * np.sin(a)], -1).astype(np.float32)
    ref = rng.integers(0, M, P)
    L = rng.integers(2, O + 1, P)
    step = rng.integers(1, max(M // (4 * O), 1) + 1, P)              # up to a quarter turn
    pt = np.repeat(np.arange(P), L)
    j = np.arange(len(pt)) - np.repeat(np.cumsum(L) - L, L)
    cam = (ref[pt] + j * step[pt]) % M
    Xc = np_lie.se3_apply(T[cam], X[pt])
    u = intr.fx * Xc[:, 0] / Xc[:, 2] + intr.cx
    v = intr.fy * Xc[:, 1] / Xc[:, 2] + intr.cy
    ok = (Xc[:, 2] > 0.1) & (u > 0) & (u < 640) & (v > 0) & (v < 480)
    pt, cam, Xc, u, v = pt[ok], cam[ok], Xc[ok], u[ok], v[ok]
    uv = np.stack([u, v], -1) + rng.normal(0, 0.5, (len(u), 2))
    ur = uv[:, 0] - intr.bf / Xc[:, 2] + rng.normal(0, 0.5, len(u))
    noise = np.concatenate([rng.normal(0, 0.01, (M, 3)), rng.normal(0, 0.003, (M, 3))], -1)
    noise[0] = 0
    T0 = lie.se3_compose(lie.se3_exp(torch.from_numpy(noise.astype(np.float32))),
                         torch.from_numpy(T)).numpy()
    X0 = X + rng.normal(0, 0.03, X.shape).astype(np.float32)
    fixed = np.zeros(M, bool)
    fixed[0] = True
    return intr, (T0, fixed, X0, cam.astype(np.int32), pt.astype(np.int64),
                  uv.astype(np.float32), ur.astype(np.float32), np.ones(len(u), np.float32)), T


def _line_problem(n_cams=5, n_pts=256, seed=7):
    """The CPU tests' sharded-BA problem (tests/dist/test_dist_ba.py::
    make_problem's geometry): n_cams keyframes 0.2 m apart along x turning
    0.04 rad each, points 4-9 m ahead, 0.3 px noise, poses perturbed."""
    import torch

    from spslam_tpu_torch.geometry import lie, np_lie
    from spslam_tpu_torch.geometry.camera import Intrinsics

    intr = Intrinsics(fx=525.0, fy=525.0, cx=319.5, cy=239.5, bf=40.0, width=640, height=480)
    rng = np.random.default_rng(seed)
    i = np.arange(n_cams, dtype=np.float32)
    xi = np.stack([0.2 * i, 0.01 * i, 0 * i, 0 * i, 0.04 * i, 0 * i], -1).astype(np.float32)
    T = lie.se3_exp(torch.from_numpy(xi)).numpy()
    X = np.stack([rng.uniform(-4, 4, n_pts), rng.uniform(-2, 2, n_pts),
                  rng.uniform(4, 9, n_pts)], -1).astype(np.float32)
    cam = np.repeat(np.arange(n_cams), n_pts)
    pt = np.tile(np.arange(n_pts), n_cams)
    Xc = np_lie.se3_apply(T[cam], X[pt])
    u = intr.fx * Xc[:, 0] / Xc[:, 2] + intr.cx
    v = intr.fy * Xc[:, 1] / Xc[:, 2] + intr.cy
    ok = (u > 0) & (u < 640) & (v > 0) & (v < 480) & (Xc[:, 2] > 0.1)
    cam, pt, Xc, u, v = cam[ok], pt[ok], Xc[ok], u[ok], v[ok]
    uv = np.stack([u, v], -1) + rng.normal(0, 0.3, (len(u), 2))
    ur = uv[:, 0] - intr.bf / Xc[:, 2] + rng.normal(0, 0.3, len(u))
    noise = rng.normal(0, 0.03, (n_cams, 6)).astype(np.float32)
    noise[0] = 0
    T0 = lie.se3_compose(lie.se3_exp(torch.from_numpy(noise)), torch.from_numpy(T)).numpy()
    X0 = X + rng.normal(0, 0.05, X.shape).astype(np.float32)
    fixed = np.zeros(n_cams, bool)
    fixed[0] = True
    return intr, (T0, fixed, X0, cam.astype(np.int32), pt.astype(np.int64),
                  uv.astype(np.float32), ur.astype(np.float32), np.ones(len(u), np.float32))


def _syncs(fn):
    """Host syncs (CUDA synchronize calls + aten::item) of one call."""
    return sum(_profiled(fn)[1].values())


def dist_ba_phase():
    """dist_bundle_adjust on the card: 256 keyframes, 32,768 points, 16
    observations a point at most, 4 shards on cuda:0."""
    import socket

    import torch
    from torch.profiler import ProfilerActivity, profile

    from spslam_tpu_torch.parallel import dist_ba

    M, P, O, D, ITERS = 256, 32768, 16, 4, 10
    t0 = time.perf_counter()
    intr, args, T_true = _ba_problem(M, P, O, seed=3)
    prob = dist_ba.partition_problem(*args, n_shards=D, obs_per_point=O)
    prob1 = dist_ba.partition_problem(*args, n_shards=1, obs_per_point=O)
    n_obs = int(prob.obs_valid.sum())
    print(f"  problem: {M} keyframes, {P} points, {n_obs} observations, {D} shards of "
          f"{prob.points.shape[1]} points / {prob.obs_valid.shape[1]} rows (built and "
          f"partitioned in {time.perf_counter() - t0:.1f} s)")
    dev = torch.device("cuda", 0)
    on4 = [dev] * D

    def run(p, devices, n_iters, stats=None):
        out = dist_ba.dist_bundle_adjust(p, intr, devices, n_iters=n_iters, stats=stats)
        torch.cuda.synchronize()
        return out

    run(prob, on4, 1)                                   # warm-up (cuBLAS, cuSOLVER)
    torch.cuda.reset_peak_memory_stats()
    walls = {}
    for n in (0, ITERS):
        t1 = time.perf_counter()
        out = run(prob, on4, n)
        walls[n] = time.perf_counter() - t1
    poses4, points4, cost4 = out
    ms_iter = (walls[ITERS] - walls[0]) / ITERS * 1e3
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    syncs_iter = (_syncs(lambda: run(prob, on4, ITERS)) - _syncs(lambda: run(prob, on4, 0))) / ITERS
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run(prob, on4, ITERS)
    groups = {"cholesky + triangular solves": ("potrf", "trsm", "trsv", "cholesky"),
              "scatter-adds (index_add_)": ("index", "scatter"),
              "einsum / matmul": ("gemm", "gemv", "bmm", "dot", "cutlass", "sm90")}
    by = {k: 0.0 for k in groups}
    rest, total = 0.0, 0.0
    names = []
    for e in prof.key_averages():
        us = float(getattr(e, "self_device_time_total", 0.0) or 0.0)
        if us <= 0 or "CUDA" not in str(e.device_type):
            continue
        total += us
        names.append((us, e.key))
        for k, pats in groups.items():
            if any(p in e.key.lower() for p in pats):
                by[k] += us
                break
        else:
            rest += us
    print(f"  dist BA on the card, D = {D} on cuda:0: cost {float(cost4):.1f}, {ms_iter:.3f} ms per "
          f"LM iteration (host clock, {ITERS} iterations less 0), {walls[0] * 1e3:.1f} ms for the "
          f"upload and first cost, device {total / 1e3 / ITERS:.3f} ms per iteration: "
          + ", ".join(f"{k} {v / 1e3 / ITERS:.3f}" for k, v in by.items())
          + f", other {rest / 1e3 / ITERS:.3f}; host syncs per iteration {syncs_iter:.1f}; peak "
          f"memory {peak_gb:.2f} GB")
    for us, name in sorted(names, reverse=True)[:6]:
        print(f"    {us / 1e3 / ITERS:8.3f} ms/iter  {name[:100]}")
    if not (torch.isfinite(poses4).all() and torch.isfinite(points4).all()):
        raise AssertionError("dist BA on the card: non-finite result")
    cost0 = float(run(prob, on4, 0)[2])
    e0 = np.linalg.norm(args[0][:, 4:7] - T_true[:, 4:7], axis=1)
    e1 = np.linalg.norm(poses4.cpu().numpy()[:, 4:7] - T_true[:, 4:7], axis=1)
    # the noise floor: ~0.75 per observation (3 rows of 0.5 px noise)
    print(f"  cost {cost0:.1f} -> {float(cost4):.1f} ({float(cost4) / n_obs:.3f} per observation); "
          f"keyframe positions off truth, median / largest: {np.median(e0) * 1e3:.2f} / "
          f"{e0.max() * 1e3:.2f} mm before, {np.median(e1) * 1e3:.2f} / {e1.max() * 1e3:.2f} after")
    if not float(cost4) < 0.1 * cost0:
        raise AssertionError("dist BA did not converge")

    poses1, _, _ = run(prob1, [dev], ITERS)
    d1 = float((poses1 - poses4).abs().max())
    print(f"  D = 1 vs D = 4 on the card: poses max diff {d1:.2e} (bound 1e-4)")
    if not d1 < 1e-4:
        raise AssertionError("shard count changed the poses")

    # card vs CPU on the CPU tests' problem; on the orbit at 8 keyframes x
    # 512 points (weakly held, 4 mm from truth after BA) as information
    for label, (intr_s, args_s), check in (
            ("the CPU tests' 5 keyframes x 256 points", _line_problem(), True),
            ("the orbit at 8 keyframes x 512 points", _ba_problem(8, 512, O, seed=4)[:2], False)):
        small = dist_ba.partition_problem(*args_s, n_shards=D, obs_per_point=O)
        pc, xc, _ = dist_ba.dist_bundle_adjust(small, intr_s, ["cpu"] * D, n_iters=ITERS)
        pg, xg, _ = run(small, on4, ITERS)
        pg2, xg2, _ = run(small, on4, ITERS)
        # a point seen by one keyframe hangs on its one stereo depth (up to
        # 9 m here): a 1-ulp jitter of the pixels moves it by up to 13.5 mm
        # on the CPU alone, so the 1e-3 bound holds points seen twice or more
        twice = torch.from_numpy((small.pt_obs >= 0).sum(-1) >= 2)
        dx = (xg.cpu() - xc).abs().amax(-1)
        dp_, dx_ = float((pg.cpu() - pc).abs().max()), float(dx[twice].max())
        print(f"  card vs CPU, {label}: poses {dp_:.2e} (1e-4), points seen twice or more "
              f"{dx_:.2e} (1e-3), seen once {float(dx[~twice].max()):.2e}; card vs card: poses "
              f"{float((pg - pg2).abs().max()):.2e}, points {float((xg - xg2).abs().max()):.2e}")
        if check and not (dp_ < 1e-4 and dx_ < 1e-3):
            raise AssertionError("dist BA: card and CPU disagree")

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    assert dist_ba.init_distributed(f"127.0.0.1:{port}", 1, 0)
    try:
        backend = torch.distributed.get_backend()
        stats = {}
        pn, xn, cn = run(prob, on4, ITERS, stats)
        buf = torch.zeros((6 * M + 1, 6 * M), device=dev)
        for _ in range(3):
            torch.distributed.all_reduce(buf)
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(20):
            torch.distributed.all_reduce(buf)
        b.record()
        b.synchronize()
        ar_ms = a.elapsed_time(b) / 20
    finally:
        torch.distributed.destroy_process_group()
    dn = float((pn - poses4).abs().max())
    per_iter = (stats["all_reduce_bytes"] - 4) / ITERS
    print(f"  world-size-1 {backend} group: poses vs no group {dn:.2e} (1e-4), "
          f"{stats['all_reduce_calls']} all_reduce calls, {per_iter / 1e6:.3f} MB per iteration "
          f"(S, b and the cost), all_reduce of the [{6 * M + 1}, {6 * M}] float32 buffer "
          f"{ar_ms:.4f} ms (CUDA events, mean of 20)")
    if backend != "nccl" or not dn < 1e-4 or stats["all_reduce_calls"] != 2 * ITERS + 1:
        raise AssertionError("dist BA through the NCCL group disagrees")
    return dict(ms_iter=ms_iter, ar_ms=ar_ms, syncs_iter=syncs_iter)


def _trajectory_through(sys_, kf_pose):
    """System.poses() with the keyframe poses of another store."""
    from spslam_tpu_torch.geometry import np_lie

    out = []
    for (ts, ref, T_rel), (_, T_abs) in zip(sys_._rel_trajectory, sys_.trajectory):
        ok = ref >= 0 and sys_.store.kf_valid[ref]
        out.append(np_lie.se3_compose(T_rel, kf_pose[ref]) if ok else T_abs)
    return np.stack(out)


def dist_gba_phase(loop):
    """The sharded global BA, and auto mode on one card, on copies of the
    loop path phase's map."""
    import torch

    from spslam_tpu_torch.eval.ate import ate_rmse
    from spslam_tpu_torch.solver import global_ba

    sys_, seq = loop["system"], loop["seq"]
    st = _store_copy(sys_.store)
    n_pts = int(st.pt_valid.sum())
    t0 = time.perf_counter()
    ran = global_ba.dist_global_bundle_adjust(st, seq.intr, n_shards=4,
                                              devices=[torch.device("cuda", 0)] * 4)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    ate = ate_rmse(_trajectory_through(sys_, st.kf_pose), seq.poses_gt)[0]
    print(f"  dist_global_bundle_adjust(n_shards=4, 4 x cuda:0) on the loop map "
          f"({int(st.kf_valid.sum())} keyframes, {n_pts} points): ran {ran}, {ms:.1f} ms, loop "
          f"ATE after it {ate * 1e3:.3f} mm (before {loop['ate'] * 1e3:.3f})")
    if not ran or not (np.isfinite(st.kf_pose).all() and np.isfinite(st.pt_pos).all()):
        raise AssertionError("sharded global BA did not run or is not finite")
    if not ate < 0.04:
        raise AssertionError(f"loop ATE after the sharded global BA {ate} m >= 0.04 m")
    st2 = _store_copy(sys_.store)
    saved = global_ba.GBA_MAX_Y_ELEMS
    global_ba.GBA_MAX_Y_ELEMS = 1000                    # the map is too big for the dense Y
    try:
        t0 = time.perf_counter()
        newton = global_ba.global_bundle_adjust(st2, seq.intr, device="cuda")
        torch.cuda.synchronize()
        ms2 = (time.perf_counter() - t0) * 1e3
    finally:
        global_ba.GBA_MAX_Y_ELEMS = saved
    ate2 = ate_rmse(_trajectory_through(sys_, st2.kf_pose), seq.poses_gt)[0]
    print(f"  auto mode past GBA_MAX_Y_ELEMS on {torch.cuda.device_count()} card(s): Newton "
          f"{newton} (the sharded solver declines with one device: 3x settle), {ms2:.1f} ms, "
          f"loop ATE after it {ate2 * 1e3:.3f} mm")
    if newton is not False or not np.isfinite(st2.kf_pose).all() or not ate2 < 0.04:
        raise AssertionError("auto-mode global BA fallback failed")


def async_path_phase(seq, sync_steady_ms):
    """System(async_mapping=True) on the 20-frame orbit."""
    import logging

    import torch

    from spslam_tpu_torch.eval.ate import ate_rmse
    from spslam_tpu_torch.ops import fast_cuda
    from spslam_tpu_torch.system import System, SystemConfig

    records = []

    class Keep(logging.Handler):
        def emit(self, record):
            records.append(record)

    logger = logging.getLogger("spslam_tpu_torch.tracking.pipeline")
    handler = Keep(level=logging.WARNING)
    logger.addHandler(handler)
    try:
        frames = _u8_u16(seq.frames)
        sys_ = System(SystemConfig(intr=seq.intr, local_ba=True, enable_reloc=False,
                                   async_mapping=True), device="cuda")
        fast_cuda.LAUNCHES = 0
        times = []
        for (gray, depth), ts in zip(frames, seq.timestamps):
            t1 = time.perf_counter()
            sys_.track_rgbd(gray, depth, ts)
            times.append(time.perf_counter() - t1)
        sys_.shutdown()
        torch.cuda.synchronize()
        launches = fast_cuda.LAUNCHES
    finally:
        logger.removeHandler(handler)
    pl = sys_.pipeline
    poses = sys_.poses()
    ate, _ = ate_rmse(poses, seq.poses_gt)
    n_lost = sum(1 for m in sys_.tracker.metrics if m["state"] == "LOST")
    steady = float(np.median(times[5:])) * 1e3
    print(f"  async: ATE {ate * 1e3:.3f} mm, LOST {n_lost}, keyframes submitted "
          f"{pl.n_submitted}, processed {pl.n_processed}, coalesced {pl.n_coalesced}, worker "
          f"errors {len(records)}, kernel launches {launches}; median steady {steady:.3f} ms per "
          f"track_rgbd call (frames 5..) vs {sync_steady_ms:.3f} synchronous (path phase)")
    if records:
        raise AssertionError(f"mapping worker logged: {records[0].getMessage()}")
    if not ate < 0.03 or n_lost or pl.n_processed != pl.n_submitted or not pl.idle():
        raise AssertionError("async path failed")
    if launches != len(frames):
        raise AssertionError(f"kernel launched {launches} times for {len(frames)} frames")
    return dict(launches=launches, steady_ms=steady)


def dp_phase(seq):
    """evaluate_sequences: two Systems on the card (the orbit of seeds 0
    and 7, len(seq.frames) frames each), frames round-robin."""
    import copy
    import warnings

    import torch

    from spslam_tpu_torch.io.synthetic import make_sequence
    from spslam_tpu_torch.ops import fast_cuda
    from spslam_tpu_torch.parallel.dp_eval import evaluate_sequences

    n = len(seq.frames)
    seqs = [copy.copy(seq), make_sequence(n_frames=n, seed=7)]
    for s in seqs:
        s.frames = _u8_u16(s.frames)
    # deterministic kernels, so that one sequence's run alone and in the
    # batch can be compared to 1e-6 (atomic scatter-adds vary in order)
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings(record=True) as warned:
            warnings.simplefilter("always")
            fast_cuda.LAUNCHES = 0
            results, fps = evaluate_sequences(seqs)
            launches = fast_cuda.LAUNCHES
            solo, solo_fps = evaluate_sequences(seqs[1:])
    finally:
        torch.use_deterministic_algorithms(False)
    nondet = sorted({str(w.message).split(" does not have a deterministic")[0]
                     for w in warned if "deterministic" in str(w.message)})
    for r in results:
        print(f"  dp {r.name} @ {r.device}: ATE {r.ate_rmse_m * 1e3:.3f} mm, {r.n_kf} keyframes, "
              f"{r.n_pts} points")
    diff = abs(results[1].ate_rmse_m - solo[0].ate_rmse_m)
    print(f"  dp: 2 Systems on one card, {fps:.3f} frames/s aggregate (one System alone "
          f"{solo_fps:.3f}), kernel launches {launches} for {2 * n} frames, sequence 1 batched vs "
          f"alone ATE diff {diff:.2e} (1e-6); ops without a deterministic kernel: {nondet or 'none'}")
    if any(not r.ate_rmse_m < 0.02 for r in results) or not diff <= 1e-6:
        raise AssertionError("dp evaluation failed")
    if launches != 2 * n:
        raise AssertionError(f"kernel launched {launches} times for {2 * n} frames")
    return dict(launches=launches, fps=fps)


def _write_png(path, img):
    """A PNG (8-bit gray / RGB, or 16-bit gray) through zlib and struct;
    rows filtered with types 0-4 in turn, so a reader meets all five."""
    import struct
    import zlib

    img = np.asarray(img)
    depth = 16 if img.dtype == np.uint16 else 8
    ctype = 2 if img.ndim == 3 else 0
    H, W = img.shape[:2]
    x = img.astype(">u2").view(np.uint8) if depth == 16 else img.astype(np.uint8)
    x = x.reshape(H, -1).astype(np.int32)
    bpp = x.shape[1] // W
    a = np.pad(x, ((0, 0), (bpp, 0)))[:, :-bpp]               # left
    b = np.pad(x, ((1, 0), (0, 0)))[:-1]                       # up
    c = np.pad(b, ((0, 0), (bpp, 0)))[:, :-bpp]                # up-left
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
    preds = [0 * x, a, b, (a + b) >> 1, paeth]
    kind = np.arange(H) % 5
    rows = np.empty((H, 1 + x.shape[1]), np.uint8)
    rows[:, 0] = kind
    for k in range(5):
        rows[kind == k, 1:] = (x - preds[k])[kind == k] & 255

    def chunk(tag, data):
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n"
                + chunk(b"IHDR", struct.pack(">IIBBBBB", W, H, depth, ctype, 0, 0, 0))
                + chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)) + chunk(b"IEND", b""))


def _write_tum_dir(root, seq):
    """seq in TUM layout: rgb/ (RGB PNGs), depth/ (16-bit), the lists,
    groundtruth.txt (T_wc) and a settings file with its camera."""
    from spslam_tpu_torch.geometry import np_lie

    for d in ("rgb", "depth"):
        os.makedirs(os.path.join(root, d), exist_ok=True)
    rgb_l, dep_l, gt_l = [], [], []
    for (gray, depth), ts, T_cw in zip(_u8_u16(seq.frames), seq.timestamps, seq.poses_gt):
        name = f"{ts:.6f}.png"
        _write_png(os.path.join(root, "rgb", name), np.repeat(gray[..., None], 3, -1))
        _write_png(os.path.join(root, "depth", name), depth)
        rgb_l.append(f"{ts:.6f} rgb/{name}")
        dep_l.append(f"{ts:.6f} depth/{name}")
        qw, qx, qy, qz, tx, ty, tz = np_lie.se3_inverse(T_cw)
        gt_l.append(f"{ts:.6f} {tx:.6f} {ty:.6f} {tz:.6f} {qx:.6f} {qy:.6f} {qz:.6f} {qw:.6f}")
    for name, lines in (("rgb.txt", rgb_l), ("depth.txt", dep_l), ("groundtruth.txt", gt_l)):
        with open(os.path.join(root, name), "w") as f:
            f.write("# ts\n" + "\n".join(lines) + "\n")
    i = seq.intr
    with open(os.path.join(root, "settings.yaml"), "w") as f:
        f.write(f"Camera.fx: {i.fx}\nCamera.fy: {i.fy}\nCamera.cx: {i.cx}\nCamera.cy: {i.cy}\n"
                f"Camera.bf: {i.bf}\nCamera.width: {i.width}\nCamera.height: {i.height}\n"
                "ThDepth: 3.2\nDepthMapFactor: 5000.0\nORBextractor.nFeatures: 1024\n"
                "ORBextractor.nLevels: 8\nORBextractor.scaleFactor: 1.2\n"
                "ORBextractor.iniThFAST: 20\nORBextractor.minThFAST: 7\n")


# runs the CLI module as `python -m spslam_tpu_torch.cli` does, then prints
# the kernel's launch count of that process
_CLI = ("import runpy, sys; sys.argv[0] = 'spslam_tpu_torch.cli'; "
        "runpy.run_module('spslam_tpu_torch.cli', run_name='__main__'); "
        "from spslam_tpu_torch.ops import fast_cuda; print('B1_LAUNCHES', fast_cuda.LAUNCHES)")


def cli_native_phase(seq, loop):
    """The CLI on a TUM-layout directory (loop closing, async mapping) in a
    subprocess, and the port's native library built on this machine."""
    import tempfile

    from spslam_tpu_torch.io.tum import load_tum_sequence
    from spslam_tpu_torch.native import bindings

    root = tempfile.mkdtemp(prefix="tum_")
    try:
        t0 = time.perf_counter()
        _write_tum_dir(root, seq)
        back = load_tum_sequence(root, os.path.join(root, "settings.yaml"))
        same = all(np.array_equal(g, np.clip(g0, 0, 255).astype(np.uint8))
                   for (g, _), (g0, _) in zip(back.frames, seq.frames))
        print(f"  wrote and read back {len(back.frames)} TUM frames in "
              f"{time.perf_counter() - t0:.1f} s (gray equal to the written frames: {same})")
        if not same or len(back.frames) != len(seq.frames):
            raise AssertionError("TUM round trip failed")
        cmd = [sys.executable, "-c", _CLI, "--tum", root, "--config",
               os.path.join(root, "settings.yaml"), "--loop", "--async-mapping",
               "--traj-out", os.path.join(root, "traj.txt")]
        t0 = time.perf_counter()
        res = subprocess.run(cmd, capture_output=True, text=True, timeout=600,
                             cwd=os.path.dirname(os.path.abspath(__file__)))
        wall = time.perf_counter() - t0
    finally:
        import shutil

        shutil.rmtree(root, ignore_errors=True)
    lines = res.stdout.splitlines()
    print("  cli: " + "\n  cli: ".join(lines[-6:]))
    if res.returncode != 0:
        raise AssertionError(f"cli exited {res.returncode}:\n{res.stderr[-3000:]}")
    stats = json.loads([x for x in lines if x.startswith("{")][-1])
    launches = int([x for x in lines if x.startswith("B1_LAUNCHES")][-1].split()[1])
    print(f"  cli subprocess {wall:.1f} s, ATE {stats['ate_rmse_m'] * 1e3:.3f} mm, kernel "
          f"launches {launches} for {len(seq.frames)} frames")
    if not stats["ate_rmse_m"] < 0.04:
        raise AssertionError(f"cli ATE {stats['ate_rmse_m']} m >= 0.04 m")
    if launches != len(seq.frames):
        raise AssertionError(f"kernel launched {launches} times for {len(seq.frames)} frames")
    lib = bindings.get_lib()
    kfdb = loop["system"].loop_closer.kfdb
    print(f"  native library {bindings.LIB_PATH} loaded {lib is not None}, built by this process "
          f"{bindings.BUILT_HERE}; the loop phase's keyframe database native {kfdb.is_native}")
    here = os.path.join(os.path.dirname(os.path.abspath(__file__)), "spslam_tpu_torch", "_build")
    if lib is None or os.path.dirname(bindings.LIB_PATH) != here or not kfdb.is_native:
        raise AssertionError("the native library did not build or load")
    return dict(launches=launches)


def _rows_in_common(a, b) -> float:
    """Descriptor rows two pools share, as multisets, over the larger pool
    (a keypoint at a FAST threshold shifts the later rows of its level)."""
    from collections import Counter

    common = Counter(map(bytes, a)) & Counter(map(bytes, b))
    return sum(common.values()) / max(len(a), len(b))


def vocab_phase(card):
    """The vocabulary trainer (loop/train_vocab.py) at full size on the
    card: 4 rooms x 12 views of 640x480, 8 levels, 1,024 features, one B1
    launch per view; k-means of 4,096 words on the card and on the CPU from
    the same pool and draw, bit for bit; room 0 built on the CPU too; the
    saved file read back."""
    import tempfile

    import torch

    from spslam_tpu_torch.loop.train_vocab import collect_training_descriptors, train_vocabulary
    from spslam_tpu_torch.loop.vocab import Vocabulary, quantize
    from spslam_tpu_torch.ops import fast_cuda
    from spslam_tpu_torch.ops.brief import unpack_bits

    fast_cuda.LAUNCHES = 0
    t0 = time.perf_counter()
    pool = collect_training_descriptors(device="cuda")
    torch.cuda.synchronize()
    collect_s = time.perf_counter() - t0
    launches = fast_cuda.LAUNCHES
    print(f"  collect: {launches} kernel launches for 48 views, {len(pool)} descriptors, "
          f"{collect_s:.2f} s (renderer included)")
    if launches != 48:
        raise AssertionError(f"kernel launched {launches} times for 48 views")
    if pool.dtype != np.uint32 or pool.ndim != 2 or pool.shape[1] != 8 or len(pool) < 4 * 4096:
        raise AssertionError(f"bad descriptor pool {pool.dtype} {pool.shape}")

    # room 0 again on the card and on the CPU (launches not counted)
    room0 = collect_training_descriptors(rooms=1, device="cuda")
    room0_cpu = collect_training_descriptors(rooms=1, device="cpu")
    same_run = np.array_equal(room0, pool[: len(room0)])
    common = _rows_in_common(room0, room0_cpu)
    print(f"  room 0 (12 views): card {len(room0)} vs CPU {len(room0_cpu)} descriptors, rows in "
          f"common {common:.5f} (bound 0.99); card rerun equal to the first run: {same_run}")
    if not same_run:
        raise AssertionError("room 0 on the card differs between two runs")
    if common < 0.99 or abs(len(room0) - len(room0_cpu)) > 0.01 * len(room0_cpu):
        raise AssertionError("the card's descriptors disagree with the CPU's")

    init_idx = torch.randperm(len(pool), generator=torch.Generator().manual_seed(0))[:4096]
    t0 = time.perf_counter()
    voc = train_vocabulary(pool, 4096, init_idx=init_idx, device="cuda")
    torch.cuda.synchronize()
    kmeans_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    voc_cpu = train_vocabulary(pool, 4096, init_idx=init_idx, device="cpu")
    kmeans_cpu_s = time.perf_counter() - t0
    bits, bits_cpu = voc.vocab_bits.cpu().numpy(), voc_cpu.vocab_bits.numpy()
    n_bits_diff = int((bits != bits_cpu).sum())
    print(f"  k-means 4096 words x 8 iterations on {len(pool)} descriptors: card "
          f"{kmeans_s * 1e3:.1f} ms, CPU {kmeans_cpu_s * 1e3:.1f} ms (idf included); bits "
          f"differing card vs CPU {n_bits_diff}, idf equal {np.array_equal(voc.idf, voc_cpu.idf)}")
    if n_bits_diff or not np.array_equal(voc.idf, voc_cpu.idf):
        raise AssertionError("the card's vocabulary differs from the CPU's")

    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "vocab.npz")
        voc.save(path)
        size = os.path.getsize(path)
        back = Vocabulary(n_words=4096, device="cuda")
        back.load(path)
    d_pool = np.ascontiguousarray(pool).view(np.int32)
    pool_bits = unpack_bits(torch.from_numpy(d_pool).cuda())
    valid = torch.ones(len(pool), dtype=torch.bool, device="cuda")
    words = quantize(pool_bits, voc.vocab_bits, valid).cpu().numpy()
    words_back = quantize(pool_bits, back.vocab_bits, valid).cpu().numpy()
    used = len(np.unique(words))
    print(f"  saved {size} bytes; words of the pool after load equal: "
          f"{np.array_equal(words, words_back)}; {used} of 4096 words used ({card})")
    if not np.array_equal(words, words_back) or not np.array_equal(back.idf, voc.idf):
        raise AssertionError("the saved vocabulary does not read back")
    return dict(launches=launches, collect_s=collect_s, kmeans_s=kmeans_s, n_desc=len(pool),
                bytes=size, pool=pool)


def api_phase(path):
    """The reference's public surface on the card against the CPU on seeded
    inputs: the Sim(3) group and SE(3) matrix conversions at 1e-5, the
    projection at pixel scale, and rpe_rmse of the path phase's run.

    sim3_exp (and sim3_log, which rebuilds W with it) take the reference's
    (e^sigma - 1) / sigma for |sigma| >= 1e-6: an ulp of e^sigma is
    2^-23 s / |sigma| of that coefficient, and the card's expf and the
    CPU's exp may round apart.  Their rows get 2 ulps of it on top of 1e-5:
    2^-22 max(s, 1) |rho| / |sigma| (the CPU's float32 itself is 7.9e-5 off
    float64 at sigma = 3e-4, 0.3-0.4x of one ulp's term)."""
    import torch

    from spslam_tpu_torch.eval.ate import rpe_rmse
    from spslam_tpu_torch.geometry import (
        Intrinsics, project_with_depth, se3_exp, se3_from_matrix, se3_matrix, sim3_compose,
        sim3_exp, sim3_inverse, sim3_log)

    rng = np.random.default_rng(21)
    xi = (0.4 * rng.normal(size=(4096, 7))).astype(np.float32)
    xi[:64, 3:6] = 0.0                         # the small-angle and small-scale branches
    xi[32:96, 6] = 0.0
    cpu = lambda fn, *a: fn(*(torch.from_numpy(x) for x in a)).numpy()   # noqa: E731
    S = cpu(sim3_exp, xi)
    S2 = cpu(sim3_exp, (0.4 * rng.normal(size=(4096, 7))).astype(np.float32))
    T = cpu(se3_exp, (0.5 * rng.normal(size=(4096, 6))).astype(np.float32))
    xc = np.concatenate([rng.normal(0, 1, (4096, 2)), rng.uniform(0.3, 6, (4096, 1))],
                        axis=-1).astype(np.float32)
    intr = Intrinsics(fx=525.0, fy=525.0, cx=319.5, cy=239.5, bf=40.0)
    sigma = np.abs(xi[:, 6])
    cond = np.where(sigma >= 1e-6, 2.0 ** -22 * np.maximum(np.exp(xi[:, 6]), 1.0)
                    * np.abs(xi[:, :3]).max(axis=1) / np.maximum(sigma, 1e-6), 0.0)
    cases = {   # name: (fn, inputs, abs bound per row, relative bound)
        "sim3_exp": (sim3_exp, (xi,), 1e-5 + cond, 0.0),
        "sim3_log": (sim3_log, (S,), 1e-5 + cond, 0.0),
        "sim3_compose": (sim3_compose, (S, S2), 1e-5, 0.0),
        "sim3_inverse": (sim3_inverse, (S,), 1e-5, 0.0),
        "se3_matrix": (se3_matrix, (T,), 1e-5, 0.0),
        "se3_from_matrix": (se3_from_matrix, (cpu(se3_matrix, T),), 1e-5, 0.0),
        # test_torch_geometry.py's pixel tolerance: 1e-6 relative, 1e-6 of 640 px
        "project_with_depth": (lambda x: project_with_depth(intr, x), (xc,), 6.4e-4, 1e-6),
    }
    print(f"  {int((cond > 1e-5).sum())} of 4096 sim3 rows with the cancellation term above 1e-5")
    for name, (fn, args, atol, rtol) in cases.items():
        got = fn(*(torch.from_numpy(x).cuda() for x in args)).cpu().numpy()
        want = cpu(fn, *args)
        diff = np.abs(got - want).reshape(len(got), -1)
        bound = np.reshape(atol, (-1, 1)) + rtol * np.abs(want).reshape(len(got), -1)
        rest = (f", {float(diff[cond < 1e-6].max()):.3g} on the rows where it is below 1e-6"
                if np.ndim(atol) else "")
        print(f"  {name}: card vs CPU max abs diff {float(diff.max()):.3g}{rest}; worst diff / "
              f"bound {float((diff / bound).max()):.3f}; finite {bool(np.isfinite(got).all())}")
        if not np.all(diff <= bound) or not np.isfinite(got).all():
            raise AssertionError(f"{name} on the card disagrees with the CPU")
    rpe, errs = rpe_rmse(path["poses"], path["poses_gt"])
    print(f"  path phase's run: RPE {rpe * 1e3:.3f} mm per frame over {len(errs)} pairs, "
          f"ATE {path['ate'] * 1e3:.3f} mm")
    if not np.isfinite(rpe) or len(errs) != len(path["poses"]) - 1:
        raise AssertionError(f"bad rpe_rmse {rpe} over {len(errs)} pairs")


# runs the bench module as `python -m spslam_tpu_torch.bench` does (its
# sys.exit included), then prints the kernel's launch count of that process
_BENCH = ("import runpy, sys; sys.argv[0] = 'spslam_tpu_torch.bench'\n"
          "try:\n    runpy.run_module('spslam_tpu_torch.bench', run_name='__main__')\n"
          "finally:\n    from spslam_tpu_torch.ops import fast_cuda\n"
          "    print('B1_LAUNCHES', fast_cuda.LAUNCHES)")
BENCH_KEYS = {"metric", "value", "unit", "vs_baseline", "ate_rmse_m", "point_passes",
              "planes_fps", "planes_ate_rmse_m", "plane_passes"}


# the renders the phases read from the bench's cache (data/.bench_cache_torch_*),
# in the order the phases need them: (tag, make_sequence kwargs)
RENDERS = (("torch_lowtex30", dict(n_frames=30, low_texture=True, depth_noise=0.008, seed=7)),
           ("torch_loop64", dict(n_frames=64, trajectory="loop", depth_noise=0.004)),
           ("torch_loop128", dict(n_frames=128, trajectory="loop", depth_noise=0.004)),
           (f"torch_orbit{BENCH_FRAMES}", dict(n_frames=BENCH_FRAMES)))
_PRERENDER = ("from spslam_tpu_torch.bench import cached_sequence\n"
              f"for tag, kw in {RENDERS!r}:\n"
              "    cached_sequence(tag, **kw)")


def _rendered(i):
    """RENDERS[i] with float frames, from the cache the prerender process
    fills, or rendered here when it is not there yet."""
    from spslam_tpu_torch.bench import load_cached
    from spslam_tpu_torch.io.synthetic import make_sequence

    tag, kw = RENDERS[i]
    t0 = time.perf_counter()
    seq = load_cached(tag, **kw)
    how = "read from the prerender's cache"
    if seq is None:
        seq, how = make_sequence(**kw), "rendered"
    print(f"  {tag}: {len(seq.frames)} frames {how} in {time.perf_counter() - t0:.1f} s")
    return seq


def bench_phase(prerender):
    """The port's bench (point and planes lanes, one pass each) in a
    subprocess, as a user runs it, once `prerender` (the process rendering
    its BENCH_FRAMES frames into the bench's cache while the earlier phases ran) has
    ended."""
    t0 = time.perf_counter()
    rc = prerender.wait(timeout=600)
    print(f"  the bench's render (niced, beside the earlier phases) ended with {rc}; waited "
          f"{time.perf_counter() - t0:.1f} s for it")
    env = dict(os.environ, BENCH_FRAMES=str(BENCH_FRAMES), BENCH_PASSES="1", BENCH_LOWTEX="0",
               BENCH_LOOP="0")
    t0 = time.perf_counter()
    res = subprocess.run([sys.executable, "-c", _BENCH], capture_output=True, text=True,
                         timeout=900, env=env, cwd=os.path.dirname(os.path.abspath(__file__)))
    wall = time.perf_counter() - t0
    print("  bench: " + "\n  bench: ".join(res.stderr.strip().splitlines()[-12:]))
    if res.returncode != 0:
        raise AssertionError(f"bench exited {res.returncode}:\n{res.stderr[-3000:]}")
    lines = res.stdout.splitlines()
    out = json.loads([x for x in lines if x.startswith("{")][-1])
    launches = int([x for x in lines if x.startswith("B1_LAUNCHES")][-1].split()[1])
    frames = 2 * (12 + BENCH_FRAMES)
    print(f"  bench subprocess {wall:.1f} s: {json.dumps(out)}")
    print(f"  kernel launches {launches} for {frames} frames fed (two 12-frame warm-ups, "
          f"two {BENCH_FRAMES}-frame passes)")
    if set(out) != BENCH_KEYS:
        raise AssertionError(f"bench keys {sorted(out)} are not the reference's")
    if not (out["ate_rmse_m"] < 0.02 and out["planes_ate_rmse_m"] < 0.02):
        raise AssertionError(f"bench ATE {out['ate_rmse_m']} / {out['planes_ate_rmse_m']} m")
    if launches != frames:
        raise AssertionError(f"kernel launched {launches} times for {frames} frames")
    return dict(launches=launches)


def host_sections_phase(seq):
    """tools/profile_host on seq's frames, 1 pass."""
    from spslam_tpu_torch.ops import fast_cuda
    from spslam_tpu_torch.tools.profile_host import SECTIONS, profile, report

    fast_cuda.LAUNCHES = 0
    res = profile(seq, n_passes=1, device="cuda")[0]
    launches = fast_cuda.LAUNCHES
    # the tool's warm-up tracks the first 12 frames (all of them, when fewer)
    frames = min(12, len(seq.frames)) + len(seq.frames)
    acct_ms = report(0, res)
    perf = res["perf"]
    acct_s = sum(perf.values())
    fired = [k for k in SECTIONS if k in perf]
    print(f"  sections accumulated: {', '.join(fired)}; {res['n']} frames resolved from the "
          f"fused step; accounted {acct_s:.3f} s of the pass's {res['wall']:.3f} s wall "
          f"({acct_ms:.2f} ms per resolved frame); kernel launches {launches} for "
          f"{frames} frames")
    if set(perf) - set(SECTIONS):
        raise AssertionError(f"sections outside the reference's: {set(perf) - set(SECTIONS)}")
    every_frame = ("upload", "snapshot", "dispatch", "wait_small", "decode", "need_kf")
    if res["n"] <= 0 or any(k not in perf for k in every_frame):
        raise AssertionError("a per-frame section was never timed")
    if not acct_s <= res["wall"]:
        raise AssertionError(f"accounted {acct_s} s > wall {res['wall']} s")
    if launches != frames:
        raise AssertionError(f"kernel launched {launches} times for {frames} frames")
    return dict(launches=launches)


def weak_scaling_phase():
    """tools/weak_scaling's fixed-total-work sweep, D = 1, 2, 4."""
    from spslam_tpu_torch.parallel.dist_ba import global_mesh
    from spslam_tpu_torch.tools import weak_scaling

    poses, fixed, pts, *obs = weak_scaling.make_problem(4096 * 4)
    rng = np.random.default_rng(3)
    pts = (pts + rng.normal(0, 0.05, pts.shape)).astype(np.float32)
    visible = global_mesh()
    results = weak_scaling.sweep((poses, fixed, pts, *obs), [1, 2, 4], visible, iters=10)
    print(json.dumps(weak_scaling.summarize(results, len(visible))))
    for r in results:
        if not (np.isfinite(r["cost"]) and r["cost"] < r["cost0"]):
            raise AssertionError(f"D={r['D']}: cost {r['cost0']} -> {r['cost']}")


def recall_phase(loop_seq, pool):
    """tools/vocab_recall's sweep at --quick's sizes on the card, on the
    loop path phase's sequence and the vocab phase's training pool."""
    import torch

    from spslam_tpu_torch.ops import fast_cuda
    from spslam_tpu_torch.tools import vocab_recall as vr

    fast_cuda.LAUNCHES = 0
    t0 = time.perf_counter()
    eval_set = [vr.eval_entry(loop_seq, "loop64", "cuda")]
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    launches = fast_cuda.LAUNCHES
    n_built = len(eval_set[0]["kfs"])
    t0 = time.perf_counter()
    rows = vr.sweep(pool, eval_set, [4096, 16384], device="cuda")
    sweep_s = time.perf_counter() - t0
    print(f"  eval frames built in {build_s:.1f} s, training pool {len(pool)} descriptors, "
          f"k-means and evaluation {sweep_s:.1f} s; kernel launches {launches} for {n_built} "
          f"frames built")
    if not rows or any(not (0 <= r <= 1 and 0 <= p <= 1 and q > 0) for _, _, r, p, q in rows):
        raise AssertionError(f"bad recall rows {rows}")
    if launches != n_built:
        raise AssertionError(f"kernel launched {launches} times for {n_built} frames")
    return dict(launches=launches)


def tools_phase(seq):
    """tools/ate_debug, profile_frame, profile_fused, profile_ab,
    profile_pipeline, profile_tunnel and profile_xfer in-process at small
    repetition counts; one kernel launch per frame each tool builds."""
    import torch

    from spslam_tpu_torch.ops import fast_cuda
    from spslam_tpu_torch.tools import (ate_debug, profile_ab, profile_frame, profile_fused,
                                        profile_pipeline, profile_tunnel, profile_xfer)
    from spslam_tpu_torch.tracking.tracker import TrackerConfig

    dev = torch.device("cuda", torch.cuda.current_device())
    cfg = TrackerConfig()
    total = 0

    def counted(name, fn, frames_of):
        nonlocal total
        fast_cuda.LAUNCHES = 0
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        launches, frames = fast_cuda.LAUNCHES, frames_of(out)
        print(f"  {name}: {time.perf_counter() - t0:.1f} s, kernel launches {launches} for "
              f"{frames} frames built")
        if launches != frames:
            raise AssertionError(f"{name}: kernel launched {launches} times for {frames} frames")
        total += launches
        return out

    ate_seq = _head(seq, ATE_FRAMES)
    runs = counted("ate_debug", lambda: [ate_debug.run(ate_seq, m, dev) for m in ("sync", "async")],
                   lambda rs: len(rs) * ATE_FRAMES)
    for r in runs:
        print("    " + ate_debug.line(r))
    if not (runs[0]["ate"] < 0.02 and runs[1]["ate"] < 0.03):
        raise AssertionError(f"ate_debug ATE {runs[0]['ate']} / {runs[1]['ate']} m")

    r = counted("profile_frame", lambda: profile_frame.profile(seq, cfg, dev, TOOL_N, 2),
                lambda r: r["_frames"])
    for k, v in r.items():
        if not k.startswith("_"):
            print(f"    {k:32s} {v:9.3f} ms")
    rows = counted("profile_fused", lambda: profile_fused.profile(seq, cfg, dev, TOOL_N),
                   lambda rows: len(rows) * (TOOL_N + 2))
    for name, ms, k in rows:
        print(f"    {name:36s} {ms:9.2f} ms per chained step, {k} kernels per step")
    if not all(k and k > 0 for *_, k in rows):
        raise AssertionError("profile_fused counted no kernel in a case")
    ra, rb = counted("profile_ab", lambda: profile_ab.profile(seq, cfg, dev, TOOL_N, 2),
                     lambda out: 2 * (1 + 2) * TOOL_N)
    print(f"    real track_frame_step {['%.2f' % v for v in ra]} ms, replica "
          f"{['%.2f' % v for v in rb]} ms per step")
    x = profile_frame.fused_inputs(seq, cfg, dev)
    hv = torch.tensor(True, device=dev)
    want, got = counted("the step and its replica once", lambda: (
        profile_frame.real_step(x, x["T0"], x["T0"], hv),
        profile_ab.replica(x, x["T0"], x["T0"], hv)), lambda out: 2)
    same = [torch.equal(g, w) for g, w in zip(got[1:], want[1:])]
    print(f"    replica's out_small, out_big equal to the step's on the card: {same} "
          f"(bit for bit on the CPU, tests/test_torch_tools_diag.py)")
    r = counted("profile_pipeline", lambda: profile_pipeline.profile(seq, cfg, dev, TOOL_N),
                lambda r: r["_frames"])
    for k, v in r.items():
        if not k.startswith("_"):
            print(f"    {k:40s} {v:9.3f} ms/frame")
    times = [ms for _, ms, _ in rows] + ra + rb + [v for k, v in r.items() if k[0] != "_"]
    rows_t = profile_tunnel.profile(seq, dev, TOOL_N)
    for label, page, pin in rows_t:
        print(f"    tunnel {label:22s} pageable {page:7.3f} ms, pinned {pin:7.3f} ms")
    curve = profile_xfer.size_curve(dev)
    for kb, direction, memory, ms in curve:
        print(f"    xfer {direction:4s} {memory:8s} {kb:6d} KB {ms:8.3f} ms "
              f"({kb / 1024 / ms * 1000:8.1f} MB/s)")
    par, seq_ms = profile_xfer.two_threads(dev)
    print(f"    xfer 614 + 307 KB uploads: two threads {par:.3f} ms, in sequence {seq_ms:.3f} ms")
    times += [v for _, a, b in rows_t for v in (a, b)] + [ms for *_, ms in curve] + [par, seq_ms]
    if not all(np.isfinite(t) and t > 0 for t in times):
        raise AssertionError("a tool measured a time that is not finite and positive")
    return dict(launches=total)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from spslam_tpu_torch.io.synthetic import make_sequence
    from spslam_tpu_torch.ops import fast_cuda
    from spslam_tpu_torch.ops.pyramid import PyramidSpec

    # cuBLAS's deterministic mode (the dp phase) needs a fixed workspace,
    # set before the first cuBLAS handle
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
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
    # a single-threaded numpy render at the lowest priority, so the timed
    # phases keep the host's other cores
    prerender = subprocess.Popen(
        [sys.executable, "-c", _PRERENDER], cwd=os.path.dirname(os.path.abspath(__file__)),
        env=dict(os.environ, OMP_NUM_THREADS="1", OPENBLAS_NUM_THREADS="1", MKL_NUM_THREADS="1"),
        stdout=subprocess.DEVNULL, preexec_fn=lambda: os.nice(19))
    try:
        return _phases(t_start, card, spec, seq, prerender)
    finally:
        if prerender.poll() is None:
            prerender.kill()
            prerender.wait()


def _phases(t_start, card, spec, seq, prerender) -> int:
    import torch

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
    phase("BA graph", ba_graph_phase, path)
    phase("fuse graph", fuse_graph_phase, path)
    phase("segmentation", segmentation_phase, seq)
    planes = phase("planes path", planes_path_phase)
    phase("loop ops", loop_ops_phase, seq)
    loop = phase("loop path", loop_path_phase)
    reloc = phase("relocalization", reloc_phase)
    lane = phase("loop lane", loop_lane_phase, prerender)
    phase("dist BA", dist_ba_phase)
    phase("dist GBA", dist_gba_phase, loop)
    async_ = phase("async path", async_path_phase, seq, path["steady_ms"])
    short = _head(seq, SHORT_FRAMES)
    dp = phase("dp", dp_phase, short)
    cli = phase("cli and native", cli_native_phase, short, loop)
    vocab = phase("vocab", vocab_phase, card)
    phase("api", api_phase, path)
    bench = phase("bench", bench_phase, prerender)
    host = phase("host sections", host_sections_phase, short)
    phase("weak scaling", weak_scaling_phase)
    recall = phase("recall", recall_phase, loop["seq"], vocab["pool"])
    tools = phase("tools", tools_phase, seq)

    kernels = [dict(
        name="fast_nms", route="cuda", source="spslam_tpu_torch/csrc/fast_nms.cu",
        replaces="spslam_tpu/ops/fast_pallas.py:99",
        # every path's run: point, planes, loop, relocalization, async,
        # the loop lane, data-parallel (2 Systems), the CLI's subprocess, the
        # vocabulary trainer, the bench's subprocess, the host sections, the
        # recall and the tools
        launches=sum(r["launches"] for r in (path, planes, loop, reloc, lane, async_, dp, cli,
                                             vocab, bench, host, recall, tools)),
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
