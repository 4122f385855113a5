"""Steady-state decomposition of the tracking pipeline: what bounds
ms/frame on the card (port of tools/profile_pipeline.py).

  A.  device throughput: n chained track_frame_step calls on one uploaded
      frame, one sync at the end;
  B.  H2D upload of n distinct u8 grays and strided u16 depths
      (Tracker._upload_frame's layout), one sync at the end: from pageable
      and from pinned host memory;
  B2. upload + dispatch, no D2H;
  C.  + the async D2H of the small output into pinned memory
      (tracking/tracker._to_host_async, one CUDA event per frame), drained
      2 behind;
  E1. build_frame alone; E2/E3 each match + pose optimization stage alone
      (radius 22 2x5, radius 6 4x10); E4 search_by_projection alone; E5 the
      4x10 pose optimization alone, on the step's compacted rows;
  D.  the full Tracker.process_pipelined / flush_pipeline loop on the
      orbit (keyframe insertion and host logic included).

    python -m spslam_tpu_torch.tools.profile_pipeline [--device cpu] [n_iters]
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch


def _per_frame_ms(t0: float, n: int) -> float:
    return (time.perf_counter() - t0) / n * 1e3


def profile(seq, cfg, device, n: int = 40) -> dict:
    """Stage label -> ms per frame; '_frames' counts the frames built (one
    FAST+NMS launch each on the card).  Stage D runs the orbit of min(n,
    40) frames."""
    from ..bench import quantized
    from ..frontend.frame import build_frame
    from ..map.store import MapConfig, MapStore
    from ..ops.brief import unpack_bits
    from ..ops.match import TH_HIGH, search_by_projection
    from ..solver.robust import octave_inv_sigma2
    from ..tracking.tracker import (Tracker, _compact_pose_opt, _match_and_optimize,
                                    _to_host_async, decode_depth, project_points)
    from .profile_frame import fused_inputs, real_step, sync

    x = fused_inputs(seq, cfg, device)
    s = cfg.depth_upload_stride
    u8u16 = quantized(seq.frames)
    grays = [g for g, _ in u8u16]
    depths = [np.ascontiguousarray(d[::s, ::s]).view(np.int16) for _, d in u8u16]
    hv = torch.tensor(True, device=device)
    r, frames = {}, 0

    def step(g, d, T, T2):
        return real_step(dict(x, gray=g, depth=d), T, T2, hv)

    step(x["gray"], x["depth"], x["T0"], x["T0"])
    sync(device)
    frames += 1

    # A: device throughput
    t0 = time.perf_counter()
    T = T2 = x["T0"]
    for _ in range(n):
        _, small, _ = step(x["gray"], x["depth"], T, T2)
        T2, T = T, small[0:7].view(torch.float32)
    sync(device)
    r["A. device-only throughput"] = _per_frame_ms(t0, n)
    frames += n

    # B: uploads, pageable and pinned
    bufs = [(grays[i % len(grays)].copy(), depths[i % len(depths)].copy()) for i in range(n)]
    kb = (bufs[0][0].nbytes + bufs[0][1].nbytes) / 1024
    t0 = time.perf_counter()
    for g, d in bufs:
        torch.from_numpy(g).to(device, non_blocking=True)
        torch.from_numpy(d).to(device, non_blocking=True)
    sync(device)
    r[f"B. H2D upload, pageable ({kb:.0f} KB/frame)"] = _per_frame_ms(t0, n)
    pin = device.type == "cuda"
    pinned = [(torch.from_numpy(g).pin_memory() if pin else torch.from_numpy(g),
               torch.from_numpy(d).pin_memory() if pin else torch.from_numpy(d))
              for g, d in bufs]
    t0 = time.perf_counter()
    for g, d in pinned:
        g.to(device, non_blocking=True)
        d.to(device, non_blocking=True)
    sync(device)
    r[f"B. H2D upload, pinned ({kb:.0f} KB/frame)"] = _per_frame_ms(t0, n)

    # B2: upload + dispatch
    t0 = time.perf_counter()
    T = T2 = x["T0"]
    for g, d in bufs:
        _, small, _ = step(torch.from_numpy(g).to(device, non_blocking=True),
                           torch.from_numpy(d).to(device, non_blocking=True), T, T2)
        T2, T = T, small[0:7].view(torch.float32)
    sync(device)
    r["B2. upload+dispatch (no D2H)"] = _per_frame_ms(t0, n)
    frames += n

    # C: + async D2H of the small output, drained 2 behind
    t0 = time.perf_counter()
    T = T2 = x["T0"]
    pend = []
    for g, d in bufs:
        _, small, _ = step(torch.from_numpy(g).to(device, non_blocking=True),
                           torch.from_numpy(d).to(device, non_blocking=True), T, T2)
        T2, T = T, small[0:7].view(torch.float32)
        host = _to_host_async(small)
        ev = None
        if device.type == "cuda":
            ev = torch.cuda.Event()
            ev.record()
        pend.append((host, ev))
        while len(pend) > 2:
            h, e = pend.pop(0)
            if e is not None:
                e.synchronize()
            h.numpy()
    for h, e in pend:
        if e is not None:
            e.synchronize()
        h.numpy()
    r["C. +small-buffer D2H drain"] = _per_frame_ms(t0, n)
    frames += n

    # E: the stages alone, chained, one sync each
    spec, intr = x["spec"], x["intr"]
    gray_f = x["gray"].to(torch.float32)
    depth_f = decode_depth(x["depth"], 5000.0)

    def bf():
        return build_frame(gray_f, depth_f, spec, intr, n_features=cfg.n_features,
                           th_high=cfg.th_fast_high, th_low=cfg.th_fast_low)

    fr = bf()
    sync(device)
    t0 = time.perf_counter()
    for _ in range(n):
        fr = bf()
    sync(device)
    r["E1. build_frame device-only"] = _per_frame_ms(t0, n)
    frames += 1 + n

    pt = x["pack"]
    pos, nrm, mind, maxd, pv = pt[:, 0:3], pt[:, 3:6], pt[:, 6], pt[:, 7], pt[:, 8] > 0.5
    bits = unpack_bits(x["desc"])
    for label, rad, nr, ni in (("E2", cfg.motion_search_radius, 2, 5),
                               ("E3", cfg.local_search_radius, 4, 10)):
        T = _match_and_optimize(x["T0"], pos, nrm, mind, maxd, bits, pv, fr, rad, TH_HIGH,
                                intr, n_rounds=nr, n_iters=ni)[0].T_cw
        sync(device)
        t0 = time.perf_counter()
        for _ in range(n):
            T = _match_and_optimize(T, pos, nrm, mind, maxd, bits, pv, fr, rad, TH_HIGH,
                                    intr, n_rounds=nr, n_iters=ni)[0].T_cw
        sync(device)
        r[f"{label}. match+opt ({nr}x{ni})"] = _per_frame_ms(t0, n)

    def match_only():
        uv, ok, op, _ = project_points(x["T0"], pos, nrm, mind, maxd, pv, intr)
        rad = cfg.local_search_radius * torch.pow(1.2, op.to(torch.float32))
        return search_by_projection(uv, bits, ok, op, fr.uv, fr.bits, fr.valid, fr.octave, rad,
                                    max_dist=TH_HIGH, ratio=0.95, octave_slack=1).idx

    match_only()
    sync(device)
    t0 = time.perf_counter()
    for _ in range(n):
        match_only()
    sync(device)
    r["E4. search_by_projection only"] = _per_frame_ms(t0, n)

    kp = torch.zeros(pos.shape[0], dtype=torch.long, device=device)
    ur = torch.full((pos.shape[0],), -1.0, device=device)
    inv_s2 = octave_inv_sigma2(fr.octave[kp])

    def opt_only(T):
        return _compact_pose_opt(T, pos, fr.uv[kp], ur, inv_s2, pv, fr.uv.shape[0], intr,
                                 4, 10).T_cw

    T = opt_only(x["T0"])
    sync(device)
    t0 = time.perf_counter()
    for _ in range(n):
        T = opt_only(T)
    sync(device)
    r["E5. pose_optimization (4x10)"] = _per_frame_ms(t0, n)

    # D: the full pipelined tracking loop
    from ..io.synthetic import make_sequence

    seq_d = make_sequence(n_frames=min(n, 40))
    map_cfg = MapConfig(n_kp=cfg.n_features)
    tr = Tracker(cfg, seq_d.intr, MapStore(map_cfg), device=device)
    for g, d in seq_d.frames[:3]:
        tr.process_pipelined(g, d, 0.0)
    tr.flush_pipeline()
    tr = Tracker(cfg, seq_d.intr, MapStore(map_cfg), device=device)
    t0 = time.perf_counter()
    for i, (g, d) in enumerate(seq_d.frames):
        tr.process_pipelined(g, d, float(i))
    tr.flush_pipeline()
    sync(device)
    r["D. full pipelined track loop"] = _per_frame_ms(t0, len(seq_d.frames))
    frames += len(seq_d.frames[:3]) + len(seq_d.frames)
    r["_frames"] = frames
    return r


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="what bounds ms/frame of the tracking pipeline")
    ap.add_argument("n", type=int, nargs="?", default=40)
    ap.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    from .. import resolve_device
    from ..io.synthetic import make_sequence
    from ..tracking.tracker import TrackerConfig

    dev = resolve_device(args.device)
    print(f"device={dev}", file=sys.stderr)
    r = profile(make_sequence(n_frames=8), TrackerConfig(), dev, args.n)
    for k, v in r.items():
        if not k.startswith("_"):
            print(f"{k:40s} {v:8.2f} ms/frame")
    return 0


if __name__ == "__main__":
    sys.exit(main())
