"""Bisect the fused track_frame_step on the card: which stage owns its time
(port of tools/profile_fused.py).  Runs variants of the step with stages
knocked out, each chained n times (the pose fed forward, one sync at the
end), and prints ms per chained step and kernels per step (counted by the
CUDA profiler from the device's activity).

Variants, built from the step's own pieces (build_frame,
tracking/tracker._match_and_optimize, the global descriptor fallback,
tracking/tracker._pack_frame):

  build only                 build_frame
  + coarse                   the motion-model match, radius 22, 2x5 LM
  + tight                    the local-map match, radius 6, 4x10 LM
  + coarse + tight
  + coarse + fallback + tight  the port's step computes the fallback on
                             every frame and selects it with torch.where
  + pack outputs             = track_frame_step (out_small, out_big equal)
  + return FrameData         the same; eager PyTorch computes the frame
                             either way, kept as the reference's case
  track_frame_step           the real step (a cached has_vel tensor, float
                             radii and th_depth)
  + 4 scalars/call           the real step with its four per-call scalars
                             (two radii, th_depth, has_vel) made into fresh
                             device tensors on every call, the torch form
                             of the per-call `torch.tensor(..., device=)`
                             uploads (solver/pose_opt.py, the projection's
                             log-scale constant)

The tight stage runs the step's 4x10 LM (the reference tool's 4x6 predates
its step's 4x10).

    python -m spslam_tpu_torch.tools.profile_fused [--device cpu] [n]
"""

from __future__ import annotations

import argparse
import sys
import time

import torch

CASES = (
    ("build only (no match)", dict()),
    ("build + coarse", dict(coarse=True)),
    ("build + tight", dict(tight=True)),
    ("build + coarse + tight", dict(coarse=True, tight=True)),
    ("build + coarse + fallback + tight", dict(coarse=True, fallback=True, tight=True)),
    ("  + pack outputs", dict(coarse=True, fallback=True, tight=True, pack=True)),
    ("  + return FrameData", dict(coarse=True, fallback=True, tight=True, pack=True,
                                  ret_frame=True)),
)


def stages(x: dict, T_pred, radius1, T_prev, coarse=False, fallback=False, tight=False,
           pack=False, ret_frame=False):
    """The step's stages on fused_inputs x, each one on or off: returns
    (T, out_small, out_big, frame), None where a stage was off.  With every
    stage on it computes track_frame_step's outputs from the predicted pose
    T_pred, the coarse radius radius1 and the fallback's prior T_prev."""
    from ..frontend.frame import build_frame
    from ..ops.brief import unpack_bits
    from ..ops.match import TH_HIGH, TH_LOW, match_descriptors
    from ..solver.robust import octave_inv_sigma2
    from ..tracking.tracker import (FALLBACK_SEED_GATE, _compact_pose_opt,
                                    _match_and_optimize, _pack_frame, decode_depth)

    cfg, intr = x["cfg"], x["intr"]
    pt = x["pack"]
    pos, nrm, mind, maxd, pv = pt[:, 0:3], pt[:, 3:6], pt[:, 6], pt[:, 7], pt[:, 8] > 0.5
    bits = unpack_bits(x["desc"])
    frame = build_frame(x["gray"].to(torch.float32), decode_depth(x["depth"], 5000.0),
                        x["spec"], intr, n_features=cfg.n_features,
                        th_high=cfg.th_fast_high, th_low=cfg.th_fast_low)
    T = T_pred
    if coarse:
        opt1, _, _ = _match_and_optimize(T, pos, nrm, mind, maxd, bits, pv, frame, radius1,
                                         TH_HIGH, intr, n_rounds=2, n_iters=5)
        T, n_seed = opt1.T_cw, opt1.n_inliers
        n_fb = torch.full_like(n_seed, -1, dtype=torch.int32)
    if fallback:
        res = match_descriptors(bits, frame.bits, pv, frame.valid, max_dist=TH_LOW, ratio=0.85)
        kp = torch.clamp_min(res.idx, 0).long()
        opt_fb = _compact_pose_opt(
            T_prev, pos, frame.uv[kp], torch.where(res.valid, frame.u_right[kp], -1.0),
            octave_inv_sigma2(frame.octave[kp]), res.valid, frame.uv.shape[0], intr, 2, 5)
        run_fb = opt1.n_inliers < FALLBACK_SEED_GATE
        n_fb = torch.where(run_fb, opt_fb.n_inliers, -1).to(torch.int32)
        T = torch.where(opt1.n_inliers >= n_fb, opt1.T_cw,
                        torch.where(run_fb, opt_fb.T_cw, T_prev))
        n_seed = torch.maximum(opt1.n_inliers, n_fb)
    if tight:
        opt2, match_idx, matched = _match_and_optimize(
            T, pos, nrm, mind, maxd, bits, pv, frame, cfg.local_search_radius, TH_HIGH, intr,
            n_rounds=4, n_iters=10)
        T = opt2.T_cw
    small = big = None
    if pack:
        small, big = _pack_frame(frame, opt2, match_idx, matched, n_seed, n_fb, cfg.th_depth,
                                 5000.0)
    return T, small, big, (frame if ret_frame else None)


def variant(x: dict, **on):
    """One case of CASES as fn(T) -> outputs; the step's prior is T with a
    zero velocity (radius1 = the motion radius)."""
    r1 = x["cfg"].motion_search_radius
    return lambda T: stages(x, T, r1, T, **on)


def real_variant(x: dict, fresh_scalars: bool = False):
    """The real step as fn(T) (T_prev = T_prev2 = T, has_vel); with
    fresh_scalars its four per-call scalars are new device tensors."""
    from ..tracking.tracker import track_frame_step
    from .profile_frame import real_step

    cfg, dev = x["cfg"], x["device"]
    hv = torch.tensor(True, device=dev)

    def fn(T):
        frame, small, big = real_step(x, T, T, hv)
        return small[0:7].view(torch.float32), small, big, frame

    def fresh(T):
        frame, small, big = track_frame_step(
            x["gray"], x["depth"], T, T, torch.tensor(True, device=dev), x["pack"], x["desc"],
            torch.tensor(cfg.motion_search_radius, device=dev),
            torch.tensor(cfg.local_search_radius, device=dev),
            torch.tensor(cfg.th_depth, device=dev), x["spec"], x["intr"], cfg.n_features,
            cfg.th_fast_high, cfg.th_fast_low)
        return small[0:7].view(torch.float32), small, big, frame

    return fresh if fresh_scalars else fn


def chained_ms(fn, T0, device, n: int) -> float:
    """ms per step of n chained calls (each fed the last pose), one sync."""
    from .profile_frame import sync

    fn(T0)
    sync(device)
    t0 = time.perf_counter()
    T = T0
    for _ in range(n):
        T = fn(T)[0]
    sync(device)
    return (time.perf_counter() - t0) / n * 1e3


def kernels_per_step(fn, T0, device):
    """Device kernels and copies of one call (events with device time),
    counted from a trace of the device's activity alone (the host-side op trace of ~30,000 launches
    costs seconds to build); None off the card."""
    if device.type != "cuda":
        return None
    from torch.profiler import ProfilerActivity, profile

    from .profile_frame import device_work, trace_events

    torch.cuda.synchronize(device)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn(T0)
        torch.cuda.synchronize(device)
    return device_work(trace_events(prof))[0]


def profile(seq, cfg, device, n: int = 40) -> list:
    """[(case, ms per chained step, kernels per step)]: CASES, then the
    real step and the 4-scalar case.  Each case builds n + 1 frames (n + 2
    on the card, where the kernel count takes one more call)."""
    from .profile_frame import fused_inputs

    x = fused_inputs(seq, cfg, device)
    rows = []
    for name, on in CASES:
        fn = variant(x, **on)
        rows.append((name, chained_ms(fn, x["T0"], device, n),
                     kernels_per_step(fn, x["T0"], device)))
    for name, fresh in (("track_frame_step", False), ("same + 4 python scalars/call", True)):
        fn = real_variant(x, fresh)
        rows.append((name, chained_ms(fn, x["T0"], device, n),
                     kernels_per_step(fn, x["T0"], device)))
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="the fused step with stages knocked out")
    ap.add_argument("n", type=int, nargs="?", default=40)
    ap.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    from .. import resolve_device
    from ..io.synthetic import make_sequence
    from ..tracking.tracker import TrackerConfig

    dev = resolve_device(args.device)
    print(f"device={dev}", file=sys.stderr)
    for name, ms, k in profile(make_sequence(n_frames=2), TrackerConfig(), dev, args.n):
        print(f"{name:36s} {ms:8.2f} ms  kernels/step {k if k is not None else 'n/a'}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
