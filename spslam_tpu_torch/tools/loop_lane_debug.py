"""The paced loop lane's diagnosis (port of tools/loop_lane_debug.py): where
in the revisit window each closure lands, what the detector saw per
keyframe, and how much ATE remains per pass.

Runs the bench's loop-lane configuration exactly (the 128-frame loop
sequence, 1.25 turns of yaw, 0.4% depth noise, u8 gray and u16 depth at
30 fps pacing, async mapping, use_loop, local BA, th_depth 3.2) for N
passes after the bench's loop warm-up, and prints per pass the reference's
lines: `pass p: ATE ..., loops=..., median ..., spike ..., kfs=...`, one
`CLOSED` line per closure and one `detect` line per detection.  Beside
them, for this port:

* `truth` per closure: the frames of the two keyframes, the angle between
  their ground-truth views (wrapped to [0, 180] degrees) and whether it is
  within the camera's half field of view, atan((width / 2) / fx) (a larger
  gap counts as a false closure), and how far the loop edge the geometric
  check measured lies from the ground-truth relative pose;
* `gba` per global BA: its keyframe window, from the newest keyframe when
  the solve started to the newest at its write-back (keyframes the
  merge had to carry), and its ms;
* the errors the mapping worker logged in the pass (logger
  `spslam_tpu_torch.tracking.pipeline`), counted with a handler as
  chip_smoke's async phase does.

    python -m spslam_tpu_torch.tools.loop_lane_debug [--device cpu] [n_passes] [n_frames]
"""

from __future__ import annotations

import argparse
import logging
import math
import sys
import time

import numpy as np

PASS_KEYS = ("ate_mm", "loops", "median_ms", "spike_ms", "kfs", "events", "closures", "gba",
             "worker_errors", "launches")


def lane_sequence(n_frames: int = 128):
    """The bench's loop-lane render (its cache file), u8/u16 frames."""
    from ..bench import cached_sequence

    return cached_sequence(f"torch_loop{n_frames}", n_frames=n_frames, trajectory="loop",
                           depth_noise=0.004)


def lane_system(seq, device):
    """The bench's loop-lane System factory."""
    from ..system import System, SystemConfig
    from ..tracking.tracker import TrackerConfig

    return lambda: System(SystemConfig(
        intr=seq.intr, local_ba=True, async_mapping=True, use_loop=True,
        tracker=TrackerConfig(th_depth=3.2)), device=device)


def warm_up(make, seq, device):
    """The bench's loop warm-up: 12 frames through a throwaway System, then
    on the card the first use of the closure and anomaly machinery."""
    from .. import resolve_device
    from ..bench import WARM_FRAMES, _warm
    from ..loop.precompile import warm_loop_machinery, warm_sync_tracking

    dev = resolve_device(device)
    _warm(make, seq, WARM_FRAMES)
    if dev.type == "cuda":
        warm_loop_machinery(seq.intr, device=dev)
        warm_sync_tracking(seq.intr, seq.frames, seq.timestamps, device=dev)


def view_gap_deg(T_a, T_b) -> float:
    """Angle between two T_cw [7] cameras' orientations, in [0, 180]."""
    d = abs(float(np.dot(T_a[:4], T_b[:4]))) / (
        float(np.linalg.norm(T_a[:4])) * float(np.linalg.norm(T_b[:4])))
    return math.degrees(2.0 * math.acos(min(1.0, d)))


def half_fov_deg(intr) -> float:
    return math.degrees(math.atan((intr.width / 2.0) / intr.fx))


def edge_error(T_edge, T_cand, T_kf) -> tuple:
    """(mm, degrees) between a loop edge T_edge = T_cand . T_kf^-1, as the
    geometric check measured it, and the same relative pose from the
    ground-truth cameras T_cand, T_kf: how wrong the accepted alignment is."""
    from ..geometry import np_lie

    gt = np_lie.se3_compose(T_cand, np_lie.se3_inverse(T_kf))
    d = np_lie.se3_compose(np.asarray(T_edge, np.float64), np_lie.se3_inverse(gt))
    return (float(np.linalg.norm(d[4:7])) * 1e3,
            math.degrees(2.0 * math.acos(min(1.0, abs(float(d[0]) / np.linalg.norm(d[:4]))))))


def closure_truth(events, loop_edges, kf_frame_id, poses_gt, intr) -> list:
    """Per closed event (in order; the i-th closure made the i-th loop
    edge): its keyframes and frames, the ground-truth view gap, whether it
    is within the half field of view, and its loop edge's error."""
    half = half_fov_deg(intr)
    out = []
    closed = [e for e in events if e["kind"] == "closed"]
    for ev, (_, _, T_edge) in zip(closed, loop_edges):
        fa, fb = int(kf_frame_id[ev["kf"]]), int(kf_frame_id[ev["cand"]])
        gap = view_gap_deg(poses_gt[fa], poses_gt[fb])
        mm, deg = edge_error(T_edge, poses_gt[fb], poses_gt[fa])
        out.append(dict(kf=int(ev["kf"]), frame=fa, cand=int(ev["cand"]), cand_frame=fb,
                        gap_deg=round(gap, 2), true_revisit=gap <= half,
                        edge_err_mm=round(mm, 1), edge_err_deg=round(deg, 2),
                        inliers=ev.get("inliers"), early=ev["early"]))
    return out


class _Count(logging.Handler):
    def __init__(self):
        super().__init__(level=logging.WARNING)
        self.messages = []

    def emit(self, record):
        self.messages.append(record.getMessage())


def _watch_gba(lc, windows: list):
    """Record each global BA's keyframe window on this LoopCloser instance:
    (newest keyframe at the solve's start, newest at its write-back, ms)."""
    run = lc._run_gba

    def run_and_record():
        k0 = lc.store.n_kf - 1
        t0 = time.perf_counter()
        run()
        windows.append(dict(kf_start=int(k0), kf_written=int(lc.store.n_kf - 1),
                            ms=round((time.perf_counter() - t0) * 1e3, 1)))

    lc._run_gba = run_and_record


def run_pass(make, seq) -> dict:
    """One pass of the lane through a fresh System from `make`; the keys of
    PASS_KEYS.  closures: per closure its keyframes, their frames, the
    ground-truth view gap and whether it is a true revisit; gba: per global
    BA its keyframe window and frames."""
    from ..bench import _feed, _steady
    from ..eval.ate import ate_rmse
    from ..ops import fast_cuda

    logger = logging.getLogger("spslam_tpu_torch.tracking.pipeline")
    errors = _Count()
    logger.addHandler(errors)
    windows = []
    try:
        sys_ = make()
        lc = sys_.loop_closer
        _watch_gba(lc, windows)
        launches0 = fast_cuda.LAUNCHES
        times = _feed(sys_, seq, paced=True)
        launches = fast_cuda.LAUNCHES - launches0
    finally:
        logger.removeHandler(errors)
    st = sys_.store
    steady = _steady(times)
    rmse, _ = ate_rmse(sys_.poses(), seq.poses_gt)
    fid = st.kf_frame_id
    closures = closure_truth(lc.events, lc.loop_edges, fid, seq.poses_gt, seq.intr)
    gba = [dict(w, frame_start=int(fid[w["kf_start"]]), frame_written=int(fid[w["kf_written"]]),
                kfs_during=w["kf_written"] - w["kf_start"]) for w in windows]
    return dict(ate_mm=round(rmse * 1e3, 3), loops=int(lc.n_loops_closed),
                median_ms=round(float(np.median(steady)) * 1e3, 2),
                spike_ms=round(float(steady.max()) * 1e3, 1), kfs=int(st.n_kf),
                events=list(lc.events), closures=closures, gba=gba,
                worker_errors=errors.messages, launches=launches,
                kf_frame_id=fid[: st.n_kf].copy())


def report(p: int, res: dict, half: float):
    """Print one pass: the reference's lines, then the truth and GBA lines."""
    fid = res["kf_frame_id"]
    print(f"\npass {p}: ATE {res['ate_mm']:.1f} mm, loops={res['loops']}, "
          f"median {res['median_ms']:.1f} ms, spike {res['spike_ms']:.0f} ms, kfs={res['kfs']}")
    for ev in res["events"]:
        if ev["kind"] == "closed":
            print(f"  CLOSED kf={ev['kf']} (frame {int(fid[ev['kf']])}) <- cand "
                  f"{ev['cand']} early={ev['early']} assembly={ev['assembly_ms']} ms")
        elif ev["kind"] == "detect" and (ev["cands"] or ev["chain"]):
            print(f"  detect kf={ev['kf']} (frame {int(fid[ev['kf']])}) chain={ev['chain']} "
                  f"cands={ev['cands']} acc={ev['accepted']} near={ev['near']}")
    for c in res["closures"]:
        print(f"  truth kf={c['kf']} (frame {c['frame']}) <- cand {c['cand']} (frame "
              f"{c['cand_frame']}): view gap {c['gap_deg']:.2f} deg "
              f"{'<=' if c['true_revisit'] else '>'} half FOV {half:.2f} -> "
              f"{'true revisit' if c['true_revisit'] else 'FALSE closure'}, "
              f"inliers {c['inliers']}; loop edge off the truth by {c['edge_err_mm']:.1f} mm, "
              f"{c['edge_err_deg']:.2f} deg")
    for g in res["gba"]:
        print(f"  gba kf {g['kf_start']} (frame {g['frame_start']}) -> written at kf "
              f"{g['kf_written']} (frame {g['frame_written']}): {g['kfs_during']} keyframes "
              f"added during the solve, {g['ms']:.1f} ms")
    print(f"  worker errors: {len(res['worker_errors'])}"
          + "".join(f"\n    {m}" for m in res["worker_errors"]))
    print(f"  B1 launches: {res['launches']}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="the paced loop lane's event log per pass")
    ap.add_argument("n_passes", type=int, nargs="?", default=2)
    ap.add_argument("n_frames", type=int, nargs="?", default=128)
    ap.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    from .. import resolve_device

    dev = resolve_device(args.device)
    print(f"device={dev}", file=sys.stderr)
    seq = lane_sequence(args.n_frames)
    make = lane_system(seq, dev)
    warm_up(make, seq, dev)
    print("warmup done", file=sys.stderr)
    half = half_fov_deg(seq.intr)
    for p in range(args.n_passes):
        report(p, run_pass(make, seq), half)
    return 0


if __name__ == "__main__":
    sys.exit(main())
