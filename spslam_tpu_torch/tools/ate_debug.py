"""Synchronous against async-mapping ATE on the 40-frame orbit (port of
tools/ate_debug.py): local BA, th_depth 5.0; per mode the ATE, the valid
keyframes and points and the summed `kf` metric of the tracker (frames it
made keyframes).  The reference's unfinished `sync_slow` branch has no
port.

    python -m spslam_tpu_torch.tools.ate_debug [--device cpu]
"""

from __future__ import annotations

import argparse
import sys


def run(seq, mode: str, device=None) -> dict:
    """One System ("sync" or "async" mapping) over seq: ATE m, keyframes,
    points and the summed kf metric."""
    from ..eval.ate import ate_rmse
    from ..system import System, SystemConfig
    from ..tracking.tracker import TrackerConfig

    sys_ = System(SystemConfig(intr=seq.intr, local_ba=True, async_mapping=(mode == "async"),
                               tracker=TrackerConfig(th_depth=5.0)), device=device)
    for (gray, depth), ts in zip(seq.frames, seq.timestamps):
        sys_.track_rgbd(gray, depth, ts)
    sys_.shutdown()
    rmse, _ = ate_rmse(sys_.poses(), seq.poses_gt)
    return dict(mode=mode, ate=float(rmse), kfs=int(sys_.store.kf_valid.sum()),
                pts=int(sys_.store.pt_valid.sum()),
                metrics_kf=sum(m.get("kf", 0) for m in sys_.tracker.metrics))


def line(r: dict) -> str:
    return (f"{r['mode']:10s}: ATE {r['ate'] * 1000:7.2f} mm  kfs={r['kfs']} pts={r['pts']} "
            f"metrics_kf={r['metrics_kf']}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="sync vs async-mapping ATE on the 40-frame orbit")
    ap.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    from .. import resolve_device
    from ..io.synthetic import make_sequence

    dev = resolve_device(args.device)
    print(f"device={dev}", file=sys.stderr)
    seq = make_sequence(n_frames=40)
    for mode in ("sync", "async"):
        print(line(run(seq, mode, dev)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
