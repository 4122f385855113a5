"""The data-parallel batch-evaluation lane: aggregate frames/s of N
sequences run together (one System each, parallel/dp_eval.py) against the
same sequences run one after another (port of tools/dp_eval_bench.py).

Caveats, printed with the result: the Systems' host bookkeeping shares one
Python process and its GIL, so any overlap comes from asynchronous kernel
launches; with fewer cards than sequences the Systems also share a card.
The signal is aggregate_fps / serial_fps > 1 (the overlap is real), not
N-fold scaling.

    python -m spslam_tpu_torch.tools.dp_eval_bench [--sequences 4] [--frames 20] [--device cpu]

The last line is one JSON object: dp_eval_speedup (value), serial_fps,
aggregate_fps, sequences, devices.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch


def _sync(devices):
    for d in {d for d in devices if d.type == "cuda"}:
        torch.cuda.synchronize(d)


def run(sequences: int = 4, frames: int = 20, device=None) -> dict:
    from ..io.synthetic import make_sequence
    from ..parallel.dist_ba import global_mesh
    from ..parallel.dp_eval import evaluate_sequences
    from ..system import System, SystemConfig

    devices = global_mesh(device)
    print(f"devices={[str(d) for d in devices]}", file=sys.stderr)
    seqs = [make_sequence(n_frames=frames, seed=i) for i in range(sequences)]

    # warm the first calls on a throwaway run so both measurements are steady
    evaluate_sequences([seqs[0]], devices=devices)

    # serial: one sequence after another on the first device
    t0 = time.perf_counter()
    for seq in seqs:
        sys_ = System(SystemConfig(intr=seq.intr), device=devices[0])
        for (g, d), ts in zip(seq.frames, seq.timestamps):
            sys_.track_rgbd(g, d, float(ts))
        sys_.shutdown()
    _sync(devices)
    serial_s = time.perf_counter() - t0
    serial_fps = sum(len(s.frames) for s in seqs) / serial_s

    # data-parallel: one System per sequence, devices round-robin
    results, agg_fps = evaluate_sequences(seqs, devices=devices)
    for r in results:
        print(f"  {r.name}: ATE {r.ate_rmse_m * 1000:.2f} mm on {r.device}", file=sys.stderr)
    print(f"caveat: {sequences} Systems share one Python process (its GIL) and "
          f"{len(devices)} device(s); the overlap comes from asynchronous launches",
          file=sys.stderr)
    return {
        "metric": "dp_eval_speedup",
        "value": round(agg_fps / serial_fps, 3),
        "unit": "aggregate_fps_over_serial_fps",
        "serial_fps": round(serial_fps, 2),
        "aggregate_fps": round(agg_fps, 2),
        "sequences": sequences,
        "devices": len(devices),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="aggregate vs serial frames/s of dp evaluation")
    ap.add_argument("--sequences", type=int, default=4)
    ap.add_argument("--frames", type=int, default=20)
    ap.add_argument("--device", default=None,
                    help="torch device for every System (default: the visible CUDA cards)")
    args = ap.parse_args(argv)
    print(json.dumps(run(args.sequences, args.frames, args.device)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
