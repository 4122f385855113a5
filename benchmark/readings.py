"""The readings a cell's correctness limits are set from, on the card.

For each seed, one short window of the cell at its own load, then on the
window's sampled fused steps (benchmark/check.py):

    program   the program's buffers against the float32 reference
    control   the reference with its float32 matmuls in TF32, the nearest
              precision below the configuration's (float32, TF32 off),
              put in the program's place
    again     a second float32 reference run against the first: how far
              the reference's own run-to-run order of atomics moves it

All seeds run in one process; the first warms the cell's paths up.

    python3 -m benchmark.readings --workload <name> --seeds 12 \\
        --control-seeds 4 --seconds 25 [--first-seed N] [--out FILE.jsonl]
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from . import check, spec
from .harness import Bench, log


def collect(cell: spec.Cell, seeds, control_seeds: int, seconds: float, device,
            warm: bool = True) -> list:
    """One dict per seed: the end-to-end numbers of the window and the
    per-step readings of program, control and again (the last two on the
    first control_seeds seeds), with the numbers a cell can compare."""
    rows = []
    for i, seed in enumerate(seeds):
        bench = Bench(cell, seed, device)
        bench.setup(warm=warm and i == 0)
        w = bench.window(seconds)
        row = {"seed": seed, "sessions": len(w.sessions),
               "frames": sum(len(s.t_start) for s in w.sessions)}
        row.update(bench.end_to_end(w, float("nan")))
        bench.release()
        steps, cfg = bench.capture.steps, cell.config
        refs = check.reference_outputs(steps, bench.sessions, cfg, device)
        r = check.readings(steps, [(s.out_small, s.out_big) for s in steps], refs, cfg)
        row["program"] = {**r._asdict(), **r.numbers()}
        if i < control_seeds:
            for name, tf32 in (("control", True), ("again", False)):
                outs = check.reference_outputs(steps, bench.sessions, cfg, device, tf32=tf32)
                r = check.readings(steps, outs, refs, cfg)
                row[name] = {**r._asdict(), **r.numbers()}
        log(json.dumps(row))
        rows.append(row)
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="program and control readings of a cell's check")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--control-seeds", type=int, default=4)
    ap.add_argument("--seconds", type=float, default=25.0)
    ap.add_argument("--first-seed", type=int, default=3_000_000_000)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("readings: no CUDA card", file=sys.stderr)
        return 2
    cell = spec.cell(args.workload)
    seeds = [args.first_seed + 7919 * k for k in range(args.seeds)]
    rows = collect(cell, seeds, args.control_seeds, args.seconds, torch.device("cuda", 0))
    if args.out:
        with open(args.out, "w") as f:
            for r in rows:
                f.write(json.dumps(r) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
