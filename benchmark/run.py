"""Run one cell of the benchmark once.

    python3 -m benchmark.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

Loads the cell named in BENCHMARK.json, renders its sessions from the seed
on the card, warms the cell's paths up, measures for --seconds, flushes,
checks the window's fused steps against the plain reference and prints
one JSON line as the last line of standard output (the compared numbers
and their limits also go to standard error).  --trace 0 reports the
cell's end-to-end metrics, --trace 1 its per-layer metrics from a profiled
window.  Without a CUDA card, or with fewer cards than the cell asks for,
it exits with code 2 and prints no result.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time


def _process_start() -> float:
    """Unix time at which this process started (Linux /proc)."""
    with open("/proc/self/stat") as f:
        ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return time.time() - uptime + ticks / os.sysconf("SC_CLK_TCK")


FORBIDDEN = ("jax", "jaxlib", "flax", "spslam_tpu")


def forbidden_modules(modules=None) -> list:
    """Loaded modules whose top-level name, compared whole, is JAX's or the
    JAX package's."""
    names = {m.split(".", 1)[0] for m in (sys.modules if modules is None else modules)}
    return sorted(names.intersection(FORBIDDEN))


def _set_cache_dirs(root: str):
    """Every build and kernel cache at a fixed path inside the checkout."""
    base = os.path.join(root, ".bench_cache")
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"), ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = os.path.join(base, sub)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="one run of one benchmark cell")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from . import spec

    _set_cache_dirs(spec.ROOT)
    cell = spec.cell(args.workload)

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"benchmark: the cell needs {cell.chips} CUDA card(s), found {n}", file=sys.stderr)
        return 2

    out = execute(cell, args.seed, args.seconds, bool(args.trace), torch.device("cuda", 0))
    if out is None:
        return 3
    print(json.dumps(out), flush=True)
    return 0


def execute(cell, seed: int, seconds: float, trace: bool, device, warm: bool = True):
    """One run of `cell` on `device`: the result object, or None when a
    forbidden module was loaded."""
    import torch

    from . import check, stats
    from .harness import Bench, log

    bench = Bench(cell, seed, device, trace=trace)
    bench.setup(warm=warm)
    w = bench.window(seconds)
    setup_s = w.t_open_ns * 1e-9 - _process_start()
    on_card = device.type == "cuda"
    attempted, failed = bench.counts(w)
    device_info = {"platform": "gpu" if on_card else device.type,
                   "kind": torch.cuda.get_device_name(device) if on_card else device.type,
                   "count": cell.chips,
                   "memory_peak_bytes": torch.cuda.max_memory_allocated(device) if on_card else 0}
    if trace:
        values, breakdown, tr = bench.per_layer(w)
        units = {m["name"]: m["unit"] for m in cell.per_layer}
        device_info.update(busy_s=tr.busy_s, window_s=tr.window_s)
    else:
        values = bench.end_to_end(w, setup_s)
        units = {m["name"]: m["unit"] for m in cell.end_to_end}
    log(f"window {w.t_close - w.t_open:.3f} s, {len(w.sessions)} sessions, "
        f"{attempted} frames handed in, {failed} failed, warm-up {bench.warm_frames} frames, "
        f"set-up {setup_s:.3f} s, {bench.capture.seen} fused steps, "
        f"{len(bench.capture.steps)} kept for the check")
    for s in w.sessions:
        ate = stats.pooled_ate_mm([(s.poses, s.poses_gt)]) if s.poses is not None else None
        log(f"session {s.index}: {len(s.t_start)} frames, ATE {ate} mm, LOST {s.lost}")

    bench.release()
    readings = check.judge(bench.capture.steps, bench.sessions, cell.config, device)
    correct, checks = check.verdict(readings, cell.limits)
    for k, v in readings.departures:
        log(f"the program ran {k} = {v!r}, which the configuration does not state")

    found = forbidden_modules()
    if found:
        print(f"benchmark: loaded {found}, which the port must not use", file=sys.stderr)
        return None
    out = {"correct": correct, "attempted": attempted, "failed": failed,
           "metrics": {k: {"value": values[k], "unit": units[k]} for k in units if k in values},
           "device": device_info}
    if trace:
        out["breakdown"] = breakdown
    out["checks"] = checks
    for k, v in checks.items():
        log(f"check {k}: {v['value']} (limit {v['limit']})")
    return out


if __name__ == "__main__":
    sys.exit(main())
