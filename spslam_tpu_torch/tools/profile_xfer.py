"""Host<->card copy time against size (port of tools/profile_xfer.py).

For each size from 16 KB to 4 MB, the median of 8 single copies, each
fenced by torch.cuda.synchronize():

  * upload from pageable memory (`torch.from_numpy(a).to(dev)`) and from
    pinned memory (`non_blocking=True`);
  * download into pageable memory (`.cpu()`) and into a pinned tensor
    (`copy_(..., non_blocking=True)`);

then two uploads (614 KB and 307 KB, pageable) from two threads against
the same two in sequence.  profile_tunnel.py holds the content and
chunking cases.

    python -m spslam_tpu_torch.tools.profile_xfer [--device cpu]
"""

from __future__ import annotations

import argparse
import sys
import threading
import time

import numpy as np
import torch

SIZES_KB = (16, 64, 128, 256, 307, 512, 614, 921, 1024, 2048, 4096)


def size_curve(device, sizes_kb=SIZES_KB, reps: int = 8) -> list:
    """[(KB, direction, memory, ms)] for up/down x pageable/pinned."""
    from .profile_frame import median_ms

    pin = device.type == "cuda"
    rows = []
    for kb in sizes_kb:
        a = np.zeros(kb * 1024, np.uint8)
        a_pin = torch.from_numpy(a).pin_memory() if pin else torch.from_numpy(a)
        x = torch.ones(kb * 1024, dtype=torch.uint8, device=device)
        out_pin = torch.empty(kb * 1024, dtype=torch.uint8, pin_memory=pin)
        for direction, memory, fn in (
            ("up", "pageable", lambda: torch.from_numpy(a).to(device)),
            ("up", "pinned", lambda: a_pin.to(device, non_blocking=True)),
            ("down", "pageable", lambda: x.cpu()),
            ("down", "pinned", lambda: out_pin.copy_(x, non_blocking=True)),
        ):
            rows.append((kb, direction, memory, median_ms(fn, device, reps, 1)))
    return rows


def two_threads(device, reps: int = 6) -> tuple:
    """(ms of a 614 KB and a 307 KB upload from two threads, ms of the same
    two in sequence), medians of reps."""
    from .profile_frame import sync

    a = np.zeros(614 * 1024, np.uint8)
    b = np.zeros(307 * 1024, np.uint8)

    def put(arr):
        torch.from_numpy(arr).to(device)
        sync(device)

    par, seq = [], []
    for _ in range(reps):
        t0 = time.perf_counter()
        th = [threading.Thread(target=put, args=(arr,)) for arr in (a, b)]
        for t in th:
            t.start()
        for t in th:
            t.join()
        par.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        torch.from_numpy(a).to(device)
        torch.from_numpy(b).to(device)
        sync(device)
        seq.append(time.perf_counter() - t0)
    return float(np.median(par)) * 1e3, float(np.median(seq)) * 1e3


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="host<->card copy time against size")
    ap.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    from .. import resolve_device

    dev = resolve_device(args.device)
    print(f"device={dev}", file=sys.stderr)
    for kb, direction, memory, ms in size_curve(dev):
        print(f"  {direction:4s} {memory:8s} {kb:6d} KB : {ms:8.3f} ms  "
              f"({kb / 1024 / ms * 1000:8.1f} MB/s)")
    par, seq = two_threads(dev)
    print(f"parallel 614+307 KB puts   : {par:8.3f} ms")
    print(f"sequential 614+307 KB puts : {seq:8.3f} ms")
    return 0


if __name__ == "__main__":
    sys.exit(main())
