"""Host->card upload time by content and chunking (port of
tools/profile_tunnel.py, whose name it keeps: on the card the link is
PCIe, where the content of a buffer should not matter; the tool shows
whether it does).

Per case, n distinct host buffers are uploaded and one
torch.cuda.synchronize() ends the run; ms per upload, from pageable and
from pinned memory:

  * a real frame as the fused step's 900 KB u8 layout (gray, depth low
    byte, depth high byte), zeros and random bytes of the same size;
  * the real gray alone and random bytes at 300 KB; random at 1,800 KB;
  * one 900 KB frame as 3 uploads of 300 KB against 1 of 900 KB.

    python -m spslam_tpu_torch.tools.profile_tunnel [--device cpu] [n]
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch


def frame_u8(seq) -> np.ndarray:
    """Frame 0 as [3, H, W] u8: gray, depth's low byte, its high byte."""
    from ..bench import quantized

    ((g, d),) = quantized(seq.frames[:1])
    d8 = d[..., None].view(np.uint8)
    return np.ascontiguousarray(np.stack([g, d8[..., 0], d8[..., 1]]))


def upload_ms(bufs, device, pinned: bool) -> float:
    """ms per upload of the host buffers bufs (lists of chunks), one sync."""
    from .profile_frame import sync

    if pinned and device.type == "cuda":
        bufs = [[torch.from_numpy(c).pin_memory() for c in b] for b in bufs]
    else:
        bufs = [[torch.from_numpy(c) for c in b] for b in bufs]
    sync(device)
    t0 = time.perf_counter()
    for b in bufs:
        for c in b:
            c.to(device, non_blocking=pinned)
    sync(device)
    return (time.perf_counter() - t0) / len(bufs) * 1e3


def cases(real: np.ndarray):
    """(label, make(i) -> list of host chunks) of every case."""
    zeros = np.zeros_like(real)
    rand = np.random.RandomState(0).randint(0, 256, real.shape, np.uint8)
    return (
        ("real frame 900KB", lambda i: [real.copy()]),
        ("zeros 900KB", lambda i: [zeros.copy()]),
        ("random 900KB", lambda i: [rand.copy()]),
        ("real gray-only 300KB", lambda i: [real[0].copy()]),
        ("random 300KB", lambda i: [rand[0].copy()]),
        ("random 1800KB", lambda i: [np.concatenate([rand, rand])]),
        ("3 chunks of 300KB", lambda i: [real[j].copy() for j in range(3)]),
    )


def profile(seq, device, n: int = 20) -> list:
    """[(case, pageable ms, pinned ms)]."""
    real = frame_u8(seq)
    torch.from_numpy(real).to(device)
    rows = []
    for label, make in cases(real):
        bufs = [make(i) for i in range(n)]
        rows.append((label, upload_ms(bufs, device, False), upload_ms(bufs, device, True)))
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="upload time by content and chunking")
    ap.add_argument("n", type=int, nargs="?", default=20)
    ap.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    from .. import resolve_device
    from ..io.synthetic import make_sequence

    dev = resolve_device(args.device)
    print(f"device={dev}", file=sys.stderr)
    for label, page, pin in profile(make_sequence(n_frames=1), dev, args.n):
        print(f"{label:22s}  pageable {page:7.3f} ms  pinned {pin:7.3f} ms")
    return 0


if __name__ == "__main__":
    sys.exit(main())
