"""The least work of kernel B1 (FAST-9/16 + 3x3 NMS over every pyramid
level in one launch, `spslam_tpu_torch/csrc/fast_nms.cu`) and the
published peaks of one H100 SXM, for B1's share of its roofline.

The count is a frozen copy of `spslam_tpu_torch/ops/fast_cuda.
fast_nms_work`: the ring is counted on the scored pixels that pass the
kernel's exact compass test on the frame at hand, as the kernel does, so
the bound is the least work these inputs need.

Peaks, all published: 132 SMs at the 1,980 MHz boost clock (NVIDIA H100
SXM data sheet); per SM and clock 128 results of 32-bit float add and 64 of
compare/min/max/select/logic (CUDA C++ Programming Guide, arithmetic
instruction throughput, compute capability 9.0); 3.35 TB/s of HBM3 (data
sheet).  The rates assume the card's full 700 W; the run reports the
card's power limit beside the share.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence, Tuple

import torch

from .reference.fast import compass_reject
from .reference.pyramid import build_pyramid_levels

SMS = 132
BOOST_HZ = 1.98e9
ADD_PER_SM_CLK = 128
MINMAX_PER_SM_CLK = 64
HBM_BYTES_PER_S = 3.35e12
ADD_OPS_PER_S = SMS * ADD_PER_SM_CLK * BOOST_HZ
MINMAX_OPS_PER_S = SMS * MINMAX_PER_SM_CLK * BOOST_HZ

# Lane operations per pixel, as the kernel computes them: the compass test
# on every scored pixel, the ring on those that pass it, NMS per output.
OPS_COMPASS = {"add": 4, "minmax": 9}
OPS_RING = {"add": 33, "minmax": 85}
OPS_NMS = {"add": 0, "minmax": 16}

KERNEL_NAME = "fast_nms_levels_kernel"
BORDER = 19   # the detection border of the tracking path


class Work(NamedTuple):
    bytes: int
    add_ops: int
    minmax_ops: int


def level_sizes(height: int, width: int, n_levels: int,
                scale: float) -> Tuple[Tuple[int, int], ...]:
    return tuple((int(round(height / scale ** i)), int(round(width / scale ** i)))
                 for i in range(n_levels))


def scored_region(h: int, w: int, border: int) -> tuple:
    """(rows, cols) slices of the pixels of an [h, w] level that need a
    score: the detection interior and the 1-px ring NMS reads around it."""
    if h - 2 * border <= 0 or w - 2 * border <= 0:
        return slice(0, 0), slice(0, 0)
    return (slice(max(border - 1, 0), min(h - border + 1, h)),
            slice(max(border - 1, 0), min(w - border + 1, w)))


def work(sizes: Sequence[Tuple[int, int]], border: int = BORDER, ring_px=None) -> Work:
    """Bytes (each level read once and written once, float32) and lane
    operations of one launch over levels of these sizes.  `ring_px`: the
    scored pixels that pass the compass test on the frame at hand (the
    kernel skips the ring on the rest; `ring_px` below counts them); None
    counts the ring on every scored pixel, the most a frame could need."""
    n_bytes = scored = outputs = 0
    for h, w in sizes:
        n_bytes += 8 * h * w
        rows, cols = scored_region(h, w, border)
        scored += (rows.stop - rows.start) * (cols.stop - cols.start)
        outputs += max(h - 2 * border, 0) * max(w - 2 * border, 0)
    ring = scored if ring_px is None else ring_px
    add, minmax = (scored * OPS_COMPASS[k] + ring * OPS_RING[k] + outputs * OPS_NMS[k]
                   for k in ("add", "minmax"))
    return Work(n_bytes, add, minmax)


def ring_px(gray: torch.Tensor, spec, th_low: float, border: int = BORDER) -> int:
    """Scored pixels of a frame's pyramid (the reference's levels of the u8
    frame `gray`) that pass the kernel's compass test."""
    levels, _ = build_pyramid_levels(gray.to(torch.float32), spec, blur=False)
    return sum(int((~compass_reject(img, th_low))[scored_region(*img.shape, border)].sum())
               for img in levels)


def bound_s(w: Work) -> float:
    """The least time of the launch on the published peaks: the largest of
    the bytes over the memory rate, all operations over the issue rate (one
    lane operation per lane and clock, the add rate) and the min/max class
    over its own rate."""
    return max(w.bytes / HBM_BYTES_PER_S,
               (w.add_ops + w.minmax_ops) / ADD_OPS_PER_S,
               w.minmax_ops / MINMAX_OPS_PER_S)
