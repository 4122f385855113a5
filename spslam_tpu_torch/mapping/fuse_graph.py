"""Fusion's projection match replayed as one CUDA graph.

`fuse._fuse_match_batch` projects a block of FUSE_POINTS map points into a
stack of FUSE_TARGETS keyframes and Hamming-matches them there: ~1,200
operations and ~940 kernels a block on an H100 (eight targets, each a
projection, a window gate and a 1,024 x 256 x N product), 3-4 blocks a
keyframe.  Launching them one by one holds the mapping worker on a CPU
for most of fusion's time.  The match is already fit for capture:
`_point_block` and `_kf_stack` pad every block to one shape, the gates are
fixed and nothing in the chain syncs with the host but the one scalar
`project_points` makes, which `build` makes once beforehand.  So it goes
through `cuda_graphs.CapturedCalls` (spans `mapper.fuse_replay`,
`mapper.fuse_capture`) and only the launches change.  On the CPU the match
stays eager.
"""

from __future__ import annotations

import torch

from ..cuda_graphs import CapturedCalls
from ..tracking.tracker import octave_log_scale
from .fuse import FUSE_POINTS, FUSE_TARGETS, _fuse_match_batch

# the process's one cache (a System is built per session, several may share
# a process): every fusion matches through it
GRAPHS = CapturedCalls("mapper.fuse")


def fetch(out: tuple):
    """The matched slots [T, P] as a numpy array."""
    return out[0].cpu().numpy()


def key(inputs: tuple, intr, device):
    """The cache key of a block, or None where it stays eager: off a
    CUDA device, or at another shape than [FUSE_TARGETS, FUSE_POINTS].
    `intr`'s floats are constants of the captured kernels."""
    device = torch.device(device)
    if (device.type != "cuda" or inputs[0].shape[0] != FUSE_TARGETS
            or inputs[5].shape[0] != FUSE_POINTS):
        return None
    return (str(device), tuple((tuple(x.shape), x.dtype) for x in inputs), intr)


def build(intr):
    """The `build` that `CapturedCalls.run` takes: `_fuse_match_batch` on a
    block's seven tensors, with the log scale made on their device
    beforehand."""
    def call_on(tensors):
        log_scale = octave_log_scale(tensors[0].device)
        return lambda: _fuse_match_batch(*tensors, intr, log_scale=log_scale)
    return call_on


def match(inputs: tuple, intr, device, graphs: CapturedCalls = GRAPHS, fetch=fetch):
    """`fetch` of `_fuse_match_batch(*inputs, intr)` for the host block
    `inputs` (`_kf_stack`'s five tensors, then `_point_block`'s two),
    matched on `device` through `graphs`."""
    return graphs.run(key(inputs, intr, device), device, inputs, build(intr), fetch)
