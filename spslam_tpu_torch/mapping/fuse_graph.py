"""Fusion's projection match replayed as one CUDA graph.

`fuse._fuse_match_batch` projects a block of FUSE_POINTS map points into a
stack of FUSE_TARGETS keyframes and Hamming-matches them there: ~1,200
operations and ~940 kernels a block on an H100 (eight targets, each a
projection, a window gate and a 1,024 x 256 x N product), 3-4 blocks a
keyframe.  Launching them one by one holds the mapping worker on a CPU
for most of fusion's time.  The match is already fit for capture: `_point_block` and
`_kf_stack` pad every block to one shape, the gates are fixed and nothing
in the chain syncs with the host but the one scalar `project_points`
makes, which `StaticFuse` makes once beforehand.  So it is captured once
and replayed; the kernels, shapes, float32 arithmetic, gates and padded
targets are `_fuse_match_batch`'s, only the launches change.

`GRAPHS` is the process's one cache, since a System is built per session
and several Systems may share a process.  It keeps one entry per device,
input shapes and dtypes and `Intrinsics` (their floats are constants of
the captured kernels): the static inputs on the device, a side stream and
the graph that matches them.  A call copies the host block into the static
tensors, replays and fetches the matched slots, all under one lock and on
the side stream, so the worker's fetch does not wait behind the tracker's
queued kernels on the default stream.  The first call of a key runs the
match eagerly on the static tensors for its answer, which also warms up
what a capture must not do (cuBLAS handles, the allocator), then captures
the same call in thread-local mode: the tracker keeps launching on its
own stream meanwhile.  A capture that fails is logged once and leaves its
key eager.

Only a block of [FUSE_TARGETS, FUSE_POINTS] on a CUDA device takes a
graph; on the CPU the match stays eager.
"""

from __future__ import annotations

import logging
import threading

import torch

from .. import tracing
from ..tracking.tracker import octave_log_scale
from .fuse import FUSE_POINTS, FUSE_TARGETS, _fuse_match_batch

log = logging.getLogger(__name__)


def fetch(out: tuple, dist: bool):
    """The matched slots [T, P] as a numpy array, with the distances beside
    them when `dist`."""
    idx = out[0].cpu().numpy()
    return (idx, out[1].cpu().numpy()) if dist else idx


class StaticFuse:
    """Tensors shaped as one block's inputs (`_fuse_match_batch`'s seven
    tensors, in its order) on `device`, filled in place from a host block,
    and the match that reads them."""

    def __init__(self, like: tuple, intr, device):
        self.inputs = tuple(torch.empty(x.shape, dtype=x.dtype, device=device) for x in like)
        self.intr = intr
        self.log_scale = octave_log_scale(device)

    def load(self, host: tuple):
        for dst, src in zip(self.inputs, host):
            dst.copy_(src)

    def match(self) -> tuple:
        return _fuse_match_batch(*self.inputs, self.intr, log_scale=self.log_scale)


class _Entry:
    __slots__ = ("static", "stream", "graph", "out")

    def __init__(self, static: StaticFuse, stream):
        self.static = static
        self.stream = stream
        self.graph = None     # None: capture failed, the key stays eager
        self.out = None       # the captured match's output tensors


class FuseGraphs:
    """Captured fusion matches by key, and counts of what they did."""

    def __init__(self):
        self._lock = threading.Lock()
        self._entries: dict = {}
        self.captures = 0
        self.replays = 0
        self.failures = 0

    @staticmethod
    def key(inputs: tuple, intr, device):
        """The cache key of a block, or None where it stays eager: off a
        CUDA device, or at another shape than [FUSE_TARGETS, FUSE_POINTS]."""
        device = torch.device(device)
        if (device.type != "cuda" or inputs[0].shape[0] != FUSE_TARGETS
                or inputs[5].shape[0] != FUSE_POINTS):
            return None
        return (str(device), tuple((tuple(x.shape), x.dtype) for x in inputs), intr)

    def match(self, inputs: tuple, intr, device, dist: bool = False):
        """`fetch` of `_fuse_match_batch(*inputs, intr)` for the host block
        `inputs` (`_kf_stack`'s five tensors, then `_point_block`'s two),
        matched on `device`."""
        key = self.key(inputs, intr, device)
        if key is None:
            return fetch(_fuse_match_batch(*(x.to(device) for x in inputs), intr), dist)
        with self._lock:
            e = self._entries.get(key)
            if e is None:
                return self._first(key, inputs, intr, torch.device(device), dist)
            with torch.cuda.device(e.stream.device), torch.cuda.stream(e.stream):
                if e.graph is None:
                    e.static.load(inputs)
                    return fetch(e.static.match(), dist)
                with tracing.span("mapper.fuse_replay"):
                    e.static.load(inputs)
                    e.graph.replay()
                    out = fetch(e.out, dist)
                self.replays += 1
                return out

    def _first(self, key, inputs, intr, device, dist: bool):
        """The eager answer of a new key's first call, then its capture."""
        stream = torch.cuda.Stream(device)
        stream.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.device(device), torch.cuda.stream(stream):
            e = _Entry(StaticFuse(inputs, intr, device), stream)
            e.static.load(inputs)
            answer = fetch(e.static.match(), dist)
        self._entries[key] = e
        graph = torch.cuda.CUDAGraph()
        try:
            with tracing.span("mapper.fuse_capture"), torch.cuda.device(device), \
                    torch.cuda.graph(graph, stream=stream, capture_error_mode="thread_local"):
                out = e.static.match()
        except RuntimeError:
            self.failures += 1
            log.exception("fusion: CUDA graph capture failed on %s at %s; this shape stays "
                          "eager", device, [tuple(x.shape) for x in inputs])
            return answer
        e.graph, e.out = graph, out
        self.captures += 1
        return answer


# the process's one cache: every fusion matches through it
GRAPHS = FuseGraphs()
