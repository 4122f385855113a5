"""Calls captured once as CUDA graphs and replayed on static tensors.

A call site gives its key (None where it stays eager), the host inputs, a
`build` and a `fetch`; the kernels, shapes and arithmetic stay the call's
own, only the launches change.  A key's first call makes static tensors
shaped as the inputs on the device, has `build` make the call on them
(per-key constants included: a captured call copies no host number),
loads them by `copy_` and runs the call eagerly on a side stream for its
answer, which warms up what a capture must not do (cuBLAS and cuSOLVER
handles, the allocator).  It then captures the call on that stream in
thread-local mode, so other threads keep launching meanwhile; a failed
capture is logged and leaves its key eager.  Later calls load, replay and
fetch under the lock and on the side stream, so the fetch does not wait
behind the default stream's queue.  Spans: `<prefix>_replay` (load,
replay, fetch) and `<prefix>_capture`.
"""

from __future__ import annotations

import logging
import threading

import torch

from . import tracing

log = logging.getLogger(__name__)


def static_call(like: tuple, build, device) -> tuple:
    """(tensors shaped as `like` on `device`, `build(tensors)`): the inputs a
    capture reads and the call it records."""
    static = tuple(torch.empty(x.shape, dtype=x.dtype, device=device) for x in like)
    return static, build(static)


def load(static: tuple, host: tuple):
    for dst, src in zip(static, host):
        dst.copy_(src)


class CapturedCalls:
    """Captured calls by key, and counts of what they did."""

    def __init__(self, span_prefix: str):
        self._prefix = span_prefix
        self._lock = threading.Lock()
        # key -> (static tensors, call, side stream, graph, the graph's
        # outputs); graph None: the capture failed, the key stays eager
        self._entries: dict = {}
        self.captures = 0
        self.replays = 0
        self.failures = 0

    def run(self, key, device, inputs: tuple, build, fetch):
        """`fetch(build(inputs on device)())`.  `build(tensors)` returns a
        call of no arguments on those tensors, made once per key; with
        `key` None the call is built and run eagerly each time."""
        if key is None:
            return fetch(build(tuple(x.to(device) for x in inputs))())
        with self._lock:
            if key not in self._entries:
                return self._first(key, torch.device(device), inputs, build, fetch)
            static, call, stream, graph, out = self._entries[key]
            with torch.cuda.device(stream.device), torch.cuda.stream(stream):
                if graph is None:
                    load(static, inputs)
                    return fetch(call())
                with tracing.span(self._prefix + "_replay"):
                    load(static, inputs)
                    graph.replay()
                    got = fetch(out)
                self.replays += 1
                return got

    def _first(self, key, device, inputs, build, fetch):
        """The eager answer of a new key's first call, then its capture."""
        stream = torch.cuda.Stream(device)
        stream.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.device(device), torch.cuda.stream(stream):
            static, call = static_call(inputs, build, device)
            load(static, inputs)
            answer = fetch(call())
        self._entries[key] = (static, call, stream, None, None)
        graph = torch.cuda.CUDAGraph()
        try:
            with tracing.span(self._prefix + "_capture"), torch.cuda.device(device), \
                    torch.cuda.graph(graph, stream=stream, capture_error_mode="thread_local"):
                out = call()
        except RuntimeError:
            self.failures += 1
            log.exception("%s: CUDA graph capture failed on %s at %s; this key stays eager",
                          self._prefix, device, [tuple(x.shape) for x in inputs])
            return answer
        self._entries[key] = (static, call, stream, graph, out)
        self.captures += 1
        return answer
