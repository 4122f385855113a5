"""The local mapper's bundle adjustment replayed as one CUDA graph.

At the local mapper's shape (M 24, P 4,096, R 16,384, L 16, Q 64, E 32;
4 + 6 LM iterations) one `bundle_adjust` is ~20,000 small device
operations (19,897 under the profiler on an H100, ~52 ms of device time),
and launching them one by one holds the mapping worker on a CPU for
0.5-1.6 s a call, the more the busier the tracker.  The solve is already
fit for capture: `MapperConfig` pads every shape, the LM accepts or
rejects by `torch.where` and `cho_solve` never syncs.  So it is captured
once per problem shape and replayed; the arithmetic, precision and
iteration counts are `bundle_adjust`'s, only the launches change.

`GRAPHS` is the process's one cache, since a System is built per session
and several Systems may share a process.  It keeps one entry per device,
field shapes and dtypes, `Intrinsics` (their floats are constants of the
captured kernels) and iteration counts: a static `BAProblem` on the device,
a side stream and the graph that solves the static problem.  A call copies
the host problem into the static tensors, replays and fetches the four
outputs the mapper writes back, all under one lock.  The first call of a
key runs `bundle_adjust` eagerly on the static tensors for its answer,
which also warms up what a capture must not do (cuBLAS and cuSOLVER
handles, the allocator), then captures the same call on the side stream in
thread-local mode: the tracker keeps launching on its own stream
meanwhile.  A capture that fails is logged once and leaves its key eager.

Only a problem at the local mapper's shape on a CUDA device takes a graph.
On the CPU the solve stays eager, and the post-loop global BA (whose shape
changes with every closure) calls `bundle_adjust` itself.
"""

from __future__ import annotations

import logging
import threading

import torch

from .. import tracing
from ..solver.ba import BAProblem, BAResult, bundle_adjust

log = logging.getLogger(__name__)


def problem_dims(prob: BAProblem) -> tuple:
    """(M, P, R, OMAX, L, Q, E) of a problem."""
    return (prob.poses.shape[0], prob.points.shape[0], prob.obs_cam.shape[0],
            prob.pt_obs.shape[1], prob.planes.shape[0], prob.pobs_cam.shape[0],
            prob.pp_a.shape[0])


def mapper_dims(cfg) -> tuple:
    """(M, P, R, OMAX, L, Q, E) that `LocalMapper.build_problem` pads to
    under the MapperConfig `cfg`."""
    return (cfg.ba_max_poses, cfg.ba_max_points, cfg.ba_max_obs, cfg.ba_obs_per_point,
            cfg.ba_max_planes, cfg.ba_max_plane_obs, cfg.ba_max_pp_edges)


def to_device(prob: BAProblem, device) -> BAProblem:
    return BAProblem(*(x.to(device) for x in prob))


def fetch(res: BAResult) -> tuple:
    """(poses, points, planes, obs_inlier) as numpy arrays: what the mapper
    writes back."""
    return tuple(x.cpu().numpy() for x in (res.poses, res.points, res.planes, res.obs_inlier))


class StaticBA:
    """Tensors shaped as one problem on `device`, filled in place from a
    host problem, and the solve that reads them."""

    def __init__(self, like: BAProblem, intr, stage1_iters: int, stage2_iters: int, device):
        self.prob = BAProblem(*(torch.empty(x.shape, dtype=x.dtype, device=device)
                                for x in like))
        self.intr = intr
        self.iters = (stage1_iters, stage2_iters)

    def load(self, host: BAProblem):
        for dst, src in zip(self.prob, host):
            dst.copy_(src)

    def solve(self) -> BAResult:
        return bundle_adjust(self.prob, self.intr, *self.iters)


class _Entry:
    __slots__ = ("static", "stream", "graph", "out")

    def __init__(self, static: StaticBA, stream):
        self.static = static
        self.stream = stream
        self.graph = None     # None: capture failed, the key stays eager
        self.out = None       # the captured solve's output tensors


class BAGraphs:
    """Captured local-BA solves by key, and counts of what they did."""

    def __init__(self):
        self._lock = threading.Lock()
        self._entries: dict = {}
        self.captures = 0
        self.replays = 0
        self.failures = 0

    @staticmethod
    def key(prob: BAProblem, intr, cfg, device):
        """The cache key of a local BA, or None where it stays eager: off a
        CUDA device, or at another shape than the local mapper's."""
        device = torch.device(device)
        if device.type != "cuda" or problem_dims(prob) != mapper_dims(cfg):
            return None
        return (str(device), tuple((tuple(x.shape), x.dtype) for x in prob), intr,
                cfg.ba_stage1_iters, cfg.ba_stage2_iters)

    def solve(self, prob: BAProblem, intr, cfg, device) -> tuple:
        """`fetch` of `bundle_adjust(prob)` for the host problem `prob` built
        under the MapperConfig `cfg`, solved on `device`."""
        key = self.key(prob, intr, cfg, device)
        if key is None:
            return fetch(bundle_adjust(to_device(prob, device), intr, cfg.ba_stage1_iters,
                                       cfg.ba_stage2_iters))
        with self._lock:
            e = self._entries.get(key)
            if e is None:
                return self._first(key, prob, intr, cfg, torch.device(device))
            with torch.cuda.device(e.stream.device), torch.cuda.stream(e.stream):
                if e.graph is None:
                    e.static.load(prob)
                    return fetch(e.static.solve())
                with tracing.span("mapper.ba_replay"):
                    e.static.load(prob)
                    e.graph.replay()
                    out = fetch(e.out)
                self.replays += 1
                return out

    def _first(self, key, prob, intr, cfg, device) -> tuple:
        """The eager answer of a new key's first call, then its capture."""
        stream = torch.cuda.Stream(device)
        stream.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.device(device), torch.cuda.stream(stream):
            e = _Entry(StaticBA(prob, intr, cfg.ba_stage1_iters, cfg.ba_stage2_iters, device),
                       stream)
            e.static.load(prob)
            answer = fetch(e.static.solve())
        self._entries[key] = e
        graph = torch.cuda.CUDAGraph()
        try:
            with tracing.span("mapper.ba_capture"), torch.cuda.device(device), \
                    torch.cuda.graph(graph, stream=stream, capture_error_mode="thread_local"):
                out = e.static.solve()
        except RuntimeError:
            self.failures += 1
            log.exception("local BA: CUDA graph capture failed on %s at %s; this shape stays "
                          "eager", device, problem_dims(prob))
            return answer
        e.graph, e.out = graph, out
        self.captures += 1
        return answer


# the process's one cache: every LocalMapper solves through it
GRAPHS = BAGraphs()
