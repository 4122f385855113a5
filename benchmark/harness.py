"""One run of one cell: set-up, the measured window, the flush, the metrics
and the check.

The traffic is a stream of sessions.  A session is a new
`System(SystemConfig(...))` fed one rendered RGB-D sequence through
`track_rgbd`, closed loop (the next frame is handed in when the call
returns), and ended by `shutdown()`; sessions run back to back until the
window ends.  Building each System and its `shutdown()` fall inside the
window.  The session that the window cuts is flushed after it, outside the
timing, with `poses()`, so that its frames count for the latency and the
ATE.  A frame resolves when `System.trajectory` grows past it.
"""

from __future__ import annotations

import gc
import sys
import time
import traceback
from typing import List, NamedTuple, Optional

import numpy as np
import torch

from . import check, spec, stats, traffic
from . import trace as trace_mod

# Host spans of traced runs around the System's workers, by label: they
# name the device's idle gaps and feed the per-layer readers.
HOST_SPANS = {
    "mapper": "mapper.process_keyframe",
    "plane mapper": "plane_mapper.process_keyframe",
    "loop closer": "loop_closer.process_keyframe",
}


def log(msg: str):
    print(msg, file=sys.stderr, flush=True)


class Spans:
    """(label, start ns, end ns) host spans on the profiler's clock."""

    def __init__(self):
        self.items: List[tuple] = []

    def add(self, label: str, t0: int):
        self.items.append((label, t0, time.time_ns()))

    def wrap(self, root, path: str, label: str):
        """Put a span around the instance method root.<path>, if its owner
        exists."""
        *owners, meth = path.split(".")
        owner = root
        for name in owners:
            owner = getattr(owner, name, None)
            if owner is None:
                return
        fn = getattr(owner, meth)

        def wrapped(*a, **kw):
            t0 = time.time_ns()
            try:
                return fn(*a, **kw)
            finally:
                self.add(label, t0)

        setattr(owner, meth, wrapped)


class SessionLog(NamedTuple):
    index: int
    t_start: List[float]          # per handed-in frame: start of its call
    t_resolved: List[Optional[float]]
    poses_gt: np.ndarray
    poses: Optional[np.ndarray]   # System.poses() at the session's end
    lost: int
    errors: int
    perf: dict


class Window(NamedTuple):
    sessions: List[SessionLog]
    t_open: float
    t_close: float
    t_open_ns: int
    t_close_ns: int


class Observations(NamedTuple):
    """What the per-layer readers read (benchmark/metrics/__init__.py)."""
    perf: dict
    spans: list
    trace: trace_mod.DeviceTrace
    frames_resolved: int
    config: dict
    frames: list         # the u8 gray frames handed in during the window
    device: torch.device


class Bench:
    def __init__(self, cell: spec.Cell, seed: int, device, trace: bool = False):
        self.cell = cell
        self.seed = seed
        self.device = torch.device(device)
        self.trace = trace
        self.spans = Spans()
        self.readers = {m["name"]: spec.metric_reader(m["name"]) for m in cell.per_layer} \
            if trace else {}
        self.capture = check.Capture(seed, int(cell.limits["check_steps"]))
        self.sessions: List[traffic.Session] = []
        self.warm_frames = 0
        self.prof = None

    # -------------------------------------------------------------- set-up
    def _system(self):
        from spslam_tpu_torch.system import System

        return System(spec.system_config(self.cell.config), device=self.device)

    def setup(self, warm: bool = True):
        """Render the sessions, warm the cell's paths up on a throwaway
        System and hook the fused step for the check."""
        self.sessions = traffic.make_sessions(self.cell.traffic, self.cell.config, self.seed,
                                              self.device)
        if warm:
            self.warm_frames = self._warm()
        self.capture.install()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
            torch.cuda.reset_peak_memory_stats(self.device)

    def _warm(self) -> int:
        """Frames through a throwaway System until a keyframe insert from
        tracking, a local BA and, with planes, a plane-mapper keyframe (its
        segmentation) have each run once: the first use of every kernel
        and library handle the window will need."""
        sys_ = self._system()
        ran = Spans()
        ran.wrap(sys_, "mapper.local_ba", "ba")
        ran.wrap(sys_, "plane_mapper.process_keyframe", "planes")

        def done(label):
            return sum(1 for item in ran.items if item[0] == label)

        s = self.sessions[0]
        n = 0
        for i in range(len(s.ts)):
            sys_.track_rgbd(s.gray[i], s.depth[i], float(s.ts[i]))
            n += 1
            if sys_.pipeline is not None and sys_.store.n_kf >= 3:
                sys_.pipeline.flush()    # let the worker's first local BA land
            if (done("ba") >= 1
                    and (sys_.plane_mapper is None or done("planes") >= 1)):
                break
        sys_.shutdown()
        log(f"warm-up: {n} frames, local BAs {done('ba')}, plane keyframes {done('planes')}")
        return n

    # -------------------------------------------------------------- window
    def _open_session(self):
        t0 = time.time_ns()
        sys_ = self._system()
        if self.trace:
            sys_.tracker.perf = {}
            paths = dict(HOST_SPANS)
            for r in self.readers.values():
                paths.update(getattr(r, "SPANS", {}))
            for label, path in paths.items():
                self.spans.wrap(sys_, path, label)
        self.spans.add("session start", t0)
        return sys_

    @staticmethod
    def _end_log(k, sys_, seq, t_start, ends, n_traj, errors) -> SessionLog:
        try:
            poses = sys_.poses()
        except Exception:
            traceback.print_exc()
            poses, errors = None, errors + 1
        lost = sum(1 for m in sys_.tracker.metrics if m.get("state") == "LOST")
        n = len(t_start) if poses is None else len(poses)   # a call that raised adds no pose
        t_res = stats.resolved_times(ends, n_traj)
        t_res += [None] * (len(t_start) - len(t_res))
        return SessionLog(k, t_start, t_res, seq.poses_gt[:n], poses, lost, errors,
                          dict(sys_.tracker.perf or {}))

    def window(self, seconds: float) -> Window:
        """Sessions back to back for `seconds`; then the cut session's flush."""
        logs: List[SessionLog] = []
        if self.trace:
            self.prof = trace_mod.start(self.device)
        self.capture.active = True
        t_open_ns = time.time_ns()
        t_open = time.perf_counter()
        t_end = t_open + seconds
        k, cut = 0, None
        while time.perf_counter() < t_end:
            seq = self.sessions[k % len(self.sessions)]
            sys_ = self._open_session()
            t_start: List[float] = []
            ends: List[float] = []      # per call, flush or stop: its end ...
            n_traj: List[int] = []      # ... and the frames resolved by then
            errors = 0
            for i in range(len(seq.ts)):
                t_a = time.perf_counter()
                if t_a >= t_end:
                    break
                self.capture.current = (k, i)
                t_a_ns = time.time_ns()
                try:
                    sys_.track_rgbd(seq.gray[i], seq.depth[i], float(seq.ts[i]))
                except Exception:
                    traceback.print_exc()
                    errors += 1
                ends.append(time.perf_counter())
                n_traj.append(len(sys_.trajectory))
                self.spans.add("tracker call", t_a_ns)
                t_start.append(t_a)
                if errors:
                    break
            if len(t_start) < len(seq.ts) and not errors:
                cut = (k, sys_, seq, t_start, ends, n_traj)
                break
            t0 = time.time_ns()
            try:
                sys_.shutdown()
            except Exception:
                traceback.print_exc()
                errors += 1
            ends.append(time.perf_counter())
            n_traj.append(len(sys_.trajectory))
            logs.append(self._end_log(k, sys_, seq, t_start, ends, n_traj, errors))
            self.spans.add("session stop", t0)
            del sys_
            k += 1
        t_close = time.perf_counter()
        t_close_ns = time.time_ns()
        self.capture.active = False
        if self.prof is not None:
            self.prof.stop()
        if cut is not None:
            k, sys_, seq, t_start, ends, n_traj = cut
            if t_start:
                sys_.poses()    # resolves every frame handed in
                ends.append(time.perf_counter())
                n_traj.append(len(sys_.trajectory))
            sys_.shutdown()
            if t_start:
                logs.append(self._end_log(k, sys_, seq, t_start, ends, n_traj, 0))
            del sys_
        return Window(logs, t_open, t_close, t_open_ns, t_close_ns)

    # ------------------------------------------------------------- results
    @staticmethod
    def end_to_end(w: Window, setup_s: float) -> dict:
        t_start = [t for s in w.sessions for t in s.t_start]
        t_res = [t for s in w.sessions for t in s.t_resolved]
        done = [(a, b) for a, b in zip(t_start, t_res) if b is not None]
        return {
            "frames_per_s": stats.frames_per_s(t_res, w.t_open, w.t_close),
            "pose_latency_ms_p90": stats.latency_p90_ms(*zip(*done)),
            "ate_mm": stats.pooled_ate_mm((s.poses, s.poses_gt) for s in w.sessions
                                          if s.poses is not None and len(s.poses)),
            "setup_s": setup_s,
        }

    @staticmethod
    def counts(w: Window) -> tuple:
        """(attempted, failed): frames handed in during the window, and those
        that resolved LOST, raised or never resolved."""
        attempted = sum(len(s.t_start) for s in w.sessions)
        unresolved = sum(1 for s in w.sessions for t in s.t_resolved if t is None)
        failed = sum(s.lost + s.errors for s in w.sessions) + unresolved
        return attempted, min(failed, attempted)

    def per_layer(self, w: Window) -> tuple:
        """({metric: value} of the cell's readers, the breakdown, the trace)."""
        tr = trace_mod.summarize(trace_mod.device_events(self.prof), w.t_open_ns, w.t_close_ns)
        perf: dict = {}
        for s in w.sessions:
            for key, v in s.perf.items():
                perf[key] = perf.get(key, 0) + v
        resolved = sum(1 for s in w.sessions for t in s.t_resolved
                       if t is not None and t <= w.t_close)
        frames = [self.sessions[s.index % len(self.sessions)].gray[i]
                  for s in w.sessions for i in range(len(s.t_start))]
        obs = Observations(perf, self.spans.items, tr, resolved, self.cell.config, frames,
                           self.device)
        out = {}
        for name, r in self.readers.items():
            v = r.read(obs)
            if v is not None:
                out[name] = v
        return out, trace_mod.breakdown(tr, self.spans.items), tr

    def release(self):
        """Free the program's state before the reference runs."""
        self.capture.remove()
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
            torch.cuda.empty_cache()
