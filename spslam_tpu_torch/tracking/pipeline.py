"""Asynchronous mapping: tracking goes on while local BA, plane mapping and
loop closing run on a background thread (port of
spslam_tpu/tracking/pipeline.py).

The reference's Tracking || LocalMapping || LoopClosing threads collapse to
one worker beside the tracker:

* one MapStore lock, held only for short host-side mutations; the device
  work of the mapper (local BA, pose graph) runs outside it;
* append-only ids, so a BA write-back touches only ids that existed when
  its window was assembled;
* a version counter: the worker refreshes the tracker's local-map snapshot
  after its write-back (`Tracker.refresh_snapshot_values`), so the
  tracker's next dispatch finds it current.

Queued keyframes are coalesced: if tracking outruns mapping, plane and loop
handling run for every keyframe and BA once, on the newest.

Both threads use the System's device and its one default CUDA stream (the
worker sets the thread's current device; every batched Jacobian takes
`solver/ba.batched_jacfwd`'s lock).  A keyframe whose mapping raises is
logged (logger `spslam_tpu_torch.tracking.pipeline`) and the worker goes
on, as the reference's does.

With the span recorder on (`tracing.py`), each keyframe's wait in the
queue, from `submit` to the worker taking it up, is a `pipeline.queue_wait`
span on the worker's thread, and its mapping a `worker.keyframe` span.
"""

from __future__ import annotations

import logging
import threading
import time
from collections import deque

import torch

from .. import tracing

log = logging.getLogger(__name__)


class AsyncMappingPipeline:
    def __init__(self, system):
        self.system = system
        self._queue: deque = deque()
        self._cv = threading.Condition()
        self._stop = False
        self._busy = False
        self.n_submitted = 0
        self.n_processed = 0
        self.n_coalesced = 0
        self._thread = threading.Thread(target=self._worker, daemon=True, name="mapping")
        self._thread.start()

    # -----------------------------------------------------------------
    def submit(self, kf: int, gray, depth):
        t_submit = time.time_ns() if tracing.ENABLED else 0
        with self._cv:
            self._queue.append((kf, gray, depth, t_submit))
            self.n_submitted += 1
            self._cv.notify()

    def idle(self) -> bool:
        with self._cv:
            return not self._queue and not self._busy

    def queue_len(self) -> int:
        """Queued + in-flight keyframes (the tracker's keyframe gate reads it)."""
        with self._cv:
            return len(self._queue) + (1 if self._busy else 0)

    def flush(self, timeout: float = 120.0):
        """Block until all queued keyframes are processed."""
        t0 = time.time()
        while not self.idle() and time.time() - t0 < timeout:
            time.sleep(0.005)

    def shutdown(self):
        self.flush()
        with self._cv:
            self._stop = True
            self._cv.notify()
        self._thread.join(timeout=10.0)

    # -----------------------------------------------------------------
    def _worker(self):
        sys_ = self.system
        if sys_.device.type == "cuda":
            torch.cuda.set_device(sys_.device)
        while True:
            with self._cv:
                while not self._queue and not self._stop:
                    self._cv.wait()
                if self._stop and not self._queue:
                    return
                # coalesce: plane / loop handling for all, BA on the newest
                items = list(self._queue)
                self._queue.clear()
                self._busy = True
            for *_, t_submit in items:
                if t_submit:
                    tracing.mark("pipeline.queue_wait", t_submit)
            try:
                for i, (kf, gray, depth, _) in enumerate(items):
                    newest = i == len(items) - 1
                    # one keyframe's failure must not end the worker
                    try:
                        with tracing.span("worker.keyframe"):
                            self._process(kf, depth, newest)
                    except Exception:
                        log.exception("mapping worker: keyframe %d failed; continuing", kf)
                    self.n_processed += 1
                self.n_coalesced += max(len(items) - 1, 0)
            finally:
                with self._cv:
                    self._busy = False

    def _process(self, kf: int, depth, newest: bool):
        """Map one keyframe: planes, local mapping (BA only on the newest of
        a coalesced batch), loop closing, then the snapshot refresh."""
        sys_ = self.system
        if sys_.plane_mapper is not None:
            sys_.plane_mapper.process_keyframe(kf, depth)
        sys_.mapper.process_keyframe(kf, run_ba=sys_.cfg.local_ba and newest)
        if sys_.loop_closer is not None:
            # a closure carries the tracker along itself (System sets the
            # loop closer's on_correction to Tracker.correct_map_frame)
            sys_.loop_closer.process_keyframe(kf, detect=sys_.cfg.use_loop)
        # the write-back bumped the store version: re-gather the tracker's
        # snapshot here, off its critical path
        sys_.tracker.refresh_snapshot_values()
