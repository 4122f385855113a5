"""Share of the local BAs wholly inside the window that replayed the
captured CUDA graph (spslam_tpu_torch/mapping/ba_graph.py): the
`mapper.local_ba` spans that hold a `mapper.ba_replay` span of their own
thread, over all `mapper.local_ba` spans, x100.  A local BA that ran its
kernels one by one (its shape's first call and capture, a failed capture,
a window too small to solve) holds none.  None without a local BA in the
window, off a CUDA device (no local BA takes a graph there) and from a
program without the graph."""

import importlib.util

import torch

from benchmark import program_spans


def _has_graph() -> bool:
    try:
        return importlib.util.find_spec("spslam_tpu_torch.mapping.ba_graph") is not None
    except ImportError:
        return False


def read(obs):
    if torch.device(obs.device).type != "cuda" or not _has_graph():
        return None
    sp = program_spans.whole(obs)
    bas = program_spans.named(sp, "mapper.local_ba")
    if not bas:
        return None
    replays = program_spans.named(sp, "mapper.ba_replay")
    held = sum(1 for b in bas if any(r.thread == b.thread and b.start_ns <= r.start_ns
                                     and r.end_ns <= b.end_ns for r in replays))
    return 100.0 * held / len(bas)
