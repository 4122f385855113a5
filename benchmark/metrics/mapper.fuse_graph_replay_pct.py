"""Share of fusion's block matches wholly inside the window that replayed
the captured CUDA graph (spslam_tpu_torch/mapping/fuse_graph.py): the
`mapper.fuse_match` spans that hold a `mapper.fuse_replay` span of their
own thread, over all `mapper.fuse_match` spans, x100.  A match that ran
its kernels one by one (its shape's first call and capture, a failed
capture) holds none.  None without a match in the window, off a CUDA
device (no match takes a graph there) and from a program without the
graph."""

import importlib.util

import torch

from benchmark import program_spans


def _has_graph() -> bool:
    try:
        return importlib.util.find_spec("spslam_tpu_torch.mapping.fuse_graph") is not None
    except ImportError:
        return False


def read(obs):
    if torch.device(obs.device).type != "cuda" or not _has_graph():
        return None
    sp = program_spans.whole(obs)
    matches = program_spans.named(sp, "mapper.fuse_match")
    if not matches:
        return None
    replays = program_spans.named(sp, "mapper.fuse_replay")
    held = sum(1 for m in matches if any(r.thread == m.thread and m.start_ns <= r.start_ns
                                         and r.end_ns <= m.end_ns for r in replays))
    return 100.0 * held / len(matches)
