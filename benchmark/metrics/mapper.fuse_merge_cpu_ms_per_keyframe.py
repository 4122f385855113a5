"""CPU ms of fusion's host merge a keyframe: the summed CPU time of the
`mapper.fuse_merge` spans (one block's `_merge_matches`, the store's lock
included) that lie inside a `mapper.fuse` span of their own thread, over
the number of `mapper.fuse` spans, all wholly inside the window.  A loop
closure's fusion is left out: it merges outside `mapper.fuse`.  None
without a `mapper.fuse` span in the window and from a program without the
merge span."""

from benchmark import program_spans


def read(obs):
    sp = program_spans.whole(obs)
    fuses = program_spans.named(sp, "mapper.fuse")
    merges = program_spans.named(sp, "mapper.fuse_merge")
    if not fuses or not merges:
        return None
    cpu_ns = sum(m.cpu_ns for m in merges
                 if any(f.thread == m.thread and f.start_ns <= m.start_ns
                        and m.end_ns <= f.end_ns for f in fuses))
    return cpu_ns * 1e-6 / len(fuses)
