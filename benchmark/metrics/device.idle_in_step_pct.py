"""Share of the traced window in which the device runs nothing while the
tracker thread is inside a `tracker.dispatch` span (the fused step's
launches): the idle time a faster enqueue of the step could take back.

Also writes one line to standard error (not into the result): the
window's idle time by the pair of spans open at each gap's middle, the
tracker thread's innermost and the mapping worker's
(benchmark/program_spans.py)."""

import sys

from benchmark import program_spans


def read(obs):
    tr = obs.trace
    sp = program_spans.spans(obs)
    steps = [(s.start_ns, s.end_ns) for s in program_spans.named(sp, "tracker.dispatch")]
    if not steps or not tr.events:
        return None
    print(program_spans.attribution_line(tr.gaps, sp, tr.window_s), file=sys.stderr, flush=True)
    return 100.0 * program_spans.overlap_ns(tr.gaps, steps) * 1e-9 / tr.window_s
