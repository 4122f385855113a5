"""Mean wall ms a keyframe waits in the async mapping queue: one
`pipeline.queue_wait` span per keyframe, from the tracker's submit to the
worker taking it up, over the spans wholly inside the window."""

from benchmark import program_spans


def read(obs):
    d = [s.end_ns - s.start_ns for s in program_spans.named(program_spans.whole(obs),
                                                            "pipeline.queue_wait")]
    return sum(d) / len(d) * 1e-6 if d else None
