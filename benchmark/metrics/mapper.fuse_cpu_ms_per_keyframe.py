"""Mean CPU ms of the mapping worker in one `mapper.fuse` span that lies
wholly inside the window (fusion of a new keyframe with its neighbours,
`spslam_tpu_torch/mapping/fuse.py`: the device match of each block and
the host merge of its matches)."""

from benchmark import program_spans


def read(obs):
    return program_spans.mean_cpu_ms(program_spans.whole(obs), "mapper.fuse")
