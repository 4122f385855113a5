"""Kernel launches in the traced window over the frames resolved there."""


def read(obs):
    k = len(obs.trace.kernels())
    return k / obs.frames_resolved if k and obs.frames_resolved else None
