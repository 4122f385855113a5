"""Mean wall ms of one call of System.mapper.process_keyframe (local
mapping: point maintenance, fusion, local BA) on the async worker, GIL
waits included."""

LABEL = "mapper"


def read(obs):
    d = [t1 - t0 for label, t0, t1 in obs.spans if label == LABEL]
    return sum(d) / len(d) * 1e-6 if d else None
