"""Mean wall ms of one call of System.loop_closer.process_keyframe (BoW,
keyframe database, detection gates)."""

LABEL = "loop closer"


def read(obs):
    d = [t1 - t0 for label, t0, t1 in obs.spans if label == LABEL]
    return sum(d) / len(d) * 1e-6 if d else None
