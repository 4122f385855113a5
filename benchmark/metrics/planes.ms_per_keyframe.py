"""Mean wall ms of one call of System.plane_mapper.process_keyframe
(keyframe plane segmentation at full size, association, merge)."""

LABEL = "plane mapper"


def read(obs):
    d = [t1 - t0 for label, t0, t1 in obs.spans if label == LABEL]
    return sum(d) / len(d) * 1e-6 if d else None
