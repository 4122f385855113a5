"""Keyframe database: the word -> keyframe inverted index for loop and
relocalization candidates (port of spslam_tpu/loop/kfdb.py, its pure-
Python index).  DBoW2 gating: common words >= 0.8 x the best count, score
>= the caller's minimum.

The reference loads its native C++ index (spslam_tpu/native) when the
library is there; its tests hold the two to the same semantics, and the
port's tests hold this index to both.  The native index is not ported.
"""

from __future__ import annotations

from collections import defaultdict

from .vocab import bow_similarity


class KeyFrameDatabase:
    def __init__(self):
        self.inverted: dict[int, list[int]] = defaultdict(list)
        self.bow: dict[int, dict[int, float]] = {}

    def add(self, kf: int, bow_vec: dict[int, float]):
        self.bow[kf] = bow_vec
        for w in bow_vec:
            self.inverted[w].append(kf)

    def erase(self, kf: int):
        vec = self.bow.pop(kf, None)
        for w in vec or ():
            lst = self.inverted.get(w)
            if lst and kf in lst:
                lst.remove(kf)

    def query(self, bow_vec: dict[int, float], exclude: set[int], min_score: float,
              max_results: int = 8) -> list[tuple[int, float]]:
        """Candidates sharing words with the query, best score first.
        exclude: keyframes never returned (the query and its neighbours)."""
        if not bow_vec:
            return []
        common = defaultdict(int)
        for w in bow_vec:
            for kf in self.inverted.get(w, ()):
                if kf not in exclude:
                    common[kf] += 1
        if not common:
            return []
        th = max(int(0.8 * max(common.values())), 1)
        scored = []
        for kf, c in common.items():
            if c < th:
                continue
            s = bow_similarity(bow_vec, self.bow.get(kf, {}))
            if s >= min_score:
                scored.append((kf, s))
        scored.sort(key=lambda x: -x[1])
        return scored[:max_results]
