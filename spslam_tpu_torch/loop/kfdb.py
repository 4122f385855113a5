"""Keyframe database: the word -> keyframe inverted index for loop and
relocalization candidates (port of spslam_tpu/loop/kfdb.py).  DBoW2
gating: common words >= 0.8 x the best count, score >= the caller's
minimum.

Backed by the native C++ index (native/src/bow_index.cc, built with g++ at
first use) when the library builds and loads, as the reference's is; the
pure-Python index of the same semantics stays for a machine without a
compiler.  The tests hold both to the reference's two indexes.

One lock serializes the index: with async mapping the mapping worker adds
keyframes while a LOST tracker queries, and ctypes releases the GIL
during a native call.
"""

from __future__ import annotations

import threading
from collections import defaultdict

from .vocab import bow_similarity


class KeyFrameDatabase:
    def __init__(self, n_words: int = 4096, use_native: bool = True):
        self.inverted: dict[int, list[int]] = defaultdict(list)
        self.bow: dict[int, dict[int, float]] = {}
        self._native = None
        self._lock = threading.Lock()
        if use_native:
            from ..native.bindings import NativeBowIndex, get_lib

            if get_lib() is not None:
                self._native = NativeBowIndex(n_words)

    @property
    def is_native(self) -> bool:
        return self._native is not None

    def add(self, kf: int, bow_vec: dict[int, float]):
        with self._lock:
            self._add(kf, bow_vec)

    def _add(self, kf: int, bow_vec: dict[int, float]):
        self.bow[kf] = bow_vec
        if self._native is not None:
            self._native.add(kf, bow_vec)
            return
        for w in bow_vec:
            self.inverted[w].append(kf)

    def erase(self, kf: int):
        with self._lock:
            self._erase(kf)

    def _erase(self, kf: int):
        vec = self.bow.pop(kf, None)
        if self._native is not None:
            self._native.erase(kf)
            return
        for w in vec or ():
            lst = self.inverted.get(w)
            if lst and kf in lst:
                lst.remove(kf)

    def similarity(self, a: int, b: int) -> float:
        if self._native is not None:
            with self._lock:
                return self._native.pair_score(a, b)
        return bow_similarity(self.bow.get(a, {}), self.bow.get(b, {}))

    def query(self, bow_vec: dict[int, float], exclude: set[int], min_score: float,
              max_results: int = 8) -> list[tuple[int, float]]:
        """Candidates sharing words with the query, best score first.
        exclude: keyframes never returned (the query and its neighbours)."""
        if not bow_vec:
            return []
        with self._lock:
            return self._query(bow_vec, exclude, min_score, max_results)

    def _query(self, bow_vec, exclude, min_score, max_results):
        if self._native is not None:
            return self._native.query(bow_vec, exclude, min_score, max_results)
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
