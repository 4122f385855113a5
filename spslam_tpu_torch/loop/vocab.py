"""Flat binary visual vocabulary for place recognition (port of
spslam_tpu/loop/vocab.py).

Quantization is exact nearest-word assignment by one Hamming-distance
matmul ([N, 256] x [V, 256], float32 with TF32 off: integer sums <= 256
are exact).  The vocabulary trains by binary k-means, or loads the
in-repo `data/vocab_synth.npz` (4096 words), as the reference's System
does.

The initial centroids are a draw without replacement; the reference takes
it from `jax.random.choice`, here from an explicit `torch.Generator`
seeded with `Vocabulary.seed`.  `train_vocab_bits` also takes the indices
themselves, so a test can hand both packages the same draw.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import resolve_device
from ..ops.brief import unpack_bits
from ..ops.match import hamming_matrix

# the in-repo vocabulary System loads by default, found from the repo root
DEFAULT_VOCAB_PATH = "data/vocab_synth.npz"


def train_vocab_bits(bits: torch.Tensor, n_words: int = 1024, n_iters: int = 8,
                     init_idx: torch.Tensor | None = None,
                     generator: torch.Generator | None = None) -> torch.Tensor:
    """Binary k-means.  bits: [N, 256] {0,1} float32.  Returns centroids
    [V, 256].  init_idx: [V] distinct rows for the initial centroids (else
    drawn with `generator`, a CPU generator)."""
    N = bits.shape[0]
    if init_idx is None:
        init_idx = torch.randperm(N, generator=generator)[:n_words]
    cent = bits[init_idx.to(bits.device).long()]
    for _ in range(n_iters):
        assign = torch.argmin(hamming_matrix(bits, cent), dim=-1)
        onehot = torch.nn.functional.one_hot(assign, n_words).to(torch.float32)  # [N, V]
        counts = onehot.sum(0)
        sums = onehot.T @ bits                                                  # [V, 256]
        maj = (sums * 2.0 > counts[:, None]).to(torch.float32)
        # keep the old centroid of an empty cluster
        cent = torch.where(counts[:, None] > 0, maj, cent)
    return cent


def quantize(bits: torch.Tensor, vocab_bits: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Nearest word per descriptor [N] int32 (first word on ties); -1 where
    not valid."""
    w = torch.argmin(hamming_matrix(bits, vocab_bits), dim=-1).to(torch.int32)
    return torch.where(valid, w, -1)


class Vocabulary:
    """Host wrapper: lazy training and TF-IDF weights (idf float64 on the
    host, the word bits on the device)."""

    def __init__(self, n_words: int = 1024, train_after: int = 20000, seed: int = 0,
                 device=None):
        self.n_words = n_words
        self.train_after = train_after
        self.seed = seed
        self.device = resolve_device(device)
        self.vocab_bits: torch.Tensor | None = None
        self._pool: list[np.ndarray] = []
        self._pool_count = 0
        self.idf = np.ones(n_words, np.float64)

    @property
    def trained(self) -> bool:
        return self.vocab_bits is not None

    def _bits(self, desc_packed: np.ndarray) -> torch.Tensor:
        d = np.ascontiguousarray(desc_packed, dtype=np.uint32).view(np.int32)
        return unpack_bits(torch.from_numpy(d).to(self.device))

    def add_training_descriptors(self, desc_packed: np.ndarray):
        """desc_packed: [n, 8] uint32 valid descriptors."""
        if self.trained or len(desc_packed) == 0:
            return
        self._pool.append(desc_packed)
        self._pool_count += len(desc_packed)
        if self._pool_count >= self.train_after:
            self.train()

    def train(self, init_idx: torch.Tensor | None = None):
        alld = np.concatenate(self._pool)
        if len(alld) < self.n_words * 4:
            return
        bits = self._bits(alld)
        gen = torch.Generator().manual_seed(self.seed)
        self.vocab_bits = train_vocab_bits(bits, self.n_words, init_idx=init_idx,
                                           generator=gen)
        # idf fixed from the training distribution, smoothed so no word
        # gets zero weight
        words = quantize(bits, self.vocab_bits,
                         torch.ones(len(alld), dtype=torch.bool, device=self.device))
        words = words.cpu().numpy()
        counts = np.bincount(words[words >= 0], minlength=self.n_words)
        self.idf = np.log((1.0 + len(alld)) / (1.0 + counts)) + 1.0
        self._pool = []

    def bow_vector(self, desc_packed: np.ndarray) -> dict[int, float]:
        """TF-IDF weighted, L1-normalized bag of words of one keyframe."""
        if not self.trained or len(desc_packed) == 0:
            return {}
        bits = self._bits(desc_packed)
        valid = torch.ones(len(desc_packed), dtype=torch.bool, device=self.device)
        words = quantize(bits, self.vocab_bits, valid).cpu().numpy()
        counts = np.bincount(words[words >= 0], minlength=self.n_words).astype(np.float64)
        tf = counts / max(counts.sum(), 1.0)
        v = tf * self.idf
        s = v.sum()
        if s <= 0:
            return {}
        v /= s
        return {int(w): float(v[w]) for w in np.nonzero(v)[0]}

    def load(self, path: str):
        with np.load(path) as d:
            self.vocab_bits = torch.from_numpy(np.asarray(d["vocab"], np.float32)).to(self.device)
            self.idf = np.array(d["idf"])


def bow_similarity(a: dict[int, float], b: dict[int, float]) -> float:
    """DBoW2's L1 score s = 1 - 0.5 |va - vb|_1, computed sparsely."""
    if not a or not b:
        return 0.0
    s = 0.0
    for w, va in a.items():
        vb = b.get(w)
        if vb is not None:
            s += abs(va) + abs(vb) - abs(va - vb)
    return 0.5 * s
