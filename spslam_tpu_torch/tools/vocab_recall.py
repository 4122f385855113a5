"""Vocabulary-size x score-floor recall study for loop detection (port of
tools/vocab_recall.py).

Sweeps the vocabulary size and the minimum-score floor against loop-
detection recall and precision on revisit sequences (varied texture,
rotation speed, depth noise) and prints the curve.

Ground truth: pseudo-keyframe i (every KF_STRIDE-th frame) revisits pseudo-
keyframe j when the two ground-truth cameras are within POS_TOL metres and
their optical axes within ANG_TOL degrees, with at least MIN_GAP pseudo-
keyframes between them.  A query is a HIT when any returned candidate
above the floor is a true revisit of it (recall is over the queries that
have a true revisit; precision over all returned candidates).

Descriptors come from `build_frame` (the FAST+NMS kernel on the card) of
each rendered view; the k-means initial draw is the Vocabulary's seeded
generator.

    python -m spslam_tpu_torch.tools.vocab_recall [--quick] [--device cpu]

--quick: one revisit sequence, one training sequence, two sizes.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

POS_TOL = 0.45
ANG_TOL = 25.0
MIN_GAP = 8          # pseudo-keyframes (= 4 frames each -> 32 frames)
KF_STRIDE = 4
FLOORS = (0.005, 0.010, 0.015, 0.030, 0.050)

EVAL_SPECS = (
    dict(n_frames=96, trajectory="loop", depth_noise=0.004, seed=0),
    dict(n_frames=64, trajectory="loop", depth_noise=0.010, seed=5),
    dict(n_frames=96, trajectory="loop", depth_noise=0.004, seed=9, low_texture=True),
)
POOL_SPECS = (dict(n_frames=60, seed=20), dict(n_frames=60, seed=21),
              dict(n_frames=40, seed=22, low_texture=True))
QUICK_EVAL_SPECS = EVAL_SPECS[:1]
QUICK_POOL_SPECS = (dict(n_frames=40, seed=20),)


def optical_axis(T_cw):
    from ..geometry import np_lie

    # camera +z in world = R_cw^T e_z
    return np_lie.quat_rotate(np_lie.quat_conj(T_cw[0:4]), np.array([0, 0, 1.0]))


def center(T_cw):
    from ..geometry import np_lie

    return np_lie.camera_center(T_cw)


def _descriptors(seq, i, device) -> np.ndarray:
    """Valid descriptors (uint32 [n, 8]) of frame i built on `device`."""
    from ..frontend.frame import build_frame
    from ..ops.pyramid import PyramidSpec

    spec = PyramidSpec(n_levels=8, scale_factor=1.2, height=seq.intr.height,
                       width=seq.intr.width)
    g, d = seq.frames[i]
    fr = build_frame(torch.from_numpy(np.asarray(g, np.float32)).to(device),
                     torch.from_numpy(np.asarray(d, np.float32)).to(device),
                     spec, seq.intr, n_features=1024)
    return fr.desc[fr.valid].cpu().numpy().view(np.uint32)


def eval_entry(seq, tag: str, device=None) -> dict:
    """One revisit sequence of the eval set: per pseudo-keyframe (every
    KF_STRIDE-th frame) its descriptors and ground-truth pose."""
    from .. import resolve_device

    dev = resolve_device(device)
    kfs = [dict(desc=_descriptors(seq, i, dev), T=seq.poses_gt[i])
           for i in range(0, len(seq.frames), KF_STRIDE)]
    return dict(tag=tag, kfs=kfs)


def build_eval_set(specs=EVAL_SPECS, device=None) -> list[dict]:
    """Render the revisit sequences and build their eval entries."""
    from ..io.synthetic import make_sequence

    out = []
    for sp in specs:
        print(f"rendering {sp} ...", file=sys.stderr)
        out.append(eval_entry(make_sequence(**sp), str(sp), device))
    return out


def build_pool(specs=POOL_SPECS, device=None) -> np.ndarray:
    """Training descriptors of every second frame of sequences disjoint
    from the eval set (other room seeds and trajectories)."""
    from .. import resolve_device
    from ..io.synthetic import make_sequence

    dev = resolve_device(device)
    print("rendering training pool ...", file=sys.stderr)
    pool = []
    for sp in specs:
        seq = make_sequence(**sp)
        pool += [_descriptors(seq, i, dev) for i in range(0, len(seq.frames), 2)]
    return np.concatenate(pool)


def true_revisits(kfs):
    """[i] -> set of j < i - MIN_GAP that are genuine revisits."""
    C = np.stack([center(k["T"]) for k in kfs])
    A = np.stack([optical_axis(k["T"]) for k in kfs])
    rv = {}
    for i in range(len(kfs)):
        js = set()
        for j in range(0, i - MIN_GAP):
            if (np.linalg.norm(C[i] - C[j]) < POS_TOL
                    and np.degrees(np.arccos(np.clip(A[i] @ A[j], -1, 1))) < ANG_TOL):
                js.add(j)
        rv[i] = js
    return rv


def evaluate(vocab, eval_set, floors=FLOORS):
    """{floor: (recall, precision, n_queries)} over the whole eval set."""
    from ..loop.kfdb import KeyFrameDatabase

    stats = {f: [0, 0, 0, 0] for f in floors}  # hit, has_rv, good_cand, all_cand
    for seqd in eval_set:
        kfs = seqd["kfs"]
        rv = true_revisits(kfs)
        kfdb = KeyFrameDatabase(n_words=vocab.n_words, use_native=False)
        bows = [vocab.bow_vector(k["desc"]) for k in kfs]
        for i in range(len(kfs)):
            if rv[i]:
                exclude = set(range(max(0, i - MIN_GAP), i))
                cands = kfdb.query(bows[i], exclude, min_score=0.0, max_results=8)
                for f in stats:
                    cf = [(k, s) for k, s in cands if s >= f]
                    stats[f][0] += int(any(k in rv[i] for k, _ in cf))
                    stats[f][1] += 1
                    stats[f][2] += sum(k in rv[i] for k, _ in cf)
                    stats[f][3] += len(cf)
            kfdb.add(i, bows[i])
    return {f: (h / max(q, 1), g / max(a, 1), q) for f, (h, q, g, a) in stats.items()}


def sweep(pool, eval_set, sizes, floors=FLOORS, device=None) -> list[tuple]:
    """Train a vocabulary of each size on `pool` and print the curve; rows
    (n_words, floor, recall, precision, queries), none for a size the pool
    is too small for."""
    from ..loop.vocab import Vocabulary

    rows = []
    print(f"{'words':>6} {'floor':>6} {'recall':>7} {'precision':>9} {'queries':>8}")
    for n_words in sizes:
        v = Vocabulary(n_words=n_words, train_after=1, device=device)
        v._pool = [pool]
        v._pool_count = len(pool)
        v.train()
        if not v.trained:
            print(f"{n_words:>6}  (pool too small: {len(pool)} < {4 * n_words})")
            continue
        res = evaluate(v, eval_set, floors)
        for f in floors:
            r, p, q = res[f]
            rows.append((n_words, f, r, p, q))
            print(f"{n_words:>6} {f:>6.3f} {r:>7.3f} {p:>9.3f} {q:>8}")
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="vocabulary size x score floor recall curve")
    ap.add_argument("--quick", action="store_true",
                    help="one revisit sequence, one training sequence, two sizes")
    ap.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    from .. import resolve_device

    dev = resolve_device(args.device)
    eval_set = build_eval_set(QUICK_EVAL_SPECS if args.quick else EVAL_SPECS, dev)
    pool = build_pool(QUICK_POOL_SPECS if args.quick else POOL_SPECS, dev)
    print(f"training pool: {len(pool)} descriptors", file=sys.stderr)
    sizes = [4096, 16384] if args.quick else [1024, 4096, 16384]
    if len(pool) >= 4 * 65536:
        sizes.append(65536)
    sweep(pool, eval_set, sizes, device=dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
