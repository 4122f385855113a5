"""Train a flat binary BoW vocabulary on rendered synthetic rooms (port of
tools/train_vocab.py).

Renders `rooms` rooms (`make_room(seed=r + 100)`) along
`loop_trajectory(views, seed=r)`, builds every view's frame on the device
(pyramid, the FAST+NMS kernel, BRIEF), pools the valid descriptors on the
host and trains the vocabulary by binary k-means (`loop/vocab.py`).  The
full size is 4 rooms x 12 views of 640x480, 8 levels, 1,024 features.

    python -m spslam_tpu_torch.loop.train_vocab N_WORDS OUT

OUT is required and may not lie under `data/`: the committed
`data/vocab_synth.npz` is the reference's and stays as it is.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch

from .. import resolve_device
from ..frontend.frame import build_frame
from ..geometry.camera import Intrinsics
from ..io.synthetic import loop_trajectory, make_room, render_frame
from ..ops.pyramid import PyramidSpec
from .vocab import Vocabulary

TRAIN_INTR = Intrinsics(fx=525.0, fy=525.0, cx=319.5, cy=239.5, bf=40.0, width=640, height=480)
TRAIN_SPEC = PyramidSpec(8, 1.2, 480, 640)
DATA_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "data")


def collect_training_descriptors(rooms: int = 4, views: int = 12,
                                 intr: Intrinsics = TRAIN_INTR,
                                 spec: PyramidSpec = TRAIN_SPEC,
                                 device=None) -> np.ndarray:
    """Valid descriptors of every view, uint32 [n, 8] on the host, in room
    and view order.  Each view is the float gray image and depth of the
    renderer, built into a frame on `device` (None: the card)."""
    dev = resolve_device(device)
    pool = []
    for r in range(rooms):
        rects = make_room(seed=r + 100)
        poses = loop_trajectory(views, seed=r)
        for i in range(views):
            gray, depth = render_frame(rects, poses[i], intr)
            f = build_frame(torch.from_numpy(gray).to(dev), torch.from_numpy(depth).to(dev),
                            spec, intr)
            pool.append(f.desc[f.valid].cpu().numpy().view(np.uint32))
    return np.concatenate(pool)


def train_vocabulary(pool: np.ndarray, n_words: int = 4096, out: str | None = None,
                     init_idx: torch.Tensor | None = None, device=None) -> Vocabulary:
    """Binary k-means on `pool` (uint32 [n, 8]) on `device`; the initial
    centroids are rows `init_idx` (else the Vocabulary's seeded draw).
    Saves to `out` when given."""
    voc = Vocabulary(n_words=n_words, train_after=10 ** 9, device=device)
    voc.add_training_descriptors(pool)
    voc.train(init_idx=init_idx)
    if not voc.trained:
        raise ValueError(f"{len(pool)} descriptors are too few for {n_words} words "
                         f"(k-means needs {4 * n_words})")
    if out is not None:
        voc.save(out)
    return voc


def _under_data(path: str) -> bool:
    p = os.path.realpath(path)
    return any(os.path.commonpath([p, d]) == d
               for d in {os.path.realpath(DATA_DIR), os.path.realpath("data")})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="train a binary BoW vocabulary on synthetic rooms")
    ap.add_argument("n_words", type=int)
    ap.add_argument("out", help="output .npz (not under data/)")
    args = ap.parse_args(argv)
    if _under_data(args.out):
        ap.error(f"refusing to write {args.out}: the vocabulary under data/ stays as committed")
    pool = collect_training_descriptors()
    print(f"training a {args.n_words}-word vocabulary on {len(pool)} descriptors")
    train_vocabulary(pool, args.n_words, out=args.out)
    print(f"saved {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
