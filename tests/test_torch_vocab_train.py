"""The port's vocabulary trainer (loop/train_vocab.py) and Vocabulary.save
against the reference's tools/train_vocab.py steps and loop/vocab.py, at a
small size: 1 room, 3 views, 320x240, 4 levels, 64 words.

- pool: >= 99% of the descriptor rows in common with the reference's
  steps (rendered by spslam_tpu.io.synthetic, built by its build_frame),
  counted as multisets.  Rows are not compared by position: a keypoint
  whose FAST score sits at a threshold in one package and not the other
  shifts every later keypoint of its level by one row.  The pools also
  differ by the renderers' resize rounding (<= 5e-7 per texel) and by
  steering-bin flips of ic_angle (ROADMAP, Queue C).
- training: from the reference's pool with the reference's PRNGKey draw
  injected, the vocabulary bits and idf equal exactly (integer Hamming
  sums and one-hot counts, first index on argmin ties).
- save/load: each package reads the other's file; quantize words equal.
"""

from collections import Counter

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spslam_tpu.frontend.frame import build_frame as jbuild_frame
from spslam_tpu.geometry import camera as jcam
from spslam_tpu.io import synthetic as jsyn
from spslam_tpu.loop import vocab as jvocab
from spslam_tpu.ops import brief as jbrief
from spslam_tpu.ops import pyramid as jpyr
from spslam_tpu_torch.geometry import camera as tcam
from spslam_tpu_torch.loop import train_vocab as ttv
from spslam_tpu_torch.loop import vocab as tvocab
from spslam_tpu_torch.ops import pyramid as tpyr
from tests.test_torch_common import DEV, n, t

INTR = dict(fx=262.5, fy=262.5, cx=159.5, cy=119.5, bf=40.0, width=320, height=240)
SPEC = (4, 1.2, 240, 320)
N_WORDS = 64


@pytest.fixture(scope="module")
def pools():
    """(port pool, reference pool) of room 0's 3 views."""
    port = ttv.collect_training_descriptors(rooms=1, views=3, intr=tcam.Intrinsics(**INTR),
                                            spec=tpyr.PyramidSpec(*SPEC), device=DEV)
    intr = jcam.Intrinsics(**INTR)
    rects = jsyn.make_room(seed=100)
    poses = jsyn.loop_trajectory(3, seed=0)
    ref = []
    for i in range(3):
        gray, depth = jsyn.render_frame(rects, poses[i], intr)
        f = jbuild_frame(jnp.asarray(gray), jnp.asarray(depth), jpyr.PyramidSpec(*SPEC), intr)
        ref.append(np.asarray(f.desc)[np.asarray(f.valid)])
    return port, np.concatenate(ref)


def test_pool_matches_reference_steps(pools):
    port, ref = pools
    assert port.dtype == np.uint32 and port.shape[1] == 8
    assert abs(len(port) - len(ref)) <= 0.01 * len(ref)
    common = sum((Counter(map(bytes, port)) & Counter(map(bytes, ref))).values())
    assert common >= 0.99 * max(len(port), len(ref))


def _reference_vocab(pool):
    voc = jvocab.Vocabulary(n_words=N_WORDS, train_after=10 ** 9)
    voc.add_training_descriptors(pool)
    voc.train()
    return voc


def _reference_draw(pool, seed=0):
    """The reference's initial centroids: jax.random.choice under PRNGKey(seed)."""
    return torch.from_numpy(np.array(jax.random.choice(
        jax.random.PRNGKey(seed), len(pool), (N_WORDS,), replace=False)))


def test_training_with_the_reference_draw(pools):
    _, ref_pool = pools
    want = _reference_vocab(ref_pool)
    got = ttv.train_vocabulary(ref_pool, N_WORDS, init_idx=_reference_draw(ref_pool),
                               device=DEV)
    np.testing.assert_array_equal(n(got.vocab_bits), n(want.vocab_bits))
    np.testing.assert_array_equal(got.idf, want.idf)
    # without an injected draw the port's seeded generator is used
    assert ttv.train_vocabulary(ref_pool, N_WORDS, device=DEV).vocab_bits.shape == (N_WORDS, 256)


def test_too_small_a_pool_is_refused(pools):
    with pytest.raises(ValueError, match="too few"):
        ttv.train_vocabulary(pools[1][: 4 * N_WORDS - 1], N_WORDS, device=DEV)


def _words(voc_bits, pool, quantize, asarray):
    bits = asarray(n(jbrief.unpack_bits(jnp.asarray(pool))))
    valid = asarray(np.ones(len(pool), bool))
    return n(quantize(bits, asarray(n(voc_bits)), valid))


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_save_load_interop(pools, tmp_path, writer):
    port_pool, ref_pool = pools
    path = str(tmp_path / f"{writer}.npz")
    if writer == "port":
        ttv.train_vocabulary(ref_pool, N_WORDS, out=path, init_idx=_reference_draw(ref_pool),
                             device=DEV)
    else:
        _reference_vocab(ref_pool).save(path)
    with np.load(path) as d:
        assert d["vocab"].dtype == np.float32 and d["vocab"].shape == (N_WORDS, 256)
        assert d["idf"].dtype == np.float64 and d["idf"].shape == (N_WORDS,)
    jv = jvocab.Vocabulary(n_words=N_WORDS)
    jv.load(path)
    tv = tvocab.Vocabulary(n_words=N_WORDS, device=DEV)
    tv.load(path)
    np.testing.assert_array_equal(tv.idf, jv.idf)
    got = _words(tv.vocab_bits, port_pool, tvocab.quantize, t)
    want = _words(jv.vocab_bits, port_pool, jvocab.quantize, jnp.asarray)
    np.testing.assert_array_equal(got, want)
    assert len(np.unique(got)) > N_WORDS // 2


def test_cli_refuses_the_committed_data_directory():
    for out in ("data/vocab_synth.npz", str(ttv.DATA_DIR) + "/v.npz"):
        with pytest.raises(SystemExit):
            ttv.main(["64", out])
