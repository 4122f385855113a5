"""Parity of the port's frontend (ops/pyramid, ops/fast, ops/brief,
frontend/frame) against spslam_tpu on the CPU.

Tolerances: pyramid sizes exact and values within 1e-5 (bilinear weights
and the 7-tap blur in float32; the two frameworks may fuse a multiply-add
differently); FAST scores and NMS bit-exact (sub/min/max only); keypoint
selections identical, including among tied scores; BRIEF descriptors equal
except for keypoints whose orientation falls on the other side of a
30-bin steering boundary (the 1089-term moment sum may round differently),
which must be at most 1% of the keypoints.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st
from hypothesis.extra import numpy as hnp

from spslam_tpu.frontend import frame as jframe
from spslam_tpu.geometry.camera import Intrinsics as JIntr
from spslam_tpu.ops import brief as jbrief
from spslam_tpu.ops import fast as jfast
from spslam_tpu.ops import fast_pallas as jfast_pallas
from spslam_tpu.ops import pyramid as jpyr
from spslam_tpu_torch.frontend import frame as tframe
from spslam_tpu_torch.geometry.camera import Intrinsics as TIntr
from spslam_tpu_torch.ops import brief as tbrief
from spslam_tpu_torch.ops import fast as tfast
from spslam_tpu_torch.ops import fast_cuda
from spslam_tpu_torch.ops import pyramid as tpyr
from tests.test_torch_common import desc_u32, n, t, textured_u8

SPEC_ARGS = (8, 1.2, 480, 640)
LEVEL_SIZES = ((480, 640), (400, 533), (333, 444), (278, 370), (231, 309), (193, 257),
               (161, 214), (134, 179))


def _smooth_image(h, w, seed):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    img = np.zeros((h, w), np.float32)
    for _ in range(24):
        cy, cx = rng.uniform(0, h), rng.uniform(0, w)
        s = rng.uniform(2, 18)
        img += rng.uniform(30, 120) * np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / (2 * s * s))
    img += rng.normal(0, 4.0, (h, w))
    return np.clip(img, 0, 255).astype(np.float32)


def test_level_sizes_exact():
    assert tpyr.PyramidSpec(*SPEC_ARGS).level_sizes == LEVEL_SIZES
    assert jpyr.PyramidSpec(*SPEC_ARGS).level_sizes == LEVEL_SIZES
    assert (tfast.level_feature_counts(tpyr.PyramidSpec(*SPEC_ARGS), 1024)
            == jfast.level_feature_counts(jpyr.PyramidSpec(*SPEC_ARGS), 1024))


def test_pyramid_values():
    img = _smooth_image(120, 160, seed=5)
    tl, tb = tpyr.build_pyramid_levels(t(img), tpyr.PyramidSpec(5, 1.2, 120, 160))
    jl, jb = jpyr.build_pyramid_levels(jnp.asarray(img), jpyr.PyramidSpec(5, 1.2, 120, 160))
    for a, b in zip(tl + tb, jl + jb):
        assert a.shape == b.shape
        np.testing.assert_allclose(n(a), n(b), rtol=0, atol=1e-5 * 255)


@pytest.mark.parametrize("shape", [(64, 96), (101, 131)])
@pytest.mark.parametrize("kind", ["smooth", "tied_u8"])
def test_fast_score_and_nms_bit_exact(shape, kind):
    h, w = shape
    img = (_smooth_image(h, w, seed=h + w) if kind == "smooth"
           else textured_u8(h, w, seed=h * w).astype(np.float32))
    ts = tfast.fast_score_map(t(img), 7.0, 20.0)
    js = jfast.fast_score_map(jnp.asarray(img), 7.0, 20.0)
    np.testing.assert_array_equal(n(ts), n(js))
    np.testing.assert_array_equal(n(tfast.nms3x3(ts)), n(jfast.nms3x3(js)))
    # the CPU dispatch is the plain version and never touches the kernel
    before = fast_cuda.LAUNCHES
    np.testing.assert_array_equal(n(fast_cuda.fast_nms_scores(t(img), 7.0, 20.0)),
                                  n(tfast.nms3x3(ts)))
    assert fast_cuda.LAUNCHES == before


def test_cuda_wrapper_refuses_cpu_tensor():
    with pytest.raises(ValueError):
        fast_cuda.fast_nms_scores_cuda(torch.zeros(8, 8), 7.0, 20.0)


def _level_table_inputs(table):
    """Level images of a named table, from a numpy seed."""
    if table == "1-level 101x131":
        return [_smooth_image(101, 131, seed=3)]
    img = _smooth_image(240, 320, seed=4)
    levels, _ = tpyr.build_pyramid_levels(t(img), tpyr.PyramidSpec(4, 1.2, 240, 320), blur=False)
    return [n(x) for x in levels]


@pytest.mark.parametrize("border", [4, 19])
@pytest.mark.parametrize("table", ["4-level 240x320", "1-level 101x131"])
def test_fast_nms_levels_against_reference(table, border):
    """All levels through the port's one function (on the CPU its plain
    version) against the JAX package's per-level dispatch and mask: exact on
    the whole image."""
    levels = _level_table_inputs(table)
    before = fast_cuda.LAUNCHES
    got = fast_cuda.fast_nms_scores_levels([t(x) for x in levels], 7.0, 20.0, border)
    assert fast_cuda.LAUNCHES == before
    assert len(got) == len(levels)
    n_corners = 0
    for lvl, g in zip(levels, got):
        h, w = lvl.shape
        mask = np.zeros((h, w), bool)
        mask[border : h - border, border : w - border] = True
        want = jnp.where(jnp.asarray(mask),
                         jfast_pallas.fast_nms_scores(jnp.asarray(lvl), 7.0, 20.0), 0.0)
        np.testing.assert_array_equal(n(g), n(want))
        n_corners += int((n(want) > 0).sum())
    assert n_corners > 20


def _bad_levels(case):
    ok = torch.zeros(40, 50)
    return {
        "non-contiguous": [ok, torch.zeros(50, 40).T],
        "float64": [ok.double()],
        "3-D": [ok[None]],
        "17 levels": [ok] * 17,
        "empty table": [],
    }[case]


@pytest.mark.parametrize("entry", ["dispatch", "cuda"])
@pytest.mark.parametrize("case", ["non-contiguous", "float64", "3-D", "17 levels",
                                  "empty table"])
def test_fast_nms_levels_refuses(case, entry):
    fn = (fast_cuda.fast_nms_scores_levels if entry == "dispatch"
          else fast_cuda.fast_nms_scores_levels_cuda)
    with pytest.raises(ValueError):
        fn(_bad_levels(case), 7.0, 20.0, 19)


def test_fast_nms_levels_cuda_refuses_cpu_and_negative_thresholds():
    with pytest.raises(ValueError, match="cuda"):
        fast_cuda.fast_nms_scores_levels_cuda([torch.zeros(40, 50)], 7.0, 20.0, 19)
    for bad in ((-1.0, 20.0, 19), (7.0, -20.0, 19), (7.0, 20.0, -1)):
        with pytest.raises(ValueError):
            fast_cuda.fast_nms_scores_levels([torch.zeros(40, 50)], *bad)


def test_fast_nms_work_counts():
    work = fast_cuda.fast_nms_work(LEVEL_SIZES, 0)
    assert work.bytes == 950_532 * 8
    assert work.scored_px == work.ring_px == 950_532
    assert work.ops == 950_532 * (4 + 9 + 33 + 85 + 16)
    # with the detection border fewer pixels need a score, and the ring is
    # counted only where the data passes the compass test
    inner = fast_cuda.fast_nms_work(LEVEL_SIZES, 19)
    assert inner.bytes == work.bytes and inner.scored_px == 775_284 < work.scored_px
    some = fast_cuda.fast_nms_work(LEVEL_SIZES, 19, ring_px=100_000)
    assert some.ops == inner.ops - (775_284 - 100_000) * (33 + 85)
    assert some.minmax_ops < inner.minmax_ops < inner.ops
    assert fast_cuda.fast_nms_work([(30, 30)], 19).scored_px == 0


@pytest.mark.parametrize("border", [0, 4, 19, 60])
def test_level_table_tiles_cover_the_interior(border):
    """The flat tile grid the kernel runs on: per level, 30x30 tiles over the
    interior (one tile where there is none), first tiles ascending."""
    sizes = ((101, 131), (84, 109), (20, 300))
    table, entries, n_tiles = fast_cuda._level_table(sizes, border)
    assert len(entries) == len(sizes)
    ends = [lv.tile0 for lv in entries[1:]] + [n_tiles]
    first = 0
    for lv, end, (h, w) in zip(entries, ends, sizes):
        assert (lv.H, lv.W, lv.tile0) == (h, w, first)
        tiles_y, rem = divmod(end - lv.tile0, lv.tiles_x)
        assert rem == 0
        for tiles, extent in ((lv.tiles_x, w - 2 * border), (tiles_y, h - 2 * border)):
            assert tiles == max(1, -(-extent // fast_cuda.TILE))
        first = end
    # the entries are views of the table that is passed to the launch
    entries[1].img = 12345
    assert table.lv[1].img == 12345


def _assert_rejects_only_zero_scores(img, th_low=7.0, th_high=20.0):
    reject = n(tfast.compass_reject(t(img), th_low))
    score = n(tfast.fast_score_map(t(img), th_low, th_high))
    assert not score[reject].any()
    return reject


@pytest.mark.parametrize("kind", ["smooth", "tied_u8"])
def test_compass_reject_is_exact(kind):
    img = (_smooth_image(101, 131, seed=11) if kind == "smooth"
           else textured_u8(101, 131, seed=12).astype(np.float32))
    reject = _assert_rejects_only_zero_scores(img)
    # the case proves something: some pixels are rejected, and corners remain
    assert reject.any() and not reject.all()
    assert (n(tfast.fast_score_map(t(img), 7.0, 20.0)) > 0).sum() > 20


@settings(max_examples=30, deadline=None)
@given(hnp.arrays(np.float32, (24, 28), elements=st.floats(0, 255, width=32)),
       st.sampled_from([0.0, 7.0, 20.0, 64.0]))
def test_compass_reject_is_exact_on_random_images(img, th_low):
    _assert_rejects_only_zero_scores(img, th_low=th_low, th_high=max(th_low, 20.0))


def test_detect_levels_tied_scores_identical():
    img = textured_u8(240, 320, seed=9).astype(np.float32)
    tspec, jspec = tpyr.PyramidSpec(4, 1.2, 240, 320), jpyr.PyramidSpec(4, 1.2, 240, 320)
    tl, _ = tpyr.build_pyramid_levels(t(img), tspec, blur=False)
    jl, _ = jpyr.build_pyramid_levels(jnp.asarray(img), jspec, blur=False)
    # the level-0 scores really tie a lot (else this test would prove nothing)
    s0 = n(jfast.nms3x3(jfast.fast_score_map(jl[0], 7.0, 20.0)))
    vals, counts = np.unique(s0[s0 > 0], return_counts=True)
    assert counts.max() >= 20
    td = tfast.detect_levels(tl, tspec, n_features=500)
    jd = jfast.detect_levels(jl, jspec, n_features=500)
    for k in ("xy_level", "xy", "score", "octave", "valid"):
        np.testing.assert_array_equal(n(td[k]), n(jd[k]), err_msg=k)


def test_select_tiled_topk_ties():
    score = np.zeros((64, 64), np.float32)
    score[::3, ::2] = 30.0                      # hundreds of equal scores
    score[5, 7] = 1e6 + 40.0
    for k in (8, 3):
        a = tfast.select_tiled_topk(t(score), 40, k_per_tile=k)
        b = jfast.select_tiled_topk(jnp.asarray(score), 40, k_per_tile=k)
        for x, y in zip(a, b):
            np.testing.assert_array_equal(n(x), n(y))


def test_brief_tables_equal():
    np.testing.assert_array_equal(tbrief.BRIEF_PATTERN, n(jbrief.BRIEF_PATTERN))
    np.testing.assert_array_equal(tbrief.MOMENT_MATRIX, n(jbrief.MOMENT_MATRIX))
    np.testing.assert_array_equal(tbrief._diff_matrix_np(), n(jbrief.BRIEF_DIFF_MATRIX))
    assert tfast.CIRCLE_OFFSETS == jfast.CIRCLE_OFFSETS


def test_unpack_bits_and_packing():
    rng = np.random.default_rng(1)
    desc = rng.integers(0, 2 ** 32, (64, 8), dtype=np.uint32)
    np.testing.assert_array_equal(n(tbrief.unpack_bits(t(desc))),
                                  n(jbrief.unpack_bits(jnp.asarray(desc))))
    bits = n(jbrief.unpack_bits(jnp.asarray(desc))) > 0.5
    np.testing.assert_array_equal(desc_u32(tbrief.pack_words(t(bits))), desc)


def test_describe_levels_parity():
    img = _smooth_image(240, 320, seed=2)
    tspec, jspec = tpyr.PyramidSpec(4, 1.2, 240, 320), jpyr.PyramidSpec(4, 1.2, 240, 320)
    jl, jb = jpyr.build_pyramid_levels(jnp.asarray(img), jspec)
    jd = jfast.detect_levels(jl, jspec, n_features=600)
    counts = jfast.level_feature_counts(jspec, 600)
    # identical inputs (the JAX levels and keypoints) into both describers
    ta, tdesc = tbrief.describe_levels(tuple(t(n(x)) for x in jb), t(n(jd["xy_level"])), counts)
    ja, jdesc = jbrief.describe_levels(jb, jd["xy_level"], counts)
    np.testing.assert_allclose(n(ta), n(ja), rtol=0, atol=1e-5)
    step = 2 * np.pi / 30
    bins_t = np.mod(np.round(n(ta) / step).astype(np.int64), 30)
    bins_j = np.mod(np.round(n(ja) / step).astype(np.int64), 30)
    same = bins_t == bins_j
    assert np.mean(~same) <= 0.01
    np.testing.assert_array_equal(desc_u32(tdesc)[same], n(jdesc)[same])


def test_build_frame_synthetic():
    from spslam_tpu_torch.io.synthetic import make_sequence

    seq = make_sequence(n_frames=2)
    gray, depth = seq.frames[1]
    intr = seq.intr
    jintr = JIntr(*intr)
    tspec, jspec = tpyr.PyramidSpec(*SPEC_ARGS), jpyr.PyramidSpec(*SPEC_ARGS)
    depth2 = np.ascontiguousarray(depth[::2, ::2])
    tf = tframe.build_frame(t(gray), t(depth2), tspec, intr, n_features=1024)
    jf = jframe.build_frame(jnp.asarray(gray), jnp.asarray(depth2), jspec, jintr,
                            n_features=1024)
    for k in ("uv", "uv_raw", "octave", "score", "depth", "u_right", "xyz_cam", "valid",
              "has_depth"):
        np.testing.assert_allclose(n(getattr(tf, k)), n(getattr(jf, k)), rtol=1e-6, atol=1e-5,
                                   err_msg=k)
    step = 2 * np.pi / 30
    same = (np.mod(np.round(n(tf.angle) / step).astype(np.int64), 30)
            == np.mod(np.round(n(jf.angle) / step).astype(np.int64), 30))
    assert np.mean(~same) <= 0.01
    np.testing.assert_array_equal(desc_u32(tf.desc)[same], n(jf.desc)[same])
    np.testing.assert_array_equal(n(tf.bits)[same], n(jf.bits)[same])
    assert int(n(tf.valid).sum()) > 800
