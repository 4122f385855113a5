"""The port's settings, TUM and CLI modules (spslam_tpu_torch/config.py,
io/tum.py, cli.py) against spslam_tpu on the CPU.

* `load_settings` / `system_config_from_yaml` on every configs/*.yaml:
  the reference's values, field by field (exact);
* `read_png` against cv2.imread on PNGs cv2 writes with each filter type
  (none, sub, up, average, Paeth, and all five, from which libpng picks
  per row): 16-bit depth and 8-bit gray equal IMREAD_UNCHANGED, RGB read as
  gray equals IMREAD_GRAYSCALE (exact: libpng's fixed-point rgb_to_gray);
* `load_tum_sequence` on tests/integration/test_tum_io.py's directory:
  the same pairs, timestamps, intrinsics and frames (exact) and T_cw
  ground truth (1e-6) as the reference's;
* the CLI on that directory (loop closing and async mapping on) prints
  its final JSON line with ATE < 20 mm (the reference test's gate), and
  the port's System reads a map the JAX System saved.
"""

import glob
import json
import os
import struct
import zlib

import cv2
import numpy as np
import pytest

from spslam_tpu import config as jconfig
from spslam_tpu.io import tum as jtum
from spslam_tpu_torch import config as tconfig
from spslam_tpu_torch.io import tum as ttum
from tests.integration.test_tum_io import tum_dir  # noqa: F401  (fixture)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(glob.glob(os.path.join(ROOT, "configs", "*.yaml")))
FILTERS = {"none": cv2.IMWRITE_PNG_FILTER_NONE, "sub": cv2.IMWRITE_PNG_FILTER_SUB,
           "up": cv2.IMWRITE_PNG_FILTER_UP, "avg": cv2.IMWRITE_PNG_FILTER_AVG,
           "paeth": cv2.IMWRITE_PNG_FILTER_PAETH, "all": cv2.IMWRITE_PNG_ALL_FILTERS}


@pytest.mark.parametrize("path", CONFIGS, ids=os.path.basename)
def test_config_matches_reference(path):
    assert tconfig.load_settings(path) == jconfig.load_settings(path)
    kw = dict(use_loop=True, local_ba=False)
    want = jconfig.system_config_from_yaml(path, **kw)
    got = tconfig.system_config_from_yaml(path, **kw)
    assert tuple(got.intr) == tuple(want.intr)
    for f in ("n_features", "n_levels", "scale_factor", "th_fast_high", "th_fast_low",
              "th_depth"):
        assert getattr(got.tracker, f) == getattr(want.tracker, f), f
    for f in ("use_loop", "local_ba", "depth_map_factor", "use_planes", "async_mapping"):
        assert getattr(got, f) == getattr(want, f), f
    assert (got.plane_cfg is None) == (want.plane_cfg is None)
    if want.plane_cfg is not None:
        assert vars(got.plane_cfg) == vars(want.plane_cfg)


def _filter_types(path):
    """The set of row filter types stored in a PNG file."""
    data = open(path, "rb").read()
    pos, idat, hdr = 8, [], None
    while pos < len(data):
        n_, kind = struct.unpack(">I4s", data[pos:pos + 8])
        if kind == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", data[pos + 8:pos + 8 + n_])
        elif kind == b"IDAT":
            idat.append(data[pos + 8:pos + 8 + n_])
        pos += 12 + n_
    W, H, depth, ctype = hdr[:4]
    row = 1 + W * {0: 1, 2: 3}[ctype] * depth // 8
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    return set(raw.reshape(H, row)[:, 0].tolist())


def _images(seed):
    rng = np.random.default_rng(seed)
    rgb = rng.integers(0, 256, (120, 160, 3), dtype=np.uint8)
    rgb[40:90] = cv2.GaussianBlur(rgb[40:90], (9, 9), 3)        # smooth rows too
    gray = cv2.cvtColor(rgb, cv2.COLOR_BGR2GRAY)
    depth = (rng.integers(0, 4, (120, 160)) * 1000 + np.arange(160) * 37).astype(np.uint16)
    depth[rng.uniform(size=depth.shape) < 0.1] = 0
    return rgb, gray, depth


@pytest.mark.parametrize("name", list(FILTERS))
def test_read_png_matches_cv2(name, tmp_path):
    params = [cv2.IMWRITE_PNG_FILTER, FILTERS[name]]
    rgb, gray, depth = _images(11)
    seen = set()
    for kind, img in (("rgb", rgb), ("gray", gray), ("depth", depth)):
        path = str(tmp_path / f"{kind}.png")
        assert cv2.imwrite(path, img, params)
        seen |= _filter_types(path)
        np.testing.assert_array_equal(ttum.read_png(path, gray=True),
                                      cv2.imread(path, cv2.IMREAD_GRAYSCALE), err_msg=kind)
        want = cv2.imread(path, cv2.IMREAD_UNCHANGED)
        got = ttum.read_png(path, gray=False)
        if kind == "rgb":
            got = got[..., ::-1]                   # OpenCV's BGR order
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want, err_msg=kind)
    if name == "all":
        assert len(seen) >= 3, seen                # libpng picks per row
    else:
        assert seen == {list(FILTERS).index(name)}, seen


def test_tum_loader_matches_reference(tum_dir):  # noqa: F811
    root, seq = tum_dir
    rgb = ttum._read_file_list(str(root / "rgb.txt"))
    depth = ttum._read_file_list(str(root / "depth.txt"))
    assert rgb == jtum._read_file_list(str(root / "rgb.txt"))
    assert ttum.associate(rgb, depth) == jtum.associate(rgb, depth)
    assert tuple(ttum.guess_intrinsics("rgbd_dataset_freiburg2_desk")) == tuple(
        jtum.guess_intrinsics("rgbd_dataset_freiburg2_desk"))
    yaml = str(root / "settings.yaml")
    assert tuple(ttum.load_intrinsics_yaml(yaml)) == tuple(jtum.load_intrinsics_yaml(yaml))
    for kw in (dict(config_yaml=yaml), dict(max_frames=4)):
        want = jtum.load_tum_sequence(str(root), **kw)
        got = ttum.load_tum_sequence(str(root), **kw)
        assert tuple(got.intr) == tuple(want.intr)
        np.testing.assert_array_equal(got.timestamps, want.timestamps)
        assert len(got.frames) == len(want.frames)
        for (g, d), (jg, jd) in zip(got.frames, want.frames):
            assert g.dtype == jg.dtype and d.dtype == jd.dtype
            np.testing.assert_array_equal(g, jg)
            np.testing.assert_array_equal(d, jd)
        np.testing.assert_allclose(got.poses_gt, want.poses_gt, atol=1e-6)


def test_cli_on_tum_layout_and_jax_map(tum_dir, tmp_path, capsys):  # noqa: F811
    from spslam_tpu.cli import main as jmain
    from spslam_tpu_torch.cli import main
    from spslam_tpu_torch.system import System, SystemConfig
    from spslam_tpu_torch.tracking.tracker import TrackState

    root, seq = tum_dir
    base = ["--tum", str(root), "--config", str(root / "settings.yaml")]
    main(base + ["--cpu", "--loop", "--async-mapping", "--traj-out", str(tmp_path / "t.txt"),
                 "--metrics-out", str(tmp_path / "m.jsonl"),
                 "--map-out", str(tmp_path / "port_map.npz")])
    out = capsys.readouterr().out
    stats = json.loads([line for line in out.splitlines() if line.startswith("{")][-1])
    assert stats["ate_rmse_m"] < 0.02, out
    rows = (tmp_path / "t.txt").read_text().split("\n")
    assert len([r for r in rows if r.strip()]) == len(seq.frames)
    assert json.loads((tmp_path / "m.jsonl").read_text().splitlines()[-1])["state"] == "OK"

    # the JAX CLI's map, loaded and tracked by the port
    jmain(base + ["--traj-out", str(tmp_path / "j.txt"), "--map-out", str(tmp_path / "j.npz")])
    capsys.readouterr()
    sys_ = System(SystemConfig(intr=seq.intr, enable_reloc=False), device="cpu")
    sys_.load_map(str(tmp_path / "j.npz"))
    data = np.load(tmp_path / "j.npz")
    assert sys_.store.n_kf == int(data["n_kf"]) and sys_.store.n_pt == int(data["n_pt"])
    np.testing.assert_array_equal(sys_.store.pt_pos, data["pt_pos"])
    sys_.activate_localization_mode()
    gray, depth = seq.frames[-1]
    sys_.track_rgbd(np.clip(gray, 0, 255).astype(np.float32), depth, 9.0)
    sys_.poses()
    assert sys_.tracker.state == TrackState.OK
