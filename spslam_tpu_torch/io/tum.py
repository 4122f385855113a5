"""TUM RGB-D (and ICL-NUIM in TUM layout) sequences on disk (port of
spslam_tpu/io/tum.py): rgb.txt / depth.txt (or associations.txt) paired by
nearest timestamp, PNG frames, DepthMapFactor, groundtruth.txt.

    seq = load_tum_sequence("rgbd_dataset_freiburg1_xyz", "configs/tum1.yaml")

The reference reads the PNGs with OpenCV; this module decodes them with
zlib + numpy (`read_png`), the kinds a TUM directory holds: 8-bit RGB
(TUM's rgb/) or gray, and 16-bit gray depth, non-interlaced, all five
filter types.  Depth equals `cv2.imread(..., IMREAD_UNCHANGED)`; gray
equals `cv2.imread(..., IMREAD_GRAYSCALE)`, which converts RGB through
libpng's fixed-point `rgb_to_gray` (0.299 / 0.587 as 9797 / 19234 / 3737
over 2^15, truncated).
"""

from __future__ import annotations

import os
import re
import struct
import zlib
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np

from ..geometry import np_lie
from ..geometry.camera import Intrinsics

# Default TUM freiburg intrinsics per sequence family (fr1/fr2/fr3), matching
# the reference's Examples/RGB-D/TUMX.yaml files.
TUM_INTRINSICS = {
    "fr1": dict(fx=517.306408, fy=516.469215, cx=318.643040, cy=255.313989,
                k1=0.262383, k2=-0.953104, p1=-0.005358, p2=0.002628, k3=1.163314),
    "fr2": dict(fx=520.908620, fy=521.007327, cx=325.141442, cy=249.701764,
                k1=0.231222, k2=-0.784899, p1=-0.003257, p2=-0.000105, k3=0.917205),
    "fr3": dict(fx=535.4, fy=539.2, cx=320.1, cy=247.6),
    "icl": dict(fx=481.20, fy=-480.0, cx=319.5, cy=239.5),
}

_PNG_SIG = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3}        # PNG colour types read here: gray, RGB
# libpng's png_set_rgb_to_gray(0.299, 0.587) in 1/32768 units
_GRAY_R, _GRAY_G, _GRAY_B = 9797, 19234, 3737


def _unfilter(raw: np.ndarray, H: int, W: int, bpp: int) -> np.ndarray:
    """Undo the per-row PNG filters of raw [H, 1 + W*bpp] bytes -> [H, W,
    bpp] bytes.  A pixel depends on its left, upper and upper-left
    neighbours, so the image is swept by anti-diagonals, each one
    vectorized over its rows (every row by its own filter type)."""
    ftype = raw[:, 0].astype(np.int32)
    if ftype.max() > 4:
        raise ValueError(f"bad PNG filter type {ftype.max()}")
    filt = raw[:, 1:].reshape(H, W, bpp).astype(np.int32)
    out = np.zeros((H + 1, W + 1, bpp), np.int32)   # zero row/col: PNG's border
    for d in range(H + W - 1):
        r = np.arange(max(0, d - W + 1), min(H - 1, d) + 1)
        j = d - r
        a, b, c = out[r + 1, j], out[r, j + 1], out[r, j]   # left, up, up-left
        p = a + b - c
        pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
        paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
        t = ftype[r][:, None]
        pred = np.select([t == 1, t == 2, t == 3, t == 4], [a, b, (a + b) >> 1, paeth], 0)
        out[r + 1, j + 1] = (filt[r, j] + pred) & 255
    return out[1:, 1:].astype(np.uint8)


def read_png(path: str, gray: bool) -> np.ndarray:
    """Decode a non-interlaced 8-bit gray / RGB or 16-bit gray PNG.

    gray=True: [H, W] uint8, as cv2.IMREAD_GRAYSCALE (RGB through
    libpng's fixed-point rgb_to_gray); gray=False: the stored samples
    ([H, W] uint8 / uint16, or [H, W, 3] RGB), as cv2.IMREAD_UNCHANGED
    gives them (up to OpenCV's BGR channel order)."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != _PNG_SIG:
        raise ValueError(f"{path}: not a PNG file")
    pos, hdr, idat = 8, None, []
    while pos < len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        if kind == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
        pos += 12 + n
    W, H, depth, ctype, _, _, interlace = hdr
    if ctype not in _CHANNELS or depth not in (8, 16) or interlace:
        raise ValueError(f"{path}: unsupported PNG (colour type {ctype}, depth {depth}, "
                         f"interlace {interlace})")
    ch = _CHANNELS[ctype]
    bpp = ch * depth // 8
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8).reshape(H, 1 + W * bpp)
    px = _unfilter(raw, H, W, bpp)
    if depth == 16:
        px = (px[..., 0::2].astype(np.uint16) << 8) | px[..., 1::2]
    if ch == 1:
        px = px[..., 0]
    if not gray:
        return px
    if depth == 16:
        px = (px >> 8).astype(np.uint8)
    if ch == 3:
        rgb = px.astype(np.uint32)
        px = ((_GRAY_R * rgb[..., 0] + _GRAY_G * rgb[..., 1] + _GRAY_B * rgb[..., 2])
              >> 15).astype(np.uint8)
    return px


@dataclass
class TumSequence:
    frames: List[Tuple[np.ndarray, np.ndarray]] = field(default_factory=list)
    timestamps: np.ndarray = None
    intr: Intrinsics = None
    poses_gt: Optional[np.ndarray] = None  # [F,7] T_cw or None


def _read_file_list(path: str):
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            out.append((float(parts[0]), parts[1:]))
    return out


def associate(a, b, max_dt=0.02):
    """Greedy nearest-timestamp association (TUM associate.py semantics)."""
    pairs = []
    bi = 0
    for ta, pa in a:
        best, best_dt = None, max_dt
        for tb, pb in b[max(bi - 2, 0): bi + 50]:
            dt = abs(ta - tb)
            if dt < best_dt:
                best, best_dt = (tb, pb), dt
        if best is not None:
            pairs.append((ta, pa, best[0], best[1]))
            bi += 1
    return pairs


def guess_intrinsics(seq_dir: str) -> Intrinsics:
    name = os.path.basename(os.path.normpath(seq_dir)).lower()
    fam = "fr1"
    if "freiburg2" in name or "fr2" in name:
        fam = "fr2"
    elif "freiburg3" in name or "fr3" in name:
        fam = "fr3"
    elif "living" in name or "lr" in name or "icl" in name or "office" in name:
        fam = "icl"
    return Intrinsics(width=640, height=480, bf=40.0, **TUM_INTRINSICS[fam])


def load_intrinsics_yaml(path: str) -> Intrinsics:
    """Read the reference's OpenCV-YAML camera settings (Camera.fx etc.)."""
    vals = {}
    with open(path) as f:
        for line in f:
            m = re.match(r"\s*Camera\.(\w+)\s*:\s*([-\d.eE+]+)", line)
            if m:
                vals[m.group(1)] = float(m.group(2))
    return Intrinsics(
        fx=vals.get("fx", 525.0), fy=vals.get("fy", 525.0),
        cx=vals.get("cx", 319.5), cy=vals.get("cy", 239.5),
        k1=vals.get("k1", 0.0), k2=vals.get("k2", 0.0),
        p1=vals.get("p1", 0.0), p2=vals.get("p2", 0.0), k3=vals.get("k3", 0.0),
        bf=vals.get("bf", 40.0),
        width=int(vals.get("width", 640)), height=int(vals.get("height", 480)),
    )


def load_groundtruth(path: str, timestamps: np.ndarray) -> Optional[np.ndarray]:
    """groundtruth.txt rows: ts tx ty tz qx qy qz qw (T_wc) -> [F,7] T_cw."""
    if not os.path.exists(path):
        return None
    rows = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            rows.append([float(x) for x in line.split()[:8]])
    gt = np.array(rows)
    out = []
    for ts in timestamps:
        i = int(np.argmin(np.abs(gt[:, 0] - ts)))
        tx, ty, tz, qx, qy, qz, qw = gt[i, 1:8]
        out.append(np_lie.se3_inverse(np.array([qw, qx, qy, qz, tx, ty, tz], np.float32)))
    return np.stack(out)


def load_tum_sequence(seq_dir: str, config_yaml: Optional[str] = None,
                      depth_factor: float = 5000.0,
                      max_frames: Optional[int] = None) -> TumSequence:
    intr = load_intrinsics_yaml(config_yaml) if config_yaml else guess_intrinsics(seq_dir)

    assoc_path = os.path.join(seq_dir, "associations.txt")
    pairs = []
    if os.path.exists(assoc_path):
        with open(assoc_path) as f:
            for line in f:
                line = line.strip()
                if not line or line.startswith("#"):
                    continue
                p = line.split()
                # ts_rgb rgb_path ts_depth depth_path (either order)
                if "depth" in p[1]:
                    pairs.append((float(p[2]), [p[3]], float(p[0]), [p[1]]))
                else:
                    pairs.append((float(p[0]), [p[1]], float(p[2]), [p[3]]))
    else:
        rgb = _read_file_list(os.path.join(seq_dir, "rgb.txt"))
        depth = _read_file_list(os.path.join(seq_dir, "depth.txt"))
        pairs = associate(rgb, depth)

    if max_frames:
        pairs = pairs[:max_frames]

    seq = TumSequence(frames=[], intr=intr)
    ts_list = []
    for t_rgb, rgb_p, _, d_p in pairs:
        try:
            img = read_png(os.path.join(seq_dir, rgb_p[0]), gray=True)
            dep = read_png(os.path.join(seq_dir, d_p[0]), gray=False)
        except (OSError, ValueError, zlib.error):
            continue   # the reference skips a frame cv2.imread cannot read
        seq.frames.append((img.astype(np.float32), dep.astype(np.float32) / depth_factor))
        ts_list.append(t_rgb)
    seq.timestamps = np.array(ts_list)
    seq.poses_gt = load_groundtruth(os.path.join(seq_dir, "groundtruth.txt"), seq.timestamps)
    return seq
