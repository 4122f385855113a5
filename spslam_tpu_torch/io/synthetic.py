"""Synthetic textured RGB-D sequence with exact ground truth (numpy copy of
spslam_tpu/io/synthetic.py, orbit trajectory, with the low-texture room and
the depth noise of the planes lane).

A ray-cast "room" of finite textured rectangles (floor, walls, boxes).  The
reference builds its textures with OpenCV's resize; this copy computes the
same bicubic and nearest resizes in numpy (float32, OpenCV's coefficients
and border rule), so it needs numpy alone.  Rendering happens once per
sequence, outside the timed SLAM path.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Tuple

import numpy as np

from ..geometry.camera import Intrinsics
from ..geometry.np_lie import quat_to_mat


@dataclass
class TexturedRect:
    """Finite rectangle: origin + two edge vectors, with a procedural texture."""

    origin: np.ndarray  # [3]
    eu: np.ndarray      # [3] edge 1 (texture u axis)
    ev: np.ndarray      # [3] edge 2 (texture v axis)
    texture: np.ndarray  # [th, tw] float32 intensities 0..255

    @property
    def normal(self) -> np.ndarray:
        n = np.cross(self.eu, self.ev)
        return n / np.linalg.norm(n)


def _cubic_taps(dst_n: int, src_n: int):
    """Source indices [dst_n, 4] and weights for OpenCV INTER_CUBIC (A=-0.75,
    pixel-centre mapping, replicated border)."""
    scale = 1.0 / (dst_n / src_n)
    f = ((np.arange(dst_n) + 0.5) * scale - 0.5).astype(np.float32)
    s = np.floor(f)
    x = (f - s).astype(np.float32)
    A = np.float32(-0.75)
    one = np.float32(1.0)
    c0 = ((A * (x + one) - 5 * A) * (x + one) + 8 * A) * (x + one) - 4 * A
    c1 = ((A + 2) * x - (A + 3)) * x * x + one
    c2 = ((A + 2) * (one - x) - (A + 3)) * (one - x) * (one - x) + one
    c3 = one - c0 - c1 - c2
    idx = np.clip(s.astype(np.int64)[:, None] + np.arange(-1, 3), 0, src_n - 1)
    return idx, np.stack([c0, c1, c2, c3], axis=-1).astype(np.float32)


def _resize_cubic(src: np.ndarray, w: int, h: int) -> np.ndarray:
    """cv2.resize(src, (w, h), interpolation=INTER_CUBIC) for float32."""
    ix, cx = _cubic_taps(w, src.shape[1])
    iy, cy = _cubic_taps(h, src.shape[0])
    t = src[:, ix]                                            # [sh, w, 4]
    hor = t[..., 0] * cx[:, 0] + t[..., 1] * cx[:, 1] + t[..., 2] * cx[:, 2] + t[..., 3] * cx[:, 3]
    v = hor[iy]                                               # [h, 4, w]
    return (v[:, 0] * cy[:, 0, None] + v[:, 1] * cy[:, 1, None]
            + v[:, 2] * cy[:, 2, None] + v[:, 3] * cy[:, 3, None]).astype(np.float32)


def _resize_nearest(src: np.ndarray, w: int, h: int) -> np.ndarray:
    """cv2.resize(src, (w, h), interpolation=INTER_NEAREST)."""
    sh, sw = src.shape
    xs = np.minimum(np.floor(np.arange(w) * (1.0 / (w / sw))).astype(np.int64), sw - 1)
    ys = np.minimum(np.floor(np.arange(h) * (1.0 / (h / sh))).astype(np.int64), sh - 1)
    return src[ys[:, None], xs[None, :]]


def _noise_texture(rng, th=256, tw=256, base=120.0, contrast=90.0, cell=16):
    """Smooth random texture with enough corners for FAST; varied scales and
    high-contrast blobs make surfaces statistically distinct."""
    cell = int(rng.choice([8, 12, 16, 24, 32]))
    small = rng.uniform(-1, 1, size=(max(th // cell, 2), max(tw // cell, 2)))
    tex = _resize_cubic(small.astype(np.float32), tw, th)
    fine_cell = int(rng.choice([3, 4, 6]))
    fine = rng.uniform(-1, 1, size=(th // fine_cell, tw // fine_cell))
    tex = tex + 0.5 * _resize_nearest(fine.astype(np.float32), tw, th)
    for _ in range(int(rng.integers(4, 10))):
        cy, cx = rng.integers(20, th - 20), rng.integers(20, tw - 20)
        r = int(rng.integers(8, 30))
        sign = rng.choice([-1.5, 1.5])
        yy, xx = np.ogrid[:th, :tw]
        mask = (yy - cy) ** 2 + (xx - cx) ** 2 < r ** 2
        tex[mask] += sign
    tex = base + contrast * tex / np.abs(tex).max()
    return np.clip(tex, 5, 250).astype(np.float32)


def _low_texture(rng, th=256, tw=256, base=120.0):
    """Near-uniform surface with a few faint blobs: FAST finds almost no
    corners on it, while its depth planes stay exact."""
    tex = np.full((th, tw), base, np.float32)
    tex += rng.normal(0, 1.5, (th, tw)).astype(np.float32)
    for _ in range(int(rng.integers(2, 4))):
        cy, cx = rng.integers(30, th - 30), rng.integers(30, tw - 30)
        r = int(rng.integers(10, 22))
        yy, xx = np.ogrid[:th, :tw]
        mask = (yy - cy) ** 2 + (xx - cx) ** 2 < r ** 2
        tex[mask] += rng.choice([-18.0, 18.0])
    return np.clip(tex, 5, 250).astype(np.float32)


def make_room(seed: int = 0, size: float = 6.0, height: float = 3.0,
              low_texture: bool = False) -> List[TexturedRect]:
    """A closed box room + two interior boxes, all textured (near-blank
    walls with low_texture=True)."""
    rng = np.random.default_rng(seed)
    s, h = size, height
    rects = []

    def rect(o, eu, ev):
        rects.append(TexturedRect(
            origin=np.array(o, np.float64), eu=np.array(eu, np.float64),
            ev=np.array(ev, np.float64),
            texture=_low_texture(rng) if low_texture else _noise_texture(rng),
        ))

    rect([-s / 2, h / 2, -s / 2], [s, 0, 0], [0, 0, s])      # floor
    rect([-s / 2, -h / 2, -s / 2], [s, 0, 0], [0, 0, s])     # ceiling
    rect([-s / 2, -h / 2, s / 2], [s, 0, 0], [0, h, 0])      # back wall  (z = +s/2)
    rect([-s / 2, -h / 2, -s / 2], [s, 0, 0], [0, h, 0])     # front wall (z = -s/2)
    rect([-s / 2, -h / 2, -s / 2], [0, 0, s], [0, h, 0])     # left wall
    rect([s / 2, -h / 2, -s / 2], [0, 0, s], [0, h, 0])      # right wall
    for (bx, bz, bw, bh_) in [(-1.2, 1.2, 1.0, 1.2), (1.0, 0.4, 0.8, 0.9)]:
        y0 = h / 2 - bh_
        rect([bx, y0, bz], [bw, 0, 0], [0, bh_, 0])
        rect([bx, y0, bz + bw], [bw, 0, 0], [0, bh_, 0])
        rect([bx, y0, bz], [0, 0, bw], [0, bh_, 0])
        rect([bx + bw, y0, bz], [0, 0, bw], [0, bh_, 0])
    return rects


def render_frame(rects: List[TexturedRect], T_cw: np.ndarray, intr: Intrinsics,
                 depth_noise: float = 0.0, rng: np.random.Generator | None = None
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """Ray-cast one RGB-D frame: (gray [H,W] float32 0..255, depth [H,W]
    float32 meters) at T_cw [7] (world->camera).  depth_noise > 0 adds
    Gaussian noise of that fraction of max(z, 1 m), drawn from rng."""
    H, W = intr.height, intr.width
    R_cw = quat_to_mat(np.asarray(T_cw[:4], np.float32)).astype(np.float64)
    t_cw = T_cw[4:7].astype(np.float64)
    C = -R_cw.T @ t_cw
    us, vs = np.meshgrid(np.arange(W), np.arange(H))
    dirs_c = np.stack(
        [(us - intr.cx) / intr.fx, (vs - intr.cy) / intr.fy, np.ones_like(us, np.float64)],
        axis=-1,
    )
    dirs_w = dirs_c @ R_cw

    best_t = np.full((H, W), np.inf)
    img = np.zeros((H, W), np.float32)
    for r in rects:
        n = r.normal
        denom = dirs_w @ n
        d_plane = -np.dot(n, r.origin)
        tt = -(np.dot(n, C) + d_plane) / np.where(np.abs(denom) < 1e-12, np.inf, denom)
        hit = tt > 1e-6
        X = C[None, None, :] + tt[..., None] * dirs_w
        rel = X - r.origin
        a = (rel @ r.eu) / np.dot(r.eu, r.eu)
        bcoord = (rel @ r.ev) / np.dot(r.ev, r.ev)
        inside = (a >= 0) & (a <= 1) & (bcoord >= 0) & (bcoord <= 1)
        closer = hit & inside & (tt < best_t)
        if not closer.any():
            continue
        th, tw = r.texture.shape
        a_safe = np.nan_to_num(np.where(closer, a, 0.0))
        b_safe = np.nan_to_num(np.where(closer, bcoord, 0.0))
        ti = np.clip((b_safe * (th - 1)).astype(np.int32), 0, th - 1)
        tj = np.clip((a_safe * (tw - 1)).astype(np.int32), 0, tw - 1)
        img = np.where(closer, r.texture[ti, tj], img)
        best_t = np.where(closer, tt, best_t)

    # ray directions have camera z = 1, so the ray parameter is the depth
    depth = np.where(np.isfinite(best_t), best_t, 0.0).astype(np.float32)
    if depth_noise > 0 and rng is not None:
        noisy = depth + rng.normal(0, depth_noise, depth.shape) * np.maximum(depth, 1.0)
        depth = np.where(depth > 0, np.maximum(noisy, 0.05), 0.0).astype(np.float32)
    return img, depth


def _so3_exp_quat(phi: np.ndarray) -> np.ndarray:
    """float32 axis-angle -> quaternion (the JAX so3_exp_quat in numpy)."""
    theta2 = np.sum(phi * phi, axis=-1, keepdims=True)
    theta = np.sqrt(np.maximum(theta2, np.float32(1e-24)))
    small = theta2 < 1e-12
    w = np.where(small, 1.0 - theta2 / 8.0, np.cos(0.5 * theta))
    k = np.where(small, 0.5 - theta2 / 48.0, np.sin(0.5 * theta) / theta)
    q = np.concatenate([w, k * phi], axis=-1).astype(np.float32)
    return q / np.maximum(np.linalg.norm(q, axis=-1, keepdims=True), 1e-12)


def _mat_to_quat(m: np.ndarray) -> np.ndarray:
    """float32 3x3 rotation -> quaternion [w,x,y,z] with w >= 0."""
    m = m.astype(np.float32)
    (m00, m01, m02), (m10, m11, m12), (m20, m21, m22) = m
    cands = np.array([1.0 + m00 + m11 + m22, 1.0 + m00 - m11 - m22,
                      1.0 - m00 + m11 - m22, 1.0 - m00 - m11 + m22], np.float32)
    i = int(np.argmax(cands))
    s = np.sqrt(max(cands[i], np.float32(1e-12))) * np.float32(2.0)
    q = [
        [s / 4.0, (m21 - m12) / s, (m02 - m20) / s, (m10 - m01) / s],
        [(m21 - m12) / s, s / 4.0, (m01 + m10) / s, (m02 + m20) / s],
        [(m02 - m20) / s, (m01 + m10) / s, s / 4.0, (m12 + m21) / s],
        [(m10 - m01) / s, (m02 + m20) / s, (m12 + m21) / s, s / 4.0],
    ][i]
    q = np.array(q, np.float32)
    q = -q if q[0] < 0 else q
    return q / max(np.linalg.norm(q), 1e-12)


def _pose_cw(cx, cy, cz, pitch, yaw) -> np.ndarray:
    """T_cw [7] of a camera at (cx, cy, cz) turned by (pitch, yaw)."""
    q = _so3_exp_quat(np.array([pitch, yaw, 0.0], np.float32))
    Rcw = quat_to_mat(q).T
    tcw = -Rcw @ np.array([cx, cy, cz])
    return np.concatenate([_mat_to_quat(Rcw), tcw]).astype(np.float32)


def orbit_trajectory(n_frames: int) -> np.ndarray:
    """Smooth arc inside the room with small rotations: [F, 7] T_cw."""
    poses = []
    for i in range(n_frames):
        a = 2.0 * np.pi * i / max(n_frames * 4, 1)  # quarter orbit over sequence
        poses.append(_pose_cw(0.8 * np.sin(a), 0.15 * np.sin(3 * a), -1.0 + 0.3 * np.sin(2 * a),
                              0.08 * np.sin(a * 3.0), 0.25 * np.sin(a * 2.0)))
    return np.stack(poses)


def loop_trajectory(n_frames: int, turns: float = 1.25) -> np.ndarray:
    """Yaw rotation in place (plus small sway) that overshoots a full turn,
    so the last quarter of the sequence re-traverses the starting views (a
    sustained revisit window for the loop detector's consistency chain).
    The sway is periodic in the turn angle.  Returns [F, 7] T_cw."""
    poses = []
    for i in range(n_frames):
        a = 2.0 * np.pi * turns * i / n_frames
        poses.append(_pose_cw(0.4 * np.sin(a), 0.05 * np.sin(3 * a), -0.8 + 0.2 * np.sin(2 * a),
                              0.03 * np.sin(2 * a), a))
    return np.stack(poses)


@dataclass
class SyntheticSequence:
    """Pre-rendered sequence with ground truth."""

    frames: List[Tuple[np.ndarray, np.ndarray]] = field(default_factory=list)
    poses_gt: np.ndarray = None  # [F, 7] T_cw
    timestamps: np.ndarray = None
    intr: Intrinsics = None


def make_sequence(n_frames: int = 30, intr: Intrinsics | None = None, seed: int = 0,
                  depth_noise: float = 0.0, trajectory: str = "orbit",
                  low_texture: bool = False) -> SyntheticSequence:
    """The reference's sequences ("orbit" or "loop"): same seeds, room and
    noise draws."""
    intr = intr or Intrinsics(fx=525.0, fy=525.0, cx=319.5, cy=239.5, bf=40.0,
                              width=640, height=480)
    rects = make_room(seed=seed, low_texture=low_texture)
    poses = loop_trajectory(n_frames) if trajectory == "loop" else orbit_trajectory(n_frames)
    rng = np.random.default_rng(seed + 2)
    seq = SyntheticSequence(frames=[], poses_gt=poses,
                            timestamps=np.arange(n_frames) / 30.0, intr=intr)
    for i in range(n_frames):
        seq.frames.append(render_frame(rects, poses[i], intr, depth_noise, rng))
    return seq
