"""Synthetic RGB-D scenes with exact ground truth, rendered on the device.

The room (14 textured rectangles: floor, ceiling, four walls and two boxes)
and the camera trajectories are frozen numpy copies of the port's
renderer (`spslam_tpu_torch/io/synthetic.py`), so the same room seed gives
the same textures.  `render_frames` is the PyTorch ray-caster of this
benchmark: ray-plane hits over every rectangle, nearest-texel lookup,
depth noise drawn from a torch generator, all in float64 on the device
like the numpy original.  `render_frame_np` is the numpy original, kept as
the yardstick that the tests hold `render_frames` against.
"""

from __future__ import annotations

from typing import List, NamedTuple

import numpy as np
import torch


class Rect(NamedTuple):
    """Finite rectangle: origin + two edge vectors, with its texture."""

    origin: np.ndarray   # [3] float64
    eu: np.ndarray       # [3] edge 1 (texture u axis)
    ev: np.ndarray       # [3] edge 2 (texture v axis)
    texture: np.ndarray  # [th, tw] float32 intensities 0..255

    @property
    def normal(self) -> np.ndarray:
        n = np.cross(self.eu, self.ev)
        return n / np.linalg.norm(n)


class Camera(NamedTuple):
    fx: float
    fy: float
    cx: float
    cy: float
    width: int
    height: int


# ---------------------------------------------------------------- textures
def _cubic_taps(dst_n: int, src_n: int):
    """Source indices [dst_n, 4] and weights of OpenCV's INTER_CUBIC
    (A = -0.75, pixel-centre mapping, replicated border)."""
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
    ix, cx = _cubic_taps(w, src.shape[1])
    iy, cy = _cubic_taps(h, src.shape[0])
    t = src[:, ix]
    hor = t[..., 0] * cx[:, 0] + t[..., 1] * cx[:, 1] + t[..., 2] * cx[:, 2] + t[..., 3] * cx[:, 3]
    v = hor[iy]
    return (v[:, 0] * cy[:, 0, None] + v[:, 1] * cy[:, 1, None]
            + v[:, 2] * cy[:, 2, None] + v[:, 3] * cy[:, 3, None]).astype(np.float32)


def _resize_nearest(src: np.ndarray, w: int, h: int) -> np.ndarray:
    sh, sw = src.shape
    xs = np.minimum(np.floor(np.arange(w) * (1.0 / (w / sw))).astype(np.int64), sw - 1)
    ys = np.minimum(np.floor(np.arange(h) * (1.0 / (h / sh))).astype(np.int64), sh - 1)
    return src[ys[:, None], xs[None, :]]


def _noise_texture(rng, th=256, tw=256, base=120.0, contrast=90.0):
    """Smooth random texture with enough corners for FAST."""
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
        tex[(yy - cy) ** 2 + (xx - cx) ** 2 < r ** 2] += sign
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
        tex[(yy - cy) ** 2 + (xx - cx) ** 2 < r ** 2] += rng.choice([-18.0, 18.0])
    return np.clip(tex, 5, 250).astype(np.float32)


def make_room(seed: int, low_texture: bool = False, size: float = 6.0,
              height: float = 3.0) -> List[Rect]:
    """A closed box room + two interior boxes; near-blank surfaces with
    low_texture=True."""
    rng = np.random.default_rng(seed)
    s, h = size, height
    rects = []

    def rect(o, eu, ev):
        rects.append(Rect(np.array(o, np.float64), np.array(eu, np.float64),
                          np.array(ev, np.float64),
                          _low_texture(rng) if low_texture else _noise_texture(rng)))

    rect([-s / 2, h / 2, -s / 2], [s, 0, 0], [0, 0, s])      # floor
    rect([-s / 2, -h / 2, -s / 2], [s, 0, 0], [0, 0, s])     # ceiling
    rect([-s / 2, -h / 2, s / 2], [s, 0, 0], [0, h, 0])      # back wall
    rect([-s / 2, -h / 2, -s / 2], [s, 0, 0], [0, h, 0])     # front wall
    rect([-s / 2, -h / 2, -s / 2], [0, 0, s], [0, h, 0])     # left wall
    rect([s / 2, -h / 2, -s / 2], [0, 0, s], [0, h, 0])      # right wall
    for (bx, bz, bw, bh_) in [(-1.2, 1.2, 1.0, 1.2), (1.0, 0.4, 0.8, 0.9)]:
        y0 = h / 2 - bh_
        rect([bx, y0, bz], [bw, 0, 0], [0, bh_, 0])
        rect([bx, y0, bz + bw], [bw, 0, 0], [0, bh_, 0])
        rect([bx, y0, bz], [0, 0, bw], [0, bh_, 0])
        rect([bx + bw, y0, bz], [0, 0, bw], [0, bh_, 0])
    return rects


# ------------------------------------------------------------ trajectories
def quat_to_mat(q: np.ndarray) -> np.ndarray:
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    m = np.stack([
        1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
        2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
        2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y),
    ], axis=-1)
    return m.reshape(q.shape[:-1] + (3, 3))


def _so3_exp_quat(phi: np.ndarray) -> np.ndarray:
    theta2 = np.sum(phi * phi, axis=-1, keepdims=True)
    theta = np.sqrt(np.maximum(theta2, np.float32(1e-24)))
    small = theta2 < 1e-12
    w = np.where(small, 1.0 - theta2 / 8.0, np.cos(0.5 * theta))
    k = np.where(small, 0.5 - theta2 / 48.0, np.sin(0.5 * theta) / theta)
    q = np.concatenate([w, k * phi], axis=-1).astype(np.float32)
    return q / np.maximum(np.linalg.norm(q, axis=-1, keepdims=True), 1e-12)


def _mat_to_quat(m: np.ndarray) -> np.ndarray:
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
    """T_cw [7] = [qw qx qy qz tx ty tz] of a camera at (cx, cy, cz)
    turned by (pitch, yaw)."""
    q = _so3_exp_quat(np.array([pitch, yaw, 0.0], np.float32))
    Rcw = quat_to_mat(q).T
    tcw = -Rcw @ np.array([cx, cy, cz])
    return np.concatenate([_mat_to_quat(Rcw), tcw]).astype(np.float32)


def orbit_trajectory(n_frames: int, radius: float = 0.8) -> np.ndarray:
    """A quarter orbit of `radius` over the sequence with small rotations:
    [F, 7] T_cw."""
    poses = []
    for i in range(n_frames):
        a = 2.0 * np.pi * i / max(n_frames * 4, 1)
        poses.append(_pose_cw(radius * np.sin(a), 0.15 * np.sin(3 * a),
                              -1.0 + 0.3 * np.sin(2 * a),
                              0.08 * np.sin(a * 3.0), 0.25 * np.sin(a * 2.0)))
    return np.stack(poses)


def loop_trajectory(n_frames: int, turns: float = 1.25) -> np.ndarray:
    """Yaw in place (plus sway) over `turns` turns, so the last part of the
    sequence revisits the first views: [F, 7] T_cw."""
    poses = []
    for i in range(n_frames):
        a = 2.0 * np.pi * turns * i / n_frames
        poses.append(_pose_cw(0.4 * np.sin(a), 0.05 * np.sin(3 * a), -0.8 + 0.2 * np.sin(2 * a),
                              0.03 * np.sin(2 * a), a))
    return np.stack(poses)


TRAJECTORIES = {"orbit": orbit_trajectory, "loop": loop_trajectory}


# --------------------------------------------------------------- rendering
def _rays(cam: Camera, device) -> torch.Tensor:
    """[H, W, 3] float64 camera-frame ray directions with z = 1."""
    vs, us = torch.meshgrid(torch.arange(cam.height, dtype=torch.float64, device=device),
                            torch.arange(cam.width, dtype=torch.float64, device=device),
                            indexing="ij")
    return torch.stack([(us - cam.cx) / cam.fx, (vs - cam.cy) / cam.fy, torch.ones_like(us)], -1)


def render_frames(rects: List[Rect], poses_cw: np.ndarray, cam: Camera, device,
                  depth_noise: float = 0.0, generator: torch.Generator | None = None):
    """Ray-cast frames at poses_cw [F, 7] on `device`: (gray [F, H, W]
    float32 0..255, depth [F, H, W] float32 metres).  depth_noise > 0 adds
    Gaussian noise of that fraction of max(z, 1 m), drawn from `generator`
    (a generator on `device`)."""
    dev = torch.device(device)
    R = quat_to_mat(np.asarray(poses_cw[:, :4], np.float32)).astype(np.float64)
    R = torch.from_numpy(R).to(dev)
    t = torch.from_numpy(np.asarray(poses_cw[:, 4:7], np.float64)).to(dev)
    C = -torch.einsum("fij,fi->fj", R, t)                             # [F, 3]
    dirs = torch.einsum("hwi,fij->fhwj", _rays(cam, dev), R)          # [F, H, W, 3]
    F_, H, W = dirs.shape[0], cam.height, cam.width
    best_t = torch.full((F_, H, W), float("inf"), dtype=torch.float64, device=dev)
    img = torch.zeros((F_, H, W), dtype=torch.float32, device=dev)
    for r in rects:
        n = torch.from_numpy(r.normal).to(dev)
        o = torch.from_numpy(r.origin).to(dev)
        eu = torch.from_numpy(r.eu).to(dev)
        ev = torch.from_numpy(r.ev).to(dev)
        tex = torch.from_numpy(r.texture).to(dev)
        denom = dirs @ n
        d_plane = -torch.dot(n, o)
        num = -((C @ n) + d_plane)[:, None, None]
        tt = num / torch.where(torch.abs(denom) < 1e-12, float("inf"), denom)
        hit = tt > 1e-6
        rel = C[:, None, None, :] + tt[..., None] * dirs - o
        a = (rel @ eu) / torch.dot(eu, eu)
        b = (rel @ ev) / torch.dot(ev, ev)
        closer = hit & (a >= 0) & (a <= 1) & (b >= 0) & (b <= 1) & (tt < best_t)
        th, tw = tex.shape
        a_safe = torch.nan_to_num(torch.where(closer, a, 0.0))
        b_safe = torch.nan_to_num(torch.where(closer, b, 0.0))
        ti = torch.clamp((b_safe * (th - 1)).to(torch.int32), 0, th - 1).long()
        tj = torch.clamp((a_safe * (tw - 1)).to(torch.int32), 0, tw - 1).long()
        img = torch.where(closer, tex[ti, tj], img)
        best_t = torch.where(closer, tt, best_t)
    depth = torch.where(torch.isfinite(best_t), best_t, 0.0)
    if depth_noise > 0:
        noise = torch.randn(depth.shape, dtype=torch.float64, device=dev, generator=generator)
        noisy = depth.to(torch.float32).to(torch.float64) + noise * depth_noise * torch.clamp_min(
            depth.to(torch.float32).to(torch.float64), 1.0)
        depth = torch.where(depth > 0, torch.clamp_min(noisy, 0.05), 0.0)
    return img, depth.to(torch.float32)


def camera_native(gray: torch.Tensor, depth: torch.Tensor, depth_factor: float):
    """(u8 gray, u16 depth at depth_factor units per metre) as numpy, the
    dtypes a TUM PNG pair delivers; truncation as numpy's astype."""
    g = torch.clamp(gray, 0, 255).to(torch.uint8)
    d = torch.clamp(depth * depth_factor, 0, 65535).to(torch.int32)
    return g.cpu().numpy(), d.cpu().numpy().astype(np.uint16)


def render_frame_np(rects: List[Rect], T_cw: np.ndarray, cam: Camera):
    """The numpy original of `render_frames` for one noise-free frame:
    (gray [H, W] float32, depth [H, W] float32)."""
    H, W = cam.height, cam.width
    R_cw = quat_to_mat(np.asarray(T_cw[:4], np.float32)).astype(np.float64)
    t_cw = T_cw[4:7].astype(np.float64)
    C = -R_cw.T @ t_cw
    us, vs = np.meshgrid(np.arange(W), np.arange(H))
    dirs_c = np.stack([(us - cam.cx) / cam.fx, (vs - cam.cy) / cam.fy,
                       np.ones_like(us, np.float64)], axis=-1)
    dirs_w = dirs_c @ R_cw
    best_t = np.full((H, W), np.inf)
    img = np.zeros((H, W), np.float32)
    for r in rects:
        n = r.normal
        denom = dirs_w @ n
        d_plane = -np.dot(n, r.origin)
        tt = -(np.dot(n, C) + d_plane) / np.where(np.abs(denom) < 1e-12, np.inf, denom)
        hit = tt > 1e-6
        rel = C[None, None, :] + tt[..., None] * dirs_w - r.origin
        a = (rel @ r.eu) / np.dot(r.eu, r.eu)
        b = (rel @ r.ev) / np.dot(r.ev, r.ev)
        closer = hit & (a >= 0) & (a <= 1) & (b >= 0) & (b <= 1) & (tt < best_t)
        if not closer.any():
            continue
        th, tw = r.texture.shape
        a_safe = np.nan_to_num(np.where(closer, a, 0.0))
        b_safe = np.nan_to_num(np.where(closer, b, 0.0))
        ti = np.clip((b_safe * (th - 1)).astype(np.int32), 0, th - 1)
        tj = np.clip((a_safe * (tw - 1)).astype(np.int32), 0, tw - 1)
        img = np.where(closer, r.texture[ti, tj], img)
        best_t = np.where(closer, tt, best_t)
    return img, np.where(np.isfinite(best_t), best_t, 0.0).astype(np.float32)
