"""The device renderer against its numpy original, and the traffic
generator's seeding."""

import numpy as np
import pytest
import torch

from benchmark import scene, spec, traffic

CAM = scene.Camera(535.4, 539.2, 320.1, 247.6, 640, 480)


@pytest.mark.parametrize("low_texture", [False, True])
def test_render_matches_numpy_original(low_texture):
    rects = scene.make_room(2**31 + 77, low_texture=low_texture)
    poses = scene.orbit_trajectory(40)
    idx = [0, 23, 39]
    gray, depth = scene.render_frames(rects, poses[idx], CAM, "cpu")
    for k, i in enumerate(idx):
        g_np, d_np = scene.render_frame_np(rects, poses[i], CAM)
        assert np.array_equal(gray[k].numpy(), g_np)
        assert np.array_equal(depth[k].numpy(), d_np)


def test_frozen_copies_equal_the_ports_renderer_today():
    """The room, the trajectories and the frames are those of the port's
    own renderer (spslam_tpu_torch/io/synthetic.py) at the same seed."""
    from spslam_tpu_torch.geometry.camera import Intrinsics
    from spslam_tpu_torch.io import synthetic

    for low in (False, True):
        ours = scene.make_room(123, low_texture=low)
        port = synthetic.make_room(123, low_texture=low)
        assert all(np.array_equal(a.texture, b.texture) and np.array_equal(a.origin, b.origin)
                   for a, b in zip(ours, port))
    assert np.array_equal(scene.orbit_trajectory(40), synthetic.orbit_trajectory(40))
    assert np.array_equal(scene.loop_trajectory(64), synthetic.loop_trajectory(64))
    intr = Intrinsics(fx=CAM.fx, fy=CAM.fy, cx=CAM.cx, cy=CAM.cy, width=640, height=480)
    pose = scene.orbit_trajectory(40)[17]
    g, d = synthetic.render_frame(synthetic.make_room(123), pose, intr)
    g2, d2 = scene.render_frame_np(scene.make_room(123), pose, CAM)
    assert np.array_equal(g, g2) and np.array_equal(d, d2)


def _tiny(name):
    c = spec.cell(name)
    return c._replace(traffic=dict(c.traffic, frames_per_session=3,
                                   room_seeds=c.traffic["room_seeds"][:2]))


def test_sessions_repeat_for_a_seed_and_only_the_noise_follows_it():
    cell = _tiny("spslam_tum3.lowtex")
    a = traffic.make_sessions(cell.traffic, cell.config, 2**31 + 5, "cpu")
    b = traffic.make_sessions(cell.traffic, cell.config, 2**31 + 5, "cpu")
    c = traffic.make_sessions(cell.traffic, cell.config, 2**31 + 6, "cpu")
    assert len(a) == 2
    for x, y in zip(a, b):
        assert np.array_equal(x.gray, y.gray) and np.array_equal(x.depth, y.depth)
    assert not np.array_equal(a[0].gray, a[1].gray)          # two rooms
    assert np.array_equal(a[0].gray, c[0].gray)              # the same rooms for every seed
    assert not np.array_equal(a[0].depth, c[0].depth)        # another noise draw
    s = a[0]
    assert s.gray.dtype == np.uint8 and s.depth.dtype == np.uint16
    assert s.gray.shape == (3, 480, 640) and s.poses_gt.shape == (3, 7)
    assert np.allclose(s.ts, np.arange(3) / 30.0)


def test_depth_noise_is_the_stated_fraction():
    rects = scene.make_room(11)
    poses = scene.orbit_trajectory(40)[:1]
    gen = torch.Generator().manual_seed(3)
    _, clean = scene.render_frames(rects, poses, CAM, "cpu")
    _, noisy = scene.render_frames(rects, poses, CAM, "cpu", 0.008, gen)
    hit = clean > 0
    rel = ((noisy - clean)[hit] / torch.clamp_min(clean[hit], 1.0)).double()
    assert abs(float(rel.std()) - 0.008) < 0.0005
    assert abs(float(rel.mean())) < 0.0005


def test_camera_native_truncates_like_numpy():
    g = torch.tensor([[-3.0, 0.7, 254.9, 300.0]])
    d = torch.tensor([[0.0, 1.23456, 20.0, 0.0001]])
    g8, d16 = scene.camera_native(g, d, 5000.0)
    assert g8.tolist() == np.clip(g.numpy(), 0, 255).astype(np.uint8).tolist()
    assert d16.tolist() == np.clip(d.numpy() * 5000.0, 0, 65535).astype(np.uint16).tolist()
