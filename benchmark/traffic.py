"""The one traffic generator: a mix's data file -> the RGB-D sessions of a run.

A traffic file (benchmark/traffic/<name>.json) holds

    room                "textured" or "low_texture" (scene.make_room)
    room_seeds          the rooms of the mix, one a session: the window runs
                        them back to back, from the first, round robin
    trajectory          "orbit" or "loop", with `trajectory_args`
    frames_per_session  frames of one session (one System, start to stop)
    fps                 the camera clock of the timestamps
    depth_noise         fraction of max(z, 1 m), Gaussian
    feed                "closed": the next frame is handed in when the
                        previous call returns

Every seed gets the same rooms, sizes, trajectory and frame count; the
seed draws the depth noise (a torch generator seeded by (seed, session)),
so a seed gives the same inputs on every run.  The rooms do not follow the
seed: the trajectory error differs far more from room to room than from
run to run, and a room drawn by the seed would change the work.  The
noise draw does not: runs on one draw spread as widely as runs on draws
of different seeds.
Frames are rendered on the device in set-up and held in host memory as the
u8 gray / u16 depth pairs a TUM PNG pair delivers.
"""

from __future__ import annotations

from typing import List, NamedTuple

import numpy as np
import torch

from . import scene

CHUNK = 8   # frames ray-cast per device call


class Session(NamedTuple):
    gray: np.ndarray      # [F, H, W] uint8
    depth: np.ndarray     # [F, H, W] uint16, depth_factor units per metre
    poses_gt: np.ndarray  # [F, 7] T_cw
    ts: np.ndarray        # [F] seconds


def _draw(seed: int, *key: int) -> int:
    """A 63-bit seed for stream `key` of run seed `seed`."""
    ss = np.random.SeedSequence([int(seed) % (1 << 63), *key])
    return int(ss.generate_state(1, np.uint64)[0] >> np.uint64(1))


def camera(config: dict) -> scene.Camera:
    c = config["camera"]
    return scene.Camera(c["fx"], c["fy"], c["cx"], c["cy"], c["width"], c["height"])


def make_sessions(traffic: dict, config: dict, seed: int, device) -> List[Session]:
    """The traffic's sessions, one per room, for run seed `seed`."""
    if traffic["feed"] != "closed":
        raise ValueError(f"feed {traffic['feed']!r}: only 'closed' is implemented")
    cam = camera(config)
    n = int(traffic["frames_per_session"])
    poses = scene.TRAJECTORIES[traffic["trajectory"]](n, **traffic.get("trajectory_args", {}))
    ts = np.arange(n) / float(traffic["fps"])
    factor = float(config["system"]["depth_map_factor"])
    out = []
    for k, room in enumerate(traffic["room_seeds"]):
        rects = scene.make_room(int(room), low_texture=traffic["room"] == "low_texture")
        gen = torch.Generator(device=device)
        gen.manual_seed(_draw(seed, k))
        grays, depths = [], []
        for i in range(0, n, CHUNK):
            g, d = scene.render_frames(rects, poses[i:i + CHUNK], cam, device,
                                       float(traffic["depth_noise"]), gen)
            g8, d16 = scene.camera_native(g, d, factor)
            grays.append(g8)
            depths.append(d16)
        out.append(Session(np.concatenate(grays), np.concatenate(depths), poses, ts))
    return out
