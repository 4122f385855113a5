"""Settings files: the reference's YAML parameter names mapped onto a
SystemConfig (port of spslam_tpu/config.py).

Camera.fx/fy/cx/cy, distortion, DepthMapFactor, ThDepth, ORBextractor.*
and SP-SLAM's plane thresholds map 1:1 onto SystemConfig fields.  The
parser reads the flat `Key.Sub: value` subset of cv::FileStorage YAML
that the settings files use, with no YAML library.

    cfg = system_config_from_yaml("configs/tum1.yaml", use_loop=True)
"""

from __future__ import annotations

import re

from .geometry.camera import Intrinsics
from .mapping.plane_mapper import PlaneMapperConfig
from .tracking.tracker import TrackerConfig


def load_settings(path: str) -> dict:
    """{key: float} of every `Key.Sub: number` line; comments dropped."""
    vals: dict[str, float] = {}
    with open(path) as f:
        for line in f:
            line = line.split("#", 1)[0].strip()
            m = re.match(r"([\w.]+)\s*:\s*([-+\d.eE]+)\s*$", line)
            if m:
                vals[m.group(1)] = float(m.group(2))
    return vals


def system_config_from_yaml(path: str, **overrides):
    """A SystemConfig from a reference-style YAML settings file; keyword
    arguments set further SystemConfig fields."""
    from .system import SystemConfig

    v = load_settings(path)
    intr = Intrinsics(
        fx=v.get("Camera.fx", 525.0),
        fy=v.get("Camera.fy", 525.0),
        cx=v.get("Camera.cx", 319.5),
        cy=v.get("Camera.cy", 239.5),
        k1=v.get("Camera.k1", 0.0),
        k2=v.get("Camera.k2", 0.0),
        p1=v.get("Camera.p1", 0.0),
        p2=v.get("Camera.p2", 0.0),
        k3=v.get("Camera.k3", 0.0),
        bf=v.get("Camera.bf", 40.0),
        width=int(v.get("Camera.width", 640)),
        height=int(v.get("Camera.height", 480)),
    )
    tracker = TrackerConfig(
        n_features=int(v.get("ORBextractor.nFeatures", 1024)),
        n_levels=int(v.get("ORBextractor.nLevels", 8)),
        scale_factor=v.get("ORBextractor.scaleFactor", 1.2),
        th_fast_high=v.get("ORBextractor.iniThFAST", 20.0),
        th_fast_low=v.get("ORBextractor.minThFAST", 7.0),
        th_depth=v.get("ThDepth", 3.2),
    )
    cfg = SystemConfig(intr=intr, tracker=tracker, **overrides)
    if "Plane.AngleThreshold" in v or "Plane.DistanceThreshold" in v:
        cfg.plane_cfg = PlaneMapperConfig(
            assoc_angle_deg=v.get("Plane.AngleThreshold", 8.0),
            assoc_dist=v.get("Plane.DistanceThreshold", 0.15),
        )
    cfg.depth_map_factor = v.get("DepthMapFactor", 5000.0)
    return cfg
