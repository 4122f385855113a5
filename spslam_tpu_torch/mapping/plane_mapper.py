"""Plane landmarks per keyframe (port of spslam_tpu/mapping/plane_mapper.py):
segmentation of the keyframe's full depth on the device, association with
the map planes by normal-angle and distance gates, support-weighted
refinement of the matched plane, and parallel / perpendicular structural
edges between co-observed planes (SP-SLAM's "supposed planes", read by
the local BA).

One device round trip per keyframe: `segment_planes` runs on the device
and the fields the loop reads come back in one copy; the per-plane math
is float32 numpy (geometry/plane.py's numpy twins).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .. import resolve_device, tracing
from ..geometry import np_lie
from ..geometry.camera import Intrinsics
from ..geometry.plane import normalize_plane_np, transform_plane_np
from ..map.store import MapStore
from ..ops.plane_seg import segment_planes


@dataclass(frozen=True)
class PlaneMapperConfig:
    """Same fields and defaults as the reference's PlaneMapperConfig."""

    assoc_angle_deg: float = 8.0      # association gates
    assoc_dist: float = 0.15
    struct_angle_deg: float = 5.0     # tolerance for parallel/perp relations
    min_inliers: int = 4000           # pixels supporting a frame plane
    obs_weight_scale: float = 1e-4    # information per supporting pixel


class PlaneMapper:
    def __init__(self, intr: Intrinsics, store: MapStore,
                 cfg: PlaneMapperConfig = PlaneMapperConfig(), device=None):
        self.intr = intr
        self.store = store
        self.cfg = cfg
        self.device = resolve_device(device)
        # raw-depth divisor for integer depth frames (System sets it)
        self.depth_factor = 5000.0

    def _segment(self, depth: np.ndarray):
        """(coef [K,4], n_inliers [K], valid [K]) of the keyframe's depth,
        numpy, through one device->host copy."""
        d = torch.from_numpy(np.ascontiguousarray(depth)).to(self.device)
        if not d.is_floating_point():
            d = d.to(torch.float32) / self.depth_factor
        res = segment_planes(d, self.intr)
        out = torch.cat([res.coef, res.n_inliers.to(torch.float32)[:, None],
                         res.valid.to(torch.float32)[:, None]], dim=1).cpu().numpy()
        return out[:, :4], out[:, 4].astype(np.int64), out[:, 5] > 0.5

    def process_keyframe(self, kf: int, depth: np.ndarray):
        """Segment keyframe kf's depth (float meters or raw integer units),
        associate and merge its planes; returns the map-plane ids it
        observed.  (The reference also takes the gray image and ignores it.)"""
        with tracing.span("planes.keyframe"):
            st = self.store
            cfg = self.cfg
            with tracing.span("planes.segment"):
                coefs_c, inliers, valid = self._segment(
                    depth.astype(np.int32) if depth.dtype.kind in "iu" else depth)
            with tracing.span("planes.associate"):
                T_wc = np_lie.se3_inverse(st.kf_pose[kf])
                observed_ids = []
                for i in range(len(valid)):
                    if not valid[i] or inliers[i] < cfg.min_inliers:
                        continue
                    pi_c = coefs_c[i]
                    pi_w = normalize_plane_np(transform_plane_np(T_wc, pi_c))
                    l = self._associate(pi_w)
                    w = cfg.obs_weight_scale * float(inliers[i])
                    if l < 0:
                        l = st.add_plane(pi_w, kf, int(inliers[i]))
                    else:
                        # support-weighted running refinement of the world plane
                        w_old = float(st.pl_n_pts[l])
                        w_new = float(inliers[i])
                        old = st.pl_coef[l]
                        new = pi_w if np.dot(old[:3], pi_w[:3]) >= 0 else -pi_w
                        mixed = (w_old * old + w_new * new) / (w_old + w_new)
                        st.pl_coef[l] = normalize_plane_np(mixed.astype(np.float32))
                        st.pl_n_pts[l] = int(min(w_old + w_new, 2 ** 30))
                    st.add_plane_observation(l, kf, pi_cam=pi_c, weight=w)
                    observed_ids.append(l)
                self._add_structural_edges(observed_ids)
            return observed_ids

    def _associate(self, pi_w: np.ndarray) -> int:
        """Nearest map plane within the angle + distance gates, else -1."""
        st = self.store
        cfg = self.cfg
        ids = np.nonzero(st.pl_valid)[0]
        if len(ids) == 0:
            return -1
        n = st.pl_coef[ids, :3]
        d = st.pl_coef[ids, 3]
        cos = np.abs(n @ pi_w[:3])
        # compare d with matching normal orientation
        sign = np.sign(n @ pi_w[:3] + 1e-12)
        dd = np.abs(d - sign * pi_w[3])
        ok = (cos > np.cos(np.radians(cfg.assoc_angle_deg))) & (dd < cfg.assoc_dist)
        cand = ids[ok]
        if len(cand) == 0:
            return -1
        return int(cand[np.argmin(dd[ok])])

    def _add_structural_edges(self, observed_ids):
        """Co-observed planes that are nearly parallel or nearly
        perpendicular get a structural edge."""
        st = self.store
        tol = np.radians(self.cfg.struct_angle_deg)
        for i in range(len(observed_ids)):
            for j in range(i + 1, len(observed_ids)):
                a, b = observed_ids[i], observed_ids[j]
                if a == b:
                    continue
                c = abs(float(np.dot(st.pl_coef[a, :3], st.pl_coef[b, :3])))
                if c > np.cos(tol):
                    st.add_plane_edge(a, b, 0)    # parallel
                elif c < np.sin(tol):
                    st.add_plane_edge(a, b, 1)    # perpendicular
