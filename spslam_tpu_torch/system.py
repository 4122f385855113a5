"""System facade: build the pipeline, feed RGB-D frames, save results
(port of spslam_tpu/system.py, synchronous mapping): points, planes with
use_planes=True, loop closure with use_loop=True, and relocalization with
enable_reloc=True (the default, as in the reference).

    sys_ = System(SystemConfig(intr=intr, use_loop=True))   # on CUDA
    for (gray, depth), ts in frames:
        sys_.track_rgbd(gray, depth, ts)
    poses = sys_.poses(); sys_.shutdown()
"""

from __future__ import annotations

import dataclasses
import os
from dataclasses import dataclass, field

import numpy as np

from . import resolve_device
from .geometry import np_lie
from .geometry.camera import Intrinsics
from .loop.loop_closer import LoopCloser, LoopConfig
from .loop.vocab import DEFAULT_VOCAB_PATH, Vocabulary
from .map.store import SAVED_ARRAYS, MapConfig, MapStore
from .mapping.local_mapper import LocalMapper, MapperConfig
from .mapping.plane_mapper import PlaneMapper, PlaneMapperConfig
from .tracking.tracker import Tracker, TrackerConfig, TrackState


@dataclass
class SystemConfig:
    """Every field and default of the reference's SystemConfig."""

    intr: Intrinsics = field(default_factory=lambda: Intrinsics(
        fx=525.0, fy=525.0, cx=319.5, cy=239.5, bf=40.0, width=640, height=480
    ))
    tracker: TrackerConfig = field(default_factory=TrackerConfig)
    mapper: MapperConfig = field(default_factory=MapperConfig)
    map: MapConfig = field(default_factory=MapConfig)
    use_planes: bool = False
    use_loop: bool = False
    enable_reloc: bool = True     # keep the vocabulary and KFDB for relocalization
    gba_distributed: bool | None = None
    async_mapping: bool = False
    local_ba: bool = True
    localization_only: bool = False
    vocab_path: str | None = None
    plane_cfg: PlaneMapperConfig | None = None
    depth_map_factor: float = 5000.0  # raw-depth divisor for integer datasets


# features of the reference this port does not have yet, and the slice of
# the port that brings each
_LATER = (
    ("async_mapping", "a later slice (async mapping, tracking/pipeline.py)"),
    ("gba_distributed", "slice 4 (the sharded global BA, parallel/dist_ba.py)"),
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class System:
    def __init__(self, cfg: SystemConfig, device=None):
        for name, slice_ in _LATER:
            if getattr(cfg, name):
                raise NotImplementedError(
                    f"SystemConfig.{name}=True is not ported yet; it comes with {slice_}"
                )
        self.device = resolve_device(device)
        self.cfg = cfg
        if cfg.map.n_kp != cfg.tracker.n_features:
            # the store's per-KF keypoint budget follows the feature budget
            cfg.map = dataclasses.replace(cfg.map, n_kp=cfg.tracker.n_features)
        self.store = MapStore(cfg.map)
        self.tracker = Tracker(cfg.tracker, cfg.intr, self.store, device=self.device)
        self.tracker.depth_factor = cfg.depth_map_factor
        self.mapper = LocalMapper(cfg.mapper, cfg.intr, self.store, device=self.device)
        if cfg.use_planes or cfg.use_loop:
            # plane accuracy and loop detection are sensitive to keyframe
            # cadence, which a deeper pipeline shifts (at depth 3 the
            # reference's consistency chain never completed on the loop
            # sequence): the reference caps both at depth 2
            self.tracker.pipeline_depth = min(self.tracker.pipeline_depth, 2)
        self.plane_mapper = None
        if cfg.use_planes:
            self.plane_mapper = PlaneMapper(cfg.intr, self.store,
                                            cfg.plane_cfg or PlaneMapperConfig(),
                                            device=self.device)
            self.plane_mapper.depth_factor = cfg.depth_map_factor
            self.tracker.use_planes = True
        self.loop_closer = None
        if cfg.use_loop or cfg.enable_reloc:
            path = cfg.vocab_path
            if path is None:
                default = os.path.join(ROOT, DEFAULT_VOCAB_PATH)
                path = default if os.path.exists(default) else None
            vocab = Vocabulary(n_words=4096, device=self.device)
            if path:
                vocab.load(path)
            self.loop_closer = LoopCloser(cfg.intr, self.store, vocab,
                                          cfg=LoopConfig(gba_distributed=cfg.gba_distributed),
                                          device=self.device)
            self.tracker.relocalizer = (self.loop_closer.vocab, self.loop_closer.kfdb)
        self.trajectory: list[tuple[float, np.ndarray]] = []
        self._rel_trajectory: list[tuple[float, int, np.ndarray]] = []

    # -----------------------------------------------------------------
    def track_rgbd(self, gray: np.ndarray, depth: np.ndarray, ts: float):
        """Feed one frame (gray: [H,W] u8 or float 0..255; depth: u16 raw
        units or float meters).  Returns (T_cw [7], state) of the most
        recently RESOLVED frame; the full trajectory is exact after
        poses()/shutdown()."""
        for rec in self.tracker.process_pipelined(gray, depth, ts):
            self._absorb(rec)
        return self.tracker.T_cw.copy(), self.tracker.state

    def _absorb(self, rec):
        """Trajectory bookkeeping + mapping for one resolved frame.  Poses
        are stored relative to their reference keyframe, so BA corrections
        to keyframes carry over to the whole trajectory."""
        T, ts, state = rec.T, rec.ts, rec.state
        ref = rec.ref_kf if state == TrackState.OK else -1
        if ref >= 0:
            T_rel = np_lie.se3_compose(T, np_lie.se3_inverse(self.store.kf_pose[ref]))
        else:
            T_rel = T
        self._rel_trajectory.append((ts, int(ref), T_rel))
        self.trajectory.append((ts, T))
        if rec.new_kf >= 0 and not self.cfg.localization_only:
            if self.plane_mapper is not None and state == TrackState.OK:
                self.plane_mapper.process_keyframe(rec.new_kf, rec.depth)
            self.mapper.process_keyframe(rec.new_kf, run_ba=self.cfg.local_ba)
            if self.loop_closer is not None:
                # detect=False keeps the relocalization index without ever
                # closing loops (use_loop=False)
                if self.loop_closer.process_keyframe(rec.new_kf, detect=self.cfg.use_loop):
                    # realign the tracker with the corrected map
                    self.tracker.external_pose_correction(self.store.kf_pose[rec.new_kf])
                    self.trajectory[-1] = (ts, self.tracker.T_cw.copy())

    # -----------------------------------------------------------------
    def poses(self) -> np.ndarray:
        """Per-frame T_cw through the CURRENT keyframe poses."""
        for rec in self.tracker.flush_pipeline():
            self._absorb(rec)
        if self.loop_closer is not None:
            self.loop_closer.wait_gba()  # land an in-flight global BA
        out = []
        for (ts, ref, T_rel), (_, T_abs) in zip(self._rel_trajectory, self.trajectory):
            if ref >= 0 and self.store.kf_valid[ref]:
                out.append(np_lie.se3_compose(T_rel, self.store.kf_pose[ref]))
            else:
                out.append(T_abs)
        return np.stack(out)

    def save_trajectory_tum(self, path: str):
        """TUM format: ts tx ty tz qx qy qz qw, camera-to-world."""
        poses = self.poses()
        with open(path, "w") as f:
            for (ts, _), T_cw in zip(self.trajectory, poses):
                qw, qx, qy, qz, tx, ty, tz = np_lie.se3_inverse(T_cw)
                f.write(f"{ts:.6f} {tx:.6f} {ty:.6f} {tz:.6f} {qx:.6f} {qy:.6f} {qz:.6f} {qw:.6f}\n")

    def save_keyframe_trajectory_tum(self, path: str):
        """TUM format, one line per valid keyframe."""
        st = self.store
        with open(path, "w") as f:
            for k in np.nonzero(st.kf_valid[: st.n_kf])[0]:
                qw, qx, qy, qz, tx, ty, tz = np_lie.se3_inverse(st.kf_pose[k])
                f.write(f"{st.kf_ts[k]:.6f} {tx:.6f} {ty:.6f} {tz:.6f} "
                        f"{qx:.6f} {qy:.6f} {qz:.6f} {qw:.6f}\n")

    # -----------------------------------------------------------------
    def save_map(self, path: str):
        """Checkpoint the map (.npz with the reference's array names)."""
        st = self.store
        np.savez_compressed(
            path, **{k: getattr(st, k) for k in SAVED_ARRAYS},
            n_kf=st.n_kf, n_pt=st.n_pt, n_pl=st.n_pl,
        )

    def load_map(self, path: str):
        """Load a map checkpoint (this package's or spslam_tpu's save_map)
        and resume tracking against it."""
        st = self.store
        cfg_n_kp = st.cfg.n_kp
        with np.load(path) as data:
            st.load_arrays(data)
        if st.cfg.n_kp != cfg_n_kp:
            raise ValueError(
                f"checkpoint keypoint budget ({st.cfg.n_kp}) != this System's "
                f"configured n_kp ({cfg_n_kp}); construct the System with a "
                f"matching MapConfig/TrackerConfig to load this map"
            )
        valid_kfs = np.nonzero(st.kf_valid)[0]
        if len(valid_kfs):
            self.tracker.ref_kf = int(valid_kfs[-1])
            self.tracker.last_kf = self.tracker.ref_kf
            self.tracker.T_cw = st.kf_pose[self.tracker.ref_kf].copy()
            self.tracker.state = TrackState.OK

    def activate_localization_mode(self):
        self.cfg.localization_only = True

    def deactivate_localization_mode(self):
        self.cfg.localization_only = False

    def shutdown(self):
        for rec in self.tracker.flush_pipeline():
            self._absorb(rec)
        lc = self.loop_closer
        # one more global BA over the closed map, only when no solve is
        # still in flight (two solves would race their merges)
        if (lc is not None and lc.wait_gba() and lc.n_loops_closed > 0
                and not self.cfg.localization_only):
            lc._run_gba()
