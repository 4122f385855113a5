"""Loop closing: BoW candidate detection, geometric verification, pose-graph
correction, point correction, loop-end fusion and the post-loop global BA
(port of spslam_tpu/loop/loop_closer.py).

* Detection: KFDB query gated by the weakest covisible keyframe's score,
  the covisibility-group accumulated-score filter, and the
  consecutive-consistency chain (with the early-closure path one detection
  short at a doubled inlier bar).
* Verification: rotation-checked descriptor matching of the two keyframes'
  depth-backed keypoints, batched Horn RANSAC (loop/sim3.py), then one
  round of guided growth by projection.
* Correction: pose graph over the essential graph (spanning tree + strong
  covisibility + loop edges), map points and planes moved through their
  reference keyframes, duplicated landmarks of the two loop ends fused, and
  a global BA on a 1-worker thread (the reference's 4th thread) whose
  result is merged into the grown map.

Runs after keyframe insertion (inline, or on the mapping worker with
async mapping); with detect=False it only maintains the relocalization
index.  Divergences from the reference:
* the RANSAC hypotheses come from an explicit CPU generator seeded 17
  (`self.draw`, replaceable by a test) instead of PRNGKey(17);
* `wait_gba` clears the future when the worker raised (the reference keeps
  the failed future and re-raises it at every later call);
* `_optimize_graph` copies the point-observation rows it reads inside the
  store lock (the reference reads `pt_obs_kf` outside it);
* the GBA worker runs on the System's device explicitly, not the thread's
  current CUDA device.
"""

from __future__ import annotations

import concurrent.futures
import time
from dataclasses import dataclass

import numpy as np
import torch

from .. import resolve_device, tracing
from ..geometry import np_lie
from ..geometry.camera import Intrinsics, project, unproject
from ..geometry.lie import se3_apply, se3_inverse
from ..geometry.plane import transform_plane
from ..map.store import MapStore
from ..mapping.fuse import fuse_into_keyframes
from ..ops.brief import unpack_bits
from ..ops.match import TH_HIGH, match_descriptors, search_by_projection
from ..solver.global_ba import global_bundle_adjust
from ..solver.pose_graph import PoseGraphProblem, optimize_pose_graph
from .kfdb import KeyFrameDatabase
from .sim3 import draw_hypotheses, ransac_align
from .vocab import Vocabulary, bow_similarity


def _retransform(T_old, T_new, X):
    """X' = T_new^{-1} . T_old . X, batched (loop point correction)."""
    return se3_apply(se3_inverse(T_new), se3_apply(T_old, X))


@dataclass(frozen=True)
class LoopConfig:
    """The reference's LoopConfig: the same fields and defaults."""

    min_interval_kfs: int = 10      # don't match very recent keyframes
    consistency_needed: int = 3     # consecutive consistent detections
    min_inliers: int = 20           # RANSAC inliers to accept
    # a candidate one detection short of the chain may close at this
    # multiple of the inlier bar (0 disables)
    early_close_inlier_scale: float = 2.0
    # FIRST-SIGHT closure: the single best candidate may close with no
    # consistency history at `first_sight_inlier_scale` x the inlier bar
    # (3x = 60+ RANSAC inliers + guided growth).  Measured on the paced
    # 128-frame lane: closures fire 2-10 frames earlier and no false
    # closure passed the tripled bar, but an EARLY single closure leaves
    # the post-closure tail drifting (once the loop ends fuse, the region
    # becomes covisible and cannot re-close) — mean ATE ~50 mm vs ~47 for
    # the chain-based path with a much wider spread (34-73 vs 45-49).  OFF
    # by default; useful where revisit windows are too short for any chain.
    first_sight_inlier_scale: float = 0.0
    # floor under the covisibility min-score gate
    min_score_floor: float = 0.015
    covis_edge_weight: int = 30     # covisibility edges in the essential graph
    loop_edge_weight: float = 10.0
    pose_graph_iters: int = 20
    # post-loop global BA: None = auto (dense small maps, the sharded solver
    # for big ones), True = sharded, False = dense
    gba_distributed: bool | None = None
    # post-loop global BA on its own worker thread (False: inline)
    gba_async: bool = True
    gba_settle_iters: int = 10
    gba_stage1_iters: int = 8
    gba_stage2_iters: int = 20


class LoopCloser:
    def __init__(self, intr: Intrinsics, store: MapStore, vocab: Vocabulary | None = None,
                 cfg: LoopConfig = LoopConfig(), device=None):
        self.intr = intr
        self.store = store
        self.cfg = cfg
        self.device = resolve_device(device)
        self.vocab = vocab or Vocabulary(device=self.device)
        self.kfdb = KeyFrameDatabase()
        # culled keyframes stop being loop / relocalization candidates
        store.erase_kf_hooks.append(self.kfdb.erase)
        self._consistent: list[tuple[set, int]] = []
        self.loop_edges: list[tuple[int, int, np.ndarray]] = []  # (i, j, T_ij rel)
        self.n_loops_closed = 0
        # per-closure host times (ms) and the accepted inlier count
        self.last_assembly_ms = 0.0
        self.last_pose_graph_ms = 0.0
        self.last_correct_ms = 0.0
        self.last_gba_ms = 0.0
        self.last_inliers = 0
        # detection-chain progress and closures, a few entries per run
        self.events: list[dict] = []
        # the gates of the last keyframe detection ran on (tools/debug_loop)
        self.last_gates: dict | None = None
        # RANSAC hypothesis draw: (valid [N] numpy) -> [256, 3] indices
        self._gen = torch.Generator().manual_seed(17)
        self.draw = lambda valid: draw_hypotheses(valid, self._gen)
        self._gba_pool = None         # lazy 1-worker executor (gba_async)
        self._gba_future = None

    # -----------------------------------------------------------------
    def process_keyframe(self, kf: int, detect: bool = True) -> bool:
        """Index the new keyframe (vocabulary training + KFDB add) and, when
        `detect`, run loop detection and closure.  Returns True when a loop
        closed."""
        with tracing.span("loop.keyframe"):
            st = self.store
            descs = st.kf_desc[kf][st.kf_kp_valid[kf]]
            if not self.vocab.trained:
                self.vocab.add_training_descriptors(descs)
                if not self.vocab.trained:
                    return False
                # vocabulary just trained: backfill the earlier keyframes
                for k in range(st.n_kf):
                    if k != kf and st.kf_valid[k] and k not in self.kfdb.bow:
                        self.kfdb.add(k, self.vocab.bow_vector(st.kf_desc[k][st.kf_kp_valid[k]]))
            bow = self.vocab.bow_vector(descs)
            if not detect:
                self.kfdb.add(kf, bow)
                return False

            exclude, covis_min, min_score = self._gates(kf, bow)
            self.last_gates = dict(kf=int(kf), bow=bow, exclude=exclude, covis_min=covis_min,
                                   min_score=min_score)
            cands = self.kfdb.query(bow, exclude, min_score)
            self.kfdb.add(kf, bow)
            cands = self._acc_score_filter(cands)
            if not cands:
                self._consistent = []
                return False

            cand_groups = [
                (cand, set(int(c) for c in st.covisibility(cand, min_weight=5)) | {cand})
                for cand, _score in cands
            ]
            accepted, near = self._consistency_check(cand_groups)
            self.events.append(dict(
                kind="detect", kf=int(kf),
                cands=[(int(c), round(float(s), 4)) for c, s in cands[:3]],
                chain=max((c for _, c in self._consistent), default=0),
                accepted=list(map(int, accepted)), near=list(map(int, near)),
            ))
            for cand in accepted:
                if self._close_loop(kf, cand):
                    self._log_closure(kf, cand, False)
                    return True
            if self.cfg.early_close_inlier_scale > 0:
                for cand in near:
                    if self._close_loop(kf, cand, inlier_scale=self.cfg.early_close_inlier_scale):
                        self._log_closure(kf, cand, True)
                        return True
            # first-sight path: the top candidate alone, at its own bar
            if self.cfg.first_sight_inlier_scale > 0 and cands:
                cand = int(cands[0][0])
                if cand not in accepted and cand not in near and self._close_loop(
                    kf, cand, inlier_scale=self.cfg.first_sight_inlier_scale
                ):
                    self._log_closure(kf, cand, "first")
                    return True
            return False

    def _gates(self, kf: int, bow: dict) -> tuple[set, float | None, float]:
        """The detector's gates for keyframe kf with BoW vector bow: the
        keyframes its query excludes (kf, its covisible keyframes and those
        too near in frames or keyframes), the weakest covisible keyframe's
        BoW score (None when none scores) and the min-score: candidates
        must score at least that (DetectLoop's minScore), above a floor."""
        st = self.store
        covis = st.covisibility(kf, min_weight=5)
        exclude = set(int(c) for c in covis) | {int(kf)}
        ks = np.arange(st.n_kf)
        near = (
            (np.abs(st.kf_frame_id[: st.n_kf] - int(st.kf_frame_id[kf])) < 1)
            | (kf - ks < self.cfg.min_interval_kfs)
        )
        exclude |= set(map(int, ks[near]))
        covis_scores = [s for s in (bow_similarity(bow, self.kfdb.bow.get(int(c), {}))
                                    for c in covis) if s > 0]
        covis_min = min(covis_scores) if covis_scores else None
        min_score = self.cfg.min_score_floor
        if covis_min is not None:
            min_score = max(min_score, covis_min)
        return exclude, covis_min, min_score

    def _log_closure(self, kf: int, cand: int, early):
        self.events.append(dict(
            kind="closed", kf=int(kf), cand=int(cand), early=early,
            inliers=self.last_inliers, assembly_ms=round(self.last_assembly_ms, 2),
            pose_graph_ms=round(self.last_pose_graph_ms, 2),
            correct_ms=round(self.last_correct_ms, 2),
        ))

    # -----------------------------------------------------------------
    def _acc_score_filter(self, cands: list[tuple[int, float]]) -> list[tuple[int, float]]:
        """The reference's covisibility-group accumulated-score gate: sum
        each candidate's score with its covisible neighbours that are also
        candidates, keep groups within 75% of the best, one (best) keyframe
        per group."""
        if not cands:
            return []
        st = self.store
        scored = {int(k): s for k, s in cands}
        best_of_group: dict[int, tuple[float, int]] = {}
        best_acc = 0.0
        for k, s in cands:
            neigh = [int(n) for n in st.covisibility(int(k), min_weight=5)[:10]]
            members = [int(k)] + [n for n in neigh if n in scored]
            acc = sum(scored[m] for m in members)
            best_kf = max(members, key=lambda m: scored[m])
            best_acc = max(best_acc, acc)
            prev = best_of_group.get(best_kf)
            if prev is None or acc > prev[0]:
                best_of_group[best_kf] = (acc, best_kf)
        out = [(k, scored[k]) for acc, k in best_of_group.values() if acc >= 0.75 * best_acc]
        out.sort(key=lambda x: -x[1])
        return out

    def _consistency_check(self, cand_groups: list[tuple[int, set]]
                           ) -> tuple[list[int], list[int]]:
        """Consecutive covisibility-consistency accumulator.  Returns
        (accepted, near): near holds candidates one detection short."""
        accepted: list[int] = []
        near: list[int] = []
        new_groups = []
        for cand, group in cand_groups:
            count = 0
            for prev_group, prev_count in self._consistent:
                if group & prev_group:
                    count = max(count, prev_count + 1)
            new_groups.append((group, count))
            if count + 1 >= self.cfg.consistency_needed:
                accepted.append(cand)
            elif count + 2 == self.cfg.consistency_needed:
                near.append(cand)
        self._consistent = new_groups
        return accepted, near

    # -----------------------------------------------------------------
    def _close_loop(self, kf: int, cand: int, inlier_scale: float = 1.0) -> bool:
        st = self.store
        # one global BA in flight at a time; a stuck solve skips this
        # closure (the detector offers candidates again)
        if not self.wait_gba(timeout=30.0):
            return False
        ok, T_cand_cur = self._geometric_check(kf, cand, inlier_scale)
        if not ok:
            return False
        # loop edge (rel = T_i . T_j^{-1}, i = cand, j = kf)
        self.loop_edges.append((int(cand), int(kf), T_cand_cur))
        old_poses = st.kf_pose.copy()
        self._optimize_graph(kf, cand)
        t0 = time.perf_counter()
        self._correct_points(old_poses)
        self.last_correct_ms = (time.perf_counter() - t0) * 1e3
        self._fuse_loop_ends(kf, cand)
        self._global_refine()
        self.n_loops_closed += 1
        self._consistent = []
        return True

    def _fuse_loop_ends(self, kf: int, cand: int):
        """Project the loop side's map points into the current side's
        keyframes with the corrected poses and fuse duplicates."""
        st = self.store
        loop_kfs = np.concatenate([[cand], st.covisibility(cand, min_weight=5)[:8]]).astype(np.int64)
        loop_pts = st.kf_obs[loop_kfs].ravel()
        loop_pts = np.unique(loop_pts[loop_pts >= 0])
        loop_pts = loop_pts[st.pt_valid[loop_pts]]
        cur_kfs = np.concatenate([[kf], st.covisibility(kf, min_weight=5)[:8]]).astype(np.int32)
        fuse_into_keyframes(st, self.intr, loop_pts, cur_kfs, self.device)

    # -----------------------------------------------------------------
    def _global_refine(self):
        """Global BA after the correction, on the worker thread when
        cfg.gba_async (keyframes keep coming meanwhile; `_merge_gba`
        carries the correction to what was created during the solve)."""
        if not self.cfg.gba_async:
            self._run_gba()
            return
        if self._gba_pool is None:
            self._gba_pool = concurrent.futures.ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="gba")
        self._gba_future = self._gba_pool.submit(self._run_gba)

    def wait_gba(self, timeout: float | None = 120.0) -> bool:
        """Join an in-flight global BA, re-raising a worker error once.
        Returns True when no solve remains in flight; a timeout keeps the
        future and returns False."""
        f = self._gba_future
        if f is None:
            return True
        try:
            f.result(timeout)
        except concurrent.futures.TimeoutError:
            if not f.done():
                return False
            self._gba_future = None
            raise
        except BaseException:
            self._gba_future = None
            raise
        self._gba_future = None
        return True

    def _run_gba(self):
        t0 = time.perf_counter()
        if self.device.type == "cuda":
            with torch.cuda.device(self.device):
                res = self._solve_gba()
        else:
            res = self._solve_gba()
        if res is not None and not res["wrote"]:
            self._merge_gba(res)
        self.last_gba_ms = (time.perf_counter() - t0) * 1e3
        self.events.append(dict(kind="gba", ms=round(self.last_gba_ms, 2),
                                newton=bool(res is not None and res["newton"])))

    def _solve_gba(self):
        return global_bundle_adjust(
            self.store, self.intr,
            settle_iters=self.cfg.gba_settle_iters,
            stage1_iters=self.cfg.gba_stage1_iters,
            stage2_iters=self.cfg.gba_stage2_iters,
            distributed=self.cfg.gba_distributed,
            write_back=False, device=self.device,
        )

    def _merge_gba(self, res: dict):
        """Write the GBA result back and carry the correction to keyframes
        (through their spanning-tree parent) and points (through their
        reference keyframe) created while the solve ran."""
        st = self.store
        kf_ids = res["kf_ids"]
        with st.lock:
            old_kf_pose = st.kf_pose.copy()
            st.kf_pose[kf_ids] = res["poses"]
            # new keyframe ids are above the snapshot's last (append-only);
            # ascending, so parents merge first
            prev_valid = int(kf_ids[-1])
            for k in range(int(kf_ids[-1]) + 1, st.n_kf):
                if not st.kf_valid[k]:
                    continue
                p = int(st.kf_parent[k])
                if p < 0 or not st.kf_valid[p]:
                    p = prev_valid
                T_rel = np_lie.se3_compose(old_kf_pose[k], np_lie.se3_inverse(old_kf_pose[p]))
                st.kf_pose[k] = np_lie.se3_compose(T_rel, st.kf_pose[p])
                prev_valid = k
            pt_ids = res["pt_ids"]
            st.pt_pos[pt_ids] = res["points"]
            in_gba = np.zeros(st.pt_valid.shape[0], bool)
            in_gba[pt_ids] = True
            fresh = np.nonzero(st.pt_valid & ~in_gba)[0]
            if len(fresh):
                refs = st.pt_ref_kf[fresh]
                ok = (refs >= 0) & st.kf_valid[np.maximum(refs, 0)]
                fresh, refs = fresh[ok], refs[ok]
                Xc = np_lie.se3_apply(old_kf_pose[refs], st.pt_pos[fresh])
                st.pt_pos[fresh] = np_lie.se3_apply(np_lie.se3_inverse(st.kf_pose[refs]), Xc)
            if res["planes"] is not None and len(res["pl_ids"]):
                st.pl_coef[res["pl_ids"]] = res["planes"]
            st.version += 1

    # -----------------------------------------------------------------
    def _kf(self, name: str, k: int, rows=None) -> torch.Tensor:
        a = getattr(self.store, name)[k]
        if rows is not None:
            a = a[rows]
        if a.dtype == np.uint32:
            a = a.view(np.int32)
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def _geometric_check(self, kf: int, cand: int, inlier_scale: float = 1.0):
        """Descriptor match + 3D-3D RANSAC between two keyframes, then one
        round of guided growth: the accepted alignment projects the
        candidate's keypoints into the current keyframe as a window gate,
        and the grown match set re-estimates the transform.  Returns (ok,
        T_ba [7] numpy)."""
        st = self.store
        intr = self.intr
        min_inl = int(round(self.cfg.min_inliers * inlier_scale))

        def kf_arrays(k):
            bits = unpack_bits(self._kf("kf_desc", k))
            valid = torch.from_numpy(st.kf_kp_valid[k] & (st.kf_depth[k] > 1e-3)).to(self.device)
            return bits, valid

        bits_a, valid_a = kf_arrays(kf)
        bits_b, valid_b = kf_arrays(cand)
        res = match_descriptors(bits_a, bits_b, valid_a, valid_b,
                                self._kf("kf_angle", kf), self._kf("kf_angle", cand),
                                max_dist=64.0, ratio=0.85)
        m = res.valid.cpu().numpy()
        if m.sum() < min_inl:
            return False, None
        pa = unproject(intr, self._kf("kf_uv", kf), self._kf("kf_depth", kf))
        idx = np.maximum(res.idx.cpu().numpy(), 0)
        pb = unproject(intr, self._kf("kf_uv", cand, idx), self._kf("kf_depth", cand, idx))
        align = ransac_align(pa, pb, res.valid, self.draw(m))
        n_inl = int(align.n_inliers)
        if n_inl < min_inl:
            return False, None

        # guided growth: project all of cand's depth-backed keypoints into
        # kf with the accepted alignment, re-match inside octave-scaled
        # windows, re-estimate from the grown set
        pb_all = unproject(intr, self._kf("kf_uv", cand), self._kf("kf_depth", cand))
        pa_pred = se3_apply(se3_inverse(align.T_ba), pb_all)
        uv_pred = project(intr, pa_pred)
        oct_b = self._kf("kf_octave", cand)
        res2 = search_by_projection(
            uv_pred, bits_b, valid_b & (pa_pred[:, 2] > 0.05), oct_b,
            self._kf("kf_uv", kf), bits_a, valid_a, self._kf("kf_octave", kf),
            10.0 * torch.pow(1.2, oct_b.to(torch.float32)),
            max_dist=TH_HIGH, ratio=0.95, check_rotation=False,
        )
        idx2 = np.maximum(res2.idx.cpu().numpy(), 0)
        m2 = res2.valid.cpu().numpy() & (st.kf_depth[kf][idx2] > 1e-3)
        if m2.sum() > m.sum():
            pa2 = unproject(intr, self._kf("kf_uv", kf, idx2), self._kf("kf_depth", kf, idx2))
            # rows are cand keypoints here: align2 still maps kf-side
            # points (pa2) to cand-side points
            align2 = ransac_align(pa2, pb_all, torch.from_numpy(m2).to(self.device),
                                  self.draw(m2))
            n2 = int(align2.n_inliers)
            if n2 >= n_inl:
                align, n_inl = align2, n2
        self.last_inliers = n_inl
        return True, align.T_ba.cpu().numpy()

    # -----------------------------------------------------------------
    def _optimize_graph(self, kf: int, cand: int):
        """Essential graph: spanning-tree + strong covisibility + loop
        edges.  The host assembly snapshots under the store lock, the
        solve runs outside it, and results write back by stable ids."""
        st = self.store
        t_asm = time.perf_counter()
        with st.lock:
            K = st.cfg.max_keyframes
            n_kf = st.n_kf
            kf_pose = st.kf_pose[:K].copy()
            kf_valid = st.kf_valid[:K].copy()
            kf_parent = st.kf_parent[:K].copy()
            kf_obs = st.kf_obs[:n_kf].copy()
            valid_ids = np.nonzero(kf_valid[:n_kf])[0]
            pts_k = kf_obs[valid_ids]                                  # [Kv, N]
            obs = st.pt_obs_kf[np.maximum(pts_k, 0)]                   # [Kv, N, O] copy
        # spanning-tree edges, with the previous valid keyframe standing in
        # for a culled parent
        children = valid_ids[1:]
        parents = kf_parent[children]
        par_ok = (parents >= 0) & kf_valid[np.maximum(parents, 0)]
        parents = np.where(par_ok, parents, valid_ids[:-1])
        ei, ej = [parents], [children]
        ew = [np.ones(len(children), np.float32)]

        # strong covisibility edges: shared-point counts [Kv, Kv], top 5 per
        # row at or above the weight, upper triangle, no sequential pairs
        Kv = len(valid_ids)
        kmap = np.full(K, -1, np.int64)
        kmap[valid_ids] = np.arange(Kv)
        ok = (pts_k >= 0)[:, :, None] & (obs >= 0)
        r, _, _ = np.nonzero(ok)
        cols = kmap[np.minimum(obs[ok], K - 1)]
        good = cols >= 0
        cnt = np.zeros((Kv, Kv), np.int32)
        np.add.at(cnt, (r[good], cols[good]), 1)
        np.fill_diagonal(cnt, 0)
        top = np.argsort(-cnt, axis=1)[:, :5]
        rows5 = np.repeat(np.arange(Kv), top.shape[1])
        w5 = cnt[rows5, top.ravel()]
        keep = w5 >= self.cfg.covis_edge_weight
        ci = valid_ids[rows5[keep]]
        cj = valid_ids[top.ravel()[keep]]
        a, b = np.minimum(ci, cj), np.maximum(ci, cj)
        adj = (b - a) > 1
        pairs = np.unique(np.stack([a[adj], b[adj]], 1), axis=0)
        if len(pairs):
            ei.append(pairs[:, 0])
            ej.append(pairs[:, 1])
            ew.append(np.ones(len(pairs), np.float32))
        ei = np.concatenate(ei).astype(np.int64)
        ej = np.concatenate(ej).astype(np.int64)
        ew = np.concatenate(ew)
        eT = np_lie.se3_compose(kf_pose[ei], np_lie.se3_inverse(kf_pose[ej]))

        le = [(int(i), int(j), T_ij) for (i, j, T_ij) in self.loop_edges
              if kf_valid[i] and kf_valid[j]]
        if le:
            ei = np.concatenate([ei, np.array([x[0] for x in le], np.int64)])
            ej = np.concatenate([ej, np.array([x[1] for x in le], np.int64)])
            eT = np.concatenate([eT, np.stack([x[2] for x in le]).astype(np.float32)])
            ew = np.concatenate([ew, np.full(len(le), self.cfg.loop_edge_weight, np.float32)])

        # edge count padded to a power-of-two bucket (few distinct shapes)
        E = len(ei)
        Ep = 256
        while Ep < E:
            Ep *= 2
        ei_p = np.zeros(Ep, np.int64)
        ej_p = np.zeros(Ep, np.int64)
        eT_p = np.tile(np.array([1, 0, 0, 0, 0, 0, 0], np.float32), (Ep, 1))
        ew_p = np.zeros(Ep, np.float32)
        ei_p[:E], ej_p[:E], eT_p[:E], ew_p[:E] = ei, ej, eT, ew
        fixed = np.zeros(K, bool)
        fixed[valid_ids[0]] = True
        self.last_assembly_ms = (time.perf_counter() - t_asm) * 1e3

        t0 = time.perf_counter()

        def d(x):
            return torch.from_numpy(x).to(self.device)

        prob = PoseGraphProblem(
            poses=d(kf_pose), fixed=d(fixed | ~kf_valid), valid=d(kf_valid),
            edge_i=d(ei_p), edge_j=d(ej_p), edge_T=d(eT_p), edge_w=d(ew_p),
            edge_valid=d(np.arange(Ep) < E),
        )
        new_poses = optimize_pose_graph(prob, n_iters=self.cfg.pose_graph_iters).cpu().numpy()
        self.last_pose_graph_ms = (time.perf_counter() - t0) * 1e3
        with st.lock:
            st.kf_pose[valid_ids] = new_poses[valid_ids]
            st.version += 1

    def _correct_points(self, old_poses: np.ndarray):
        """Move each map point (and plane) through its reference keyframe's
        correction: X' = T_wc_new . T_cw_old . X."""
        st = self.store
        with st.lock:
            pt_valid = st.pt_valid.copy()
            pt_ref_kf = st.pt_ref_kf.copy()
            pt_pos = st.pt_pos.copy()
            kf_valid = st.kf_valid.copy()
            kf_pose = st.kf_pose.copy()
            pl_valid = st.pl_valid.copy()
            pl_ref_kf = st.pl_ref_kf.copy()
            pl_coef = st.pl_coef.copy()
        pts = np.nonzero(pt_valid)[0]
        if len(pts) == 0:
            return
        nk = len(old_poses)

        def ref_or_0(refs):
            return np.where((refs >= 0) & (refs < nk) & kf_valid[np.clip(refs, 0, nk - 1)],
                            refs, 0)

        def d(x):
            return torch.from_numpy(np.ascontiguousarray(x)).to(self.device)

        refs = ref_or_0(pt_ref_kf[pts])
        Xw = _retransform(d(old_poses[refs]), d(kf_pose[refs]), d(pt_pos[pts])).cpu().numpy()
        with st.lock:
            st.pt_pos[pts] = Xw
            st.version += 1
        pls = np.nonzero(pl_valid)[0]
        if len(pls):
            prefs = ref_or_0(pl_ref_kf[pls])
            pi_c = transform_plane(d(old_poses[prefs]), d(pl_coef[pls]))
            pi_w = transform_plane(se3_inverse(d(kf_pose[prefs])), pi_c).cpu().numpy()
            with st.lock:
                st.pl_coef[pls] = pi_w
                st.version += 1
