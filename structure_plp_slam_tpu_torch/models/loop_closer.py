"""Loop detection, validation and correction.

Port of structure_plp_slam_tpu/models/loop_closer.py (reference
global_optimization_module.cc, module/loop_detector.cc,
loop_bundle_adjuster.cc). The loop thread becomes host orchestration
around four device stages:

1. detect   — retrieval scores against every keyframe (``data/bow``), the
              min-score gate from the covisibility neighbourhood, and a
              continuity >= 3 requirement (loop_detector.cc:102-127);
2. validate — dense descriptor matching between the two keyframes'
              landmarks, Sim3 RANSAC and its reweighted refinement
              (loop_detector.cc:334);
3. correct  — Sim3 propagation over the current keyframe's covisibles,
              landmark transformation, duplicate fusion through the fused
              matcher (global_optimization_module.cc:233-260);
4. optimize — the Sim3 pose graph over all keyframes
              (``models/pose_graph``), then global BA (``models/global_ba``).

Device results the host gates on travel as one packed vector each, copied
to the host without waiting (``utils/types.HostCopy``). The System drives
these stages as deferred phases over later frames; :meth:`LoopCloser.correct`
is the synchronous form.
"""

from __future__ import annotations

import logging
from typing import List, Optional, Tuple

import numpy as np
import torch

from structure_plp_slam_tpu_torch.data import map_state as ms
from structure_plp_slam_tpu_torch.data.bow import BowIndex
from structure_plp_slam_tpu_torch.models import global_ba, mapper
from structure_plp_slam_tpu_torch.models import pose_graph as pg
from structure_plp_slam_tpu_torch.ops import lie, matching, sim3_solver
from structure_plp_slam_tpu_torch.utils.types import HostCopy, nonzero_static

_log = logging.getLogger("plpslam.torch.loop_closer")

# LoopCloser's defaults: consecutive detections of one covisibility
# cluster; matches, RANSAC inliers and refined inliers a loop needs;
# keyframes between loop closures (and from the candidate).
MIN_CONTINUITY = 3
MIN_INLIERS = 20
MIN_GAP = 10
MATCH_MAX_HAMMING = 50
COVIS_NEIGHBOR = 15  # shared landmarks that make two keyframes neighbours
COVIS_STRONG = 100   # shared landmarks that make a pose-graph edge
LOOP_EDGE_WEIGHT = 10.0
DENSE_GRAPH_MAX_K = 512  # beyond this the pose graph and global BA run PCG


def _match_landmark_pairs(camera, state: ms.MapState, kf1, kf2):
    """Match kf1's keypoints that hold landmarks against kf2's (mutual
    best, Hamming <= 50). Per kf1 slot: (lm1, lm2, pts1 [N, 3], pts2
    [N, 3] in each keyframe's camera frame, uv1, uv2, sig1, sig2, valid)."""
    L = state.lm_pos.shape[0]
    has1 = (state.kf_lm_idx[kf1] >= 0) & state.kf_kp_valid[kf1]
    has2 = (state.kf_lm_idx[kf2] >= 0) & state.kf_kp_valid[kf2]
    d = matching.distance_matrix_mxu(matching.unpack_desc_bits(state.kf_desc[kf1]),
                                        matching.unpack_desc_bits(state.kf_desc[kf2]),
                                        has1, has2)
    best, mutual = matching.mutual_best(d, MATCH_MAX_HAMMING)
    lm1 = state.kf_lm_idx[kf1]
    lm2 = state.kf_lm_idx[kf2][best]
    R1, t1 = state.kf_pose[kf1, :, :3], state.kf_pose[kf1, :, 3]
    R2, t2 = state.kf_pose[kf2, :, :3], state.kf_pose[kf2, :, 3]
    pts1 = state.lm_pos[torch.clamp(lm1, 0, L - 1)] @ R1.T + t1
    pts2 = state.lm_pos[torch.clamp(lm2, 0, L - 1)] @ R2.T + t2
    uv1 = state.kf_xy[kf1]
    uv2 = state.kf_xy[kf2][best]
    sig1 = torch.pow(1.2, state.kf_level[kf1].to(torch.float32)) ** 2
    sig2 = torch.pow(1.2, state.kf_level[kf2][best].to(torch.float32)) ** 2
    ok = mutual & has1 & (lm2 >= 0) & (pts1[:, 2] > 0) & (pts2[:, 2] > 0)
    return lm1, lm2, pts1, pts2, uv1, uv2, sig1, sig2, ok


def _validate_packed(camera, state: ms.MapState, kf_cur, kf_cand, key):
    """Match + RANSAC + refine, packed as [n_matches, ransac_inliers,
    refined_inliers, s, R (9), t (3)]."""
    _, _, pts1, pts2, uv1, uv2, sig1, sig2, ok = _match_landmark_pairs(
        camera, state, kf_cur, kf_cand)
    R, t, s, inl, cnt = sim3_solver.sim3_ransac(camera, pts1, pts2, uv1, uv2, sig1, sig2,
                                                ok, key)
    R2, t2, s2, _, cnt2 = sim3_solver.refine_sim3(camera, R, t, s, pts1, pts2, uv1, uv2, inl)
    head = torch.stack([torch.sum(ok), cnt, cnt2]).to(torch.float32)
    return torch.cat([head, s2.reshape(1), R2.reshape(-1), t2.reshape(-1)])


def _strong_pair_list(state: ms.MapState, cap: int):
    """``[cap, 2]`` strong covisibility pairs (weight >= 100, j >= i + 2:
    the pose graph's extra edges) in row-major order, compacted on the
    device so the host reads a few KB instead of the ``[K, K]`` matrix;
    rows of -1 are padding."""
    W = ms.covisibility_matrix(state)
    K = W.shape[0]
    ar = torch.arange(K, device=W.device)
    ok = ((W >= COVIS_STRONG) & state.kf_valid[:, None] & state.kf_valid[None, :]
          & (ar[None, :] >= ar[:, None] + 2))
    idx = nonzero_static(ok.reshape(-1), cap, -1)
    return torch.stack([torch.where(idx >= 0, idx // K, -1),
                        torch.where(idx >= 0, idx % K, -1)], dim=1)


def _pack_detect_arrays(cov, kf, scores, kf_valid):
    """The keyframe's covisibility row, its retrieval scores and keyframe
    validity as one ``[K, 3]`` array: one copy to the host."""
    return torch.stack([cov[kf].to(torch.float32), scores, kf_valid.to(torch.float32)], dim=1)


class LoopCloser:
    def __init__(self, camera, max_keyframes: int = 0, *,
                 min_continuity: int = MIN_CONTINUITY, min_inliers: int = MIN_INLIERS,
                 min_gap: int = MIN_GAP, device="cpu"):
        # max_keyframes is accepted as the JAX package accepts it: the
        # retrieval index is stateless over the MapState and needs no
        # capacity. The thresholds are read at every call.
        self.camera = camera
        self.device = torch.device(device)
        self.bow = BowIndex()
        self.min_continuity = min_continuity
        self.min_inliers = min_inliers
        self.min_gap = min_gap
        # (covisibility cluster as a frozenset, consecutive detections).
        self._continuity: list = []
        self.last_loop_kf = -999
        # (kf_cur, kf_cand, R_21, t_21, s_21): the loop edges of every
        # later pose graph.
        self.loop_edges: List[Tuple[int, int, np.ndarray, np.ndarray, float]] = []
        self.num_loops_closed = 0
        # Optional parallel.distributed_ba.LandmarkMesh: with more than one
        # shard the post-loop global BA runs landmark-sharded over it
        # (global_ba.run_global_ba's mesh route).
        self.mesh = None

    # ------------------------------------------------------------------
    def detect_dispatch(self, state: ms.MapState, kf: int, ind=None):
        """Start the detection of keyframe ``kf`` and its copy to the host;
        consume it with :meth:`detect_consume` (a keyframe later, in the
        System). None inside the cool-down after a loop closure."""
        if kf - self.last_loop_kf < self.min_gap:
            return None
        cov = ms.covisibility_matrix(state, ind)
        packed = _pack_detect_arrays(cov, kf, self.bow.scores_for_slot(state, kf),
                                     state.kf_valid)
        return HostCopy(packed), cov

    def detect_consume(self, packed, kf: int) -> Optional[int]:
        """The host half of detection on the ``[K, 3]`` copy: candidates
        score at least the weakest covisible neighbour (and 0.1), are not
        covisible and are ``min_gap`` keyframes old. A candidate continues
        a previous detection's cluster when their covisibility sets
        intersect (loop_detector.cc:102-127); a loop fires after
        ``min_continuity`` in a row. Returns the best-scoring matured
        candidate or None. Only the candidates' covisibility rows are read
        back from the device matrix."""
        copy, cov = packed
        packed = copy.numpy()
        K = packed.shape[0]
        W = packed[:, 0]
        sims = packed[:, 1]
        kf_valid = packed[:, 2] > 0.5
        covis = (W >= COVIS_NEIGHBOR) & kf_valid
        covis[kf] = True
        if covis.sum() > 1:
            min_score = float(sims[covis & (np.arange(K) != kf)].min())
        else:
            min_score = 0.2
        cand_mask = kf_valid & ~covis & (sims >= max(min_score, 0.1))
        cand_mask[max(0, kf - self.min_gap):] = False
        cands = np.where(cand_mask)[0].tolist()

        new_clusters, matured = [], []
        if cands:
            W_rows = cov[torch.as_tensor(cands, device=cov.device)].cpu().numpy()
        for row, c in enumerate(cands):
            cluster = frozenset(
                np.where((W_rows[row] >= COVIS_NEIGHBOR) & kf_valid)[0].tolist()) | {int(c)}
            prev = max((n for cl, n in self._continuity if cl & cluster), default=0)
            new_clusters.append((cluster, prev + 1))
            if prev + 1 >= self.min_continuity:
                matured.append(int(c))
        self._continuity = new_clusters
        if not matured:
            return None
        return int(max(matured, key=lambda c: sims[c]))

    def detect(self, state: ms.MapState, kf: int) -> Optional[int]:
        """Detection in one call (dispatch + consume)."""
        packed = self.detect_dispatch(state, kf)
        return None if packed is None else self.detect_consume(packed, kf)

    # ------------------------------------------------------------------
    def validate_dispatch(self, state: ms.MapState, kf_cur: int, kf_cand: int, key):
        """Start the whole Sim3 validation (matching, RANSAC, refinement)
        and its packed result's copy to the host."""
        return HostCopy(_validate_packed(self.camera, state, kf_cur, kf_cand, key))

    def validate_consume(self, packed):
        """Gate the packed validation result: (R_21, t_21, s_21) or None."""
        v = packed.numpy()
        if min(v[0], v[1], v[2]) < self.min_inliers:
            _log.info("loop validation rejected: %d matches, %d RANSAC inliers, %d refined",
                      v[0], v[1], v[2])
            return None
        return v[4:13].reshape(3, 3).astype(np.float32), v[13:16].astype(np.float32), float(v[3])

    def validate(self, state: ms.MapState, kf_cur: int, kf_cand: int, key):
        """Sim3 validation: (R_21, t_21, s_21) mapping points in kf_cur's
        camera frame into kf_cand's, or None."""
        return self.validate_consume(self.validate_dispatch(state, kf_cur, kf_cand, key))

    # ------------------------------------------------------------------
    # Host pieces of the System's deferred loop fix: numpy on arrays
    # copied earlier, so no phase waits for the device.
    # ------------------------------------------------------------------
    def correct_host_poses(self, old_pose_h, kf_valid_h, covis_rows_h, kf_cur: int,
                           kf_cand: int, R21, t21, s21, neigh_extend=()):
        """The neighbourhood Sim3 correction in numpy: the current
        keyframe's covisibles (not the candidate's, and not the candidate)
        move rigidly with it to S_cur_corr = S_21^-1 ∘ S_cand.
        ``neigh_extend``: keyframes inserted while the fix was in flight,
        forced into the neighbourhood. Returns (R_new [K, 3, 3], t_new
        [K, 3], s_new [K], neigh [K] bool)."""
        K = old_pose_h.shape[0]

        def s_inv(R, t, s):
            Rt = np.swapaxes(R, -1, -2)
            return Rt, -(1.0 / s)[..., None] * np.einsum("...ij,...j->...i", Rt, t), 1.0 / s

        def s_mul(Ra, ta, sa, Rb, tb, sb):
            return Ra @ Rb, sa[..., None] * np.einsum("...ij,...j->...i", Ra, tb) + ta, sa * sb

        Ri, ti, si = s_inv(np.asarray(R21, np.float32), np.asarray(t21, np.float32),
                           np.float32(s21))
        Rc, tc = old_pose_h[kf_cand, :, :3], old_pose_h[kf_cand, :, 3]
        R_cur_c = Ri @ Rc
        t_cur_c = si * (Ri @ tc) + ti
        s_cur_c = np.float32(si)

        neigh = (covis_rows_h[0] >= COVIS_NEIGHBOR) & kf_valid_h
        neigh &= ~((covis_rows_h[1] >= COVIS_NEIGHBOR) | (np.arange(K) == kf_cand))
        neigh[kf_cur] = True
        for e in neigh_extend:
            if 0 <= e < K:
                neigh[e] = True

        R_old, t_old = old_pose_h[:, :, :3], old_pose_h[:, :, 3]
        s_old = np.ones((K,), np.float32)
        Rcui, tcui, scui = s_inv(old_pose_h[kf_cur, :, :3], old_pose_h[kf_cur, :, 3],
                                 np.float32(1.0))
        R_rel, t_rel, s_rel = s_mul(
            R_old, t_old, s_old, np.broadcast_to(Rcui, (K, 3, 3)),
            np.broadcast_to(tcui, (K, 3)), np.broadcast_to(scui, (K,)))
        R_corr, t_corr, s_corr = s_mul(
            R_rel, t_rel, s_rel, np.broadcast_to(R_cur_c, (K, 3, 3)),
            np.broadcast_to(t_cur_c, (K, 3)),
            np.broadcast_to(np.asarray(s_cur_c, np.float32), (K,)))
        R_new = np.where(neigh[:, None, None], R_corr, R_old)
        t_new = np.where(neigh[:, None], t_corr, t_old)
        s_new = np.where(neigh, s_corr, s_old).astype(np.float32)
        return R_new.astype(np.float32), t_new.astype(np.float32), s_new, neigh

    def build_graph_problem(self, pose_h, kf_valid_h, pairs_h, anchor_kf: int):
        """The pose-graph problem from host arrays: the sequential chain of
        valid keyframes, the strong covisibility pairs ``pairs_h`` (-1 rows
        are padding) and the accumulated loop edges (weight 10). Edges are
        padded to a power-of-two count, as the JAX package does. Returns
        (problem on the device, valid keyframe ids), or (None, ids) below
        3 keyframes."""
        K = pose_h.shape[0]
        valid_ids = np.where(kf_valid_h)[0]
        if len(valid_ids) < 3:
            return None, valid_ids
        live_pairs = pairs_h[pairs_h[:, 0] >= 0]
        if len(pairs_h) and pairs_h[-1, 0] >= 0:
            _log.warning("strong-pair list full (%d): some covisibility edges dropped "
                         "from the pose graph", len(pairs_h))
        ei = np.concatenate([valid_ids[:-1], live_pairs[:, 0]]).astype(np.int64)
        ej = np.concatenate([valid_ids[1:], live_pairs[:, 1]]).astype(np.int64)
        # Measured S_ji: the pose of i in j's frame from the current estimates.
        Ri_, ti_ = pose_h[ei, :, :3], pose_h[ei, :, 3]
        Rj_, tj_ = pose_h[ej, :, :3], pose_h[ej, :, 3]
        R_m = np.einsum("eab,ecb->eac", Rj_, Ri_)
        t_m = tj_ - np.einsum("eab,eb->ea", R_m, ti_)
        s_m = np.ones(len(ei), np.float32)
        w_m = np.ones(len(ei), np.float32)
        live = [e for e in self.loop_edges if kf_valid_h[e[0]] and kf_valid_h[e[1]]]
        if live:
            ei = np.concatenate([ei, [e[0] for e in live]])
            ej = np.concatenate([ej, [e[1] for e in live]])
            R_m = np.concatenate([R_m, np.stack([e[2] for e in live])])
            t_m = np.concatenate([t_m, np.stack([e[3] for e in live])])
            s_m = np.concatenate([s_m, [e[4] for e in live]])
            w_m = np.concatenate([w_m, np.full(len(live), LOOP_EDGE_WEIGHT, np.float32)])
        E = len(ei)
        E_pad = 1 << max(8, (E - 1).bit_length())
        pad = E_pad - E
        dev = self.device

        def T(a, dtype=torch.float32):
            return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype, device=dev)

        prob = pg.PoseGraphProblem(
            R=T(pose_h[:, :, :3]), t=T(pose_h[:, :, 3]),
            s=torch.ones((K,), dtype=torch.float32, device=dev),
            fixed=torch.arange(K, device=dev) == anchor_kf, valid=T(kf_valid_h, torch.bool),
            edge_i=T(np.concatenate([ei, np.zeros(pad, np.int64)]), torch.int64),
            edge_j=T(np.concatenate([ej, np.zeros(pad, np.int64)]), torch.int64),
            edge_R=T(np.concatenate([R_m, np.tile(np.eye(3, dtype=np.float32), (pad, 1, 1))])),
            edge_t=T(np.concatenate([t_m, np.zeros((pad, 3), np.float32)])),
            edge_s=T(np.concatenate([s_m, np.ones(pad, np.float32)])),
            edge_valid=torch.arange(E_pad, device=dev) < E,
            edge_weight=T(np.concatenate([w_m, np.zeros(pad, np.float32)])),
        )
        return prob, valid_ids

    def solve_graph(self, prob, valid_ids, K: int):
        """The pose-graph solve: dense up to ``DENSE_GRAPH_MAX_K``
        keyframes, matrix-free PCG beyond. Returns device (R, t, s)."""
        if K > DENSE_GRAPH_MAX_K:
            E_pad = prob.edge_i.shape[0]
            raw_of_comp = np.full(K, -1, np.int64)
            raw_of_comp[:len(valid_ids)] = valid_ids
            n_chain = len(valid_ids) - 1
            edge_chain_pos = np.full(E_pad, -1, np.int64)
            edge_chain_pos[:n_chain] = np.arange(n_chain)
            R, t, s, _ = pg.optimize_pose_graph_pcg(
                prob, torch.from_numpy(raw_of_comp).to(self.device),
                torch.from_numpy(edge_chain_pos).to(self.device))
        else:
            R, t, s, _ = pg.optimize_pose_graph(prob)
        return R, t, s

    # ------------------------------------------------------------------
    def correct(self, state: ms.MapState, kf_cur: int, kf_cand: int, R21, t21, s21,
                inv_sigma_sq_table, *, run_global_ba: bool = True):
        """Propagate a validated loop and optimize the pose graph, in one
        call. ``run_global_ba=False`` stops after the pose graph (the
        System runs global BA in chunks over later frames instead).
        Returns the corrected MapState."""
        K = state.kf_pose.shape[0]
        dev = state.kf_pose.device
        old_pose = state.kf_pose
        f32 = dict(dtype=torch.float32, device=dev)
        Ri, ti, si = lie.sim3_inverse(torch.as_tensor(R21, **f32), torch.as_tensor(t21, **f32),
                                      torch.as_tensor(s21, **f32))
        one = torch.ones((), **f32)
        R_cur_c, t_cur_c, s_cur_c = lie.sim3_compose(
            Ri, ti, si, old_pose[kf_cand, :, :3], old_pose[kf_cand, :, 3], one)
        # The current keyframe's covisibles move rigidly with it; the
        # candidate and its covisibles are the loop's fixed side.
        Wm = ms.covisibility_matrix(state)[[kf_cur, kf_cand]]
        ar = torch.arange(K, device=dev)
        neigh = (Wm[0] >= COVIS_NEIGHBOR) & state.kf_valid
        neigh &= ~((Wm[1] >= COVIS_NEIGHBOR) | (ar == kf_cand))
        neigh[kf_cur] = True
        R_old, t_old = old_pose[:, :, :3], old_pose[:, :, 3]
        s_old = torch.ones((K,), **f32)
        Rcui, tcui, scui = lie.sim3_inverse(old_pose[kf_cur, :, :3], old_pose[kf_cur, :, 3], one)
        R_rel, t_rel, s_rel = lie.sim3_compose(R_old, t_old, s_old, Rcui.expand(K, 3, 3),
                                               tcui.expand(K, 3), scui.expand(K))
        R_corr, t_corr, s_corr = lie.sim3_compose(R_rel, t_rel, s_rel, R_cur_c.expand(K, 3, 3),
                                                  t_cur_c.expand(K, 3), s_cur_c.expand(K))
        R_new = torch.where(neigh[:, None, None], R_corr, R_old)
        t_new = torch.where(neigh[:, None], t_corr, t_old)
        s_new = torch.where(neigh, s_corr, s_old)
        state = pg.correct_map_structures(
            state, R_old, t_old, s_old, R_new, t_new, s_new,
            lm_mask=neigh[torch.clamp(state.lm_ref_kf, 0, K - 1)] & state.lm_valid,
            ln_mask=neigh[torch.clamp(state.ln_ref_kf, 0, K - 1)] & state.ln_valid,
            pl_mask=neigh[torch.clamp(state.pl_ref_kf, 0, K - 1)] & state.pl_valid,
        )
        state = state._replace(kf_pose=lie.pack_pose(
            R_new, t_new / torch.clamp(s_new, min=1e-12)[:, None]))
        # Fuse the duplicated landmarks around the current keyframe
        # (global_optimization_module.cc:257-260).
        cand_mask = torch.zeros((K,), dtype=torch.bool, device=dev)
        cand_mask[kf_cand] = True
        state, _ = mapper.fuse_into_keyframe(self.camera, state, kf_cur,
                                             ms.local_landmark_mask(state, cand_mask))
        self.loop_edges.append((kf_cur, kf_cand, np.array(R21), np.array(t21), float(s21)))
        state = self._optimize_graph(state, kf_cand)
        self.last_loop_kf = kf_cur
        self._continuity.clear()
        self.num_loops_closed += 1
        if run_global_ba:
            pose_before = state.kf_pose
            state = global_ba.run_global_ba(self.camera, state, inv_sigma_sq_table,
                                            anchor_kf=kf_cand, mesh=self.mesh)
            # Points moved with the BA; lines and planes ride their
            # reference keyframes' pose deltas (loop_bundle_adjuster.cc:110-145).
            ones = torch.ones((K,), **f32)
            state = pg.correct_map_structures(
                state, pose_before[:, :, :3], pose_before[:, :, 3], ones,
                state.kf_pose[:, :, :3], state.kf_pose[:, :, 3], ones,
                lm_mask=torch.zeros_like(state.lm_valid))
        return state

    def _optimize_graph(self, state: ms.MapState, anchor_kf: int):
        """The Sim3 pose graph (chain + strong covisibility + loop edges)
        on the map; landmarks, lines and planes follow their reference
        keyframes' corrections (graph_optimizer.cc)."""
        K = state.kf_pose.shape[0]
        pairs = _strong_pair_list(state, cap=K * K).cpu().numpy()
        prob, valid_ids = self.build_graph_problem(
            state.kf_pose.cpu().numpy(), state.kf_valid.cpu().numpy(), pairs, anchor_kf)
        if prob is None:
            return state
        R_opt, t_opt, s_opt = self.solve_graph(prob, valid_ids, K)
        state = pg.correct_map_structures(state, prob.R, prob.t, prob.s, R_opt, t_opt, s_opt)
        return state._replace(kf_pose=lie.pack_pose(
            R_opt, t_opt / torch.clamp(s_opt, min=1e-12)[:, None]))
