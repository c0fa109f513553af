"""Relocalization from tracking loss.

Port of structure_plp_slam_tpu/models/relocalizer.py (reference
module/relocalizer.cc: BoW candidates -> descriptor matching >= 20 ->
PnP RANSAC >= 15 inliers -> projection-match top-up with pose
optimization -> accept at >= 50 inliers). Candidates come from the
match-count retrieval of ``data/bow.py``.

The JAX package ``vmap``s the top ``max_candidates`` candidates through
one dispatch; the port runs them in turn, each through
``tracker.track_frame`` (so each candidate makes the fused matcher's
three calls), with no host read in between. The first (best-scored)
candidate that passes every gate wins, and the result is ONE packed
vector read back once per lost frame.
"""

from __future__ import annotations

import numpy as np
import torch

from structure_plp_slam_tpu_torch.data import bow as bow_mod
from structure_plp_slam_tpu_torch.data import map_state as ms
from structure_plp_slam_tpu_torch.models import tracker
from structure_plp_slam_tpu_torch.ops import matching, pnp
from structure_plp_slam_tpu_torch.utils import prng
from structure_plp_slam_tpu_torch.utils.types import topk_stable

def _match_frame_to_keyframe(state: ms.MapState, kf, feats):
    """Mutual-best descriptor matches of the frame's keypoints against a
    keyframe's landmark observations. Returns (landmark id per frame
    keypoint [N] (-1 none), count)."""
    kf_lm = state.kf_lm_idx[kf]
    has_kf = (kf_lm >= 0) & state.kf_kp_valid[kf]
    d = matching.distance_matrix_mxu(
        matching.unpack_desc_bits(feats["desc"]),
        matching.unpack_desc_bits(state.kf_desc[kf]), feats["valid"], has_kf,
    )
    best, ok = matching.mutual_best(d, 50)
    lm = torch.where(ok, kf_lm[best], -1)
    return lm, torch.sum(lm >= 0)


def _relocalize_batch(camera, state: ms.MapState, feats, inv_sigma_sq_table, key,
                      obs_indicator, min_matches, min_pnp, min_inliers, *, num_levels,
                      scale_factor, max_candidates, bow_max_hamming, bow_chunk):
    """The whole relocalization ladder for the top ``max_candidates``
    retrieval candidates. Packed result (f32): [ok, kf, num_tracked,
    R(9), t(3), kp_lm(N)] (kp_lm ids are exact in f32 up to 2^24)."""
    L = state.lm_pos.shape[0]
    sims = bow_mod._scores_impl(state.kf_desc, state.kf_kp_valid, state.kf_valid,
                                feats["desc"], feats["valid"], max_hamming=bow_max_hamming,
                                chunk=bow_chunk)
    sims = torch.where(state.kf_valid, sims, torch.full_like(sims, -1.0))
    top_sims, cands = topk_stable(sims, max_candidates)  # best first, lower slot on ties
    keys = prng.split(key, max_candidates)
    info = inv_sigma_sq_table[torch.clamp(feats["level"], 0, inv_sigma_sq_table.shape[0] - 1)]

    oks, results = [], []
    for c in range(max_candidates):
        kf = cands[c]
        lm, n = _match_frame_to_keyframe(state, kf, feats)
        pts = state.lm_pos[torch.clamp(lm, 0, L - 1)]
        R, t, inl, cnt = pnp.pnp_ransac(camera, pts, feats["xy"], info,
                                        (lm >= 0) & feats["valid"], keys[c])
        res = tracker.track_frame(
            camera, state, feats, R, t, torch.where(inl, lm, -1), kf, inv_sigma_sq_table,
            obs_indicator, 3, num_levels=num_levels, scale_factor=scale_factor,
        )
        oks.append((top_sims[c] > 0.05) & (n >= min_matches) & (cnt >= min_pnp)
                   & (res.num_tracked >= min_inliers))
        results.append(res)
    ok = torch.stack(oks)
    prio = torch.where(ok, torch.arange(max_candidates, device=ok.device), max_candidates)
    sel = torch.argmin(prio)
    f32 = torch.float32
    return torch.cat([
        torch.stack([torch.any(ok).to(f32), cands[sel].to(f32),
                     torch.stack([r.num_tracked for r in results])[sel].to(f32)]),
        torch.stack([r.R for r in results])[sel].reshape(-1),
        torch.stack([r.t for r in results])[sel].reshape(-1),
        torch.stack([r.kp_lm for r in results])[sel].to(f32),
    ])


class Relocalizer:
    def __init__(self, camera, bow: bow_mod.BowIndex, *, min_candidates_matches: int = 20,
                 min_pnp_inliers: int = 15, min_inliers: int = 50):
        """The reference ladder's thresholds (relocalizer.{h,cc}): >= 20
        descriptor matches to try a candidate, >= 15 PnP inliers to try the
        top-up, >= 50 inliers after it to accept. Each is read at every
        call (``min_matches``, ``min_pnp_inliers``, ``min_inliers``)."""
        self.camera = camera
        self.bow = bow
        self.min_matches = min_candidates_matches
        self.min_pnp_inliers = min_pnp_inliers
        self.min_inliers = min_inliers

    def relocalize(self, state: ms.MapState, feats, inv_sigma_sq_table, key,
                   max_candidates: int = 3, *, obs_indicator=None, num_levels: int = 8,
                   scale_factor: float = 1.2):
        """Try to recover the camera pose from the best ``max_candidates``
        retrieval candidates. Returns (R, t, kp_lm, ref_kf) or None; one
        host read of the packed result."""
        if obs_indicator is None:
            obs_indicator = ms.observation_indicator(state)
        packed = _relocalize_batch(
            self.camera, state, feats, inv_sigma_sq_table, key, obs_indicator,
            self.min_matches, self.min_pnp_inliers, self.min_inliers,
            num_levels=num_levels, scale_factor=scale_factor, max_candidates=max_candidates,
            bow_max_hamming=self.bow.max_hamming, bow_chunk=self.bow.chunk,
        )
        vals = packed.cpu().numpy()
        if vals[0] < 0.5:
            return None
        dev = state.device
        R = torch.from_numpy(vals[3:12].reshape(3, 3).copy()).to(dev)
        t = torch.from_numpy(vals[12:15].copy()).to(dev)
        kp_lm = torch.from_numpy(vals[15:].astype(np.int64)).to(dev)
        return R, t, kp_lm, int(vals[1])
