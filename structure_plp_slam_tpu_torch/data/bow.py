"""Place-recognition retrieval (loop and relocalization candidates).

Port of structure_plp_slam_tpu/data/bow.py, which replaces the reference's
DBoW2 vocabulary + inverted index (data/bow_database.{h,cc}) by direct
descriptor matching against every keyframe:

  score(query, kf) = (# query descriptors whose best Hamming distance in
                      kf is <= max_hamming) / (# valid query descriptors)

Stateless: the MapState's ``kf_desc`` / ``kf_kp_valid`` / ``kf_valid`` are
the index. Each chunk of keyframes is one exact f32 matmul of ±1 bit
planes (TF32 is off package-wide), unpacked per chunk, so the scores are
integer counts over a count, bit-equal to the JAX package's.
"""

from __future__ import annotations

import torch

from structure_plp_slam_tpu_torch.ops import matching


def _scores_impl(kf_desc, kf_kp_valid, kf_valid, q_desc, q_valid, *, max_hamming: int,
                 chunk: int = 8):
    """``[K]`` match-count scores of a query descriptor set against every
    stored keyframe (a query descriptor counts when its best distance is
    within ``max_hamming``); one matmul per ``chunk`` keyframes."""
    K, N, _ = kf_desc.shape
    q_bits = matching.unpack_desc_bits(q_desc)  # [Nq, 256]
    counts = []
    for k0 in range(0, K, chunk):
        blk_bits = matching.unpack_desc_bits(kf_desc[k0:k0 + chunk])  # [C, N, 256]
        C = blk_bits.shape[0]
        d = ((256.0 - q_bits @ blk_bits.reshape(C * N, 256).T) * 0.5).reshape(-1, C, N)
        ok = (kf_kp_valid[k0:k0 + chunk] & kf_valid[k0:k0 + chunk, None])[None]
        best = torch.amin(torch.where(ok, d, torch.full_like(d, 1024.0)), dim=-1)  # [Nq, C]
        counts.append(torch.sum((best <= max_hamming) & q_valid[:, None], dim=0))
    counts = torch.cat(counts).to(torch.float32)
    return counts / torch.clamp(torch.sum(q_valid), min=1).to(torch.float32)


class BowIndex:
    """Match-count retrieval over the MapState's keyframe descriptors.
    Construction takes only scoring knobs (``max_hamming``, read at every
    query, and the keyframes per matmul); queries take the state."""

    def __init__(self, max_hamming: int = 30, chunk: int = 8):
        self.max_hamming = max_hamming
        self.chunk = chunk

    def scores(self, state, query_desc_u32, query_valid):
        """``[K]`` scores of a query frame's descriptors (relocalization
        candidates, bow_database.cc:170)."""
        return _scores_impl(state.kf_desc, state.kf_kp_valid, state.kf_valid,
                            query_desc_u32, query_valid, max_hamming=self.max_hamming,
                            chunk=self.chunk)

    def scores_for_slot(self, state, slot):
        """``[K]`` scores of stored keyframe ``slot`` against every keyframe
        (loop candidates, bow_database.cc:97)."""
        return _scores_impl(state.kf_desc, state.kf_kp_valid, state.kf_valid,
                            state.kf_desc[slot], state.kf_kp_valid[slot],
                            max_hamming=self.max_hamming, chunk=self.chunk)
