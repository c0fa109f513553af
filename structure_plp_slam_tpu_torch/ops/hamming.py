"""Batched Hamming distance over 256-bit binary descriptors.

Port of structure_plp_slam_tpu/ops/hamming.py. Descriptors are
``int32 [*, 8]`` bit patterns; popcount widens each word to int64 first
(SWAR on the unsigned value, no sign-bit or overflow hazards).
"""

from __future__ import annotations

import torch

from structure_plp_slam_tpu_torch.utils.types import HAMMING_MASKED

_MASK32 = 0xFFFFFFFF


def popcount_u32(x):
    """Per-element popcount of int32 bit patterns (returns int64)."""
    x = x.to(torch.int64) & _MASK32
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & _MASK32) >> 24


def hamming_distance(desc_a, desc_b):
    """Elementwise Hamming distance between matching rows ``[..., 8]``."""
    return torch.sum(popcount_u32(torch.bitwise_xor(desc_a, desc_b)), dim=-1)


def distance_matrix(desc_a, desc_b, valid_a=None, valid_b=None):
    """All-pairs Hamming distances ``[N, M]`` (int64); invalid rows/cols
    are ``HAMMING_MASKED``."""
    d = hamming_distance(desc_a[:, None, :], desc_b[None, :, :])
    if valid_a is not None:
        d = torch.where(valid_a[:, None], d, HAMMING_MASKED)
    if valid_b is not None:
        d = torch.where(valid_b[None, :], d, HAMMING_MASKED)
    return d


def mutual_best_matches(dist, max_dist: int, ratio: float | None = None):
    """Mutual nearest neighbours of a masked distance matrix ``[N, M]``,
    with Lowe's ratio test against the second best in the row when
    ``ratio`` is given. Returns each row's match ``[N]`` (int64, -1 for
    none); ties go to the lowest index, as ``jnp.argmin``'s."""
    best_b = torch.argmin(dist, dim=1)
    best_ab = torch.gather(dist, 1, best_b[:, None])[:, 0]
    best_a = torch.argmin(dist, dim=0)
    ok = (best_ab <= max_dist) & (best_a[best_b] == torch.arange(dist.shape[0],
                                                                  device=dist.device))
    if ratio is not None:
        second = torch.min(dist.scatter(1, best_b[:, None], HAMMING_MASKED), dim=1).values
        ok = ok & (best_ab.to(torch.float32) <= ratio * second.to(torch.float32))
    return torch.where(ok, best_b, -1)
