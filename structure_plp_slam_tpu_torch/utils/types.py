"""Dtype policy, sentinels and small tensor helpers.

Port of structure_plp_slam_tpu/utils/types.py. Policy:

* Geometry runs in float32.
* Descriptors are 256-bit rBRIEF stored as ``int32 [*, 8]`` — the BIT
  PATTERNS of the JAX package's ``uint32`` words (torch's uint32 supports
  few ops). Code compares and shifts bits (``>> k & 1``), never signed
  values.
* Invalid slots in padded tensors are marked by boolean masks.

It also holds the helpers that stand in for JAX idioms with no direct
torch counterpart: a static-size ``nonzero``, a stable top-k and a
scatter-set with a fixed rule for duplicate indices, a sum whose order on
the CPU does not follow torch's thread count, and a segment sum whose
order on the card is fixed.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

# Sentinel index for "no landmark / no match" in index tensors.
INVALID = -1

# A large-but-finite distance used to mask out candidates in min-reductions.
BIG = 1e30
# Max Hamming distance for 256-bit descriptors + 1; used as masked value.
HAMMING_MASKED = 1024


# Rows per block of ``fixed_order_sum``.
SUM_BLOCK = 256


def fixed_order_sum(fn, *xs, dim: int = 0):
    """``fn(*xs)``, summed in one order at any torch thread count. ``fn``
    sums over axis ``dim`` of every one of ``xs`` (all of one length n
    there) and maps a new leading axis through (a ``...`` einsum, say).
    On the CPU the n entries are cut into two or more blocks of at most
    SUM_BLOCK (the last padded with zeros), ``fn`` runs on all blocks at
    once with the blocks as a leading batch axis, and the block results
    are added in order. torch's CPU reduction to one value splits its sum
    across threads past 32768 elements, and MKL's product splits a long
    contraction whose output is small, so the last bits of either follow
    the thread count; a batched product runs each block's product on one
    thread, and a reduction to many values splits only across them. On
    another device this is ``fn(*xs)``: the ops stay as they were."""
    n = xs[0].shape[dim]
    if xs[0].device.type != "cpu" or n < 2:
        return fn(*xs)
    nb = max(2, -(-n // SUM_BLOCK))
    rows = -(-n // nb)
    pad = nb * rows - n

    def blocks(x):
        if pad:
            x = torch.cat([x, x.new_zeros(x.shape[:dim] + (pad,) + x.shape[dim + 1 :])], dim)
        return x.reshape(x.shape[:dim] + (nb, rows) + x.shape[dim + 1 :]).movedim(dim, 0)

    parts = fn(*(blocks(x) for x in xs))
    out = parts[0]
    for part in parts[1:]:
        out = out + part
    return out


def _index_add_route(t) -> bool:
    """Whether ``segment_sum`` adds with ``index_add_`` for tensors on
    ``t``'s device: on the CPU, whose ``index_add_`` adds each bin's rows
    in row order."""
    return t.device.type == "cpu"


class SegmentPlan(NamedTuple):
    """How ``segment_sum`` visits the rows of one index set on the card,
    built once (``segment_plan``) and reused while the ids stay the same:
    either the rows sorted by bin (``perm``; bin b's rows are ``perm[
    offsets[b]:offsets[b + 1]]``, in row order) or, with ``grid`` > 0, a
    promise that the ids are ``arange(n)`` each repeated ``grid`` times."""

    perm: torch.Tensor = None     # [O] i64
    offsets: torch.Tensor = None  # [n + 1] i64
    grid: int = 0


def segment_plan(ids, n: int, *, keep=None, grid: bool = False):
    """The plan of ``segment_sum(ids, ..., n)`` on the card; ``None`` on the
    CPU, where ``index_add_`` needs none. ``keep`` ([O] bool): rows that
    may add something; the others must add zero (a dead row's zero weight),
    and the plan leaves them out, so that padding piled into one bin costs
    nothing. ``grid``: the ids are ``arange(n)`` each repeated O / n times
    in order (a [n, O / n] layout), summed by a reshape. Adds no host
    sync: the sizes are the tensors' own."""
    if _index_add_route(ids):
        return None
    if grid:
        return SegmentPlan(grid=ids.shape[0] // n)
    key = ids if keep is None else torch.where(keep, ids, n)
    key, perm = torch.sort(key, stable=True)
    return SegmentPlan(perm, torch.searchsorted(key, torch.arange(n + 1, device=ids.device)))


def segment_sum(ids, vals, n: int, *, plan: SegmentPlan = None, base=None):
    """Sum the rows of ``vals [O, ...]`` into ``n`` bins by ``ids [O]`` (in
    ``[0, n)``), onto ``base [n, ...]`` when given, else onto zeros.

    On the CPU this is ``index_add_``, which adds each bin's rows in row
    order onto its start. On the card each bin's rows are summed in one
    fixed order, the same on every run: with ``plan`` from
    ``segment_plan`` (built here when not given), the rows are gathered in
    bin order and ``torch.segment_reduce`` adds each bin's rows one after
    another in row order, starting from zero; a ``grid`` plan sums the
    [n, O / n] layout with ``torch.sum``. ``base`` is then added to the
    sums. ``index_add_`` on the card would add in whatever order its
    atomics land."""
    if _index_add_route(vals):
        out = vals.new_zeros((n,) + tuple(vals.shape[1:])) if base is None else base.clone()
        return out.index_add_(0, ids, vals)
    plan = segment_plan(ids, n) if plan is None else plan
    tail = tuple(vals.shape[1:])
    if plan.grid:
        out = vals.reshape((n, plan.grid) + tail).sum(1)
    else:
        # 2-D rows: segment_reduce then runs one thread per bin and column,
        # adding that bin's rows in order.
        rows = vals.reshape(vals.shape[0], math.prod(tail))[plan.perm]
        out = torch.segment_reduce(rows, "sum", offsets=plan.offsets, axis=0,
                                   unsafe=True).reshape((n,) + tail)
    return out if base is None else base + out


def round_up(x: int, m: int) -> int:
    """Round ``x`` up to a multiple of ``m`` (static Python int)."""
    return ((x + m - 1) // m) * m


def pad_to(arr: np.ndarray, size: int, axis: int = 0, fill=0) -> np.ndarray:
    """Pad a host array with ``fill`` along ``axis`` to length ``size``."""
    n = arr.shape[axis]
    if n > size:
        raise ValueError(f"cannot pad axis of length {n} down to {size}")
    if n == size:
        return arr
    widths = [(0, 0)] * arr.ndim
    widths[axis] = (0, size - n)
    return np.pad(arr, widths, constant_values=fill)


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller asks for
    another. Raises when CUDA is asked for (or defaulted to) without a
    card — nothing falls back to the CPU silently."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device available; pass device='cpu' to run on the CPU"
        )
    return dev


def rdiv(scalar: float, t):
    """``scalar / t`` as ONE correctly rounded division. torch computes a
    Python-scalar numerator as ``reciprocal(t) * scalar`` (two roundings);
    the JAX package divides."""
    return torch.full_like(t, scalar) / t


def masked_argmin(values, mask, axis: int = -1):
    """Argmin along ``axis`` over ``values`` where ``mask`` is True.
    Returns ``(indices, min_values)``; rows without a valid entry give
    ``BIG``."""
    v = torch.where(mask, values, torch.full_like(values, BIG))
    return torch.argmin(v, dim=axis), torch.amin(v, dim=axis)


def topk_stable(values, k: int, dim: int = -1):
    """Largest ``k`` along ``dim``, lower index first on ties — the order
    ``lax.top_k`` guarantees and ``torch.topk`` does not."""
    vals, idx = torch.sort(values, dim=dim, descending=True, stable=True)
    return vals.narrow(dim, 0, k), idx.narrow(dim, 0, k)


def masked_topk_smallest(values, mask, k: int):
    """Top-k *smallest* values along the last axis under a mask.
    Returns ``(values, indices)``; invalid slots surface as ``BIG``."""
    v = torch.where(mask, values, torch.full_like(values, BIG))
    neg, idx = topk_stable(-v, k)
    return -neg, idx


def safe_norm(x, axis=-1, eps=1e-12, keepdims=False):
    """L2 norm along ``axis`` clamped below by sqrt(eps)."""
    sq = torch.sum(x * x, dim=axis, keepdim=keepdims)
    return torch.sqrt(torch.clamp(sq, min=eps))


def normalize(x, axis=-1, eps=1e-12):
    """Unit-normalize along ``axis`` with safe division."""
    return x / safe_norm(x, axis=axis, eps=eps, keepdims=True)


def nanmedian_mean(z, ok):
    """Median of ``z`` over ``ok``, averaging the two middle values of an
    even count as ``jnp.nanmedian`` does (``torch.nanmedian`` returns the
    lower one). NaN when nothing is ok."""
    n = torch.sum(ok)
    s, _ = torch.sort(torch.where(ok, z, torch.full_like(z, float("inf"))))
    # Gathers, not 0-d tensor indices (which wait for the card).
    lohi = s.gather(0, torch.stack([torch.clamp((n - 1) // 2, min=0),
                                    torch.clamp(n // 2, min=0)]))
    med = lohi[0] * 0.5 + lohi[1] * 0.5
    return torch.where(n > 0, med, torch.full_like(med, float("nan")))


def nonzero_static(mask, size: int, fill_value: int):
    """``jnp.nonzero(mask, size=size, fill_value=fill)[0]`` for a 1-D mask:
    the first ``size`` True positions in order, padded with ``fill``."""
    idx = torch.nonzero(mask, as_tuple=False).reshape(-1)[:size]
    out = torch.full((size,), fill_value, dtype=torch.int64, device=mask.device)
    out[: idx.shape[0]] = idx
    return out


def to_host(x) -> np.ndarray:
    """``x`` as a numpy array on the host: a tensor on any device is copied
    off it (``np.asarray`` of a CUDA tensor raises), anything else goes
    through ``np.asarray``."""
    if torch.is_tensor(x):
        return x.detach().cpu().numpy()
    return np.asarray(x)


class HostCopy:
    """A tensor's copy on the host, started without waiting: on the card a
    pinned buffer filled by a non-blocking copy and a CUDA event that marks
    it (the role of the JAX package's ``copy_to_host_async``); a CPU tensor
    is its own copy."""

    def __init__(self, t):
        self.event = None
        if t.is_cuda:
            host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            host.copy_(t, non_blocking=True)
            self.event = torch.cuda.Event()
            self.event.record()
            t = host
        self.host = t

    def ready(self) -> bool:
        """Whether the copy has landed (never waits)."""
        return self.event is None or self.event.query()

    def numpy(self):
        """The copy as a numpy array (waits for it on the card)."""
        if self.event is not None:
            self.event.synchronize()
        return self.host.detach().numpy()


def scatter_set(target, idx, vals, valid):
    """``target[idx[i]] = vals[i]`` for every ``i`` with ``valid[i]``
    (returns a new tensor; rows of ``target`` are along dim 0).

    Where several valid rows name the same index, the LAST row wins: the
    order XLA's serial CPU scatter leaves for ``.at[].set``, made explicit
    so the result is the same on every device (torch's ``index_put_``
    leaves duplicates unspecified)."""
    n = target.shape[0]
    pos = torch.arange(idx.shape[0], device=idx.device)
    safe = torch.where(valid, idx, torch.full_like(idx, n))
    winner = torch.full((n + 1,), -1, dtype=pos.dtype, device=idx.device)
    winner.scatter_reduce_(0, safe, torch.where(valid, pos, -1), "amax")
    wins = valid & (winner[safe] == pos)
    out = target.clone()
    out[idx[wins]] = vals[wins].to(target.dtype)
    return out
