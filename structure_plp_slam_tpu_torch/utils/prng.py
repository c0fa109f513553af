"""Counter-based random draws, bit-equal to the JAX package's.

The JAX package draws its RANSAC samples with ``jax.random`` (threefry2x32
keys, ``jax_threefry_partitionable=True``, the default of JAX 0.9). The
port holds a key exactly as the JAX System does and reproduces every draw
the slice uses, so both packages sample the same minimal sets:

* ``PRNGKey(seed)``: the key words ``(seed >> 32, seed & 0xFFFFFFFF)`` of
  a 32-bit seed, i.e. ``(0, seed)``;
* ``split(key, n)``: threefry of the counters ``(0, i)``, i < n; the two
  output words are the new key;
* ``random_bits(key, shape)``: threefry of ``(0, i)`` over the flat
  row-major index, the two words XOR-ed;
* ``uniform``: ``bits >> 9 | 0x3F800000`` read as f32, minus 1;
* ``choice_weighted``: ``jax.random.choice(..., replace=True, p=p)``,
  i.e. ``cumsum(p)``, ``r = total * (1 - uniform)``, ``searchsorted``.

Words are held in int64 tensors masked to 32 bits (torch's uint32 has few
ops). The cumulative sum follows XLA:CPU's order for a 1-D ``cumsum``
(blocks of 16 summed left to right, the block totals scanned the same way
recursively): a different order moves a draw that sits within an ulp of a
bucket edge. ``ops/orb.py``'s moment maps scan 2-D images the same way
along either axis.
"""

from __future__ import annotations

import torch

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_SCAN_BLOCK = 16  # XLA's reduce-window rewriter base length


def _rotl(x, r: int):
    return ((x << r) | (x >> (32 - r))) & _MASK


def threefry2x32(k1, k2, x1, x2):
    """The Threefry-2x32 hash (20 rounds) of counter words ``x1, x2`` under
    key words ``k1, k2``; all int64 tensors holding u32 values."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x = [(x1 + ks[0]) & _MASK, (x2 + ks[1]) & _MASK]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x[0] = (x[0] + x[1]) & _MASK
            x[1] = _rotl(x[1], r) ^ x[0]
        x[0] = (x[0] + ks[(i + 1) % 3]) & _MASK
        x[1] = (x[1] + ks[(i + 2) % 3] + i + 1) & _MASK
    return x[0], x[1]


def PRNGKey(seed: int, device="cpu"):
    """``jax.random.PRNGKey(seed)`` for a 32-bit seed: int64 ``[2]``."""
    if not -(2**31) <= int(seed) < 2**31:
        raise ValueError(f"seed {seed} is not a 32-bit integer")
    return torch.tensor([0, int(seed) & _MASK], dtype=torch.int64, device=device)


def _counters(n: int, device):
    lo = torch.arange(n, dtype=torch.int64, device=device)
    return torch.zeros_like(lo), lo


def split(key, num: int = 2):
    """``jax.random.split(key, num)``: ``[num, 2]`` new keys."""
    hi, lo = _counters(num, key.device)
    b1, b2 = threefry2x32(key[0], key[1], hi, lo)
    return torch.stack([b1, b2], dim=-1)


def random_bits(key, shape, device=None):
    """32 random bits per element (u32 values in int64)."""
    key = key.to(device) if device is not None else key
    n = 1
    for s in shape:
        n *= int(s)
    hi, lo = _counters(n, key.device)
    b1, b2 = threefry2x32(key[0], key[1], hi, lo)
    return (b1 ^ b2).reshape(tuple(shape))


def uniform(key, shape, device=None):
    """``jax.random.uniform(key, shape)`` in f32, values in [0, 1)."""
    bits = (random_bits(key, shape, device) >> 9) | 0x3F800000
    return bits.to(torch.int32).view(torch.float32) - 1.0


def cumsum_xla(x, dim: int = 0):
    """f32 cumulative sum along ``dim`` in XLA:CPU's order (see the module
    note): blocks of 16 summed left to right, the block totals scanned the
    same way recursively and added to every later block."""
    x = x.movedim(dim, 0)
    n = x.shape[0]
    B = _SCAN_BLOCK
    if n <= B:
        cols = [x[0]] if n else []
        for i in range(1, n):
            cols.append(cols[-1] + x[i])
        out = torch.stack(cols) if n else x.clone()
        return out.movedim(0, dim)
    m = -(-n // B)
    rest = x.shape[1:]
    blk = torch.cat([x, x.new_zeros((m * B - n,) + rest)]).reshape((m, B) + rest)
    cols = [blk[:, 0]]
    for i in range(1, B):
        cols.append(cols[-1] + blk[:, i])
    inb = torch.stack(cols, dim=1)
    tot = cumsum_xla(inb[:, -1].contiguous())
    out = torch.cat([inb[:1], inb[1:] + tot[:-1, None]])
    return out.reshape((m * B,) + rest)[:n].movedim(0, dim)


def choice_weighted(key, num_points: int, shape, p):
    """``jax.random.choice(key, num_points, shape, replace=True, p=p)``:
    int64 indices of ``shape`` drawn on ``p``'s device."""
    if p.shape != (num_points,):
        raise ValueError(f"p must have shape ({num_points},), got {tuple(p.shape)}")
    p_cuml = cumsum_xla(p.to(torch.float32))
    u = uniform(key, shape, device=p.device)
    r = p_cuml[-1] * (1.0 - u)
    return torch.searchsorted(p_cuml, r.reshape(-1)).reshape(tuple(shape))
