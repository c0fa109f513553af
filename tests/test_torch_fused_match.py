"""Port parity: the fused matcher's plain version against the Pallas kernel.

``fused_match_plain`` (the port) must EQUAL ``fused_match_reference`` and
``fused_match(..., interpret=True)`` of the JAX package on every row —
best, second-best and argmin — since all three compute exact integer
Hamming distances. The JAX side takes the ±1 bit planes and 128-lane meta
blocks (padded to its 512-row tiles for the interpreted kernel); the port
takes the same u32 words as int32 and plain [L, 4] / [N, 3] meta. The
kernel-vs-plain case needs a CUDA card and skips without one.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from structure_plp_slam_tpu.ops import matching, pallas_matching as pm
from structure_plp_slam_tpu_torch.ops import fused_match as tfm
from structure_plp_slam_tpu_torch.ops import matching as tmatching

torch.set_num_threads(2)


def _setup(rng, L, N, kind="random"):
    """The tests/test_pallas_matching.py generator pattern, as numpy."""
    desc_lm = rng.integers(0, 2**32, (L, 8), dtype=np.uint32)
    desc_kp = rng.integers(0, 2**32, (N, 8), dtype=np.uint32)
    for i in range(0, N, 3):  # near-duplicates so real matches exist
        d = desc_lm[(i * 7) % L].copy()
        d[0] ^= 0x3
        desc_kp[i] = d
    lm_meta = np.stack([
        rng.uniform(0, 600, L), rng.uniform(0, 600, L),
        np.where(rng.uniform(size=L) < 0.9, rng.uniform(50, 400, L), -1.0),
        rng.integers(0, 4, L),
    ], -1).astype(np.float32)
    kp_meta = np.stack([
        rng.uniform(0, 600, N), rng.uniform(0, 600, N),
        np.where(rng.uniform(size=N) < 0.95, rng.integers(0, 4, N), 1e9),
    ], -1).astype(np.float32)
    if kind == "masked":
        lm_meta[:, 2] = -1.0
    elif kind == "ties":
        # Few distinct descriptors, every keypoint in every window: equal
        # distances everywhere, so argmin must pick the lowest index and
        # second must equal best.
        desc_kp = desc_kp[rng.integers(0, 4, N)]
        kp_meta[:, :2] = 300.0
        kp_meta[:, 2] = 1.0
        lm_meta[:, 2:] = (1000.0, 1.0)
    return desc_lm, lm_meta, desc_kp, kp_meta


def _jax_args(desc_lm, lm_meta, desc_kp, kp_meta, pad=False):
    if pad:  # the interpreted kernel tiles rows and keypoints by 512
        L, N = len(desc_lm), len(desc_kp)
        Lp, Np = -(-L // pm.TILE_L) * pm.TILE_L, -(-N // pm.TILE_N) * pm.TILE_N
        desc_lm = np.pad(desc_lm, ((0, Lp - L), (0, 0)))
        lm_meta = np.pad(lm_meta, ((0, Lp - L), (0, 0)), constant_values=-1.0)
        desc_kp = np.pad(desc_kp, ((0, Np - N), (0, 0)))
        kp_meta = np.pad(kp_meta, ((0, Np - N), (0, 0)), constant_values=1e9)
    return (
        matching.unpack_desc_bits(jnp.asarray(desc_lm)),
        pm.pack_meta_lm(jnp.asarray(lm_meta[:, :2]), jnp.asarray(lm_meta[:, 2]),
                        jnp.asarray(lm_meta[:, 3])),
        matching.unpack_desc_bits(jnp.asarray(desc_kp)),
        pm.pack_meta_kp(jnp.asarray(kp_meta[:, :2]), jnp.asarray(kp_meta[:, 2])),
    )


def _torch_args(desc_lm, lm_meta, desc_kp, kp_meta, device="cpu"):
    return tuple(
        torch.from_numpy(np.ascontiguousarray(a)).to(device)
        for a in (desc_lm.view(np.int32), lm_meta, desc_kp.view(np.int32), kp_meta)
    )


def _assert_equal(port, ref, L, what):
    # Exact: integer distances, deterministic argmin rule.
    for name, p, r in zip(("best", "second", "idx"), port, ref):
        np.testing.assert_array_equal(np.asarray(p)[:L], np.asarray(r)[:L],
                                      err_msg=f"{name} vs {what}")


CASES = [
    ("random", 1024, 512),
    ("masked", 512, 512),
    ("ties", 512, 300),
    ("random", 1000, 700),   # ragged: not multiples of 512
    ("random", 37, 5),
]


@pytest.mark.parametrize("kind,L,N", CASES)
def test_plain_equals_reference(kind, L, N):
    inputs = _setup(np.random.default_rng(L + N), L, N, kind)
    port = [t.numpy() for t in tfm.fused_match_plain(*_torch_args(*inputs))]
    ref = pm.fused_match_reference(*_jax_args(*inputs))
    _assert_equal(port, ref, L, "fused_match_reference")
    if kind == "masked":
        assert (port[0] == 1024).all() and (port[1] == 1024).all() and (port[2] == 0).all()
    if kind == "ties":
        assert (port[1] == port[0]).all()
    if kind == "random" and L >= 512:
        assert (port[0] < 1024).sum() > 50  # real matches exist


@pytest.mark.parametrize("kind,L,N", CASES[:4])
def test_plain_equals_interpreted_kernel(kind, L, N):
    inputs = _setup(np.random.default_rng(L + N), L, N, kind)
    port = [t.numpy() for t in tfm.fused_match_plain(*_torch_args(*inputs))]
    ref = pm.fused_match(*_jax_args(*inputs, pad=True), interpret=True)
    _assert_equal(port, ref, L, "fused_match(interpret=True)")


def _projection_inputs(rng, L=700, N=520, num_levels=4):
    """Tracker-like inputs: predicted projections and levels per landmark,
    keypoints of which every third sits near a landmark's prediction with
    a near-duplicate descriptor."""
    desc_lm, _, desc_kp, _ = _setup(rng, L, N)
    uv = rng.uniform(0, 600, (L, 2)).astype(np.float32)
    pred_level = rng.integers(0, num_levels, L).astype(np.int32)
    kp_xy = rng.uniform(0, 600, (N, 2)).astype(np.float32)
    kp_level = rng.integers(0, num_levels, N).astype(np.int32)
    for i in range(0, N, 3):
        j = (i * 7) % L
        kp_xy[i] = uv[j] + rng.uniform(-20, 20, 2)
        kp_level[i] = np.clip(pred_level[j] + rng.integers(-1, 3), 0, num_levels - 1)
    lm_valid = rng.uniform(size=L) < 0.8
    kp_valid = rng.uniform(size=N) < 0.95
    radius_by_level = (15.0 * 1.2 ** np.arange(num_levels)).astype(np.float32)
    return desc_lm, uv, pred_level, lm_valid, desc_kp, kp_xy, kp_level, kp_valid, radius_by_level


@pytest.mark.parametrize("level_window,ratio,max_h", [(1, None, 100), (1, 0.85, 100),
                                                      (8, None, 50)])
def test_fused_path_equals_cpu_branch(level_window, ratio, max_h):
    """The JAX package's CPU branch (match_by_projection, level_window 1 in
    the tracker, 8 in fuse) and the port's route through the fused matcher
    (radius -1 for an invalid row, level 1e9 for an invalid keypoint,
    levels zeroed for fuse) give the same matches and distances."""
    (desc_lm, uv, pred_level, lm_valid, desc_kp, kp_xy, kp_level, kp_valid,
     radius_by_level) = _projection_inputs(np.random.default_rng(11 + level_window))
    j_idx, j_best = matching.match_by_projection(
        jnp.asarray(uv), jnp.asarray(pred_level),
        matching.unpack_desc_bits(jnp.asarray(desc_lm)), jnp.asarray(lm_valid),
        jnp.asarray(kp_xy), jnp.asarray(kp_level),
        matching.unpack_desc_bits(jnp.asarray(desc_kp)), jnp.asarray(kp_valid),
        radius_by_level=jnp.asarray(radius_by_level), max_hamming=max_h, ratio=ratio,
        level_window=level_window,
    )
    no_level_gate = level_window >= len(radius_by_level)
    lm_lvl = np.zeros_like(pred_level) if no_level_gate else pred_level
    kp_lvl = np.where(kp_valid, 0 if no_level_gate else kp_level, 1e9)
    lm_meta = np.stack([uv[:, 0], uv[:, 1], np.where(lm_valid, radius_by_level[pred_level], -1.0),
                        lm_lvl], -1).astype(np.float32)
    kp_meta = np.stack([kp_xy[:, 0], kp_xy[:, 1], kp_lvl], -1).astype(np.float32)
    best, second, idx = tfm.fused_match(*_torch_args(desc_lm, lm_meta, desc_kp, kp_meta))
    ok = best <= max_h
    if ratio is not None:
        ok = ok & (best <= ratio * second)
    t_idx = torch.where(ok, idx, -1).numpy()
    # Exact: the same integer distances under the same masks and tie rule.
    np.testing.assert_array_equal(t_idx, np.asarray(j_idx))
    np.testing.assert_array_equal(best.numpy(), np.asarray(j_best).astype(np.float32))
    assert (best <= max_h).sum() > 50  # real matches exist (before any ratio test)


def test_match_by_projection_matches_jax():
    (desc_lm, uv, pred_level, lm_valid, desc_kp, kp_xy, kp_level, kp_valid,
     radius_by_level) = _projection_inputs(np.random.default_rng(5))
    kw = dict(radius_by_level=radius_by_level, max_hamming=100, ratio=0.85, level_window=1)
    j_idx, j_best = matching.match_by_projection(
        jnp.asarray(uv), jnp.asarray(pred_level),
        matching.unpack_desc_bits(jnp.asarray(desc_lm)), jnp.asarray(lm_valid),
        jnp.asarray(kp_xy), jnp.asarray(kp_level),
        matching.unpack_desc_bits(jnp.asarray(desc_kp)), jnp.asarray(kp_valid),
        **{**kw, "radius_by_level": jnp.asarray(radius_by_level)},
    )
    t = torch.from_numpy
    t_idx, t_best = tmatching.match_by_projection(
        t(uv), t(pred_level).long(), tmatching.unpack_desc_bits(t(desc_lm.view(np.int32))),
        t(lm_valid), t(kp_xy), t(kp_level).long(),
        tmatching.unpack_desc_bits(t(desc_kp.view(np.int32))), t(kp_valid),
        **{**kw, "radius_by_level": t(radius_by_level)},
    )
    np.testing.assert_array_equal(t_idx.numpy(), np.asarray(j_idx))  # exact
    np.testing.assert_array_equal(t_best.numpy(), np.asarray(j_best))


def test_cpu_wrapper_takes_plain_version():
    args = _torch_args(*_setup(np.random.default_rng(3), 64, 32))
    before = tfm.fused_match.launches
    out = tfm.fused_match(*args)
    for a, b in zip(out, tfm.fused_match_plain(*args)):
        assert torch.equal(a, b)
    assert tfm.fused_match.launches == before  # no kernel launch on the CPU


@pytest.mark.cuda
@pytest.mark.parametrize("kind,L,N", CASES + [("random", 32768, 1032)])
def test_kernel_equals_plain_on_card(kind, L, N):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    args = _torch_args(*_setup(np.random.default_rng(L + N), L, N, kind), device="cuda")
    out = tfm.fused_match(*args)
    torch.cuda.synchronize()
    for a, b in zip(out, tfm.fused_match_plain(*args)):
        assert torch.equal(a, b)  # exact
