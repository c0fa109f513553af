"""The keyframe chain of a System with 8 keyframes on the CPU against
XLA:CPU's (ROADMAP C18).

A System with ``max_keyframes`` 8, as most tier-1 System tests build, runs
its chain's local BA over a window of C = 16 cameras (8 optimized, 8 fixed):
D = 6C = 96 camera entries, M = 4096 landmark slots. XLA:CPU's dot sums that
Schur product ``[96, 12288] x [12288, 96]`` in blocks of 1024 entries, each
in two interleaved lanes (``ops/ba_cpu._SCHUR_BLOCKS``), and its
back-substitution and step norms have their own layout
(``_UPDATE_LAYOUT[96]``); the mono, RGB-D and stereo chains compile into the
same kernels (``python -m tests.xla_chain_ba --dump DIR --setup rgbd
--width 320 --max-keyframes 8``). Held here on the first chain with a local
BA of the 320x240 RGB-D System with 8 keyframes
(``tests/xla_chain_ba.chain_call(320, setup="rgbd", max_keyframes=8)``),
from the JAX System's own pre-chain state:

* the port's ``_kf_chain`` gives the JAX chain's output bit for bit: every
  map field, the next landmark slot and the observation indicator;
* every Gauss-Newton iteration of the chain's BA equals
  ``tests/xla_init_ba.ba_trace``;
* the D = 96 Schur layout gives XLA's dot on random rows at M = 4096 and at
  the growth maps' M = 2048;
* the other entries the tier-1 Systems reach (``xla_chain_ba.TIER1_SHAPES``
  and ``TIER1_GRID_SHAPES``) are what the probes of XLA's dots measure;
* a synthetic 16-camera window of 70% stereo and 30% monocular rows, with
  landmarks seen two and three times by one keyframe, equals the JAX solve
  in every iteration and in its result, and so does a monocular one over
  2048 landmark slots.
"""

from __future__ import annotations

import functools

import numpy as np
import pytest
import torch

from structure_plp_slam_tpu_torch.data import map_state as tms
from structure_plp_slam_tpu_torch.models import bundle_adjustment as tba
from structure_plp_slam_tpu_torch.models import mapper as tmapper
from structure_plp_slam_tpu_torch.ops import ba_cpu
from tests import xla_chain_ba as xc
from tests import xla_init_ba as xo

torch.set_num_threads(2)


@functools.lru_cache(maxsize=1)
def _call():
    """The JAX RGB-D System's first chain with a local BA at 8 keyframes and
    the port's camera."""
    call = xc.chain_call(320, setup="rgbd", max_keyframes=8)
    return call, xc.port_camera(call["camera"])


@functools.lru_cache(maxsize=1)
def _trace():
    """The chain's BA window (the port's extraction) and its JAX trace."""
    call, tcam = _call()
    prob = xc.chain_window(call, tcam)
    return prob, xo.ba_trace(call["camera"], xc.jax_problem(prob))


def _solve_equals_trace(tcam, prob, final, steps):
    assert xc.iterations_apart(tcam, prob, steps) is None
    res = tba.ba_solve(tcam, prob, obs_grid=True, num_iters=8, cull_at_iters=(4,), _xla="chain")
    for g, w in zip(res, final):
        assert np.array_equal(g.numpy(), w)


def test_rgbd_chain_equals_jax():
    call, tcam = _call()
    want = xc.map_fields(call["out"][0])
    with ba_cpu.unmeasured_shapes() as met:
        got, next_lm, ind = xc.port_chain(call, tcam)
    assert not met, met
    apart = sorted(f for f, v in want.items() if not np.array_equal(got[f], v.astype(got[f].dtype)))
    assert not apart, apart
    assert next_lm == int(call["out"][1])
    assert np.array_equal(ind, call["out"][4])
    before = xc.map_fields(call["args"][0])
    # The chain moved the window's poses and points and refreshed statistics.
    assert not np.array_equal(got["kf_pose"], before["kf_pose"])
    assert not np.array_equal(got["lm_dist_max"], before["lm_dist_max"])


def test_rgbd_chain_iterations_equal_jax():
    call, tcam = _call()
    prob, (final, steps) = _trace()
    assert prob.cam_pose.shape[0] == 16 and prob.lm_pos.shape[0] == 4096
    assert int(((prob.obs_xr >= 0) & prob.obs_valid).sum()) > 500
    # The traced solve ends where the JAX chain does: the free window
    # cameras' poses in the chain's output.
    free = ((~prob.cam_fixed) & prob.cam_valid).numpy()
    assert free.sum() >= 2
    _, _, ba_cams = tmapper.local_ba(tcam, tms.from_numpy(xc.map_fields(call["ba_in"]), "cpu"),
                                     int(call["args"][1]), xc.to_torch(call["args"][12]),
                                     ind=xc.to_torch(call["out"][4]), return_cams=True)
    for c in np.flatnonzero(free):
        assert np.array_equal(final[0][c], call["out"][0]["kf_pose"][int(ba_cams[c])])
    _solve_equals_trace(tcam, prob, final, steps)


@pytest.mark.parametrize("K", [12288, 6144])
@pytest.mark.parametrize("seed", xo.SEEDS)
def test_schur_layout_matches_xla(K, seed):
    """The D = 96 Schur product in blocks of 1024, two lanes each, gives
    XLA's dot at M = 4096 and 2048; one lane would not."""
    assert ba_cpu._SCHUR_BLOCKS[(96, K)] == (1024, 2)
    WH, W = xo.random_rows(K // 3, 16, seed)
    want = xo.xla_schur(WH, W)
    assert np.array_equal(xo.port_schur(WH, W), want)
    saved = ba_cpu._SCHUR_BLOCKS[(96, K)]
    ba_cpu._SCHUR_BLOCKS[(96, K)] = (1024, 1)
    try:
        assert not np.array_equal(xo.port_schur(WH, W), want)
    finally:
        ba_cpu._SCHUR_BLOCKS[(96, K)] = saved


@pytest.mark.parametrize("shape", xc.TIER1_SHAPES)
def test_tier1_schur_probe(shape):
    assert xo.probe_schur_block(*shape) == ba_cpu._SCHUR_BLOCKS[shape]


@pytest.mark.parametrize("shape", xc.TIER1_GRID_SHAPES)
def test_tier1_grid_probe(shape):
    assert xc.probe_grid_block(*shape) == ba_cpu._GRID_BLOCKS[shape]


def test_mixed_window_equals_jax():
    """A 16-camera window at the chain's shape (616 slots a row) with 70% of
    the observations stereo rows, the rest monocular, landmarks seen two and
    three times by one keyframe, every free camera stepping
    (``xla_chain_ba.synthetic_problem``)."""
    call, tcam = _call()
    arrays = xc.synthetic_problem(16, seed=2, Ng=616, width=320,
                                  focal_x_baseline=tcam.focal_x_baseline, stereo_share=0.7)
    prob = tba.BAProblem(**{k: torch.from_numpy(v) for k, v in arrays.items()})
    rows = prob.obs_valid & (prob.obs_xr >= 0)
    assert 0.6 < float(rows.sum()) / float(prob.obs_valid.sum()) < 0.75
    final, steps = xo.ba_trace(call["camera"], xc.jax_problem(prob))
    # Both kinds of row carry weight, and the cull drops some of each.
    live, rows, valid = steps["obs_live"][-1], rows.numpy(), prob.obs_valid.numpy()
    assert (live & rows).any() and (live & valid & ~rows).any()
    assert (valid & rows & ~live).any() and (valid & ~rows & ~live).any()
    _solve_equals_trace(tcam, prob, final, steps)


def test_growth_window_equals_jax():
    """A monocular 16-camera window over 2048 landmark slots, as a growth
    map's chain starts (640 slots a row): the M = 2048 Schur and grid
    entries."""
    jcam = xc.setup_camera("mono", 320, "jax")
    tcam = xc.port_camera(jcam)
    arrays = xc.synthetic_problem(16, seed=3, M=2048, n_lm=1800, width=320)
    prob = tba.BAProblem(**{k: torch.from_numpy(v) for k, v in arrays.items()})
    final, steps = xo.ba_trace(jcam, xc.jax_problem(prob))
    _solve_equals_trace(tcam, prob, final, steps)
