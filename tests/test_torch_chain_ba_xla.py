"""The keyframe chain on the CPU against XLA:CPU's (ROADMAP C18).

The JAX System runs each keyframe's mapping chain as one jitted
``_kf_chain``; its local BA has C = 32 window cameras and M = 4096 landmark
slots. The port's System passes ``_xla="chain"`` from its monocular chain,
and on the CPU ``ba_solve`` then computes each iteration with
``ops/ba_cpu`` (``csrc/ba_solve_cpu.c``) as XLA:CPU compiles it; the
chain's triangulation and landmark statistics take XLA's dots and sums
through ``ops/linalg``. Held here on the first chain after a 320x240
monocular init (``tests/xla_chain_ba.chain_call``: numpy seed 42, 16
keyframes, 4096 landmarks, the window's 32 cameras and 4096 slots), from the
JAX System's own pre-chain state:

* the port's ``_kf_chain`` gives the JAX chain's output bit for bit: every
  map field (poses, points, associations, statistics), the next landmark
  slot and the observation indicator;
* every Gauss-Newton iteration of the chain's BA, each on the port's own
  previous iterate, equals ``tests/xla_init_ba.ba_trace`` (the same solve
  with each iteration's values as outputs, whose end equals the JAX
  chain's);
* synthetic windows of 8 and 32 cameras with every camera observing and
  landmarks seen two and three times by one keyframe: every iteration and
  the solve's result equal the JAX solve's (the back-substitution's
  accumulators, the camera step's norms, the grid contraction's runs, the
  final orthonormalization);
* the Schur product's new block entry and the grid contraction's runs
  against XLA's dots;
* the PyTorch iteration (the card's) on the same chain stays within 1e-4 m
  on poses and 1e-3 m on points of the JAX chain;
* stereo rows are refused by the C iteration, and the System's RGB-D
  chain takes the PyTorch iteration;
* shapes outside the tables warn once.
"""

from __future__ import annotations

import dataclasses
import functools
import logging

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from structure_plp_slam_tpu.models import bundle_adjustment as jba
from structure_plp_slam_tpu_torch import system as tsys
from structure_plp_slam_tpu_torch.camera import Camera, CameraModel, CameraSetup
from structure_plp_slam_tpu_torch.data import map_state as tms
from structure_plp_slam_tpu_torch.models import bundle_adjustment as tba
from structure_plp_slam_tpu_torch.models import mapper as tmapper
from structure_plp_slam_tpu_torch.ops import ba_cpu, linalg, robust
from tests import xla_chain_ba as xc
from tests import xla_init_ba as xo

torch.set_num_threads(2)

OBS_FIELDS = ("pc", "r_uv", "chi2", "w", "Jc2", "Jl2", "Hcc_o", "Hll_o", "Hcl_o", "bc_o",
              "bl_o", "Hll", "WHinv", "Hcc", "bc", "S_red")
STEP_FIELDS = (*OBS_FIELDS, "S", "rhs", "Hll_inv", "W", "bl", "dx_l", "cam_pose", "lm_pos",
               "obs_live")


def _t(x):
    """A torch tensor of a JAX-side numpy array (u32 as int32 bits, int32
    widened)."""
    a = np.array(x)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    if a.dtype == np.int32:
        a = a.astype(np.int64)
    return torch.from_numpy(a)


def _fields(state: dict) -> dict:
    return {f: (v.view(np.int32) if v.dtype == np.uint32 else v) for f, v in state.items()}


@functools.lru_cache(maxsize=1)
def _call():
    """The JAX System's first chain and the port's camera."""
    call = xc.chain_call(320)
    jcam = call["camera"]
    tcam = Camera(setup=CameraSetup(jcam.setup.value), model=CameraModel(jcam.model.value),
                  **{f.name: getattr(jcam, f.name) for f in dataclasses.fields(Camera)
                     if f.name not in ("setup", "model")})
    return call, tcam


def _port_chain():
    """The port's ``_kf_chain`` on the JAX chain's arguments: ``(state, next
    landmark slot, indicator)``."""
    call, tcam = _call()
    a, kw = call["args"], call["kw"]
    feats = {k: _t(v) for k, v in a[4].items()}
    st, next_lm, _, _, ind, _, _ = tsys._kf_chain(
        tcam, tms.from_numpy(_fields(a[0]), "cpu"), int(a[1]), _t(a[2]), float(a[3]), feats,
        _t(a[5]), int(a[6]), _t(a[12]), _t(a[13]), None, do_ba=kw["do_ba"],
        do_cull_kf=kw["do_cull_kf"], stats_full=kw["stats_full"], do_detect=False,
        num_tri_neighbors=kw["num_tri_neighbors"], scale_factor=kw["scale_factor"],
        num_levels=kw["num_levels"], timer=tsys.StageTimer(device="cpu"))
    return tms.to_numpy(st), int(next_lm), ind.numpy()


@functools.lru_cache(maxsize=1)
def _window():
    """The chain's BA window as the port extracts it from the state the JAX
    BA starts from (gathers, equal to the JAX package's), and the same as a
    JAX ``BAProblem``."""
    call, tcam = _call()
    a = call["args"]
    seen = []
    solve = tba.ba_solve

    def record(camera, prob, *args, **k):
        seen.append(prob)
        return solve(camera, prob, *args, **k)

    tmapper.ba.ba_solve = record
    try:
        tmapper.local_ba(tcam, tms.from_numpy(_fields(call["ba_in"]), "cpu"), int(a[1]),
                         _t(a[12]), ind=_t(call["out"][4]))
    finally:
        tmapper.ba.ba_solve = solve
    prob = seen[0]
    return prob, _jax_problem(prob)


def _jax_problem(prob):
    return jba.BAProblem(**{f: jnp.asarray(v.numpy().astype(np.int32) if v.dtype == torch.int64
                                           else v.numpy()) for f, v in prob._asdict().items()})


def _iterations_apart(tcam, prob, steps):
    """Run the C iteration from the window's start, each step on its own
    previous iterate, and return the first iteration's fields that differ
    from the JAX trace's ``steps`` (empty when every iteration is equal)."""
    policy = tba._ba_policy(1e-4)
    free = (~prob.cam_fixed) & prob.cam_valid
    cam_pose, lm_pos = prob.cam_pose, prob.lm_pos
    live = prob.obs_valid & prob.cam_valid[prob.obs_cam] & prob.lm_valid[prob.obs_lm]
    for it in range(8):
        (S, rhs, Hinv, W, bl), st = ba_cpu.normal_equations(
            tcam, prob, cam_pose, lm_pos, live, free, policy=policy, trace=True)
        got = dict(st, S=S, rhs=rhs, Hll_inv=Hinv, W=W, bl=bl)
        dx_c = linalg.cho_solve(linalg.cho_factor(S), rhs)
        cam_pose, lm_pos, got["dx_l"] = ba_cpu.update(
            tcam, dx_c, Hinv, W, bl, cam_pose, lm_pos, free, prob.lm_valid, policy=policy,
            trace=True)
        if it == 4:
            chi2 = ba_cpu.obs_chi2(tcam, prob, cam_pose, lm_pos, policy=policy)
            live = live & (chi2 <= robust.CHI2_2D)
        got.update(cam_pose=cam_pose, lm_pos=lm_pos, obs_live=live)
        apart = [k for k in STEP_FIELDS if not np.array_equal(got[k].numpy(), steps[k][it])]
        if apart:
            return it, apart
    return None


def test_chain_equals_jax():
    call, _ = _call()
    want, want_next_lm, want_ind = call["out"][0], int(call["out"][1]), call["out"][4]
    got, next_lm, ind = _port_chain()
    assert len(want) == 38
    apart = sorted(f for f, v in _fields(want).items()
                   if not np.array_equal(got[f], v.astype(got[f].dtype)))
    assert not apart, apart
    assert next_lm == want_next_lm
    assert np.array_equal(ind, want_ind)
    before = _fields(call["args"][0])
    # The chain moved the window's poses and points and refreshed statistics.
    assert not np.array_equal(got["kf_pose"][1], before["kf_pose"][1])
    assert not np.array_equal(got["lm_dist_max"], before["lm_dist_max"])


def test_chain_iterations_equal_jax():
    call, tcam = _call()
    prob, jprob = _window()
    assert prob.cam_pose.shape[0] == 32 and prob.lm_pos.shape[0] == 4096
    final, steps = xo.ba_trace(call["camera"], jprob)
    # The traced solve ends where the JAX chain does: the free window
    # cameras' poses in the chain's output.
    free = ((~prob.cam_fixed) & prob.cam_valid).numpy()
    assert free.sum() >= 2
    _, _, ba_cams = tmapper.local_ba(tcam, tms.from_numpy(_fields(call["ba_in"]), "cpu"),
                                     int(call["args"][1]), _t(call["args"][12]),
                                     ind=_t(call["out"][4]), return_cams=True)
    for c in np.flatnonzero(free):
        assert np.array_equal(final[0][c], call["out"][0]["kf_pose"][int(ba_cams[c])])
    assert _iterations_apart(tcam, prob, steps) is None
    res = tba.ba_solve(tcam, prob, obs_grid=True, num_iters=8, cull_at_iters=(4,), _xla="chain")
    for g, w in zip(res, final):
        assert np.array_equal(g.numpy(), w)


@pytest.mark.parametrize("C", [8, 32])
def test_synthetic_window_equals_jax(C):
    """Windows where every camera observes, some landmarks two and three
    times in one keyframe's row, every free camera stepping
    (``xla_chain_ba.synthetic_problem``): the update's layout of both
    window sizes (``ba_cpu._UPDATE_LAYOUT``), the grid contraction's runs."""
    _, tcam = _call()
    jcam = _call()[0]["camera"]
    arrays = xc.synthetic_problem(C, seed=1)
    prob = tba.BAProblem(**{k: torch.from_numpy(v) for k, v in arrays.items()})
    final, steps = xo.ba_trace(jcam, _jax_problem(prob))
    assert _iterations_apart(tcam, prob, steps) is None
    res = tba.ba_solve(tcam, prob, obs_grid=True, num_iters=8, cull_at_iters=(4,), _xla="chain")
    for g, w in zip(res, final):
        assert np.array_equal(g.numpy(), w)


@pytest.mark.parametrize("seed", xo.SEEDS)
def test_schur_block_table(seed):
    for D, K in xc.SHAPES:
        WH, W = xo.random_rows(K // 3, D // 6, seed)
        assert np.array_equal(xo.port_schur(WH, W), xo.xla_schur(WH, W)), (D, K)


def test_grid_block_table():
    for shape in xc.GRID_SHAPES:
        assert ba_cpu._GRID_BLOCKS[shape] == xc.probe_grid_block(*shape), shape


def test_card_body_within_tolerance(monkeypatch):
    """The same chain with the C route off, so its BA runs the PyTorch
    iteration the card runs: poses within 1e-4, points within 1e-3 m of
    the JAX chain, the detached observations equal on >= 99% of slots."""
    call, _ = _call()
    monkeypatch.setattr(ba_cpu, "serves", lambda *a: False)
    got, _, _ = _port_chain()
    want = _fields(call["out"][0])
    np.testing.assert_allclose(got["kf_pose"], want["kf_pose"], rtol=0, atol=1e-4)
    np.testing.assert_allclose(got["lm_pos"], want["lm_pos"], rtol=0, atol=1e-3)
    assert (got["kf_lm_idx"] == want["kf_lm_idx"]).mean() >= 0.99


def test_stereo_rows_refused():
    """The C iteration computes the monocular compile only: stereo rows
    raise, under either program name; an unknown program name raises."""
    _, tcam = _call()
    prob, _ = _window()
    stereo = prob._replace(obs_xr=torch.where(prob.obs_valid, 100.0, -1.0))
    for program in ba_cpu.PROGRAMS:
        with pytest.raises(ValueError, match="monocular"):
            tba.ba_solve(tcam, stereo, obs_grid=True, num_iters=1, _xla=program)
    with pytest.raises(ValueError, match="_xla"):
        tba.ba_solve(tcam, prob, obs_grid=True, num_iters=1, _xla="loop")


def test_rgbd_chain_takes_torch_body(monkeypatch):
    """The System's RGB-D chain passes no program to ``local_ba`` and runs
    the PyTorch iteration: the C source is never called."""
    from structure_plp_slam_tpu_torch.config import Config
    from structure_plp_slam_tpu_torch.ops.orb import OrbParams
    from structure_plp_slam_tpu_torch.testing import synthetic_scene

    cam = Camera(setup=CameraSetup.RGBD, model=CameraModel.PERSPECTIVE,
                 **dict(xc.WIDTHS[320]["cam"], focal_x_baseline=40.0))
    frames, _ = synthetic_scene.make_sequence(np.random.default_rng(7), cam, 6, step=0.08)
    calls = []
    local_ba = tmapper.local_ba

    def record(*a, **k):
        calls.append(k.get("_xla"))
        return local_ba(*a, **k)

    def refuse(*a, **k):
        raise AssertionError("the RGB-D chain reached the XLA:CPU iteration")

    monkeypatch.setattr(tmapper, "local_ba", record)
    monkeypatch.setattr(ba_cpu, "normal_equations", refuse)
    slam = tsys.System(Config(camera=cam, orb=OrbParams(max_num_keypts=600, num_levels=4),
                              raw={}), device="cpu", max_keyframes=8, max_landmarks=4096,
                       enable_loop_closing=False, max_kf_interval=1)
    slam.startup()
    for img, depth, ts in frames:
        slam.feed_RGBD_frame(img, depth, ts)
    slam.shutdown()
    assert calls and all(c is None for c in calls), calls


def test_unmeasured_shapes_warn_once(caplog):
    """Outside ``_UPDATE_LAYOUT`` and ``_GRID_BLOCKS`` the C source sums in
    order (one accumulator, fused norms, one run) and logs one warning per
    shape."""
    ba_cpu._UNMEASURED.discard(60)
    ba_cpu._UNMEASURED.discard((10, 64, 512))
    with caplog.at_level(logging.WARNING, logger=ba_cpu.__name__):
        assert ba_cpu.update_layout(60) == (1, None, 0)
        assert ba_cpu.update_layout(60) == (1, None, 0)
        assert ba_cpu.grid_block(10, 64, 512) == 64
        assert ba_cpu.grid_block(10, 64, 512) == 64
    msgs = [r.getMessage() for r in caplog.records if "no measured XLA:CPU" in r.getMessage()]
    assert len(msgs) == 2, msgs
    assert "6C = 60" in msgs[0] and "[10, 64, 512]" in msgs[1]
    assert ba_cpu.update_layout(192) == (4, None, 24) and ba_cpu.grid_block(32, 640, 4096) == 320
