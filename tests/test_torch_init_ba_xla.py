"""The two-view init's local BA on the CPU against XLA:CPU's (ROADMAP C18).

The JAX System runs its monocular init's two-view BA as one jitted
``mapper.local_ba`` (8 window cameras, 4096 landmark slots, 8 Gauss-Newton
iterations with a cull after the fifth). The port's System passes
``_xla="init"`` from that call site, and on the CPU ``ba_solve`` then computes
each iteration with ``ops/ba_cpu`` (``csrc/ba_solve_cpu.c``) as XLA:CPU
compiles it. Held here on test_torch_mono.py's 320x240 sequence (numpy seed
42), from the JAX System's own init input:

* the port's ``local_ba(_xla="init")`` gives the JAX System's output
  state bit for bit in every field;
* every Gauss-Newton iteration, each on the port's own previous iterate,
  equals the JAX solve (``tests/xla_init_ba.ba_trace``, the same solve with
  each iteration's values as outputs, whose end equals the JAX program's):
  the per-observation residuals, weights, Jacobians and blocks, the grid
  sums, Hll^-1, W Hll^-1, the Schur product, the camera system and its
  right-hand side, the landmark step, the poses, points and live
  observations after the cull;
* the Schur product's block table against XLA's dot on random rows;
* the PyTorch iteration (every other call, and the card) stays within the
  mapper tests' 1e-3 of the JAX package on the same input;
* the C source takes the damping, the chi2 gate and the step limits from
  ``models/bundle_adjustment`` (``_ba_policy``): changed there, both
  iterations follow;
* what the C source does not serve goes to the PyTorch iteration, and
  observations off its monocular grid are refused.
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
from structure_plp_slam_tpu_torch.camera import Camera, CameraModel, CameraSetup
from structure_plp_slam_tpu_torch.data import map_state as tms
from structure_plp_slam_tpu_torch.models import bundle_adjustment as tba
from structure_plp_slam_tpu_torch.models import mapper as tmapper
from structure_plp_slam_tpu_torch.ops import ba_cpu, linalg, robust
from tests import xla_init_ba as xo

torch.set_num_threads(2)

OBS_FIELDS = ("pc", "r_uv", "chi2", "w", "Jc2", "Jl2", "Hcc_o", "Hll_o", "Hcl_o", "bc_o",
              "bl_o", "Hll", "WHinv", "Hcc", "bc", "S_red")


def _host(a):
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype == np.uint32 else a


@functools.lru_cache(maxsize=1)
def _call():
    """The JAX init BA's camera, input state, arguments and output, and the
    port's camera and input state."""
    jcam, state, args, kw, out = xo.init_ba_call()
    tcam = Camera(setup=CameraSetup(jcam.setup.value), model=CameraModel(jcam.model.value),
                  **{f.name: getattr(jcam, f.name) for f in dataclasses.fields(Camera)
                     if f.name not in ("setup", "model")})
    tstate = tms.from_numpy({f: _host(v) for f, v in state.items()}, "cpu")
    return jcam, tcam, tstate, (int(args[0]), torch.from_numpy(np.array(args[1]))), kw, out


def _local_ba(**kw):
    _, tcam, tstate, args, call_kw, _ = _call()
    return tmapper.local_ba(tcam, tstate, *args, **call_kw, **kw)


@functools.lru_cache(maxsize=1)
def _problem():
    """The port's BA window of the init (its extraction is gathers, equal to
    the JAX package's), and the same as a JAX ``BAProblem``."""
    seen = []
    solve = tba.ba_solve

    def record(camera, prob, *a, **k):
        seen.append(prob)
        return solve(camera, prob, *a, **k)

    tmapper.ba.ba_solve = record
    try:
        _local_ba()
    finally:
        tmapper.ba.ba_solve = solve
    prob = seen[0]
    jprob = jba.BAProblem(**{f: jnp.asarray(v.numpy().astype(np.int32) if v.dtype == torch.int64
                                            else v.numpy()) for f, v in prob._asdict().items()})
    return prob, jprob


def test_init_local_ba_equals_jax():
    _, _, _, _, _, want = _call()
    state, chi2 = _local_ba(_xla="init")
    got = tms.to_numpy(state)
    assert len(want) == 38
    for f, v in want.items():
        v = _host(v)
        assert np.array_equal(got[f], v.astype(got[f].dtype)), f
    assert not np.array_equal(got["kf_pose"][1], _host(_call()[2].kf_pose.numpy())[1])


def test_iterations_equal_jax():
    jcam, tcam, _, _, _, out = _call()
    prob, jprob = _problem()
    final, steps = xo.ba_trace(jcam, jprob)
    # The traced copy ends where the JAX program does.
    real = jba.ba_solve(jcam, jprob, obs_grid=True, num_iters=8, cull_at_iters=(4,))
    for a, b in zip(final, real):
        assert np.array_equal(a, np.asarray(b))
    assert ba_cpu.serves(tcam, prob, None)
    ba_cpu.check(prob)
    policy = tba._ba_policy(1e-4)
    free = (~prob.cam_fixed) & prob.cam_valid
    cam_pose, lm_pos = prob.cam_pose, prob.lm_pos
    live = prob.obs_valid & prob.cam_valid[prob.obs_cam] & prob.lm_valid[prob.obs_lm]
    assert int(live.sum()) > 400
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
        apart = [k for k in (*OBS_FIELDS, "S", "rhs", "Hll_inv", "W", "bl", "dx_l", "cam_pose",
                             "lm_pos", "obs_live")
                 if not np.array_equal(got[k].numpy(), steps[k][it])]
        assert not apart, (it, apart)
    res = tba.ba_solve(tcam, prob, obs_grid=True, num_iters=8, cull_at_iters=(4,),
                       _xla="init")
    for g, w in zip(res, final):
        assert np.array_equal(g.numpy(), w)


@pytest.mark.parametrize("seed", xo.SEEDS)
def test_schur_block_table(seed):
    for (D, K), block in ba_cpu._SCHUR_BLOCKS.items():
        WH, W = xo.random_rows(K // 3, D // 6, seed)
        assert np.array_equal(xo.port_schur(WH, W), xo.xla_schur(WH, W)), (D, K)


def test_schur_block_probe():
    for (D, K), block in ba_cpu._SCHUR_BLOCKS.items():
        assert xo.probe_schur_block(D, K) == block


def test_unmeasured_shape_warns_once(caplog):
    shape = (12, 300)
    assert shape not in ba_cpu._SCHUR_BLOCKS
    ba_cpu._UNMEASURED.discard(shape)
    WH, W = xo.random_rows(100, 2, 0)
    with caplog.at_level(logging.WARNING, logger=ba_cpu.__name__):
        a = xo.port_schur(WH, W)
        xo.port_schur(WH, W)
    msgs = [r.getMessage() for r in caplog.records if "no measured XLA:CPU" in r.getMessage()]
    assert len(msgs) == 1 and "[12, 300]" in msgs[0]
    want = np.einsum("mpk,mqk->pq", WH.reshape(100, 12, 3).astype(np.float64),
                     W.reshape(100, 12, 3).astype(np.float64))
    assert np.allclose(a, want, rtol=1e-4, atol=1e-4 * np.abs(want).max())


def test_torch_route_within_tolerance():
    """The PyTorch iteration, the card's, on the same input: the mapper
    tests' 1e-3, and the chi2 outlier detach equal on >= 99% of slots."""
    _, _, _, _, _, want = _call()
    state, _ = _local_ba()
    got = tms.to_numpy(state)
    for f in ("kf_pose", "lm_pos"):
        np.testing.assert_allclose(got[f], _host(want[f]), rtol=1e-3, atol=1e-3, err_msg=f)
    assert (got["kf_lm_idx"] == _host(want["kf_lm_idx"])).mean() >= 0.99


def test_policy_has_one_copy(monkeypatch):
    """With the damping, the chi2 gate and the step limits changed in
    ``models/bundle_adjustment``, the C iteration and the PyTorch one still
    agree (poses and points within 1e-3, the detached observations on >=
    99% of slots), and both move away from the default policy's map."""
    def both():
        c = tms.to_numpy(_local_ba(_xla="init")[0])
        t = tms.to_numpy(_local_ba()[0])
        for f in ("kf_pose", "lm_pos"):
            np.testing.assert_allclose(c[f], t[f], rtol=1e-3, atol=1e-3, err_msg=f)
        assert (c["kf_lm_idx"] == t["kf_lm_idx"]).mean() >= 0.99
        return c

    default = both()
    monkeypatch.setattr(tba, "_MAX_ROT", 1e-4)
    monkeypatch.setattr(tba, "_MAX_TRANS", 1e-4)
    monkeypatch.setattr(tba, "_MAX_LM_STEP", 1e-3)
    monkeypatch.setattr(robust, "CHI2_2D", 0.5)
    solve = tba.ba_solve
    monkeypatch.setattr(tmapper.ba, "ba_solve", lambda *a, **k: solve(*a, **k, damping=1.0))
    changed = both()
    assert np.abs(changed["kf_pose"][1] - default["kf_pose"][1]).max() > 1e-4
    assert np.abs(changed["lm_pos"] - default["lm_pos"]).max() > 1e-4
    assert (changed["kf_lm_idx"] != default["kf_lm_idx"]).any()


def test_refused():
    """The C source serves f32 CPU tensors of a pinhole camera without lines
    (``ba_solve`` runs the PyTorch iteration otherwise) and raises on
    observations off the grid; stereo rows pass (their arithmetic:
    tests/test_torch_chain_ba_xla_rgbd.py)."""
    _, tcam, _, _, _, _ = _call()
    prob, _ = _problem()
    assert ba_cpu.serves(tcam, prob, None)
    assert not ba_cpu.serves(tcam, prob._replace(cam_pose=torch.zeros((8, 3, 4), device="meta")),
                             None)
    assert not ba_cpu.serves(tcam, prob._replace(cam_pose=prob.cam_pose.double()), None)
    assert not ba_cpu.serves(tcam, prob, object())
    eq = dataclasses.replace(tcam, model=CameraModel.EQUIRECTANGULAR)
    assert not ba_cpu.serves(eq, prob, None)
    ba_cpu.check(prob._replace(obs_xr=torch.ones_like(prob.obs_xr)))
    with pytest.raises(ValueError, match="grid"):
        ba_cpu.check(prob._replace(obs_cam=prob.obs_cam.flip(0)))
