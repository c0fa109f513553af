"""The tracker's motion-only pose solve on the CPU against XLA:CPU's.

The JAX tracker runs its pose solve twice per frame inside one jitted
``track_frame``: vmapped over three association strategies (stage 1, 2 x 8
Gauss-Newton steps) and alone over the union of the associations (stage 2,
4 x 10). On the CPU the port's ``ops/pose_cpu`` computes both as XLA:CPU
compiles them (ROADMAP C18). Held here on the organic out-and-back's frame
1 at 320x240 (a 0.4 m jump from an identity motion model), from the JAX
System's map after frame 0:

* the port's ``track_frame`` gives the JAX tracker's pose, associations and
  counts bit for bit, with the perspective camera and with a fisheye camera
  of the same intrinsics (both project with the pinhole model, and both
  take the C solve);
* each of the port's two solves, on the inputs its tracker gives it, equals
  the JAX package's solve (``tests/xla_pose_solve_orders.pose_trace``, the
  same solve with every step's values as outputs, vmapped for stage 1) on
  every Gauss-Newton step: ``chi2``, ``J3r``, ``Jw2``, ``H``, ``g``, the
  clamped step ``xi``, the step's cost and acceptance, and the final pose,
  inliers and chi2 total; the stage-2 trace ends at the JAX tracker's pose;
* each entry of the stereo normal-matrix block table, and the monocular
  dot's 4-lane order, gives XLA's dots on random rows of two seeds, in the
  batched and in the single layout;
* the C solve takes the LM policy and the chi2 gates from
  ``models/pose_opt`` (``_lm_policy``): changed there, both solves follow.
"""

from __future__ import annotations

import dataclasses
import functools
import logging

import numpy as np
import pytest
import torch

from structure_plp_slam_tpu.camera.base import CameraModel as JModel
from structure_plp_slam_tpu.models import tracker as jtracker
from structure_plp_slam_tpu_torch.camera.base import CameraModel
from structure_plp_slam_tpu_torch.models import pose_opt as tpose
from structure_plp_slam_tpu_torch.models import tracker as ttracker
from structure_plp_slam_tpu_torch.ops import pose_cpu
from tests import xla_pose_solve_orders as xo
from tests.test_torch_loop_system import TCAM
from tests.test_torch_tracker import state_to_torch, to_torch

STEP_FIELDS = ("chi2", "J3r", "Jw2", "H", "g", "xi", "cost", "accept")
# A fisheye lens's distortion (equidistant k1..k4): the tracker works on
# undistorted keypoints, so only the model's projection reaches it.
FISHEYE_K = dict(k1=-0.013, k2=0.004, k3=-0.0006, k4=0.00002)


@functools.lru_cache(maxsize=1)
def _frame1_inputs():
    return xo.out_and_back_frame1()


@functools.lru_cache(maxsize=None)
def _frame1(model="perspective"):
    """The JAX tracker's result on frame 1, the port's, and the inputs the
    port's tracker gave its two pose solves; ``model`` "fisheye" runs both
    trackers with a fisheye camera of the same intrinsics."""
    cam, args, kw = _frame1_inputs()
    tcam = TCAM
    if model == "fisheye":
        cam = dataclasses.replace(cam, model=JModel.FISHEYE, **FISHEYE_K)
        tcam = dataclasses.replace(TCAM, model=CameraModel.FISHEYE, **FISHEYE_K)
    jres = jtracker.track_frame(cam, *args, **kw)
    state, feats, *rest = args
    solves = []
    solve = tpose.optimize_pose

    def record(*a, **k):
        solves.append((a, k))
        return solve(*a, **k)

    tpose.optimize_pose = record
    try:
        tres = ttracker.track_frame(
            tcam, state_to_torch(state), {k: to_torch(v) for k, v in feats.items()},
            *(to_torch(x) for x in rest[:3]), int(rest[3]), to_torch(rest[4]),
            to_torch(rest[5]), int(rest[6]), **kw)
    finally:
        tpose.optimize_pose = solve
    return cam, jres, tres, solves


@pytest.mark.parametrize("model", ["perspective", "fisheye"])
def test_track_frame_equals_jax(model):
    _, jres, tres, solves = _frame1(model)
    assert len(solves) == 2
    for field in ("R", "t", "kp_lm", "num_tracked", "ref_kf", "ref_tracked",
                  "n_close_tracked", "n_close_untracked"):
        got = getattr(tres, field).numpy()
        want = np.asarray(getattr(jres, field))
        assert np.array_equal(got, want.astype(got.dtype)), field
    assert int(tres.num_tracked) > 100


@pytest.mark.parametrize("stage", [1, 2])
def test_pose_solve_steps_equal_jax(stage):
    cam, jres, _, solves = _frame1()
    (camera, *inputs), kw = solves[stage - 1]
    assert camera is TCAM
    trials, iters = kw.get("num_trials", 4), kw.get("num_iters", 10)
    assert (trials, iters) == ((2, 8) if stage == 1 else (4, 10))
    assert inputs[2].ndim == (3 if stage == 1 else 2)
    (R, t, inl, chi2), steps = pose_cpu.optimize_pose(
        TCAM, *inputs, num_trials=trials, num_iters=iters, policy=tpose._lm_policy(), trace=True)
    final, want = xo.pose_trace(cam, *(x.numpy() for x in inputs), num_trials=trials,
                                num_iters=iters)
    assert bool(torch.any(inputs[4] >= 0)), "the RGB-D rows carry the stereo term"
    for field in STEP_FIELDS:
        got = steps[field].numpy()
        w = want[field].astype(got.dtype)
        assert got.shape == w.shape, field
        lead = 3 if stage == 1 else 2  # ([strategy,] trial, step)
        apart = (got != w).reshape(got.shape[:lead] + (-1,)).any(-1)
        assert not apart.any(), (field, np.argwhere(apart)[:3].tolist())
    for g, w in zip((R, t, inl, chi2), final):
        assert np.array_equal(g.numpy(), w)
    res = tpose.optimize_pose(TCAM, *inputs, **kw)
    assert torch.equal(res.R, R) and torch.equal(res.t, t) and torch.equal(res.inliers, inl)
    if stage == 2:
        assert np.array_equal(final[0], np.asarray(jres.R))
        assert np.array_equal(final[1], np.asarray(jres.t))


@pytest.mark.parametrize("n", sorted(pose_cpu._H3_BLOCKS))
@pytest.mark.parametrize("batched", [True, False], ids=["batched", "single"])
def test_normal_dot_orders(n, batched):
    for seed in xo.SEEDS:
        rows = xo.random_rows(n, seed)
        want = xo.xla_normal_dots(*rows, batched)
        for b in range(rows[0].shape[0]):
            H2, H3 = xo.port_normal_dots(*(torch.from_numpy(x[b]) for x in rows))
            assert np.array_equal(H2.numpy(), want[0][b]), (n, seed, b)
            assert np.array_equal(H3.numpy(), want[1][b]), (n, seed, b)


def test_unmeasured_shape_warns_once(caplog):
    n = 100
    assert n not in pose_cpu._H3_BLOCKS
    pose_cpu._UNMEASURED.discard(n)
    rows = [torch.from_numpy(x[0]) for x in xo.random_rows(n, 0)]
    with caplog.at_level(logging.WARNING, logger=pose_cpu.__name__):
        H2, H3 = xo.port_normal_dots(*rows)
        xo.port_normal_dots(*rows)
    msgs = [r.getMessage() for r in caplog.records if "no measured XLA:CPU" in r.getMessage()]
    assert len(msgs) == 1 and "100 rows" in msgs[0]
    want = np.einsum("ni,nj->ij", rows[2].double().numpy(), rows[3].double().numpy())
    assert np.allclose(H3.numpy(), want, rtol=1e-4, atol=1e-3 * np.abs(want).max())


def test_cuda_tensors_refused():
    x = torch.zeros((4, 3), device="meta")
    with pytest.raises(ValueError, match="CPU tensors only"):
        pose_cpu.optimize_pose(TCAM, torch.eye(3), torch.zeros(3), x, torch.zeros((4, 2)),
                               torch.zeros(4), torch.ones(4), torch.ones(4, dtype=torch.bool),
                               num_trials=1, num_iters=1, policy=tpose._lm_policy())


def test_lm_policy_has_one_copy(monkeypatch):
    """The C solve repeats ``_optimize_pose_torch``'s loop and takes its
    constants from ``models/pose_opt``: with the damping schedule, the
    diagonal floor, the trust region and the chi2 gates changed there, the C
    solve and the PyTorch solve still agree (pose within 1e-4, inliers
    equal), and both move away from the default policy's pose."""
    _, _, _, solves = _frame1()
    (camera, *inputs), kw = solves[1]

    def both():
        c = tpose.optimize_pose(camera, *inputs, **kw)
        t = tpose._optimize_pose_torch(camera, *inputs, **kw)
        assert torch.equal(c.inliers, t.inliers)
        assert (c.R - t.R).abs().max() < 1e-4 and (c.t - t.t).abs().max() < 1e-4
        return c

    default = both()
    for name, value in dict(_LM_LAMBDA0=30.0, _LM_DOWN=0.9, _LM_MIN=1.0, _LM_UP=1.5,
                            _LM_MAX=100.0, _LM_DIAG_FLOOR=1e2, _MAX_ROT=1e-3,
                            _MAX_TRANS=2e-3).items():
        monkeypatch.setattr(tpose, name, value)
    monkeypatch.setattr(tpose.robust, "CHI2_2D", 2.0)
    monkeypatch.setattr(tpose.robust, "CHI2_3D", 3.0)
    changed = both()
    assert (changed.t - default.t).abs().max() > 1e-3
    assert int(changed.num_inliers) < int(default.num_inliers)
