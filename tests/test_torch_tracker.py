"""Port parity: tracking against a map carried across from the JAX System.

The JAX System maps 6 rendered RGB-D frames (320x240, 600 keypoints over
4 levels, 8 keyframes / 4096 landmarks). Its MapState goes to the port
through ``map_state.from_numpy``; both packages then track frame 7 from
the same features, motion prediction, previous associations and
observation indicator. The JAX tracker runs its CPU branch (masked
distance matrices); the port runs its fused matcher — the two compute the
same function, so associations must agree on >= 99% of the keypoint slots
(float order in the LM can flip a borderline chi2 gate), the pose within
1e-4 (rotation Frobenius) and 1e-4 m, the tracked count within 1%.

``build_jax_map`` is shared with tests/test_torch_mapper.py.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from structure_plp_slam_tpu.camera import Camera as JCamera
from structure_plp_slam_tpu.camera import CameraModel as JModel
from structure_plp_slam_tpu.camera import CameraSetup as JSetup
from structure_plp_slam_tpu.config import Config as JConfig
from structure_plp_slam_tpu.models import pose_opt as jpose_opt
from structure_plp_slam_tpu.models import tracker as jtracker
from structure_plp_slam_tpu.ops import lie as jlie
from structure_plp_slam_tpu.ops.orb import OrbParams as JOrb
from structure_plp_slam_tpu.system import System as JSystem
from structure_plp_slam_tpu_torch.camera import Camera, CameraModel, CameraSetup
from structure_plp_slam_tpu_torch.data import map_state as tms
from structure_plp_slam_tpu_torch.models import pose_opt as tpose_opt
from structure_plp_slam_tpu_torch.models import tracker as ttracker
from tests import synthetic_scene

torch.set_num_threads(2)

_KW = dict(name="synt", cols=320, rows=240, fx=260.0, fy=260.0, cx=159.5, cy=119.5,
           fps=30.0, focal_x_baseline=26.0, depth_threshold=400.0, depthmap_factor=1.0)
JCAM = JCamera(setup=JSetup.RGBD, model=JModel.PERSPECTIVE, **_KW)
TCAM = Camera(setup=CameraSetup.RGBD, model=CameraModel.PERSPECTIVE, **_KW)
MAP_FRAMES = 6


def to_torch(x):
    """JAX/numpy array -> CPU tensor in the port's dtypes."""
    a = np.array(x)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    elif a.dtype == np.int32:
        a = a.astype(np.int64)
    return torch.from_numpy(a)


def state_to_torch(state):
    return tms.from_numpy({f: np.asarray(getattr(state, f)) for f in state._fields}, "cpu")


@functools.lru_cache(maxsize=1)
def build_jax_map():
    """The JAX System after MAP_FRAMES frames, and the inputs of the next
    frame's tracking step."""
    frames, _ = synthetic_scene.make_sequence(np.random.default_rng(42), JCAM,
                                              num_frames=MAP_FRAMES + 1)
    cfg = JConfig(camera=JCAM, orb=JOrb(max_num_keypts=600, num_levels=4), raw={})
    js = JSystem(cfg, max_keyframes=8, max_landmarks=4096, enable_loop_closing=False)
    js.startup()
    for img, depth, ts in frames[:MAP_FRAMES]:
        js.feed_RGBD_frame(img, depth, ts)
    state = js.state  # drains the lagged decisions
    img, depth, ts = frames[MAP_FRAMES]
    feats = js.frontend.rgbd(img, depth)
    (R, t), (Rv, tv) = js.pose, js.vel
    inputs = dict(
        R_pred=Rv @ R, t_pred=Rv @ t + tv, last_kp_lm=js.last_kp_lm,
        prev_ref_kf=js._ref_kf_dev, inv_sigma_sq=js.frontend.inv_sigma_sq,
        ind=js._obs_indicator(), min_obs=3 if js.next_kf >= 3 else 1,
        next_kf=int(js.next_kf), next_lm=int(js.next_lm), ts=ts,
    )
    return state, feats, inputs


@functools.lru_cache(maxsize=1)
def track_both():
    state, feats, inp = build_jax_map()
    jres = jtracker.track_frame(
        JCAM, state, feats, inp["R_pred"], inp["t_pred"], inp["last_kp_lm"],
        inp["prev_ref_kf"], inp["inv_sigma_sq"], inp["ind"], jnp.int32(inp["min_obs"]),
        num_levels=4, scale_factor=1.2,
    )
    tfeats = {k: to_torch(v) for k, v in feats.items()}
    tres = ttracker.track_frame(
        TCAM, state_to_torch(state), tfeats, to_torch(inp["R_pred"]),
        to_torch(inp["t_pred"]), to_torch(inp["last_kp_lm"]),
        int(inp["prev_ref_kf"]), to_torch(inp["inv_sigma_sq"]), to_torch(inp["ind"]),
        inp["min_obs"], num_levels=4, scale_factor=1.2,
    )
    return jres, tres


def test_state_round_trip():
    state, _, _ = build_jax_map()
    back = tms.to_numpy(state_to_torch(state))
    for f in state._fields:
        ref = np.asarray(getattr(state, f))
        assert back[f].dtype == ref.dtype, f
        np.testing.assert_array_equal(back[f], ref, err_msg=f)


def test_track_frame_pose():
    jres, tres = track_both()
    dR = np.linalg.norm(tres.R.numpy() - np.asarray(jres.R))
    dt = np.linalg.norm(tres.t.numpy() - np.asarray(jres.t))
    assert dR < 1e-4 and dt < 1e-4, (dR, dt)


def test_track_frame_associations():
    jres, tres = track_both()
    kp_eq = tres.kp_lm.numpy() == np.asarray(jres.kp_lm)
    assert kp_eq.mean() >= 0.99, f"kp_lm equal on {kp_eq.mean():.4f} of the slots"
    n_j, n_t = int(jres.num_tracked), int(tres.num_tracked)
    assert n_j > 100 and abs(n_t - n_j) <= 0.01 * n_j, (n_t, n_j)
    assert int(tres.ref_kf) == int(jres.ref_kf)
    for f in ("lm_vis", "lm_fnd"):
        eq = getattr(tres, f).numpy() == np.asarray(getattr(jres, f))
        assert eq.mean() >= 0.99, f


def test_track_frame_decision_inputs():
    jres, tres = track_both()
    for f in ("ref_tracked", "n_close_tracked", "n_close_untracked"):
        j, t = int(getattr(jres, f)), int(getattr(tres, f))
        assert abs(t - j) <= max(1, 0.01 * j), (f, t, j)


def test_count_trackable_in_ref():
    state, _, inp = build_jax_map()
    j = jtracker.count_trackable_in_ref(JCAM, state, 0, 1, inp["ind"])
    t = ttracker.count_trackable_in_ref(TCAM, state_to_torch(state), 0, 1, to_torch(inp["ind"]))
    assert int(t) == int(j)


def _pose_problem(rng, B=3, N=240):
    """Landmarks 2-8 m ahead, observed from a camera 5 cm / 0.02 rad away
    from the initial guess, with 0.5 px noise, 15% gross outliers and half
    of the keypoints carrying a depth (virtual right x); ``B`` masks over
    the same observations."""
    X = np.concatenate([rng.uniform(-3, 3, (N, 2)), rng.uniform(2, 8, (N, 1))], -1)
    X = np.broadcast_to(X, (B, N, 3))  # the strategies differ by their masks
    R_true = np.asarray(jlie.so3_exp(jnp.asarray([[0.01, -0.02, 0.005]])))[0]
    t_true = np.array([0.05, -0.02, 0.03])
    pc = X[0] @ R_true.T + t_true
    uv = np.stack([_KW["fx"] * pc[:, 0] / pc[:, 2] + _KW["cx"],
                   _KW["fy"] * pc[:, 1] / pc[:, 2] + _KW["cy"]], -1)
    uv += rng.normal(scale=0.5, size=uv.shape)
    out = rng.uniform(size=N) < 0.15
    uv[out] += rng.uniform(-40, 40, (out.sum(), 2))
    xr = np.where(rng.uniform(size=N) < 0.5, uv[:, 0] - _KW["focal_x_baseline"] / pc[:, 2], -1.0)
    info = 1.0 / 1.2 ** (2 * rng.integers(0, 4, N))
    valid = rng.uniform(size=(B, N)) < 0.9
    f32 = np.float32
    return (np.eye(3, dtype=f32), np.zeros(3, f32), X.astype(f32), uv.astype(f32),
            xr.astype(f32), info.astype(f32), valid)


@pytest.mark.parametrize(("batched", "solve"), [
    (False, "optimize_pose"), (True, "optimize_pose"),
    (False, "_optimize_pose_torch"), (True, "_optimize_pose_torch")],
    ids=["False", "True", "torch-False", "torch-True"])
def test_optimize_pose_matches_jax(batched, solve):
    """The LM motion-only solve: one pose, or the tracker's batch of 3
    strategies (JAX vmaps the same solve). Pose within 1e-4, inlier masks
    equal on >= 99% of the observations (a chi2 gate can flip on f32
    order), inlier counts within 1%. Both solves of the port: the public
    ``optimize_pose`` (on the CPU the C source, ``ops/pose_cpu``) and the
    PyTorch solve the card runs (``_optimize_pose_torch``)."""
    fn = getattr(tpose_opt, solve)
    R0, t0, X, uv, xr, info, valid = _pose_problem(np.random.default_rng(9))
    if batched:
        kw = dict(num_trials=2, num_iters=8)
        jfn = jax.vmap(
            lambda p, v: jpose_opt.optimize_pose(JCAM, R0, t0, p, uv, xr, info, v, **kw))
        jres = jfn(jnp.asarray(X), jnp.asarray(valid))
        tres = fn(TCAM, to_torch(R0), to_torch(t0), to_torch(X),
                                       to_torch(uv), to_torch(xr), to_torch(info),
                                       to_torch(valid), **kw)
    else:
        jres = jpose_opt.optimize_pose(JCAM, R0, t0, X[0], uv, xr, info, valid[0])
        tres = fn(TCAM, to_torch(R0), to_torch(t0), to_torch(X[0]),
                                       to_torch(uv), to_torch(xr), to_torch(info),
                                       to_torch(valid[0]))
    np.testing.assert_allclose(tres.R.numpy(), np.asarray(jres.R), rtol=0, atol=1e-4)
    np.testing.assert_allclose(tres.t.numpy(), np.asarray(jres.t), rtol=0, atol=1e-4)
    eq = tres.inliers.numpy() == np.asarray(jres.inliers)
    assert eq.mean() >= 0.99, eq.mean()
    n_j, n_t = np.asarray(jres.num_inliers), tres.num_inliers.numpy()
    assert np.all(np.abs(n_t - n_j) <= np.maximum(1, 0.01 * n_j)), (n_t, n_j)
    assert np.all(n_j > 100)
