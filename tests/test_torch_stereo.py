"""Port parity: stereo matching, the stereo frontend, rectification and the
stereo System.

Inputs: rendered left/right pairs at 320x240 with a 0.1 m baseline (the
right camera at ``t - [b, 0, 0]``, as tests/test_stereo_system.py renders
them), 600 keypoints over 4 levels. ``match_stereo`` takes the JAX
extractor's keypoints of both images in both packages: ``ok``, ``xr`` and
depth equal (the SAD sums in XLA:CPU's order). ``Frontend.stereo``
runs each package's own extractor, whose features are equal
(tests/test_torch_frontend.py), so its ``ok`` masks, ``xr`` and depths are
equal (ROADMAP C29). The rectifier's maps are the same numpy code (exact); the
remapped images agree within 1e-3 grey levels. The System test runs both
Systems on 6 pairs (8 keyframes: the chain's local BA over 16 window
cameras, which ``ops/ba_cpu`` computes as XLA:CPU does, ROADMAP C18): every
per-frame pose and the frame trajectory equal, equal keyframe and landmark
counts, and no shape outside ``ops/ba_cpu``'s tables.
"""

import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from structure_plp_slam_tpu.camera import Camera as JCamera
from structure_plp_slam_tpu.camera import CameraModel as JModel
from structure_plp_slam_tpu.camera import CameraSetup as JSetup
from structure_plp_slam_tpu.config import Config as JConfig
from structure_plp_slam_tpu.models import frontend as jfrontend
from structure_plp_slam_tpu.ops import matching as jmatching
from structure_plp_slam_tpu.ops import orb as jorb
from structure_plp_slam_tpu.ops import rectify as jrectify
from structure_plp_slam_tpu.ops import stereo as jstereo
from structure_plp_slam_tpu.system import System as JSystem
from structure_plp_slam_tpu_torch.camera import Camera, CameraModel, CameraSetup
from structure_plp_slam_tpu_torch.config import Config
from structure_plp_slam_tpu_torch.io import trajectory as traj_io
from structure_plp_slam_tpu_torch.models import frontend as tfrontend
from structure_plp_slam_tpu_torch.ops import ba_cpu
from structure_plp_slam_tpu_torch.ops import fused_match as tfm
from structure_plp_slam_tpu_torch.ops import matching as tmatching
from structure_plp_slam_tpu_torch.ops import rectify as trectify
from structure_plp_slam_tpu_torch.ops import stereo as tstereo
from structure_plp_slam_tpu_torch.ops.orb import OrbParams
from structure_plp_slam_tpu_torch.system import System, TrackerState
from structure_plp_slam_tpu_torch.testing import synthetic_scene

torch.set_num_threads(2)

BASELINE = 0.1
_KW = dict(name="stereo", cols=320, rows=240, fx=260.0, fy=260.0, cx=159.5, cy=119.5,
           fps=30.0, focal_x_baseline=260.0 * BASELINE, depth_threshold=400.0)
JCAM = JCamera(setup=JSetup.STEREO, model=JModel.PERSPECTIVE, **_KW)
TCAM = Camera(setup=CameraSetup.STEREO, model=CameraModel.PERSPECTIVE, **_KW)
ORB = dict(max_num_keypts=600, num_levels=4)
NUM_FRAMES = 6
SIZES = dict(max_keyframes=8, max_landmarks=4096, enable_loop_closing=False, track_lag=2,
             max_kf_interval=2)


def render_pairs(rng, num_frames, step=0.06):
    """Left/right pairs and the left camera's ground-truth poses."""
    tex = synthetic_scene.make_texture(rng)
    poses = synthetic_scene.trajectory(num_frames, step=step)
    pairs = []
    for i, (R, t) in enumerate(poses):
        left, _ = synthetic_scene.render(TCAM, tex, R, t)
        right, _ = synthetic_scene.render(TCAM, tex, R, t - np.array([BASELINE, 0.0, 0.0]))
        pairs.append((left, right, float(i) / 30.0))
    return pairs, poses


@functools.lru_cache(maxsize=1)
def _pairs():
    return render_pairs(np.random.default_rng(42), NUM_FRAMES)[0]


def _T(a):
    a = np.array(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    elif a.dtype == np.int32:
        a = a.astype(np.int64)
    return torch.from_numpy(a)


def test_match_stereo_parity():
    left, right, _ = _pairs()[2]
    ext = jorb.OrbExtractor(240, 320, jorb.OrbParams(**ORB))
    fl, fr = ext(jnp.asarray(left)), ext(jnp.asarray(right))
    sf = jnp.asarray(jorb.OrbParams(**ORB).scale_factors(), jnp.float32)
    args_j = (jnp.asarray(left), jnp.asarray(right), fl["xy"], fl["level"],
              jmatching.unpack_desc_bits(fl["desc"]), fl["valid"], fr["xy"], fr["level"],
              jmatching.unpack_desc_bits(fr["desc"]), fr["valid"], sf)
    xj, dj, okj = (np.asarray(a) for a in jstereo.match_stereo(
        *args_j, focal_x_baseline=TCAM.focal_x_baseline))
    t = {k: _T(np.asarray(v)) for k, v in (("lxy", fl["xy"]), ("llv", fl["level"]),
                                           ("ld", fl["desc"]), ("lv", fl["valid"]),
                                           ("rxy", fr["xy"]), ("rlv", fr["level"]),
                                           ("rd", fr["desc"]), ("rv", fr["valid"]))}
    xt, dt, okt = (a.numpy() for a in tstereo.match_stereo(
        torch.from_numpy(left), torch.from_numpy(right), t["lxy"], t["llv"],
        tmatching.unpack_desc_bits(t["ld"]), t["lv"], t["rxy"], t["rlv"],
        tmatching.unpack_desc_bits(t["rd"]), t["rv"], _T(np.asarray(sf)),
        focal_x_baseline=TCAM.focal_x_baseline))
    assert (okt == okj).all()
    assert okj.sum() > 200
    np.testing.assert_array_equal(xt, xj)
    np.testing.assert_array_equal(dt, dj)


def test_frontend_stereo_parity():
    left, right, _ = _pairs()[0]
    cap = -(-jorb.OrbExtractor(240, 320, jorb.OrbParams(**ORB)).capacity // 8) * 8
    fj = jfrontend.Frontend(JCAM, jorb.OrbParams(**ORB), pad_to=cap).stereo(
        jnp.asarray(left), jnp.asarray(right))
    ft = tfrontend.Frontend(TCAM, OrbParams(**ORB), pad_to=cap, device="cpu").stereo(
        left, right)
    okj, okt = np.asarray(fj["xr"]) >= 0, ft["xr"].numpy() >= 0
    assert (okj == okt).all()
    both = okj & okt
    assert both.sum() > 200
    np.testing.assert_array_equal(ft["xr"].numpy(), np.asarray(fj["xr"]))
    np.testing.assert_array_equal(ft["depth"].numpy(), np.asarray(fj["depth"]))
    assert (ft["depth"].numpy()[~okt] == 0).all()


def _rectifier_raw():
    K_raw = [[275.0, 0, 150.0], [0, 271.0, 125.0], [0, 0, 1.0]]
    th = 0.03
    R = [[np.cos(th), 0, np.sin(th)], [0, 1, 0], [-np.sin(th), 0, np.cos(th)]]
    return {
        "StereoRectifier.K_left": np.array(K_raw), "StereoRectifier.K_right": np.array(K_raw),
        "StereoRectifier.D_left": [-0.28, 0.07, 1.9e-4, 1.76e-5, 0.0],
        "StereoRectifier.D_right": [-0.2, 0.05, 0.0, 0.0, 0.0],
        "StereoRectifier.R_left": np.array(R), "StereoRectifier.R_right": np.eye(3),
    }


def test_stereo_rectifier_parity():
    raw = _rectifier_raw()
    rj = jrectify.StereoRectifier(JCAM, raw)
    rt = trectify.StereoRectifier(TCAM, raw, device="cpu")
    for a, b in ((rj.my_l, rt.my_l), (rj.mx_l, rt.mx_l), (rj.my_r, rt.my_r),
                 (rj.mx_r, rt.mx_r)):
        assert (np.asarray(a) == b.numpy()).all()
    left, right, _ = _pairs()[1]
    lj, rjj = rj(left, right)
    lt, rtt = rt(left, right)
    assert np.abs(lt.numpy() - np.asarray(lj)).max() < 1e-3
    assert np.abs(rtt.numpy() - np.asarray(rjj)).max() < 1e-3
    # Out-of-bounds samples read 0 on both sides.
    assert ((np.asarray(lj) == 0) == (lt.numpy() == 0)).all()


def _run(slam, pairs):
    slam.startup()
    poses = []
    for left, right, ts in pairs:
        out = slam.feed_stereo_frame(left, right, ts)
        if torch.is_tensor(out):
            out = out.cpu().numpy()
        poses.append(None if out is None else np.array(out))
    slam.shutdown()
    return poses


@functools.lru_cache(maxsize=1)
def run_jax():
    js = JSystem(JConfig(camera=JCAM, orb=jorb.OrbParams(**ORB), raw={}), **SIZES)
    return js, _run(js, _pairs())


# The shapes outside ops/ba_cpu's tables the port run met.
UNMEASURED = set()


@functools.lru_cache(maxsize=1)
def run_port():
    ts = System(Config(camera=TCAM, orb=OrbParams(**ORB), raw={}), device="cpu", **SIZES)
    tfm.reset_counts()
    with ba_cpu.unmeasured_shapes() as met:
        poses = _run(ts, _pairs())
    UNMEASURED.update(met)
    return ts, poses, tfm.fused_match.calls


def test_stereo_system_matches_jax():
    js, jposes = run_jax()
    ts, tposes, _ = run_port()
    assert len(jposes) == len(tposes) == NUM_FRAMES
    for i, (a, b) in enumerate(zip(jposes, tposes)):
        assert (a is None) == (b is None), f"frame {i}: one System returned no pose"
        if a is None:
            continue
        assert np.array_equal(a, b), f"frame {i}: {np.abs(a - b).max():.2e}"
    tj, tt = js.frame_trajectory(), ts.frame_trajectory()
    assert len(tj) == len(tt)
    for (ta, pa), (tb, pb) in zip(tj, tt):
        assert ta == tb
        assert np.array_equal(pa, pb)
    assert ts.num_keyframes == js.num_keyframes
    assert ts.next_kf == js.next_kf >= 3
    assert ts.num_landmarks == js.num_landmarks
    assert ts.tracking_state.value == js.tracking_state.value == "Tracking"
    assert not UNMEASURED, UNMEASURED


def test_stereo_system_went_through_matcher():
    ts, _, calls = run_port()
    assert ts.num_track_steps == NUM_FRAMES - 1  # the first pair initializes
    assert calls == 3 * ts.num_track_steps + ts.next_kf - 1


@pytest.mark.slow
def test_stereo_sequence_ate():
    """tests/test_stereo_system.py::test_stereo_sequence_ate on the port."""
    pairs, poses = render_pairs(np.random.default_rng(42), 12)
    slam = System(Config(camera=TCAM, orb=OrbParams(**ORB), raw={}), max_keyframes=32,
                  max_landmarks=8192, max_kf_interval=2, enable_loop_closing=False,
                  device="cpu")
    slam.startup()
    for left, right, ts in pairs:
        slam.feed_stereo_frame(left, right, ts)
    slam.shutdown()
    assert slam.tracking_state is TrackerState.TRACKING
    gt = [(float(i) / 30.0, np.concatenate([R, t[:, None]], 1).astype(np.float64))
          for i, (R, t) in enumerate(poses)]
    ate = traj_io.ate_rmse(slam.frame_trajectory(), gt, align_scale=False)
    assert ate < 0.06, f"ATE {ate}"
    assert slam.num_landmarks > 200
