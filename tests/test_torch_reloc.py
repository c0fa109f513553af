"""Port parity: retrieval, PnP, relocalization, lost frames and map growth.

Inputs: the rendered RGB-D sequence at 320x240 (600 keypoints over 4
levels). The op-level tests feed the same inputs and keys to both
packages:

* BoW scores bit-equal (integer counts over a count);
* ``pnp_ransac`` on the same minimal sets (``utils/prng``): pose within
  1e-4, inlier masks equal;
* ``Relocalizer.relocalize`` on the JAX System's map (carried across with
  ``map_state.from_numpy``) and the JAX frontend's features: the same
  keyframe, pose within 1e-3, associations equal on >= 99% of the slots;
* ``map_database.grow``: every old slot bit-equal, every new slot as
  ``create`` makes it, equal to the JAX package's ``grow``.

System level: ``tests/test_loop_system.py``'s blackout (8 frames, two
black frames, frame 4 again) on both Systems: LOST after the black
frames, TRACKING after, frame poses within 1e-3; a kidnapped camera
(frame 4 again, turned upside down) that only the relocalizer recovers,
on both Systems: one relocalization each, poses within 1e-3; and a port
System that grows from small capacities matches one started at the
larger ones within 1e-4.
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
from structure_plp_slam_tpu.data import bow as jbow
from structure_plp_slam_tpu.data import map_database as jmdb
from structure_plp_slam_tpu.data import map_state as jms
from structure_plp_slam_tpu.models import relocalizer as jreloc
from structure_plp_slam_tpu.ops import pnp as jpnp
from structure_plp_slam_tpu.ops.orb import OrbParams as JOrb
from structure_plp_slam_tpu.system import System as JSystem
from structure_plp_slam_tpu_torch.camera import Camera, CameraModel, CameraSetup
from structure_plp_slam_tpu_torch.config import Config
from structure_plp_slam_tpu_torch.data import bow as tbow
from structure_plp_slam_tpu_torch.data import map_database as tmdb
from structure_plp_slam_tpu_torch.data import map_state as tms
from structure_plp_slam_tpu_torch.models import relocalizer as treloc
from structure_plp_slam_tpu_torch.ops import fused_match as tfm
from structure_plp_slam_tpu_torch.ops import pnp as tpnp
from structure_plp_slam_tpu_torch.ops.orb import OrbParams
from structure_plp_slam_tpu_torch.system import System
from structure_plp_slam_tpu_torch.testing import synthetic_scene
from structure_plp_slam_tpu_torch.utils import prng

torch.set_num_threads(2)

_KW = dict(name="synt", cols=320, rows=240, fx=260.0, fy=260.0, cx=159.5, cy=119.5,
           fps=30.0, focal_x_baseline=26.0, depth_threshold=400.0, depthmap_factor=1.0)
JCAM = JCamera(setup=JSetup.RGBD, model=JModel.PERSPECTIVE, **_KW)
TCAM = Camera(setup=CameraSetup.RGBD, model=CameraModel.PERSPECTIVE, **_KW)
ORB = dict(max_num_keypts=600, num_levels=4)
SIZES = dict(max_keyframes=8, max_landmarks=4096, enable_loop_closing=False,
             max_kf_interval=2)


def _T(a):
    a = np.array(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    elif a.dtype == np.int32:
        a = a.astype(np.int64)
    return torch.from_numpy(a)


def _jax_system(**kw):
    return JSystem(JConfig(camera=JCAM, orb=JOrb(**ORB), raw={}), **{**SIZES, **kw})


def _port_system(**kw):
    return System(Config(camera=TCAM, orb=OrbParams(**ORB), raw={}), device="cpu",
                  **{**SIZES, **kw})


@functools.lru_cache(maxsize=1)
def _frames():
    return synthetic_scene.make_sequence(np.random.default_rng(0), TCAM, num_frames=10)


@functools.lru_cache(maxsize=1)
def jax_map():
    """The JAX System after 8 frames: its state as numpy arrays, and the
    JAX frontend's features of frame 4."""
    js = _jax_system()
    js.startup()
    for img, depth, ts in _frames()[0][:8]:
        js.feed_RGBD_frame(img, depth, ts)
    st = js.state
    arrays = {f: np.asarray(getattr(st, f)) for f in st._fields}
    feats = js.frontend.rgbd(jnp.asarray(_frames()[0][4][0]), jnp.asarray(_frames()[0][4][1]))
    return js, arrays, {k: np.asarray(v) for k, v in feats.items()}


@pytest.mark.parametrize("chunk", [8, 3])
def test_bow_scores_bit_equal(chunk):
    _, arrays, feats = jax_map()
    sj = np.asarray(jbow._scores_impl(
        jnp.asarray(arrays["kf_desc"]), jnp.asarray(arrays["kf_kp_valid"]),
        jnp.asarray(arrays["kf_valid"]), jnp.asarray(feats["desc"]),
        jnp.asarray(feats["valid"]), chunk=chunk))
    st = tms.from_numpy(arrays, "cpu")
    s = tbow.BowIndex(chunk=chunk).scores(st, _T(feats["desc"]), _T(feats["valid"])).numpy()
    assert (s == sj).all()
    assert s.max() > 0.3


def test_pnp_ransac_parity():
    rng = np.random.default_rng(3)
    N = 300
    pts = np.stack([rng.uniform(-3, 3, N), rng.uniform(-2, 2, N), rng.uniform(4, 9, N)],
                   -1).astype(np.float32)
    phi = np.array([0.02, -0.05, 0.01])
    th = np.linalg.norm(phi)
    k = phi / th
    Kx = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    R = np.eye(3) + np.sin(th) * Kx + (1 - np.cos(th)) * Kx @ Kx
    t = np.array([0.3, -0.1, 0.2])
    pc = pts @ R.T + t
    uv = np.stack([TCAM.fx * pc[:, 0] / pc[:, 2] + TCAM.cx,
                   TCAM.fy * pc[:, 1] / pc[:, 2] + TCAM.cy], -1)
    uv += rng.normal(0, 0.5, uv.shape)
    out = rng.uniform(size=N) < 0.3
    uv[out] = rng.uniform([0, 0], [320, 240], (out.sum(), 2))
    uv = uv.astype(np.float32)
    valid = rng.uniform(size=N) < 0.9
    info = rng.choice(np.array([1.0, 1 / 1.44], np.float32), N)
    Rj, tj, inj, nj = jpnp.pnp_ransac(JCAM, jnp.asarray(pts), jnp.asarray(uv),
                                      jnp.asarray(info), jnp.asarray(valid),
                                      jax.random.PRNGKey(4))
    Rt, tt, int_, nt = tpnp.pnp_ransac(TCAM, _T(pts), _T(uv), _T(info), _T(valid),
                                       prng.PRNGKey(4))
    assert np.abs(Rt.numpy() - np.asarray(Rj)).max() < 1e-4
    assert np.abs(tt.numpy() - np.asarray(tj)).max() < 1e-4
    assert (int_.numpy() == np.asarray(inj)).all()
    # The LM polish keeps only the best hypothesis's inliers (the tracker's
    # top-up adds the rest), so the count sits well below the 172 clean
    # points.
    assert int(nt) == int(nj) > 30
    np.testing.assert_allclose(Rt.numpy(), R, atol=2e-2)


def test_relocalize_parity():
    js, arrays, feats = jax_map()
    key = jax.random.PRNGKey(11)
    oj = jreloc.Relocalizer(JCAM, jbow.BowIndex()).relocalize(
        jms.MapState(**{k: jnp.asarray(v) for k, v in arrays.items()}),
        {k: jnp.asarray(v) for k, v in feats.items()}, js.frontend.inv_sigma_sq, key,
        num_levels=4, scale_factor=1.2)
    inv_sigma_sq = torch.from_numpy(np.array(js.frontend.inv_sigma_sq))
    ot = treloc.Relocalizer(TCAM, tbow.BowIndex()).relocalize(
        tms.from_numpy(arrays, "cpu"), {k: _T(v) for k, v in feats.items()}, inv_sigma_sq,
        prng.PRNGKey(11), num_levels=4, scale_factor=1.2)
    assert oj is not None and ot is not None
    Rj, tj, kpj, kfj = oj
    Rt, tt, kpt, kft = ot
    assert kft == kfj
    assert np.abs(Rt.numpy() - np.asarray(Rj)).max() < 1e-3
    assert np.abs(tt.numpy() - np.asarray(tj)).max() < 1e-3
    assert (kpt.numpy() == np.asarray(kpj)).mean() >= 0.99


def test_grow_matches_jax_and_keeps_slots():
    rng = np.random.default_rng(2)
    sj = jms.create(max_keyframes=4, max_kps=16, max_landmarks=32, max_lines_per_kf=4,
                    max_line_landmarks=8, max_planes=2)
    arrays = {f: np.array(getattr(sj, f)) for f in sj._fields}
    for name, a in arrays.items():  # fill every slot with something distinct
        if a.dtype == np.bool_:
            arrays[name] = rng.uniform(size=a.shape) < 0.5
        elif a.dtype == np.uint32:
            arrays[name] = rng.integers(0, 2**32, a.shape, dtype=np.uint32)
        elif np.issubdtype(a.dtype, np.integer):
            arrays[name] = rng.integers(-1, 30, a.shape).astype(a.dtype)
        else:
            arrays[name] = rng.normal(size=a.shape).astype(a.dtype)
    kw = dict(grow_kf=True, grow_lm=True)
    gj = jmdb.grow(jms.MapState(**{k: jnp.asarray(v) for k, v in arrays.items()}), **kw)
    gt = tmdb.grow(tms.from_numpy(arrays, "cpu"), **kw)
    out = tms.to_numpy(gt)
    for name in sj._fields:
        a = np.asarray(getattr(gj, name))
        assert out[name].shape == a.shape, name
        assert (out[name] == a).all(), name
        old = arrays[name]
        assert (out[name][tuple(slice(0, s) for s in old.shape)] == old).all(), name
    assert gt.kf_pose.shape[0] == 8 and gt.lm_pos.shape[0] == 64
    # Only the selected capacities grow.
    g2 = tmdb.grow(tms.from_numpy(arrays, "cpu"), grow_lm=True)
    assert g2.kf_pose.shape[0] == 4 and g2.lm_pos.shape[0] == 64


def _assert_trajectories_agree(a, b, tol):
    """Camera translations within ``tol`` m and rotation entries within
    ``tol`` (about radians for small angles; an arccos of the trace cannot
    resolve f32 rotations below ~5e-4 rad)."""
    assert [ts for ts, _ in a] == [ts for ts, _ in b]
    for (ts, Pa), (_, Pb) in zip(a, b):
        dt = np.linalg.norm(Pa[:, 3] - Pb[:, 3])
        dr = np.abs(Pa[:, :3] - Pb[:, :3]).max()
        assert dt < tol and dr < tol, f"t={ts}: {dt:.2e} m, {dr:.2e}"


def turned(img):
    """The image of a camera turned 180 degrees about its optical axis (the
    principal point is the image centre): R -> diag(-1, -1, 1) R, same
    centre."""
    return np.ascontiguousarray(img[::-1, ::-1])


def _blackout(slam, frames, shown, black_ts, turn=False):
    """Feed ``frames``, two black frames, then frame ``shown`` again
    (``turn``: turned 180 degrees). Returns the tracking states after the
    black frames and at the end."""
    slam.startup()
    for img, depth, ts in frames:
        slam.feed_RGBD_frame(img, depth, ts)
    black = np.zeros_like(frames[0][0])
    for k in range(2):
        slam.feed_RGBD_frame(black, frames[0][1] * 0 + 1.0, black_ts + k / 30.0)
    lost = slam.tracking_state
    img, depth, _ = frames[shown]
    if turn:
        img, depth = turned(img), turned(depth)
    slam.feed_RGBD_frame(img, depth, black_ts + 0.1)
    slam.shutdown()
    return lost, slam.tracking_state


@functools.lru_cache(maxsize=None)
def run_blackout(package):
    slam = _jax_system() if package == "jax" else _port_system()
    tfm.reset_counts()
    lost, end = _blackout(slam, _frames()[0][:8], 4, 0.4)
    return slam, lost.value, end.value, tfm.fused_match.calls


def test_blackout_systems_agree():
    js, lost_j, end_j, _ = run_blackout("jax")
    ts, lost_t, end_t, _ = run_blackout("port")
    assert lost_t == lost_j == "Lost"
    assert end_t == end_j == "Tracking"
    assert ts.num_relocalizations == js.num_relocalizations
    assert ts.next_kf == js.next_kf
    _assert_trajectories_agree(js.frame_trajectory(), ts.frame_trajectory(), 1e-3)
    # The re-shown frame 4 sits where the camera was.
    R_gt, t_gt = _frames()[1][4]
    P = ts.frame_trajectory()[-1][1]
    assert np.linalg.norm(-P[:, :3].T @ P[:, 3] + R_gt.T @ t_gt) < 0.08


def test_blackout_relocalizer_went_through_matcher():
    """Each lost frame runs the relocalizer: 3 candidates, each through
    track_frame's three matcher calls."""
    ts, _, _, calls = run_blackout("port")
    lost = sum(1 for s in ts._frame_stats if s[3])
    assert lost == 2
    assert calls == 3 * ts.num_track_steps + (ts.next_kf - 1) + lost * 3 * 3


@functools.lru_cache(maxsize=None)
def run_kidnap(package):
    slam = _jax_system() if package == "jax" else _port_system()
    lost, end = _blackout(slam, _frames()[0][:8], 4, 0.4, turn=True)
    return slam, lost.value, end.value


def test_kidnapped_camera_relocalizes():
    """After the blackout, frame 4 seen by the camera turned upside down:
    the tracker cannot turn its motion-model pose round, the relocalizer
    (rotation-invariant retrieval and PnP) can."""
    js, lost_j, end_j = run_kidnap("jax")
    ts, lost_t, end_t = run_kidnap("port")
    assert lost_t == lost_j == "Lost"
    assert end_t == end_j == "Tracking"
    assert ts.num_relocalizations == js.num_relocalizations == 1
    _assert_trajectories_agree(js.frame_trajectory(), ts.frame_trajectory(), 1e-3)
    R_gt, t_gt = _frames()[1][4]
    P = ts.frame_trajectory()[-1][1]
    assert np.linalg.norm(-P[:, :3].T @ P[:, 3] + R_gt.T @ t_gt) < 0.08
    assert np.abs(P[:, :3] - np.diag([-1.0, -1.0, 1.0]) @ R_gt).max() < 0.02


@functools.lru_cache(maxsize=None)
def run_growth(start):
    slam = _port_system(max_keyframes=start[0], max_landmarks=start[1], track_lag=2)
    poses = []
    slam.startup()
    for img, depth, ts in _frames()[0][:6]:
        out = slam.feed_RGBD_frame(img, depth, ts)
        poses.append(None if out is None else np.asarray(out))
    slam.shutdown()
    return slam, poses


def test_grown_system_matches_larger_start():
    """A System started at K = 4, L = 2048 doubles both (the landmark
    headroom runs out at the first frame's seeds) and then agrees with
    one started at K = 8, L = 4096."""
    small, ps = run_growth((4, 2048))
    large, pl = run_growth((8, 4096))
    assert small.max_keyframes == large.max_keyframes == 8
    assert small.max_landmarks == large.max_landmarks == 4096
    assert small.next_kf == large.next_kf
    assert small.num_landmarks == large.num_landmarks
    for a, b in zip(ps, pl):
        assert (a is None) == (b is None)
        if a is not None:
            assert np.abs(a - b).max() < 1e-4
    _assert_trajectories_agree(small.frame_trajectory(), large.frame_trajectory(), 1e-4)


@pytest.mark.slow
def test_full_width_keyframe_fault_matches_jax():
    """8 frames at chip_smoke.py's width (640x480, 1000 keypoints over 8
    levels; capacities cut to 16 keyframes / 8192 landmarks) with
    max_kf_interval=2: local BA pulls the second keyframe (frame 1) more
    than 0.5 m off its place in the JAX System, and the port does the
    same (ROADMAP C15). How far moves with the f32 summation order (the
    thread count), so the two are held within 0.1 m of each other."""
    kw = dict(name="b", cols=640, rows=480, fx=525.0, fy=525.0, cx=319.5, cy=239.5,
              fps=30.0, focal_x_baseline=40.0, depth_threshold=40.0, depthmap_factor=1.0)
    cam = Camera(setup=CameraSetup.RGBD, model=CameraModel.PERSPECTIVE, **kw)
    frames, poses = synthetic_scene.make_sequence(np.random.default_rng(0), cam, 8)
    sizes = dict(max_keyframes=16, max_landmarks=8192, max_kf_interval=2,
                 enable_loop_closing=False)
    js = JSystem(JConfig(camera=JCamera(setup=JSetup.RGBD, model=JModel.PERSPECTIVE, **kw),
                         orb=JOrb(max_num_keypts=1000, num_levels=8), raw={}), **sizes)
    ts = System(Config(camera=cam, orb=OrbParams(max_num_keypts=1000, num_levels=8), raw={}),
                device="cpu", **sizes)
    errors = []
    for slam in (js, ts):
        slam.startup()
        for img, depth, t in frames:
            slam.feed_RGBD_frame(img, depth, t)
        slam.shutdown()
        P = np.asarray(slam.state.kf_pose)[1]
        R_gt, t_gt = poses[1]
        errors.append(float(np.linalg.norm(-P[:, :3].T @ P[:, 3] + R_gt.T @ t_gt)))
    print(f"keyframe 1's centre error: JAX {errors[0]:.6f} m, port {errors[1]:.6f} m")
    assert min(errors) > 0.5
    assert abs(errors[0] - errors[1]) < 0.1
