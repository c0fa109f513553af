"""Port parity at the dataset cameras (ROADMAP C46): EuRoC's 752x480 and
KITTI odometry's 1241x376, the cameras of run.py's euroc and kitti
subcommands, each with chip_smoke.py phase 8 (b)'s features (1000 keypoints
at EuRoC, 2000 at KITTI, 8 levels at 1.2).

- The resize: every product of both pyramids and of both half-resolution
  line passes equals XLA:CPU's bit for bit (``ops/image.py``'s
  ``_XLA_DOT_ORDERS``; at K = 1241 some second products add the odd last
  tap after the lanes, the order's ``tail`` field).
- The extractor on one rendered frame (numpy seed 42): slots, levels,
  angles and descriptors equal to the JAX package's.
- ``match_stereo`` on one pair at each camera (KITTI's 0.537 m baseline
  allows disparities up to 386 px) and on a 640x480 pair (1000 keypoints,
  1,032 slots), with the JAX extractor's keypoints in both packages:
  ``xr``, depth and ``ok`` equal (the SAD sums in XLA:CPU's tree order,
  ``ops/linalg.tree_sum``); the card's ops (``torch.sum``) on the same
  CPU tensors: ``ok`` equal, ``xr`` within 1e-3 px, depth within 1e-4
  relative (ROADMAP C29).
- A shape outside the table takes the default order and says so once.
- The slow case drives both Systems over 6 stereo pairs at each camera:
  every per-frame pose equal.
"""

import functools
import logging

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from structure_plp_slam_tpu.camera import Camera as JCamera
from structure_plp_slam_tpu.camera import CameraModel as JModel
from structure_plp_slam_tpu.camera import CameraSetup as JSetup
from structure_plp_slam_tpu.config import Config as JConfig
from structure_plp_slam_tpu.ops import matching as jmatching
from structure_plp_slam_tpu.ops import orb as jorb
from structure_plp_slam_tpu.ops import stereo as jstereo
from structure_plp_slam_tpu.system import System as JSystem
from structure_plp_slam_tpu_torch.camera import Camera, CameraModel, CameraSetup
from structure_plp_slam_tpu_torch.config import Config
from structure_plp_slam_tpu_torch.ops import ba_cpu
from structure_plp_slam_tpu_torch.ops import image as timg
from structure_plp_slam_tpu_torch.ops import linalg as tlinalg
from structure_plp_slam_tpu_torch.ops import matching as tmatching
from structure_plp_slam_tpu_torch.ops import orb as torb
from structure_plp_slam_tpu_torch.ops import stereo as tstereo
from structure_plp_slam_tpu_torch.system import System
from tests import synthetic_scene, xla_dot_orders

torch.set_num_threads(2)

# The stereo YAMLs' cameras (chip_smoke.py DATASET_CAMERAS).
CAMERAS = {
    "euroc": (dict(name="euroc", cols=752, rows=480, fx=435.2046959714599,
                   fy=435.2046959714599, cx=367.4517211914062, cy=252.2008514404297,
                   fps=20.0, focal_x_baseline=47.90639384423901, depth_threshold=40.0), 1000),
    "kitti": (dict(name="kitti", cols=1241, rows=376, fx=718.856, fy=718.856, cx=607.1928,
                   cy=185.2157, fps=10.0, focal_x_baseline=386.1448, depth_threshold=40.0),
              2000),
}
# The 640x480 main path's stereo camera (chip_smoke.py phase 8: 0.1 m
# baseline), for match_stereo only.
STEREO_CAMERAS = {**CAMERAS, "vga": (dict(name="vga", cols=640, rows=480, fx=525.0, fy=525.0,
                                          cx=319.5, cy=239.5, fps=30.0, focal_x_baseline=52.5,
                                          depth_threshold=40.0), 1000)}
PLANE_HALF = 8.0  # chip_smoke.py DATASET_PLANE_HALF: the plane fills the wider views


def _cams(name):
    kw, _ = STEREO_CAMERAS[name]
    return (JCamera(setup=JSetup.STEREO, model=JModel.PERSPECTIVE, **kw),
            Camera(setup=CameraSetup.STEREO, model=CameraModel.PERSPECTIVE, **kw))


def _orb(name, mod):
    return mod.OrbParams(max_num_keypts=STEREO_CAMERAS[name][1], num_levels=8)


def _resize_cases():
    return xla_dot_orders.resize_shapes(xla_dot_orders.DATASET_PYRAMIDS,
                                        xla_dot_orders.DATASET_HALVES)


@pytest.mark.parametrize("src,dst", _resize_cases(),
                         ids=[f"{s[1]}x{s[0]}-{d[1]}x{d[0]}" for s, d in _resize_cases()])
def test_resize_summation_order(src, dst):
    """XLA:CPU's ``(A @ img) @ B.T`` bit for bit on a random frame, and
    each product's order the first candidate of tests/xla_dot_orders.py
    that matches XLA (tests/test_torch_frontend.py's case at the dataset
    cameras' shapes)."""
    img = np.random.default_rng(0).uniform(0, 255, src).astype(np.float32)
    _, ref = xla_dot_orders.xla_products(img, dst)
    port = timg.resize_bilinear(torch.from_numpy(img), dst).numpy()
    np.testing.assert_array_equal(port, ref)
    for shape, ok in xla_dot_orders.matching_orders(img, dst):
        assert ok and timg._dot_order(*shape) == ok[0], (shape, ok)
        assert shape in timg._XLA_DOT_ORDERS, shape


@functools.lru_cache(maxsize=None)
def _frame(name):
    jcam, _ = _cams(name)
    frames, _ = synthetic_scene.make_sequence(np.random.default_rng(42), jcam, num_frames=1)
    return frames[0][0]


@pytest.mark.parametrize("name", list(CAMERAS))
def test_orb_dataset_camera_exact(name):
    """8 levels at 1.2, the camera's keypoint count: slots, levels,
    angles and descriptors exactly equal at every level."""
    jcam, _ = _cams(name)
    img = _frame(name)
    H, W = jcam.rows, jcam.cols
    jo = jorb.OrbExtractor(H, W, _orb(name, jorb))(jnp.asarray(img))
    to = torb.OrbExtractor(H, W, _orb(name, torb))(torch.from_numpy(img))
    jo = {k: np.asarray(v) for k, v in jo.items()}
    to = {k: v.numpy() for k, v in to.items()}
    assert jo["valid"].sum() > 0.9 * CAMERAS[name][1]
    assert np.unique(jo["level"][jo["valid"]]).size == 8
    for k in ("xy", "level", "valid", "response", "angle"):
        np.testing.assert_array_equal(to[k], jo[k], err_msg=k)
    np.testing.assert_array_equal(to["desc"], jo["desc"].view(np.int32))


def _pairs(name, n, seed=0):
    """``n`` rectified pairs of chip_smoke.py phase 8's scene at the
    camera (the right view at ``t - [b, 0, 0]``) and the poses."""
    jcam, _ = _cams(name)
    b = jcam.focal_x_baseline / jcam.fx
    tex = synthetic_scene.make_texture(np.random.default_rng(seed))
    poses = synthetic_scene.trajectory(n)
    pairs = []
    for i, (R, t) in enumerate(poses):
        left, _ = synthetic_scene.render(jcam, tex, R, t, plane_half=PLANE_HALF)
        right, _ = synthetic_scene.render(jcam, tex, R, t - np.array([b, 0.0, 0.0]),
                                          plane_half=PLANE_HALF)
        pairs.append((left, right, float(i) / jcam.fps))
    return pairs, poses


def _T(a):
    a = np.array(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    elif a.dtype == np.int32:
        a = a.astype(np.int64)
    return torch.from_numpy(a)


@functools.lru_cache(maxsize=None)
def _stereo_case(name):
    """(JAX outputs, port inputs) of ``match_stereo`` on the camera's
    first pair, both packages given the JAX extractor's keypoints."""
    jcam, tcam = _cams(name)
    left, right, _ = _pairs(name, 1)[0][0]
    ext = jorb.OrbExtractor(jcam.rows, jcam.cols, _orb(name, jorb))
    fl, fr = ext(jnp.asarray(left)), ext(jnp.asarray(right))
    sf = jnp.asarray(_orb(name, jorb).scale_factors(), jnp.float32)
    xj, dj, okj = (np.asarray(a) for a in jstereo.match_stereo(
        jnp.asarray(left), jnp.asarray(right), fl["xy"], fl["level"],
        jmatching.unpack_desc_bits(fl["desc"]), fl["valid"], fr["xy"], fr["level"],
        jmatching.unpack_desc_bits(fr["desc"]), fr["valid"], sf,
        focal_x_baseline=jcam.focal_x_baseline))
    t = {k: _T(v) for k, v in (("lxy", fl["xy"]), ("llv", fl["level"]), ("ld", fl["desc"]),
                                ("lv", fl["valid"]), ("rxy", fr["xy"]), ("rlv", fr["level"]),
                                ("rd", fr["desc"]), ("rv", fr["valid"]))}
    args = (torch.from_numpy(left), torch.from_numpy(right), t["lxy"], t["llv"],
            tmatching.unpack_desc_bits(t["ld"]), t["lv"], t["rxy"], t["rlv"],
            tmatching.unpack_desc_bits(t["rd"]), t["rv"], _T(sf))
    return (xj, dj, okj), args, np.asarray(fl["xy"]), tcam.focal_x_baseline


@pytest.mark.parametrize("name", list(STEREO_CAMERAS))
def test_match_stereo(name):
    """On the CPU the port's ``x_right``, depth and ``ok`` are the JAX
    package's bit for bit."""
    (xj, dj, okj), args, lxy, fb = _stereo_case(name)
    xt, dt, okt = (a.numpy() for a in tstereo.match_stereo(*args, focal_x_baseline=fb))
    np.testing.assert_array_equal(okt, okj)
    np.testing.assert_array_equal(xt, xj)
    np.testing.assert_array_equal(dt, dj)
    assert okj.sum() > 0.3 * STEREO_CAMERAS[name][1]
    # The background plane at 6 m alone gives focal_x_baseline / 6: at
    # KITTI 64 px, against 52.5 px at most for 640x480's 0.1 m.
    disp = lxy[okj, 0] - xj[okj]
    assert disp.max() > fb / 8


@pytest.mark.parametrize("name", list(STEREO_CAMERAS))
def test_match_stereo_card_ops(name, monkeypatch):
    """The card's SAD sums (``torch.sum``, what ``linalg.tree_sum`` runs
    on a CUDA tensor) on the same CPU tensors: ``ok`` equal, ``xr`` within
    1e-3 px, depth within 1e-4 relative of the JAX package's."""
    (xj, dj, okj), args, _, fb = _stereo_case(name)
    monkeypatch.setattr(tlinalg, "tree_sum", lambda x, dim=-1: torch.sum(x, dim=dim))
    xt, dt, okt = (a.numpy() for a in tstereo.match_stereo(*args, focal_x_baseline=fb))
    np.testing.assert_array_equal(okt, okj)
    assert np.abs(xt - xj).max() < 1e-3
    assert (np.abs(dt - dj)[okj] / dj[okj]).max() < 1e-4


def test_dot_order_warns_once_for_unmeasured_shape(caplog):
    """A shape outside the table takes the default order and logs one
    warning for that shape, however often it is asked; a measured shape
    logs none."""
    shape = (77, 1237, 531)
    assert shape not in timg._XLA_DOT_ORDERS
    timg._UNMEASURED.discard(shape)
    with caplog.at_level(logging.WARNING, logger="plpslam"):
        for _ in range(3):
            assert timg._dot_order(*shape) == timg._DEFAULT_ORDER
        assert timg._dot_order(400, 480, 752) == timg._XLA_DOT_ORDERS[(400, 480, 752)]
    msgs = [r.getMessage() for r in caplog.records if "summation order" in r.getMessage()]
    assert len(msgs) == 1 and str(shape) in msgs[0], msgs


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


@pytest.mark.slow
@pytest.mark.parametrize("name", list(CAMERAS))
def test_stereo_system_matches_jax(name):
    """Both Systems on 6 pairs at the camera (tests/test_torch_stereo.py's
    System test at the dataset widths, 8 keyframes: the chain's local BA
    over 16 window cameras, which ``ops/ba_cpu`` computes as XLA:CPU does,
    ROADMAP C18): the same frames return a pose, every per-frame pose and
    the frame trajectory equal, equal keyframe and landmark counts, both
    TRACKING, and no shape outside ``ops/ba_cpu``'s tables."""
    jcam, tcam = _cams(name)
    pairs, _ = _pairs(name, 6)
    sizes = dict(max_keyframes=8, max_landmarks=8192, enable_loop_closing=False,
                 max_kf_interval=2)
    js = JSystem(JConfig(camera=jcam, orb=_orb(name, jorb), raw={}), **sizes)
    ts = System(Config(camera=tcam, orb=_orb(name, torb), raw={}), device="cpu", **sizes)
    jposes = _run(js, pairs)
    with ba_cpu.unmeasured_shapes() as met:
        tposes = _run(ts, pairs)
    for i, (a, b) in enumerate(zip(jposes, tposes)):
        assert (a is None) == (b is None), f"frame {i}: one System returned no pose"
        if a is None:
            continue
        assert np.array_equal(a, b), f"frame {i}: {np.abs(a - b).max():.2e}"
    tj, tt = js.frame_trajectory(), ts.frame_trajectory()
    assert len(tj) == len(tt)
    for (ta, pa), (tb, pb) in zip(tj, tt):
        assert ta == tb and np.array_equal(pa, pb)
    assert ts.num_keyframes == js.num_keyframes >= 2
    assert ts.num_landmarks == js.num_landmarks
    assert ts.tracking_state.value == js.tracking_state.value == "Tracking"
    assert not met, met


@pytest.mark.slow
@pytest.mark.parametrize("name,n", [("vga", 40), ("euroc", 24)])
def test_stereo_system_bit_equal_at_32_keyframes(name, n):
    """Both Systems on ``n`` pairs at the camera (the 640x480 main path's
    stereo camera, EuRoC's) with 32 keyframes, so that every keyframe
    chain's local BA has the 32-camera window of ``ops/ba_cpu``'s tables
    (ROADMAP C18): every frame's pose, the frame trajectory and every map
    field bit-equal."""
    jcam, tcam = _cams(name)
    pairs, _ = _pairs(name, n)
    sizes = dict(max_keyframes=32, max_landmarks=8192, enable_loop_closing=False,
                 max_kf_interval=2)
    js = JSystem(JConfig(camera=jcam, orb=_orb(name, jorb), raw={}), **sizes)
    ts = System(Config(camera=tcam, orb=_orb(name, torb), raw={}), device="cpu", **sizes)
    jposes, tposes = _run(js, pairs), _run(ts, pairs)
    for i, (a, b) in enumerate(zip(jposes, tposes)):
        assert (a is None) == (b is None), i
        assert a is None or np.array_equal(a, b), i
    jt, tt = js.frame_trajectory(), ts.frame_trajectory()
    assert len(jt) == len(tt) == n
    assert all(np.array_equal(np.asarray(a[1]), np.asarray(b[1])) for a, b in zip(jt, tt))
    for f in js.state._fields:
        a, b = np.asarray(getattr(js.state, f)), getattr(ts.state, f).numpy()
        assert np.array_equal(a.view(np.int32) if a.dtype == np.uint32 else a, b), f
    assert ts.num_keyframes == js.num_keyframes >= 10
