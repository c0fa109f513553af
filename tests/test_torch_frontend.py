"""Port parity: image ops, ORB extraction and the RGB-D frontend.

One 320x240 frame of tests/synthetic_scene.make_sequence goes through the
JAX package and the port, and 640x480 frames at 8 levels with 1000
keypoints (seeds 42 and 7). The atlas, keypoint slots, angles and
descriptors are exactly equal (ROADMAP C8, closed): the port sums every
f32 reduction in XLA:CPU's order and calls glibc's f32 trigonometry on
the CPU.

- The resize: XLA:CPU's ``(A @ img) @ B.T`` sums each output's few
  nonzero taps in an order YNNPACK picks per dot shape; the port keeps
  those orders in a table (``ops/image.py``'s ``_XLA_DOT_ORDERS``,
  regenerated by ``python -m tests.xla_dot_orders``), held against XLA
  entry by entry here.
- The IC moment maps: blocked prefix sums (``prng.cumsum_xla``) along
  either axis; in the jitted extractor every ``acc + d * diff`` is one
  fused multiply-add.
- The BRIEF blur: in the jitted extractor both passes are fused
  multiply-add chains.
- ``atan2``, ``cos`` and ``sin`` at the keypoints: glibc's ``atan2f``,
  ``cosf`` and ``sinf``, which XLA:CPU computes.

The equality holds with 2 and with 3 torch threads.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from structure_plp_slam_tpu.camera import Camera as JCamera
from structure_plp_slam_tpu.camera import CameraModel as JModel
from structure_plp_slam_tpu.camera import CameraSetup as JSetup
from structure_plp_slam_tpu.models import frontend as jfront
from structure_plp_slam_tpu.ops import image as jimg
from structure_plp_slam_tpu.ops import orb as jorb
from structure_plp_slam_tpu_torch.camera import Camera, CameraModel, CameraSetup
from structure_plp_slam_tpu_torch.models import frontend as tfront
from structure_plp_slam_tpu_torch.ops import image as timg
from structure_plp_slam_tpu_torch.ops import orb as torb
from structure_plp_slam_tpu_torch.testing import synthetic_scene as tscene
from tests import synthetic_scene

torch.set_num_threads(2)

_KW = dict(name="synt", cols=320, rows=240, fx=260.0, fy=260.0, cx=159.5, cy=119.5,
           fps=30.0, focal_x_baseline=26.0, depth_threshold=400.0, depthmap_factor=1.0)
JCAM = JCamera(setup=JSetup.RGBD, model=JModel.PERSPECTIVE, **_KW)
TCAM = Camera(setup=CameraSetup.RGBD, model=CameraModel.PERSPECTIVE, **_KW)
ORB = dict(max_num_keypts=600, num_levels=4)


@pytest.fixture(scope="module")
def frame():
    frames, _ = synthetic_scene.make_sequence(np.random.default_rng(42), JCAM, num_frames=1)
    img, depth, _ = frames[0]
    return img, depth


@pytest.fixture(scope="module")
def orb_pair(frame):
    img, _ = frame
    jo = jorb.OrbExtractor(240, 320, jorb.OrbParams(**ORB))(jnp.asarray(img))
    to = torb.OrbExtractor(240, 320, torb.OrbParams(**ORB))(torch.from_numpy(img))
    return ({k: np.asarray(v) for k, v in jo.items()}, {k: v.numpy() for k, v in to.items()})


def _atlas(mod, img, to_arr):
    shapes = mod.pyramid_shapes(240, 320, 4, 1.2)
    offs, H, W = mod.atlas_layout(shapes)
    return mod.build_atlas(to_arr(img), shapes, offs, H, W)


def test_build_atlas(frame):
    """Every level exactly equal, eager and under ``jax.jit`` (the
    extractor builds its atlas inside its jitted pass)."""
    img, _ = frame
    shapes = jimg.pyramid_shapes(240, 320, 4, 1.2)
    offs, H, W = jimg.atlas_layout(shapes)
    ja = np.asarray(_atlas(jimg, img, jnp.asarray))
    jj = np.asarray(jax.jit(lambda x: jimg.build_atlas(x, shapes, offs, H, W))(jnp.asarray(img)))
    ta = _atlas(timg, img, torch.from_numpy).numpy()
    np.testing.assert_array_equal(ta, ja)
    np.testing.assert_array_equal(ta, jj)


def test_gaussian_blur(frame):
    img, _ = frame
    ja = np.array(_atlas(jimg, img, jnp.asarray))
    jb = np.asarray(jimg.gaussian_blur(jnp.asarray(ja)))
    tb = timg.gaussian_blur(torch.from_numpy(ja)).numpy()
    np.testing.assert_array_equal(tb, jb)


def test_orb_level0_exact(orb_pair):
    jo, to = orb_pair
    lv0 = jo["level"] == 0
    assert lv0.sum() > 100
    for k in ("xy", "level", "valid", "response"):
        np.testing.assert_array_equal(to[k][lv0], jo[k][lv0], err_msg=k)
    np.testing.assert_array_equal(to["desc"][lv0], jo["desc"][lv0].view(np.int32))


def _assert_orb_equal(jo, to):
    """Keypoint slots, angles and descriptors exactly equal."""
    for k in ("xy", "level", "valid", "response", "angle"):
        np.testing.assert_array_equal(to[k], jo[k], err_msg=k)
    np.testing.assert_array_equal(to["desc"], jo["desc"].view(np.int32))


def test_orb_pyramid_99_percent(orb_pair):
    """Every level, not just level 0: slots, angles and descriptors equal."""
    jo, to = orb_pair
    assert jo["valid"].sum() > 300
    _assert_orb_equal(jo, to)


_CAM640 = dict(_KW, cols=640, rows=480, fx=520.0, fy=520.0, cx=319.5, cy=239.5)


@pytest.mark.parametrize("seed", [42, 7])
def test_orb_640_8_levels_exact(seed):
    """640x480, 8 levels, 1000 keypoints: slots, angles and descriptors
    exactly equal at every level."""
    cam = JCamera(setup=JSetup.RGBD, model=JModel.PERSPECTIVE, **_CAM640)
    frames, _ = synthetic_scene.make_sequence(np.random.default_rng(seed), cam, num_frames=1)
    img = frames[0][0]
    orb = dict(max_num_keypts=1000, num_levels=8)
    jo = jorb.OrbExtractor(480, 640, jorb.OrbParams(**orb))(jnp.asarray(img))
    to = torb.OrbExtractor(480, 640, torb.OrbParams(**orb))(torch.from_numpy(img))
    jo = {k: np.asarray(v) for k, v in jo.items()}
    assert jo["valid"].sum() > 900 and np.unique(jo["level"][jo["valid"]]).size == 8
    _assert_orb_equal(jo, {k: v.numpy() for k, v in to.items()})


@pytest.mark.parametrize("threads", [2, 3])
def test_orb_exact_across_threads(frame, orb_pair, threads):
    """The port's result does not follow the torch thread count."""
    img, _ = frame
    jo, _ = orb_pair
    before = torch.get_num_threads()
    torch.set_num_threads(threads)
    try:
        to = torb.OrbExtractor(240, 320, torb.OrbParams(**ORB))(torch.from_numpy(img))
    finally:
        torch.set_num_threads(before)
    _assert_orb_equal(jo, {k: v.numpy() for k, v in to.items()})


def test_rgbd_frontend_depth_exact(frame):
    img, depth = frame
    cap = jorb.OrbExtractor(240, 320, jorb.OrbParams(**ORB)).capacity
    jr = jfront.Frontend(JCAM, jorb.OrbParams(**ORB), pad_to=cap).rgbd(img, depth)
    tr = tfront.Frontend(TCAM, torb.OrbParams(**ORB), pad_to=cap, device="cpu").rgbd(img, depth)
    jr = {k: np.asarray(v) for k, v in jr.items()}
    tr = {k: v.numpy() for k, v in tr.items()}
    common = np.all(jr["xy"] == tr["xy"], 1) & jr["valid"] & tr["valid"]
    np.testing.assert_array_equal(tr["valid"], jr["valid"])
    assert common.sum() == jr["valid"].sum()
    np.testing.assert_array_equal(tr["depth"][common], jr["depth"][common])
    np.testing.assert_array_equal(tr["xr"][common], jr["xr"][common])
    np.testing.assert_allclose(tr["bearing"], jr["bearing"], rtol=0, atol=1e-6)


def test_port_renderer_matches_test_helper():
    """The port's copy of the renderer (used by chip_smoke.py and
    tests/test_torch_system.py) against tests/synthetic_scene.py."""
    jf, jp = synthetic_scene.make_sequence(np.random.default_rng(0), JCAM, num_frames=3)
    tf, tp = tscene.make_sequence(np.random.default_rng(0), TCAM, num_frames=3)
    for (ji, jd, jt), (ti, td, tt) in zip(jf, tf):
        assert jt == tt
        # atol 1e-2 grey levels: the texture blur sums f32 in another order.
        np.testing.assert_allclose(ti, ji, rtol=0, atol=1e-2)
        np.testing.assert_allclose(td, jd, rtol=1e-6, atol=1e-6)
    for (jR, jt), (tR, tt) in zip(jp, tp):
        np.testing.assert_allclose(tR, jR, rtol=0, atol=1e-6)
        np.testing.assert_allclose(tt, jt, rtol=0, atol=1e-6)


def test_mono_frontend_with_mask(frame):
    """``Frontend.mono`` (the shared ``_base`` without depth) under an
    extraction mask that drops the left third of the image."""
    img, _ = frame
    mask = np.ones_like(img, dtype=np.uint8)
    mask[:, :100] = 0
    cap = jorb.OrbExtractor(240, 320, jorb.OrbParams(**ORB)).capacity
    jcam = JCamera(setup=JSetup.MONOCULAR, model=JModel.PERSPECTIVE, **_KW)
    tcam = Camera(setup=CameraSetup.MONOCULAR, model=CameraModel.PERSPECTIVE, **_KW)
    jr = jfront.Frontend(jcam, jorb.OrbParams(**ORB), pad_to=cap).mono(img, mask=mask)
    tr = tfront.Frontend(tcam, torb.OrbParams(**ORB), pad_to=cap, device="cpu").mono(
        img, mask=mask)
    jr = {k: np.asarray(v) for k, v in jr.items()}
    tr = {k: v.numpy() for k, v in tr.items()}
    assert set(tr) <= set(jr)
    assert not (tr["valid"] & (tr["xy"][:, 0] < 100)).any()
    same = np.all(jr["xy"] == tr["xy"], 1) & (jr["valid"] == tr["valid"])
    assert same.all(), same.mean()
    np.testing.assert_array_equal(tr["xr"], jr["xr"])
    np.testing.assert_array_equal(tr["depth"], jr["depth"])
    np.testing.assert_array_equal(tr["level"], jr["level"])


def _resize_cases():
    """Every resize but the dataset cameras' (held in
    tests/test_torch_dataset_cameras.py)."""
    from tests import xla_dot_orders
    dataset = set(xla_dot_orders.resize_shapes(xla_dot_orders.DATASET_PYRAMIDS,
                                               xla_dot_orders.DATASET_HALVES))
    return [c for c in xla_dot_orders.resize_shapes() if c not in dataset]


@pytest.mark.parametrize("src,dst", _resize_cases(),
                         ids=[f"{s[1]}x{s[0]}-{d[1]}x{d[0]}" for s, d in _resize_cases()])
def test_resize_summation_order(src, dst):
    """ROADMAP C8/C17: XLA:CPU's ``(A @ img) @ B.T`` bit for bit on a random
    frame, for every resize the port's pyramids and line passes run. Each
    product's order comes from ``ops/image.py``'s table (or its default);
    the first candidate order of tests/xla_dot_orders.py that matches
    XLA must be the one the port uses."""
    from tests import xla_dot_orders

    img = np.random.default_rng(0).uniform(0, 255, src).astype(np.float32)
    _, ref = xla_dot_orders.xla_products(img, dst)
    port = timg.resize_bilinear(torch.from_numpy(img), dst).numpy()
    np.testing.assert_array_equal(port, ref)
    for shape, ok in xla_dot_orders.matching_orders(img, dst):
        assert ok and timg._dot_order(*shape) == ok[0], (shape, ok)
