"""Port parity: image ops, ORB extraction and the RGB-D frontend.

One 320x240 frame of tests/synthetic_scene.make_sequence goes through the
JAX package and the port. Measured on this frame (seed 42): the keypoint
slots are identical at every level, descriptors are identical at level 0
and on 99.5% of all keypoints (the mismatches sit at levels 1 and 3).
Level 0 is the input image itself; higher levels come from a float
resize (an f32 matmul, 3e-5 apart between the runtimes) and every IC
angle from f32 prefix sums summed in another order (<= 4e-4 rad apart),
which moves a few rotated BRIEF samples by one pixel.
"""

import numpy as np
import pytest
import torch

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
    img, _ = frame
    ja = np.asarray(_atlas(jimg, img, jnp.asarray))
    ta = _atlas(timg, img, torch.from_numpy).numpy()
    # atol 1e-3: the resize is an f32 matmul summed in another order.
    np.testing.assert_allclose(ta, ja, rtol=0, atol=1e-3)
    np.testing.assert_array_equal(ta[:240, :320], ja[:240, :320])  # level 0 = the image


def test_gaussian_blur(frame):
    img, _ = frame
    ja = np.array(_atlas(jimg, img, jnp.asarray))
    jb = np.asarray(jimg.gaussian_blur(jnp.asarray(ja)))
    tb = timg.gaussian_blur(torch.from_numpy(ja)).numpy()
    np.testing.assert_allclose(tb, jb, rtol=0, atol=1e-3)


def test_orb_level0_exact(orb_pair):
    jo, to = orb_pair
    lv0 = jo["level"] == 0
    assert lv0.sum() > 100
    for k in ("xy", "level", "valid", "response"):
        np.testing.assert_array_equal(to[k][lv0], jo[k][lv0], err_msg=k)
    np.testing.assert_array_equal(to["desc"][lv0], jo["desc"][lv0].view(np.int32))


def test_orb_pyramid_99_percent(orb_pair):
    jo, to = orb_pair
    same = np.all(to["xy"] == jo["xy"], 1) & (to["valid"] == jo["valid"])
    assert same.mean() >= 0.99, f"identical keypoint slots {same.mean():.4f}"
    common = same & jo["valid"]
    desc_eq = np.all(to["desc"] == jo["desc"].view(np.int32), 1)[common]
    # Measured 0.9951 on this frame (module docstring).
    assert desc_eq.mean() >= 0.99, f"identical descriptors {desc_eq.mean():.4f}"
    np.testing.assert_allclose(to["angle"][common], jo["angle"][common], atol=1e-3)


def test_rgbd_frontend_depth_exact(frame):
    img, depth = frame
    cap = jorb.OrbExtractor(240, 320, jorb.OrbParams(**ORB)).capacity
    jr = jfront.Frontend(JCAM, jorb.OrbParams(**ORB), pad_to=cap).rgbd(img, depth)
    tr = tfront.Frontend(TCAM, torb.OrbParams(**ORB), pad_to=cap, device="cpu").rgbd(img, depth)
    jr = {k: np.asarray(v) for k, v in jr.items()}
    tr = {k: v.numpy() for k, v in tr.items()}
    common = np.all(jr["xy"] == tr["xy"], 1) & jr["valid"] & tr["valid"]
    assert common.mean() >= 0.99
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
    assert same.mean() >= 0.99, same.mean()
    np.testing.assert_array_equal(tr["xr"], jr["xr"])
    np.testing.assert_array_equal(tr["depth"], jr["depth"])
    np.testing.assert_array_equal(tr["level"], jr["level"])


def _fma_chains(X, Y, lanes=1):
    """``X @ Y`` in f32 with one fused multiply-add chain per accumulator,
    k assigned to accumulator k % lanes, the accumulators added in order
    (numpy; a product of two f32 is exact in f64, so one f64 add rounded
    to f32 is an FMA)."""
    acc = np.zeros((lanes, X.shape[0], Y.shape[1]), np.float32)
    for k in range(X.shape[1]):
        rows = X[:, k] != 0
        if rows.any():
            a = acc[k % lanes]
            a[rows] = (a[rows].astype(np.float64)
                       + X[rows, k, None].astype(np.float64) * Y[k][None, :]).astype(np.float32)
    return acc.sum(axis=0, dtype=np.float32) if lanes > 1 else acc[0]


@pytest.mark.slow
def test_resize_summation_order():
    """ROADMAP C17, the evidence: which f32 summation order gives XLA:CPU's
    ``(A @ img) @ B.T`` of the pyramid resize, bit for bit, on a random
    640x480 frame. The first product is one FMA chain in increasing k at
    every level. The second is one FMA chain with two accumulators (even
    and odd k) at levels 1 and 6, close to a single chain at levels 2-4
    and 7, and neither at level 5: no one order reproduces every level,
    so the port keeps its matmul (printed: the share of equal pixels)."""
    rng = np.random.default_rng(0)
    img = rng.uniform(0, 255, (480, 640)).astype(np.float32)
    shares = {}
    for lv, (h, w) in enumerate(jimg.pyramid_shapes(480, 640, 8, 1.2)[1:], start=1):
        ref = np.asarray(jimg.resize_bilinear(jnp.asarray(img), (h, w)))
        A = timg._resize_matrix(480, h)
        B = np.ascontiguousarray(timg._resize_matrix(640, w).T)
        first = np.asarray(jnp.asarray(A) @ jnp.asarray(img))
        chain = _fma_chains(A, img)
        assert (chain == first).all(), lv
        port = timg.resize_bilinear(torch.from_numpy(img), (h, w)).numpy()
        shares[lv] = {"torch": float((port == ref).mean())}
        for lanes in (1, 2):
            shares[lv][f"fma x{lanes}"] = float((_fma_chains(chain, B, lanes) == ref).mean())
    print(shares)
    assert shares[1]["fma x2"] == shares[6]["fma x2"] == 1.0
    assert all(shares[lv]["fma x1"] > 0.99 for lv in (2, 3, 4, 7))
    assert max(shares[5].values()) < 1.0
