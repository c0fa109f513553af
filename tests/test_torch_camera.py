"""Port parity: the three camera models, their renderers and the fisheye
stereo rectifier.

The same numpy inputs (seeded) go through the JAX camera functions and
their counterparts in structure_plp_slam_tpu_torch.camera. Tolerances:

- fisheye undistortion (the 10-step Newton solve): 1e-4 px, or two
  float32 ulps of the coordinate where that is larger (beyond 512 px one
  ulp is 6.1e-5 px). XLA's tan and its x*x + y*y round differently from
  torch's in the last place on ~5% of the inputs; the Newton steps
  themselves use the products JAX lowers ``t2**n`` to;
- every other float output: rtol 1e-5, atol 1e-5 (same formulas, other
  op ordering);
- masks (``in_image``, ``cheirality``) and the module ``dispatch`` picks:
  exact; ``uv_residual``'s wrap, including du = ±cols/2 (round half to
  even in both packages): exact.

The port's renderers (testing/synthetic_scene.py, used by chip_smoke.py)
are held against tests/synthetic_scene.py's: the same pixels on >= 99.9%
of the image (a ray an ulp off can cross a texel edge) and the depth or
range within 1e-4 relative. The fisheye rectifier's maps are the same
numpy code in both packages (exact), its images within 1e-3 grey levels.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from structure_plp_slam_tpu.camera import Camera as JCamera
from structure_plp_slam_tpu.camera import CameraModel as JModel
from structure_plp_slam_tpu.camera import CameraSetup as JSetup
from structure_plp_slam_tpu.camera import base as jcam
from structure_plp_slam_tpu.camera import perspective as jpersp
from structure_plp_slam_tpu.ops import rectify as jrectify
from structure_plp_slam_tpu_torch.camera import Camera, CameraModel, CameraSetup
from structure_plp_slam_tpu_torch.camera import base as tcam
from structure_plp_slam_tpu_torch.camera import equirectangular as teq
from structure_plp_slam_tpu_torch.camera import fisheye as tfe
from structure_plp_slam_tpu_torch.camera import perspective as tpersp
from structure_plp_slam_tpu_torch.ops import rectify as trectify
from structure_plp_slam_tpu_torch.testing import synthetic_scene
from tests import synthetic_scene as jscene

torch.set_num_threads(2)

RTOL, ATOL = 1e-5, 1e-5
_KW = {
    "perspective": dict(cols=640, rows=480, fx=525.0, fy=520.0, cx=319.5, cy=239.5,
                        k1=-0.28, k2=0.07, p1=1e-4, p2=-2e-4),
    # tests/test_fisheye_system.py's camera scaled x2 (chip_smoke.py's).
    "fisheye": dict(cols=640, rows=480, fx=480.0, fy=480.0, cx=319.5, cy=239.5,
                    k1=-0.05, k2=0.01, k3=-0.003, k4=0.001, focal_x_baseline=48.0,
                    depth_threshold=400.0),
    "equirectangular": dict(cols=1024, rows=512),
}


def _cams(model, setup="rgbd", **over):
    kw = {"name": model, **_KW[model], **over}
    return (JCamera(setup=JSetup(setup), model=JModel(model), **kw),
            Camera(setup=CameraSetup(setup), model=CameraModel(model), **kw))


def _points(rng, model, n=400):
    """Camera-space points: in front of a pinhole camera, all around a
    spherical one (a few near the poles)."""
    if model == "equirectangular":
        pc = rng.normal(size=(n, 3)) * 4.0
        pc[:8, [0, 2]] *= 1e-3
        return pc.astype(np.float32)
    return np.stack([rng.uniform(-3, 3, n), rng.uniform(-2, 2, n),
                     rng.uniform(0.5, 10, n)], 1).astype(np.float32)


def _pixels(rng, cam, n=400):
    return np.stack([rng.uniform(0, cam.cols, n), rng.uniform(0, cam.rows, n)],
                    1).astype(np.float32)


def _close(a, b):
    np.testing.assert_allclose(np.asarray(b), np.asarray(a), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("model", list(_KW))
def test_camera_functions_match_jax(model):
    rng = np.random.default_rng(5)
    jc, tc = _cams(model)
    pc, kp = _points(rng, model), _pixels(rng, jc)
    if model != "fisheye":  # fisheye: test_fisheye_undistort_grid_matches_jax
        _close(jcam.undistort_keypoints(jc, jnp.asarray(kp)),
               tcam.undistort_keypoints(tc, torch.from_numpy(kp)))
    _close(jcam.bearings(jc, jnp.asarray(kp)), tcam.bearings(tc, torch.from_numpy(kp)))
    uv_j, d_j = jcam.project(jc, jnp.asarray(pc))
    uv_t, d_t = tcam.project(tc, torch.from_numpy(pc))
    _close(uv_j, uv_t)
    _close(d_j, d_t)
    _close(jcam.project_jacobian(jc, jnp.asarray(pc)),
           tcam.project_jacobian(tc, torch.from_numpy(pc)))
    for margin in (0.0, 5.0):
        assert (np.asarray(jcam.in_image(jc, uv_j, margin))
                == tcam.in_image(tc, uv_t, margin).numpy()).all()
    assert (np.asarray(jcam.cheirality(jc, jnp.asarray(pc)))
            == tcam.cheirality(tc, torch.from_numpy(pc)).numpy()).all()


@pytest.mark.parametrize("case", ["random", "test_stereo_reproject"])
def test_reproject_stereo_matches_jax(case):
    """``perspective.reproject_stereo`` (uv, right-image x, depth) on the
    same points in both packages, at RTOL / ATOL; the JAX test's point
    4 m ahead with fx * baseline = 40 gives a disparity of 10 px."""
    jc, tc = _cams("perspective", focal_x_baseline=40.0)
    if case == "random":
        pc = _points(np.random.default_rng(5), "perspective")
        pc[:4, 2] = [0.0, 1e-12, -1e-12, -2.0]  # the depth guard and a point behind
    else:
        pc = np.array([[0.5, 0.2, 4.0]], np.float32)
    jout = jpersp.reproject_stereo(jc, jnp.asarray(pc))
    tout = tpersp.reproject_stereo(tc, torch.from_numpy(pc))
    for a, b in zip(jout, tout, strict=True):
        _close(a, b)
    uv, xr, _ = (t.numpy() for t in tout)
    if case == "test_stereo_reproject":
        np.testing.assert_allclose(uv[0, 0] - xr[0], 40.0 / 4.0, rtol=1e-5)


def test_camera_cases_on_port():
    """tests/test_camera.py's cases on the port's functions: the pinhole
    project / bearing round trip, identity undistortion without
    distortion, undistortion against OpenCV, the equirectangular bearing
    / project round trip at 1024x512, the undistorted bounds without
    distortion and the dispatched undistortion's shape. Each case draws
    from a fresh seed-42 generator, as each of those tests does."""
    cv2 = pytest.importorskip("cv2")
    rng = np.random.default_rng(42)
    _, plain = _cams("perspective", k1=0.0, k2=0.0, p1=0.0, p2=0.0)
    pts = torch.from_numpy(np.stack([rng.uniform(-3, 3, 200), rng.uniform(-2, 2, 200),
                                     rng.uniform(2, 10, 200)], 1).astype(np.float32))
    uv, _ = tpersp.project(plain, pts)
    b = tpersp.bearings(plain, uv)
    np.testing.assert_allclose((b * (pts[:, 2] / b[:, 2])[:, None]).numpy(), pts.numpy(),
                               rtol=1e-4, atol=1e-3)
    rng = np.random.default_rng(42)
    kp = rng.uniform(0, 640, size=(50, 2)).astype(np.float32)
    np.testing.assert_allclose(tpersp.undistort_keypoints(plain, torch.from_numpy(kp)).numpy(),
                               kp, atol=1e-5)
    _, dist = _cams("perspective", k1=-0.28, k2=0.07, p1=1e-4, p2=-2e-4)
    rng = np.random.default_rng(42)
    kp = rng.uniform(40, 600, size=(100, 2)).astype(np.float32)
    kp[:, 1] = np.clip(kp[:, 1], 40, 440)
    K = np.array([[dist.fx, 0, dist.cx], [0, dist.fy, dist.cy], [0, 0, 1]])
    expected = cv2.undistortPoints(kp.reshape(-1, 1, 2), K,
                                   np.array([dist.k1, dist.k2, dist.p1, dist.p2, dist.k3]),
                                   P=K).reshape(-1, 2)
    np.testing.assert_allclose(tpersp.undistort_keypoints(dist, torch.from_numpy(kp)).numpy(),
                               expected, atol=0.05)
    _, eq = _cams("equirectangular", "monocular")
    rng = np.random.default_rng(42)
    kp = torch.from_numpy(np.stack([rng.uniform(0, 1024, 300), rng.uniform(1, 511, 300)],
                                   1).astype(np.float32))
    b = teq.bearings(eq, kp)
    np.testing.assert_allclose(torch.linalg.norm(b, dim=-1).numpy(), 1.0, atol=1e-5)
    np.testing.assert_allclose(teq.project(eq, b)[0].numpy(), kp.numpy(), atol=1e-2)
    assert plain.image_bounds() == (0.0, 640.0, 0.0, 480.0)
    assert tcam.undistort_keypoints(plain, torch.zeros((4, 2))).shape == (4, 2)


def test_dispatch_covers_every_model():
    expect = {"perspective": tpersp, "fisheye": tfe, "equirectangular": teq}
    for model, module in expect.items():
        jc, tc = _cams(model)
        assert tcam.dispatch(tc) is module
        assert jcam.dispatch(jc).__name__.rsplit(".", 1)[1] == module.__name__.rsplit(".", 1)[1]


def test_fisheye_undistort_grid_matches_jax():
    """Every pixel of the 640x480 fisheye image."""
    jc, tc = _cams("fisheye")
    ys, xs = np.mgrid[0:jc.rows, 0:jc.cols]
    pix = np.stack([xs.ravel(), ys.ravel()], 1).astype(np.float32)
    a = np.asarray(jcam.undistort_keypoints(jc, jnp.asarray(pix)))
    b = tcam.undistort_keypoints(tc, torch.from_numpy(pix)).numpy()
    tol = np.maximum(1e-4, 2 * np.spacing(np.abs(a).astype(np.float32)))
    assert (np.abs(a - b) <= tol).all(), np.abs(a - b).max()


def test_fisheye_undistort_inverts_distortion():
    """Pixels distorted by the Kannala-Brandt model come back to their
    pinhole positions."""
    _, tc = _cams("fisheye")
    rng = np.random.default_rng(6)
    xy = rng.uniform(-0.6, 0.6, size=(200, 2))
    r = np.linalg.norm(xy, axis=1)
    th = np.arctan(r)
    th_d = th * (1 + tc.k1 * th**2 + tc.k2 * th**4 + tc.k3 * th**6 + tc.k4 * th**8)
    dist = xy * (th_d / r)[:, None]
    pix = (dist * [tc.fx, tc.fy] + [tc.cx, tc.cy]).astype(np.float32)
    und = tcam.undistort_keypoints(tc, torch.from_numpy(pix)).numpy()
    np.testing.assert_allclose(und, xy * [tc.fx, tc.fy] + [tc.cx, tc.cy], atol=2e-3)


def test_image_bounds_match_jax():
    for model in _KW:
        jc, tc = _cams(model)
        np.testing.assert_allclose(tc.image_bounds(), jc.image_bounds(), atol=1e-3)
    jc, tc = _cams("fisheye")
    assert tc.image_bounds()[0] < 0.0 and tc.image_bounds()[1] > tc.cols  # barrel: wider
    _, tc = _cams("fisheye", k1=0.0, k2=0.0, k3=0.0, k4=0.0)
    assert tc.image_bounds() == (0.0, 640.0, 0.0, 480.0)


def test_equirect_project_bearing_roundtrip():
    _, tc = _cams("equirectangular", "monocular")
    rng = np.random.default_rng(3)
    pc = torch.from_numpy((rng.normal(size=(256, 3)) * 4.0).astype(np.float32))
    uv, rng_norm = teq.project(tc, pc)
    b = teq.bearings(tc, uv)
    np.testing.assert_allclose((b * rng_norm[:, None]).numpy(), pc.numpy(), atol=2e-3)


def test_equirect_jacobian_matches_finite_difference():
    """tests/test_equirect_system.py's check on the port: central
    differences through the wrapped residual, away from the poles."""
    _, tc = _cams("equirectangular", "monocular", cols=512, rows=256)
    rng = np.random.default_rng(4)
    pc = rng.normal(size=(64, 3)) * 3.0
    pc = pc[np.abs(pc[:, 0] ** 2 + pc[:, 2] ** 2) > 0.5]
    J = teq.project_jacobian(tc, torch.from_numpy(pc.astype(np.float32))).numpy()
    eps = 1e-3
    for k in range(3):
        dp = np.zeros(3)
        dp[k] = eps
        up, _ = teq.project(tc, torch.from_numpy((pc + dp).astype(np.float32)))
        um, _ = teq.project(tc, torch.from_numpy((pc - dp).astype(np.float32)))
        fd = tcam.uv_residual(tc, up, um).numpy() / (2 * eps)
        np.testing.assert_allclose(J[:, :, k], fd, atol=0.1)


def test_uv_residual_wraps_like_jax():
    """tests/test_equirect_system.py's seam case, du of exactly ±cols/2
    (both round half to even), multiples of cols, and random pairs across
    the seam; the pinhole models never wrap."""
    jc, tc = _cams("equirectangular", "monocular", cols=512, rows=256)
    pred = np.array([[2.0, 50.0], [256.0, 10.0], [0.0, 10.0], [768.0, 3.0], [100.0, 7.0],
                     [-256.0, 1.0], [1024.0, 2.0], [511.5, 9.0]], np.float32)
    obs = np.array([[510.0, 50.0], [0.0, 10.0], [256.0, 10.0], [0.0, 3.0], [612.0, 7.0],
                    [0.0, 1.0], [0.0, 2.0], [0.25, 9.0]], np.float32)
    rng = np.random.default_rng(8)
    pred = np.concatenate([pred, rng.uniform(-20, 20, (64, 2)).astype(np.float32) % 512])
    obs = np.concatenate([obs, rng.uniform(-20, 20, (64, 2)).astype(np.float32) % 512])
    rj = np.asarray(jcam.uv_residual(jc, jnp.asarray(pred), jnp.asarray(obs)))
    rt = tcam.uv_residual(tc, torch.from_numpy(pred), torch.from_numpy(obs)).numpy()
    assert (rj == rt).all()
    assert abs(rt[0, 0] - 4.0) < 1e-4 and abs(rt[0, 1]) < 1e-6  # 2 - 510 wraps to +4
    assert rt[1, 0] == 256.0 and rt[2, 0] == -256.0  # ±cols/2: half to even (0)
    assert (np.abs(rt[:, 0]) <= 256.0).all()
    for model in ("perspective", "fisheye"):
        _, tc = _cams(model)
        assert (tcam.uv_residual(tc, torch.from_numpy(pred), torch.from_numpy(obs)).numpy()
                == pred - obs).all()


def test_cheirality_gates():
    """Positive z for the pinhole models, any direction but the centre for
    the sphere."""
    pc = np.array([[0, 0, 1], [0, 0, -1], [1, 0, 0], [0, 0, 1e-7], [0, 0, 0],
                   [1e-7, 0, 0], [0, -2, -3]], np.float32)
    for model, expect in (("perspective", [1, 0, 0, 0, 0, 0, 0]),
                          ("fisheye", [1, 0, 0, 0, 0, 0, 0]),
                          ("equirectangular", [1, 1, 1, 0, 0, 0, 1])):
        jc, tc = _cams(model)
        got = tcam.cheirality(tc, torch.from_numpy(pc)).numpy()
        assert (got == np.asarray(jcam.cheirality(jc, jnp.asarray(pc)))).all()
        assert (got == np.array(expect, bool)).all(), (model, got)


def test_renderers_match_jax_helpers():
    """The port's fisheye and equirectangular renderers against
    tests/synthetic_scene.py's, on the JAX system tests' cameras."""
    rng = np.random.default_rng(0)
    tex = synthetic_scene.make_texture(rng)
    poses = synthetic_scene.trajectory(3, step=0.09)
    jf, tf = _cams("fisheye", cols=320, rows=240, fx=240.0, fy=240.0, cx=159.5, cy=119.5)
    je, te = _cams("equirectangular", "monocular", cols=512, rows=256)
    for R, t in poses:
        for render_j, render_t, jc, tc in (
                (jscene.render_fisheye, synthetic_scene.render_fisheye, jf, tf),
                (jscene.render_equirect, synthetic_scene.render_equirect, je, te)):
            img_j, d_j = render_j(jc, tex, R, t)
            img_t, d_t = render_t(tc, tex, R, t)
            assert (img_j == img_t).mean() >= 0.999
            np.testing.assert_allclose(d_t, d_j, rtol=1e-4)


def _fisheye_rectifier_raw():
    """A fisheye stereo rig: each raw camera turned 0.02 rad about y from
    the rectified frame, Kannala-Brandt k1..k4 per side."""
    def rot(th):
        return np.array([[np.cos(th), 0, np.sin(th)], [0, 1, 0], [-np.sin(th), 0, np.cos(th)]])

    K_raw = np.array([[250.0, 0, 161.0], [0, 249.0, 118.0], [0, 0, 1.0]])
    return {
        "StereoRectifier.model": "fisheye",
        "StereoRectifier.K_left": K_raw, "StereoRectifier.K_right": K_raw.copy(),
        "StereoRectifier.D_left": [-0.05, 0.01, -0.003, 0.001],
        "StereoRectifier.D_right": [-0.04, 0.008, -0.002, 0.0005],
        "StereoRectifier.R_left": rot(0.02), "StereoRectifier.R_right": rot(-0.02),
    }


def test_fisheye_rectifier_matches_jax():
    """StereoRectifier built from a fisheye node (``StereoRectifier.model:
    fisheye``, the cv::fisheye maps) in both packages; the raw pair comes
    from the port's fisheye renderer."""
    kw = dict(name="rect", cols=320, rows=240, fx=240.0, fy=240.0, cx=159.5, cy=119.5,
              fps=30.0, focal_x_baseline=24.0, depth_threshold=40.0)
    jc = JCamera(setup=JSetup.STEREO, model=JModel.PERSPECTIVE, **kw)
    tc = Camera(setup=CameraSetup.STEREO, model=CameraModel.PERSPECTIVE, **kw)
    raw = _fisheye_rectifier_raw()
    rj = jrectify.StereoRectifier(jc, raw)
    rt = trectify.StereoRectifier(tc, raw, device="cpu")
    for a, b in ((rj.my_l, rt.my_l), (rj.mx_l, rt.mx_l), (rj.my_r, rt.my_r),
                 (rj.mx_r, rt.mx_r)):
        assert np.abs(np.asarray(a) - b.numpy()).max() <= 1e-3
    _, fe = _cams("fisheye", cols=320, rows=240, fx=250.0, fy=249.0, cx=161.0, cy=118.0,
                  k1=-0.05, k2=0.01, k3=-0.003, k4=0.001)
    tex = synthetic_scene.make_texture(np.random.default_rng(2))
    left, _ = synthetic_scene.render_fisheye(fe, tex, np.eye(3), np.zeros(3))
    right, _ = synthetic_scene.render_fisheye(fe, tex, np.eye(3), np.array([-0.1, 0.0, 0.0]))
    lj, rjj = rj(left, right)
    lt, rtt = rt(left, right)
    assert np.abs(lt.numpy() - np.asarray(lj)).max() < 1e-3
    assert np.abs(rtt.numpy() - np.asarray(rjj)).max() < 1e-3
    assert ((np.asarray(lj) == 0) == (lt.numpy() == 0)).all()
    # The fisheye maps differ from the perspective ones on the same node.
    persp = trectify.StereoRectifier(tc, {**raw, "StereoRectifier.model": "perspective"},
                                     device="cpu")
    assert np.abs(persp.mx_l.numpy() - rt.mx_l.numpy()).max() > 1.0
