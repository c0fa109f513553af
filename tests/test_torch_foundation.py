"""Port parity: Lie, linear-algebra, robust-cost and perspective-camera ops.

The same numpy inputs (seeded) go through the JAX function and its
counterpart in structure_plp_slam_tpu_torch; float32 outputs must agree
within rtol 1e-5 / atol 1e-6 (same formulas, different op ordering in the
two runtimes).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from structure_plp_slam_tpu.camera import Camera as JCamera
from structure_plp_slam_tpu.camera import CameraModel as JModel
from structure_plp_slam_tpu.camera import CameraSetup as JSetup
from structure_plp_slam_tpu.camera import base as jcam
from structure_plp_slam_tpu.io import trajectory as jtraj
from structure_plp_slam_tpu.ops import hamming as jham
from structure_plp_slam_tpu.ops import lie as jlie
from structure_plp_slam_tpu.ops import linalg as jlinalg
from structure_plp_slam_tpu.ops import robust as jrobust
from structure_plp_slam_tpu.ops import triangulation as jtri
from structure_plp_slam_tpu.utils import types as jtypes
from structure_plp_slam_tpu_torch.camera import Camera, CameraModel, CameraSetup
from structure_plp_slam_tpu_torch.camera import base as tcam
from structure_plp_slam_tpu_torch.io import trajectory as ttraj
from structure_plp_slam_tpu_torch.ops import hamming as tham
from structure_plp_slam_tpu_torch.ops import lie as tlie
from structure_plp_slam_tpu_torch.ops import linalg as tlinalg
from structure_plp_slam_tpu_torch.ops import robust as trobust
from structure_plp_slam_tpu_torch.ops import triangulation as ttri
from structure_plp_slam_tpu_torch.utils import types as ttypes

torch.set_num_threads(2)

RTOL, ATOL = 1e-5, 1e-6

_CAM_KW = dict(name="t", cols=640, rows=480, fx=525.0, fy=520.0, cx=319.5,
               cy=239.5, k1=0.1, k2=-0.05, p1=0.001, p2=-0.002, k3=0.01,
               focal_x_baseline=40.0)
JCAM = JCamera(setup=JSetup.RGBD, model=JModel.PERSPECTIVE, **_CAM_KW)
TCAM = Camera(setup=CameraSetup.RGBD, model=CameraModel.PERSPECTIVE, **_CAM_KW)


def _spd(rng, n, batch=16):
    A = rng.normal(size=(batch, n, n))
    return (A @ np.swapaxes(A, -1, -2) + n * np.eye(n)).astype(np.float32)


def _rot(rng, batch=32):
    phi = rng.normal(scale=0.8, size=(batch, 3)).astype(np.float32)
    return np.asarray(jlie.so3_exp(jnp.asarray(phi)))


def _cases(rng):
    phi = rng.normal(scale=0.8, size=(32, 3)).astype(np.float32)
    phi[:4] *= 1e-6  # Taylor branches
    xi = rng.normal(scale=0.5, size=(32, 6)).astype(np.float32)
    R = _rot(rng)
    t = rng.normal(size=(32, 3)).astype(np.float32)
    pts = rng.normal(size=(32, 5, 3)).astype(np.float32)
    H6 = _spd(rng, 6)
    b6 = rng.normal(size=(16, 6)).astype(np.float32)
    H3 = _spd(rng, 3)
    S = _spd(rng, 24, batch=2)
    r24 = rng.normal(size=(2, 24)).astype(np.float32)
    chi2 = rng.uniform(0, 20, size=(64,)).astype(np.float32)
    pc = np.concatenate(
        [rng.uniform(-2, 2, (64, 2)), rng.uniform(0.5, 8, (64, 1))], -1
    ).astype(np.float32)
    kp = np.stack([rng.uniform(0, 640, 64), rng.uniform(0, 480, 64)], -1).astype(np.float32)
    res2 = rng.normal(size=(64, 2)).astype(np.float32)
    res3 = rng.normal(size=(64, 3)).astype(np.float32)
    info = rng.uniform(0.2, 1.0, 64).astype(np.float32)
    pc_signed = pc * np.where(rng.uniform(size=(64, 1)) < 0.3, -1.0, 1.0).astype(np.float32)
    # Two-view geometry: points 2-8 m ahead of camera 1 at the origin,
    # camera 2 moved 0.3 m sideways with a small rotation.
    X = np.concatenate([rng.uniform(-2, 2, (64, 2)), rng.uniform(2, 8, (64, 1))], -1)
    R2 = np.asarray(jlie.so3_exp(jnp.asarray([[0.0, 0.05, 0.01]], jnp.float32)))[0]
    t2 = np.array([-0.3, 0.02, 0.05], np.float32)
    b1 = X / np.linalg.norm(X, axis=-1, keepdims=True)
    X2 = X @ R2.T + t2
    b2 = X2 / np.linalg.norm(X2, axis=-1, keepdims=True)
    b1, b2 = b1.astype(np.float32), b2.astype(np.float32)
    eye3, zero3 = np.eye(3, dtype=np.float32), np.zeros(3, np.float32)
    vals = rng.integers(0, 20, (16, 40)).astype(np.float32)  # ties are common
    mask = rng.uniform(size=(16, 40)) < 0.7
    mask[0] = False  # a row with no valid entry
    return {
        "so3_exp": (lambda m: m.so3_exp, (phi,)),
        "so3_log": (lambda m: m.so3_log, (R,)),
        "so3_left_jacobian": (lambda m: m.so3_left_jacobian, (phi,)),
        "se3_exp": (lambda m: m.se3_exp, (xi,)),
        "se3_log": (lambda m: m.se3_log, (R, t)),
        "se3_update": (lambda m: m.se3_update, (R, t, xi)),
        "se3_apply": (lambda m: m.se3_apply, (R, t, pts)),
        "se3_inverse": (lambda m: m.se3_inverse, (R, t)),
        "quat_from_rotmat": (lambda m: m.quat_from_rotmat, (R,)),
        "orthonormalize": (lambda m: m.orthonormalize, (R * 1.001,)),
        "clamp_tangent": (lambda m: m.clamp_tangent, (xi * 4.0,)),
        "inv3x3": (lambda m: m.inv3x3, (H3,)),
        "inv6x6_spd": (lambda m: m.inv6x6_spd, (H6,)),
        "solve6_spd": (lambda m: m.solve6_spd, (H6, b6)),
        "spd_solve": (lambda m: m.spd_solve, (S, r24)),
        "huber_weight": (lambda m: (lambda c: m.huber_weight(c, 5.991)), (chi2,)),
        "project": (lambda m: (lambda p: m.project(CAM[m], p)), (pc,)),
        "project_jacobian": (lambda m: (lambda p: m.project_jacobian(CAM[m], p)), (pc,)),
        "undistort_keypoints": (lambda m: (lambda k: m.undistort_keypoints(CAM[m], k)), (kp,)),
        "bearings": (lambda m: (lambda k: m.bearings(CAM[m], k)), (kp,)),
        "in_image": (lambda m: (lambda p: m.in_image(CAM[m], p * 100.0, 5.0)), (pc[:, :2],)),
        "hat": (lambda m: m.hat, (t,)),
        "vee": (lambda m: (lambda v: m.vee(m.hat(v))), (t,)),
        "se3_compose": (lambda m: m.se3_compose, (R, t, R[::-1].copy(), t[::-1].copy())),
        "pack_pose": (lambda m: m.pack_pose, (R, t)),
        "unpack_pose": (lambda m: (lambda R_, t_: m.unpack_pose(m.pack_pose(R_, t_))), (R, t)),
        "rotmat_from_quat": (lambda m: (lambda R_: m.rotmat_from_quat(m.quat_from_rotmat(R_))),
                             (R,)),
        "chi2_2d": (lambda m: m.chi2_2d, (res2, info)),
        "chi2_3d": (lambda m: m.chi2_3d, (res3, info)),
        "uv_residual": (lambda m: (lambda a, b: m.uv_residual(CAM[m], a, b)), (kp, kp[::-1].copy())),
        "cheirality": (lambda m: (lambda p: m.cheirality(CAM[m], p)), (pc_signed,)),
        "triangulate_dlt": (lambda m: m.triangulate_dlt, (b1, b2, R2.astype(np.float32), t2)),
        "triangulate_two_view": (lambda m: m.triangulate_two_view,
                                 (b1, b2, eye3, zero3, R2.astype(np.float32), t2)),
        "rays_parallax_cos": (lambda m: m.rays_parallax_cos, (b1, b2, R2.astype(np.float32))),
        "masked_argmin": (lambda m: m.masked_argmin, (vals, mask)),
        "masked_topk_smallest": (lambda m: (lambda v, k: m.masked_topk_smallest(v, k, 5)),
                                 (vals, mask)),
        "safe_norm": (lambda m: m.safe_norm, (pc_signed,)),
        "normalize": (lambda m: m.normalize, (pc_signed,)),
    }


MODULES = {
    "jax": {"lie": jlie, "linalg": jlinalg, "robust": jrobust, "cam": jcam, "tri": jtri,
            "types": jtypes},
    "torch": {"lie": tlie, "linalg": tlinalg, "robust": trobust, "cam": tcam, "tri": ttri,
              "types": ttypes},
}
CAM = {jcam: JCAM, tcam: TCAM}
_MODULE_OF = {
    "inv3x3": "linalg", "inv6x6_spd": "linalg", "solve6_spd": "linalg",
    "spd_solve": "linalg", "huber_weight": "robust", "project": "cam",
    "project_jacobian": "cam", "undistort_keypoints": "cam", "bearings": "cam",
    "in_image": "cam", "chi2_2d": "robust", "chi2_3d": "robust", "uv_residual": "cam",
    "cheirality": "cam", "triangulate_dlt": "tri", "triangulate_two_view": "tri",
    "rays_parallax_cos": "tri", "masked_argmin": "types", "masked_topk_smallest": "types",
    "safe_norm": "types", "normalize": "types",
}
# Triangulation goes through a 4x4 eigendecomposition (LAPACK in both
# runtimes, different routines): rtol 1e-4 on points 2-8 m away.
TOL = {"triangulate_dlt": (1e-4, 1e-5), "triangulate_two_view": (1e-4, 1e-5)}
CASE_NAMES = [
    "so3_exp", "so3_log", "so3_left_jacobian", "se3_exp", "se3_log", "se3_update",
    "se3_apply", "se3_inverse", "quat_from_rotmat", "orthonormalize", "clamp_tangent",
    "inv3x3", "inv6x6_spd", "solve6_spd", "spd_solve", "huber_weight", "project",
    "project_jacobian", "undistort_keypoints", "bearings", "in_image", "hat", "vee",
    "se3_compose", "pack_pose", "unpack_pose", "rotmat_from_quat", "chi2_2d", "chi2_3d",
    "uv_residual", "cheirality", "triangulate_dlt", "triangulate_two_view",
    "rays_parallax_cos", "masked_argmin", "masked_topk_smallest", "safe_norm", "normalize",
]


def _flat(out):
    if isinstance(out, (tuple, list)):
        return [x for o in out for x in _flat(o)]
    return [np.asarray(out.numpy() if isinstance(out, torch.Tensor) else out)]


@pytest.mark.parametrize("name", CASE_NAMES)
def test_op_matches_jax(name):
    getter, args = _cases(np.random.default_rng(7))[name]
    mod = _MODULE_OF.get(name, "lie")
    jout = getter(MODULES["jax"][mod])(*[jnp.asarray(a) for a in args])
    tout = getter(MODULES["torch"][mod])(*[torch.from_numpy(np.array(a)) for a in args])
    rtol, atol = TOL.get(name, (RTOL, ATOL))
    for j, t in zip(_flat(jout), _flat(tout), strict=True):
        assert j.shape == t.shape
        if j.dtype == bool or np.issubdtype(j.dtype, np.integer):
            np.testing.assert_array_equal(t, j, err_msg=name)  # indices and masks: exact
        else:
            # rtol 1e-5 / atol 1e-6: float32 op-order differences only.
            np.testing.assert_allclose(t, j, rtol=rtol, atol=atol, err_msg=name)


def test_hamming_matches_jax():
    """Descriptors as u32 words (JAX) and their int32 bit patterns (port):
    popcount distances must be exactly equal."""
    rng = np.random.default_rng(3)
    a = rng.integers(0, 2**32, (40, 8), dtype=np.uint32)
    b = rng.integers(0, 2**32, (30, 8), dtype=np.uint32)
    b[:10] = a[:10] ^ np.uint32(0x80000001)  # sign bit set: signed shifts must not leak
    va, vb = rng.uniform(size=40) < 0.8, rng.uniform(size=30) < 0.8
    j = np.asarray(jham.distance_matrix(jnp.asarray(a), jnp.asarray(b), jnp.asarray(va),
                                        jnp.asarray(vb)))
    ta, tb = torch.from_numpy(a.view(np.int32)), torch.from_numpy(b.view(np.int32))
    t = tham.distance_matrix(ta, tb, torch.from_numpy(va), torch.from_numpy(vb)).numpy()
    np.testing.assert_array_equal(t, j)
    np.testing.assert_array_equal(
        tham.hamming_distance(ta[:30], tb).numpy(),
        np.asarray(jham.hamming_distance(jnp.asarray(a[:30]), jnp.asarray(b))))


def test_trajectory_io_matches_jax(tmp_path):
    """TUM / KITTI files written by the port equal the JAX package's, read
    back the same, and give the same ATE."""
    rng = np.random.default_rng(4)
    Rs = _rot(rng, 12).astype(np.float64)
    poses = [(0.1 * i, np.concatenate([Rs[i], rng.normal(size=(3, 1))], 1)) for i in range(12)]
    noisy = [(ts, P + rng.normal(scale=0.01, size=P.shape) * np.array([0, 0, 0, 1.0]))
             for ts, P in poses]
    for fmt in ("tum", "kitti"):
        jtr, ttr = tmp_path / f"j.{fmt}", tmp_path / f"t.{fmt}"
        getattr(jtraj, f"save_{fmt}")(str(jtr), poses)
        getattr(ttraj, f"save_{fmt}")(str(ttr), poses)
        assert ttr.read_text() == jtr.read_text(), fmt
    jl, tl = jtraj.load_tum(str(tmp_path / "j.tum")), ttraj.load_tum(str(tmp_path / "t.tum"))
    for (jt, jP), (tt, tP) in zip(jl, tl, strict=True):
        assert jt == tt
        np.testing.assert_array_equal(tP, jP)
    for scale in (False, True):
        assert ttraj.ate_rmse(noisy, poses, align_scale=scale) == pytest.approx(
            jtraj.ate_rmse(noisy, poses, align_scale=scale), rel=1e-12)
