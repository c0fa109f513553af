"""Port parity: the equirectangular (360 degree) path.

- Matching with ``wrap_cols`` (``match_by_projection``, its precomputed
  form, ``match_in_area``) on keypoints straddling the seam u = 0 / cols:
  indices and distances exactly equal to the JAX functions'.
- ``select_pose_by_cheirality(spherical=True)`` on points all around the
  camera, and ``scale_to_median_depth(use_dist=True)``: masks and counts
  exact, pose within 1e-5, points within 1e-3 relative (a unit baseline
  puts them ~20 away), scale bit-equal.
- ``try_initialize_mono`` on the JAX frontend's features of two rendered
  frames with the same key: success, matches and point masks exact, R and
  t within 1e-4, point directions within 1e-4 and ranges within 1e-4 *
  range^2 (the triangulation's conditioning over a unit baseline).
- Both Systems on tests/test_equirect_system.py's 512x256 sequence (600
  keypoints over 4 levels, max_kf_interval=3), rendered by the port's
  renderer: the same init frame, per-frame poses within 1e-3 m / 1e-3 rad,
  equal keyframe counts; the port's fused matcher is called 0 times (the
  JAX package routes the sphere around its kernel: tracker.py:149-157,
  mapper.py:504-508). Each System takes its own features, which are
  equal (ROADMAP C8).

The slow case is tests/test_equirect_system.py::
test_equirect_mono_sequence_ate on both Systems, with its bounds.
"""

import functools
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from structure_plp_slam_tpu.camera import Camera as JCamera
from structure_plp_slam_tpu.camera import CameraModel as JModel
from structure_plp_slam_tpu.camera import CameraSetup as JSetup
from structure_plp_slam_tpu.config import Config as JConfig
from structure_plp_slam_tpu.models import frontend as jfrontend
from structure_plp_slam_tpu.models import initializer as jinit
from structure_plp_slam_tpu.ops import matching as jmatching
from structure_plp_slam_tpu.ops import ransac as jransac
from structure_plp_slam_tpu.ops.orb import OrbParams as JOrb
from structure_plp_slam_tpu.system import System as JSystem
from structure_plp_slam_tpu_torch.camera import Camera, CameraModel, CameraSetup
from structure_plp_slam_tpu_torch.config import Config
from structure_plp_slam_tpu_torch.io import trajectory as traj_io
from structure_plp_slam_tpu_torch.models import initializer as tinit
from structure_plp_slam_tpu_torch.ops import fused_match as tfm
from structure_plp_slam_tpu_torch.ops import matching as tmatching
from structure_plp_slam_tpu_torch.ops import ransac as transac
from structure_plp_slam_tpu_torch.ops.orb import OrbParams
from structure_plp_slam_tpu_torch.system import System
from structure_plp_slam_tpu_torch.testing import synthetic_scene
from structure_plp_slam_tpu_torch.utils import prng

torch.set_num_threads(2)

COLS, ROWS = 512, 256
_KW = dict(name="equirect", cols=COLS, rows=ROWS, fps=30.0)
JCAM = JCamera(setup=JSetup.MONOCULAR, model=JModel.EQUIRECTANGULAR, **_KW)
TCAM = Camera(setup=CameraSetup.MONOCULAR, model=CameraModel.EQUIRECTANGULAR, **_KW)
ORB = dict(max_num_keypts=600, num_levels=4)
NUM_FRAMES = 8
SIZES = dict(max_keyframes=32, max_landmarks=8192, max_kf_interval=3,
             enable_loop_closing=False, track_lag=2)


def _desc(rng, n):
    return rng.integers(0, 2**32, (n, 8), dtype=np.uint32)


def _seam_case(rng, L=96, N=128):
    """Landmarks predicted and keypoints detected within 12 px of the seam
    on both sides; a third of the keypoints carry a landmark's descriptor
    with two bits flipped, so real matches cross the seam."""
    def near_seam(n):
        u = rng.uniform(-12, 12, n) % COLS
        return np.stack([u, rng.uniform(20, 200, n)], 1).astype(np.float32)

    lm_desc, kp_desc = _desc(rng, L), _desc(rng, N)
    for i in range(0, N, 3):
        d = lm_desc[(i * 5) % L].copy()
        d[0] ^= 0x5
        kp_desc[i] = d
    lm_uv, kp_xy = near_seam(L), near_seam(N)
    for i in range(0, N, 3):  # the copies sit within a few px of their landmark
        kp_xy[i] = ((lm_uv[(i * 5) % L] + rng.uniform(-4, 4, 2)) % [COLS, ROWS])
    return dict(
        lm_uv=lm_uv, lm_level=rng.integers(0, 4, L), lm_desc=lm_desc,
        lm_valid=rng.uniform(size=L) < 0.9, kp_xy=kp_xy.astype(np.float32),
        kp_level=rng.integers(0, 4, N), kp_desc=kp_desc, kp_valid=rng.uniform(size=N) < 0.95,
        kp_angle=rng.uniform(0, 2 * np.pi, N).astype(np.float32),
    )


def _bits_j(d):
    return jmatching.unpack_desc_bits(jnp.asarray(d))


def _bits_t(d):
    return tmatching.unpack_desc_bits(torch.from_numpy(d.view(np.int32)))


@pytest.mark.parametrize("ratio", [None, 0.85])
@pytest.mark.parametrize("wrap", [True, False])
def test_match_by_projection_wraps_like_jax(wrap, ratio):
    c = _seam_case(np.random.default_rng(11))
    radius = np.array([15.0 * 1.2**lv for lv in range(4)], np.float32)
    wrap_cols = float(COLS) if wrap else None
    kw = dict(max_hamming=100, ratio=ratio, wrap_cols=wrap_cols)
    ij, dj = jmatching.match_by_projection(
        jnp.asarray(c["lm_uv"]), jnp.asarray(c["lm_level"]), _bits_j(c["lm_desc"]),
        jnp.asarray(c["lm_valid"]), jnp.asarray(c["kp_xy"]), jnp.asarray(c["kp_level"]),
        _bits_j(c["kp_desc"]), jnp.asarray(c["kp_valid"]),
        radius_by_level=jnp.asarray(radius), **kw)
    it, dt = tmatching.match_by_projection(
        torch.from_numpy(c["lm_uv"]), torch.from_numpy(c["lm_level"]), _bits_t(c["lm_desc"]),
        torch.from_numpy(c["lm_valid"]), torch.from_numpy(c["kp_xy"]),
        torch.from_numpy(c["kp_level"]), _bits_t(c["kp_desc"]),
        torch.from_numpy(c["kp_valid"]), radius_by_level=torch.from_numpy(radius), **kw)
    assert (it.numpy() == np.asarray(ij)).all()
    assert (dt.numpy() == np.asarray(dj)).all()
    # Matches across the seam exist only with the wrap.
    du = np.abs(c["lm_uv"][:, 0] - c["kp_xy"][np.maximum(it.numpy(), 0), 0])
    across = ((it.numpy() >= 0) & (du > COLS / 2)).sum()
    assert (across > 0) == wrap, across

    # The precomputed form on the same distances (the tracker's route).
    d_j = jmatching.distance_matrix_mxu(_bits_j(c["lm_desc"]), _bits_j(c["kp_desc"]),
                                        None, jnp.asarray(c["kp_valid"]))
    d_t = tmatching.distance_matrix_mxu(_bits_t(c["lm_desc"]), _bits_t(c["kp_desc"]),
                                           None, torch.from_numpy(c["kp_valid"]))
    pj, qj = jmatching.match_by_projection_precomputed(
        d_j, jnp.asarray(c["lm_uv"]), jnp.asarray(c["lm_level"]), jnp.asarray(c["lm_valid"]),
        jnp.asarray(c["kp_xy"]), jnp.asarray(c["kp_level"]),
        radius_by_level=jnp.asarray(radius), **kw)
    pt, qt = tmatching.match_by_projection_precomputed(
        d_t, torch.from_numpy(c["lm_uv"]), torch.from_numpy(c["lm_level"]),
        torch.from_numpy(c["lm_valid"]), torch.from_numpy(c["kp_xy"]),
        torch.from_numpy(c["kp_level"]), radius_by_level=torch.from_numpy(radius), **kw)
    assert (pt.numpy() == np.asarray(pj)).all()
    assert (qt.numpy() == np.asarray(qj)).all()
    assert (pt.numpy() == it.numpy()).all()


@pytest.mark.parametrize("wrap", [True, False])
def test_match_in_area_wraps_like_jax(wrap):
    """Frame 2's keypoints are frame 1's moved 3 px to the right with a
    few bits flipped, so a third of them cross the seam."""
    rng = np.random.default_rng(12)
    c = _seam_case(rng, L=8, N=160)
    xy1 = c["kp_xy"]
    xy2 = ((xy1 + [3.0, 0.0]) % [COLS, ROWS]).astype(np.float32)
    d2 = c["kp_desc"].copy()
    d2[:, 1] ^= 0x11
    ang2 = (c["kp_angle"] + rng.normal(0, 0.02, len(xy1))).astype(np.float32)
    wrap_cols = float(COLS) if wrap else None
    mj = jmatching.match_in_area(
        jnp.asarray(xy1), jnp.asarray(c["kp_angle"]), _bits_j(c["kp_desc"]),
        jnp.asarray(c["kp_valid"]), jnp.asarray(xy2), jnp.asarray(ang2), _bits_j(d2),
        jnp.asarray(c["kp_valid"]), window=10.0, wrap_cols=wrap_cols)
    mt = tmatching.match_in_area(
        torch.from_numpy(xy1), torch.from_numpy(c["kp_angle"]), _bits_t(c["kp_desc"]),
        torch.from_numpy(c["kp_valid"]), torch.from_numpy(xy2), torch.from_numpy(ang2),
        _bits_t(d2), torch.from_numpy(c["kp_valid"]), window=10.0, wrap_cols=wrap_cols)
    assert (mt.numpy() == np.asarray(mj)).all()
    crossing = np.abs(xy1[:, 0] - xy2[:, 0]) > COLS / 2
    found = mt.numpy() == np.arange(len(xy1))
    assert found[crossing].any() == wrap and found[~crossing].sum() > 50


def _sphere_geometry(rng, n=300):
    """Points 2-8 m away in every direction from camera 1 (the world),
    camera 2 moved 0.4 m with a small turn; unit bearings in both."""
    d = rng.normal(size=(n, 3))
    p = d / np.linalg.norm(d, axis=1, keepdims=True) * rng.uniform(2, 8, (n, 1))
    k, th = np.array([0.35, -0.9, 0.2]), 0.055
    k = k / np.linalg.norm(k)
    K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    R = np.eye(3) + np.sin(th) * K + (1 - np.cos(th)) * K @ K
    t = np.array([0.3, 0.05, -0.25])
    p2 = p @ R.T + t
    b1 = p / np.linalg.norm(p, axis=1, keepdims=True)
    b2 = p2 / np.linalg.norm(p2, axis=1, keepdims=True)
    tx = np.array([[0, -t[2], t[1]], [t[2], 0, -t[0]], [-t[1], t[0], 0]])
    return b1.astype(np.float32), b2.astype(np.float32), (tx @ R).astype(np.float32)


@pytest.mark.parametrize("spherical", [True, False])
def test_select_pose_spherical_matches_jax(spherical):
    rng = np.random.default_rng(13)
    b1, b2, E = _sphere_geometry(rng)
    valid = rng.uniform(size=len(b1)) < 0.95
    Rs, ts = jransac.decompose_essential(jnp.asarray(E))
    kw = dict(spherical=spherical, reproj_cos=math.cos(5.0 / TCAM.focal_like))
    Rj, tj, pj, gj, cj = jransac.select_pose_by_cheirality(
        Rs, ts, jnp.asarray(b1), jnp.asarray(b2), jnp.asarray(valid), **kw)
    Rt, tt, pt, gt, ct = transac.select_pose_by_cheirality(
        torch.from_numpy(np.array(Rs)), torch.from_numpy(np.array(ts)),
        torch.from_numpy(b1), torch.from_numpy(b2), torch.from_numpy(valid), **kw)
    assert int(ct) == int(cj)
    assert (gt.numpy() == np.asarray(gj)).all()
    assert np.abs(Rt.numpy() - np.asarray(Rj)).max() < 1e-5
    assert np.abs(tt.numpy() - np.asarray(tj)).max() < 1e-5
    ok = np.asarray(gj)
    # Unit baseline: depths reach ~20, which scales the rays' rounding
    # into the points (1e-3 relative, as tests/test_torch_mono.py).
    assert np.abs(pt.numpy()[ok] - np.asarray(pj)[ok]).max() / np.abs(np.asarray(pj)[ok]).max() < 1e-3
    if spherical:  # points behind camera 1 count on the sphere
        assert int(ct) > 0.8 * valid.sum() and (np.asarray(pj)[ok][:, 2] < 0).any()
    else:
        assert int(ct) < 0.7 * valid.sum()


@pytest.mark.parametrize("use_dist", [True, False])
def test_scale_to_median_depth_use_dist(use_dist):
    rng = np.random.default_rng(14)
    pts = rng.normal(size=(40, 3)).astype(np.float32) * 3
    ok = rng.uniform(size=40) < 0.7
    t = rng.normal(size=3).astype(np.float32)
    pj, tj, sj = jinit.scale_to_median_depth(jnp.asarray(pts), jnp.asarray(ok), jnp.asarray(t),
                                             use_dist=use_dist)
    pt, tt, st = tinit.scale_to_median_depth(torch.from_numpy(pts), torch.from_numpy(ok),
                                             torch.from_numpy(t), use_dist=use_dist)
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    np.testing.assert_array_equal(pt.numpy(), np.asarray(pj))
    np.testing.assert_array_equal(tt.numpy(), np.asarray(tj))


@functools.lru_cache(maxsize=1)
def _frames():
    tex = synthetic_scene.make_texture(np.random.default_rng(42))
    poses = synthetic_scene.trajectory(NUM_FRAMES, step=0.09)
    return [synthetic_scene.render_equirect(TCAM, tex, R, t)[0] for R, t in poses], poses


@functools.lru_cache(maxsize=None)
def jax_feats(i):
    """The JAX frontend's features of frame ``i`` (numpy)."""
    orb = JOrb(**ORB)
    cap = jfrontend.orb_ops.OrbExtractor(ROWS, COLS, orb).capacity
    fe = jfrontend.Frontend(JCAM, orb, pad_to=-(-cap // 8) * 8)
    return {k: np.asarray(v) for k, v in fe.mono(jnp.asarray(_frames()[0][i])).items()}


def _to_torch(f):
    out = {}
    for k, v in f.items():
        a = np.array(v)
        if a.dtype == np.uint32:
            a = a.view(np.int32)
        elif a.dtype == np.int32:
            a = a.astype(np.int64)
        out[k] = torch.from_numpy(a)
    return out


@pytest.mark.parametrize("pair,seed", [((0, 2), 0), ((0, 3), 1), ((0, 1), 2)])
def test_try_initialize_equirect_parity(pair, seed):
    f1, f2 = (jax_feats(i) for i in pair)
    rj = jinit.try_initialize_mono(JCAM, f1, f2, jax.random.PRNGKey(seed))
    rt = tinit.try_initialize_mono(TCAM, _to_torch(f1), _to_torch(f2), prng.PRNGKey(seed))
    assert not bool(rj.used_homography) and not bool(rt.used_homography)
    assert int(rt.num_matches) == int(rj.num_matches) > 50
    assert bool(rt.success) == bool(rj.success)
    assert int(rt.num_points) == int(rj.num_points)
    assert (rt.point_ok.numpy() == np.asarray(rj.point_ok)).all()
    assert (rt.matches.numpy() == np.asarray(rj.matches)).all()
    assert np.abs(rt.R_2w.numpy() - np.asarray(rj.R_2w)).max() < 1e-4
    assert np.abs(rt.t_2w.numpy() - np.asarray(rj.t_2w)).max() < 1e-4
    ok = np.asarray(rj.point_ok)
    if ok.any():
        # Over a unit baseline a point's range error grows with the square
        # of its range (up to ~70 here): directions within 1e-4, ranges
        # within 1e-4 * range^2.
        pj, pt = np.asarray(rj.points_w)[ok], rt.points_w.numpy()[ok]
        rj_, rt_ = np.linalg.norm(pj, axis=1), np.linalg.norm(pt, axis=1)
        assert np.abs(pj / rj_[:, None] - pt / rt_[:, None]).max() < 1e-4
        assert (np.abs(rt_ - rj_) <= 1e-4 * rj_**2).all()


def _run(slam, frames):
    slam.startup()
    poses = []
    for i, img in enumerate(frames):
        out = slam.feed_monocular_frame(img, float(i) / 30.0)
        if torch.is_tensor(out):
            out = out.cpu().numpy()
        poses.append(None if out is None else np.array(out))
    slam.shutdown()
    return poses


@functools.lru_cache(maxsize=1)
def run_jax():
    js = JSystem(JConfig(camera=JCAM, orb=JOrb(**ORB), raw={}), distributed_ba=False, **SIZES)
    return js, _run(js, _frames()[0])


@functools.lru_cache(maxsize=1)
def run_port():
    ts = System(Config(camera=TCAM, orb=OrbParams(**ORB), raw={}), device="cpu", **SIZES)
    tfm.reset_counts()
    poses = _run(ts, _frames()[0])
    return ts, poses, tfm.fused_match.calls


def _rot_angle(Ra, Rb):
    c = (np.trace(Ra.T @ Rb) - 1.0) / 2.0
    return float(np.arccos(np.clip(c, -1.0, 1.0)))


def test_equirect_system_matches_jax():
    js, jposes = run_jax()
    ts, tposes, _ = run_port()
    init_j = [p is not None for p in jposes]
    assert [p is not None for p in tposes] == init_j
    assert sum(init_j) >= 4, "the map did not initialize early enough"
    for i, (a, b) in enumerate(zip(jposes, tposes)):
        if a is None:
            continue
        dt = np.linalg.norm(a[:, 3] - b[:, 3])
        dr = _rot_angle(a[:, :3], b[:, :3])
        # 1e-3 m / 1e-3 rad: f32 sums in another order through SVD, LM and BA.
        assert dt < 1e-3 and dr < 1e-3, f"frame {i}: {dt:.2e} m, {dr:.2e} rad"
    assert ts.num_keyframes == js.num_keyframes >= 3
    assert ts.tracking_state.value == js.tracking_state.value == "Tracking"


def test_equirect_system_bypasses_kernel():
    """The sphere's projection matches wrap in u and the fused matcher's
    windows do not: neither the tracker nor the keyframe fuse calls it."""
    ts, _, calls = run_port()
    assert ts.num_track_steps > 0 and ts.next_kf > 2
    assert calls == 0


@pytest.mark.slow
def test_equirect_mono_sequence_ate():
    """tests/test_equirect_system.py::test_equirect_mono_sequence_ate on
    both Systems (the port's renderer, the JAX test's texture and bounds)."""
    tex = synthetic_scene.make_texture(np.random.default_rng(42))
    poses = synthetic_scene.trajectory(14, step=0.09)
    frames = [synthetic_scene.render_equirect(TCAM, tex, R, t)[0] for R, t in poses]
    gt = [(float(i) / 30.0, np.concatenate([R, t[:, None]], 1)) for i, (R, t) in enumerate(poses)]
    kw = dict(max_keyframes=32, max_landmarks=8192, max_kf_interval=3)
    for slam in (JSystem(JConfig(camera=JCAM, orb=JOrb(**ORB), raw={}), distributed_ba=False,
                         **kw),
                 System(Config(camera=TCAM, orb=OrbParams(**ORB), raw={}), device="cpu", **kw)):
        _run(slam, frames)
        assert slam.tracking_state.value == "Tracking"
        est = slam.frame_trajectory()
        assert len(est) >= 9
        ate = traj_io.ate_rmse(est, gt, align_scale=True)
        assert ate < 0.10, f"{type(slam).__module__}: ATE {ate}"
