"""Port copies of reference tests whose edge cases no parity test reaches
(ROADMAP A18): each keeps the original's name, inputs and gates and runs
on the port, and runs the JAX function on the same inputs with the same
gates, the outputs held against each other where they are comparable.

- tests/test_lie.py::test_so3_log_near_pi (angles 1e-5 short of pi);
- tests/test_landmark_stats.py's unobserved landmark, windowed refresh
  with partial overlap and local BA's returned cameras;
- tests/test_lines.py's drawn segments, flat image and shifted
  descriptors;
- tests/test_coherent_init.py's contaminated block and plane region.
"""

import numpy as np
import torch

import jax
import jax.numpy as jnp

from structure_plp_slam_tpu.data import map_state as jms
from structure_plp_slam_tpu.models import mapper as jmapper
from structure_plp_slam_tpu.ops import lie as jlie
from structure_plp_slam_tpu.ops import lines as jlines
from structure_plp_slam_tpu.ops import ransac as jransac
from structure_plp_slam_tpu_torch.camera import Camera, CameraModel, CameraSetup
from structure_plp_slam_tpu_torch.data import map_state as tms
from structure_plp_slam_tpu_torch.models import mapper as tmapper
from structure_plp_slam_tpu_torch.ops import lie as tlie
from structure_plp_slam_tpu_torch.ops import lines as tlines
from structure_plp_slam_tpu_torch.ops import ransac as transac
from structure_plp_slam_tpu_torch.utils import prng
from tests import helpers
from tests.test_lines import SEGS, synthetic_line_image

torch.set_num_threads(2)


def T(a, dtype=None):
    a = np.array(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    elif a.dtype == np.int32:
        a = a.astype(np.int64)
    t = torch.from_numpy(a)
    return t if dtype is None else t.to(dtype)


def _port_camera(jcam):
    return Camera(name=jcam.name, setup=CameraSetup.MONOCULAR, model=CameraModel.PERSPECTIVE,
                  cols=jcam.cols, rows=jcam.rows, fx=jcam.fx, fy=jcam.fy, cx=jcam.cx,
                  cy=jcam.cy)


# ---- tests/test_lie.py ------------------------------------------------------


def test_so3_log_near_pi(rng):
    for _ in range(10):
        axis = rng.normal(size=3)
        axis /= np.linalg.norm(axis)
        phi = (axis * (np.pi - 1e-5)).astype(np.float32)
        outs = []
        for exp, log, arr in ((tlie.so3_exp, tlie.so3_log, torch.from_numpy),
                              (jlie.so3_exp, jlie.so3_log, jnp.asarray)):
            R = exp(arr(phi[None]))
            phi2 = np.asarray(log(R))[0]
            # Log may return the antipodal representative; compare rotations.
            R2 = np.asarray(exp(arr(phi2[None])))[0]
            np.testing.assert_allclose(R2, np.asarray(R)[0], atol=1e-4)
            outs.append(R2)
        np.testing.assert_allclose(outs[0], outs[1], atol=1e-4)


# ---- tests/test_landmark_stats.py --------------------------------------------


def _blank_feats(N):
    """The original's empty feature dict (numpy, the JAX package's dtypes)."""
    return {
        "xy": np.zeros((N, 2), np.float32),
        "xr": np.full((N,), -1.0, np.float32),
        "depth": np.full((N,), -1.0, np.float32),
        "level": np.zeros((N,), np.int32),
        "angle": np.zeros((N,), np.float32),
        "desc": np.zeros((N, 8), np.uint32),
        "bearing": np.zeros((N, 3), np.float32),
        "valid": np.zeros((N,), bool),
    }


def _three_observers(port):
    """The original's three keyframes on the -z axis, all observing
    landmark 0 at the origin (kf 0 and 1 one descriptor bit apart, kf 2
    an outlier; levels 0, 1, 2), in either package; plus landmark 1 with
    no observer (test_unobserved_landmarks_untouched's)."""
    mod, arr = (tms, T) if port else (jms, jnp.asarray)
    kw = {"device": "cpu"} if port else {}
    st = mod.create(max_keyframes=4, max_kps=16, max_landmarks=8, **kw)
    descs = [np.zeros(8, np.uint32), np.zeros(8, np.uint32), np.full(8, 0xFFFFFFFF, np.uint32)]
    descs[1][0] = 1
    for k, z in enumerate((1.0, 2.0, 4.0)):
        f = _blank_feats(16)
        f["valid"][0] = True
        f["level"][0] = k
        f["desc"][0] = descs[k]
        pose = np.concatenate([np.eye(3), [[0.0], [0.0], [z]]], 1).astype(np.float32)
        lm_idx = np.full(16, -1, np.int32)
        lm_idx[0] = 0
        st = mod.add_keyframe(st, k, arr(pose), float(k), {key: arr(v) for key, v in f.items()},
                              arr(lm_idx))
    return mod.add_landmarks(
        st, slots=arr(np.array([0, 1], np.int32)),
        pos=arr(np.array([[0.0, 0.0, 0.0], [1.0, 1.0, 1.0]], np.float32)),
        desc=arr(np.stack([descs[2], np.full(8, 7, np.uint32)])),  # 0: stale, from the outlier
        normal=arr(np.array([[1.0, 0.0, 0.0], [0.0, 1.0, 0.0]], np.float32)),
        dist_min=arr(np.array([99.0, 0.5], np.float32)),
        dist_max=arr(np.array([99.0, 2.0], np.float32)),
        ref_kf=arr(np.array([0, 0], np.int32)), valid=arr(np.array([True, True])))


def _refresh_both(window=None):
    """refresh_landmark_stats on the three-observer state in both
    packages (``window``: the window keyframes, -1 padded)."""
    jst, tst = _three_observers(False), _three_observers(True)
    kw = {} if window is None else {"window_kfs": np.array(window, np.int32)}
    jout = jmapper.refresh_landmark_stats(
        jst, **{k: jnp.asarray(v) for k, v in kw.items()})
    tout = tmapper.refresh_landmark_stats(tst, **{k: T(v) for k, v in kw.items()})
    return jst, jout, tms.to_numpy(tout)


def _assert_stats_equal(jout, tout):
    np.testing.assert_array_equal(tout["lm_desc"].view(np.uint32),
                                  np.asarray(jout.lm_desc).view(np.uint32))
    for f in ("lm_dist_min", "lm_dist_max", "lm_normal"):
        np.testing.assert_allclose(tout[f], np.asarray(getattr(jout, f)), rtol=1e-6, atol=1e-7)


def test_unobserved_landmarks_untouched():
    _, jout, tout = _refresh_both()
    for out in ({k: np.asarray(getattr(jout, k)) for k in tout}, tout):
        assert np.all(out["lm_desc"][1] == 7)
        assert float(out["lm_dist_min"][1]) == 0.5
        assert float(out["lm_dist_max"][1]) == 2.0
    _assert_stats_equal(jout, tout)


def test_windowed_refresh_partial_overlap_aggregates_all_observers():
    """A landmark observed inside and outside the window: bounds and
    normal from every observer (the full refresh's), the stored
    descriptor kept."""
    jst, jfull, tfull = _refresh_both()
    _, jout, tout = _refresh_both(window=[1, -1, -1, -1])  # one of the three observers
    for full, out in (({k: np.asarray(getattr(jfull, k)) for k in tfull},
                       {k: np.asarray(getattr(jout, k)) for k in tout}), (tfull, tout)):
        assert np.isclose(float(out["lm_dist_max"][0]), float(full["lm_dist_max"][0]), rtol=1e-5)
        assert np.isclose(float(out["lm_dist_min"][0]), float(full["lm_dist_min"][0]), rtol=1e-5)
        np.testing.assert_allclose(out["lm_normal"][0], full["lm_normal"][0], atol=1e-6)
        np.testing.assert_array_equal(out["lm_desc"][0].view(np.uint32),
                                      np.asarray(jst.lm_desc[0]))
    _assert_stats_equal(jout, tout)


def test_local_ba_returned_cams_have_no_duplicates():
    """local_ba's returned cameras: three covisible keyframes, every other
    slot -1 (no clipped padding, no duplicate)."""
    rng = np.random.default_rng(3)
    jcam = helpers.make_camera()
    K_mat = helpers.K_of(jcam)
    pts = rng.uniform([-1.5, -1.0, 3.0], [1.5, 1.0, 6.0], (24, 3))
    jst = jms.create(max_keyframes=4, max_kps=32, max_landmarks=32)
    tst = tms.create(max_keyframes=4, max_kps=32, max_landmarks=32, device="cpu")
    for k in range(3):
        R = np.eye(3, dtype=np.float32)
        t = np.array([0.12 * k, 0.0, 0.0], np.float32)
        uv, _ = helpers.project_points(R, t, K_mat, pts)
        f = _blank_feats(32)
        f["xy"][:24] = uv
        f["valid"][:24] = True
        b = np.concatenate([(uv - K_mat[:2, 2]) / np.diag(K_mat)[:2], np.ones((24, 1))], axis=1)
        f["bearing"][:24] = b / np.linalg.norm(b, axis=1, keepdims=True)
        pose = np.concatenate([R, t[:, None]], axis=1)
        lm_idx = np.full(32, -1, np.int32)
        lm_idx[:24] = np.arange(24)
        jst = jms.add_keyframe(jst, k, jnp.asarray(pose), float(k),
                               {key: jnp.asarray(v) for key, v in f.items()}, jnp.asarray(lm_idx))
        tst = tms.add_keyframe(tst, k, T(pose), float(k), {key: T(v) for key, v in f.items()},
                               T(lm_idx))
    lms = dict(pos=pts.astype(np.float32), desc=np.zeros((24, 8), np.uint32),
               normal=np.tile(np.array([[0.0, 0.0, -1.0]], np.float32), (24, 1)),
               dist_min=np.full(24, 0.5, np.float32), dist_max=np.full(24, 20.0, np.float32),
               ref_kf=np.zeros(24, np.int32), valid=np.ones(24, bool))
    jst = jms.add_landmarks(jst, slots=jnp.arange(24, dtype=jnp.int32),
                            **{k: jnp.asarray(v) for k, v in lms.items()})
    tst = tms.add_landmarks(tst, slots=torch.arange(24), **{k: T(v) for k, v in lms.items()})
    inv_sig = (1.0 / (1.2 ** (2 * np.arange(8)))).astype(np.float32)
    _, _, jcams = jmapper.local_ba(jcam, jst, jnp.int32(1), jnp.asarray(inv_sig),
                                   return_cams=True)
    _, _, tcams = tmapper.local_ba(_port_camera(jcam), tst, 1, T(inv_sig), return_cams=True)
    for cams in (np.asarray(jcams), tcams.numpy()):
        live = cams[cams >= 0]
        # 3 valid keyframes, all covisible (weight 24 >= 15) -> all three in
        # the optimize half, every other slot -1.
        assert sorted(live.tolist()) == [0, 1, 2]
        assert len(cams) > 3 and np.all(cams[np.isin(cams, live, invert=True)] == -1)
    np.testing.assert_array_equal(tcams.numpy(), np.asarray(jcams))


# ---- tests/test_lines.py ------------------------------------------------------


def _detect_both(img, seed=0):
    j = jlines.detect_line_segments(jnp.asarray(img), jax.random.PRNGKey(seed))
    t = tlines.detect_line_segments(torch.from_numpy(img), prng.PRNGKey(seed))
    return [tuple(np.asarray(a) for a in x) for x in (j, t)], (j, t)


def test_detects_drawn_segments():
    img = synthetic_line_image(SEGS)
    ((jseg, jval, _), (tseg, tval, _)), _ = _detect_both(img)
    np.testing.assert_array_equal(tval, jval)
    for seg in (jseg[jval], tseg[tval]):
        assert len(seg) >= 3
        # Every drawn segment has a detection with a similar direction
        # and a small midpoint distance.
        for (x1, y1, x2, y2) in SEGS:
            gt_dir = np.array([x2 - x1, y2 - y1], float)
            gt_dir /= np.linalg.norm(gt_dir)
            gt_mid = np.array([(x1 + x2) / 2, (y1 + y2) / 2])
            found = False
            for s in seg:
                d = np.array([s[2] - s[0], s[3] - s[1]])
                if np.linalg.norm(d) < 20:
                    continue
                d = d / np.linalg.norm(d)
                mid = np.array([(s[0] + s[2]) / 2, (s[1] + s[3]) / 2])
                dist = abs(np.dot(gt_mid - mid, np.array([-d[1], d[0]])))
                if abs(np.dot(d, gt_dir)) > 0.98 and dist < 4.0:
                    found = True
                    break
            assert found, f"segment {(x1, y1, x2, y2)} not detected"


def test_no_lines_in_flat_image():
    img = np.full((240, 320), 128.0, np.float32)
    ((_, jval, _), (_, tval, _)), _ = _detect_both(img)
    assert not jval.any() and not tval.any()


def test_descriptors_match_across_shift():
    img1 = synthetic_line_image(SEGS)
    img2 = np.roll(img1, 5, axis=1)
    _, (j1, t1) = _detect_both(img1, 0)
    _, (j2, t2) = _detect_both(img2, 1)
    for mod, arr, (s1, v1, _), (s2, v2, _) in ((jlines, jnp.asarray, j1, j2),
                                               (tlines, torch.from_numpy, t1, t2)):
        d1 = mod.line_band_descriptors(arr(img1), s1, v1)
        d2 = mod.line_band_descriptors(arr(img2), s2, v2)
        dist = np.asarray(mod.line_descriptor_distance_matrix(d1, d2, v1, v2))
        v1 = np.asarray(v1)
        # Each valid line in img1 has a strong match in img2.
        good = sum(1 for i in range(len(dist)) if v1[i] and dist[i].min() < 0.25)
        assert good >= max(2, int(0.6 * int(v1.sum())))


# ---- tests/test_coherent_init.py -------------------------------------------------


def _bearing(cam, uv):
    b = np.concatenate([(uv - [cam.cx, cam.cy]) / [cam.fx, cam.fy], np.ones((len(uv), 1))],
                       axis=1)
    return b / np.linalg.norm(b, axis=1, keepdims=True)


def _proj(K, p, R, t):
    pc = p @ R.T + t
    return ((pc / pc[:, 2:3]) @ K.T)[:, :2]


def test_coherent_essential_expels_contaminated_block(rng):
    """A compact region of wrong associations: lucky members admitted by
    plain MSAC must be expelled by the coherent consensus, which recruits
    the boundary-noise true matches back."""
    cam = helpers.make_camera()
    K = helpers.K_of(cam)
    t2 = np.array([0.35, 0.0, 0.02])
    n_true, n_blk = 170, 130
    n = n_true + n_blk
    pts = np.stack([rng.uniform(-3.5, 3.5, n), rng.uniform(-2.5, 2.5, n),
                    np.full(n, 6.0) + rng.uniform(-0.3, 0.3, n)], axis=1)
    pts[n_true:, 0] = rng.uniform(1.6, 2.9, n_blk)  # the block, compact in view 1
    pts[n_true:, 1] = rng.uniform(-0.9, 0.5, n_blk)
    uv1 = _proj(K, pts, np.eye(3), np.zeros(3))
    uv2 = _proj(K, pts, np.eye(3), t2)
    uv1 += rng.normal(scale=0.3, size=uv1.shape)
    uv2[:n_true] += rng.normal(scale=0.4, size=(n_true, 2))
    uv2[n_true:] = np.stack([rng.uniform(0, cam.cols, n_blk),
                             rng.uniform(0, cam.rows, n_blk)], axis=1)
    b1 = _bearing(cam, uv1).astype(np.float32)
    b2 = _bearing(cam, uv2).astype(np.float32)
    valid = np.ones(n, bool)
    true_mask = np.arange(n) < n_true
    thr = (2.0 / cam.focal_like) ** 2

    _, jplain, _ = jransac.essential_ransac(jnp.asarray(b1), jnp.asarray(b2),
                                            jnp.asarray(valid), jax.random.PRNGKey(0),
                                            inlier_thr=thr)
    _, jcoh, _ = jransac.essential_ransac_coherent(
        jnp.asarray(b1), jnp.asarray(b2), jnp.asarray(uv1, jnp.float32), jnp.asarray(valid),
        jax.random.PRNGKey(0), inlier_thr=thr)
    _, tplain, _ = transac.essential_ransac(T(b1), T(b2), T(valid), prng.PRNGKey(0),
                                            inlier_thr=thr)
    _, tcoh, _ = transac.essential_ransac_coherent(
        T(b1), T(b2), T(uv1, torch.float32), T(valid), prng.PRNGKey(0), inlier_thr=thr)
    # The masks agree on >= 98% of the matches: the block's lucky members
    # sit at the gate, where the packages' f32 epipolar errors part.
    assert (tplain.numpy() == np.asarray(jplain)).mean() >= 0.98
    assert (tcoh.numpy() == np.asarray(jcoh)).mean() >= 0.98
    for plain, coh in ((np.asarray(jplain), np.asarray(jcoh)), (tplain.numpy(), tcoh.numpy())):
        false_plain, false_coh = int((plain & ~true_mask).sum()), int((coh & ~true_mask).sum())
        true_plain, true_coh = int((plain & true_mask).sum()), int((coh & true_mask).sum())
        assert true_coh >= true_plain + 15, (true_plain, true_coh)
        assert false_coh <= max(false_plain, 2), (false_plain, false_coh)


def test_coherent_homography_recruits_plane_region(rng):
    """The H race's support is the dominant-plane region; boundary-noise
    members dropped by the hard gate must be recruited by coherence."""
    cam = helpers.make_camera()
    K = helpers.K_of(cam)
    t2 = np.array([0.4, 0.05, 0.0])
    n_pl, n_off = 170, 60
    pts = np.stack([rng.uniform(-3.5, 3.5, n_pl + n_off), rng.uniform(-2.5, 2.5, n_pl + n_off),
                    np.concatenate([np.full(n_pl, 6.0), rng.uniform(3.0, 5.0, n_off)])], axis=1)
    uv1 = _proj(K, pts, np.eye(3), np.zeros(3))
    uv2 = _proj(K, pts, np.eye(3), t2)
    uv1 += rng.normal(scale=0.3, size=uv1.shape)
    uv2[:n_pl] += rng.normal(scale=1.6, size=(n_pl, 2))  # boundary-level noise on the plane
    uv2[n_pl:] += rng.normal(scale=0.3, size=(n_off, 2))
    valid = np.ones(n_pl + n_off, bool)
    plane_mask = np.arange(n_pl + n_off) < n_pl
    p1, p2 = uv1.astype(np.float32), uv2.astype(np.float32)

    _, jplain, _ = jransac.homography_ransac(jnp.asarray(p1), jnp.asarray(p2),
                                             jnp.asarray(valid), jax.random.PRNGKey(1))
    _, jcoh, _ = jransac.homography_ransac_coherent(jnp.asarray(p1), jnp.asarray(p2),
                                                    jnp.asarray(valid), jax.random.PRNGKey(1))
    _, tplain, _ = transac.homography_ransac(T(p1), T(p2), T(valid), prng.PRNGKey(1))
    _, tcoh, _ = transac.homography_ransac_coherent(T(p1), T(p2), T(valid), prng.PRNGKey(1))
    np.testing.assert_array_equal(tplain.numpy(), np.asarray(jplain))
    np.testing.assert_array_equal(tcoh.numpy(), np.asarray(jcoh))
    for plain, coh in ((np.asarray(jplain), np.asarray(jcoh)), (tplain.numpy(), tcoh.numpy())):
        rec_plain = (plain & plane_mask).sum() / n_pl
        rec_coh = (coh & plane_mask).sum() / n_pl
        off_coh = (coh & ~plane_mask).sum()
        assert rec_plain <= 0.85, rec_plain  # the hard gate drops plane members here
        assert rec_coh >= rec_plain + 0.05, (rec_plain, rec_coh)
        assert off_coh <= 0.15 * n_off, off_coh
