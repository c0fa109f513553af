"""Port copies of reference tests whose edge cases no parity test reaches
(ROADMAP A18): each keeps the original's name, inputs and gates and runs
on the port, and runs the JAX function on the same inputs with the same
gates, the outputs held against each other where they are comparable.

- tests/test_lie.py::test_so3_log_near_pi (angles 1e-5 short of pi);
- tests/test_landmark_stats.py's unobserved landmark, windowed refresh
  with partial overlap and local BA's returned cameras;
- tests/test_lines.py's drawn segments, flat image and shifted
  descriptors;
- tests/test_coherent_init.py's contaminated block and plane region;
- slow, as the originals are: tests/test_line_frontend_eval.py's
  repeatability under viewpoint and matching precision under
  degradations (the port's detector and band descriptors on the natural
  texture), and tests/test_line_ba_joint_experiment.py's production joint
  solver against point-only BA and the corridor experiment (the port's
  ``ba_solve`` with and without a ``LineWindow``; the experiment's dense
  joint Gauss-Newton written on the port's line geometry).
"""

import numpy as np
import pytest
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


# ---- tests/test_line_frontend_eval.py (slow) --------------------------------


def _port_detect(img, depth):
    """``test_line_frontend_eval._detect`` on the port's detector: the
    segments, keeping those that lie on the z = 6 background plane; the
    same segments as the JAX detector's, within tests/test_torch_lines.py's
    1e-3 px."""
    from tests import test_line_frontend_eval as lfe

    seg, valid, _ = tlines.detect_line_segments(T(np.asarray(img, np.float32)),
                                                prng.PRNGKey(0))
    seg = seg.numpy()[valid.numpy()]
    H, W = depth.shape
    keep = []
    for sg in seg:
        pts = np.stack([sg[0:2], sg[2:4], 0.5 * (sg[0:2] + sg[2:4])])
        xs = np.clip(pts[:, 0].astype(int), 0, W - 1)
        ys = np.clip(pts[:, 1].astype(int), 0, H - 1)
        keep.append(bool((depth[ys, xs] > 4.5).all()))
    seg = seg[np.array(keep, bool)]
    np.testing.assert_allclose(seg, lfe._detect(img, depth=depth), rtol=0.0, atol=1e-3)
    return seg


def _port_match_precision(img_a, img_b, seg_a, seg_b, H_ab):
    """``test_line_frontend_eval.match_precision`` on the port's band
    descriptors."""
    from tests import test_line_frontend_eval as lfe

    if len(seg_a) < 3 or len(seg_b) < 3:
        return 0.0, 0

    def desc(img, seg):
        sg = np.zeros((64, 4), np.float32)
        v = np.zeros((64,), bool)
        sg[: len(seg)] = seg[:64]
        v[: len(seg)] = True
        return tlines.line_band_descriptors(T(np.asarray(img, np.float32)), T(sg), T(v)).numpy()

    best_ab = (desc(img_a, seg_a)[: len(seg_a)] @ desc(img_b, seg_b)[: len(seg_b)].T).argmax(1)
    mapped = lfe._warp_seg(seg_a, H_ab)
    good, n = 0, 0
    for i in range(len(seg_a)):
        if not any(lfe._seg_close(mapped[i], b) for b in seg_b):
            continue
        n += 1
        good += bool(lfe._seg_close(mapped[i], seg_b[best_ab[i]]))
    return good / max(n, 1), n


@pytest.mark.slow
def test_line_repeatability_under_viewpoint():
    """The original's gates (0.7 at 5 degrees, 0.8 at 10) on the port's
    segments, and the JAX detector's repeatability on the same views."""
    from tests import synthetic_scene
    from tests import test_line_frontend_eval as lfe

    rng = np.random.default_rng(7)
    tex = lfe._natural_texture(rng)
    Ra, ta = lfe._pose(0.0)
    img_a, dep_a = synthetic_scene.render(lfe.CAM, tex, Ra, ta)
    seg_a = _port_detect(img_a, dep_a)
    assert len(seg_a) >= 6, f"too few segments on natural texture: {len(seg_a)}"
    for angle, floor in ((5.0, 0.7), (10.0, 0.8)):
        Rb, tb = lfe._pose(angle)
        img_b, dep_b = synthetic_scene.render(lfe.CAM, tex, Rb, tb)
        H = lfe._homography(Ra, ta, Rb, tb)
        rep = lfe.repeatability(seg_a, _port_detect(img_b, dep_b), H)
        assert rep == lfe.repeatability(lfe._detect(img_a, depth=dep_a),
                                        lfe._detect(img_b, depth=dep_b), H)
        assert rep > floor, f"repeatability {rep:.2f} at {angle} deg viewpoint"


@pytest.mark.slow
def test_line_matching_precision_with_degradations():
    """The original's gates on the port's descriptors; each case's
    precision and matchable count equal the JAX package's."""
    from tests import synthetic_scene
    from tests import test_line_frontend_eval as lfe

    rng = np.random.default_rng(11)
    tex = lfe._natural_texture(rng)
    Ra, ta = lfe._pose(0.0)
    Rb, tb = lfe._pose(8.0)
    img_a, dep_a = synthetic_scene.render(lfe.CAM, tex, Ra, ta)
    img_b0, dep_b = synthetic_scene.render(lfe.CAM, tex, Rb, tb)
    H = lfe._homography(Ra, ta, Rb, tb)
    seg_a = _port_detect(img_a, dep_a)
    cases = {
        "clean": img_b0,
        "low contrast": 0.55 * img_b0 + 50.0,
        "noise": np.clip(img_b0 + rng.normal(0, 5.0, img_b0.shape), 0, 255).astype(np.float32),
    }
    results = {}
    for name, img_b in cases.items():
        seg_b = _port_detect(img_b, dep_b)
        prec, n = _port_match_precision(img_a, img_b, seg_a, seg_b, H)
        assert (prec, n) == lfe.match_precision(img_a, img_b, seg_a, seg_b, H), name
        assert n >= 5, f"{name}: only {n} matchable pairs"
        floor = 0.65 if name == "clean" else 0.5
        assert prec >= floor, f"{name}: precision {prec:.2f} over {n} matches"
        results[name] = prec
    assert results["low contrast"] >= results["clean"] - 0.25
    assert results["noise"] >= results["clean"] - 0.35


# ---- tests/test_line_ba_joint_experiment.py (slow) --------------------------


def _port_ba_problem(obs, pose0, pts0, n_cams, n_pts):
    from structure_plp_slam_tpu_torch.models import bundle_adjustment as tba

    n_obs = len(obs["cam"])
    return tba.BAProblem(
        cam_pose=T(np.stack(pose0), torch.float32), cam_fixed=T(np.arange(n_cams) == 0),
        cam_valid=torch.ones(n_cams, dtype=torch.bool), lm_pos=T(pts0, torch.float32),
        lm_valid=torch.ones(n_pts, dtype=torch.bool), obs_cam=T(obs["cam"], torch.int64),
        obs_lm=T(obs["lm"], torch.int64), obs_uv=T(np.stack(obs["uv"]), torch.float32),
        obs_xr=torch.full((n_obs,), -1.0), obs_inv_sigma_sq=torch.ones(n_obs),
        obs_valid=torch.ones(n_obs, dtype=torch.bool))


def _port_point_only(cam, obs, pose0, pts0, n_cams, n_pts):
    from structure_plp_slam_tpu_torch.models import bundle_adjustment as tba

    prob = _port_ba_problem(obs, pose0, pts0, n_cams, n_pts)
    return tba.ba_solve(_port_camera(cam), prob, num_iters=12, cull_at_iters=()).cam_pose.numpy()


def _port_lines0(lines0):
    from structure_plp_slam_tpu_torch.ops import line_geometry as tlg

    pl0 = tlg.plucker_from_endpoints(T(np.stack([p for p, _ in lines0]), torch.float32),
                                     T(np.stack([q for _, q in lines0]), torch.float32))
    return tlg.plucker_to_orthonormal(pl0)


def _port_joint_production(cam, obs, lobs, pose0, pts0, lines0, n_cams, n_pts, n_lines):
    """``ba_solve`` with a ``LineWindow``: the production joint solver."""
    from structure_plp_slam_tpu_torch.models import bundle_adjustment as tba

    U0, w0 = _port_lines0(lines0)
    n_lobs = len(lobs["cam"])
    lw = tba.LineWindow(
        ln_U=U0, ln_w=w0, ln_valid=T(np.bincount(lobs["ln"], minlength=n_lines) >= 2),
        lobs_cam=T(lobs["cam"], torch.int64), lobs_line=T(lobs["ln"], torch.int64),
        lobs_seg=T(np.stack(lobs["seg"]), torch.float32), lobs_inv_sigma_sq=torch.ones(n_lobs),
        lobs_valid=torch.ones(n_lobs, dtype=torch.bool))
    prob = _port_ba_problem(obs, pose0, pts0, n_cams, n_pts)
    return tba.ba_solve(_port_camera(cam), prob, lw, num_iters=15,
                        cull_at_iters=()).cam_pose.numpy()


def _port_joint(cam, obs, lobs, pose0, pts0, lines0, n_cams, n_pts, n_lines):
    """``test_line_ba_joint_experiment._joint`` on the port's Lie group and
    line geometry: the experiment's dense accept / reject
    Levenberg-Marquardt over poses, points and orthonormal lines, its
    Jacobian by forward mode."""
    from structure_plp_slam_tpu_torch.ops import line_geometry as tlg
    from structure_plp_slam_tpu_torch.ops import linalg as tlinalg

    tcam = _port_camera(cam)
    po, pm = T(obs["cam"], torch.int64), T(obs["lm"], torch.int64)
    puv = T(np.stack(obs["uv"]), torch.float32)
    lo, lnid = T(lobs["cam"], torch.int64), T(lobs["ln"], torch.int64)
    lseg = T(np.stack(lobs["seg"]), torch.float32)
    pose_init = T(np.stack(pose0), torch.float32)
    pts_init = T(pts0, torch.float32)
    U0, w0 = _port_lines0(lines0)
    fixed = torch.arange(n_cams) == 0
    sizes = (n_cams * 6, n_pts * 3, n_lines * 4)

    def pose(dx_c):
        R, t = tlie.se3_update(pose_init[:, :, :3], pose_init[:, :, 3], dx_c)
        return (torch.where(fixed[:, None, None], pose_init[:, :, :3], R),
                torch.where(fixed[:, None], pose_init[:, :, 3], t))

    def res_flat(x):
        dx_c, dx_p, dx_l = torch.split(x, sizes)
        R, t = pose(dx_c.reshape(n_cams, 6))
        X = pts_init + dx_p.reshape(n_pts, 3)
        pc = torch.einsum("oij,oj->oi", R[po], X[pm]) + t[po]
        z = torch.clamp(pc[:, 2], min=1e-3)
        uv = torch.stack([tcam.fx * pc[:, 0] / z + tcam.cx, tcam.fy * pc[:, 1] / z + tcam.cy], 1)
        U2, w2 = tlg.orthonormal_update(U0, w0, dx_l.reshape(n_lines, 4))
        pl_c = tlg.transform_line(tlg.orthonormal_to_plucker(U2, w2)[lnid], R[lo], t[lo])
        r_ln = tlg.endpoint_line_distances(tlg.project_line(tcam, pl_c), lseg[:, 0:2],
                                           lseg[:, 2:4])
        return torch.cat([(uv - puv).reshape(-1), r_ln.reshape(-1)])

    x = torch.zeros(sum(sizes))
    lam = 1e-2
    cost = float(torch.sum(res_flat(x) ** 2))
    for _ in range(40):
        J = torch.func.jacfwd(res_flat)(x)
        r = res_flat(x)
        H = J.T @ J
        D = torch.diag(torch.clamp(torch.diagonal(H), min=1e-8))
        accepted = False
        for _try in range(6):
            dx = tlinalg.solve(H + lam * D, J.T @ r)
            if not bool(torch.isfinite(dx).all()):
                lam *= 10.0
                continue
            c_new = float(torch.sum(res_flat(x - dx) ** 2))
            if c_new < cost:
                x, cost = x - dx, c_new
                lam = max(lam / 3.0, 1e-7)
                accepted = True
                break
            lam *= 10.0
        if not accepted:
            break
    R, t = pose(torch.split(x, sizes)[0].reshape(n_cams, 6))
    return torch.cat([R, t[:, :, None]], 2).numpy()


@pytest.mark.slow
def test_production_joint_solver_beats_point_only():
    """The original's gate (the joint solve under half the point-only
    pose error, averaged over seeds 5-7) on the port's ``ba_solve``, with
    the JAX package's errors on the same corridors beside it (printed;
    within 1e-3 m of the port's)."""
    from tests import test_line_ba_joint_experiment as lbx

    errs_a, errs_p, jax_a, jax_p = [], [], [], []
    for s in range(3):
        rng = np.random.default_rng(5 + s)
        cam, poses, _, _, obs, lobs, pose0, pts0, lines0 = lbx._corridor(
            rng, n_cams=6, n_pts=12, n_lines=20)
        errs_a.append(lbx._pose_err(_port_point_only(cam, obs, pose0, pts0, 6, 12), poses))
        errs_p.append(lbx._pose_err(_port_joint_production(cam, obs, lobs, pose0, pts0, lines0,
                                                           6, 12, 20), poses))
        jax_a.append(lbx._pose_err(lbx._point_only(cam, obs, pose0, pts0, 6, 12), poses))
        jax_p.append(lbx._pose_err(lbx._joint_production(cam, obs, lobs, pose0, pts0, lines0,
                                                         6, 12, 20), poses))
    a, p = float(np.mean(errs_a)), float(np.mean(errs_p))
    print(f"\ncorridor pose RMSE, port: point-only {a * 100:.2f} cm, production joint "
          f"{p * 100:.2f} cm; JAX package: {np.mean(jax_a) * 100:.2f} / "
          f"{np.mean(jax_p) * 100:.2f} cm")
    assert p < 0.5 * a, f"joint {p} not clearly better than point-only {a}"
    assert np.abs(np.subtract(errs_a, jax_a)).max() < 1e-3
    assert np.abs(np.subtract(errs_p, jax_p)).max() < 1e-3


@pytest.mark.slow
def test_corridor_alternation_vs_joint():
    """The original's gates on the port: point-only BA and the
    experiment's joint point + line Gauss-Newton both improve on the
    perturbed initialization, and the joint solve is never much worse
    than point-only; with the JAX package's errors on the same corridors
    beside them (printed). Per seed the port's point-only error is within
    1e-3 m of JAX's, as the production solver's copy holds it. The joint
    solve is a damped Gauss-Newton on a rank-deficient f32 system (the
    monocular scale is free), whose rounding moves the iterate along the
    cost's flat valley: JAX's own solve, its initial points nudged by one
    ulp (four nudges), moves by up to 2.1e-2 m at seed 7 (printed). So its per-seed
    gap is held within 1e-3 m or that spread of JAX's, whichever is
    larger."""
    from tests import test_line_ba_joint_experiment as lbx

    errs_a, errs_b, errs_0, jax_a, jax_b, spread = [], [], [], [], [], []
    for s in range(3):
        rng = np.random.default_rng(5 + s)
        cam, poses, _, _, obs, lobs, pose0, pts0, lines0 = lbx._corridor(
            rng, n_cams=6, n_pts=12, n_lines=20)
        errs_0.append(lbx._pose_err(np.stack(pose0), poses))
        errs_a.append(lbx._pose_err(_port_point_only(cam, obs, pose0, pts0, 6, 12), poses))
        errs_b.append(lbx._pose_err(_port_joint(cam, obs, lobs, pose0, pts0, lines0, 6, 12, 20),
                                    poses))
        jax_a.append(lbx._pose_err(lbx._point_only(cam, obs, pose0, pts0, 6, 12), poses))
        jax_b.append(lbx._pose_err(lbx._joint(cam, obs, lobs, pose0, pts0, lines0, 6, 12, 20),
                                   poses))
        spread.append(max(abs(lbx._pose_err(lbx._joint(cam, obs, lobs, pose0, p, lines0,
                                                        6, 12, 20), poses) - jax_b[-1])
                          for p in _ulp_nudges(pts0, 4)))
    a, b, z = (float(np.mean(v)) for v in (errs_a, errs_b, errs_0))
    print(f"\ncorridor pose RMSE, port: init {z * 100:.2f} cm, point-only {a * 100:.2f} cm, "
          f"joint point+line {b * 100:.2f} cm; JAX package: {np.mean(jax_a) * 100:.2f} / "
          f"{np.mean(jax_b) * 100:.2f} cm; joint per seed: gap to JAX "
          f"{np.abs(np.subtract(errs_b, jax_b))} m, JAX's one-ulp spread {np.array(spread)} m")
    assert a < z
    assert b < z
    assert b < a * 1.5 + 0.01
    assert np.abs(np.subtract(errs_a, jax_a)).max() < 1e-3
    assert (np.abs(np.subtract(errs_b, jax_b)) <= np.maximum(1e-3, spread)).all()


def _ulp_nudges(pts, n):
    """``n`` copies of ``pts`` (as f32), each entry moved one ulp up or
    down at random (seeded)."""
    pts = np.asarray(pts, np.float32)
    rng = np.random.default_rng(100)
    return [np.where(rng.random(pts.shape) < 0.5, np.nextafter(pts, np.float32(np.inf)),
                     np.nextafter(pts, np.float32(-np.inf))) for _ in range(n)]
