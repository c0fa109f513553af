"""Port parity: plane fitting and the planar mapper (ROADMAP A13).

The JAX functions and the port's take the same inputs (random point sets
from a numpy seed, and a map the JAX System built over 5 rendered RGB-D
frames at 320x240, carried across with ``map_state.from_numpy``):

* RANSAC draws bit-equal, inlier masks, ``label_keypoints`` and
  ``knn_graph`` exact;
* plane coefficients within 1e-5 up to a joint sign of (n, d): the
  normal is the smallest eigenvector of a 3x3 covariance, whose sign
  LAPACK and XLA need not agree on (ROADMAP C10);
* ``detect_planes``, ``merge_planes``, ``refine_planes`` and
  ``snap_points_to_planes`` each on one carried state: validity and
  landmark ownership exact, positions within 1e-5.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from structure_plp_slam_tpu.config import Config as JConfig
from structure_plp_slam_tpu.models import mapper as jmapper
from structure_plp_slam_tpu.models import planar_mapper as jpm
from structure_plp_slam_tpu.ops import plane_fit as jpf
from structure_plp_slam_tpu.ops import ransac as jransac
from structure_plp_slam_tpu.ops.orb import OrbParams as JOrb
from structure_plp_slam_tpu.system import System as JSystem
from structure_plp_slam_tpu_torch.models import mapper as tmapper
from structure_plp_slam_tpu_torch.models import planar_mapper as tpm
from structure_plp_slam_tpu_torch.ops import plane_fit as tpf
from structure_plp_slam_tpu_torch.ops import ransac as transac
from structure_plp_slam_tpu_torch.utils import prng
from tests import synthetic_scene
from tests.test_torch_tracker import JCAM, state_to_torch, to_torch

torch.set_num_threads(2)

TOL = 1e-5


def _key(seed):
    return jax.random.PRNGKey(seed), prng.PRNGKey(seed)


def _coef_close(a, b, tol=TOL):
    """Plane coefficients ``[..., 4]`` equal up to a joint sign per plane."""
    a, b = np.asarray(a).reshape(-1, 4), np.asarray(b).reshape(-1, 4)
    err = np.minimum(np.abs(a - b).max(1), np.abs(a + b).max(1))
    assert err.max() < tol, err


def _plane_cloud(seed, n_in=200, n_out=60, noise=0.01):
    """Points on a tilted plane (plus noise) and gross outliers."""
    rng = np.random.default_rng(seed)
    n_gt = np.array([0.2, -0.3, 0.93])
    n_gt /= np.linalg.norm(n_gt)
    basis = np.linalg.svd(n_gt[None])[2][1:]
    pts = 2.0 * n_gt + rng.uniform(-3, 3, (n_in, 2)) @ basis
    pts = pts + rng.normal(scale=noise, size=(n_in, 3))
    out = rng.normal(scale=2.0, size=(n_out, 3)) + [0, 0, 2.0]
    allp = np.concatenate([pts, out]).astype(np.float32)
    valid = rng.uniform(size=len(allp)) > 0.1
    return allp, valid


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fit_plane_svd(seed):
    pts, valid = _plane_cloud(seed)
    w = np.where(valid, np.random.default_rng(seed).uniform(0.2, 1.0, len(pts)), 0.0)
    w = w.astype(np.float32)
    jn, jd = jpf.fit_plane_svd(jnp.asarray(pts), jnp.asarray(w))
    tn, td = tpf.fit_plane_svd(torch.from_numpy(pts), torch.from_numpy(w))
    _coef_close(np.append(np.asarray(jn), float(jd)), np.append(tn.numpy(), float(td)))
    coef = np.append(np.asarray(jn), float(jd)).astype(np.float32)
    np.testing.assert_allclose(
        tpf.point_plane_distance(torch.from_numpy(coef), torch.from_numpy(pts)).numpy(),
        np.asarray(jpf.point_plane_distance(jnp.asarray(coef), jnp.asarray(pts))), atol=TOL)


@pytest.mark.parametrize("seed", [0, 1])
def test_ransac_draws_bit_equal(seed):
    """The 3-point minimal sets both packages draw from the same key."""
    _, valid = _plane_cloud(seed)
    jk, tk = _key(seed)
    j = jransac.sample_minimal_sets(jk, 128, 3, len(valid), jnp.asarray(valid))
    t = transac.sample_minimal_sets(tk, 128, 3, len(valid), torch.from_numpy(valid))
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))


@pytest.mark.parametrize("coherent", [False, True], ids=["msac", "coherent"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_plane_ransac(seed, coherent):
    """Inlier masks exact, coefficients within 1e-5 up to sign."""
    pts, valid = _plane_cloud(seed)
    jk, tk = _key(seed)
    jfn = jpf.plane_ransac_coherent if coherent else jpf.plane_ransac
    tfn = tpf.plane_ransac_coherent if coherent else tpf.plane_ransac
    jc, ji, jn = jfn(jnp.asarray(pts), jnp.asarray(valid), jk, inlier_thr=0.04)
    tc, ti, tn = tfn(torch.from_numpy(pts), torch.from_numpy(valid), tk, inlier_thr=0.04)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    assert int(tn) == int(jn) > 150
    _coef_close(jc, tc.numpy())


@pytest.mark.parametrize("seed", [0, 1])
def test_knn_graph(seed):
    pts, valid = _plane_cloud(seed, n_in=120, n_out=30)
    pts[5] = pts[9]  # a distance tie
    jn, jo = jpf.knn_graph(jnp.asarray(pts), jnp.asarray(valid))
    tn, to = tpf.knn_graph(torch.from_numpy(pts), torch.from_numpy(valid))
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    np.testing.assert_array_equal(to.numpy(), np.asarray(jo))


@pytest.mark.parametrize("check_3x3", [True, False])
def test_label_keypoints(check_3x3):
    rng = np.random.default_rng(3)
    mask = np.zeros((60, 80), np.int32)
    mask[10:30, 10:40] = 1
    mask[35:55, 45:75] = 2
    mask[5:20, 50:70] = 7
    xy = rng.uniform([0, 0], [80, 60], (300, 2)).astype(np.float32)
    valid = rng.uniform(size=300) > 0.2
    j = jpm.label_keypoints(jnp.asarray(mask), jnp.asarray(xy), jnp.asarray(valid),
                            check_3x3=check_3x3)
    t = tpm.label_keypoints(torch.from_numpy(mask).long(), torch.from_numpy(xy),
                            torch.from_numpy(valid), check_3x3=check_3x3)
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    assert (np.asarray(j) > 0).sum() > 50


def test_planar_params_from_raw():
    raw = {"Threshold.max_instances": 4, "Threshold.plane_distance_correction": 0.03,
           "Threshold.use_graph_cut": False, "Threshold.inliers_ratio_thr": 0.6}
    j, t = jpm.PlanarParams.from_raw(raw), tpm.PlanarParams.from_raw(raw)
    assert {f: getattr(t, f) for f in t.__dataclass_fields__} == \
        {f: getattr(j, f) for f in j.__dataclass_fields__}


# ---------------------------------------------------------------------------
# The planar mapper on a carried state.
# ---------------------------------------------------------------------------

NUM_FRAMES = 5


@functools.lru_cache(maxsize=1)
def jax_point_map():
    """A JAX System's map after 5 grid-textured RGB-D frames (no planes
    yet), the last keyframe and the instance mask of its frame."""
    rng = np.random.default_rng(0)
    tex = synthetic_scene.make_texture(rng, grid=True)
    poses = synthetic_scene.trajectory(NUM_FRAMES, step=0.06)
    frames = [synthetic_scene.render(JCAM, tex, R, t) for R, t in poses]
    cfg = JConfig(camera=JCAM, orb=JOrb(max_num_keypts=600, num_levels=4), raw={})
    js = JSystem(cfg, max_keyframes=8, max_landmarks=4096, enable_loop_closing=False,
                 max_kf_interval=2, distributed_ba=False)
    js.startup()
    for i, (img, depth) in enumerate(frames):
        js.feed_RGBD_frame(img, depth, i / 30.0)
    js.shutdown()
    state = js.state
    slot = int(js.next_kf) - 1
    frame = int(round(float(state.kf_timestamp[slot]) * 30.0))
    seg = np.where(frames[frame][1] < 4.5, 1, 2).astype(np.int32)
    return state, slot, seg


def _assert_state(j, t, exact, close=(), tol=TOL):
    for f in exact:
        np.testing.assert_array_equal(getattr(t, f).numpy(), np.asarray(getattr(j, f)),
                                      err_msg=f)
    for f in close:
        np.testing.assert_allclose(getattr(t, f).numpy(), np.asarray(getattr(j, f)),
                                   atol=tol, err_msg=f)


def test_map_scale():
    state, slot, _ = jax_point_map()
    for kf in range(slot + 1):
        j = float(jmapper.map_scale(state, kf))
        t = float(tmapper.map_scale(state_to_torch(state), kf))
        assert t == j


@functools.lru_cache(maxsize=4)
def detect_both(coherent, mono_gates):
    state, slot, seg = jax_point_map()
    labels = jpm.label_keypoints(jnp.asarray(seg), state.kf_xy[slot], state.kf_kp_valid[slot])
    scale = jmapper.map_scale(state, slot)
    kw = dict(thr_mult=5.0, ratio_override=0.45) if mono_gates else {}
    jk, tk = _key(7)
    j_out = jpm.detect_planes(state, slot, labels, 3, jk, scale, coherent=coherent, **kw)
    t_out = tpm.detect_planes(state_to_torch(state), slot, to_torch(labels), 3, tk,
                              to_torch(scale), coherent=coherent, **kw)
    return j_out, t_out


@pytest.mark.parametrize("coherent,mono_gates", [(True, False), (False, False), (True, True)],
                         ids=["coherent", "msac", "mono_gates"])
def test_detect_planes(coherent, mono_gates):
    (js, jn), (ts, tn) = detect_both(coherent, mono_gates)
    assert int(tn) == int(jn) >= 1
    _assert_state(js, ts, ("pl_valid", "pl_needs_refresh", "pl_ref_kf", "lm_plane"))
    v = np.asarray(js.pl_valid)
    _coef_close(np.asarray(js.pl_coef)[v], ts.pl_coef.numpy()[v])
    assert (np.asarray(js.lm_plane) >= 0).sum() > 30


@functools.lru_cache(maxsize=1)
def merge_input():
    """The detected planes with a near-duplicate of the first valid plane
    in a free slot (offset 0.01 closer) owning every second landmark of
    the original: a pair ``merge_planes`` must merge."""
    (js, _), _ = detect_both(True, False)
    coef = np.array(js.pl_coef)
    valid = np.array(js.pl_valid)
    lm_plane = np.array(js.lm_plane)
    p = int(np.flatnonzero(valid)[0])
    q = int(np.flatnonzero(~valid)[-1])
    coef[q] = coef[p]
    coef[q, 3] -= 0.01 * np.sign(coef[q, 3])
    valid[q] = True
    owned = np.flatnonzero(lm_plane == p)
    lm_plane[owned[::2]] = q
    return js._replace(pl_coef=jnp.asarray(coef), pl_valid=jnp.asarray(valid),
                       lm_plane=jnp.asarray(lm_plane))


def test_merge_planes():
    st = merge_input()
    state, slot, _ = jax_point_map()
    scale = jmapper.map_scale(state, slot)
    js, jn = jpm.merge_planes(st, scale)
    ts, tn = tpm.merge_planes(state_to_torch(st), to_torch(scale))
    assert int(tn) == int(jn) >= 1
    _assert_state(js, ts, ("pl_valid", "pl_needs_refresh", "lm_plane"))


def _merged():
    state, slot, _ = jax_point_map()
    scale = jmapper.map_scale(state, slot)
    return jpm.merge_planes(merge_input(), scale)[0], scale


def test_refine_planes():
    st, scale = _merged()
    js = jpm.refine_planes(st, scale)
    ts = tpm.refine_planes(state_to_torch(st), to_torch(scale))
    _assert_state(js, ts, ("pl_valid", "pl_needs_refresh", "lm_plane"))
    v = np.asarray(js.pl_valid)
    _coef_close(np.asarray(js.pl_coef)[v], ts.pl_coef.numpy()[v])


def test_snap_points_to_planes():
    st, scale = _merged()
    st = jpm.refine_planes(st, scale)
    js = jpm.snap_points_to_planes(st, scale)
    ts = tpm.snap_points_to_planes(state_to_torch(st), to_torch(scale))
    _assert_state(js, ts, ("lm_plane",), ("lm_pos",))
    moved = np.abs(np.asarray(js.lm_pos) - np.asarray(st.lm_pos)).max(1) > 0
    assert moved.sum() > 30
