"""Port parity: line geometry, detection, description and the line
mapper (ROADMAP A14).

The JAX functions and the port's take the same inputs (random geometry
from a numpy seed; 320x240 frames of the grid-textured scene; a map the
JAX System built with lines over 5 RGB-D frames, carried across with
``map_state.from_numpy``). Tolerances:

* line geometry within 1e-5;
* detection: valid masks and the picked hypotheses (their strengths, the
  inlier counts) exact, endpoints within 1e-3 px (the refit's f32 sums).
  The coarse pass runs on ``resize_bilinear``'s half-resolution image,
  summed in XLA:CPU's order for its shape (ROADMAP C8); the multiscale
  case checks it with the same tolerances;
* band descriptors within 1e-4; ``depth_at_points``' ok mask and depths
  exact (the 7x7 SAD sums and their mean in XLA:CPU's order);
* each line-mapper function and the ``LineWindow`` BA within 1e-4 on
  poses, within 1e-4 absolute plus 1e-4 relative on Plücker coordinates
  and endpoints (lines 6 m away carry moments of 6), indices, masks and
  counts exact.
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
from structure_plp_slam_tpu.data import map_state as jms
from structure_plp_slam_tpu.models import frontend as jfrontend
from structure_plp_slam_tpu.models import line_ba as jline_ba
from structure_plp_slam_tpu.models import line_mapper as jlm
from structure_plp_slam_tpu.models import mapper as jmapper
from structure_plp_slam_tpu.ops import line_geometry as jlg
from structure_plp_slam_tpu.ops import lines as jlines
from structure_plp_slam_tpu.ops import stereo as jstereo
from structure_plp_slam_tpu.ops.orb import OrbParams as JOrb
from structure_plp_slam_tpu.system import System as JSystem
from structure_plp_slam_tpu_torch.camera import Camera, CameraModel, CameraSetup
from structure_plp_slam_tpu_torch.models import frontend as tfrontend
from structure_plp_slam_tpu_torch.models import line_ba as tline_ba
from structure_plp_slam_tpu_torch.models import line_mapper as tlm
from structure_plp_slam_tpu_torch.models import mapper as tmapper
from structure_plp_slam_tpu_torch.ops import line_geometry as tlg
from structure_plp_slam_tpu_torch.ops import linalg as tlinalg
from structure_plp_slam_tpu_torch.ops import lines as tlines
from structure_plp_slam_tpu_torch.ops import stereo as tstereo
from structure_plp_slam_tpu_torch.ops.orb import OrbParams
from tests import synthetic_scene
from tests.test_torch_tracker import JCAM, TCAM, _KW, state_to_torch, to_torch

torch.set_num_threads(2)

GEO_TOL = 1e-5
EP_TOL = 1e-3   # px, detected endpoints
DESC_TOL = 1e-4
MAP_TOL = 1e-4


def T(a):
    return to_torch(a)


def J(a):
    return jnp.asarray(np.asarray(a))


def _close(t, j, tol, what="", rtol=0.0):
    np.testing.assert_allclose(np.asarray(t), np.asarray(j), atol=tol, rtol=rtol, err_msg=what)


# ---------------------------------------------------------------------------
# Line geometry.
# ---------------------------------------------------------------------------


def _rot(rng, n):
    from structure_plp_slam_tpu.ops import lie as jlie

    return np.asarray(jlie.so3_exp(jnp.asarray(rng.normal(scale=0.3, size=(n, 3)), jnp.float32)))


@functools.lru_cache(maxsize=1)
def _geo_inputs():
    rng = np.random.default_rng(0)
    n = 64
    p1 = rng.uniform([-2, -2, 3], [2, 2, 7], (n, 3)).astype(np.float32)
    p2 = (p1 + rng.normal(size=(n, 3))).astype(np.float32)
    R = _rot(rng, n)
    t = rng.normal(scale=0.3, size=(n, 3)).astype(np.float32)
    seg = rng.uniform([20, 20, 20, 20], [300, 220, 300, 220], (n, 4)).astype(np.float32)
    seg2 = (seg + rng.normal(scale=4.0, size=(n, 4))).astype(np.float32)
    delta = rng.normal(scale=0.05, size=(n, 4)).astype(np.float32)
    return dict(p1=p1, p2=p2, R=R, t=t, seg=seg, seg2=seg2, delta=delta)


GEOMETRY = ["plucker_from_endpoints", "closest_point_on_line", "transform_line",
            "project_line", "endpoint_line_distances", "triangulate_line_two_view",
            "trim_endpoints", "orthonormal"]


@pytest.mark.parametrize("name", GEOMETRY)
def test_line_geometry(name):
    g = _geo_inputs()
    jp = jlg.plucker_from_endpoints(J(g["p1"]), J(g["p2"]))
    tp = tlg.plucker_from_endpoints(T(g["p1"]), T(g["p2"]))
    if name == "plucker_from_endpoints":
        return _close(tp, jp, GEO_TOL)
    jp, tp = np.asarray(jp), tp
    if name == "closest_point_on_line":
        q = g["p2"] + 1.0
        return _close(tlg.closest_point_on_line(tp, T(q)),
                      jlg.closest_point_on_line(J(jp), J(q)), GEO_TOL)
    jc = jlg.transform_line(J(jp), J(g["R"]), J(g["t"]))
    tc = tlg.transform_line(tp, T(g["R"]), T(g["t"]))
    if name == "transform_line":
        return _close(tc, jc, GEO_TOL)
    jl = jlg.project_line(JCAM, jc)
    tl = tlg.project_line(TCAM, tc)
    if name == "project_line":
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=GEO_TOL, atol=1e-2)
        return None
    if name == "endpoint_line_distances":
        return _close(tlg.endpoint_line_distances(T(jl), T(g["seg"][:, :2]), T(g["seg"][:, 2:])),
                      jlg.endpoint_line_distances(jl, J(g["seg"][:, :2]), J(g["seg"][:, 2:])),
                      1e-3)
    if name == "triangulate_line_two_view":
        eye = np.eye(3, dtype=np.float32)
        z = np.zeros(3, np.float32)
        jw, jok = jlg.triangulate_line_two_view(JCAM, J(g["seg"]), J(g["seg2"]), J(eye), J(z),
                                                J(g["R"]), J(g["t"]))
        tw, tok = tlg.triangulate_line_two_view(TCAM, T(g["seg"]), T(g["seg2"]), T(eye), T(z),
                                                T(g["R"]), T(g["t"]))
        np.testing.assert_array_equal(tok.numpy(), np.asarray(jok))
        ok = np.asarray(jok)
        return _close(tw.numpy()[ok], np.asarray(jw)[ok], 1e-4)
    if name == "trim_endpoints":
        je, jok = jlg.trim_endpoints(JCAM, jc, J(g["seg"]))
        te, tok = tlg.trim_endpoints(TCAM, tc, T(g["seg"]))
        np.testing.assert_array_equal(tok.numpy(), np.asarray(jok))
        return _close(te, je, 1e-4)
    jU, jw = jlg.plucker_to_orthonormal(J(jp))
    tU, tw = tlg.plucker_to_orthonormal(tp)
    _close(tU, jU, GEO_TOL)
    _close(tw, jw, GEO_TOL)
    jU2, jw2 = jlg.orthonormal_update(jU, jw, J(g["delta"]))
    tU2, tw2 = tlg.orthonormal_update(tU, tw, T(g["delta"]))
    _close(tU2, jU2, GEO_TOL)
    _close(tw2, jw2, GEO_TOL)
    _close(tlg.orthonormal_to_plucker(tU2, tw2), jlg.orthonormal_to_plucker(jU2, jw2), GEO_TOL)
    return None


# ---------------------------------------------------------------------------
# Detection and description at 320x240.
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=1)
def _frames():
    tex = synthetic_scene.make_texture(np.random.default_rng(0), grid=True)
    out = []
    for R, t in synthetic_scene.trajectory(2, step=0.06):
        img, depth = synthetic_scene.render(JCAM, tex, R, t)
        right, _ = synthetic_scene.render(JCAM, tex, R, t - np.array([0.1, 0.0, 0.0]))
        out.append((img, depth, right))
    return out


def test_linspace_matches_jax():
    for a, b, n in ((0.1, 0.9, 8), (0.05, 0.95, 16)):
        np.testing.assert_array_equal(tlines._linspace(a, b, n, "cpu").numpy(),
                                      np.asarray(jnp.linspace(a, b, n)))


@pytest.mark.parametrize("frame", [0, 1])
def test_sobel_and_box(frame):
    img = _frames()[frame][0]
    for jt, tt in zip(jlines.sobel_gradients(J(img)), tlines.sobel_gradients(T(img))):
        _close(tt, jt, 1e-3)
    _close(tlines._box3(T(img)), jlines._box3(J(img)), 1e-4)


@pytest.mark.parametrize("multiscale", [False, True], ids=["single", "multiscale"])
@pytest.mark.parametrize("frame", [0, 1])
def test_detect_line_segments(frame, multiscale):
    img = _frames()[frame][0]
    if multiscale:
        j = jlines.detect_line_segments_multiscale(J(img), jax.random.PRNGKey(0))
        t = tlines.detect_line_segments_multiscale(T(img))
    else:
        j = jlines.detect_line_segments(J(img), jax.random.PRNGKey(0))
        t = tlines.detect_line_segments(T(img))
    (jseg, jval, jstr), (tseg, tval, tstr) = [tuple(np.asarray(a) for a in x) for x in (j, t)]
    np.testing.assert_array_equal(tval, jval)
    np.testing.assert_array_equal(tstr, jstr)  # the picked hypotheses' inlier counts
    assert jval.sum() >= 30
    _close(tseg[jval], jseg[jval], EP_TOL)


@pytest.mark.parametrize("frame", [0, 1])
def test_line_band_descriptors(frame):
    img = _frames()[frame][0]
    seg, val, _ = (np.asarray(a) for a in jlines.detect_line_segments_multiscale(
        J(img), jax.random.PRNGKey(0)))
    jd = jlines.line_band_descriptors(J(img), J(seg), J(val))
    td = tlines.line_band_descriptors(T(img), T(seg), T(val))
    _close(td, jd, DESC_TOL)
    jm = jlines.line_descriptor_distance_matrix(jd, jd[::-1], J(val), J(val[::-1]))
    tm = tlines.line_descriptor_distance_matrix(td, td.flip(0), T(val), T(val[::-1]))
    _close(tm, jm, DESC_TOL)


def test_depth_at_points():
    img, _, right = _frames()[0]
    rng = np.random.default_rng(1)
    pts = rng.uniform([0, 0], [319, 239], (500, 2)).astype(np.float32)
    jd, jok = jstereo.depth_at_points(J(img), J(right), J(pts), focal_x_baseline=26.0)
    td, tok = tstereo.depth_at_points(T(img), T(right), T(pts), focal_x_baseline=26.0)
    jok = np.asarray(jok)
    np.testing.assert_array_equal(tok.numpy(), jok)
    assert jok.sum() > 100
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))


def test_depth_at_points_card_ops(monkeypatch):
    """The card's SAD sums and mean (``torch.sum`` / ``torch.mean``, what
    ``linalg.tree_sum`` / ``tree_mean`` run on a CUDA tensor) on the same
    CPU tensors: ``ok`` equal, depths within 1e-6 relative of the JAX
    package's."""
    img, _, right = _frames()[0]
    rng = np.random.default_rng(1)
    pts = rng.uniform([0, 0], [319, 239], (500, 2)).astype(np.float32)
    monkeypatch.setattr(tlinalg, "tree_sum", lambda x, dim=-1: torch.sum(x, dim=dim))
    monkeypatch.setattr(tlinalg, "tree_mean", lambda x, dim=-1: torch.mean(x, dim=dim))
    jd, jok = jstereo.depth_at_points(J(img), J(right), J(pts), focal_x_baseline=26.0)
    td, tok = tstereo.depth_at_points(T(img), T(right), T(pts), focal_x_baseline=26.0)
    jok = np.asarray(jok)
    np.testing.assert_array_equal(tok.numpy(), jok)
    assert jok.sum() > 100
    np.testing.assert_allclose(td.numpy()[jok], np.asarray(jd)[jok], rtol=1e-6, atol=0)


@pytest.mark.parametrize("setup", ["rgbd", "stereo", "mono"])
def test_frontend_lines(setup):
    """``Frontend(with_lines=True)``: the three modes of ``_lines_impl``."""
    img, depth, right = _frames()[1]
    jsetup = {"rgbd": JSetup.RGBD, "stereo": JSetup.STEREO, "mono": JSetup.MONOCULAR}[setup]
    tsetup = {"rgbd": CameraSetup.RGBD, "stereo": CameraSetup.STEREO,
              "mono": CameraSetup.MONOCULAR}[setup]
    jcam = JCamera(setup=jsetup, model=JModel.PERSPECTIVE, **_KW)
    tcam = Camera(setup=tsetup, model=CameraModel.PERSPECTIVE, **_KW)
    pad = tfrontend.orb_ops.OrbExtractor(240, 320, OrbParams(max_num_keypts=600,
                                                            num_levels=4)).capacity
    jf = jfrontend.Frontend(jcam, JOrb(max_num_keypts=600, num_levels=4), pad_to=pad,
                            with_lines=True)
    tf = tfrontend.Frontend(tcam, OrbParams(max_num_keypts=600, num_levels=4), pad_to=pad,
                            with_lines=True, device="cpu")
    key = jax.random.PRNGKey(0)
    if setup == "rgbd":
        j, t = jf.rgbd(img, depth, key), tf.rgbd(img, depth)
    elif setup == "stereo":
        j, t = jf.stereo(img, right, key), tf.stereo(img, right)
    else:
        j, t = jf.mono(img, key), tf.mono(img)
    val = np.asarray(j["seg_valid"])
    np.testing.assert_array_equal(t["seg_valid"].numpy(), val)
    _close(t["seg"].numpy()[val], np.asarray(j["seg"])[val], EP_TOL)
    _close(t["seg_desc"], j["seg_desc"], DESC_TOL)
    _close(t["seg_depth"], j["seg_depth"], 1e-4)
    if setup != "mono":
        assert (np.asarray(j["seg_depth"])[val] > 0).sum() > 10


# ---------------------------------------------------------------------------
# The line mapper on a carried state.
# ---------------------------------------------------------------------------

NUM_FRAMES = 5


@functools.lru_cache(maxsize=1)
def jax_line_map():
    """The JAX System (lines on) after 5 grid-textured RGB-D frames, and
    the next frame's features and tracking result."""
    tex = synthetic_scene.make_texture(np.random.default_rng(0), grid=True)
    poses = synthetic_scene.trajectory(NUM_FRAMES + 1, step=0.06)
    frames = [synthetic_scene.render(JCAM, tex, R, t) for R, t in poses]
    cfg = JConfig(camera=JCAM, orb=JOrb(max_num_keypts=600, num_levels=4), raw={})
    js = JSystem(cfg, max_keyframes=8, max_landmarks=4096, enable_loop_closing=False,
                 max_kf_interval=2, with_lines=True, distributed_ba=False)
    js.startup()
    for i, (img, depth) in enumerate(frames[:NUM_FRAMES]):
        js.feed_RGBD_frame(img, depth, i / 30.0)
    state = js.state
    img, depth = frames[NUM_FRAMES]
    feats = js.frontend.rgbd(img, depth, jax.random.PRNGKey(0))
    return js, state, feats


def _free_rows(state, kfs):
    """``state`` with keyframes ``kfs``' segments unassociated."""
    kli = np.array(state.kf_line_idx)
    kli[list(kfs)] = -1
    return state._replace(kf_line_idx=jnp.asarray(kli))


def _assert_lines(j_state, t_state):
    for f in ("ln_valid", "ln_ref_kf", "kf_line_idx", "ln_n_vis", "ln_n_fnd"):
        np.testing.assert_array_equal(getattr(t_state, f).numpy(),
                                      np.asarray(getattr(j_state, f)), err_msg=f)
    v = np.asarray(j_state.ln_valid)
    for f in ("ln_pluck", "ln_endpoints", "ln_desc"):
        _close(getattr(t_state, f).numpy()[v], np.asarray(getattr(j_state, f))[v], MAP_TOL, f,
               rtol=MAP_TOL)


def _slots():
    js, state, _ = jax_line_map()
    valid = np.flatnonzero(np.asarray(state.kf_valid))
    return int(valid[-1]), int(valid[-2]), int(js.next_line)


def test_line_map_is_rich():
    js, state, _ = jax_line_map()
    assert int(np.asarray(state.ln_valid).sum()) >= 20
    assert int(np.asarray(state.kf_valid).sum()) >= 3


def test_match_and_update_line_stats():
    _, state, feats = jax_line_map()
    slot, _, _ = _slots()
    R, t = state.kf_pose[slot, :, :3], state.kf_pose[slot, :, 3]
    j = jlm.match_lines_to_frame(JCAM, state, feats["seg"], feats["seg_desc"],
                                 feats["seg_valid"], R, t)
    ts = state_to_torch(state)
    tt = tlm.match_lines_to_frame(TCAM, ts, T(feats["seg"]), T(feats["seg_desc"]),
                                  T(feats["seg_valid"]), T(R), T(t))
    np.testing.assert_array_equal(tt.numpy(), np.asarray(j))
    assert (np.asarray(j) >= 0).sum() >= 3
    _assert_lines(jlm.update_line_stats(JCAM, state, j, R, t),
                  tlm.update_line_stats(TCAM, ts, tt, T(R), T(t)))


def test_cull_lines():
    _, state, _ = jax_line_map()
    slot, _, _ = _slots()
    # Raise the visibility counts so the ratio rule fires too.
    st = state._replace(ln_n_vis=state.ln_n_vis + 4)
    js, jn = jlm.cull_lines(st, slot + 2)
    ts, tn = tlm.cull_lines(state_to_torch(st), slot + 2)
    assert int(tn) == int(jn) >= 1
    _assert_lines(js, ts)


@pytest.mark.parametrize("fn", ["lines_from_depth", "lines_from_points"])
def test_line_creation(fn):
    _, state, _ = jax_line_map()
    slot, _, base = _slots()
    st = _free_rows(state, [slot])
    js, jn = getattr(jlm, fn)(JCAM, st, slot, base)
    ts, tn = getattr(tlm, fn)(TCAM, state_to_torch(st), slot, base)
    assert int(tn) == int(jn) >= 1
    _assert_lines(js, ts)


def test_refresh_lines():
    _, state, _ = jax_line_map()
    # Move a keyframe so the refresh has something to do.
    pose = np.array(state.kf_pose)
    slot, _, _ = _slots()
    pose[slot, :, 3] += [0.02, -0.01, 0.03]
    st = state._replace(kf_pose=jnp.asarray(pose))
    _assert_lines(jlm.refresh_lines(JCAM, st), tlm.refresh_lines(TCAM, state_to_torch(st)))


@pytest.mark.parametrize("fn", ["pair", "neighbors"])
def test_two_view_lines(fn):
    _, state, _ = jax_line_map()
    slot, prev, base = _slots()
    st = _free_rows(state, [slot, prev])
    if fn == "pair":
        js, jn = jlm.triangulate_lines_pair(JCAM, st, slot, prev, base)
        ts, tn = tlm.triangulate_lines_pair(TCAM, state_to_torch(st), slot, prev, base)
    else:
        js, jn = jlm.triangulate_lines_with_neighbors(JCAM, st, slot, base)
        ts, tn = tlm.triangulate_lines_with_neighbors(TCAM, state_to_torch(st), slot, base)
    assert int(tn) == int(jn) >= 1
    _assert_lines(js, ts)


def _track_inputs():
    """The next frame tracked by the JAX tracker (points only), and the
    inputs of its line tracking step, as the JAX System's _track_step
    builds them."""
    from structure_plp_slam_tpu.models import tracker as jtracker

    js, state, feats = jax_line_map()
    (R, t), (Rv, tv) = js.pose, js.vel
    res = jtracker.track_frame(
        JCAM, state, feats, Rv @ R, Rv @ t + tv, js.last_kp_lm, js._ref_kf_dev,
        js.frontend.inv_sigma_sq, js._obs_indicator(), jnp.int32(3), num_levels=4,
        scale_factor=1.2)
    L = state.lm_pos.shape[0]
    pts = state.lm_pos[jnp.clip(res.kp_lm, 0, L - 1)]
    info = js.frontend.inv_sigma_sq[jnp.clip(feats["level"], 0, 3)]
    valid = (res.kp_lm >= 0) & feats["valid"]
    args = (feats["seg"], feats["seg_desc"], feats["seg_valid"], pts, feats["xy"], info, valid)
    return state, args, res.R, res.t


def test_track_lines():
    state, args, R, t = _track_inputs()
    j_state, jR, jt, jl = jlm.track_lines(JCAM, state, *args, R, t)
    t_state, tR, tt, tl = tlm.track_lines(TCAM, state_to_torch(state), *(T(a) for a in args),
                                          T(R), T(t))
    assert (np.asarray(jl) >= 0).sum() >= 3
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    _close(tR, jR, MAP_TOL)
    _close(tt, jt, MAP_TOL)
    _assert_lines(j_state, t_state)


def test_refine_pose_with_lines():
    """From a perturbed pose: the joint point + line Gauss-Newton."""
    state, args, R, t = _track_inputs()
    seg_lines = jlm.match_lines_to_frame(JCAM, state, *args[:3], R, t)
    L2 = state.ln_pluck.shape[0]
    pl = state.ln_pluck[jnp.clip(seg_lines, 0, L2 - 1)]
    t0 = t + jnp.asarray([0.01, -0.005, 0.008])
    jR, jt, jinl = jlm.refine_pose_with_lines(JCAM, R, t0, *args[3:], pl, args[0],
                                              seg_lines >= 0)
    tR, tt, tinl = tlm.refine_pose_with_lines(TCAM, T(R), T(t0), *(T(a) for a in args[3:]),
                                              T(pl), T(args[0]), T(seg_lines >= 0))
    np.testing.assert_array_equal(tinl.numpy(), np.asarray(jinl))
    _close(tR, jR, MAP_TOL)
    _close(tt, jt, MAP_TOL)


def test_local_ba_line_window():
    """The joint point + line local BA (``LineWindow`` in ``ba_solve``)."""
    js, state, _ = jax_line_map()
    slot, _, _ = _slots()
    ind = jms.observation_indicator(state)
    j_state, jchi, jcams = jmapper.local_ba(JCAM, state, slot, js.frontend.inv_sigma_sq,
                                            with_lines=True, ind=ind, return_cams=True)
    t_state, tchi, tcams = tmapper.local_ba(TCAM, state_to_torch(state), slot,
                                            T(js.frontend.inv_sigma_sq), with_lines=True,
                                            ind=T(ind), return_cams=True)
    np.testing.assert_array_equal(tcams.numpy(), np.asarray(jcams))
    np.testing.assert_array_equal(t_state.kf_lm_idx.numpy(), np.asarray(j_state.kf_lm_idx))
    _close(t_state.kf_pose, j_state.kf_pose, MAP_TOL)
    _close(t_state.lm_pos, j_state.lm_pos, 1e-3)
    _assert_lines(j_state, t_state)
    moved = np.abs(np.asarray(j_state.ln_pluck) - np.asarray(state.ln_pluck)).max(1) > 1e-6
    assert moved.sum() >= 3


def test_refine_lines():
    """The full-map line polish (``line_ba.refine_lines``), from keyframe
    poses nudged so every line has something to correct."""
    _, state, _ = jax_line_map()
    pose = np.array(state.kf_pose)
    pose[:, :, 3] += np.random.default_rng(2).normal(scale=0.004, size=pose[:, :, 3].shape)
    st = state._replace(kf_pose=jnp.asarray(pose.astype(np.float32)))
    j = jline_ba.refine_lines(JCAM, st, num_iters=12)
    t = tline_ba.refine_lines(TCAM, state_to_torch(st), num_iters=12)
    _assert_lines(j, t)
    moved = np.abs(np.asarray(j.ln_pluck) - np.asarray(st.ln_pluck)).max(1) > 1e-6
    assert moved.sum() >= 3
