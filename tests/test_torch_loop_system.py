"""Port parity: the loop closer and the System's deferred loop machinery.

Inputs: the rendered RGB-D sequence at 320x240 (600 keypoints over 4
levels), and tests/test_global_ba.py's map for the deferred global BA.

* ``LoopCloser.detect_consume`` on the same packed scores and covisibility:
  the same candidate on every call, the same continuity clusters;
* ``validate`` on the JAX System's map (carried across with
  ``map_state.from_numpy``) and the same key: match and inlier counts
  equal, R / t / s within 1e-4;
* ``correct`` (neighbourhood correction, duplicate fusion through the
  matcher, pose graph, global BA): keyframe poses within 1e-3 and
  landmarks within 1e-2 of the JAX closer's; associations equal on >= 99%
  of the slots;
* the deferred global BA, advanced phase by phase on a bare System,
  lands within 5e-3 of the one-shot solve (the JAX test's bound) and
  within 1e-4 of the JAX package's; a keyframe and a landmark inserted
  mid-solve ride the delta of their parent at 1e-4 (mirroring
  tests/test_async_loop_ba.py's first and third tests);
* a System with loop closing on that scores 3 keyframes for loops: the
  same detections consumed and the same poses as the JAX System, within
  1e-3.

The JAX System's detection is gated on its packed array being ready,
which on the CPU depends on XLA's async dispatch; the tests block on it
before each feed, so the JAX side consumes a detection at the next
keyframe, as the port (whose CPU reads are always ready) does.

Slow: ``tests/test_loop_system.py::test_organic_loop_closure_from_feed_
only`` on both Systems (the same loop, the same count; the loop fix
replayed on both from the JAX System's map at its start: keyframe poses
within 1e-3 m / 1e-3 after the merge), and chip_smoke.py's loop path at
its width and capacities, where ROADMAP C15 could bear on it.
"""

import dataclasses
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
from structure_plp_slam_tpu.models import global_ba as jgba
from structure_plp_slam_tpu.models import loop_closer as jloop
from structure_plp_slam_tpu.ops.orb import OrbParams as JOrb
from structure_plp_slam_tpu.system import System as JSystem
from structure_plp_slam_tpu_torch.camera import Camera, CameraModel, CameraSetup
from structure_plp_slam_tpu_torch.config import Config
from structure_plp_slam_tpu_torch.data import map_state as tms
from structure_plp_slam_tpu_torch.models import global_ba as tgba
from structure_plp_slam_tpu_torch.models import loop_closer as tloop
from structure_plp_slam_tpu_torch.ops import lie as tlie
from structure_plp_slam_tpu_torch.ops.orb import OrbParams
from structure_plp_slam_tpu_torch.system import StageTimer, System
from structure_plp_slam_tpu_torch.testing import synthetic_scene
from structure_plp_slam_tpu_torch.utils import prng
from structure_plp_slam_tpu_torch.utils.types import HostCopy
from tests.test_global_ba import _make_state

torch.set_num_threads(2)

_KW = dict(name="synt", cols=320, rows=240, fx=260.0, fy=260.0, cx=159.5, cy=119.5,
           fps=30.0, focal_x_baseline=26.0, depth_threshold=400.0, depthmap_factor=1.0)
JCAM = JCamera(setup=JSetup.RGBD, model=JModel.PERSPECTIVE, **_KW)
TCAM = Camera(setup=CameraSetup.RGBD, model=CameraModel.PERSPECTIVE, **_KW)
ORB = dict(max_num_keypts=600, num_levels=4)


def N(t):
    return t.detach().cpu().numpy()


def _jax_system(cam=JCAM, orb=ORB, **kw):
    # The suite's 8 virtual CPU devices would send the JAX System's
    # post-loop global BA to its mesh; the port's System on the CPU has
    # one device and solves on it, so both solve on one device.
    return JSystem(JConfig(camera=cam, orb=JOrb(**orb), raw={}), distributed_ba=False, **kw)


def _port_system(cam=TCAM, orb=ORB, **kw):
    return System(Config(camera=cam, orb=OrbParams(**orb), raw={}), device="cpu", **kw)


def feed_all(slam, frames):
    """Feed frames; before each, block on the JAX System's pending
    detection so that its readiness gate does not depend on timing."""
    for img, depth, ts in frames:
        if isinstance(slam, JSystem) and slam._pending_loop is not None:
            jax.block_until_ready(slam._pending_loop[1][0])
        slam.feed_RGBD_frame(img, depth, ts)


@functools.lru_cache(maxsize=1)
def _frames():
    return synthetic_scene.make_sequence(np.random.default_rng(0), TCAM, num_frames=12)[0]


@functools.lru_cache(maxsize=1)
def jax_map():
    """The JAX System's map after 8 frames (loop closing off) as numpy."""
    js = _jax_system(max_keyframes=8, max_landmarks=4096, max_kf_interval=2,
                     enable_loop_closing=False)
    js.startup()
    feed_all(js, _frames()[:8])
    js.shutdown()
    st = js.state
    return js, {f: np.asarray(getattr(st, f)) for f in st._fields}


# ---------------------------------------------------------------------------
# Detection.
# ---------------------------------------------------------------------------


def test_detect_consume_continuity_parity():
    """Four detections in a row on a 40-keyframe map with a revisit of
    keyframes 2-4: the candidates' covisibility clusters continue from
    call to call, and the loop fires on the third."""
    rng = np.random.default_rng(5)
    K = 40
    W = np.zeros((K, K), np.int64)
    for k in range(K - 1):  # a chain of covisible neighbours
        W[k, k + 1] = W[k + 1, k] = 60
    W[2, 3] = W[3, 2] = W[3, 4] = W[4, 3] = 80
    np.fill_diagonal(W, 300)
    valid = np.ones(K, bool)
    valid[[7, 19]] = False
    jl, tl = jloop.LoopCloser(JCAM), tloop.LoopCloser(TCAM, device="cpu")
    fired = []
    for kf in (30, 31, 32, 33):
        sims = rng.uniform(0.0, 0.05, K).astype(np.float32)
        sims[[2, 3, 4]] = rng.uniform(0.3, 0.6, 3)
        sims[kf - 1] = 0.05  # the weakest covisible neighbour sets the min score
        packed = np.stack([W[kf], sims, valid], 1).astype(np.float32)
        cj = jl.detect_consume((jnp.asarray(packed), jnp.asarray(W)), kf)
        ct = tl.detect_consume((HostCopy(torch.from_numpy(packed)), torch.from_numpy(W)), kf)
        assert cj == ct
        assert [(sorted(c), n) for c, n in tl._continuity] == \
            [(sorted(c), n) for c, n in jl._continuity]
        fired.append(ct)
    assert fired[:2] == [None, None] and fired[2] in (2, 3, 4)


def test_entry_points_default_to_the_card():
    """``LoopCloser``, ``global_ba.prepare_from_arrays`` and
    ``distributed_ba.shard_chain_pairs`` run on CUDA unless the caller asks
    for another device, and raise without a card (nothing falls back to
    the CPU); with ``device="cpu"`` they run here."""
    from structure_plp_slam_tpu_torch.parallel import distributed_ba as tdba

    kf_valid = np.ones(2, bool)
    kp_valid = np.ones((2, 3), bool)
    lm_idx = np.array([[0, 1, -1], [0, 1, 2]])
    arrays = (kf_valid, kp_valid, lm_idx, np.ones(3, bool), np.zeros((2, 3, 2), np.float32),
              np.full((2, 3), -1.0, np.float32), np.zeros((2, 3), np.int64),
              np.ones(8, np.float32))
    pairs = (np.array([0]), np.array([1]), np.array([[0, 0], [0, 1]]), 1, np.array([0]))
    if torch.cuda.is_available():
        assert tloop.LoopCloser(TCAM).device.type == "cuda"
    else:
        for make in (lambda: tloop.LoopCloser(TCAM),
                     lambda: tgba.prepare_from_arrays(*arrays),
                     lambda: tdba.shard_chain_pairs(*pairs)):
            with pytest.raises(RuntimeError, match="no CUDA device"):
                make()
    lc = tloop.LoopCloser(TCAM, device="cpu")
    assert lc.device == torch.device("cpu")
    W = np.full((4, 4), 60, np.int64)
    packed = np.stack([W[3], np.full(4, 0.5), np.ones(4)], 1).astype(np.float32)
    assert lc.detect_consume((HostCopy(torch.from_numpy(packed)), torch.from_numpy(W)), 3) is None
    data = tgba.prepare_from_arrays(*arrays, device="cpu")
    assert data.num_obs == 5
    o1, o2, cpos = tdba.shard_chain_pairs(*pairs, device="cpu")
    assert o1.device.type == "cpu" and int(o1[0]) == 0 and int(o2[0]) == 1


# ---------------------------------------------------------------------------
# Validation and correction on the JAX System's map.
# ---------------------------------------------------------------------------


def _loop_pair(arrays):
    valid = np.where(arrays["kf_valid"])[0]
    return int(valid[-1]), int(valid[0])


def test_detect_dispatch_parity():
    """The detection arrays of the map's last keyframe (covisibility row,
    retrieval scores, validity) and its covisibility matrix: exact."""
    js, arrays = jax_map()
    kf, _ = _loop_pair(arrays)
    packed_j, cov_j = jloop._detect_packed(js.state, kf, js.loop_closer.bow)
    tl = tloop.LoopCloser(TCAM, device="cpu")
    copy, cov_t = tl.detect_dispatch(tms.from_numpy(arrays, "cpu"), kf)
    assert (copy.numpy() == np.asarray(packed_j)).all()
    assert (N(cov_t) == np.asarray(cov_j)).all()
    tl.last_loop_kf = kf - 1  # inside the cool-down: no detection
    assert tl.detect_dispatch(tms.from_numpy(arrays, "cpu"), kf) is None


def test_validate_parity():
    js, arrays = jax_map()
    kf_cur, cand = _loop_pair(arrays)
    vj = np.asarray(jloop._validate_packed(JCAM, js.state, kf_cur, cand,
                                           jax.random.PRNGKey(11)))
    vt = N(tloop._validate_packed(TCAM, tms.from_numpy(arrays, "cpu"), kf_cur, cand,
                                  prng.PRNGKey(11)))
    assert (vt[:3] == vj[:3]).all() and vt[0] >= tloop.MIN_INLIERS, (vt[:3], vj[:3])
    np.testing.assert_allclose(vt[3:], vj[3:], atol=1e-4)
    # Keyframes of one map: the similarity is close to their relative pose.
    P1, P2 = arrays["kf_pose"][kf_cur], arrays["kf_pose"][cand]
    R_rel = P2[:, :3] @ P1[:, :3].T
    assert np.abs(vt[4:13].reshape(3, 3) - R_rel).max() < 5e-3 and abs(vt[3] - 1) < 0.02


def test_correct_parity():
    js, arrays = jax_map()
    kf_cur, cand = _loop_pair(arrays)
    jst = js.state
    val = jloop.LoopCloser(JCAM).validate(jst, kf_cur, cand, jax.random.PRNGKey(11))
    assert val is not None
    R21, t21, s21 = val
    # A loop of the same keyframes with an injected offset (the "drift" a
    # real loop removes): the candidate seen 0.2 m off.
    t21 = (t21 + np.array([0.2, 0.0, 0.0], np.float32)).astype(np.float32)
    table = np.asarray(js.frontend.inv_sigma_sq)
    jl, tl = jloop.LoopCloser(JCAM), tloop.LoopCloser(TCAM, device="cpu")
    out_j = jl.correct(jst, kf_cur, cand, R21, t21, s21, table)
    out_t = tl.correct(tms.from_numpy(arrays, "cpu"), kf_cur, cand, R21, t21, s21,
                       torch.from_numpy(table))
    assert tl.num_loops_closed == jl.num_loops_closed == 1
    assert tl.last_loop_kf == jl.last_loop_kf == kf_cur
    assert len(tl.loop_edges) == len(jl.loop_edges) == 1
    kv = arrays["kf_valid"]
    np.testing.assert_allclose(N(out_t.kf_pose)[kv], np.asarray(out_j.kf_pose)[kv], atol=1e-3)
    lv = np.asarray(out_j.lm_valid)
    assert (N(out_t.lm_valid) == lv).all()
    np.testing.assert_allclose(N(out_t.lm_pos)[lv], np.asarray(out_j.lm_pos)[lv], atol=1e-2)
    same = N(out_t.kf_lm_idx)[kv] == np.asarray(out_j.kf_lm_idx)[kv]
    assert same.mean() >= 0.99
    # The correction moved the current keyframe.
    assert np.abs(N(out_t.kf_pose)[kf_cur] - arrays["kf_pose"][kf_cur]).max() > 1e-3


# ---------------------------------------------------------------------------
# The deferred global BA (tests/test_async_loop_ba.py on the port).
# ---------------------------------------------------------------------------


def _bare_system(cam, state, next_kf):
    """A System with only what the deferred global BA touches."""
    slam = System.__new__(System)
    slam.camera = cam
    slam.device = torch.device("cpu")
    slam._state = state
    slam.next_kf = next_kf
    slam.ref_kf = 0
    slam.pose = (torch.eye(3), torch.zeros(3))
    slam.vel = (torch.eye(3), torch.zeros(3))
    slam._pending_gba = None
    slam.loop_closer = tloop.LoopCloser(cam, device="cpu")
    slam.gba_iters_per_chunk = 2
    slam.gba_num_chunks = 4
    slam._ind_cache = None
    slam.timer = StageTimer()

    class _Frontend:
        inv_sigma_sq = torch.ones(8)

    slam.frontend = _Frontend()
    return slam


def _ba_maps():
    jcam, jst, _, _ = _make_state(np.random.default_rng(42), K=6, M=150)
    kw = {f.name: getattr(jcam, f.name) for f in dataclasses.fields(Camera)}
    tcam = Camera(**{**kw, "setup": CameraSetup(jcam.setup.value),
                     "model": CameraModel(jcam.model.value)})
    tst = tms.from_numpy({f: np.asarray(getattr(jst, f)) for f in jst._fields}, "cpu")
    return jcam, jst, tcam, tst


def test_deferred_gba_matches_synchronous():
    jcam, jst, tcam, tst = _ba_maps()
    table = np.ones(8, np.float32)
    sync = tgba.run_global_ba(tcam, tst, table, anchor_kf=0, num_iters=8)
    sync_j = jgba.run_global_ba(jcam, jst, table, anchor_kf=0, num_iters=8)
    slam = _bare_system(tcam, tst, next_kf=6)
    slam._start_deferred_gba(anchor_kf=0)
    phases = []
    while slam._pending_gba is not None:
        phases.append(slam._pending_gba["phase"])
        slam._advance_deferred_gba()
    assert phases == ["fetch", "enumerate"] + ["solve"] * 4 + ["adopt"]
    kv = N(tst.kf_valid)
    np.testing.assert_allclose(N(slam._state.kf_pose)[kv], N(sync.kf_pose)[kv], atol=5e-3)
    np.testing.assert_allclose(N(slam._state.kf_pose)[kv], np.asarray(sync_j.kf_pose)[kv],
                               atol=1e-4)
    assert set(slam.timer.times) == {"gba.prepare", "gba.chunk", "gba.adopt"}


def test_deferred_gba_propagates_to_midsolve_keyframe():
    _, _, tcam, tst = _ba_maps()
    slam = _bare_system(tcam, tst, next_kf=6)
    slam._start_deferred_gba(anchor_kf=0)
    for _ in range(3):  # fetch, enumerate, one chunk
        slam._advance_deferred_gba()
    # Mid-solve: keyframe 6 at an offset from keyframe 5, and a landmark
    # referenced to it.
    st = slam._state
    P_child = N(st.kf_pose[5]).copy()
    P_child[:, 3] += np.array([0.25, 0.0, 0.0], np.float32)
    new_lm = np.array([0.5, -0.3, 7.0], np.float32)
    st = st._replace(
        kf_pose=tms.with_row(st.kf_pose, 6, torch.from_numpy(P_child)),
        kf_valid=tms.with_row(st.kf_valid, 6, True),
        lm_pos=tms.with_row(st.lm_pos, 200, torch.from_numpy(new_lm)),
        lm_valid=tms.with_row(st.lm_valid, 200, True),
        lm_ref_kf=tms.with_row(st.lm_ref_kf, 200, 6),
    )
    slam._state = st
    slam.next_kf = 7
    slam._finish_deferred_gba()
    out = slam._state
    P5_cur = P_child.copy()
    P5_cur[:, 3] -= np.array([0.25, 0.0, 0.0], np.float32)
    P5_new = N(out.kf_pose[5])
    Rm = P5_cur[:, :3].T @ P5_new[:, :3]
    tm = P5_cur[:, :3].T @ (P5_new[:, 3] - P5_cur[:, 3])
    expect = np.concatenate([P_child[:, :3] @ Rm, (P_child[:, :3] @ tm + P_child[:, 3])[:, None]],
                            axis=1)
    np.testing.assert_allclose(N(out.kf_pose[6]), expect, atol=1e-4)
    P6_new = N(out.kf_pose[6])
    Xc = new_lm @ P_child[:, :3].T + P_child[:, 3]
    np.testing.assert_allclose(N(out.lm_pos[200]), (Xc - P6_new[:, 3]) @ P6_new[:, :3], atol=1e-4)


# ---------------------------------------------------------------------------
# Systems with loop closing on.
# ---------------------------------------------------------------------------


def _assert_trajectories_agree(a, b, tol):
    assert [ts for ts, _ in a] == [ts for ts, _ in b]
    for (ts, Pa), (_, Pb) in zip(a, b):
        dt = np.linalg.norm(Pa[:, 3] - Pb[:, 3])
        dr = np.abs(Pa[:, :3] - Pb[:, :3]).max()
        assert dt < tol and dr < tol, f"t={ts}: {dt:.2e} m, {dr:.2e}"


def test_detecting_systems_agree():
    """12 frames, a keyframe every frame: keyframes 7 on are scored for
    loops, each detection gated at the next keyframe (no loop: no
    candidate is MIN_GAP keyframes old). Both Systems end alike."""
    sizes = dict(max_keyframes=16, max_landmarks=8192, max_kf_interval=1)
    systems = []
    for slam in (_jax_system(**sizes), _port_system(**sizes)):
        slam.startup()
        feed_all(slam, _frames())
        slam.shutdown()
        systems.append(slam)
    js, ts = systems
    assert ts.next_kf == js.next_kf >= 9
    assert ts.timer.summary()["loop_detect"]["count"] == \
        js.timer.summary()["loop_detect"]["count"] >= 2
    assert ts.metrics()["loops_closed"] == js.metrics()["loops_closed"] == 0
    assert [list(c) for c, _ in ts.loop_closer._continuity] == \
        [list(c) for c, _ in js.loop_closer._continuity]
    _assert_trajectories_agree(js.frame_trajectory(), ts.frame_trajectory(), 1e-3)


def _out_and_back(cam, seed, tex_size=1536, out_frames=24, step=0.4, plane_half=14.0):
    """tests/test_loop_system.py's out-and-back: frames and (R, t)."""
    tex = synthetic_scene.make_texture(np.random.default_rng(seed), size=tex_size)
    Cs = ([np.array([step * i, 0.0, 0.0]) for i in range(out_frames)]
          + [np.array([step * (out_frames - 1 - i), 0.0, 0.0]) for i in range(out_frames)])
    frames, poses = [], []
    for i, C in enumerate(Cs):
        img, depth = synthetic_scene.render(cam, tex, np.eye(3), -C, plane_half=plane_half)
        frames.append((img, depth, i / 30.0))
        poses.append((np.eye(3), -C))
    return frames, poses


def inject_drift(slam, to_tensor, consistent=False):
    """The organic test's drift: the later half of the map (keyframes from
    next_kf // 2, their landmarks, the tracker pose) moved by a rigid
    transform larger than the tracker's association windows.
    ``consistent``: also drop the observations across the cut (a later
    keyframe's of an earlier landmark and the reverse), as chip_smoke.py
    does, so each half stays self-consistent (ROADMAP C22)."""
    T_R = N(tlie.so3_exp(torch.tensor([0.0, 0.05, 0.0])))
    T_t = np.array([0.9, 0.0, 0.3], np.float32)
    st = slam.state
    kf_cut = slam.next_kf // 2
    K = st.kf_pose.shape[0]
    pose = np.array(st.kf_pose)
    for k in np.where((np.arange(K) >= kf_cut) & np.array(st.kf_valid))[0]:
        R, t = pose[k, :, :3].copy(), pose[k, :, 3].copy()
        pose[k, :, :3] = R @ T_R.T
        pose[k, :, 3] = R @ (-T_R.T @ T_t) + t
    lm = np.array(st.lm_pos)
    late = np.array(st.lm_ref_kf) >= kf_cut
    sel = late & np.array(st.lm_valid)
    lm[sel] = lm[sel] @ T_R.T + T_t
    idx = np.array(st.kf_lm_idx)
    if consistent:
        cross = (idx >= 0) & ((np.arange(K) >= kf_cut)[:, None] != late[np.clip(idx, 0, None)])
        idx = np.where(cross, -1, idx)
    slam.state = st._replace(kf_pose=to_tensor(pose), lm_pos=to_tensor(lm),
                             kf_lm_idx=to_tensor(idx))
    slam._ind_cache = None  # the JAX System's setter keeps its cached indicator
    Rp, tp = slam.pose
    slam.pose = (Rp @ to_tensor(np.ascontiguousarray(T_R.T)),
                 Rp @ to_tensor((-T_R.T @ T_t).astype(np.float32)) + tp)


def run_organic(package, cam, orb, sizes, seed, consistent=False):
    """The organic loop closure on one System. The JAX System's state and
    tracker at the start of each loop fix (each validation) are kept in
    ``slam.fix_starts`` for :func:`replay_fix`."""
    frames, poses = _out_and_back(cam, seed)
    if package == "jax":
        slam = _jax_system(cam=cam, orb=orb, **sizes)
        to_tensor = jnp.asarray
        lc = slam.loop_closer
        validate = lc.validate_dispatch
        slam.fix_starts = []

        def record(state, kf_cur, cand, key):
            slam.fix_starts.append(dict(
                state={f: np.array(getattr(state, f)) for f in state._fields},
                kf_cur=kf_cur, cand=cand, key=np.array(key), next_kf=slam.next_kf,
                next_lm=int(slam.next_lm), ref_kf=int(slam.ref_kf),
                pose=tuple(np.array(a) for a in slam.pose), loop_edges=list(lc.loop_edges)))
            return validate(state, kf_cur, cand, key)

        lc.validate_dispatch = record
    else:
        slam = _port_system(cam=cam, orb=orb, **sizes)
        to_tensor = torch.from_numpy
    slam.startup()
    n_out = len(frames) // 2
    feed_all(slam, frames[:n_out])
    assert slam.tracking_state.value == "Tracking"
    slam.outbound_poses = np.array(slam.state.kf_pose)
    inject_drift(slam, to_tensor, consistent)
    assert slam.enable_loop_closing
    feed_all(slam, frames[n_out:])
    slam.shutdown()
    return slam, poses


def replay_fix(slam, snap, package):
    """Run one loop fix on ``slam`` from a recorded start: the map, the
    tracker pose and the loop edges set as they were, the validation
    started with the same key, then the fix's two phases and the whole
    deferred global BA. Returns the System."""
    if package == "jax":
        import structure_plp_slam_tpu.data.map_state as jms

        slam._state = jms.MapState(**{f: jnp.asarray(v) for f, v in snap["state"].items()})
        slam.pose = tuple(jnp.asarray(a) for a in snap["pose"])
        key = jnp.asarray(snap["key"])
    else:
        slam._state = tms.from_numpy(snap["state"], "cpu")
        slam.pose = tuple(torch.from_numpy(a) for a in snap["pose"])
        key = torch.from_numpy(snap["key"].astype(np.int64))
    slam.startup()
    slam._ind_cache = None
    slam.next_kf, slam.next_lm, slam.ref_kf = snap["next_kf"], snap["next_lm"], snap["ref_kf"]
    lc = slam.loop_closer
    lc.loop_edges = list(snap["loop_edges"])
    kf_cur, cand = snap["kf_cur"], snap["cand"]
    lc.last_loop_kf = kf_cur
    slam._pending_fix = {
        "phase": "validate", "kf_cur": kf_cur, "cand": cand, "prev_cooldown": -999,
        "packed": lc.validate_dispatch(slam._state, kf_cur, cand, key),
        "n0": snap["next_kf"], "K": slam._state.kf_pose.shape[0],
    }
    while slam._pending_fix is not None:
        slam._advance_pending_fix()
    slam._finish_deferred_gba()
    return slam


def _last_keyframe_error(slam, poses):
    kf_ts = np.array(slam.state.kf_timestamp)
    kf_last = int(np.argmax(kf_ts * np.array(slam.state.kf_valid)))
    P = np.array(slam.state.kf_pose[kf_last])
    R_gt, t_gt = poses[int(round(kf_ts[kf_last] * 30.0))]
    return float(np.linalg.norm(-P[:, :3].T @ P[:, 3] + R_gt.T @ t_gt))


def _assert_poses_agree(js, ts, tol):
    kv = np.array(js._state.kf_valid)
    assert (np.array(ts._state.kf_valid) == kv).all()
    Pj, Pt = np.array(js._state.kf_pose)[kv], np.array(ts._state.kf_pose)[kv]
    worst = (0.0, 0.0)
    for k, (a, b) in zip(np.where(kv)[0], zip(Pj, Pt)):
        dt = np.linalg.norm(a[:, 3] - b[:, 3])
        dr = np.abs(a[:, :3] - b[:, :3]).max()
        worst = max(worst[0], dt), max(worst[1], dr)
        assert dt < tol and dr < tol, f"keyframe {k}: {dt:.2e} m, {dr:.2e}"
    return worst


@pytest.mark.slow
def test_organic_loop_closure_matches_jax():
    """tests/test_loop_system.py's organic loop closure on both Systems
    (numpy seed 42, 320x240, 64 keyframes / 24576 landmarks,
    max_kf_interval=2): the same loop (kf_cur, cand), the same count and
    keyframe count, the last keyframe within the JAX test's 0.35 m.

    Over 48 frames at 0.4 m a frame the two maps stay bit-equal until the
    loop work (ROADMAP C18; ``test_organic_out_and_back_equals_jax``): the
    keyframes after the outbound leg are equal (printed), and the loop
    work after it parts them. The keyframe poses
    after the merge are held within 1e-3 m / 1e-3 here (measured: 8.63e-5
    m, 1.06e-5); the loop machinery itself
    is held at 1e-3 m / 1e-3 on the JAX System's own map at the start of
    the fix that closed the loop (replay_fix on both Systems)."""
    sizes = dict(max_keyframes=64, max_landmarks=24576, max_kf_interval=2)
    js, poses = run_organic("jax", JCAM, ORB, sizes, seed=42)
    ts, _ = run_organic("port", TCAM, ORB, sizes, seed=42)
    assert js.metrics()["loops_closed"] == ts.metrics()["loops_closed"] >= 1
    assert [e[:2] for e in ts.loop_closer.loop_edges] == [e[:2] for e in js.loop_closer.loop_edges]
    assert ts.next_kf == js.next_kf
    outbound = np.abs(js.outbound_poses - ts.outbound_poses)[np.array(js.state.kf_valid)].max()
    worst = _assert_poses_agree(js, ts, 1e-3)
    errs = [_last_keyframe_error(s, poses) for s in (js, ts)]
    print(f"loops {ts.loop_closer.loop_edges[0][:2]}; keyframes apart by up to {outbound:.2e} "
          f"after the outbound leg, {worst[0]:.2e} m, {worst[1]:.2e} at the end; last "
          f"keyframe's centre error: JAX {errs[0]:.6f} m, port {errs[1]:.6f} m")
    assert max(errs) < 0.35

    # The fix alone, from the JAX System's map at the start of the fix
    # that closed the loop.
    snap = next(f for f in js.fix_starts
                if (f["kf_cur"], f["cand"]) == js.loop_closer.loop_edges[0][:2])
    jr = replay_fix(_jax_system(**sizes), snap, "jax")
    tr = replay_fix(_port_system(**sizes), snap, "port")
    assert jr.loop_closer.num_loops_closed == tr.loop_closer.num_loops_closed == 1
    for a, b in zip(jr.loop_closer.loop_edges[-1][2:], tr.loop_closer.loop_edges[-1][2:]):
        np.testing.assert_allclose(np.asarray(b), np.asarray(a), atol=1e-4)
    worst = _assert_poses_agree(jr, tr, 1e-3)
    lv = np.array(jr._state.lm_valid)
    assert (np.array(tr._state.lm_valid) == lv).mean() >= 0.99
    for a, b in zip(jr.pose, tr.pose):
        np.testing.assert_allclose(np.array(b), np.array(a), atol=1e-3)
    print(f"replayed fix {snap['kf_cur']} -> {snap['cand']}: keyframes apart by up to "
          f"{worst[0]:.2e} m, {worst[1]:.2e}")
    # The same fix with the global BA run at once (async_loop_ba=False):
    # as many iterations as the deferred chunks, on the same snapshot.
    ts_sync = replay_fix(_port_system(async_loop_ba=False, **sizes), snap, "port")
    assert ts_sync.timer.summary().keys().isdisjoint({"gba.chunk", "gba.adopt"})
    _assert_poses_agree(tr, ts_sync, 1e-3)


@pytest.mark.slow
def test_full_width_loop_closure():
    """chip_smoke.py's loop path on the CPU (640x480, 1000 keypoints over 8
    levels, 256 keyframes / 32768 landmarks, numpy seed 0,
    max_kf_interval=2), on both Systems.

    With tests/test_loop_system.py's surgery (landmarks moved by their
    reference keyframe alone) the revisit's keyframes hold landmarks ~1.1
    m off in their own frames, and a loop closes or not by chance
    (ROADMAP C22). With the observations across the cut dropped
    (``consistent``, as chip_smoke.py does), both Systems close the same
    loop on its first validation at a scale within 1e-3 of 1, and end
    their last keyframe within the JAX test's 0.35 m."""
    kw = dict(name="b", cols=640, rows=480, fx=525.0, fy=525.0, cx=319.5, cy=239.5,
              fps=30.0, focal_x_baseline=40.0, depth_threshold=40.0, depthmap_factor=1.0)
    orb = dict(max_num_keypts=1000, num_levels=8)
    sizes = dict(max_keyframes=256, max_landmarks=32768, max_kf_interval=2)
    js, poses = run_organic("jax", JCamera(setup=JSetup.RGBD, model=JModel.PERSPECTIVE, **kw),
                            orb, sizes, seed=0, consistent=True)
    ts, _ = run_organic("port", Camera(setup=CameraSetup.RGBD, model=CameraModel.PERSPECTIVE,
                                       **kw), orb, sizes, seed=0, consistent=True)
    errs = [_last_keyframe_error(s, poses) for s in (js, ts)]
    edges = [[(e[0], e[1], e[4]) for e in s.loop_closer.loop_edges] for s in (js, ts)]
    print(f"last keyframe's centre error: JAX {errs[0]:.6f} m, port {errs[1]:.6f} m; loops "
          f"(kf_cur, cand, s): JAX {edges[0]}, port {edges[1]}")
    assert [e[:2] for e in edges[0]] == [e[:2] for e in edges[1]] and len(edges[0]) >= 1
    for slam, err, loops in zip((js, ts), errs, edges):
        assert slam.metrics()["tracking_state"] == "Tracking"
        assert err < 0.35
        assert abs(loops[0][2] - 1.0) < 1e-3


@pytest.mark.slow
def test_organic_out_and_back_equals_jax():
    """ROADMAP C18 on the organic loop's out-and-back (320x240, 0.4 m a
    frame, 48 frames, no drift injected), both Systems fed frame by frame.
    With the frontends (C8), the RGB-D landmark seeding
    (``mapper.insert_keyframe``), the tracker's pose solve
    (``ops/pose_cpu``) and the keyframe chain's local BA with its stereo
    rows (``ops/ba_cpu``) computing XLA:CPU's arithmetic, every frame leaves
    the two Systems' poses and maps bit-equal, frames 0-2 (where the RGB-D
    chain's BA once parted them) and the return leg included, and both use
    the same landmark and keyframe slots."""
    frames, _ = _out_and_back(TCAM, 42)
    sizes = dict(max_keyframes=64, max_landmarks=24576, max_kf_interval=2)
    js, ts = _jax_system(**sizes), _port_system(**sizes)
    js.startup()
    ts.startup()
    for i in range(len(frames)):
        for slam in (js, ts):
            feed_all(slam, frames[i:i + 1])
        assert all(np.array_equal(np.asarray(a), N(b)) for a, b in zip(js.pose, ts.pose)), i
        apart = []
        for f in js.state._fields:
            a, b = np.asarray(getattr(js.state, f)), N(getattr(ts.state, f))
            if a.dtype == np.uint32:
                a = a.view(np.int32)
            if not np.array_equal(a.astype(b.dtype), b):
                apart.append(f)
        assert not apart, (i, apart)
        assert (int(js.next_lm), js.next_kf) == (int(ts.next_lm), ts.next_kf), i
    js.shutdown()
    ts.shutdown()
    assert ts.next_kf >= 20
    jt, tt = js.frame_trajectory(), ts.frame_trajectory()
    assert len(jt) == len(tt) == len(frames)
    assert all(np.array_equal(np.asarray(a[1]), np.asarray(b[1])) for a, b in zip(jt, tt))
    print(f"{len(frames)} frames bit-equal; {ts.next_kf} keyframes, {int(ts.next_lm)} "
          "landmark slots (both)")
