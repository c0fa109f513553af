"""Port parity: monocular initialization and the monocular System.

Inputs: 8 frames of the rendered sequence at 320x240 (600 keypoints over 4
levels), stepping 0.08 m a frame as tests/test_system_e2e.py's monocular
test does. The op-level tests feed the JAX frontend's features to both
packages with the same key; ``utils/prng`` draws the JAX package's
samples and the port's CPU factorizations and fused products are XLA:CPU's
(``ops/linalg``), so the outputs must be equal: matches, masks, the model
choice, the pose and the points. The System-level
test runs both Systems on the frames: the same frames return no pose
(the same init frame), per-frame poses within 1e-3 m / 1e-3 rad, equal
keyframe counts. The slow case is the port's copy of
``test_mono_sequence_ate``.
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
from structure_plp_slam_tpu.models import frontend as jfrontend
from structure_plp_slam_tpu.models import initializer as jinit
from structure_plp_slam_tpu.ops.orb import OrbParams as JOrb
from structure_plp_slam_tpu.system import System as JSystem
from structure_plp_slam_tpu_torch.camera import Camera, CameraModel, CameraSetup
from structure_plp_slam_tpu_torch.config import Config
from structure_plp_slam_tpu_torch.io import trajectory as traj_io
from structure_plp_slam_tpu_torch.models import initializer as tinit
from structure_plp_slam_tpu_torch.ops import fused_match as tfm
from structure_plp_slam_tpu_torch.ops.orb import OrbParams
from structure_plp_slam_tpu_torch.system import System, TrackerState
from structure_plp_slam_tpu_torch.testing import synthetic_scene
from structure_plp_slam_tpu_torch.utils import prng

torch.set_num_threads(2)

_KW = dict(name="synt", cols=320, rows=240, fx=260.0, fy=260.0, cx=159.5, cy=119.5,
           fps=30.0, focal_x_baseline=0.0, depth_threshold=400.0, depthmap_factor=1.0)
JCAM = JCamera(setup=JSetup.MONOCULAR, model=JModel.PERSPECTIVE, **_KW)
TCAM = Camera(setup=CameraSetup.MONOCULAR, model=CameraModel.PERSPECTIVE, **_KW)
NUM_FRAMES = 8
SIZES = dict(max_keyframes=8, max_landmarks=4096, enable_loop_closing=False, track_lag=2,
             max_kf_interval=3)


@functools.lru_cache(maxsize=1)
def _frames():
    frames, poses = synthetic_scene.make_sequence(np.random.default_rng(42), TCAM,
                                                  num_frames=NUM_FRAMES, step=0.08)
    return frames, poses


@functools.lru_cache(maxsize=None)
def jax_feats(i):
    """The JAX frontend's monocular features of frame ``i`` (numpy)."""
    orb = JOrb(max_num_keypts=600, num_levels=4)
    cap = jfrontend.orb_ops.OrbExtractor(JCAM.rows, JCAM.cols, orb).capacity
    fe = jfrontend.Frontend(JCAM, orb, pad_to=-(-cap // 8) * 8)  # the System's pad_to
    out = fe.mono(jnp.asarray(_frames()[0][i][0]))
    return {k: np.asarray(v) for k, v in out.items()}


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


@pytest.mark.parametrize("pair,seed", [((0, 3), 0), ((0, 5), 1), ((1, 6), 7)])
def test_try_initialize_mono_parity(pair, seed):
    f1, f2 = (jax_feats(i) for i in pair)
    rj = jinit.try_initialize_mono(JCAM, f1, f2, jax.random.PRNGKey(seed))
    rt = tinit.try_initialize_mono(TCAM, _to_torch(f1), _to_torch(f2), prng.PRNGKey(seed))
    assert int(rt.num_matches) == int(rj.num_matches)
    assert bool(rt.used_homography) == bool(rj.used_homography)
    assert bool(rt.success) == bool(rj.success)
    assert int(rt.num_points) == int(rj.num_points)
    assert (rt.point_ok.numpy() == np.asarray(rj.point_ok)).all()
    assert (rt.matches.numpy() == np.asarray(rj.matches)).all()
    np.testing.assert_array_equal(rt.R_2w.numpy(), np.asarray(rj.R_2w))
    np.testing.assert_array_equal(rt.t_2w.numpy(), np.asarray(rj.t_2w))
    ok = np.asarray(rj.point_ok)
    np.testing.assert_array_equal(rt.points_w.numpy()[ok], np.asarray(rj.points_w)[ok])


@pytest.mark.parametrize("count", [1, 2, 7, 8, 0])
def test_scale_to_median_depth_parity(count):
    """Even counts average the two middle depths (jnp.nanmedian), which
    torch.nanmedian would not."""
    rng = np.random.default_rng(count)
    pts = rng.uniform(0.5, 9.0, (12, 3)).astype(np.float32)
    ok = np.zeros(12, bool)
    ok[rng.permutation(12)[:count]] = True
    t = rng.normal(size=3).astype(np.float32)
    pj, tj, sj = jinit.scale_to_median_depth(jnp.asarray(pts), jnp.asarray(ok), jnp.asarray(t))
    pt, tt, st = tinit.scale_to_median_depth(torch.from_numpy(pts), torch.from_numpy(ok),
                                             torch.from_numpy(t))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    np.testing.assert_array_equal(pt.numpy(), np.asarray(pj))
    np.testing.assert_array_equal(tt.numpy(), np.asarray(tj))


def _run(slam, frames):
    slam.startup()
    poses = []
    for img, _, ts in frames:
        out = slam.feed_monocular_frame(img, ts)
        if torch.is_tensor(out):
            out = out.cpu().numpy()
        poses.append(None if out is None else np.array(out))
    slam.shutdown()
    return poses


@functools.lru_cache(maxsize=1)
def run_jax():
    js = JSystem(JConfig(camera=JCAM, orb=JOrb(max_num_keypts=600, num_levels=4), raw={}),
                 **SIZES)
    return js, _run(js, _frames()[0])


@functools.lru_cache(maxsize=1)
def run_port():
    ts = System(Config(camera=TCAM, orb=OrbParams(max_num_keypts=600, num_levels=4), raw={}),
                device="cpu", **SIZES)
    tfm.reset_counts()
    poses = _run(ts, _frames()[0])
    return ts, poses, tfm.fused_match.calls, tfm.fused_match.launches


def _rot_angle(Ra, Rb):
    c = (np.trace(Ra.T @ Rb) - 1.0) / 2.0
    return float(np.arccos(np.clip(c, -1.0, 1.0)))


def test_mono_system_matches_jax():
    js, jposes = run_jax()
    ts, tposes, _, _ = run_port()
    init_j = [p is not None for p in jposes]
    assert [p is not None for p in tposes] == init_j
    assert sum(init_j) >= 3, "the monocular map did not initialize early enough"
    for i, (a, b) in enumerate(zip(jposes, tposes)):
        if a is None:
            continue
        dt = np.linalg.norm(a[:, 3] - b[:, 3])
        dr = _rot_angle(a[:, :3], b[:, :3])
        # 1e-3 m / 1e-3 rad: f32 sums in another order through SVD, LM and BA.
        assert dt < 1e-3 and dr < 1e-3, f"frame {i}: {dt:.2e} m, {dr:.2e} rad"
    tj, tt = js.frame_trajectory(), ts.frame_trajectory()
    assert len(tj) == len(tt)
    for (ta, pa), (tb, pb) in zip(tj, tt):
        assert ta == tb
        assert np.abs(pa - pb).max() < 1e-3
    assert ts.num_keyframes == js.num_keyframes
    assert ts.next_kf == js.next_kf >= 2
    assert ts.tracking_state.value == js.tracking_state.value == "Tracking"


def test_mono_system_went_through_matcher():
    ts, _, calls, launches = run_port()
    assert ts.num_track_steps > 0
    # Three matcher calls per tracked frame, one per keyframe chain (the
    # two init keyframes run no chain).
    assert calls == 3 * ts.num_track_steps + ts.next_kf - 2, (calls, ts.num_track_steps)
    assert launches == 0  # CPU tensors take the plain version


def test_full_width_init_parity():
    """ROADMAP C45: the two-view init at chip_smoke.py's width (640x480,
    1000 keypoints over 8 levels) on the JAX frontend's features of
    numpy seed 42's frames 0-1 (the pair both Systems initialize on) and
    0-2, with keys 0-2: success, point counts, the model, the matches, the
    pose and every point equal. The four successful inits take the
    essential matrix three times and the homography once. A 0.08 m
    baseline scales the last bit of a rotation into millimetres of depth,
    so this holds only because the port's CPU factorizations are LAPACK's,
    as XLA:CPU's are, and its small products, the triangulation's rows and
    normal matrix, the homography's normalization and inverse and the
    decompositions' scalars are fused and summed as XLA:CPU compiles them
    (``ops/linalg``: ``fma``, ``einsum_fma``, ``norm``, ``inv3x3``)."""
    cam = Camera(setup=CameraSetup.MONOCULAR, model=CameraModel.PERSPECTIVE, **_FULL_KW)
    jcam = JCamera(setup=JSetup.MONOCULAR, model=JModel.PERSPECTIVE, **_FULL_KW)
    frames, _ = synthetic_scene.make_sequence(np.random.default_rng(42), cam, 3, step=0.08)
    fe = jfrontend.Frontend(jcam, JOrb(**_FULL_ORB), pad_to=1032)
    f = [{k: np.asarray(v) for k, v in fe.mono(jnp.asarray(img)).items()}
         for img, _, _ in frames]
    models = []
    for a, b in ((0, 1), (0, 2)):
        for key in (0, 1, 2):
            rj = jinit.try_initialize_mono(jcam, f[a], f[b], jax.random.PRNGKey(key))
            rt = tinit.try_initialize_mono(cam, _to_torch(f[a]), _to_torch(f[b]),
                                           prng.PRNGKey(key))
            assert bool(rt.success) == bool(rj.success)
            assert int(rt.num_points) == int(rj.num_points)
            assert bool(rt.used_homography) == bool(rj.used_homography)
            assert (rt.matches.numpy() == np.asarray(rj.matches)).all()
            if not bool(rj.success):
                continue
            g = np.asarray(rj.point_ok)
            assert (rt.point_ok.numpy() == g).all()
            np.testing.assert_array_equal(rt.R_2w.numpy(), np.asarray(rj.R_2w))
            np.testing.assert_array_equal(rt.t_2w.numpy(), np.asarray(rj.t_2w))
            np.testing.assert_array_equal(rt.points_w.numpy()[g], np.asarray(rj.points_w)[g])
            models.append(bool(rj.used_homography))
    assert sorted(models) == [False, False, False, True], models


@pytest.mark.slow
def test_mono_sequence_ate():
    """tests/test_system_e2e.py::test_mono_sequence_ate on the port."""
    frames, poses = synthetic_scene.make_sequence(np.random.default_rng(42), TCAM,
                                                  num_frames=16, step=0.08)
    slam = System(Config(camera=TCAM, orb=OrbParams(max_num_keypts=600, num_levels=4),
                         raw={}),
                  max_keyframes=32, max_landmarks=8192, max_kf_interval=3,
                  enable_loop_closing=False, device="cpu")
    slam.startup()
    for img, _, ts in frames:
        slam.feed_monocular_frame(img, ts)
    slam.shutdown()
    assert slam.tracking_state is TrackerState.TRACKING
    est = slam.frame_trajectory()
    assert len(est) >= 10
    gt = [(float(i) / 30.0, np.concatenate([R, t[:, None]], 1).astype(np.float64))
          for i, (R, t) in enumerate(poses)]
    ate = traj_io.ate_rmse(est, gt, align_scale=True)
    assert ate < 0.08, f"ATE {ate}"


_FULL_KW = dict(name="b", cols=640, rows=480, fx=525.0, fy=525.0, cx=319.5, cy=239.5,
                fps=30.0, focal_x_baseline=0.0, depth_threshold=40.0, depthmap_factor=1.0)
_FULL_ORB = dict(max_num_keypts=1000, num_levels=8)


def _full_width_systems(seed, num_frames=40, threads=(2,)):
    """chip_smoke.py's monocular path on the CPU (640x480, 1000 keypoints
    over 8 levels, ``num_frames`` frames at 0.08 m a frame,
    max_kf_interval=3; capacities cut to 32 keyframes / 8192 landmarks),
    each System on its own frontend, the port's once per torch thread
    count in ``threads``. Checks that the two frontends give equal
    features on every frame; returns each run's (state, lost frames,
    trajectory length, first pose frame, first pose, keyframes, Sim3 ATE,
    keyframe frames): the JAX System's, then the port's per thread count."""
    cam = Camera(setup=CameraSetup.MONOCULAR, model=CameraModel.PERSPECTIVE, **_FULL_KW)
    frames, poses = synthetic_scene.make_sequence(np.random.default_rng(seed), cam, num_frames,
                                                  step=0.08)
    sizes = dict(max_keyframes=32, max_landmarks=8192, max_kf_interval=3,
                 enable_loop_closing=False)

    def port_system():
        return System(Config(camera=cam, orb=OrbParams(**_FULL_ORB), raw={}), device="cpu",
                      **sizes)

    js = JSystem(JConfig(camera=JCamera(setup=JSetup.MONOCULAR, model=JModel.PERSPECTIVE,
                                        **_FULL_KW), orb=JOrb(**_FULL_ORB), raw={}), **sizes)
    port_fe = port_system().frontend
    for img, _, _ in frames:
        fj = {k: np.asarray(v) for k, v in js.frontend.mono(jnp.asarray(img)).items()}
        ft = {k: v.numpy() for k, v in port_fe.mono(img).items()}
        for k, v in fj.items():
            np.testing.assert_array_equal(ft[k], v.view(np.int32) if v.dtype == np.uint32 else v)
    gt = [(float(i) / 30.0, np.concatenate([R, t[:, None]], 1).astype(np.float64))
          for i, (R, t) in enumerate(poses)]
    out = []
    before = torch.get_num_threads()
    try:
        for label, make, n in [("jax", lambda: js, before)] + [
                ("port", port_system, n) for n in threads]:
            torch.set_num_threads(n)
            slam = make()
            fed = _run(slam, frames)
            first = next(i for i, p in enumerate(fed) if p is not None)
            est = slam.frame_trajectory()
            st = slam.state
            kf = sorted(round(float(t) * 30) for t, v in zip(np.array(st.kf_timestamp),
                                                               np.array(st.kf_valid)) if v)
            r = (slam.tracking_state.value, [s[0] for s in slam._frame_stats if s[3]],
                 len(est), first, fed[first], slam.num_keyframes,
                 traj_io.ate_rmse(est, gt, align_scale=True), kf)
            out.append(r)
            print(f"seed {seed}, {label} System{'' if label == 'jax' else f' ({n} torch threads)'}"
                  f": state {r[0]}, lost frames at {r[1]}, {r[2]} trajectory frames, first pose "
                  f"at frame {r[3]}, {r[5]} keyframes (at frames {r[7]}), Sim3 ATE {r[6]:.6f} m")
    finally:
        torch.set_num_threads(before)
    return out


# How far apart the two Systems' Sim3 ATEs may end: both take the same
# keyframes on both seeds; seed 0's trajectories part after the init's
# local BA (ROADMAP C18) and are held at the band that bounded them while
# their keyframes still differed (measured on this tree).
ATE_APART = {0: 0.01, 1: 1e-4}


@pytest.mark.slow
@pytest.mark.parametrize("seed", [0, 1])
def test_full_width_mono_matches_jax(seed):
    """chip_smoke.py's monocular path on the CPU (``_full_width_systems``),
    on the other paths' texture (seed 0) and the next one (seed 1). The
    frontends are equal on every frame (ROADMAP C8), and so are the
    two-view init (``test_full_width_init_parity``) and the tracker
    (``tests/test_torch_pose_solve_xla.py``, C18): end state, lost frames,
    trajectory length and the first pose frame equal, the first pose
    within 1e-3, the keyframes taken at the same frames (before the
    tracker computed XLA:CPU's arithmetic, seed 0 parted at frame 11 and
    seed 1 at frame 28), and the Sim3 ATEs within ``ATE_APART``. The
    init's local BA is the first op that parts the two maps (ROADMAP C18;
    ``test_full_width_init_local_ba_parts_first``). Measured on this tree:
    seed 0, JAX 0.073879 m and the port 0.066488 m, keyframes at frames
    0, 11, 14, 20, 28, 31, 34, 37; seed 1, JAX 0.010472 m and the port
    0.010532 m at 0, 11, 14, 28, 31, 34, 37."""
    a, b = _full_width_systems(seed)
    assert a[:4] == b[:4], (a[:4], b[:4])
    assert np.abs(a[4] - b[4]).max() < 1e-3, (a[4], b[4])
    assert a[7] == b[7], (a[7], b[7])
    assert abs(a[6] - b[6]) < ATE_APART[seed], (a[6], b[6])


@pytest.mark.slow
def test_full_width_mono_seed42_parts_after_init():
    """ROADMAP C45 on chip_smoke.py's gated monocular sequence (numpy seed
    42) at full width, the port at 1, 2 and 3 torch threads: equal
    features, the same init (bit-equal since the port's CPU linear algebra
    is XLA:CPU's), the same end state and first pose (1e-3), one port
    result at every thread count, and the two Systems match: keyframes at
    the same frames and Sim3 ATEs within 1e-4 m. Measured on this tree:
    the JAX System 0.115389 m and the port 0.115470 m, both with their
    valid keyframes at frames 0, 11, 14, 28, 31, 34, 37 (before the
    LAPACK routes the port ended at 0.134512 m with keyframes at 0, 5, 8,
    19, 32, 33, 34, 37). The JAX System misses tests/test_system_e2e.py's
    0.08 m bound here, which that test sets at 320x240; chip_smoke.py
    gates the monocular path there (ROADMAP C17, C45)."""
    a, *ports = _full_width_systems(42, threads=(1, 2, 3))
    for b in ports:
        assert a[0] == b[0] and a[3] == b[3], (a[:4], b[:4])
        assert np.abs(a[4] - b[4]).max() < 1e-3, (a[4], b[4])
        assert (b[6], b[7]) == (ports[0][6], ports[0][7])  # one port result
    assert ports[0][7] == a[7], (a[7], ports[0][7])
    assert abs(ports[0][6] - a[6]) < 1e-4, (a[6], ports[0][6])


@pytest.mark.slow
def test_full_width_tracker_replays_jax(monkeypatch):
    """ROADMAP C18 on chip_smoke.py's gated monocular sequence (numpy seed
    42, 640x480, 40 frames): the JAX System runs, and on every tracked
    frame the port's motion model and ``track_frame`` take the JAX
    tracker's own inputs (its map, features and carry): the predicted
    pose, the tracked pose and every association equal the JAX tracker's
    bit for bit (its two pose solves are ``ops/pose_cpu``'s C source)."""
    import structure_plp_slam_tpu.system as jsys

    from structure_plp_slam_tpu_torch.models import tracker as ttracker
    from structure_plp_slam_tpu_torch.ops import linalg as tlinalg
    from tests.test_torch_tracker import state_to_torch, to_torch

    seen = []
    step = jsys._track_step

    def record(camera, state, feats, carry, isg, obs_ind, min_obs, next_lm, **kw):
        out = step(camera, state, feats, carry, isg, obs_ind, min_obs, next_lm, **kw)
        seen.append((state, feats, carry, isg, obs_ind, min_obs, kw, out[1]))
        return out

    monkeypatch.setattr(jsys, "_track_step", record)
    cam = Camera(setup=CameraSetup.MONOCULAR, model=CameraModel.PERSPECTIVE, **_FULL_KW)
    frames, _ = synthetic_scene.make_sequence(np.random.default_rng(42), cam, 40, step=0.08)
    js = JSystem(JConfig(camera=JCamera(setup=JSetup.MONOCULAR, model=JModel.PERSPECTIVE,
                                        **_FULL_KW), orb=JOrb(**_FULL_ORB), raw={}),
                 max_keyframes=32, max_landmarks=8192, max_kf_interval=3,
                 enable_loop_closing=False)
    _run(js, frames)
    monkeypatch.undo()
    assert len(seen) >= 30
    predict = jax.jit(lambda Rv, R, tv, t: (Rv @ R, Rv @ t + tv))
    for i, (state, feats, carry, isg, ind, min_obs, kw, jres) in enumerate(seen):
        Rv, R, tv, t = (torch.from_numpy(np.array(x)) for x in (carry.Rv, carry.R, carry.tv,
                                                                 carry.t))
        R_pred, t_pred = tlinalg.matmul(Rv, R), tlinalg.matvec(Rv, t) + tv
        jR_pred, jt_pred = predict(carry.Rv, carry.R, carry.tv, carry.t)
        assert np.array_equal(R_pred.numpy(), np.asarray(jR_pred)), i
        assert np.array_equal(t_pred.numpy(), np.asarray(jt_pred)), i
        res = ttracker.track_frame(
            cam, state_to_torch(state), {k: to_torch(v) for k, v in feats.items()}, R_pred,
            t_pred, to_torch(carry.last_kp_lm), int(carry.ref_kf), to_torch(isg),
            to_torch(ind), int(min_obs), num_levels=kw["num_levels"],
            scale_factor=kw["scale_factor"])
        for field in ("R", "t", "kp_lm", "num_tracked", "ref_kf"):
            got = getattr(res, field).numpy()
            assert np.array_equal(got, np.asarray(getattr(jres, field)).astype(got.dtype)), (i, field)
    print(f"{len(seen)} tracked frames: the port's prediction and track_frame equal the JAX "
          "tracker's on every one")


@pytest.mark.slow
@pytest.mark.parametrize("seed", [0, 1, 42])
def test_full_width_init_local_ba_parts_first(seed, monkeypatch):
    """ROADMAP C18 on the full-width monocular sequences
    (``_full_width_systems``' camera and sizes; seeds 0 and 1 of
    ``test_full_width_mono_matches_jax`` and chip phase 7's 42): both
    Systems are fed frame by frame up to their two-view init, and the
    init's local BA (``system.py``'s two-view BA after the init) is the
    first op that parts them. Its input, the whole map state after the
    init (keyframes, points, normals, scale ranges, descriptors), is bit
    for bit the JAX System's; its output is not: keyframe 0 (fixed) stays
    equal, keyframe 1's pose and points move apart (printed)."""
    import structure_plp_slam_tpu.models.mapper as jmapper

    from structure_plp_slam_tpu_torch.data import map_state as tms
    from structure_plp_slam_tpu_torch.models import mapper as tmapper

    cam = Camera(setup=CameraSetup.MONOCULAR, model=CameraModel.PERSPECTIVE, **_FULL_KW)
    frames, _ = synthetic_scene.make_sequence(np.random.default_rng(seed), cam, 12, step=0.08)
    sizes = dict(max_keyframes=32, max_landmarks=8192, max_kf_interval=3,
                 enable_loop_closing=False)
    js = JSystem(JConfig(camera=JCamera(setup=JSetup.MONOCULAR, model=JModel.PERSPECTIVE,
                                        **_FULL_KW), orb=JOrb(**_FULL_ORB), raw={}), **sizes)
    ts = System(Config(camera=cam, orb=OrbParams(**_FULL_ORB), raw={}), device="cpu", **sizes)
    calls = {}

    def recorder(module, key):
        fn = module.local_ba

        def record(camera, state, *a, **k):
            out = fn(camera, state, *a, **k)
            calls.setdefault(key, (state, out[0]))
            return out
        monkeypatch.setattr(module, "local_ba", record)

    recorder(jmapper, "jax")
    recorder(tmapper, "port")

    def fields(st, port):
        d = tms.to_numpy(st) if port else {f: np.asarray(getattr(st, f)) for f in st._fields}
        return {f: (v.view(np.int32) if v.dtype == np.uint32 else np.asarray(v))
                for f, v in d.items()}

    for slam in (js, ts):
        slam.startup()
    for i, (img, _, stamp) in enumerate(frames):
        for slam in (js, ts):
            slam.feed_monocular_frame(img, stamp)
        if len(calls) == 2:
            break
    for slam in (js, ts):
        slam.shutdown()
    monkeypatch.undo()
    assert sorted(calls) == ["jax", "port"], f"no init within {len(frames)} frames"
    (jin, jout), (tin, tout) = calls["jax"], calls["port"]
    jin, jout, tin, tout = fields(jin, False), fields(jout, False), fields(tin, True), fields(
        tout, True)
    apart_in = [f for f in jin if not np.array_equal(jin[f].astype(tin[f].dtype), tin[f])]
    assert not apart_in, apart_in
    apart = {f: jout[f].astype(tout[f].dtype) != tout[f] for f in jout}
    apart = {f: m for f, m in apart.items() if m.any()}
    kf = np.flatnonzero(apart.get("kf_pose", np.zeros((1, 1, 1), bool)).any((-1, -2)))
    lms = np.flatnonzero(apart.get("lm_pos", np.zeros((1, 1), bool)).any(-1))
    gap_kf = np.abs(jout["kf_pose"][1] - tout["kf_pose"][1]).max()
    gap_lm = np.abs(jout["lm_pos"] - tout["lm_pos"]).max()
    print(f"seed {seed}: init at frame {i}, the init's local BA input equal in all "
          f"{len(jin)} fields; after it keyframes {[int(k) for k in kf]} apart (up to {gap_kf:.3e}), "
          f"{len(lms)} landmarks apart (up to {gap_lm:.3e} m), fields {sorted(apart)}")
    assert list(kf) == [1], kf
    assert len(lms) > 0
