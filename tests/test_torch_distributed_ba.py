"""Port parity: the landmark-sharded global BA (``parallel/distributed_ba``).

The JAX package runs on its 8 virtual CPU devices, as
tests/test_distributed_ba.py runs it (``Mesh(jax.devices()[:8], ("lm",))``);
the port runs on ``LandmarkMesh(["cpu"] * 8)``, and on 2 and 3 shards
where the partition is compared. The same numpy-seeded inputs
(``np.random.default_rng(42)``) go through both. Tolerances:

* ``shard_problem`` and ``shard_chain_pairs``: exactly equal, for 2, 3
  (M not divisible) and 8 shards, but for the pairs of dead observation
  slots, which the port leaves out (ROADMAP C43), and for the chain
  pairs' positions: the port gives each pair its first keyframe's chain
  position, where the one-device PCG puts its block, and the JAX package
  the pair's index in the list (ROADMAP C42). Both mesh PCGs are fed the
  chain positions;
* the dense and the PCG mesh solves on the same sharded arrays, and
  ``run_global_ba(mesh=)``: poses within 1e-4 and landmarks within 1e-3
  of JAX's (the bounds of the port's global BA parity,
  tests/test_torch_loop.py), and on the noisy problem of the JAX test
  5e-3 / 2e-2 (its own bounds: f32 sums in another order, amplified over
  8 damped Gauss-Newton steps), and the port's mesh PCG against the JAX
  package's one-device PCG on a chain map with 2 cm of pose noise at
  those bounds;
* the port copies of tests/test_distributed_ba.py's tests, on the port
  alone, at their bounds;
* the System's deferred global BA on mesh shards: poses within 1e-4 of
  the JAX mesh solve.
"""

import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from structure_plp_slam_tpu.camera import CameraModel as JModel
from structure_plp_slam_tpu.camera import base as jcam_base
from structure_plp_slam_tpu.models import bundle_adjustment as jba
from structure_plp_slam_tpu.models import global_ba as jgba
from structure_plp_slam_tpu.ops import lie as jlie
from structure_plp_slam_tpu.parallel import distributed_ba as jdba
from structure_plp_slam_tpu_torch.camera import Camera, CameraModel, CameraSetup
from structure_plp_slam_tpu_torch.config import Config
from structure_plp_slam_tpu_torch.models import bundle_adjustment as tba
from structure_plp_slam_tpu_torch.models import global_ba as tgba
from structure_plp_slam_tpu_torch.ops.orb import OrbParams
from structure_plp_slam_tpu_torch.parallel import distributed_ba as tdba
from structure_plp_slam_tpu_torch.parallel.distributed_ba import LandmarkMesh
from structure_plp_slam_tpu_torch.system import System
from tests.helpers import create_random_landmarks, make_camera
from tests.test_bundle_adjustment import _make_problem, _pose_errors
from tests.test_torch_loop import N, T, _ba_state, port_camera
from tests.test_torch_loop_system import _bare_system

torch.set_num_threads(2)

MESH8 = LandmarkMesh(["cpu"] * 8)


@pytest.fixture
def mesh8():
    devs = jax.devices()
    assert len(devs) >= 8, "conftest must force 8 virtual CPU devices"
    return Mesh(np.array(devs[:8]), ("lm",))


def _rng():
    return np.random.default_rng(42)


def _port(jnt, cls):
    """A port NamedTuple (BAProblem, ShardedBAProblem) with the JAX one's
    arrays (int32 indices as int64)."""
    return cls(**{f: T(np.asarray(getattr(jnt, f))) for f in jnt._fields})


def _state_problem(jst):
    """tests/test_torch_loop.py's map as the BAProblem the JAX package's
    sharded global BA packs (padded observation bucket, anchor 0)."""
    data = jgba.prepare(jst, np.ones(8, np.float32))
    O = int(data.num_obs)
    O_pad = 1 << max(10, (O - 1).bit_length())

    def pad(a, fill=0):
        a = np.asarray(a)[:O]
        return jnp.asarray(np.concatenate([a, np.full((O_pad - O,) + a.shape[1:], fill,
                                                      a.dtype)]))

    K = jst.kf_pose.shape[0]
    prob = jba.BAProblem(
        cam_pose=jst.kf_pose, cam_fixed=jnp.asarray(np.arange(K) == 0), cam_valid=jst.kf_valid,
        lm_pos=jst.lm_pos, lm_valid=jst.lm_valid, obs_cam=pad(data.obs_cam),
        obs_lm=pad(data.obs_lm), obs_uv=pad(data.obs_uv), obs_xr=pad(data.obs_xr, -1.0),
        obs_inv_sigma_sq=pad(data.obs_info), obs_valid=jnp.asarray(np.arange(O_pad) < O))
    return data, prob


def _unshard(lm_flat, n, M):
    lm = np.asarray(lm_flat).reshape(n, -1, 3)
    m = np.arange(M)
    return lm[m % n, m // n]


# ---------------------------------------------------------------------------
# The partition: exact.
# ---------------------------------------------------------------------------


def _assert_partition_equal(st, sj, n):
    """The port's sharded arrays against JAX's: every non-pair array
    exactly equal; the pair arrays JAX's with the pairs of its dead
    observation slots left out (ROADMAP C43), in the same order."""
    for f in sj._fields:
        if not f.startswith("pair_"):
            assert (N(getattr(st, f)) == np.asarray(getattr(sj, f))).all(), f
    ov = np.asarray(sj.obs_valid).reshape(n, -1)
    for i, (p1, p2, pv) in enumerate(zip(*(np.asarray(getattr(sj, f)).reshape(n, -1)
                                           for f in ("pair_o1", "pair_o2", "pair_valid")))):
        live = pv & ov[i][p1] & ov[i][p2]
        t1, t2, tv = (N(getattr(st, f)).reshape(n, -1)[i] for f in ("pair_o1", "pair_o2",
                                                                    "pair_valid"))
        k = int(live.sum())
        assert tv[:k].all() and not tv[k:].any()
        assert (t1[:k] == p1[live]).all() and (t2[:k] == p2[live]).all()


@pytest.mark.parametrize("n", [2, 3, 8])
def test_shard_problem_exact(n):
    _, prob, _, _ = _make_problem(_rng(), C=5, M=96, noise=0.3, stereo=True)
    tprob = _port(prob, tba.BAProblem)
    # Dead rows: an invalid observation and an invalid landmark.
    tprob = tprob._replace(obs_valid=tprob.obs_valid & (torch.arange(tprob.obs_cam.shape[0]) != 7),
                           lm_valid=tprob.lm_valid & (torch.arange(96) != 5))
    jprob = prob._replace(obs_valid=jnp.asarray(N(tprob.obs_valid)),
                          lm_valid=jnp.asarray(N(tprob.lm_valid)))
    sj, mj = jdba.shard_problem(jprob, n, return_map=True)
    st, mt = tdba.shard_problem(tprob, n, return_map=True)
    _assert_partition_equal(st, sj, n)
    assert (mt == mj).all()

    _, jst, tst, _, _ = _ba_state()
    data, sprob = _state_problem(jst)
    sj, mj = jdba.shard_problem(sprob, n, return_map=True)
    st, mt = tdba.shard_problem(_port(sprob, tba.BAProblem), n, return_map=True)
    _assert_partition_equal(st, sj, n)
    assert (mt == mj).all()
    c1, c2, raw = jgba.prepare_chain_pairs(data, np.asarray(jst.kf_valid))
    obs_cam = np.asarray(data.obs_cam)
    pos = N(tgba.chain_positions(T(obs_cam), T(c1), T(raw)))
    o1, o2, cpos = tdba.shard_chain_pairs(c1, c2, mt, n, pos)
    jo1, jo2, _ = jdba.shard_chain_pairs(c1, c2, mj, n)
    for a, b in ((o1, jo1), (o2, jo2)):
        assert a.shape == b.shape and (N(a) == np.asarray(b)).all()
    # The chain positions (C42): each live pair at comp_of_cam[obs_cam[c1]],
    # laid out as its o1; -1 in the padding rows.
    comp_of_cam = np.full(len(raw), -1)
    comp_of_cam[raw[raw >= 0]] = np.nonzero(raw >= 0)[0]
    live = c1 >= 0
    want = np.full(cpos.shape, -1)
    order = np.argsort(mt[c1[live], 0], kind="stable")
    flat = N(o1) >= 0
    want[flat] = comp_of_cam[obs_cam[c1[live]]][order]
    assert cpos.shape == jo1.shape and (N(cpos) == want).all()
    assert (want[flat] >= 0).all() and len(np.unique(want[flat])) > 1


def test_shard_problem_dead_pairs():
    """ROADMAP C43: the JAX pair list pairs the padded rows too (all on
    landmark 0, so (pads)^2 pairs); the port pairs the valid observations
    only. The pads' pairs are gone, and the dense mesh solve on the port's
    arrays is the one on JAX's."""
    cam, jst, _, _, _ = _ba_state()
    _, sprob = _state_problem(jst)
    sj = jdba.shard_problem(sprob, 8)
    st = tdba.shard_problem(_port(sprob, tba.BAProblem), 8)
    _assert_partition_equal(st, sj, 8)
    assert int(N(st.pair_valid).sum()) < int(np.asarray(sj.pair_valid).sum())
    tcam = port_camera(cam)
    a = tdba.make_distributed_ba(MESH8, tcam, num_iters=4)(_port(sj, tdba.ShardedBAProblem))
    b = tdba.make_distributed_ba(MESH8, tcam, num_iters=4)(st)
    for x, y in zip(a, b):  # the same sums of other batch sizes: f32 last places
        np.testing.assert_allclose(N(x), N(y), rtol=1e-5, atol=1e-5)


def test_landmark_mesh_psum():
    """psum: the shards' parts summed in shard order, on every shard's device."""
    mesh = LandmarkMesh(["cpu"] * 3)
    parts = [torch.full((2, 6), float(i + 1)) for i in range(3)]
    out = mesh.psum(parts)
    assert len(out) == 3 and all(torch.equal(o, torch.full((2, 6), 6.0)) for o in out)
    flat = torch.arange(12.0).reshape(6, 2)
    assert [p.tolist() for p in mesh.split(flat)] == [[[0, 1], [2, 3]], [[4, 5], [6, 7]],
                                                     [[8, 9], [10, 11]]]
    calls = []
    assert mesh.replicated(lambda x: calls.append(x) or x + 1, [1, 1, 1]) == [2, 2, 2]
    assert len(calls) == 1  # once per distinct device


# ---------------------------------------------------------------------------
# The mesh solves against JAX's on the same sharded arrays.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case,atol", [("ba_state", (1e-4, 1e-3)),
                                       ("noise_free", (1e-4, 1e-3)),
                                       ("noisy", (5e-3, 2e-2))])
def test_dense_mesh_matches_jax(mesh8, case, atol):
    if case == "ba_state":
        cam, jst, _, _, _ = _ba_state()
        _, prob = _state_problem(jst)
    else:
        kw = dict(noise=0.0, perturb=0.02) if case == "noise_free" else dict(C=5, M=96,
                                                                            noise=0.3)
        cam, prob, _, _ = _make_problem(_rng(), **kw)
    sj = jdba.shard_problem(prob, 8)
    pj, lj = jdba.make_distributed_ba(mesh8, cam, num_iters=8)(sj)
    pt, lt = tdba.make_distributed_ba(MESH8, port_camera(cam), num_iters=8)(
        _port(sj, tdba.ShardedBAProblem))
    np.testing.assert_allclose(N(pt), np.asarray(pj), atol=atol[0])
    lv = np.asarray(sj.lm_valid)
    np.testing.assert_allclose(N(lt)[lv], np.asarray(lj)[lv], atol=atol[1])


def _chain_problem(K):
    """A forward chain of K keyframes (testing/large_map.py's, small), its
    poses but the first moved by 2 cm, as the sharded problem and the
    chain pairs both packages' PCG mesh solves take: JAX's local slots
    with the port's chain positions (C42). Also returns the prepared
    observations and the chain's keyframe slots."""
    from structure_plp_slam_tpu_torch.data import map_state as tms
    from tests.test_large_map_loop import _build_large_map

    cam, jst, _ = _build_large_map(_rng(), K=K, lm_per_kf=8, N=32)
    pose = np.array(jst.kf_pose)
    pose[1:, :, 3] += _rng().normal(size=(K - 1, 3)).astype(np.float32) * 0.02
    jst = jst._replace(kf_pose=jnp.asarray(pose))
    data, prob = _state_problem(jst)
    sp, obs_map = jdba.shard_problem(prob, 8, return_map=True)
    c1, c2, raw = jgba.prepare_chain_pairs(data, np.asarray(jst.kf_valid))
    o1, o2, _ = jdba.shard_chain_pairs(c1, c2, obs_map, 8)
    pos = N(tgba.chain_positions(T(np.asarray(data.obs_cam)), T(c1), T(raw)))
    cpos = tdba.shard_chain_pairs(c1, c2, obs_map, 8, pos)[2]
    chain = (o1, o2, jnp.asarray(N(cpos), jnp.int32))
    comp = (jnp.asarray(np.clip(raw, 0, K - 1), jnp.int32), jnp.asarray(raw >= 0))
    tst = tms.from_numpy({f: np.asarray(getattr(jst, f)) for f in jst._fields}, "cpu")
    return cam, jst, tst, sp, chain, comp, data, raw


@pytest.mark.parametrize("K", [12, 32])
def test_pcg_mesh_matches_jax(mesh8, K):
    cam, _, _, sp, chain, comp, _, _ = _chain_problem(K)
    pj, lj = jdba.make_distributed_ba_pcg(mesh8, cam, num_iters=2)(sp, *chain, *comp)
    pt, lt = tdba.make_distributed_ba_pcg(MESH8, port_camera(cam), num_iters=2)(
        _port(sp, tdba.ShardedBAProblem), *(T(np.asarray(a)) for a in chain + comp))
    np.testing.assert_allclose(N(pt), np.asarray(pj), atol=1e-4)
    lv = np.asarray(sp.lm_valid)
    np.testing.assert_allclose(N(lt)[lv], np.asarray(lj)[lv], atol=1e-3)


def test_pcg_mesh_matches_single_device_perturbed():
    """C42: on the K = 32 chain map with 2 cm of pose noise the port's mesh
    PCG (8 CPU shards, 2 iterations) lands within the mesh bounds of the
    JAX package's one-device PCG, and the solve moves the poses."""
    K = 32
    cam, jst, _, sp, chain, comp, data, raw = _chain_problem(K)
    pt, lt = tdba.make_distributed_ba_pcg(MESH8, port_camera(cam), num_iters=2)(
        _port(sp, tdba.ShardedBAProblem), *(T(np.asarray(a)) for a in chain + comp))
    c1, c2, _ = jgba.prepare_chain_pairs(data, np.asarray(jst.kf_valid))
    c1, c2 = jgba.pad_chain_pairs(c1, c2)
    pj, lj = jgba.solve_pcg(cam, jst.kf_pose, jst.kf_valid, jnp.arange(K) == 0, jst.lm_pos,
                            jst.lm_valid, data, jnp.asarray(c1), jnp.asarray(c2),
                            jnp.asarray(raw), num_iters=2)
    kv, lv = np.asarray(jst.kf_valid), np.asarray(jst.lm_valid)
    assert np.abs(np.asarray(pj) - np.asarray(jst.kf_pose))[kv].max() > 0.01
    np.testing.assert_allclose(N(pt)[kv], np.asarray(pj)[kv], atol=5e-3)
    lm = _unshard(N(lt), 8, lv.shape[0])
    np.testing.assert_allclose(lm[lv], np.asarray(lj)[lv], atol=2e-2)


def _perturbed_large_map(rng, dtype=torch.float32):
    """tests/test_distributed_ba.py's K = 1024 chain map (8 landmarks per
    keyframe, 32 slots) with 2 cm of noise on every pose but the first,
    its poses and landmarks in ``dtype``."""
    from structure_plp_slam_tpu_torch.testing.large_map import build_large_map

    cam, state, _ = build_large_map(rng, K=1024, lm_per_kf=8, N=32, device="cpu")
    pose = state.kf_pose.clone()
    pose[1:, :, 3] += T(rng.normal(size=(pose.shape[0] - 1, 3)).astype(np.float32)) * 0.02
    return cam, state._replace(kf_pose=pose.to(dtype), lm_pos=state.lm_pos.to(dtype))


@pytest.mark.parametrize("n", [2, 8])
def test_pcg_mesh_matches_single_device_f64(rng, n):
    """C44: in float64 the mesh PCG on the perturbed K = 1024 chain map
    lands within 1e-9 of the one-device PCG (both moving the poses by more
    than 0.01 m), so the mesh bounds' gap in float32 (up to a few mm, the
    slow test below) is summation order that the weakly tied chain's 40
    CG steps amplify, and no second difference between the routes."""
    cam, state = _perturbed_large_map(rng, torch.float64)
    table = np.ones(8, np.float32)
    ref = tgba.run_global_ba(cam, state, table, anchor_kf=0, num_iters=2)
    out = tgba.run_global_ba(cam, state, table, anchor_kf=0, num_iters=2,
                             mesh=LandmarkMesh(["cpu"] * n))
    assert ref.kf_pose.dtype == out.kf_pose.dtype == out.lm_pos.dtype == torch.float64
    kv, lv = N(state.kf_valid), N(state.lm_valid)
    assert np.abs(N(ref.kf_pose) - N(state.kf_pose))[kv].max() > 0.01
    np.testing.assert_allclose(N(out.kf_pose)[kv], N(ref.kf_pose)[kv], rtol=0, atol=1e-9)
    np.testing.assert_allclose(N(out.lm_pos)[lv], N(ref.lm_pos)[lv], rtol=0, atol=1e-9)


def test_chain_blocks_reference_departure():
    """C42 states the reference's fault: at the first linearization of the
    K = 32 chain map, the chain blocks the port's mesh sums over its 8
    shards equal the one-device PCG's (1e-5 relative to the largest
    block), while the JAX package's chain positions (each pair's index in
    the chain-pair list) put them elsewhere."""
    K = 32
    cam, jst, tst, sp, chain, _, _, raw = _chain_problem(K)
    tcam = port_camera(cam)
    data = tgba.prepare(tst, np.ones(8, np.float32))
    free_f = (torch.arange(K) != 0).to(torch.float32) * tst.kf_valid
    U_o, _, _, Hll_inv, bl = tgba._normal_blocks(tcam, tst.kf_pose, tst.lm_pos, data, 1e-4)
    UH = tgba._schur_reduction(data, U_o, Hll_inv, bl, K)[1]
    c1, c2, _ = tgba.prepare_chain_pairs(data, N(tst.kf_valid))
    single = tgba._chain_blocks(data, U_o, UH, free_f, T(c1), T(c2),
                                tgba.chain_positions(data.obs_cam, T(c1), T(raw)), K)

    tsp = _port(sp, tdba.ShardedBAProblem)
    shards, lm = tdba._shards(MESH8, tsp), MESH8.split(tsp.lm_pos)
    jax_cpos = jdba.shard_chain_pairs(
        c1, c2, jdba.shard_problem(_state_problem(jst)[1], 8, return_map=True)[1], 8)[2]

    def mesh_blocks(cpos):
        total = torch.zeros_like(single)
        pairs = zip(*(MESH8.split(T(np.asarray(a))) for a in (chain[0], chain[1], cpos)))
        for s, lm_s, (o1, o2, cp) in zip(shards, lm, pairs):
            Us, _, _, Hs, bs = tgba._normal_blocks(tcam, s.cam_pose, lm_s, s.data, 1e-4,
                                                   live=s.live)
            UHs = tgba._schur_reduction(s.data, Us, Hs, bs, K)[1]
            total += tgba._chain_blocks(s.data, Us, UHs, free_f, o1, o2, cp, K)
        return total

    scale = float(single.abs().max())
    assert scale > 0
    np.testing.assert_allclose(N(mesh_blocks(chain[2])), N(single), rtol=0, atol=1e-5 * scale)
    assert float((mesh_blocks(jax_cpos) - single).abs().max()) > 0.1 * scale


def test_run_global_ba_mesh_matches_jax(mesh8):
    """tests/test_global_ba.py::test_global_ba_sharded_matches_single_device
    on the port (its bounds against the single-device solve and the
    ground truth), and the port's mesh solve against JAX's."""
    cam, jst, tst, poses_gt, pts = _ba_state()
    table = np.ones(8, np.float32)
    tcam = port_camera(cam)
    single = tgba.run_global_ba(tcam, tst, table, anchor_kf=0)
    sharded = tgba.run_global_ba(tcam, tst, table, anchor_kf=0, mesh=MESH8)
    ref = jgba.run_global_ba(cam, jst, table, anchor_kf=0, mesh=mesh8)
    est_s, est_1 = N(sharded.kf_pose), N(single.kf_pose)
    for c, (R, t) in enumerate(poses_gt):
        dR = est_s[c, :, :3] @ R.T
        ang = np.linalg.norm(np.asarray(jlie.so3_log(jnp.asarray(dR[None], jnp.float32))))
        assert ang < 5e-3, f"kf {c} rot err {ang}"
        assert np.linalg.norm(est_s[c, :, 3] - t) < 0.05
    K_valid = int(N(tst.kf_valid).sum())
    assert np.abs(est_s[:K_valid] - est_1[:K_valid]).max() < 5e-3
    M = len(pts)
    assert np.abs(N(sharded.lm_pos)[:M] - N(single.lm_pos)[:M]).max() < 2e-2
    np.testing.assert_allclose(est_s, np.asarray(ref.kf_pose), atol=1e-4)
    np.testing.assert_allclose(N(sharded.lm_pos), np.asarray(ref.lm_pos), atol=1e-3)


# ---------------------------------------------------------------------------
# tests/test_distributed_ba.py on the port.
# ---------------------------------------------------------------------------


def test_sharded_matches_single_device():
    cam, prob, _, _ = _make_problem(_rng(), C=5, M=96, noise=0.3)
    tcam, tprob = port_camera(cam), _port(prob, tba.BAProblem)
    ref = tba.ba_solve(tcam, tprob, num_iters=8, cull_at_iters=())
    cam_pose, lm_flat = tdba.make_distributed_ba(MESH8, tcam, num_iters=8)(
        tdba.shard_problem(tprob, 8))
    np.testing.assert_allclose(N(cam_pose), N(ref.cam_pose), atol=5e-3)
    np.testing.assert_allclose(_unshard(N(lm_flat), 8, 96), N(ref.lm_pos), atol=2e-2)


@pytest.mark.parametrize("model", ["fisheye", "equirectangular"])
def test_sharded_camera_model_dispatch(model):
    """The JAX test's fisheye and equirectangular maps (built with the JAX
    camera's projection): the port's mesh solve agrees with its
    single-device BA and recovers the true poses."""
    rng = _rng()
    if model == "fisheye":
        cam = make_camera(model=JModel.FISHEYE, k1=0.05, k2=-0.01)
        z_range = (5.0, 10.0)
    else:
        cam = make_camera(model=JModel.EQUIRECTANGULAR, cols=1024, rows=512,
                          fx=0.0, fy=0.0, cx=0.0, cy=0.0)
        z_range = (4.0, 9.0)
    C, M = 5, 96
    pts = create_random_landmarks(rng, M, space=6.0, z_range=z_range)
    poses = []
    for c in range(C):
        phi = rng.normal(size=3) * 0.02
        R = np.asarray(jlie.so3_exp(jnp.asarray(phi[None], jnp.float32)))[0]
        t = np.array([0.25 * (c - C / 2), 0.02 * c, 0.0]) + rng.normal(size=3) * 0.01
        poses.append((R, t))
    obs_cam, obs_lm, obs_uv = [], [], []
    for c, (R, t) in enumerate(poses):
        uv = np.asarray(jcam_base.project(cam, jnp.asarray(pts @ R.T + t, jnp.float32))[0])
        obs_cam += [c] * M
        obs_lm += list(range(M))
        obs_uv += list(uv)
    pose_arr = []
    for c, (R, t) in enumerate(poses):
        if c == 0:
            pose_arr.append(np.concatenate([R, t[:, None]], 1))
        else:
            dphi = rng.normal(size=3) * 0.015
            dR = np.asarray(jlie.so3_exp(jnp.asarray(dphi[None], jnp.float32)))[0]
            pose_arr.append(np.concatenate([dR @ R, (t + rng.normal(size=3) * 0.015)[:, None]],
                                           1))
    lm_init = pts + rng.normal(size=pts.shape) * 0.03
    O = len(obs_cam)
    prob = tba.BAProblem(
        cam_pose=torch.tensor(np.stack(pose_arr), dtype=torch.float32),
        cam_fixed=torch.arange(C) == 0, cam_valid=torch.ones(C, dtype=torch.bool),
        lm_pos=torch.tensor(lm_init, dtype=torch.float32), lm_valid=torch.ones(M, dtype=torch.bool),
        obs_cam=torch.tensor(obs_cam), obs_lm=torch.tensor(obs_lm),
        obs_uv=torch.tensor(np.stack(obs_uv), dtype=torch.float32),
        obs_xr=torch.full((O,), -1.0), obs_inv_sigma_sq=torch.ones(O),
        obs_valid=torch.ones(O, dtype=torch.bool))
    tcam = port_camera(cam)
    ref = tba.ba_solve(tcam, prob, num_iters=8, cull_at_iters=())
    cam_pose, _ = tdba.make_distributed_ba(MESH8, tcam, num_iters=8)(tdba.shard_problem(prob, 8))
    np.testing.assert_allclose(N(cam_pose), N(ref.cam_pose), atol=5e-3)
    for c, (R, t) in enumerate(poses):
        dR = N(cam_pose)[c, :, :3] @ R.T
        ang = np.linalg.norm(np.asarray(jlie.so3_log(jnp.asarray(dR[None], jnp.float32))))
        assert ang < 2e-3, f"{model} kf {c} rot err {ang}"


def test_sharded_converges():
    cam, prob, poses, _ = _make_problem(_rng(), C=5, M=96, noise=0.0, perturb=0.02)
    cam_pose, _ = tdba.make_distributed_ba(MESH8, port_camera(cam), num_iters=10)(
        tdba.shard_problem(_port(prob, tba.BAProblem), 8))
    errs_R, _ = _pose_errors(types.SimpleNamespace(cam_pose=N(cam_pose)), poses)
    assert errs_R.max() < 1e-3


@pytest.mark.slow
def test_sharded_pcg_matches_single_device_large_k(rng):
    """tests/test_distributed_ba.py's K = 1024 chain map (the PCG route
    past K = 512), its poses but the first moved by 2 cm (as built the map
    is at its optimum and no solve moves it): the port's mesh solve
    against its single-device PCG, at the JAX test's bounds (C42)."""
    cam, state = _perturbed_large_map(rng)
    pose = state.kf_pose
    table = np.ones(8, np.float32)
    ref = tgba.run_global_ba(cam, state, table, anchor_kf=0, num_iters=2)
    out = tgba.run_global_ba(cam, state, table, anchor_kf=0, num_iters=2, mesh=MESH8)
    kv, lv = N(state.kf_valid), N(state.lm_valid)
    assert np.abs(N(ref.kf_pose) - N(pose))[kv].max() > 0.01
    np.testing.assert_allclose(N(out.kf_pose)[kv], N(ref.kf_pose)[kv], atol=5e-3)
    np.testing.assert_allclose(N(out.lm_pos)[lv], N(ref.lm_pos)[lv], atol=2e-2)


# ---------------------------------------------------------------------------
# The System: the deferred global BA on mesh shards, and which mesh it builds.
# ---------------------------------------------------------------------------


def test_deferred_gba_on_mesh_shards(mesh8):
    """The deferred global BA with ``loop_closer.mesh`` set: one solve of
    gba_iters_per_chunk * gba_num_chunks = 8 iterations on the mesh, so
    the phases are fetch, enumerate, solve, adopt; the poses match the JAX
    mesh solve of 8 iterations."""
    cam, jst, tst, _, _ = _ba_state()
    ref = jgba.run_global_ba(cam, jst, np.ones(8, np.float32), anchor_kf=0, num_iters=8,
                             mesh=mesh8)
    slam = _bare_system(port_camera(cam), tst, next_kf=6)
    slam.loop_closer.mesh = MESH8
    slam._start_deferred_gba(anchor_kf=0)
    phases = []
    while slam._pending_gba is not None:
        phases.append(slam._pending_gba["phase"])
        slam._advance_deferred_gba()
    assert phases == ["fetch", "enumerate", "solve", "adopt"]
    kv = N(tst.kf_valid)
    np.testing.assert_allclose(N(slam._state.kf_pose)[kv], np.asarray(ref.kf_pose)[kv],
                               atol=1e-4)
    assert slam.timer.times["gba.chunk"] and len(slam.timer.times["gba.chunk"]) == 1


_KW = dict(name="synt", setup=CameraSetup.RGBD, model=CameraModel.PERSPECTIVE, cols=320,
           rows=240, fx=260.0, fy=260.0, cx=159.5, cy=119.5, fps=30.0, focal_x_baseline=26.0,
           depth_threshold=400.0, depthmap_factor=1.0)


def _system(**kw):
    cfg = Config(camera=Camera(**_KW), orb=OrbParams(max_num_keypts=600, num_levels=4), raw={})
    return System(cfg, max_keyframes=8, max_landmarks=4096, **kw)


@pytest.mark.parametrize("distributed_ba", [True, False])
def test_system_builds_no_mesh_on_the_cpu(distributed_ba):
    """On the CPU the port has one device: no mesh with either setting
    (a caller sets ``loop_closer.mesh`` itself)."""
    assert _system(device="cpu", distributed_ba=distributed_ba).loop_closer.mesh is None


@pytest.mark.cuda
def test_system_mesh_over_visible_cards():
    """On the card: one visible card builds no mesh; several build one
    shard per card; ``distributed_ba=False`` never builds one."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    n = torch.cuda.device_count()
    mesh = _system(device="cuda").loop_closer.mesh
    if n == 1:
        assert mesh is None
    else:
        assert [str(d) for d in mesh.devices] == [f"cuda:{i}" for i in range(n)]
    assert _system(device="cuda", distributed_ba=False).loop_closer.mesh is None

