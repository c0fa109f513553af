"""System facade: the public API of the port.

Port of structure_plp_slam_tpu/system.py for monocular, stereo and RGB-D
tracking, mapping and loop closing with point, line and plane landmarks
(reference PLPSLAM::system, src/PLPSLAM/system.cc): feed frames with
``feed_monocular_frame``, ``feed_stereo_frame`` or ``feed_RGBD_frame``,
read trajectories back. Stereo and RGB-D start from depth; a monocular map
starts from two views (``models/initializer.py``). Each frame
runs the frontend, then ``_track_step`` (motion-model prediction,
tracking, landmark statistics, decision packing); the host-side decisions
(lost check, keyframe insertion, trajectory record) trail the device by
``track_lag`` frames and read ONE packed vector per frame. On the card
that vector comes back through a pinned non-blocking copy and a CUDA
event (``utils/types.HostCopy``), so the copy overlaps the next frames'
work. A keyframe runs the whole mapping chain (``_kf_chain``) as one
Python function with no host sync inside. A frame that keeps fewer than
30 inliers is Lost and goes to the relocalizer; map capacities double
just before an insertion would hit them (``data/map_database.grow``).

Loop closing (``models/loop_closer.py``, on by default) runs as deferred
phases, so a closing loop never stalls one frame for the whole fix: a
keyframe chain scores the keyframe against the map; the next keyframe
gates the scores on the host (once their copy has landed, or after 3
keyframes) and starts the Sim3 validation; the following frames gate the
validation, then correct the map (Sim3 neighbourhood correction, pose
graph, duplicate fusion through the fused matcher), and the global BA runs
in chunks over later frames and is merged into the map as it is then.

Lines (``with_lines=True``): every frame detects line segments; the
tracker associates them with the map's 3D lines and refines the pose
jointly with the points when three match; keyframes create lines from
endpoint depths, from co-located point landmarks and (stereo, RGB-D) by
two-view triangulation, and local BA optimizes the window's lines with
the points. Planes: a frame fed with ``seg_mask`` (an instance-id image)
has its keyframe's landmarks bucketed by instance and plane-fitted; the
planes are merged, refit and their landmarks snapped to them.

Random draws (mono init, relocalization, loop validation, plane RANSAC)
follow the JAX System's key sequence from ``seed`` (``utils/prng``): one
key per mono init attempt, per keyframe, per lost frame, per loop
validation, per init plane fit and, with lines, per fed frame.

Cameras: perspective, fisheye (Kannala-Brandt) and equirectangular
(360 degrees, monocular; its matching takes the masked distance matrices
with the u window wrapped, as the JAX package routes it).

Control: ``pause_tracker`` / ``resume_tracker`` and ``request_terminate``
make the feeds drop frames (they return None); ``disable_mapping_module``
stops keyframe insertion; ``get_landmarks`` reads the map's points.

Several cards (``distributed_ba=True``, the default): on a CUDA device
with more than one visible card, the post-loop global BA runs
landmark-sharded over all of them (``parallel/distributed_ba``), as the
JAX System does over ``jax.devices()``. A caller may set
``loop_closer.mesh`` to any ``LandmarkMesh`` (several shards on one card,
or on the CPU). Past K = 512 keyframes the mesh route runs the PCG with
the one-device solve's chain preconditioner (ROADMAP C42: the JAX
package's mesh puts those blocks at the pairs' list indices).

I/O and viewers: ``save_map_database`` / ``load_map_database`` write and
read msgpack snapshots that either package loads (``io/map_io.py``; a
loaded map starts Lost and relocalizes); ``enable_autosave`` checkpoints
every n keyframes through the native writer (``native.py``). Each
consumed frame goes to ``get_frame_publisher()`` and the map is read by
``get_map_publisher()`` (``publish/``), both copy-on-read; the live web
viewer (``start_live_viewer``), the native TCP publisher
(``start_native_publisher``, a packet per keyframe) and the dense RGB-D
cloud (``store_dense_cloud=True``) are off unless asked for.

Usage:
    slam = System(config)   # device="cuda"
    slam.startup()
    for img, depth, ts in frames:
        slam.feed_RGBD_frame(img, depth, ts)
    slam.shutdown()
    traj = slam.frame_trajectory()
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import enum
import time
from typing import Any, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from structure_plp_slam_tpu_torch.camera import CameraModel, CameraSetup
from structure_plp_slam_tpu_torch.config import Config
from structure_plp_slam_tpu_torch.data import map_database
from structure_plp_slam_tpu_torch.data import map_state as ms
from structure_plp_slam_tpu_torch.io import trajectory as traj_io
from structure_plp_slam_tpu_torch.models import frontend as frontend_mod
from structure_plp_slam_tpu_torch.models import global_ba, initializer, line_ba, line_mapper
from structure_plp_slam_tpu_torch.models import loop_closer as loop_mod
from structure_plp_slam_tpu_torch.models import mapper, planar_mapper, tracker
from structure_plp_slam_tpu_torch.models import pose_graph as pg
from structure_plp_slam_tpu_torch.models.relocalizer import Relocalizer
from structure_plp_slam_tpu_torch.ops import lie, linalg
from structure_plp_slam_tpu_torch.ops import orb as orb_ops
from structure_plp_slam_tpu_torch.parallel.distributed_ba import LandmarkMesh
from structure_plp_slam_tpu_torch.publish.frame_publisher import FramePublisher
from structure_plp_slam_tpu_torch.publish.map_publisher import MapPublisher
from structure_plp_slam_tpu_torch.utils import prng
from structure_plp_slam_tpu_torch.utils.logging import get_logger
from structure_plp_slam_tpu_torch.utils.types import HostCopy, resolve_device, round_up, to_host

_log = get_logger("torch.system")


class StageTimer:
    """Per-stage wall-clock timing (reference tracking_module.cc:607-645).
    With ``synced=True`` each stage ends with ``torch.cuda.synchronize()``
    so its time includes the device work it issued. Each stage is also a
    ``stage.<name>`` range for torch.profiler, so a trace can attribute
    device kernels to stages (a no-op while no profiler runs)."""

    def __init__(self, synced: bool = False, device=None):
        self.synced = synced and device is not None and torch.device(device).type == "cuda"
        self.times: dict = collections.defaultdict(list)

    @contextlib.contextmanager
    def stage(self, name: str, sync_on=None):
        """Time the block as stage ``name``. ``sync_on`` names what the
        JAX package's synced timer waits for; a synced port timer waits
        for the whole card (``torch.cuda.synchronize``), which covers it."""
        t0 = time.perf_counter()
        try:
            with torch.profiler.record_function(f"stage.{name}"):
                yield
        finally:
            if self.synced:
                torch.cuda.synchronize()
            self.times[name].append(time.perf_counter() - t0)

    def summary(self) -> dict:
        out = {}
        for name, ts in self.times.items():
            a = np.asarray(ts)
            out[name] = {
                "count": int(len(a)),
                "mean_ms": float(a.mean()) * 1e3,
                "median_ms": float(np.median(a)) * 1e3,
                "max_ms": float(a.max()) * 1e3,
            }
        return out


class TrackerState(enum.Enum):
    NOT_INITIALIZED = "NotInitialized"
    TRACKING = "Tracking"
    LOST = "Lost"


# Layout of the per-frame packed decision vector.
_PK_NUM_TRACKED = 0
_PK_REF_TRACKED = 1
_PK_CLOSE_TRK = 2
_PK_CLOSE_UNTRK = 3
_PK_REF_KF = 4
_PK_NEXT_LM = 5
_PK_POSE = slice(6, 18)      # row-major [3,4] camera-from-world
_PK_REL = slice(18, 30)      # row-major [3,4] pose relative to ref keyframe
_PK_SIZE = 30


def _pack_decision(state, res, next_lm):
    """Fuse every per-frame host-needed value into one f32 vector."""
    kfp = state.kf_pose[res.ref_kf]
    R_ref, t_ref = kfp[:, :3], kfp[:, 3]
    R_rel = linalg.matmul(res.R, R_ref.T)
    t_rel = res.t - linalg.matvec(R_rel, t_ref)
    P = torch.cat([res.R, res.t[:, None]], 1)
    rel = torch.cat([R_rel, t_rel[:, None]], 1)
    dev = state.device
    head = torch.stack([
        res.num_tracked, res.ref_tracked, res.n_close_tracked, res.n_close_untracked,
        res.ref_kf, torch.as_tensor(next_lm, device=dev),
    ]).to(torch.float32)
    return torch.cat([head, P.reshape(-1), rel.reshape(-1)])


class _TrackCarry(NamedTuple):
    """The tracker's recurrent device state."""

    R: torch.Tensor           # [3, 3] camera-from-world rotation
    t: torch.Tensor           # [3]
    Rv: torch.Tensor          # [3, 3] velocity (frame-to-frame motion model)
    tv: torch.Tensor          # [3]
    last_kp_lm: torch.Tensor  # [N] previous frame's keypoint->landmark
    ref_kf: Any               # reference keyframe (int or device scalar)


def _track_step(camera, state, feats, carry: _TrackCarry, inv_sigma_sq, obs_ind,
                min_obs, next_lm, *, num_levels, scale_factor, with_lines=False, timer=None):
    """The per-frame device pipeline: motion-model prediction, tracking,
    landmark statistics, line tracking, motion-model update, decision
    packing, the viewer's plane id per keypoint. Returns (state, res, carry,
    packed, seg_lines or None, kp_plane)."""
    # The motion model's 3x3 products in XLA:CPU's order on the CPU (one
    # multiply-add chain per entry; the plain products on the card).
    R_pred = linalg.matmul(carry.Rv, carry.R)
    t_pred = linalg.matvec(carry.Rv, carry.t) + carry.tv
    res = tracker.track_frame(
        camera, state, feats, R_pred, t_pred, carry.last_kp_lm, carry.ref_kf,
        inv_sigma_sq, obs_ind, min_obs, num_levels=num_levels, scale_factor=scale_factor,
    )
    state = state._replace(
        lm_n_vis=state.lm_n_vis + res.lm_vis.to(torch.int64),
        lm_n_fnd=state.lm_n_fnd + res.lm_fnd.to(torch.int64),
    )
    seg_lines = None
    if with_lines:
        # Associate the map lines and refine the pose jointly, gated on the
        # device on >= 3 line matches (pose_optimizer_extended_line).
        L = state.lm_pos.shape[0]
        info = inv_sigma_sq[torch.clamp(feats["level"], 0, inv_sigma_sq.shape[0] - 1)]
        with timer.stage("track.lines") if timer else contextlib.nullcontext():
            state, R_l, t_l, seg_lines = line_mapper.track_lines(
                camera, state, feats["seg"], feats["seg_desc"], feats["seg_valid"],
                state.lm_pos[torch.clamp(res.kp_lm, 0, L - 1)], feats["xy"], info,
                (res.kp_lm >= 0) & feats["valid"], res.R, res.t,
            )
        res = res._replace(R=R_l, t=t_l)
    Rv2 = linalg.matmul(res.R, carry.R.T)
    carry2 = _TrackCarry(
        R=res.R, t=res.t, Rv=Rv2, tv=res.t - linalg.matvec(Rv2, carry.t),
        last_kp_lm=res.kp_lm, ref_kf=res.ref_kf,
    )
    L = state.lm_pos.shape[0]
    kp_plane = torch.where(res.kp_lm >= 0, state.lm_plane[torch.clamp(res.kp_lm, 0, L - 1)], -1)
    return state, res, carry2, _pack_decision(state, res, next_lm), seg_lines, kp_plane


def _clear_failed_init(state):
    """Undo a failed depth-init keyframe insertion: clear the validity
    masks and the keyframe's association row."""
    return state._replace(
        kf_valid=ms.with_row(state.kf_valid, 0, False),
        kf_kp_valid=ms.with_row(state.kf_kp_valid, 0, False),
        kf_lm_idx=ms.with_row(state.kf_lm_idx, 0, -1),
        lm_valid=torch.zeros_like(state.lm_valid),
        lm_plane=torch.full_like(state.lm_plane, -1),
    )


def _rebase_pose(R, t, P_old, P_new):
    """Carry a camera pose through its reference keyframe's correction:
    the pose relative to the keyframe stays while the keyframe moves from
    ``P_old`` to ``P_new`` (all world->camera)."""
    R_rel = R @ P_old[:, :3].T
    t_rel = t - R_rel @ P_old[:, 3]
    return R_rel @ P_new[:, :3], R_rel @ P_new[:, 3] + t_rel


def _child_poses(old, new, last):
    """Every pose of ``old`` carried by the delta of keyframe ``last``
    (old -> new): P_child o P_last_old^-1 o P_last_new. Keyframes inserted
    while a solve was in flight follow their spanning-tree parent this way
    (loop_bundle_adjuster.cc:110-145)."""
    Rc, tc = old[last, :, :3], old[last, :, 3]
    Rm = Rc.T @ new[last, :, :3]
    tm = Rc.T @ (new[last, :, 3] - tc)
    R_child = torch.einsum("kij,jl->kil", old[:, :, :3], Rm)
    t_child = torch.einsum("kij,j->ki", old[:, :, :3], tm) + old[:, :, 3]
    return lie.pack_pose(R_child, t_child)


def _gba_adopt_step(state, solved_pose, solved_lm, snap_kf_valid, snap_lm_valid,
                    snap_next_kf: int):
    """Merge a deferred global-BA result into the map as it is now
    (loop_bundle_adjuster.cc:100-145): keyframes of the solve's snapshot
    take the solved poses, later ones ride the delta of the snapshot's
    newest keyframe; snapshot landmarks take the solved positions,
    landmarks made since (and lines and planes) ride their reference
    keyframes' deltas."""
    K = state.kf_pose.shape[0]
    old = state.kf_pose
    existed = (torch.arange(K, device=old.device) < snap_next_kf) & snap_kf_valid
    last = min(max(snap_next_kf - 1, 0), K - 1)
    adopted = torch.where(existed[:, None, None], solved_pose,
                          _child_poses(old, solved_pose, last))
    keep_lm = snap_lm_valid & state.lm_valid
    state = state._replace(kf_pose=adopted,
                           lm_pos=torch.where(keep_lm[:, None], solved_lm, state.lm_pos))
    ones = torch.ones((K,), dtype=torch.float32, device=old.device)
    return pg.correct_map_structures(
        state, old[:, :, :3], old[:, :, 3], ones, adopted[:, :, :3], adopted[:, :, 3], ones,
        lm_mask=state.lm_valid & ~snap_lm_valid,
    )


def _loopfix_adopt(state, R_opt, t_opt, s_opt, snap_next_kf: int):
    """Apply a loop correction's pose-graph result to the map as it is
    now: keyframes of the fix's snapshot (``slot < snap_next_kf``) take
    the optimized poses (scale folded into SE3), later ones ride the
    newest snapshot keyframe's delta; landmarks, lines and planes ride
    their reference keyframes' Sim3 deltas from the current poses."""
    K = state.kf_pose.shape[0]
    old = state.kf_pose
    existed = torch.arange(K, device=old.device) < snap_next_kf
    new_se3 = lie.pack_pose(R_opt, t_opt / torch.clamp(s_opt, min=1e-12)[:, None])
    last = min(max(snap_next_kf - 1, 0), K - 1)
    adopted = torch.where(existed[:, None, None], new_se3, _child_poses(old, new_se3, last))
    ones = torch.ones((K,), dtype=torch.float32, device=old.device)
    state = pg.correct_map_structures(
        state, old[:, :, :3], old[:, :, 3], ones,
        torch.where(existed[:, None, None], R_opt, adopted[:, :, :3]),
        torch.where(existed[:, None], t_opt, adopted[:, :, 3]),
        torch.where(existed, s_opt, ones),
    )
    return state._replace(kf_pose=adopted)


def _kf_chain(camera, st, slot, pose, ts, feats, kp_lm, next_lm, inv_sigma_sq, ind0,
              bow, *, do_ba, do_cull_kf, stats_full, do_detect, num_tri_neighbors,
              scale_factor, num_levels, timer, with_lines=False, seg_line_idx=None,
              two_view_lines=False, next_line=0, seg_mask=None, planar=None,
              use_graph_cut=True, key=None, next_plane=0):
    """The keyframe processing chain (reference mapping thread,
    mapping_module.cc:193-285, plus the loop detector's scoring of
    global_optimization_module.cc): insert, cull landmarks, triangulate,
    lines (the frame's line associations, lines from endpoint depths and
    from point landmarks, two-view lines, line culling), fuse, planes from
    ``seg_mask`` (detect, merge, refine, snap), line refresh and local BA,
    cull keyframes, statistics and, with ``do_detect``, the loop-detection
    arrays. The observation indicator ``ind0`` is patched row by row
    between stages (only fuse's global remap rebuilds it). Returns
    (state, next_lm, next_line, next_plane, indicator, packed detection
    [K, 3] or None, covisibility or None)."""
    K = st.kf_pose.shape[0]
    dev = st.device
    st, created = mapper.insert_keyframe(camera, st, slot, pose, ts, feats, kp_lm, next_lm)
    next_lm = next_lm + created
    slot_t = torch.tensor([slot], device=dev)
    ind = ms.indicator_update_rows(ind0, st, slot_t)
    st, _ = mapper.cull_landmarks(st, slot, ind=ind)
    ind = ind * st.lm_valid[None, :].to(torch.float32)
    st, n_tri, tri_nbs = mapper.triangulate_with_neighbors(
        camera, st, slot, next_lm, ind, num_neighbors=num_tri_neighbors,
        return_neighbors=True,
    )
    next_lm = next_lm + n_tri
    if with_lines:
        with timer.stage("keyframe.lines"):
            if seg_line_idx is not None:
                st = st._replace(kf_line_idx=ms.with_row(st.kf_line_idx, slot, seg_line_idx))
            st, n = line_mapper.lines_from_depth(camera, st, slot, next_line)
            next_line = next_line + n
            st, n = line_mapper.lines_from_points(camera, st, slot, next_line)
            next_line = next_line + n
            if two_view_lines:
                st, n = line_mapper.triangulate_lines_with_neighbors(camera, st, slot, next_line)
                next_line = next_line + n
            st, _ = line_mapper.cull_lines(st, slot)
    ind = ms.indicator_update_rows(ind, st, torch.cat([slot_t, tri_nbs]))
    kf_mask = torch.zeros((K,), dtype=torch.bool, device=dev)
    kf_mask[slot] = True
    lm_local = ms.local_landmark_mask(st, kf_mask, ind)
    st, _ = mapper.fuse_into_keyframe(camera, st, slot, lm_local, ind=ind)
    ind = ms.observation_indicator(st)
    if seg_mask is not None:
        with timer.stage("keyframe.planes"):
            labels = planar_mapper.label_keypoints(seg_mask, feats["xy"], feats["valid"],
                                                   check_3x3=planar.check_3x3_window)
            scale = mapper.map_scale(st, slot)
            st, n_pl = planar_mapper.detect_planes(
                st, slot, labels, next_plane, key, scale, max_instances=planar.max_instances,
                coherent=use_graph_cut, params=planar)
            next_plane = next_plane + n_pl
            st, _ = planar_mapper.merge_planes(st, scale, params=planar)
            st = planar_mapper.refine_planes(st, scale, params=planar)
            st = planar_mapper.snap_points_to_planes(st, scale, params=planar)

    ba_cams = None
    if do_ba:
        if with_lines:
            st = line_mapper.refresh_lines(camera, st)
        # The chain's BA is, on the CPU, XLA:CPU's (ops/ba_cpu).
        st, _, ba_cams = mapper.local_ba(camera, st, slot, inv_sigma_sq, with_lines=with_lines,
                                         ind=ind, return_cams=True, _xla="chain")
        ind = ms.indicator_update_rows(ind, st, ba_cams)
    if do_cull_kf:
        st, _ = mapper.cull_keyframes(st, slot, ind=ind)
        ind = ind * st.kf_valid[:, None].to(torch.float32)
    if stats_full:
        st = mapper.refresh_landmark_stats(
            st, ind, scale_factor=scale_factor, num_levels=num_levels,
            window_kfs=ba_cams,
        )
    else:
        st = mapper.update_landmark_normals(st, ind)
    if not do_detect:
        return st, next_lm, next_line, next_plane, ind, None, None
    cov = ms.covisibility_matrix(st, ind)
    packed = loop_mod._pack_detect_arrays(cov, slot, bow.scores_for_slot(st, slot), st.kf_valid)
    return st, next_lm, next_line, next_plane, ind, packed, cov


@dataclasses.dataclass
class _PendingFrame:
    """A fed frame whose host-side decisions are deferred by ``track_lag``
    frames; ``packed`` is the decision vector's copy on the host."""

    packed: HostCopy
    feats: dict
    ts: float
    res: Any
    frames_since_kf: int
    seg_mask: Optional[torch.Tensor] = None
    seg_line_idx: Optional[torch.Tensor] = None
    kp_plane: Optional[torch.Tensor] = None  # the viewer's plane id per keypoint
    dense: Optional[tuple] = None  # (gray_small u8, depth_small f32) for the dense cloud


def _keep_image(img):
    """Retain a fed image for the frame publisher. A host numpy image is
    COPIED (dataset readers may decode into a reused buffer); a tensor is
    kept as it is (no copy off the card on the frame path)."""
    if isinstance(img, np.ndarray):
        return np.array(img, copy=True)
    return img


def _dense_sample(img, depthmap, stride: int, depthmap_factor: float):
    """The strided gray (u8) and metric depth (f32) a keyframe keeps for the
    dense cloud display; tensors stay on their device."""
    s = stride
    g, d = img[s // 2::s, s // 2::s], depthmap[s // 2::s, s // 2::s]
    if torch.is_tensor(g):
        return (torch.clamp(g, 0, 255).to(torch.uint8),
                torch.as_tensor(d).to(torch.float32) * float(np.float32(1.0 / depthmap_factor)))
    g, d = np.asarray(g), np.asarray(d).astype(np.float32)
    return np.clip(g, 0, 255).astype(np.uint8), d * np.float32(1.0 / depthmap_factor)


class System:
    # Lines off unless __init__ turns them on (the loop and global-BA steps
    # read it, also on a System built without __init__).
    with_lines = False

    def __init__(
        self,
        config: Config,
        *,
        max_keyframes: int = 256,
        max_landmarks: int = 32768,
        seed: int = 0,
        enable_mapping: bool = True,
        enable_loop_closing: bool = True,
        with_lines: bool = False,
        num_triangulation_neighbors: int = 2,
        max_kf_interval: Optional[int] = None,
        min_kf_interval: int = 0,
        track_lag: int = 2,
        auto_grow: bool = True,
        verbose_timing: bool = False,
        async_loop_ba: bool = True,
        distributed_ba: bool = True,
        store_dense_cloud: bool = False,
        dense_cloud_stride: int = 8,
        device=None,
    ):
        self.device = resolve_device(device)
        # Dense RGB-D cloud display (reference: pangolin_viewer/viewer.h
        # :132-133): each keyframe keeps a strided copy of its gray and
        # depth images; viewers backproject them under the CURRENT
        # keyframe poses, so the cloud follows BA and loop corrections.
        self.store_dense_cloud = bool(store_dense_cloud)
        self.dense_cloud_stride = int(dense_cloud_stride)
        self.timer = StageTimer(synced=verbose_timing, device=self.device)
        self.auto_grow = bool(auto_grow)
        # ``track_lag``: how many frames the host-side decisions may trail
        # the device work (0 = synchronous per-frame semantics).
        self.track_lag = max(0, int(track_lag))
        self._pending: collections.deque = collections.deque()
        # Keyframe conditions A1/A2 (keyframe_inserter.cc:76-81).
        self.max_kf_interval = (
            max_kf_interval if max_kf_interval is not None else int(config.camera.fps)
        )
        self.min_kf_interval = min_kf_interval
        self.config = config
        self.camera = config.camera
        # The spatially coherent consensus for the mono-init H/E races
        # (GC-RANSAC, initialize/perspective.cc:70-85), by its own YAML key.
        self.init_graph_cut = bool(config.raw.get("Initializer.use_graph_cut", False))
        # Lines may also be switched on by the reference's YAML key
        # (Threshold.use_line_tracking, system.cc:550-556); the planar
        # thresholds come from planar_mapping_parameters.yaml's keys.
        self.with_lines = bool(with_lines or config.raw.get("Threshold.use_line_tracking", False))
        self.planar = planar_mapper.PlanarParams.from_raw(config.raw)
        self.use_graph_cut = self.planar.use_graph_cut
        self.key = prng.PRNGKey(seed)
        # Loop closing and relocalization share the retrieval index.
        self.enable_loop_closing = enable_loop_closing
        self.loop_closer = loop_mod.LoopCloser(config.camera, device=self.device)
        if distributed_ba and self.device.type == "cuda" and torch.cuda.device_count() > 1:
            self.loop_closer.mesh = LandmarkMesh(
                [f"cuda:{i}" for i in range(torch.cuda.device_count())])
        self.relocalizer = Relocalizer(config.camera, self.loop_closer.bow)
        self.num_relocalizations = 0
        # The post-loop global BA (the reference's loop-BA thread,
        # loop_bundle_adjuster.cc:68-145) runs ``gba_num_chunks`` chunks of
        # ``gba_iters_per_chunk`` iterations over later frames and is
        # merged at its end; ``async_loop_ba=False`` runs it at once.
        self.async_loop_ba = bool(async_loop_ba)
        self.gba_iters_per_chunk = 2
        self.gba_num_chunks = 5
        cap = round_up(
            orb_ops.OrbExtractor(config.camera.rows, config.camera.cols, config.orb).capacity,
            8,
        )
        self.frontend = frontend_mod.Frontend(config.camera, config.orb, pad_to=cap,
                                              with_lines=self.with_lines, device=self.device)
        self.frontend.timer = self.timer
        self.max_keyframes = max_keyframes
        self.max_landmarks = max_landmarks
        self.num_tri_neighbors = num_triangulation_neighbors
        self.enable_mapping = enable_mapping
        self.num_frames = 0
        self.num_track_steps = 0
        self._running = False
        self._paused = False
        self._terminate_requested = False
        # Publishers (reference: system.h:103-106 getter pair) and the
        # default-off surfaces: the live viewer, the native TCP publisher
        # and the autosave writer.
        self.frame_publisher = FramePublisher()
        self.map_publisher = MapPublisher(self)
        self._last_image = None
        self._live_viewer = None
        self._native_pub = None
        self._autosave = None
        self._autosave_every = 10
        self.reset()

    # ------------------------------------------------------------------
    @property
    def state(self) -> ms.MapState:
        """The current MapState, after draining pending frame decisions
        and any loop fix or global BA in flight."""
        self._drain_pending()
        return self._state

    @state.setter
    def state(self, value):
        self._drain_pending()
        self._state = value
        self._ind_cache = None  # the new map's associations may differ

    @property
    def tracking_state(self) -> TrackerState:
        self._drain_pending()
        return self._tracking_state

    @tracking_state.setter
    def tracking_state(self, value):
        self._tracking_state = value

    def _drain_pending(self):
        while self._pending:
            self._consume(self._pending.popleft())
        if self._pending_loop is not None:
            self._consume_pending_loop(force=True)
        while self._pending_fix is not None:
            self._advance_pending_fix()
        self._finish_deferred_gba()

    # ------------------------------------------------------------------
    # Loop closing as deferred phases (reference: the loop thread,
    # global_optimization_module.cc:90-296, and the loop-BA thread).
    # ------------------------------------------------------------------
    def _consume_pending_loop(self, force=False):
        """Gate the previous keyframe's loop detection on the host and, on
        a candidate, start its Sim3 validation; the validation's gate, the
        correction and the pose graph run in later frames
        (:meth:`_advance_pending_fix`). The read waits for nothing: while
        the detection's copy has not landed, it stays pending (no new
        detection starts) for at most 3 keyframes, then it is read."""
        kf_cur, packed = self._pending_loop
        if not force and self._pending_loop_age < 3 and not packed[0].ready():
            self._pending_loop_age += 1
            return
        self._pending_loop = None
        self._pending_loop_age = 0
        with self.timer.stage("loop_detect"):
            cand = self.loop_closer.detect_consume(packed, kf_cur)
        if cand is None or self._pending_fix is not None:
            return  # no loop, or one is in flight (its cool-down covers this)
        lc = self.loop_closer
        prev_cooldown = lc.last_loop_kf
        # The cool-down starts now, so detection pauses while the fix is in
        # flight; a rejected candidate restores it.
        lc.last_loop_kf = kf_cur
        self._pending_fix = {
            "phase": "validate", "kf_cur": int(kf_cur), "cand": int(cand),
            "prev_cooldown": prev_cooldown,
            "packed": lc.validate_dispatch(self._state, kf_cur, cand, self._split_key()),
            "n0": self.next_kf, "K": self._state.kf_pose.shape[0],
        }

    def _advance_pending_fix(self):
        """Advance the loop fix in flight by one phase (once per fed frame):

        validate -> gate the Sim3; start the host copies the correction
                    needs (poses, validity, the two keyframes'
                    covisibility rows, the strong-pair list);
        correct  -> numpy neighbourhood correction and pose-graph edges on
                    those copies, then device work: graph solve, adoption
                    into the current map, duplicate fusion through the
                    fused matcher, tracker pose rebase, deferred global BA.
        """
        f = self._pending_fix
        if f is None:
            return
        lc = self.loop_closer
        st = self._state
        if st.kf_pose.shape[0] != f["K"]:
            _log.info("pending loop fix dropped (map capacity grew)")
            lc.last_loop_kf = f["prev_cooldown"]
            self._pending_fix = None
            return
        if f["phase"] == "validate":
            with self.timer.stage("loopfix.validate"):
                val = lc.validate_consume(f["packed"])
                if val is None:
                    lc.last_loop_kf = f["prev_cooldown"]
                    self._pending_fix = None
                    return
                f["val"] = val
                kf_cur, cand = f["kf_cur"], f["cand"]
                _log.info("loop closure: keyframe %d -> %d (s=%.3f)", kf_cur, cand, val[2])
                cov = ms.covisibility_matrix(st, self._obs_indicator())
                f["fetch"] = {
                    "pose": HostCopy(st.kf_pose), "valid": HostCopy(st.kf_valid),
                    "rows": HostCopy(cov[[kf_cur, cand]]),
                    "pairs": HostCopy(loop_mod._strong_pair_list(st, cap=4096)),
                }
                f["n1"] = self.next_kf
                f["phase"] = "correct"
            return
        with self.timer.stage("loopfix.correct"):
            kf_cur, cand = f["kf_cur"], f["cand"]
            R21, t21, s21 = f["val"]
            # A global BA still in flight solved a map from before this
            # correction: merge it first.
            self._finish_deferred_gba()
            fetch = {k: v.numpy() for k, v in f["fetch"].items()}
            pose_h, valid_h = fetch["pose"], fetch["valid"]
            R_new, t_new, s_new, _ = lc.correct_host_poses(
                pose_h, valid_h, fetch["rows"], kf_cur, cand, R21, t21, s21,
                neigh_extend=range(f["n0"], f["n1"]))
            # The pose graph starts from the correction, scale folded into SE3.
            init = pose_h.copy()
            init[:, :, :3] = R_new
            init[:, :, 3] = t_new / np.maximum(s_new, 1e-12)[:, None]
            prob, valid_ids = lc.build_graph_problem(init, valid_h, fetch["pairs"], cand)
            st = self._state
            P_old_cur = st.kf_pose[kf_cur]
            if prob is None:  # a tiny map: the neighbourhood correction alone
                R_opt, t_opt, s_opt = (torch.as_tensor(a, device=self.device)
                                       for a in (R_new, t_new, s_new))
            else:
                R_opt, t_opt, s_opt = lc.solve_graph(prob, valid_ids, st.kf_pose.shape[0])
            self._state = _loopfix_adopt(st, R_opt, t_opt, s_opt, f["n1"])
            # Fuse the duplicated landmarks around the closed loop on the
            # corrected geometry (global_optimization_module.cc:257-260).
            cand_mask = torch.zeros((self._state.kf_pose.shape[0],), dtype=torch.bool,
                                    device=self.device)
            cand_mask[cand] = True
            self._state, _ = mapper.fuse_into_keyframe(
                self.camera, self._state, kf_cur, ms.local_landmark_mask(self._state, cand_mask))
            # The tracker goes on from the corrected geometry.
            self.pose = _rebase_pose(*self.pose, P_old_cur, self._state.kf_pose[kf_cur])
            self._reset_velocity()
            self._ind_cache = None
            lc.loop_edges.append((kf_cur, cand, np.asarray(R21), np.asarray(t21), float(s21)))
            lc.last_loop_kf = kf_cur
            lc._continuity.clear()
            lc.num_loops_closed += 1
            if self.async_loop_ba:
                self._start_deferred_gba(anchor_kf=cand)
            else:
                pose_before = self._state.kf_pose
                self._state = global_ba.run_global_ba(self.camera, self._state,
                                                      self.frontend.inv_sigma_sq, anchor_kf=cand,
                                                      mesh=lc.mesh)
                ones = torch.ones((pose_before.shape[0],), dtype=torch.float32,
                                  device=self.device)
                self._state = pg.correct_map_structures(
                    self._state, pose_before[:, :, :3], pose_before[:, :, 3], ones,
                    self._state.kf_pose[:, :, :3], self._state.kf_pose[:, :, 3], ones,
                    lm_mask=torch.zeros_like(self._state.lm_valid))
                self._ind_cache = None
        self._pending_fix = None

    def _start_deferred_gba(self, anchor_kf: int):
        """Snapshot the map after the pose graph and start the host copies
        the observation enumeration needs; the solve advances one phase per
        fed frame (:meth:`_advance_deferred_gba`)."""
        st = self._state
        fetch = {"kf_valid": st.kf_valid, "kp_valid": st.kf_kp_valid, "lm_idx": st.kf_lm_idx,
                 "lm_valid": st.lm_valid, "xy": st.kf_xy, "xr": st.kf_xr, "level": st.kf_level}
        self._pending_gba = {
            "phase": "fetch", "anchor": int(anchor_kf),
            "fetch": {k: HostCopy(v) for k, v in fetch.items()},
            "snap_pose": st.kf_pose, "snap_lm": st.lm_pos,
            "snap_kf_valid": st.kf_valid, "snap_lm_valid": st.lm_valid,
            "snap_next_kf": self.next_kf, "K": st.kf_pose.shape[0], "L": st.lm_pos.shape[0],
        }

    def _advance_deferred_gba(self):
        """Advance the deferred global BA by one bounded step: read the
        copies; enumerate observations and pairs (numpy); one chunk of
        ``gba_iters_per_chunk`` iterations (on a mesh of several shards,
        the whole solve of ``gba_iters_per_chunk * gba_num_chunks``
        iterations at once, as the JAX System runs it); or merge into the
        map."""
        p = self._pending_gba
        if p is None:
            return
        st = self._state
        if st.kf_pose.shape[0] != p["K"] or st.lm_pos.shape[0] != p["L"]:
            _log.info("deferred global BA dropped (map capacity grew)")
            self._pending_gba = None
            return
        if p["phase"] == "fetch":
            # The copies only; the enumeration runs on the next frame, so
            # neither step alone holds up one frame for both.
            with self.timer.stage("gba.prepare"):
                p["host"] = {k: v.numpy() for k, v in p.pop("fetch").items()}
                p["phase"] = "enumerate"
            return
        if p["phase"] == "enumerate":
            with self.timer.stage("gba.prepare"):
                f = p.pop("host")
                mesh = self.loop_closer.mesh
                sharded = mesh is not None and mesh.n_shards > 1
                data = global_ba.prepare_from_arrays(
                    f["kf_valid"], f["kp_valid"], f["lm_idx"], f["lm_valid"], f["xy"], f["xr"],
                    f["level"], self.frontend.inv_sigma_sq.cpu().numpy(),
                    device="cpu" if sharded else self.device)
                if data.num_obs < global_ba.MIN_OBS:
                    self._pending_gba = None
                    return
                K = p["K"]
                p["data"] = data
                p["cam_fixed"] = torch.arange(K, device=self.device) == p["anchor"]
                p["carry"] = (p["snap_pose"], p["snap_lm"])
                p["aux"] = None
                if sharded:
                    p["aux"] = "mesh"
                elif K > loop_mod.DENSE_GRAPH_MAX_K:
                    c1, c2, raw_of_comp = global_ba.prepare_chain_pairs(data, f["kf_valid"])
                    c1, c2 = global_ba.pad_chain_pairs(c1, c2)
                    p["aux"] = tuple(torch.from_numpy(a).to(self.device)
                                     for a in (c1, c2, raw_of_comp))
                p["chunks_left"] = 1 if sharded else self.gba_num_chunks
                p["phase"] = "solve"
            return
        if p["phase"] == "solve":
            with self.timer.stage("gba.chunk"):
                cam_pose, lm_pos = p["carry"]
                args = (self.camera, cam_pose, p["snap_kf_valid"], p["cam_fixed"], lm_pos,
                        p["snap_lm_valid"], p["data"])
                if p["aux"] == "mesh":
                    shim = st._replace(kf_pose=cam_pose, lm_pos=lm_pos,
                                       kf_valid=p["snap_kf_valid"], lm_valid=p["snap_lm_valid"])
                    out = global_ba._run_global_ba_sharded(
                        self.camera, shim, p["data"], p["cam_fixed"], self.loop_closer.mesh,
                        self.gba_iters_per_chunk * self.gba_num_chunks)
                    p["carry"] = (out.kf_pose, out.lm_pos)
                elif p["aux"] is not None:
                    p["carry"] = global_ba.solve_pcg(*args, *p["aux"],
                                                     num_iters=self.gba_iters_per_chunk)
                else:
                    p["carry"] = global_ba.solve(*args, num_iters=self.gba_iters_per_chunk)
                p["chunks_left"] -= 1
                if p["chunks_left"] <= 0:
                    p["phase"] = "adopt"
            return
        with self.timer.stage("gba.adopt"):
            solved_pose, solved_lm = p["carry"]
            P_old_ref = st.kf_pose[self.ref_kf]
            self._state = _gba_adopt_step(st, solved_pose, solved_lm, p["snap_kf_valid"],
                                          p["snap_lm_valid"], p["snap_next_kf"])
            if self.with_lines:
                # Lines rode their reference keyframes' deltas through the
                # solve; a full-map multi-view polish refits them against
                # the merged poses (loop_bundle_adjuster.cc:110-145).
                self._state = line_ba.refine_lines(self.camera, self._state, num_iters=12)
            self.pose = _rebase_pose(*self.pose, P_old_ref, self._state.kf_pose[self.ref_kf])
            self._reset_velocity()
            self._ind_cache = None
            _log.info("deferred global BA merged (anchor=%d)", p["anchor"])
        self._pending_gba = None

    def _finish_deferred_gba(self):
        """Run a deferred global BA to its end now (drain points, a new
        loop correction, growth)."""
        while self._pending_gba is not None:
            self._advance_deferred_gba()

    def _reset_velocity(self):
        self.vel = (torch.eye(3, dtype=torch.float32, device=self.device),
                    torch.zeros((3,), dtype=torch.float32, device=self.device))

    # ------------------------------------------------------------------
    # Lifecycle (reference: system::startup/shutdown/reset).
    # ------------------------------------------------------------------
    def startup(self, need_initialize: bool = True):
        self._running = True
        if not need_initialize:
            self._tracking_state = TrackerState.LOST

    def shutdown(self):
        """Stop feeding and tear down the background surfaces (reference:
        system::shutdown joins its threads; here the viewer, publisher and
        snapshot writer threads)."""
        self._drain_pending()
        self._running = False
        self.stop_live_viewer()
        if self._native_pub is not None:
            self._native_pub.close()
            self._native_pub = None
        if self._autosave is not None:
            self._autosave.close()  # writes what was submitted first
            self._autosave = None

    def reset(self):
        # Pending decisions and loop work refer to the map being dropped.
        self._pending.clear()
        self._pending_loop = None  # (keyframe, (HostCopy of [K, 3], covisibility))
        self._pending_loop_age = 0
        self._pending_fix: Optional[dict] = None
        self._pending_gba: Optional[dict] = None
        self._dense_frames: dict = {}  # keyframe slot -> _dense_sample
        self._state = ms.create(self.max_keyframes, self.frontend.pad_to,
                                self.max_landmarks, device=self.device)
        self._tracking_state = TrackerState.NOT_INITIALIZED
        self.next_kf = 0
        self.next_lm = 0
        self.next_line = 0
        self.next_plane = 0
        self.frames_since_kf = 0
        eye = torch.eye(3, dtype=torch.float32, device=self.device)
        zero = torch.zeros((3,), dtype=torch.float32, device=self.device)
        self.pose = (eye, zero)
        self.vel = (eye, zero)
        self.last_kp_lm = torch.full((self.frontend.pad_to,), -1, dtype=torch.int64,
                                     device=self.device)
        self.ref_kf = 0
        self._ref_kf_dev = 0
        # (timestamp, reference keyframe, pose relative to it, lost) per frame.
        self._frame_stats: List[Tuple[float, int, np.ndarray, bool]] = []
        self._init_frame_count = self.num_frames
        self._ind_cache = None
        # The monocular init's first frame (kept until two views succeed).
        self._init_feats = None
        self._init_ts = None
        self._init_seg_mask = None
        self._cur_seg_mask = None

    # ------------------------------------------------------------------
    # Frame feeding (reference: system::feed_*_frame).
    # ------------------------------------------------------------------
    def feed_monocular_frame(self, img, timestamp: float, mask=None, seg_mask=None):
        """Track one monocular frame (see :meth:`feed_RGBD_frame`)."""
        key = self._frame_key()
        with self.timer.stage("frontend"):
            feats = self.frontend.mono(img, key, mask=mask)
        self._last_image = _keep_image(img)
        return self._track(feats, timestamp, seg_mask)

    def feed_stereo_frame(self, img_left, img_right, timestamp: float, mask=None,
                          seg_mask=None):
        """Track one rectified stereo pair (see :meth:`feed_RGBD_frame`);
        ``ops/rectify.StereoRectifier`` rectifies a raw pair first."""
        key = self._frame_key()
        with self.timer.stage("frontend"):
            feats = self.frontend.stereo(img_left, img_right, key, mask=mask)
        self._last_image = _keep_image(img_left)
        return self._track(feats, timestamp, seg_mask)

    def feed_RGBD_frame(self, img, depthmap, timestamp: float, mask=None,
                        seg_mask=None):
        """Track one RGB-D frame; returns the tracked world->camera pose
        ``[3, 4]`` (a device tensor), or None before initialization and,
        with ``track_lag=0``, for a lost frame. ``mask``: optional [H, W]
        extraction mask, 0 = ignore. ``seg_mask``: optional [H, W]
        instance-id image (0 = background; the reference's *_with_SegMask
        feeds), whose keyframes get plane landmarks."""
        key = self._frame_key()
        with self.timer.stage("frontend"):
            feats = self.frontend.rgbd(img, depthmap, key, mask=mask)
        self._last_image = _keep_image(img)
        dense = (_dense_sample(img, depthmap, self.dense_cloud_stride,
                               self.camera.depthmap_factor)
                 if self.store_dense_cloud else None)
        return self._track(feats, timestamp, seg_mask, dense)

    def _split_key(self):
        """The next key of the JAX System's sequence (``_split_key``)."""
        self.key, k = prng.split(self.key)
        return k

    def _frame_key(self):
        """With lines, a key for each fed frame's line detection, split as
        the JAX System splits it (the detector draws nothing from it), so
        the later draws stay in step; None without lines."""
        return self._split_key() if self.with_lines else None

    def _track(self, feats, ts: float, seg_mask=None, dense=None):
        if self._paused or self._terminate_requested or not self._running:
            # A paused tracker drops fed frames until resume_tracker()
            # (system.cc:482-528, the pause protocol).
            return None
        self._cur_seg_mask = (None if seg_mask is None else
                              torch.as_tensor(np.asarray(seg_mask), device=self.device)
                              .to(torch.int64))
        self.num_frames += 1
        if self._tracking_state is TrackerState.NOT_INITIALIZED:
            if not self._initialize(feats, ts):
                return None
            return self._record_frame(ts)
        # min_obs of the reliable-landmark count relaxes while the map is
        # young (keyframe_inserter.cc:66-67; see the JAX package).
        min_obs = 3 if self.next_kf >= 3 else 1
        Rv, tv = self.vel
        Rp, tp = self.pose
        carry = _TrackCarry(R=Rp, t=tp, Rv=Rv, tv=tv, last_kp_lm=self.last_kp_lm,
                            ref_kf=self._ref_kf_dev)
        params = self.frontend.extractor.params
        with self.timer.stage("track"):
            self._state, res, carry2, packed, seg_lines, kp_plane = _track_step(
                self.camera, self._state, feats, carry, self.frontend.inv_sigma_sq,
                self._obs_indicator(), min_obs, self.next_lm,
                num_levels=params.num_levels, scale_factor=params.scale_factor,
                with_lines=self.with_lines, timer=self.timer,
            )
        self.num_track_steps += 1
        self.pose = (carry2.R, carry2.t)
        self.vel = (carry2.Rv, carry2.tv)
        self.last_kp_lm = carry2.last_kp_lm
        self._ref_kf_dev = carry2.ref_kf
        self.frames_since_kf += 1

        # Defer the host-side decisions: the packed vector's copy to the
        # host starts now and is read ``track_lag`` frames later.
        entry = _PendingFrame(packed=HostCopy(packed), feats=feats, ts=ts, res=res,
                              frames_since_kf=self.frames_since_kf,
                              seg_mask=self._cur_seg_mask, seg_line_idx=seg_lines,
                              kp_plane=kp_plane, dense=dense)
        self._pending.append(entry)
        # One phase of a loop fix and one step of a deferred global BA in
        # flight ride along with each frame.
        self._advance_pending_fix()
        self._advance_deferred_gba()
        cur_ok = True
        while len(self._pending) > self.track_lag:
            oldest = self._pending.popleft()
            ok = self._consume(oldest)
            if oldest is entry:
                cur_ok = ok
        if not cur_ok:
            return None  # track_lag == 0 and this frame was lost
        return torch.cat([res.R, res.t[:, None]], 1)

    # ------------------------------------------------------------------
    def _consume(self, entry: _PendingFrame) -> bool:
        """Apply a fed frame's deferred host-side decisions: lost check and
        relocalization, capacity growth, keyframe decision + insertion,
        trajectory record (tracking_module.cc:651-657,
        keyframe_inserter.cc:54-114). Returns False if the frame was lost."""
        with self.timer.stage("decision_fetch"):
            vals = entry.packed.numpy()
        num_tracked = int(vals[_PK_NUM_TRACKED])
        ref_tracked = int(vals[_PK_REF_TRACKED])
        n_close_trk = int(vals[_PK_CLOSE_TRK])
        n_close_untrk = int(vals[_PK_CLOSE_UNTRK])
        ref_kf_host = int(vals[_PK_REF_KF])
        next_lm_host = int(vals[_PK_NEXT_LM])
        rel = vals[_PK_REL].reshape(3, 4).copy()
        ts = entry.ts

        # Reference acceptance: local-map tracking must keep >= 30 inliers;
        # below that the pose is unreliable: Lost, and relocalize.
        if num_tracked < 30:
            return self._lost(entry, ts, ref_kf_host, rel, num_tracked)
        self._tracking_state = TrackerState.TRACKING
        self.ref_kf = ref_kf_host
        self._publish(entry, num_tracked)

        # Capacity growth just before the walls (the reference's map grows
        # without bound; here capacities double).
        if self.enable_mapping and self.auto_grow:
            if self.next_kf >= self.max_keyframes - 1:
                self._grow(grow_kf=True)
            if next_lm_host >= self.max_landmarks - 2 * self.frontend.pad_to:
                self._grow(grow_lm=True)
            # Line and plane counters live on the device: read every 8
            # keyframes, as the JAX System does.
            if (self.with_lines or entry.seg_mask is not None) and self.next_kf % 8 == 7:
                n_ln, n_pl = int(self.next_line), int(self.next_plane)
                if self.with_lines and n_ln >= (self._state.ln_pluck.shape[0]
                                                - 2 * self.frontend.max_lines):
                    self._grow(grow_ln=True)
                if n_pl >= self._state.pl_coef.shape[0] - 8:
                    self._grow(grow_pl=True)

        # Keyframe decision (keyframe_inserter.cc:54-114): condition B
        # (enough matches, and the tracked share of the reference's
        # reliable landmarks dropped below 0.9 or close points demand
        # insertion) with A1/A2/A3, or the A1 interval force.
        if self.enable_mapping and self.next_kf < self.max_keyframes:
            lm_headroom = next_lm_host < self.max_landmarks - 2 * self.frontend.pad_to
            close_needed = (self.camera.setup is not CameraSetup.MONOCULAR
                            and n_close_trk < 100 and n_close_untrk > 70)
            cond_b = num_tracked >= 15 and (
                num_tracked < 0.9 * max(ref_tracked, 1) or close_needed
            )
            cond_a1 = self.frames_since_kf >= self.max_kf_interval
            cond_a2 = self.frames_since_kf >= self.min_kf_interval
            cond_a3 = num_tracked < 0.25 * max(ref_tracked, 1)
            need = (
                (cond_b and (cond_a1 or cond_a2 or cond_a3))
                or (cond_a1 and num_tracked >= 15)
            ) and lm_headroom
            if need:
                _log.info("keyframe %d at t=%.3f (tracked=%d ref_tracked=%d)",
                          self.next_kf, ts, num_tracked, ref_tracked)
                with self.timer.stage("keyframe"):
                    self._insert_keyframe(entry)

        self._frame_stats.append((ts, ref_kf_host, rel, False))
        return True

    def _lost(self, entry: _PendingFrame, ts, ref_kf_host, rel, num_tracked) -> bool:
        """A lost frame: relocalize against the map; on failure auto-reset
        a young map (tracking_module.cc:506-513: lost within ~5 s of init)
        or record the frame as lost."""
        self._tracking_state = TrackerState.LOST
        _log.info("tracking lost at t=%.3f (%d inliers); relocalizing", ts, num_tracked)
        params = self.frontend.extractor.params
        with self.timer.stage("relocalize"):
            out = self.relocalizer.relocalize(
                self._state, entry.feats, self.frontend.inv_sigma_sq, self._split_key(),
                obs_indicator=self._obs_indicator(), num_levels=params.num_levels,
                scale_factor=params.scale_factor,
            )
        if out is None:
            if (self.enable_mapping and self.next_kf <= 3
                    and self.num_frames - self._init_frame_count < 5.0 * self.camera.fps):
                _log.warning("lost on a young map; auto-reset")
                self.reset()
                return False
            self._frame_stats.append((ts, ref_kf_host, rel, True))
            return False
        R_r, t_r, kp_lm_r, ref = out
        self.num_relocalizations += 1
        _log.info("relocalized against keyframe %d", ref)
        self.pose = (R_r, t_r)
        self._reset_velocity()
        self.last_kp_lm = kp_lm_r
        self.ref_kf = ref
        self._ref_kf_dev = ref
        self._tracking_state = TrackerState.TRACKING
        # Frames fed after this one tracked from the pre-relocalization
        # pose; drop their pending decisions.
        while self._pending:
            e = self._pending.popleft()
            self._frame_stats.append((e.ts, ref, np.eye(3, 4, dtype=np.float32), True))
        self._record_frame(ts)
        return True

    def _grow(self, **kw):
        """Double the selected map capacities (slot ids stay). A loop fix or
        global BA in flight runs to its end first: its snapshots have the
        old shapes."""
        while self._pending_fix is not None:
            self._advance_pending_fix()
        self._finish_deferred_gba()
        _log.info("growing map capacities: %s", ", ".join(sorted(kw)))
        self._state = map_database.grow(self._state, **kw)
        self.max_keyframes = self._state.kf_pose.shape[0]
        self.max_landmarks = self._state.lm_pos.shape[0]
        self._ind_cache = None

    # ------------------------------------------------------------------
    def _initialize(self, feats, ts: float) -> bool:
        """Stereo and RGB-D start from depth: the first frame with >= 30
        depth seeds becomes keyframe 0 at the origin. A monocular map starts
        from two views (:meth:`_initialize_mono`)."""
        if self.camera.setup is CameraSetup.MONOCULAR:
            return self._initialize_mono(feats, ts)
        dev = self.device
        pose = torch.cat([torch.eye(3, device=dev), torch.zeros((3, 1), device=dev)], 1)
        self._state, created = mapper.insert_keyframe(
            self.camera, self._state, 0, pose, ts, feats,
            torch.full((self.frontend.pad_to,), -1, dtype=torch.int64, device=dev), 0,
        )
        n = int(created)
        if n < 30:
            self._state = _clear_failed_init(self._state)
            return False
        self.next_kf = 1
        self.next_lm = n
        self.last_kp_lm = self._state.kf_lm_idx[0]
        self.ref_kf = 0
        self._ref_kf_dev = 0
        eye = torch.eye(3, dtype=torch.float32, device=dev)
        zero = torch.zeros((3,), dtype=torch.float32, device=dev)
        self.pose = (eye, zero)
        self.vel = (eye, zero)
        self._tracking_state = TrackerState.TRACKING
        self.frames_since_kf = 0
        self._init_frame_count = self.num_frames
        # Initial lines (from the depth map) and planes on keyframe 0
        # (initializer.cc:322-333, initialize_map_with_plane).
        self._init_structures(0, self._cur_seg_mask, feats)
        self._ind_cache = None
        return True

    def _initialize_mono(self, feats, ts: float) -> bool:
        """Two-view initialization (initializer.cc): keep a first frame with
        >= 100 keypoints, try each later frame against it; on success both
        become keyframes, the triangulated points landmarks at median
        depth 1, and a two-view BA refines them."""
        if self._init_feats is None:
            if int(feats["valid"].sum()) >= 100:
                self._init_feats, self._init_ts = feats, ts
                self._init_seg_mask = self._cur_seg_mask
            return False
        res = initializer.try_initialize_mono(
            self.camera, self._init_feats, feats, self._split_key(),
            coherent=self.init_graph_cut,
        )
        if not bool(res.success):
            # Keep the first frame while it still matches well (the failure
            # is then low parallax, which more baseline fixes); restart from
            # this frame only when the matches ran out.
            if int(res.num_matches) < 50 and int(feats["valid"].sum()) >= 100:
                self._init_feats, self._init_ts = feats, ts
                self._init_seg_mask = self._cur_seg_mask
            return False

        pts, t2, _ = initializer.scale_to_median_depth(
            res.points_w, res.point_ok, res.t_2w,
            use_dist=self.camera.model is CameraModel.EQUIRECTANGULAR)
        f1 = self._init_feats
        dev = self.device
        N = self.frontend.pad_to
        count = int(res.point_ok.sum())
        slots = torch.cumsum(res.point_ok.to(torch.int64), 0) - 1  # compact ids
        lm1 = torch.where(res.point_ok, slots, -1)
        lm2 = torch.full((N,), -1, dtype=torch.int64, device=dev)
        lm2[torch.clamp(res.matches, 0, N - 1)[res.point_ok]] = slots[res.point_ok]
        eye = torch.eye(3, dtype=torch.float32, device=dev)
        pose1 = torch.cat([eye, torch.zeros((3, 1), dtype=torch.float32, device=dev)], 1)
        pose2 = torch.cat([res.R_2w, t2[:, None]], 1)
        st = ms.add_keyframe(self._state, 0, pose1, self._init_ts, f1, lm1)
        st = ms.add_keyframe(st, 1, pose2, ts, feats, lm2)

        dist = torch.linalg.norm(pts, dim=-1)
        params = self.frontend.extractor.params
        sf, nlv = params.scale_factor, params.num_levels
        dist_max = dist * torch.pow(sf, f1["level"].to(torch.float32))
        dist_min = dist_max / (sf ** (nlv - 1))
        view = pts / torch.clamp(dist[:, None], min=1e-9)
        st = ms.add_landmarks(st, slots, pts, f1["desc"], view, dist_min, dist_max,
                              torch.zeros((N,), dtype=torch.int64, device=dev), res.point_ok)
        self.next_kf = 2
        self.next_lm = count
        # The two-view BA (initializer.cc:306-307 runs global BA); on the CPU
        # as XLA:CPU computes the JAX package's init BA.
        self._state, _ = mapper.local_ba(self.camera, st, 1, self.frontend.inv_sigma_sq,
                                         max_opt=4, max_fix=4, max_lms=4096, _xla="init")
        self.pose = (res.R_2w, t2)
        self.vel = (eye, torch.zeros((3,), dtype=torch.float32, device=dev))
        self.last_kp_lm = self._state.kf_lm_idx[1]
        self.ref_kf = 1
        self._ref_kf_dev = 1
        self._tracking_state = TrackerState.TRACKING
        self.frames_since_kf = 0
        # Initial lines (from the fresh point map) and planes on both init
        # keyframes (initializer.cc:299-302, :322-333).
        self._init_structures(0, self._init_seg_mask, f1)
        self._init_structures(1, self._cur_seg_mask, feats)
        self._init_feats = None
        self._init_seg_mask = None
        self._init_frame_count = self.num_frames
        self._ind_cache = None
        return True

    def _init_structures(self, slot: int, seg_mask, feats):
        """Initial line and plane landmarks on an init keyframe: lines from
        the depth map (stereo, RGB-D) and from the point map; planes from
        ``seg_mask``, with relaxed gates on two-view monocular clouds, whose
        triangulation noise is an order above a depth sensor's
        (``planar_mapper.detect_planes``)."""
        st = self._state
        if self.with_lines and "seg" in feats:
            next_line = self.next_line
            if self.camera.setup is not CameraSetup.MONOCULAR:
                st, n = line_mapper.lines_from_depth(self.camera, st, slot, next_line)
                next_line = next_line + n
            st, n = line_mapper.lines_from_points(self.camera, st, slot, next_line)
            self.next_line = next_line + n
        if seg_mask is not None:
            labels = planar_mapper.label_keypoints(seg_mask, feats["xy"], feats["valid"],
                                                   check_3x3=self.planar.check_3x3_window)
            scale = mapper.map_scale(st, slot)
            mono = self.camera.setup is CameraSetup.MONOCULAR
            st, n_pl = planar_mapper.detect_planes(
                st, slot, labels, self.next_plane, self._split_key(), scale,
                max_instances=self.planar.max_instances, coherent=self.use_graph_cut,
                params=self.planar, thr_mult=5.0 if mono else 1.0,
                ratio_override=0.45 if mono else None,
            )
            self.next_plane = self.next_plane + n_pl
        self._state = st

    # ------------------------------------------------------------------
    def _insert_keyframe(self, entry: _PendingFrame):
        """Run the keyframe chain on the frame and publish its results. The
        previous keyframe's loop detection is gated first; this chain
        scores the new keyframe for the next one (no new detection while
        one is pending)."""
        if self.enable_loop_closing and self._pending_loop is not None:
            self._consume_pending_loop()
        res = entry.res
        slot = self.next_kf
        pose = torch.cat([res.R, res.t[:, None]], 1)
        params = self.frontend.extractor.params
        lc = self.loop_closer
        do_detect = (self.enable_loop_closing and self.next_kf + 1 >= 8
                     and slot - lc.last_loop_kf >= lc.min_gap
                     and self._pending_loop is None)
        key = self._split_key()  # the chain's plane RANSAC draws
        with self.timer.stage("keyframe.chain"):
            st, next_lm, next_line, next_plane, ind, packed, cov = _kf_chain(
                self.camera, self._state, slot, pose, entry.ts, entry.feats, res.kp_lm,
                self.next_lm, self.frontend.inv_sigma_sq, self._obs_indicator(), lc.bow,
                do_ba=self.next_kf + 1 >= 3,
                do_cull_kf=self.next_kf + 1 >= 5,
                stats_full=slot % 2 == 0,
                do_detect=do_detect,
                num_tri_neighbors=self.num_tri_neighbors,
                scale_factor=params.scale_factor,
                num_levels=params.num_levels,
                timer=self.timer,
                with_lines=self.with_lines,
                seg_line_idx=entry.seg_line_idx,
                two_view_lines=(self.camera.setup is not CameraSetup.MONOCULAR
                                and self.next_kf + 1 >= 2),
                next_line=self.next_line,
                seg_mask=entry.seg_mask, planar=self.planar,
                use_graph_cut=self.use_graph_cut, key=key, next_plane=self.next_plane,
            )
        self.next_kf += 1
        self.frames_since_kf = 0
        if entry.dense is not None:
            self._dense_frames[slot] = entry.dense
        self._state = st
        self.next_lm = next_lm
        self.next_line = next_line
        self.next_plane = next_plane
        self.last_kp_lm = st.kf_lm_idx[slot]
        self.ref_kf = slot
        self._ref_kf_dev = slot
        # The chain returns the post-chain indicator: seed the cache.
        self._ind_cache = ind
        # Stream the new map to attached viewers; maybe checkpoint (two
        # stages, so checkpoint I/O is not counted as publishing).
        with self.timer.stage("kf.publish"):
            self._publish_map_packet()
        with self.timer.stage("kf.autosave"):
            self._maybe_autosave()
        if do_detect:  # gated at the next keyframe, once the copy has landed
            self._pending_loop = (slot, (HostCopy(packed), cov))
            self._pending_loop_age = 0

    # ------------------------------------------------------------------
    def _obs_indicator(self):
        """Cached observation indicator [K, L]; rebuilt after the map's
        associations change."""
        if self._ind_cache is None:
            self._ind_cache = ms.observation_indicator(self._state)
        return self._ind_cache

    def _record_frame(self, ts: float) -> np.ndarray:
        R, t = self.pose
        kf_pose = self._state.kf_pose[self.ref_kf]
        R_rel = linalg.matmul(R, kf_pose[:, :3].T)
        t_rel = t - linalg.matvec(R_rel, kf_pose[:, 3])
        both = torch.stack([torch.cat([R, t[:, None]], 1),
                            torch.cat([R_rel, t_rel[:, None]], 1)]).cpu().numpy()
        self._frame_stats.append((ts, self.ref_kf, both[1], False))
        return both[0]

    # ------------------------------------------------------------------
    # Output (reference: io/trajectory_io).
    # ------------------------------------------------------------------
    def frame_trajectory(self):
        """Frame poses recomposed against the current keyframe poses."""
        self._drain_pending()
        kf_poses = self._state.kf_pose.cpu().numpy()
        out = []
        for ts, ref, rel, lost in self._frame_stats:
            if lost:
                continue
            Pk = kf_poses[ref]
            R = rel[:, :3] @ Pk[:, :3]
            t = rel[:, :3] @ Pk[:, 3] + rel[:, 3]
            out.append((ts, np.concatenate([R, t[:, None]], 1)))
        return out

    def keyframe_trajectory(self):
        self._drain_pending()
        kf_poses = self._state.kf_pose.cpu().numpy()
        kf_valid = self._state.kf_valid.cpu().numpy()
        kf_ts = self._state.kf_timestamp.cpu().numpy()
        return [(float(kf_ts[k]), kf_poses[k]) for k in np.argsort(kf_ts) if kf_valid[k]]

    def save_frame_trajectory(self, path: str, fmt: str = "tum"):
        saver = traj_io.save_tum if fmt == "tum" else traj_io.save_kitti
        saver(path, self.frame_trajectory())

    def save_keyframe_trajectory(self, path: str, fmt: str = "tum"):
        saver = traj_io.save_tum if fmt == "tum" else traj_io.save_kitti
        saver(path, self.keyframe_trajectory())

    @property
    def num_keyframes(self) -> int:
        self._drain_pending()
        return int(self._state.kf_valid.sum())

    @property
    def num_landmarks(self) -> int:
        self._drain_pending()
        return int(self._state.lm_valid.sum())

    def get_landmarks(self) -> np.ndarray:
        """World positions ``[M, 3]`` of the valid point landmarks."""
        self._drain_pending()
        return self._state.lm_pos[self._state.lm_valid].cpu().numpy()

    # ------------------------------------------------------------------
    # Map persistence (reference: system.h:91-100, save/load map database)
    # and autosave.
    # ------------------------------------------------------------------
    def _snapshot_kw(self) -> dict:
        return dict(next_kf=int(self.next_kf), next_lm=int(self.next_lm),
                    next_line=int(self.next_line), next_plane=int(self.next_plane),
                    camera_name=self.camera.name, camera=self.camera)

    def save_map_database(self, path: str):
        """Write the map as a msgpack snapshot that either package loads
        (``io/map_io.py``)."""
        self._drain_pending()
        from structure_plp_slam_tpu_torch.io import map_io

        map_io.save_map(path, self._state, **self._snapshot_kw())

    def load_map_database(self, path: str):
        """Load a snapshot (either package's); tracking starts Lost and
        relocalizes against the loaded map (reference:
        run_image_localization.cc:66-76). The retrieval index needs no
        rebuild: scoring reads the loaded map's own descriptors."""
        from structure_plp_slam_tpu_torch.io import map_io

        # Pending decisions, loop work and the dense images belong to the
        # map being replaced.
        self._drain_pending()
        state, counters = map_io.load_map_with_counters(path, self.device)
        n_kp = state.kf_desc.shape[1]
        if n_kp != self.frontend.pad_to:
            raise ValueError(
                f"map {path} holds {n_kp} keypoint slots per keyframe; this System's frontend "
                f"pads frames to {self.frontend.pad_to} (ORB max_num_keypts and num_levels "
                f"of the config that built the map must match)")
        self._state = state
        self.next_kf = counters["next_kf"]
        self.next_lm = counters["next_lm"]
        self.next_line = counters["next_line"]
        self.next_plane = counters["next_plane"]
        self.max_keyframes = state.kf_pose.shape[0]
        self.max_landmarks = state.lm_pos.shape[0]
        self._dense_frames = {}
        self._tracking_state = TrackerState.LOST
        self._ind_cache = None

    def enable_autosave(self, path: str, every_n_keyframes: int = 10):
        """Periodic map checkpoints through the native double-buffered
        writer (``native.AsyncSnapshotWriter``), every
        ``every_n_keyframes`` keyframes: the file write runs on the
        writer's thread; the copy of the map to the host and its packing
        run in the keyframe (stage ``kf.autosave``)."""
        from structure_plp_slam_tpu_torch import native

        if self._autosave is not None:
            self._autosave.close()
        self._autosave = native.AsyncSnapshotWriter(path)
        self._autosave_every = int(every_n_keyframes)

    def _maybe_autosave(self):
        if self._autosave is None or self.next_kf % self._autosave_every != 0:
            return
        from structure_plp_slam_tpu_torch.io import map_io

        map_io.save_map_async(self._autosave, self._state, **self._snapshot_kw())

    # ------------------------------------------------------------------
    # Publishers and viewers (reference: system.h:103-106, the socket
    # publisher and its web viewer).
    # ------------------------------------------------------------------
    def get_frame_publisher(self) -> FramePublisher:
        return self.frame_publisher

    def get_map_publisher(self) -> MapPublisher:
        return self.map_publisher

    def _publish(self, entry: _PendingFrame, num_tracked: int):
        """Hand a consumed frame to the publishers: references only, no copy
        to the host (viewers copy what they read when they poll). The
        image is the newest fed one, as the JAX System pairs them."""
        feats = entry.feats
        self.frame_publisher.update(
            image=(self._last_image if self._last_image is not None
                   else np.zeros((self.camera.rows, self.camera.cols), np.uint8)),
            kp_xy=feats["xy"], kp_valid=feats["valid"], kp_has_landmark=entry.res.kp_lm >= 0,
            kp_plane=entry.kp_plane, segments=feats.get("seg"),
            seg_valid=feats.get("seg_valid"), state=self._tracking_state.value,
            num_tracked=num_tracked, timestamp=entry.ts,
        )
        self.map_publisher.set_current_cam_pose(self.pose)

    def start_live_viewer(self, port: int = 0, max_points: int = 20000,
                          host: str = "127.0.0.1") -> int:
        """Start the live HTTP map viewer (reference: socket_publisher +
        node.js web viewer). Returns the bound port; open
        ``http://localhost:<port>``. Serves loopback only unless ``host``
        says otherwise."""
        from structure_plp_slam_tpu_torch.publish.live_server import LiveViewerServer

        self.stop_live_viewer()  # a second start replaces the first server
        self._live_viewer = LiveViewerServer(self.map_publisher, port=port,
                                             max_points=max_points, host=host)
        return self._live_viewer.port

    def stop_live_viewer(self):
        if self._live_viewer is not None:
            self._live_viewer.stop()
            self._live_viewer = None

    def start_native_publisher(self, port: int = 0) -> int:
        """Start the native TCP map publisher (reference: socket_publisher
        streaming to the web viewer); each keyframe then sends connected
        clients one length-prefixed msgpack packet (landmarks, keyframe
        poses, the current pose). Returns the bound port."""
        from structure_plp_slam_tpu_torch import native

        if self._native_pub is not None:
            self._native_pub.close()
        self._native_pub = native.NativePublisher(port)
        return self._native_pub.port

    def _publish_map_packet(self):
        pub = self._native_pub
        if pub is None or pub.num_clients == 0:
            return
        import msgpack

        st = self._state
        valid = to_host(st.lm_valid)
        pts = to_host(st.lm_pos)[valid].astype(np.float32)
        kf_valid = to_host(st.kf_valid)
        kfs = to_host(st.kf_pose)[kf_valid].astype(np.float32)
        R, t = self.pose
        pose = to_host(torch.cat([R, t[:, None]], 1)).astype(np.float32)
        pub.publish(msgpack.packb({
            "landmarks": pts.tobytes(),
            "num_landmarks": int(len(pts)),
            "keyframes": kfs.tobytes(),
            "num_keyframes": int(len(kfs)),
            "current_pose": pose.tobytes(),
        }, use_bin_type=True))

    # ------------------------------------------------------------------
    # Pause / terminate protocol (reference: system.h:112-192). Mapping and
    # loop closing run inside the feeds, not on threads of their own, so
    # pausing the tracker pauses everything.
    # ------------------------------------------------------------------
    def pause_tracker(self):
        self._drain_pending()
        self._paused = True

    def resume_tracker(self):
        self._paused = False

    def tracker_is_paused(self) -> bool:
        return self._paused

    def request_terminate(self):
        self._drain_pending()
        self._terminate_requested = True

    def terminate_is_requested(self) -> bool:
        return self._terminate_requested

    def disable_mapping_module(self):
        self.enable_mapping = False

    def enable_mapping_module(self):
        self.enable_mapping = True

    def disable_loop_detector(self):
        self.enable_loop_closing = False

    def enable_loop_detector(self):
        self.enable_loop_closing = True

    def metrics(self) -> dict:
        self._drain_pending()
        return {
            "frames": self.num_frames,
            "keyframes": self.num_keyframes,
            "landmarks": self.num_landmarks,
            "lines": int(self._state.ln_valid.sum()),
            "planes": int(self._state.pl_valid.sum()),
            "loops_closed": self.loop_closer.num_loops_closed,
            "relocalizations": self.num_relocalizations,
            "tracking_state": self._tracking_state.value,
            "timing": self.timer.summary(),
        }
