"""The local BA iteration on the CPU, as XLA:CPU computes the JAX package's
(``csrc/ba_solve_cpu.c``), in the two programs that run it: the two-view init
(``"init"``) and the keyframe chain (``"chain"``) of the monocular, RGB-D and
stereo Systems.

XLA:CPU compiles the JAX System's init BA (the jitted ``mapper.local_ba``
over the two init keyframes: C = 8 window cameras) and the keyframe chain's
(``system.py``'s jitted ``_kf_chain``: C = 2 min(16, max_keyframes), 32 or,
at 8 keyframes, 16), each over M = min(4096, max_landmarks) landmarks and
the observations as a dense [C, Ng] grid, into kernels whose fused
multiply-adds and summation orders follow each kernel; the C source repeats
one Gauss-Newton iteration of that compile operation for operation (``python
-m tests.xla_init_ba`` and ``python -m tests.xla_chain_ba`` dump the programs
and measure the Schur product's blocks). Both programs compile the iteration
into the same kernels, and the monocular, RGB-D and stereo chains compile into
the same ones too (the camera's ``focal_x_baseline`` is a constant of the
compile; ``python -m tests.xla_chain_ba --dump DIR --setup rgbd`` lists them);
where the vectorizer lays a kernel out by its shapes, the layout is a table
keyed by the shape (``_SCHUR_BLOCKS``, ``_GRID_BLOCKS``, ``_UPDATE_LAYOUT``).
``models/bundle_adjustment.ba_solve`` keeps the solver's loop and policy and
calls, per iteration, :func:`normal_equations`, the camera solve
(``ops/linalg``: XLA's LAPACK routines) and :func:`update`; its cull and its
final inlier test take :func:`obs_chi2`.

The source is built with the host C compiler at first use into
``build/kernels/`` and loaded with ctypes (``utils/host_c``); it builds on
x86-64 only (XLA:CPU's reciprocal root is the SSE ``rsqrtss`` instruction).
It serves f32 CPU tensors of pinhole-projecting cameras (perspective,
fisheye), monocular and stereo observations (an RGB-D keypoint with depth has
a stereo row, ``obs_xr >= 0``), and no line landmarks.
"""

from __future__ import annotations

import contextlib
import ctypes
import logging
import threading

import torch

from structure_plp_slam_tpu_torch.camera import CameraModel
from structure_plp_slam_tpu_torch.ops import linalg
from structure_plp_slam_tpu_torch.utils import host_c

_log = logging.getLogger(__name__)

SOURCE = host_c.CSRC / "ba_solve_cpu.c"

# The Schur product's layout over its contraction index K = k M + m, by (6C,
# 3M): XLA:CPU's dot sums K in consecutive blocks of the first length (the
# last one shorter), each block in the second number of interleaved lanes,
# each lane one chain, the lanes and then the blocks added in order. Measured
# with jax / jaxlib 0.9.0 on an x86-64 Xeon with AVX-512 (tests/xla_init_ba.py,
# tests/xla_chain_ba.py; tests/test_torch_init_ba_xla.py,
# test_torch_chain_ba_xla.py and test_torch_chain_ba_xla_c16.py hold the
# entries against XLA's dot). C = 8, 16 and 32 window cameras at M = 4096 and
# the growth maps' M = 2048.
_SCHUR_BLOCKS = {(48, 12288): (682, 1), (96, 12288): (1024, 2), (192, 12288): (512, 1),
                 (48, 6144): (682, 1), (96, 6144): (1024, 2), (192, 6144): (512, 1)}
# The update's layout by 6C, as XLA:CPU's vectorizer lays its kernels out:
# the back-substitution W^T dx_c ([3M, 6C] x [6C]) in accumulators of 8 lanes
# through the groups of 8 camera entries in an order (None for in order), and
# how many leading cameras the camera step's squared norms (the clamp's two,
# the rotation angle's) sum as rounded squares in a vector loop, the rest as
# fused chains. At 48 (the init): one accumulator through the groups 0, 2, 4,
# 3, 1, 5, every norm fused; at 96 (the chain of a System with 8 keyframes):
# one accumulator through the groups 0, 4, 8, 5, 1, 9, 6, 2, 10, 7, 3, 11,
# cameras 0-7 rounded; at 192 (the chain): four accumulators, group g into g
# % 4, cameras 0-23 rounded (the dumped bitcast_dot_fusion,
# maximum_rsqrt_fusion and multiply_reduce_fusion kernels;
# tests/xla_chain_ba.py lists them, tests/test_torch_chain_ba_xla.py and
# test_torch_chain_ba_xla_c16.py hold them against XLA's).
_UPDATE_LAYOUT = {48: (1, (0, 2, 4, 3, 1, 5), 0),
                  96: (1, (0, 4, 8, 5, 1, 9, 6, 2, 10, 7, 3, 11), 8),
                  192: (4, None, 24)}
# The grid contraction's run length by (C, Ng, M): XLA:CPU's library dot of
# the one-hot grid ([C, Ng, M] against [C, Ng, 30]) sums each camera row in
# two runs, each one chain, the runs added in order; it decides where a
# landmark sits three times in one keyframe row (tests/xla_chain_ba.py
# probes it). C = 8, 16 and 32 cameras, 640 and 616 slots a row, M = 4096 and
# 2048 landmarks.
_GRID_BLOCKS = {(C, Ng, M): {640: 320, 616: 312}[Ng] for C in (8, 16, 32) for Ng in (640, 616)
                for M in (4096, 2048)}
# The programs whose BA iteration the C source computes (ba_solve's _xla).
PROGRAMS = ("init", "chain")
_UNMEASURED: set = set()
# Floats per observation in the trace (csrc/ba_solve_cpu.c OBS_TRACE).
_OBS_TRACE = 107

_lib = None
_lib_lock = threading.Lock()


def schur_block(D: int, K: int) -> tuple:
    """The Schur product's ``(block length, lanes)`` for a [D, K] x [K, D]
    product (``_SCHUR_BLOCKS``; one chain for a shape outside the table, with
    one warning)."""
    block = _SCHUR_BLOCKS.get((D, K))
    if block is None:
        block = (K, 1)
        if (D, K) not in _UNMEASURED:
            _UNMEASURED.add((D, K))
            _log.warning(
                "the BA's Schur product [%d, %d] x [%d, %d] has no measured XLA:CPU "
                "summation order; summing it in one chain, so the solve may differ from "
                "the JAX package's in the last place (add the shape to tests/xla_chain_ba.py "
                "and extend _SCHUR_BLOCKS)", D, K, K, D)
    return block


def grid_block(C: int, Ng: int, M: int) -> int:
    """The grid contraction's run length over a camera row of ``Ng`` slots
    (``_GRID_BLOCKS``; the whole row outside the table, with one warning)."""
    block = _GRID_BLOCKS.get((C, Ng, M))
    if block is None:
        block = Ng
        if (C, Ng, M) not in _UNMEASURED:
            _UNMEASURED.add((C, Ng, M))
            _log.warning(
                "the BA's grid contraction over [%d, %d, %d] has no measured XLA:CPU "
                "summation order; summing each camera row in one run, so a landmark seen "
                "three times in one keyframe may differ from the JAX package's in the last "
                "place (probe it with tests/xla_chain_ba.py and extend _GRID_BLOCKS)",
                C, Ng, M)
    return block


def update_layout(D: int) -> tuple:
    """The update's layout for 6C = ``D``: W^T dx_c's accumulators and group
    order, and the cameras whose step norms sum rounded squares
    (``_UPDATE_LAYOUT``; one accumulator in order and every norm fused outside
    the table, with one warning)."""
    layout = _UPDATE_LAYOUT.get(D)
    if layout is None:
        layout = (1, None, 0)
        if D not in _UNMEASURED:
            _UNMEASURED.add(D)
            _log.warning(
                "the BA's update over 6C = %d camera entries has no measured XLA:CPU "
                "layout; summing its back-substitution in 8 lanes in order and its step norms "
                "fused, so the solve may differ from the JAX package's in the last place (read "
                "it from the dumped kernels, tests/xla_chain_ba.py --dump, and extend "
                "_UPDATE_LAYOUT)", D)
    return layout


@contextlib.contextmanager
def unmeasured_shapes():
    """Record the shapes met outside the tables within the block: yields a
    set, filled on exit. The warnings fire once a shape per process, so the
    block starts from an empty record (``_UNMEASURED``) and puts the earlier
    one back after."""
    met: set = set()
    saved = set(_UNMEASURED)
    _UNMEASURED.clear()
    try:
        yield met
    finally:
        met |= _UNMEASURED
        _UNMEASURED.update(saved)


def _load():
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = host_c.load(SOURCE)
            lib.ba_normal_cpu.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p] * 9 + [
                ctypes.c_int] * 3 + [ctypes.c_void_p] * 8
            lib.ba_normal_cpu.restype = ctypes.c_int
            lib.ba_update_cpu.argtypes = [ctypes.c_int] * 2 + [ctypes.c_void_p] * 9 + [
                ctypes.c_int, ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 3
            lib.ba_update_cpu.restype = ctypes.c_int
            lib.ba_chi2_cpu.argtypes = [ctypes.c_int] * 2 + [ctypes.c_void_p] * 8
            lib.ba_chi2_cpu.restype = None
            lib.ba_orthonormalize_cpu.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 2
            lib.ba_orthonormalize_cpu.restype = None
            lib.ba_schur_cpu.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p] * 4
            lib.ba_schur_cpu.restype = ctypes.c_int
            _lib = lib
    return _lib


def _c(x, dtype=torch.float32):
    return x.detach().to(dtype).contiguous()


def serves(camera, prob, lines) -> bool:
    """Whether the C source computes this solve: f32 CPU tensors, a
    pinhole-projecting camera (perspective, fisheye) and no line landmarks.
    ``models/bundle_adjustment.ba_solve`` runs its PyTorch iteration
    otherwise."""
    return (prob.cam_pose.device.type == "cpu" and prob.cam_pose.dtype == torch.float32
            and lines is None and camera.model in (CameraModel.PERSPECTIVE, CameraModel.FISHEYE))


def check(prob) -> None:
    """Raise unless the observations of a problem that :func:`serves` takes
    are what the programs' compile solves: a dense [C, Ng] grid
    (``obs_cam[o] == o // Ng``), monocular and stereo rows alike."""
    C, O = prob.cam_pose.shape[0], prob.obs_cam.shape[0]
    grid = torch.arange(C)[:, None].expand(C, O // C).reshape(-1)
    if O % C or not torch.equal(prob.obs_cam, grid):
        raise ValueError("the XLA:CPU BA iteration needs the observations as a [C, O/C] grid")


def _camf(camera, policy):
    return torch.tensor([camera.fx, camera.fy, camera.cx, camera.cy, camera.focal_x_baseline,
                         *policy], dtype=torch.float32)


def normal_equations(camera, prob, cam_pose, lm_pos, obs_live, free, *, policy: tuple,
                     trace: bool = False):
    """The iteration's camera system and what its back-substitution needs:
    ``(S [6C, 6C], rhs [6C], Hll_inv [M, 3, 3], W [M, C, 6, 3], bl [M, 3])``;
    ``policy`` is ``models/bundle_adjustment._ba_policy``. With ``trace``
    also a dict of the per-observation values (``pc``, ``r_uv``, ``chi2``,
    ``w``, ``Jc2``, ``Jl2``, ``Hcc_o``, ``Hll_o``, ``Hcl_o``, ``bc_o``,
    ``bl_o``, ``r_xr``, ``Jc3``, ``Jl3``), ``Hll``, ``WHinv``, ``Hcc``, ``bc``
    and the Schur product ``S_red [6C, 6C]``."""
    C, M = cam_pose.shape[0], lm_pos.shape[0]
    O = prob.obs_lm.shape[0]
    D = 6 * C
    f32 = torch.float32
    S = torch.empty((D, D), dtype=f32)
    rhs = torch.empty((D,), dtype=f32)
    Hinv = torch.empty((M, 3, 3), dtype=f32)
    W = torch.empty((M, C, 6, 3), dtype=f32)
    bl = torch.empty((M, 3), dtype=f32)
    obs_tr = torch.empty((O, _OBS_TRACE), dtype=f32) if trace else None
    lm_tr = torch.empty((M * 9 + M * C * 18,), dtype=f32) if trace else None
    cam_tr = torch.empty((C * 42 + D * D,), dtype=f32) if trace else None
    ins = [_camf(camera, policy), _c(cam_pose), _c(lm_pos), _c(prob.obs_lm, torch.int64),
           _c(prob.obs_uv), _c(prob.obs_xr), _c(prob.obs_inv_sigma_sq),
           _c(obs_live, torch.uint8), _c(free, torch.uint8)]
    p = host_c.ptr
    rc = _load().ba_normal_cpu(C, M, O // C, *(p(x) for x in ins), *schur_block(D, 3 * M),
                               grid_block(C, O // C, M), p(S), p(rhs), p(Hinv), p(W), p(bl),
                               p(obs_tr), p(lm_tr), p(cam_tr))
    if rc != 0:
        raise RuntimeError(f"ba_normal_cpu returned {rc}")
    out = (S, rhs, Hinv, W, bl)
    if not trace:
        return out
    cols = dict(pc=(0, 3), r_uv=(3, 5), chi2=(5, 6), w=(6, 7), Jc2=(7, 19), Jl2=(19, 25),
                Hcc_o=(25, 61), Hll_o=(61, 70), Hcl_o=(70, 88), bc_o=(88, 94), bl_o=(94, 97),
                r_xr=(97, 98), Jc3=(98, 104), Jl3=(104, 107))
    shapes = dict(Jc2=(2, 6), Jl2=(2, 3), Hcc_o=(6, 6), Hll_o=(3, 3), Hcl_o=(6, 3))
    steps = {}
    for k, (a, b) in cols.items():
        v = obs_tr[:, a:b]
        steps[k] = v[:, 0] if b - a == 1 else v.reshape(O, *shapes.get(k, (b - a,)))
    steps["Hll"] = lm_tr[:M * 9].reshape(M, 3, 3)
    steps["WHinv"] = lm_tr[M * 9:].reshape(M, C, 6, 3)
    steps["Hcc"] = cam_tr[:C * 36].reshape(C, 6, 6)
    steps["bc"] = cam_tr[C * 36:C * 42].reshape(C, 6)
    steps["S_red"] = cam_tr[C * 42:].reshape(D, D)
    return out, steps


def update(camera, dx_c, Hinv, W, bl, cam_pose, lm_pos, free, lm_valid, *, policy: tuple,
           trace: bool = False):
    """The back-substitution and the update: ``(cam_pose [C, 3, 4], lm_pos
    [M, 3])`` after the step ``dx_c [C * 6]`` (and with ``trace`` the clipped
    landmark step ``dx_l [M, 3]``)."""
    C, M = cam_pose.shape[0], lm_pos.shape[0]
    Pn = torch.empty((C, 3, 4), dtype=torch.float32)
    Xn = torch.empty((M, 3), dtype=torch.float32)
    dxl = torch.empty((M, 3), dtype=torch.float32) if trace else None
    ins = [_camf(camera, policy), _c(dx_c.reshape(-1)), _c(Hinv), _c(W), _c(bl), _c(cam_pose),
           _c(lm_pos), _c(free, torch.uint8), _c(lm_valid, torch.uint8)]
    accs, order, vec_cams = update_layout(6 * C)
    order = None if order is None else torch.tensor(order, dtype=torch.int32)
    p = host_c.ptr
    rc = _load().ba_update_cpu(C, M, *(p(x) for x in ins), accs, p(order), vec_cams, p(Pn),
                               p(Xn), p(dxl))
    if rc != 0:
        raise RuntimeError(f"ba_update_cpu returned {rc}")
    return (Pn, Xn, dxl) if trace else (Pn, Xn)


def iteration(camera, prob, cam_pose, lm_pos, obs_live, free, *, policy: tuple):
    """One Gauss-Newton iteration: :func:`normal_equations`, the camera
    system's Cholesky solve (``ops/linalg``) and :func:`update`; returns the
    new ``(cam_pose, lm_pos)``."""
    S, rhs, Hinv, W, bl = normal_equations(camera, prob, cam_pose, lm_pos, obs_live, free,
                                           policy=policy)
    dx_c = linalg.cho_solve(linalg.cho_factor(S), rhs)
    return update(camera, dx_c, Hinv, W, bl, cam_pose, lm_pos, free, prob.lm_valid,
                  policy=policy)


def orthonormalize(cam_pose):
    """``lie.orthonormalize`` of every pose's rotation as the programs compile
    it (the solve's last step), the translations kept: ``[C, 3, 4]``."""
    out = torch.empty((cam_pose.shape[0], 3, 4), dtype=torch.float32)
    _load().ba_orthonormalize_cpu(cam_pose.shape[0], host_c.ptr(_c(cam_pose)), host_c.ptr(out))
    return out


def obs_chi2(camera, prob, cam_pose, lm_pos, *, policy: tuple):
    """Every observation's chi2 under ``(cam_pose, lm_pos)``: ``[O]``."""
    C, O = cam_pose.shape[0], prob.obs_lm.shape[0]
    chi2 = torch.empty((O,), dtype=torch.float32)
    ins = [_camf(camera, policy), _c(cam_pose), _c(lm_pos), _c(prob.obs_lm, torch.int64),
           _c(prob.obs_uv), _c(prob.obs_xr), _c(prob.obs_inv_sigma_sq)]
    p = host_c.ptr
    _load().ba_chi2_cpu(C, O // C, *(p(x) for x in ins), p(chi2))
    return chi2
