"""The motion-only pose solve on the CPU, as XLA:CPU computes the JAX
package's (``csrc/pose_solve_cpu.c``).

XLA:CPU compiles the JAX tracker's two pose solves (the stage-1 solve
vmapped over three association strategies, the stage-2 solve alone) into
kernels whose fused multiply-adds and summation orders follow each kernel,
not the expression; the C source repeats them operation for operation, read
from the tracker's compiled code (``python -m tests.xla_pose_solve_orders``
dumps it). A batched call (``points_w [B, N, 3]``) takes the vmapped
solve's arithmetic, a single one (``[N, 3]``) the stage-2 solve's.

The source is built with the host C compiler at first use into
``build/kernels/`` and loaded with ctypes (``utils/host_c``; a failed build
raises with the compiler's output); it builds on x86-64 only (XLA:CPU's reciprocal root is the
SSE ``rsqrtss`` instruction, whose last bits other CPUs do not give). It
serves f32 CPU tensors of pinhole-projecting cameras (perspective, fisheye).
"""

from __future__ import annotations

import ctypes
import logging
import threading

import torch

from structure_plp_slam_tpu_torch.utils import host_c

_log = logging.getLogger(__name__)

SOURCE = host_c.CSRC / "pose_solve_cpu.c"

# The blocks of observation rows that XLA:CPU's dot sums apart for the
# normal matrix's stereo part ``sum J3w^T J3r``, by the number of rows N
# (the frontend's keypoint slots), each block one chain, the blocks added in
# order. Measured with jax / jaxlib 0.9.0 on an x86-64 Xeon with AVX-512,
# for the batched and the single solve alike (tests/xla_pose_solve_orders.py;
# tests/test_torch_pose_solve_xla.py holds each entry against XLA). The other
# three dots keep one order at these shapes (csrc/pose_solve_cpu.c).
_H3_BLOCKS = {
    616: (312, 304),
    1032: (260, 260, 256, 256),
    2040: (256, 256, 256, 256, 256, 256, 252, 252),
}
_UNMEASURED: set = set()

_lib = None
_lib_lock = threading.Lock()


def h3_blocks(n: int, warn: bool = True) -> tuple:
    """The stereo normal-matrix blocks for ``n`` rows (``_H3_BLOCKS``; one
    chain for a shape outside the table, with one warning when ``warn``:
    without stereo rows the dot sums zeros and its order is moot)."""
    blocks = _H3_BLOCKS.get(n)
    if blocks is None:
        blocks = (n,)
        if warn and n not in _UNMEASURED:
            _UNMEASURED.add(n)
            _log.warning(
                "pose solve over %d rows has no measured XLA:CPU summation order; "
                "summing the stereo normal matrix in one chain, so the pose may "
                "differ from the JAX package's in the last place (add the shape to "
                "tests/xla_pose_solve_orders.py and extend _H3_BLOCKS)", n)
    return blocks


def _load():
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = host_c.load(SOURCE)
            fn = lib.pose_solve_cpu
            fn.argtypes = ([ctypes.c_int] * 3 + [ctypes.c_void_p] * 8 + [ctypes.c_int] * 2
                           + [ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 6)
            fn.restype = ctypes.c_int
            _lib = lib
    return _lib


_ptr = host_c.ptr


def optimize_pose(camera, R0, t0, points_w, obs_uv, obs_xr, inv_sigma_sq, valid, *,
                  num_trials: int, num_iters: int, policy: tuple, trace: bool = False):
    """models/pose_opt.optimize_pose on CPU f32 tensors of a pinhole camera,
    with the solve's constants ``policy`` (``models/pose_opt._lm_policy``):
    ``(R [B, 3, 3], t [B, 3], inliers [B, N], chi2 [B])`` for
    ``points_w [B, N, 3]`` (the vmapped solve's arithmetic) and the same
    without the leading axis for ``[N, 3]`` (the single solve's). With
    ``trace`` also a dict of every Gauss-Newton step's ``chi2 [N]``, ``J3r
    [N, 6]``, ``Jw2 [N, 2, 6]``, ``H [6, 6]``, ``g [6]``, the clamped step
    ``xi [6]``, the step's robust cost and its acceptance, each with leading
    axes ``[B, num_trials, num_iters]``."""
    single = points_w.ndim == 2
    if single:
        points_w, valid = points_w[None], valid[None]
    if points_w.device.type != "cpu":
        raise ValueError("the XLA:CPU pose solve serves CPU tensors only")
    B, N = points_w.shape[:2]
    f32 = torch.float32

    def c(x, dtype=f32):
        return x.detach().to(dtype).contiguous()

    R = c(R0.expand(B, 3, 3) if R0.ndim == 2 else R0)
    t = c(t0.expand(B, 3) if t0.ndim == 1 else t0)
    cam = torch.tensor([camera.fx, camera.fy, camera.cx, camera.cy, camera.focal_x_baseline,
                        *policy], dtype=f32)
    ins = [cam, R, t, c(points_w), c(obs_uv), c(obs_xr), c(inv_sigma_sq),
           c(valid, torch.uint8)]
    blocks = torch.tensor(h3_blocks(N, warn=bool(torch.any(ins[5] >= 0))), dtype=torch.int32)
    R_out = torch.empty((B, 3, 3), dtype=f32)
    t_out = torch.empty((B, 3), dtype=f32)
    inl = torch.empty((B, N), dtype=torch.uint8)
    chi2 = torch.empty((B,), dtype=f32)
    work = torch.empty((42 * N,), dtype=f32)
    step = 19 * N + 50
    tr = torch.zeros((B, num_trials, num_iters, step), dtype=f32) if trace else None
    rc = _load().pose_solve_cpu(
        int(single), B, N, *(_ptr(x) for x in ins), num_trials, num_iters, _ptr(blocks),
        len(blocks), _ptr(R_out), _ptr(t_out), _ptr(inl), _ptr(chi2), _ptr(work),
        _ptr(tr) if trace else None)
    if rc != 0:
        raise RuntimeError(f"pose_solve_cpu returned {rc}")
    out = [R_out, t_out, inl.bool(), chi2]
    if single:
        out = [x[0] for x in out]
    if not trace:
        return tuple(out)
    steps = dict(chi2=tr[..., :N], J3r=tr[..., N:7 * N].unflatten(-1, (N, 6)),
                 Jw2=tr[..., 7 * N:19 * N].unflatten(-1, (N, 2, 6)),
                 H=tr[..., 19 * N:19 * N + 36].unflatten(-1, (6, 6)),
                 g=tr[..., 19 * N + 36:19 * N + 42], xi=tr[..., 19 * N + 42:19 * N + 48],
                 cost=tr[..., 19 * N + 48], accept=tr[..., 19 * N + 49] != 0)
    if single:
        steps = {k: v[0] for k, v in steps.items()}
    return tuple(out), steps
