"""Fused windowed descriptor matcher: hand-written CUDA kernel + plain twin.

Port of structure_plp_slam_tpu/ops/pallas_matching.py (the repo's only
TPU kernel). For every landmark row: the Hamming distance to every
keypoint, masked to ``HAMMING_MASKED`` outside the row's window
(``|du|, |dv| <= radius``, radius <= 0 makes the row inactive) and outside
``|Δlevel| <= 1.5`` (level 1e9 marks an invalid keypoint); then the best
distance, the second best (only the argmin column removed, so a tie gives
second == best) and the argmin (lowest index on ties).

Layout. The TPU's 128-lane meta blocks and 512-row padding are gone:

    fused_match(lm_desc int32 [L, 8],   packed u32 words as bit patterns
                lm_meta f32   [L, 4],   u, v, radius, predicted level
                kp_desc int32 [N, 8],
                kp_meta f32   [N, 3])   x, y, level
      -> best f32 [L], second f32 [L], idx int32 [L]

``fused_match`` launches ``csrc/fused_match.cu`` for CUDA tensors (built
with nvcc for sm_90a at first use into ``build/kernels/``, loaded with
ctypes) and takes :func:`fused_match_plain` only for CPU tensors. The
kernel is built and loaded inside the launching call, never at import.
The three outputs are views of one ``[3, L]`` buffer.
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

from structure_plp_slam_tpu_torch.ops.matching import unpack_desc_bits
from structure_plp_slam_tpu_torch.utils.types import HAMMING_MASKED

LEVEL_WINDOW = 1.5
_MASKED = float(HAMMING_MASKED)

SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "fused_match.cu"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC"]

_lib = None
_lib_lock = threading.Lock()


def fused_match_plain(lm_desc, lm_meta, kp_desc, kp_meta):
    """Plain PyTorch version: an ``[L, N]`` masked distance matrix, then
    min, argmin and a second min with the argmin column removed."""
    d = (256.0 - unpack_desc_bits(lm_desc) @ unpack_desc_bits(kp_desc).T) * 0.5
    in_window = (
        (torch.abs(lm_meta[:, 0:1] - kp_meta[None, :, 0]) <= lm_meta[:, 2:3])
        & (torch.abs(lm_meta[:, 1:2] - kp_meta[None, :, 1]) <= lm_meta[:, 2:3])
        & (torch.abs(lm_meta[:, 3:4] - kp_meta[None, :, 2]) <= LEVEL_WINDOW)
    )
    d = torch.where(in_window, d, _MASKED)
    idx = torch.argmin(d, dim=1)
    best = torch.gather(d, 1, idx[:, None])[:, 0]
    d[torch.arange(d.shape[0], device=d.device), idx] = _MASKED
    second = torch.amin(d, dim=1)
    return best, second, idx.to(torch.int32)


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (shutil.which("nvcc"), os.path.join(cuda_home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: cannot build the fused_match kernel")


def build(verbose: bool = False) -> Path:
    """Compile ``csrc/fused_match.cu`` into a shared library (named by the
    source's hash, so an edited source never reuses a stale build)."""
    src = SOURCE.read_bytes()
    tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    out = BUILD_DIR / f"libfused_match_{tag}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)]
    if verbose:
        cmd.insert(1, "-Xptxas=-v")
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n{res.stderr}")
    if verbose and res.stderr:
        print(res.stderr.strip())
    os.replace(tmp, out)
    return out


def _load():
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            fn = lib.fused_match_launch
            fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int, ctypes.c_int,
                                                   ctypes.c_void_p]
            fn.restype = ctypes.c_int
            lib.fused_match_count_tiles.argtypes = [ctypes.c_int, ctypes.c_void_p]
            lib.fused_match_count_tiles.restype = ctypes.c_int
            _lib = lib
    return _lib


def _check(name, t, dtype, cols):
    if t.dtype != dtype or t.ndim != 2 or t.shape[1] != cols:
        raise ValueError(
            f"fused_match: {name} must be {dtype} [*, {cols}], got "
            f"{t.dtype} {tuple(t.shape)}"
        )
    if not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"fused_match: {name} must be contiguous and 16-byte aligned")


def fused_match(lm_desc, lm_meta, kp_desc, kp_meta):
    """Run the fused matcher (layouts in the module docstring). CPU tensors
    take the plain version; CUDA tensors launch the kernel or raise."""
    fused_match.calls += 1
    dev = lm_desc.device
    if dev.type == "cpu":
        return fused_match_plain(lm_desc, lm_meta, kp_desc, kp_meta)
    if dev.type != "cuda":
        raise ValueError(f"fused_match: unsupported device {dev}")
    for name, t in (("lm_meta", lm_meta), ("kp_desc", kp_desc), ("kp_meta", kp_meta)):
        if t.device != dev:
            raise ValueError(f"fused_match: {name} is on {t.device}, not {dev}")
    _check("lm_desc", lm_desc, torch.int32, 8)
    _check("lm_meta", lm_meta, torch.float32, 4)
    _check("kp_desc", kp_desc, torch.int32, 8)
    _check("kp_meta", kp_meta, torch.float32, 3)
    L, N = lm_desc.shape[0], kp_desc.shape[0]
    if lm_meta.shape[0] != L or kp_meta.shape[0] != N:
        raise ValueError("fused_match: desc and meta row counts differ")
    out = torch.empty((3, L), dtype=torch.float32, device=dev)
    ptr = out.data_ptr()
    args = (lm_desc.data_ptr(), lm_meta.data_ptr(), kp_desc.data_ptr(), kp_meta.data_ptr(),
            ptr, ptr + 4 * L, ptr + 8 * L, L, N)
    launch = (_lib or _load()).fused_match_launch
    if dev.index == torch.cuda.current_device():
        err = launch(*args, torch.cuda.current_stream().cuda_stream)
    else:
        with torch.cuda.device(dev):
            err = launch(*args, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:  # the kernel's own limits (e.g. N > 2**21) come back as errors
        raise RuntimeError(f"fused_match kernel launch failed: cudaError {err}")
    fused_match.launches += 1
    fused_match.launches_by_rows[L] += 1
    return out[0], out[1], out[2].view(torch.int32)


def count_tiles(on: bool) -> dict:
    """Have the kernel launches that follow count their tiles (``on``) or
    not, and return what the launches on the current device counted since
    the last switch: the 8-keypoint tiles their warps walked, and those
    sent to the binary tensor cores (a pair in a window). The counting
    build is the same source with the counters in; it waits for the
    device first."""
    buf = (ctypes.c_ulonglong * 2)()
    err = _load().fused_match_count_tiles(int(on), buf)
    if err != 0:
        raise RuntimeError(f"fused_match tile counts failed: cudaError {err}")
    return {"walked": buf[0], "mma": buf[1]}


# Counters read by chip_smoke.py and the tests to show that the main path
# went through the matcher: ``launches`` (and its split by row count)
# counts kernel launches only; ``calls`` counts every call, plain CPU
# ones included.
fused_match.launches = 0
fused_match.launches_by_rows = collections.Counter()
fused_match.calls = 0


def reset_counts():
    fused_match.launches = 0
    fused_match.launches_by_rows.clear()
    fused_match.calls = 0
