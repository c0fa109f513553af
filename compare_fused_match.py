"""Time another version of the fused matcher's CUDA source against this
one, in turns, on one NVIDIA GPU.

    python3 chip_smoke.py        # saves the inputs it timed
    git show <commit>:structure_plp_slam_tpu_torch/csrc/fused_match.cu > build/other.cu
    python3 compare_fused_match.py build/other.cu

Both sources are built with the wrapper's nvcc flags and launched through
the same bare ctypes call, so the wrapper's host work weighs on neither.
On each input that chip_smoke.py saved (the last main-path call at each
call site, the dense fuse-sized input, and the loop path's loop-fix fuse
call) both are held exactly against
fused_match_plain, then timed other, this, this, other with
chip_smoke.py's readers. Prints a line per input and a JSON line. The
other source must keep the C interface of ``fused_match_launch``.
"""

from __future__ import annotations

import ctypes
import hashlib
import json
import subprocess
import sys
from pathlib import Path

import torch

import chip_smoke as cs
from structure_plp_slam_tpu_torch.ops import fused_match as fm


def launcher(source: Path):
    """Build ``source`` and return a function that launches its kernel on
    CUDA tensors in the wrapper's layout."""
    tag = hashlib.sha256(source.read_bytes()).hexdigest()[:16]
    lib = fm.BUILD_DIR / f"libcompare_{tag}.so"
    fm.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    res = subprocess.run([fm._nvcc(), *fm.NVCC_FLAGS, "-o", str(lib), str(source)],
                         capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed on {source}:\n{res.stderr}")
    fn = ctypes.CDLL(str(lib)).fused_match_launch
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def run(lm_desc, lm_meta, kp_desc, kp_meta):
        L, N = lm_desc.shape[0], kp_desc.shape[0]
        out = torch.empty((3, L), dtype=torch.float32, device=lm_desc.device)
        p = out.data_ptr()
        err = fn(lm_desc.data_ptr(), lm_meta.data_ptr(), kp_desc.data_ptr(), kp_meta.data_ptr(),
                 p, p + 4 * L, p + 8 * L, L, N, torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"{source}: launch failed, cudaError {err}")
        return out[0], out[1], out[2].view(torch.int32)

    return run


def main():
    if len(sys.argv) != 2:
        sys.exit(__doc__)
    if not torch.cuda.is_available():
        cs._fail("no CUDA device")
    inputs = torch.load(cs.INPUTS)
    this, other = launcher(fm.SOURCE), launcher(Path(sys.argv[1]))
    print(f"card: {cs.card_line()}")
    cs.device_ms(lambda: torch.ones(1024, device="cuda").add_(1), reps=2, warmup=1)
    results = {}
    for label, args in inputs.items():
        args = tuple(a.cuda() for a in args)
        plain = fm.fused_match_plain(*args)
        for name, fn in (("other", other), ("this", this)):
            for a, b in zip(fn(*args), plain):
                if not torch.equal(a, b.to(a.dtype)):
                    raise AssertionError(f"{label}: the {name} version differs from plain")
        t = results[label] = cs.time_in_turns(("other", other), ("this", this), args)
        print(f"{label}: device other {t['other_ms']:.5f} ms ({t['other_records']} records), "
              f"this {t['this_ms']:.5f} ms ({t['this_records']} records), "
              f"{t['other_ms'] / t['this_ms']:.2f}x; one call other {t['other_call_ms']:.4f} ms, "
              f"this {t['this_call_ms']:.4f} ms")
    print(json.dumps({"other": sys.argv[1], "this": cs.SOURCE,
                      "results": results}))


if __name__ == "__main__":
    main()
