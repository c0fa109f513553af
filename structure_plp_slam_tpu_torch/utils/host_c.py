"""Build the port's C sources for the CPU (``csrc/*.c``) with the host C
compiler and load them with ctypes.

A source is compiled at first use into ``build/kernels/`` as a shared library
named by the hash of the source and the headers beside it (``xla_cpu.h``),
the compiler, the flags and the host CPU
(``-march=native`` builds for it), to a temporary name that is then renamed,
so that concurrent processes do not race. A failed build raises with the
compiler's output. ``-ffp-contract=off``: every fused multiply-add of a
source is an explicit ``fmaf``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
CFLAGS = ["-O2", "-march=native", "-ffp-contract=off", "-fPIC", "-shared"]

_libs: dict = {}
_lock = threading.Lock()


def _host() -> bytes:
    """The CPU's model and feature flags."""
    try:
        with open("/proc/cpuinfo", "rb") as f:
            lines = [ln for ln in f.read().splitlines()
                     if ln.startswith((b"model name", b"flags"))]
        return b"\n".join(lines[:2])
    except OSError:
        return platform.processor().encode()


def build(source: Path) -> Path:
    """Compile ``source`` (once per source and the headers beside it,
    compiler, flags and host)."""
    src = source.read_bytes() + b"".join(h.read_bytes() for h in sorted(source.parent.glob("*.h")))
    cc = os.environ.get("CC", "cc")
    tag = hashlib.sha256(src + " ".join([cc, *CFLAGS]).encode() + _host()).hexdigest()[:16]
    out = BUILD_DIR / f"lib{source.stem}_{tag}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    res = subprocess.run([cc, *CFLAGS, "-o", str(tmp), str(source), "-lm"],
                         capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"{cc} failed ({res.returncode}) building {source}:\n{res.stderr}")
    os.replace(tmp, out)
    return out


def load(source: Path) -> ctypes.CDLL:
    """The built library of ``source``, loaded once per process."""
    with _lock:
        lib = _libs.get(source)
        if lib is None:
            lib = _libs[source] = ctypes.CDLL(str(build(source)))
    return lib


def ptr(t) -> ctypes.c_void_p:
    """The data pointer of a contiguous tensor (None for None)."""
    return None if t is None else ctypes.c_void_p(t.data_ptr())
