"""ctypes bindings to the native runtime library (native/plpslam_native.cpp).

Port of structure_plp_slam_tpu/native.py, over the same library (it has
no JAX in it). Native components (see the C++ file for the reference
mapping):
  * AsyncSnapshotWriter — non-blocking map checkpointing.
  * NativePublisher — TCP broadcast of binary map packets to viewers
    (reference: src/socket_publisher/).

The library is built with ``make`` on first use. A build that fails
raises ``RuntimeError`` with make's output, so ``System.enable_autosave``
and ``System.start_native_publisher`` say why they cannot start.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Optional

_NATIVE_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                           "native")
_LIB_PATH = os.path.join(_NATIVE_DIR, "libplpslam_native.so")
_lib: Optional[ctypes.CDLL] = None
_lock = threading.Lock()


def _build():
    """Run ``make`` in native/ into a file of this process's own, then
    rename it into place (another process may load or build the library
    at the same time); raise with make's output if it fails."""
    tmp = f"{os.path.basename(_LIB_PATH)}.{os.getpid()}.tmp"
    try:
        res = subprocess.run(["make", "-C", _NATIVE_DIR, f"TARGET={tmp}"],
                             capture_output=True, text=True, timeout=300)
    except (OSError, subprocess.TimeoutExpired) as e:
        raise RuntimeError(f"could not build {_LIB_PATH}: {e}") from e
    built = os.path.join(_NATIVE_DIR, tmp)
    if res.returncode != 0 or not os.path.exists(built):
        raise RuntimeError(f"could not build {_LIB_PATH} (make exited {res.returncode}):\n"
                           f"{res.stdout}{res.stderr}")
    os.replace(built, _LIB_PATH)


def load() -> ctypes.CDLL:
    """The native library, built first if it is absent."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        if not os.path.exists(_LIB_PATH):
            _build()
        lib = ctypes.CDLL(_LIB_PATH)
        lib.snapshot_writer_create.restype = ctypes.c_void_p
        lib.snapshot_writer_create.argtypes = [ctypes.c_char_p]
        lib.snapshot_writer_submit.restype = None
        lib.snapshot_writer_submit.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                               ctypes.c_uint64]
        lib.snapshot_writer_wait.restype = None
        lib.snapshot_writer_wait.argtypes = [ctypes.c_void_p]
        lib.snapshot_writer_destroy.restype = None
        lib.snapshot_writer_destroy.argtypes = [ctypes.c_void_p]
        lib.publisher_create.restype = ctypes.c_void_p
        lib.publisher_create.argtypes = [ctypes.c_int]
        lib.publisher_port.restype = ctypes.c_int
        lib.publisher_port.argtypes = [ctypes.c_void_p]
        lib.publisher_num_clients.restype = ctypes.c_int
        lib.publisher_num_clients.argtypes = [ctypes.c_void_p]
        lib.publisher_packets_sent.restype = ctypes.c_uint64
        lib.publisher_packets_sent.argtypes = [ctypes.c_void_p]
        lib.publisher_publish.restype = None
        lib.publisher_publish.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_uint64]
        lib.publisher_destroy.restype = None
        lib.publisher_destroy.argtypes = [ctypes.c_void_p]
        _lib = lib
        return _lib


def available() -> bool:
    """Whether the native library loads (built first if it is absent)."""
    try:
        load()
    except (OSError, RuntimeError):
        return False
    return True


class AsyncSnapshotWriter:
    """Latest-wins background checkpoint writer (atomic rename)."""

    def __init__(self, path: str):
        self._lib = load()
        self._h = self._lib.snapshot_writer_create(path.encode())

    def submit(self, blob: bytes):
        self._lib.snapshot_writer_submit(self._h, blob, len(blob))

    def wait(self):
        self._lib.snapshot_writer_wait(self._h)

    def close(self):
        if self._h:
            self._lib.snapshot_writer_destroy(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()


class NativePublisher:
    """TCP broadcast server for binary map packets (4-byte big-endian
    length prefix, then the packet)."""

    def __init__(self, port: int = 0):
        self._lib = load()
        self._h = self._lib.publisher_create(port)
        if not self._h:
            raise OSError(f"could not bind publisher port {port}")

    @property
    def port(self) -> int:
        return self._lib.publisher_port(self._h)

    @property
    def num_clients(self) -> int:
        return self._lib.publisher_num_clients(self._h)

    @property
    def packets_sent(self) -> int:
        return self._lib.publisher_packets_sent(self._h)

    def publish(self, blob: bytes):
        self._lib.publisher_publish(self._h, blob, len(blob))

    def close(self):
        if self._h:
            self._lib.publisher_destroy(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()
