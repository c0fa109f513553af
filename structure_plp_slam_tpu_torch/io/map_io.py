"""Whole-map snapshot save/load (MessagePack).

Port of structure_plp_slam_tpu/io/map_io.py. Reference:
src/PLPSLAM/io/map_database_io.cc:51-180 — a msgpack document {cameras,
keyfrms, landmarks, ...} written under paused threads; load reconstructs
the database for localization-only or continued mapping.

The snapshot is the MapState's field arrays plus the id counters. Arrays
are written in the JAX package's dtypes (u32 descriptors, int32 ids;
``map_state.to_numpy``), so a file either package writes loads in the
other, and the document for one map is byte for byte the same.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

from structure_plp_slam_tpu_torch.data import map_state as ms
from structure_plp_slam_tpu_torch.utils.types import resolve_device

_FORMAT_VERSION = 1


def _arr(a: np.ndarray) -> dict:
    return {"dtype": str(a.dtype), "shape": list(a.shape), "data": a.tobytes()}


def _unarr(d) -> np.ndarray:
    return np.frombuffer(d["data"], dtype=np.dtype(d["dtype"])).reshape(d["shape"])


def _build_doc(state: ms.MapState, next_kf, next_lm, camera_name="", camera=None, *,
               next_line=0, next_plane=0) -> dict:
    arrays = ms.to_numpy(state)
    doc = {
        "version": _FORMAT_VERSION,
        "camera_name": camera_name,
        "keyframe_next_id": next_kf,
        "landmark_next_id": next_lm,
        # Reference saves landmarks_line alongside points
        # (map_database_io.cc:51-103); planes are ours beyond parity.
        "line_next_id": next_line,
        "plane_next_id": next_plane,
        "arrays": {name: _arr(arrays[name]) for name in ms.MapState._fields},
    }
    if camera is not None:
        # Full camera round-trip (reference: data/camera_database — the
        # snapshot registers camera models for reload).
        doc["cameras"] = {
            camera.name: {
                k: (v.value if hasattr(v, "value") else v)
                for k, v in dataclasses.asdict(camera).items()
            }
        }
    return doc


def pack_map(state: ms.MapState, *, next_kf: int, next_lm: int, next_line: int = 0,
             next_plane: int = 0, camera_name: str = "", camera=None) -> bytes:
    """The snapshot document of ``state``, packed (what ``save_map``
    writes and ``save_map_async`` hands to the writer)."""
    import msgpack

    doc = _build_doc(state, next_kf, next_lm, camera_name, camera,
                     next_line=next_line, next_plane=next_plane)
    return msgpack.packb(doc, use_bin_type=True)


def save_map(path: str, state: ms.MapState, *, next_kf: int, next_lm: int,
             next_line: int = 0, next_plane: int = 0, camera_name: str = "", camera=None):
    blob = pack_map(state, next_kf=next_kf, next_lm=next_lm, next_line=next_line,
                    next_plane=next_plane, camera_name=camera_name, camera=camera)
    with open(path, "wb") as f:
        f.write(blob)


def save_map_async(writer, state: ms.MapState, *, next_kf: int, next_lm: int,
                   next_line: int = 0, next_plane: int = 0, camera_name: str = "",
                   camera=None):
    """Serialize + hand the blob to a native AsyncSnapshotWriter
    (checkpointing without stalling the tracking loop on the file write)."""
    writer.submit(pack_map(state, next_kf=next_kf, next_lm=next_lm, next_line=next_line,
                           next_plane=next_plane, camera_name=camera_name, camera=camera))


def _read_doc(path: str) -> dict:
    import msgpack

    with open(path, "rb") as f:
        doc = msgpack.unpackb(f.read(), raw=False)
    if doc.get("version") != _FORMAT_VERSION:
        raise ValueError(f"unsupported map snapshot version {doc.get('version')}")
    return doc


def _doc_counters(doc: dict) -> dict:
    """All id counters from a snapshot doc. Line/plane counters of
    snapshots written before they were recorded fall back to the highest
    valid slot + 1 (append-only slot discipline makes that an upper
    bound)."""

    def derived(mask_key):
        m = _unarr(doc["arrays"][mask_key])
        idx = np.where(m)[0]
        return int(idx[-1]) + 1 if len(idx) else 0

    return {
        "next_kf": int(doc["keyframe_next_id"]),
        "next_lm": int(doc["landmark_next_id"]),
        "next_line": int(doc["line_next_id"]) if "line_next_id" in doc else derived("ln_valid"),
        "next_plane": (int(doc["plane_next_id"]) if "plane_next_id" in doc
                       else derived("pl_valid")),
    }


def load_map_with_counters(path: str, device=None) -> Tuple[ms.MapState, dict]:
    """One-parse load: (state on ``device``, the card unless the caller
    asks for another; counters dict). Prefer this
    over load_map + load_counters, which would deserialize the
    (potentially very large) snapshot twice."""
    doc = _read_doc(path)
    arrays = {k: _unarr(v) for k, v in doc["arrays"].items()}
    return ms.from_numpy(arrays, resolve_device(device)), _doc_counters(doc)


def load_map(path: str, device=None) -> Tuple[ms.MapState, int, int]:
    """Returns (state, next_kf, next_lm); see ``load_map_with_counters``
    for the full counter set in one parse."""
    state, c = load_map_with_counters(path, device)
    return state, c["next_kf"], c["next_lm"]


def load_counters(path: str) -> dict:
    return _doc_counters(_read_doc(path))


def load_cameras(path: str) -> dict:
    """Camera parameter dicts stored in a snapshot (may be empty)."""
    import msgpack

    with open(path, "rb") as f:
        doc = msgpack.unpackb(f.read(), raw=False)
    return doc.get("cameras", {})
