"""Leveled logging for the framework (the reference's spdlog role).

Port of structure_plp_slam_tpu/utils/logging.py, under the same
``plpslam`` logger namespace, so one ``configure`` call sets the level of
both packages.

The reference logs through spdlog everywhere — levels set by the example
drivers (``spdlog::set_level``, e.g. example/run_slam_planeSeg.cc:83-86),
keyframe/loop/relocalization events at info, per-stage timings at debug.
This module provides the same surface on top of :mod:`logging`:

* ``get_logger(name)`` — a module logger under the ``plpslam`` namespace.
* ``configure(level)`` — one-call setup (stderr handler, spdlog-like
  format); also reads the ``PLPSLAM_LOG_LEVEL`` environment variable so
  library users can switch levels without touching code.

Logging calls must never force a device sync: callers only log host-side
Python values (slot ids, counts already fetched for control flow).
"""

from __future__ import annotations

import logging
import os
import sys

_ROOT_NAME = "plpslam"
_configured = False


def get_logger(name: str = "") -> logging.Logger:
    """Module logger, e.g. ``get_logger("system")`` -> ``plpslam.system``."""
    return logging.getLogger(f"{_ROOT_NAME}.{name}" if name else _ROOT_NAME)


def configure(level: str | int | None = None, stream=None) -> logging.Logger:
    """Attach a stderr handler with an spdlog-like format and set the level.

    ``level``: name ("debug", "info", ...) or numeric; defaults to the
    ``PLPSLAM_LOG_LEVEL`` env var, then "warning" (quiet library default).
    Safe to call repeatedly (level updates, handler attaches once).
    """
    global _configured
    root = logging.getLogger(_ROOT_NAME)
    if level is None:
        level = os.environ.get("PLPSLAM_LOG_LEVEL", "warning")
    if isinstance(level, str):
        level = getattr(logging, level.upper())
    root.setLevel(level)
    if not _configured:
        handler = logging.StreamHandler(stream or sys.stderr)
        handler.setFormatter(
            logging.Formatter(
                "[%(asctime)s.%(msecs)03d] [%(levelname)s] [%(name)s] %(message)s",
                datefmt="%H:%M:%S",
            )
        )
        root.addHandler(handler)
        root.propagate = False
        _configured = True
    return root
