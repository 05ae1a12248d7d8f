"""Fovea-to-full-resolution coordinate mapping.

Reproduces getPointCloud.cpp:387-484: a fovea-stack pixel at stack level
``src_level`` maps into the original pyramid at ``dest_level`` (default 0 =
full resolution) by scaling with SCALE^|src-dest| and adding the centred
fovea window margins.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from ug_stereomatcher.config import MatcherConfig


def _dims_chain(cfg: MatcherConfig, height: int, width: int):
    return cfg.dims_chain(height, width)


def fovea_margins(cfg: MatcherConfig, height: int, width: int,
                  src_level: int, dest_level: int = 0) -> Tuple[int, int]:
    """(left, upper) margins of the scaled fovea window of ``src_level``
    inside pyramid level ``dest_level``.

    Mirrors left_marginOf_in / upper_marginOf_in (getPointCloud.cpp:431-484):
    the 'scaled fovea level' is (fovea_level-1) - src_level for the usual
    src >= dest case."""
    dims = _dims_chain(cfg, height, width)
    if src_level < dest_level:
        scaled = src_level + dest_level  # reference branch (:437-438)
    else:
        scaled = (cfg.fovea_level - 1) - src_level
    dest_h, dest_w = dims[dest_level]
    src_h, src_w = dims[scaled]
    left = dest_w // 2 - src_w // 2
    upper = dest_h // 2 - src_h // 2
    return left, upper


def map_fovea_coords(cfg: MatcherConfig, height: int, width: int,
                     src_level: int, src_x, src_y, dest_level: int = 0):
    """Map fovea-stack coordinates (src_x, src_y) at ``src_level`` to
    pyramid-level ``dest_level`` coordinates.

    original = margin + src * SCALE^|src_level - dest_level|  (with the
    inverse power when src_level < dest_level) — mapXcoord/mapYcoord
    (getPointCloud.cpp:387-421)."""
    left, upper = fovea_margins(cfg, height, width, src_level, dest_level)
    if src_level < dest_level:
        root = 1.0 / np.sqrt(2.0)
    else:
        root = np.sqrt(2.0)
    factor = root ** abs(src_level - dest_level)
    return left + src_x * factor, upper + src_y * factor
