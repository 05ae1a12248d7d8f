"""Result dump utilities — the viz/save node analogs.

Replaces UG_dispImgTest.cpp / UG_FdispImgTest.cpp, which sync-subscribe the
H/V/C outputs and write `<prefix>_H.tif` etc. to the package directory.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

from ug_stereomatcher.io.image import save_float_tiff


def save_disparity_maps(result, out_dir: str, prefix: str = "disparity",
                        ext: str = ".tif") -> dict:
    """Dump a MatchResult's H/V/C planes (UG_dispImgTest.cpp:106-108)."""
    os.makedirs(out_dir, exist_ok=True)
    paths = {}
    for tag, plane in (("H", result.disparity_h), ("V", result.disparity_v),
                       ("C", result.confidence)):
        p = os.path.join(out_dir, f"{prefix}_{tag}{ext}")
        save_float_tiff(p, np.asarray(plane))
        paths[tag] = p
    return paths


def save_foveated_stack(stack, out_dir: str, prefix: str = "fdisparity",
                        ext: str = ".tif") -> dict:
    """Dump a FoveatedStackResult's stacks (UG_FdispImgTest.cpp:107-109
    writes _FH/_FV/_FC)."""
    os.makedirs(out_dir, exist_ok=True)
    paths = {}
    for tag, plane in (("FH", stack.stack_h), ("FV", stack.stack_v),
                       ("FC", stack.stack_c)):
        p = os.path.join(out_dir, f"{prefix}_{tag}{ext}")
        save_float_tiff(p, np.asarray(plane))
        paths[tag] = p
    return paths
