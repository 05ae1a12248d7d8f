"""Pyramid construction, foveation and disparity resampling.

Reproduces the reference's pyramid contract (MatchGPULib.cpp):

* ``build_pyramid``      — CreatePyramidFromImage  (:1033-1125)
* ``foveate_pyramid``    — CreateFoveatedPyramid   (:1128-1190)
* ``upsample_to_level``  — subsampleDisp wrapper   (:1526-1590)
* ``foveated_upsample``  — foveatedsubsampleDisp   (:1595-1655)
* ``hierarchical_disparity`` — hierarchicalDisparity (:2589-2701)

Dimension chains use truncated integer division by the exact SCALE literal
(see MatcherConfig.dims_chain).  The pyramid is built as an even/odd
factor-2 chain: level 1 comes from blurred level 0 at scale SCALE, and every
level i+2 comes from blurred level i at scale 2.0 — avoiding repeated
sqrt(2)-resampling drift (MatchGPULib.cpp:1082-1096).
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import jax
import jax.numpy as jnp

from ug_stereomatcher.config import MatcherConfig
from ug_stereomatcher.ops.conv import blur_gaussian_zero
from ug_stereomatcher.ops.resample import (
    part_upsample_disp,
    resample_coords,
    subsample,
    upsample_disp,
)


def build_pyramid_pair(left: jnp.ndarray, right: jnp.ndarray,
                       cfg: MatcherConfig, num_levels: int | None = None
                       ) -> Tuple[List[jnp.ndarray], List[jnp.ndarray]]:
    """Both images' pyramids in ONE stacked pass.

    The blur/subsample chain is channel-agnostic (the reference loops
    channels one CUDA stream at a time, MatchGPULib.cpp:1033-1125; here
    channels are just a batched axis), so a (2C, H, W) stack halves the
    per-level kernel launches and amortises each blur/subsample's fixed
    costs across both images.  Bit-identical per channel to two separate
    :func:`build_pyramid` calls."""
    c = left.shape[-3]
    stacked = jnp.concatenate([left, right], axis=-3)
    levels = build_pyramid(stacked, cfg, num_levels)
    return ([lv[..., :c, :, :] for lv in levels],
            [lv[..., c:, :, :] for lv in levels])


def build_pyramid(image: jnp.ndarray, cfg: MatcherConfig,
                  num_levels: int | None = None) -> List[jnp.ndarray]:
    """Build the image pyramid.  image: (C, H, W) float. Returns a list of
    (C, h_i, w_i) arrays, index 0 = finest (the unblurred input itself).

    Each level is Gaussian-blurred (zero-boundary, MatchGPULib.cpp:1071)
    before being used as a resample source; the *returned* levels are the
    un-blurred resample results (p[i] = pyramid[i][0], :1119-1121)."""
    h, w = image.shape[-2], image.shape[-1]
    dims = cfg.dims_chain(h, w)
    n = num_levels if num_levels is not None else cfg.num_levels(h, w)

    levels: List[jnp.ndarray] = [None] * n  # type: ignore[list-item]
    levels[0] = image
    scale2 = float(int(cfg.scale * cfg.scale + 0.5))  # == 2.0 (MatchGPULib.cpp:1090)
    with jax.named_scope("pyramid_build"):
        for i in range(n):
            blurred = blur_gaussian_zero(levels[i])
            if i == 0 and n > 1:
                h2, w2 = dims[1]
                levels[1] = subsample(blurred, h2, w2, cfg.scale, cfg.interp)
            if i + 2 < n:
                h2, w2 = dims[i + 2]
                levels[i + 2] = subsample(blurred, h2, w2, scale2,
                                          cfg.interp)
    return levels


def foveate_pyramid(levels: Sequence[jnp.ndarray], cfg: MatcherConfig,
                    full_dims: Tuple[int, int]) -> List[jnp.ndarray]:
    """Foveated pyramid: levels >= fovea_level-1 alias the full level; finer
    levels crop a centred window of the fixed fovea size
    (CreateFoveatedPyramid, MatchGPULib.cpp:1128-1190)."""
    h0, w0 = full_dims
    dims = cfg.dims_chain(h0, w0)
    fov_h, fov_w = dims[cfg.fovea_level - 1]
    x1, y1 = fov_w // 2, fov_h // 2
    out: List[jnp.ndarray] = []
    for level, img in enumerate(levels):
        if level >= cfg.fovea_level - 1:
            out.append(img)
        else:
            h, w = dims[level]
            left = w // 2 - x1
            upper = h // 2 - y1
            out.append(img[..., upper:upper + fov_h, left:left + fov_w])
    return out


def upsample_to_level(disp: jnp.ndarray, out_h: int, out_w: int,
                      cfg: MatcherConfig) -> jnp.ndarray:
    """Upsample a disparity triplet (3, h, w) -> (3, out_h, out_w) for the
    next finer level; values scaled by SCALE (MatchGPULib.cpp:1279 with
    scalefactor = 1/SCALE; MatchLib.cu:393-394).

    NOTE: the reference applies the value scaling to all three planes,
    including confidence (cfg.scale_conf_on_upsample)."""
    inv = 1.0 / cfg.scale
    up = upsample_disp(disp, out_h, out_w, inv, cfg.scale, cfg.interp)
    if not cfg.scale_conf_on_upsample:
        conf = upsample_disp(disp[2:3], out_h, out_w, inv, 1.0, cfg.interp)
        up = jnp.concatenate([up[:2], conf], axis=0)
    return up


def foveated_upsample(disp: jnp.ndarray, big_h: int, big_w: int,
                      cfg: MatcherConfig) -> jnp.ndarray:
    """Fovea-to-fovea level transition: upsample the fovea-sized disparity to
    the (big_h, big_w) grid of the next finer full-size level, then crop the
    centred fovea window back out (foveatedsubsampleDisp,
    MatchGPULib.cpp:1595-1655).

    Evaluated as ONE windowed resample: the crop commutes with the
    per-destination-pixel gather, so only the fovea window's pixels are
    computed (the reference materialised the full big_h x
    big_w grid first; at 16MP that is up to ~7x excess work per
    transition).  Values are identical: the window indices are the same
    float64 host arithmetic on the shifted destination rows/cols."""
    fov_h, fov_w = disp.shape[-2], disp.shape[-1]
    left = big_w // 2 - fov_w // 2
    upper = big_h // 2 - fov_h // 2
    inv = 1.0 / cfg.scale
    up = resample_coords(disp, fov_h, fov_w, lambda t: t * inv, cfg.scale,
                         cfg.interp, upper, left)
    if not cfg.scale_conf_on_upsample:
        conf = resample_coords(disp[2:3], fov_h, fov_w, lambda t: t * inv,
                               1.0, cfg.interp, upper, left)
        up = jnp.concatenate([up[:2], conf], axis=0)
    return up


def hierarchical_disparity(stack: Sequence[jnp.ndarray], cfg: MatcherConfig,
                           full_dims: Tuple[int, int]) -> jnp.ndarray:
    """Reconstruct a full-resolution disparity map from a fovea stack.

    Starting at the coarsest fovea level (index fovea_level-1, whose window
    covers the full image at that resolution), repeatedly upsample by SCALE
    (values x SCALE — confidence included, a reference quirk) and overwrite
    the centred fovea window with the next finer stack level
    (hierarchicalDisparity, MatchGPULib.cpp:2589-2701).

    stack: list of (3, fov_h, fov_w) disparity triplets, index 0 = finest.
    Returns (3, H, W) at full resolution."""
    h0, w0 = full_dims
    dims = cfg.dims_chain(h0, w0)
    fov_h, fov_w = dims[cfg.fovea_level - 1]
    xs, ys = fov_w // 2, fov_h // 2

    current = stack[cfg.fovea_level - 1]
    for level in range(cfg.fovea_level - 1, 0, -1):
        big_h, big_w = dims[level - 1]
        up = part_upsample_disp(current, big_h, big_w, cfg.scale, cfg.interp)
        left = big_w // 2 - xs
        upper = big_h // 2 - ys
        window = stack[level - 1]
        current = up.at[..., upper:upper + fov_h, left:left + fov_w].set(window)
    return current
