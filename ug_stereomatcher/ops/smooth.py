"""Confidence-weighted plus-shaped smoothing.

Subsumes smoothKernel (MatchLib.cu:1092-1170):

    out(x,y) = sum_n disp(n) * conf(n) / sum_n conf(n)

over the 5-point plus stencil {(x,y), (x±1,y), (x,y±1)} with clamp
addressing.  The CUDA kernel only computes pixels with ix > 0 and iy > 0
(MatchLib.cu:1106) — the top row and left column keep their input values;
the right/bottom edges are computed with clamped neighbours.  Both quirks
are reproduced.
"""

from __future__ import annotations

import jax.numpy as jnp

from ug_stereomatcher.ops.resample import shift_image


def weighted_smooth(disp: jnp.ndarray, conf: jnp.ndarray) -> jnp.ndarray:
    """One confidence-weighted smoothing pass over the last two axes.

    disp, conf: (..., H, W).  Returns smoothed disp of the same shape."""
    num = disp * conf
    den = conf
    for (dx, dy) in ((-1, 0), (1, 0), (0, -1), (0, 1)):
        cs = shift_image(conf, dx, dy)
        num = num + shift_image(disp, dx, dy) * cs
        den = den + cs
    out = num / den
    h, w = disp.shape[-2], disp.shape[-1]
    row = jnp.arange(h)[:, None]
    col = jnp.arange(w)[None, :]
    keep = (row == 0) | (col == 0)
    return jnp.where(keep, disp, out)
