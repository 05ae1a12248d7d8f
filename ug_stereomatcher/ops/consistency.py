"""Left-right consistency checking.

Not present in the reference (its confidence map is the correlation-derived
plane), but a standard dense-stereo validity test and part of this
framework's production surface: match both directions and flag pixels whose
forward and backward disparities disagree.

    forward:  left(x)  ~ right(x + d_lr(x))
    backward: right(x) ~ left(x + d_rl(x))
    consistent(x)  <=>  |d_lr(x) + d_rl(x + d_lr(x))| <= tau   (both axes)

The backward field is sampled at the forward match position with the same
nearest/clamp texture semantics as the rest of the framework.
"""

from __future__ import annotations

from typing import Tuple

import jax.numpy as jnp

from ug_stereomatcher.ops.resample import warp_by_disparity


def lr_consistency_mask(disp_lr_h: jnp.ndarray, disp_lr_v: jnp.ndarray,
                        disp_rl_h: jnp.ndarray, disp_rl_v: jnp.ndarray,
                        tau: float = 1.0, method: str = "nearest"
                        ) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Consistency mask + per-pixel LR error for two-axis disparity fields.

    disp_lr_*: left->right fields on the left grid; disp_rl_*: right->left
    fields on the right grid.  Returns (mask bool (H, W), error (H, W))
    where error = ||d_lr(x) + d_rl(x + d_lr(x))||_2."""
    # one gather-index computation for both fields (warp_by_disparity
    # broadcasts over leading dims) — this runs per frame on full-res maps
    back = warp_by_disparity(jnp.stack([disp_rl_h, disp_rl_v]),
                             disp_lr_h, disp_lr_v, method)
    eh = disp_lr_h + back[0]
    ev = disp_lr_v + back[1]
    err = jnp.sqrt(eh * eh + ev * ev)
    return err <= tau, err


def apply_consistency(disparity: jnp.ndarray, mask: jnp.ndarray,
                      fill_value: float = jnp.nan) -> jnp.ndarray:
    """Invalidate inconsistent pixels (occlusions / mismatches)."""
    return jnp.where(mask, disparity, fill_value)
