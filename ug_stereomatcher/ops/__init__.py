"""Pure-JAX image ops for the stereo matcher.

Each op documents which reference CUDA kernel(s) it subsumes
(src/gpu_matcher/MatchLib.cu) and reproduces its exact boundary and sampling
semantics.  All ops are shape-polymorphic pure functions, safe under jit,
vmap, scan and shard_map.
"""

from ug_stereomatcher.ops.conv import (
    conv_separable,
    conv1d,
    blur_gaussian_zero,
    blur_gaussian_clamp,
    blur_average_clamp,
)
from ug_stereomatcher.ops.resample import (
    tex_gather,
    subsample,
    upsample_disp,
    part_upsample_disp,
    warp_by_disparity,
    shift_image,
)
from ug_stereomatcher.ops.pointwise import (
    correlation_ratio,
    parabola_fit,
    blend_confidence,
)
from ug_stereomatcher.ops.smooth import weighted_smooth

__all__ = [
    "conv_separable",
    "conv1d",
    "blur_gaussian_zero",
    "blur_gaussian_clamp",
    "blur_average_clamp",
    "tex_gather",
    "subsample",
    "upsample_disp",
    "part_upsample_disp",
    "warp_by_disparity",
    "shift_image",
    "correlation_ratio",
    "parabola_fit",
    "blend_confidence",
    "weighted_smooth",
]
