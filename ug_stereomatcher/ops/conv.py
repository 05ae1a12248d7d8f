"""Separable convolutions with the reference's two boundary semantics.

The reference uses two distinct convolution families:

* shared-memory convs with ZERO padding outside the image
  (convolutionRowsKernel / convolutionColumnsKernel, MatchLib.cu:71-305;
  CPU gold model convolutionSeparable_gold.cpp:20-75) — used for pyramid
  blurring and the cross-correlation product blurs;
* texture-sampled convs with CLAMP (edge-replicate) addressing
  (convolutionRows/ColumnsKernelT(a), MatchLib.cu:1461-1718) — used for the
  energy-map blurs and the final per-iteration average filter.

Tap orientation follows the reference: the weight applied at offset k is
``kernel[radius - k]`` (MatchLib.cu:133).  All kernels here are built as
shifted-slice weighted sums on a padded array, which XLA fuses into a single
VPU stencil loop — no gather, no matmul, fully fusible with neighbouring
elementwise ops.
"""

from __future__ import annotations

from functools import partial
from typing import Sequence

import jax.numpy as jnp
import numpy as np

from ug_stereomatcher.config import average_kernel, gaussian_kernel

_PAD_MODE = {"zero": "constant", "clamp": "edge"}


def conv1d(x: jnp.ndarray, kernel, axis: int, boundary: str = "zero") -> jnp.ndarray:
    """1-D convolution along ``axis`` with reference tap orientation.

    out[i] = sum_k kernel[radius - k] * x[i + k],  k in [-radius, radius]
    """
    kernel = np.asarray(kernel)
    radius = len(kernel) // 2
    axis = axis % x.ndim
    pad = [(0, 0)] * x.ndim
    pad[axis] = (radius, radius)
    xp = jnp.pad(x, pad, mode=_PAD_MODE[boundary])
    n = x.shape[axis]
    out = None
    for k in range(-radius, radius + 1):
        w = float(kernel[radius - k])
        if w == 0.0:
            continue
        sl = [slice(None)] * x.ndim
        sl[axis] = slice(radius + k, radius + k + n)
        term = w * xp[tuple(sl)]
        out = term if out is None else out + term
    return out


def conv_separable(x: jnp.ndarray, kernel, boundary: str = "zero") -> jnp.ndarray:
    """Separable 2-D convolution over the last two axes (rows pass then
    columns pass, matching MatchGPULib.cpp:866-960 convolutionGPU order)."""
    x = conv1d(x, kernel, axis=-1, boundary=boundary)   # row pass (along width)
    x = conv1d(x, kernel, axis=-2, boundary=boundary)   # column pass
    return x


# Cached default kernels -------------------------------------------------
_GAUSS = gaussian_kernel()
_AVG = average_kernel()


def blur_gaussian_zero(x: jnp.ndarray) -> jnp.ndarray:
    """5-tap Gaussian blur, zero boundary.

    Subsumes convolutionRowsGPU + convolutionColumnsGPU (MatchLib.cu:159-305)
    with the hard-coded kernel of MatchGPULib.cpp:761-765."""
    return conv_separable(x, _GAUSS, boundary="zero")


def blur_gaussian_clamp(x: jnp.ndarray) -> jnp.ndarray:
    """5-tap Gaussian blur, clamp boundary.

    Subsumes convolutionRowsGPUT + convolutionColumnsGPUT
    (MatchLib.cu:1461-1586)."""
    return conv_separable(x, _GAUSS, boundary="clamp")


def blur_average_clamp(x: jnp.ndarray) -> jnp.ndarray:
    """3-tap average filter (taps exactly 0.3333), clamp boundary.

    Subsumes convolutionRowsGPUTa + convolutionColumnsGPUTa
    (MatchLib.cu:1593-1718) with the kernel set at MatchGPULib.cpp:344-350.
    Note the taps sum to 0.9999, not 1 — the slight attenuation is part of
    the reference contract."""
    return conv_separable(x, _AVG, boundary="clamp")
