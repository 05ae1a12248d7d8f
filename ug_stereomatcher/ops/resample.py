"""Texture-style resampling ops: subsample, disparity up-sampling, warping.

One gather op subsumes the reference's texture-unit sampling kernels
(subsampleKernel, subsampleDispKernel, partsubsampleDispKernel, warpAbyB —
MatchLib.cu:311-549).  Semantics reproduced exactly:

* Coordinates are texel-centred: destination pixel (ix, iy) samples at
  (ix + 0.5, iy + 0.5) before any scaling/offset (MatchLib.cu:322-323 etc.).
* The reference's texture references never set ``filterMode`` so CUDA uses
  the default cudaFilterModePoint: value = src[floor(y), floor(x)] — i.e.
  NEAREST sampling, not bilinear.  ``method="nearest"`` (default) reproduces
  this; ``method="bilinear"`` implements CUDA's linear filtering convention
  (weights from coord - 0.5) as the quality upgrade.
* Addressing is clamp-to-edge (cudaAddressModeClamp, the default for
  unnormalised coordinates).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np


def _gather_hw(img: jnp.ndarray, iy: jnp.ndarray, ix: jnp.ndarray) -> jnp.ndarray:
    """Gather img[..., iy, ix] for integer index maps iy, ix of equal shape.

    img: (..., H, W); iy/ix: int32 arrays (h2, w2) already clamped in-range.
    Returns (..., h2, w2).
    """
    h, w = img.shape[-2], img.shape[-1]
    flat = img.reshape(img.shape[:-2] + (h * w,))
    idx = (iy * w + ix).reshape(-1)
    out = jnp.take(flat, idx, axis=-1)
    return out.reshape(img.shape[:-2] + iy.shape)


def tex_gather(img: jnp.ndarray, x: jnp.ndarray, y: jnp.ndarray,
               method: str = "nearest") -> jnp.ndarray:
    """Sample ``img`` at float texel coordinates (x, y), CUDA-texture style.

    x, y: float arrays of identical shape (h2, w2) in texel space (a texel i
    spans [i, i+1)).  img: (..., H, W).  Returns (..., h2, w2).
    """
    h, w = img.shape[-2], img.shape[-1]
    if method == "nearest":
        ix = jnp.clip(jnp.floor(x), 0, w - 1).astype(jnp.int32)
        iy = jnp.clip(jnp.floor(y), 0, h - 1).astype(jnp.int32)
        return _gather_hw(img, iy, ix)
    elif method == "bilinear":
        # CUDA linear filtering: weights derive from (coord - 0.5).
        xf = x - 0.5
        yf = y - 0.5
        x0 = jnp.floor(xf)
        y0 = jnp.floor(yf)
        ax = xf - x0
        ay = yf - y0
        x0i = jnp.clip(x0, 0, w - 1).astype(jnp.int32)
        x1i = jnp.clip(x0 + 1, 0, w - 1).astype(jnp.int32)
        y0i = jnp.clip(y0, 0, h - 1).astype(jnp.int32)
        y1i = jnp.clip(y0 + 1, 0, h - 1).astype(jnp.int32)
        v00 = _gather_hw(img, y0i, x0i)
        v01 = _gather_hw(img, y0i, x1i)
        v10 = _gather_hw(img, y1i, x0i)
        v11 = _gather_hw(img, y1i, x1i)
        top = v00 * (1 - ax) + v01 * ax
        bot = v10 * (1 - ax) + v11 * ax
        return top * (1 - ay) + bot * ay
    elif method == "cubic":
        # 4x4 bicubic (cv::INTER_CUBIC kernel, a = -0.75), clamp addressing.
        xf = x - 0.5
        yf = y - 0.5
        x0 = jnp.floor(xf)
        y0 = jnp.floor(yf)
        wxs = _cubic_weights_jnp(xf - x0)
        wys = _cubic_weights_jnp(yf - y0)
        out = None
        for ky in range(4):
            yi = jnp.clip(y0 + (ky - 1), 0, h - 1).astype(jnp.int32)
            row = None
            for kx in range(4):
                xi = jnp.clip(x0 + (kx - 1), 0, w - 1).astype(jnp.int32)
                v = wxs[kx] * _gather_hw(img, yi, xi)
                row = v if row is None else row + v
            v = wys[ky] * row
            out = v if out is None else out + v
        return out
    raise ValueError(f"unknown method {method!r}")


_CUBIC_A = -0.75  # OpenCV's bicubic sharpness constant (imgproc resize)


def _cubic_weights_np(t: np.ndarray) -> np.ndarray:
    """Keys' bicubic weights for fractional offsets ``t`` in [0, 1): the 4
    taps at offsets {-1, 0, +1, +2} from floor(coord).  Uses the a=-0.75
    kernel family of cv::INTER_CUBIC (getPointCloud.cpp:841 resizes the
    range maps with it).  Partition of unity holds analytically; weights are
    computed in float64 at trace time and cast once."""
    a = _CUBIC_A
    t = np.asarray(t, dtype=np.float64)
    w0 = ((a * (t + 1) - 5 * a) * (t + 1) + 8 * a) * (t + 1) - 4 * a
    w1 = ((a + 2) * t - (a + 3)) * t * t + 1
    u = 1 - t
    w2 = ((a + 2) * u - (a + 3)) * u * u + 1
    w3 = 1.0 - w0 - w1 - w2
    return np.stack([w0, w1, w2, w3], axis=0)


def _cubic_weights_jnp(t: jnp.ndarray):
    a = _CUBIC_A
    w0 = ((a * (t + 1) - 5 * a) * (t + 1) + 8 * a) * (t + 1) - 4 * a
    w1 = ((a + 2) * t - (a + 3)) * t * t + 1
    u = 1 - t
    w2 = ((a + 2) * u - (a + 3)) * u * u + 1
    w3 = 1.0 - w0 - w1 - w2
    return (w0, w1, w2, w3)


def _separable_cubic(img: jnp.ndarray, out_h: int, out_w: int,
                     coord_of, row_off: int = 0,
                     col_off: int = 0) -> jnp.ndarray:
    """Axis-separable bicubic resample with static indices AND weights.

    Like :func:`_separable_nearest`, resize coordinates depend only on the
    destination axis, so bicubic factors into two per-axis 4-tap weighted
    takes whose indices and weights are trace-time constants — XLA sees
    8 takes + fused FMAs, no per-element gather.  Tap indices clamp to the
    edge (cv::resize border replication)."""
    h, w = img.shape[-2], img.shape[-1]

    def axis_taps(n_out, n_src, off):
        c = np.asarray(coord_of(np.arange(n_out) + off + 0.5),
                       dtype=np.float64) - 0.5
        i0 = np.floor(c)
        frac = c - i0
        wts = _cubic_weights_np(frac)            # (4, n_out)
        idx = np.stack([np.clip(i0 + k, 0, n_src - 1)
                        for k in (-1, 0, 1, 2)], axis=0).astype(np.int32)
        return idx, wts.astype(np.float32)

    ry, wy = axis_taps(out_h, h, row_off)
    rx, wx = axis_taps(out_w, w, col_off)
    rows = sum(wy[k][:, None] * jnp.take(img, jnp.asarray(ry[k]), axis=-2)
               for k in range(4))
    return sum(wx[k][None, :] * jnp.take(rows, jnp.asarray(rx[k]), axis=-1)
               for k in range(4))


def _dest_coords(out_h: int, out_w: int, dtype=jnp.float32,
                 row_off: int = 0, col_off: int = 0):
    ys = (jnp.arange(out_h, dtype=dtype) + row_off + 0.5)[:, None]
    xs = (jnp.arange(out_w, dtype=dtype) + col_off + 0.5)[None, :]
    return jnp.broadcast_to(xs, (out_h, out_w)), jnp.broadcast_to(ys, (out_h, out_w))


def axis_taps(n_out: int, n_in: int, coord_of, method: str = "nearest",
              offset: int = 0):
    """Static per-axis taps of a separable texture resample.

    ``coord_of(j)`` maps destination texel centres ``j + offset + 0.5`` to
    source texel coordinates (float64 host arithmetic).  Returns int32
    ``(i0, i1)`` clamped to ``[0, n_in)`` and the float32 weight ``w`` of
    ``i1`` — CUDA's linear filter (weights from coord - 0.5) — or
    ``(i0, i0, None)`` for nearest (point sampling at floor(coord))."""
    c = np.asarray(coord_of(np.arange(n_out) + offset + 0.5),
                   dtype=np.float64)
    if method == "nearest":
        i0 = np.clip(np.floor(c), 0, n_in - 1).astype(np.int32)
        return i0, i0, None
    f = c - 0.5
    f0 = np.floor(f)
    i0 = np.clip(f0, 0, n_in - 1).astype(np.int32)
    i1 = np.clip(f0 + 1, 0, n_in - 1).astype(np.int32)
    return i0, i1, (f - f0).astype(np.float32)


def _separable_nearest(img: jnp.ndarray, out_h: int, out_w: int,
                       coord_of, row_off: int = 0,
                       col_off: int = 0) -> jnp.ndarray:
    """Axis-separable nearest resample with *static* index vectors.

    All pyramid resamplers (subsample / disparity up-sample) have
    coordinates that depend only on the destination axis, so the 2-D gather
    factors into two per-axis takes with indices known at trace time —
    bit-identical to the per-element gather and cheaper.
    ``coord_of(j)`` maps a destination index vector to source texel
    coordinates.  ``row_off``/``col_off`` shift the destination window:
    the result equals rows [row_off, row_off+out_h) x cols
    [col_off, col_off+out_w) of the full (unshifted) resample — used to
    evaluate only a centred fovea crop instead of the whole grid."""
    h, w = img.shape[-2], img.shape[-1]
    iy = axis_taps(out_h, h, coord_of, offset=row_off)[0]
    ix = axis_taps(out_w, w, coord_of, offset=col_off)[0]
    out = jnp.take(img, jnp.asarray(iy), axis=-2)
    return jnp.take(out, jnp.asarray(ix), axis=-1)


def resample_coords(img: jnp.ndarray, out_h: int, out_w: int, coord_of,
                    value_scale: float = 1.0, method: str = "nearest",
                    row_off: int = 0, col_off: int = 0) -> jnp.ndarray:
    """Generic texture resample from a destination-axis coordinate callback
    — the common form of subsample / upsample_disp / part_upsample_disp
    (value scaling applied after the gather, as those do), with optional
    destination-window offsets: only the [row_off, row_off+out_h) x
    [col_off, col_off+out_w) window of the virtual full output grid is
    evaluated.  foveated_upsample's crop-after-upsample
    (MatchGPULib.cpp:1612-1644) collapses to one windowed call."""
    if method == "nearest":
        out = _separable_nearest(img, out_h, out_w, coord_of, row_off,
                                 col_off)
    elif method == "cubic":
        out = _separable_cubic(img, out_h, out_w, coord_of, row_off, col_off)
    else:
        xs, ys = _dest_coords(out_h, out_w, img.dtype, row_off, col_off)
        out = tex_gather(img, coord_of(xs), coord_of(ys), method)
    return out if value_scale == 1.0 else value_scale * out


def subsample(img: jnp.ndarray, out_h: int, out_w: int, scale: float,
              method: str = "nearest") -> jnp.ndarray:
    """Resample to (out_h, out_w): dst(x,y) = src(x*scale, y*scale).

    Subsumes subsampleKernel (MatchLib.cu:311-367) — used with scale = SCALE
    (level 0 -> 1) and scale = 2.0 (level i -> i+2) during pyramid build.
    ``method="cubic"`` adds cv::INTER_CUBIC semantics (used by the resized
    range-map reconstructions, getPointCloud.cpp:772, :841)."""
    if method == "nearest":
        return _separable_nearest(img, out_h, out_w, lambda t: t * scale)
    if method == "cubic":
        return _separable_cubic(img, out_h, out_w, lambda t: t * scale)
    xs, ys = _dest_coords(out_h, out_w, img.dtype)
    return tex_gather(img, xs * scale, ys * scale, method)


def upsample_disp(img: jnp.ndarray, out_h: int, out_w: int, scale: float,
                  value_scale: float, method: str = "nearest") -> jnp.ndarray:
    """Disparity upsample: dst(x,y) = value_scale * src(x*scale, y*scale).

    Subsumes subsampleDispKernel (MatchLib.cu:372-429): the coarse-to-fine
    driver calls it with scale = 1/SCALE and value_scale = SCALE
    (MatchGPULib.cpp:1222, 1279; MatchLib.cu:393-394)."""
    if method == "nearest":
        out = _separable_nearest(img, out_h, out_w, lambda t: t * scale)
        return value_scale * out
    xs, ys = _dest_coords(out_h, out_w, img.dtype)
    return value_scale * tex_gather(img, xs * scale, ys * scale, method)


def part_upsample_disp(img: jnp.ndarray, out_h: int, out_w: int, scale: float,
                       method: str = "nearest") -> jnp.ndarray:
    """Fovea-stack upsample: dst(x,y) = scale * src(x/scale, y/scale).

    Subsumes partsubsampleDispKernel (MatchLib.cu:435-492), used by
    hierarchical full-resolution reconstruction (MatchGPULib.cpp:2589)."""
    if method == "nearest":
        out = _separable_nearest(img, out_h, out_w, lambda t: t / scale)
        return scale * out
    xs, ys = _dest_coords(out_h, out_w, img.dtype)
    return scale * tex_gather(img, xs / scale, ys / scale, method)


def warp_by_disparity(img: jnp.ndarray, disp_x: jnp.ndarray,
                      disp_y: jnp.ndarray, method: str = "nearest") -> jnp.ndarray:
    """Backward warp: dst(x,y) = src(x + disp_x(x,y), y + disp_y(x,y)).

    Subsumes warpAbyB (MatchLib.cu:499-549): warps the right image toward the
    left by the current two-axis disparity.  img: (..., H, W),
    disp_x/disp_y: (H, W)."""
    h, w = img.shape[-2], img.shape[-1]
    xs, ys = _dest_coords(h, w, disp_x.dtype)
    return tex_gather(img, xs + disp_x, ys + disp_y, method)


def shift_image(img: jnp.ndarray, dx: int, dy: int) -> jnp.ndarray:
    """Integer shift with clamp addressing: dst(x,y) = src(x+dx, y+dy).

    Equivalent to tex_gather at (x+0.5+dx, y+0.5+dy) with nearest sampling —
    the correlation search moves (CompareMove / MoveCorrelation second
    operand, MatchLib.cu:607-725) always use dx,dy in {-1,0,1}.  Implemented
    with pad+slice so XLA fuses it into the surrounding stencil."""
    if dx == 0 and dy == 0:
        return img
    pads = [(0, 0)] * (img.ndim - 2)
    pads += [(max(0, -dy), max(0, dy)), (max(0, -dx), max(0, dx))]
    xp = jnp.pad(img, pads, mode="edge")
    h, w = img.shape[-2], img.shape[-1]
    y0 = max(0, dy)
    x0 = max(0, dx)
    sl = [slice(None)] * (img.ndim - 2) + [slice(y0, y0 + h), slice(x0, x0 + w)]
    return xp[tuple(sl)]
