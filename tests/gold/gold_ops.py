"""Scalar NumPy gold models of every matcher op.

Written directly from the reference kernel specs (MatchLib.cu) as independent
implementations — deliberately naive/loopy so they are easy to audit against
the CUDA sources.  These generalise the reference's own gold-model idea
(convolutionSeparable_gold.cpp) to the whole op set.
"""

from __future__ import annotations

import numpy as np

SCALE = 1.41421356

GAUSS_RAW = np.array([0.0816475, 0.218507, 0.303281, 0.218507, 0.0816475])
GAUSS = (GAUSS_RAW / GAUSS_RAW.sum()).astype(np.float32)
AVG = np.array([0.0, 0.3333, 0.3333, 0.3333, 0.0], dtype=np.float32)


def conv_row_zero(src: np.ndarray, kernel: np.ndarray) -> np.ndarray:
    """Row convolution, zero boundary (convolutionSeparable_gold.cpp:20-48)."""
    h, w = src.shape
    radius = len(kernel) // 2
    out = np.zeros_like(src)
    for y in range(h):
        for x in range(w):
            s = 0.0
            for k in range(-radius, radius + 1):
                d = x + k
                if 0 <= d < w:
                    s += src[y, d] * kernel[radius - k]
            out[y, x] = s
    return out


def conv_col_zero(src: np.ndarray, kernel: np.ndarray) -> np.ndarray:
    h, w = src.shape
    radius = len(kernel) // 2
    out = np.zeros_like(src)
    for y in range(h):
        for x in range(w):
            s = 0.0
            for k in range(-radius, radius + 1):
                d = y + k
                if 0 <= d < h:
                    s += src[d, x] * kernel[radius - k]
            out[y, x] = s
    return out


def conv_sep_zero(src, kernel):
    return conv_col_zero(conv_row_zero(src, kernel), kernel)


def _clamp(v, lo, hi):
    return max(lo, min(hi, v))


def tex_point(src: np.ndarray, x: float, y: float) -> float:
    """CUDA tex2D point sampling with clamp addressing."""
    h, w = src.shape
    ix = _clamp(int(np.floor(x)), 0, w - 1)
    iy = _clamp(int(np.floor(y)), 0, h - 1)
    return src[iy, ix]


def tex_linear(src: np.ndarray, x: float, y: float) -> float:
    """CUDA tex2D linear filtering (cudaFilterModeLinear) with clamp
    addressing: the four texels around (x - 0.5, y - 0.5), weighted by
    the fractional parts."""
    h, w = src.shape
    xb, yb = x - 0.5, y - 0.5
    x0, y0 = int(np.floor(xb)), int(np.floor(yb))
    ax, ay = xb - x0, yb - y0

    def at(yy, xx):
        return float(src[_clamp(yy, 0, h - 1), _clamp(xx, 0, w - 1)])

    top = (1 - ax) * at(y0, x0) + ax * at(y0, x0 + 1)
    bot = (1 - ax) * at(y0 + 1, x0) + ax * at(y0 + 1, x0 + 1)
    return (1 - ay) * top + ay * bot


def conv_row_clamp(src, kernel):
    """Texture row conv (convolutionRowsKernelT, MatchLib.cu:1461-1498)."""
    h, w = src.shape
    radius = len(kernel) // 2
    out = np.zeros_like(src)
    for y in range(h):
        for x in range(w):
            s = 0.0
            for k in range(-radius, radius + 1):
                s += tex_point(src, x + 0.5 + k, y + 0.5) * kernel[radius - k]
            out[y, x] = s
    return out


def conv_col_clamp(src, kernel):
    h, w = src.shape
    radius = len(kernel) // 2
    out = np.zeros_like(src)
    for y in range(h):
        for x in range(w):
            s = 0.0
            for k in range(-radius, radius + 1):
                s += tex_point(src, x + 0.5, y + 0.5 + k) * kernel[radius - k]
            out[y, x] = s
    return out


def conv_sep_clamp(src, kernel):
    return conv_col_clamp(conv_row_clamp(src, kernel), kernel)


def subsample(src, out_h, out_w, scale, tex=tex_point):
    """subsampleKernel gold (MatchLib.cu:311-339); ``tex=tex_linear`` for
    the bilinear option."""
    out = np.zeros((out_h, out_w), dtype=src.dtype)
    for iy in range(out_h):
        for ix in range(out_w):
            out[iy, ix] = tex(src, (ix + 0.5) * scale, (iy + 0.5) * scale)
    return out


def upsample_disp(src, out_h, out_w, scale, value_scale=SCALE,
                  tex=tex_point):
    """subsampleDispKernel gold (MatchLib.cu:372-401)."""
    out = np.zeros((out_h, out_w), dtype=src.dtype)
    for iy in range(out_h):
        for ix in range(out_w):
            out[iy, ix] = value_scale * tex(
                src, (ix + 0.5) * scale, (iy + 0.5) * scale)
    return out


def part_upsample_disp(src, out_h, out_w, scale):
    """partsubsampleDispKernel gold (MatchLib.cu:435-464)."""
    out = np.zeros((out_h, out_w), dtype=src.dtype)
    for iy in range(out_h):
        for ix in range(out_w):
            out[iy, ix] = scale * tex_point(
                src, (ix + 0.5) / scale, (iy + 0.5) / scale)
    return out


def _keys_kernel(d: float, a: float = -0.75) -> float:
    """Analytic Keys bicubic kernel W(d) — the piecewise-cubic definition,
    deliberately NOT the Horner-coefficient form the production op uses, so
    the gold check is an independent derivation.  a = -0.75 is OpenCV's
    INTER_CUBIC constant."""
    d = abs(d)
    if d <= 1.0:
        return (a + 2) * d ** 3 - (a + 3) * d ** 2 + 1
    if d < 2.0:
        return a * d ** 3 - 5 * a * d ** 2 + 8 * a * d - 4 * a
    return 0.0


def tex_cubic(src: np.ndarray, x: float, y: float) -> float:
    """Bicubic sampling at texel coordinates (x, y), clamp addressing —
    cv::resize INTER_CUBIC semantics (border-replicated taps)."""
    h, w = src.shape
    xf = x - 0.5
    yf = y - 0.5
    x0 = int(np.floor(xf))
    y0 = int(np.floor(yf))
    s = 0.0
    for ky in range(-1, 3):
        wy = _keys_kernel((yf - y0) - ky)
        for kx in range(-1, 3):
            wx = _keys_kernel((xf - x0) - kx)
            s += wy * wx * src[_clamp(y0 + ky, 0, h - 1),
                               _clamp(x0 + kx, 0, w - 1)]
    return s


def subsample_cubic(src, out_h, out_w, scale):
    """subsampleKernel coordinates with bicubic filtering — the gold model
    for the resized-range-map path (getPointCloud.cpp:772, :841 use
    cv::resize(..., INTER_CUBIC) on the Z map)."""
    out = np.zeros((out_h, out_w), dtype=np.float32)
    for iy in range(out_h):
        for ix in range(out_w):
            out[iy, ix] = tex_cubic(src, (ix + 0.5) * scale,
                                    (iy + 0.5) * scale)
    return out


def warp(src, disp_x, disp_y, tex=tex_point):
    """warpAbyB gold (MatchLib.cu:499-520).  The sample coordinate is
    formed in float32, as the device computes it."""
    h, w = src.shape
    out = np.zeros_like(src)
    for iy in range(h):
        for ix in range(w):
            x = np.float32(ix + 0.5) + np.float32(disp_x[iy, ix])
            y = np.float32(iy + 0.5) + np.float32(disp_y[iy, ix])
            out[iy, ix] = tex(src, float(x), float(y))
    return out


def shift(src, dx, dy):
    """Integer clamp shift (CompareMove second operand, MatchLib.cu:607-632)."""
    h, w = src.shape
    out = np.zeros_like(src)
    for iy in range(h):
        for ix in range(w):
            out[iy, ix] = tex_point(src, ix + 0.5 + dx, iy + 0.5 + dy)
    return out


def correlation_ratio(bcross, bl2, bw2, dx, dy):
    """MoveCorrelation gold (MatchLib.cu:666-693)."""
    h, w = bcross.shape
    out = np.zeros_like(bcross)
    for iy in range(h):
        for ix in range(w):
            num = bcross[iy, ix] ** 2
            den = bl2[iy, ix] * tex_point(bw2, ix + 0.5 + dx, iy + 0.5 + dy)
            with np.errstate(divide="ignore", invalid="ignore"):
                v = num / den
            if v > 1:
                v = 1.0
            if v < 0:
                v = 0.0
            out[iy, ix] = v
    return out


def parabola_fit(l, c, r, threshold, no_peak=0.4, aff_scale=0.3,
                 aff_bias=0.7):
    """PolyDisparity gold (MatchLib.cu:790-843); the confidence constants
    default to the reference's literals."""
    h, w = c.shape
    off = np.zeros_like(c)
    conf = np.zeros_like(c)
    for iy in range(h):
        for ix in range(w):
            lv, cv, rv = l[iy, ix], c[iy, ix], r[iy, ix]
            b1 = (rv - lv) / 2.0
            c1 = rv - (cv + b1)
            if c1 < 0:
                o = (-b1 * 0.5) / c1
                o = min(threshold, max(o, -threshold))
                cstar = (c1 * o + b1) * o + cv
                if cstar > 1.0:
                    d = cstar - cv
                    if d > 1e-10:
                        o = o * ((1.0 - cv) / d)
                    off[iy, ix] = o
                    conf[iy, ix] = 1.0
                else:
                    off[iy, ix] = o
                    conf[iy, ix] = aff_scale * cstar + aff_bias
            else:
                off[iy, ix] = 0.0
                conf[iy, ix] = no_peak
    return off, conf


def blend_confidence(new, old, w_new=0.75, w_old=0.25):
    """TrueConfidence gold (MatchLib.cu:990-1013)."""
    out = w_new * new + w_old * old
    return np.clip(out, 0.0, 1.0)


def weighted_difference(disp_new, disp_old, conf):
    """weightedDifference gold (MatchGPULib.cpp:1336-1437): confidence-
    weighted mean absolute difference between successive estimates."""
    num = 0.0
    den = 0.0
    h, w = disp_new.shape
    for iy in range(h):
        for ix in range(w):
            num += abs(disp_new[iy, ix] - disp_old[iy, ix]) * conf[iy, ix]
            den += conf[iy, ix]
    return num / den


def weighted_smooth(disp, conf):
    """smoothKernel gold (MatchLib.cu:1092-1145): plus-stencil weighted mean,
    skipping ix==0 / iy==0 (those pixels keep their input values)."""
    h, w = disp.shape
    out = disp.copy()
    for iy in range(h):
        for ix in range(w):
            if ix > 0 and iy > 0:
                num = 0.0
                den = 0.0
                for (dx, dy) in ((0, 0), (-1, 0), (1, 0), (0, -1), (0, 1)):
                    d = tex_point(disp, ix + 0.5 + dx, iy + 0.5 + dy)
                    cf = tex_point(conf, ix + 0.5 + dx, iy + 0.5 + dy)
                    num += d * cf
                    den += cf
                out[iy, ix] = num / den
    return out
