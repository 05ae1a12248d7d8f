"""Spatial (row-tile) sharding of the match engine with explicit halo
exchange — the ring-attention-style stencil pattern of SURVEY.md §5.

Design: each pyramid level's (C, H, W) arrays are padded to a multiple of
the row-axis size and row-sharded.  Inside ``shard_map``:

* stencil ops (blurs, ±1 shifts, plus-smoothing) exchange fixed halos with
  ``lax.ppermute`` (radius 2 for the 5-tap blurs, 1 for shifts/smoothing);
* the disparity-driven warp uses a tiled row ``all_gather`` of the right
  image (vertical disparity is unbounded in general, and coarse levels are
  tiny — SURVEY.md §2.5's 'row all-gathers' option);
* global image edges keep the reference's boundary semantics (zero for the
  cross-correlation blurs, clamp for texture convs/shifts) via a pad-region
  refresh before each stencil: the bottom pad rows are rewritten to the
  exact boundary extension (zeros or edge-row replicate).  Sharded results
  match the single-device engine to float rounding per level (fused-multiply
  contraction differs across partitions, and the nearest-warp feedback is
  chaotic over iterations) — compare with tolerances, per level or in
  lockstep, never bitwise (see the NOTE in sharded_match_level and
  tests/test_sharding.py).

Pyramid levels smaller than ``min_rows_per_shard *  n_shards`` run
replicated — the reference's coarse levels are a few dozen pixels and not
worth a collective (SURVEY.md §2.5 'replicate small levels').
"""

from __future__ import annotations

import warnings
from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.sharding import Mesh, PartitionSpec as P

from ug_stereomatcher.config import MatcherConfig
from ug_stereomatcher.ops.conv import _AVG, _GAUSS, conv1d
from ug_stereomatcher.ops.pointwise import (
    blend_confidence,
    correlation_ratio,
    parabola_fit,
)
from ug_stereomatcher.ops.conv import (blur_gaussian_clamp,
                                           blur_gaussian_zero)
from ug_stereomatcher.ops.resample import (axis_taps, resample_coords,
                                               shift_image, tex_gather)
from ug_stereomatcher import match as match_mod
from ug_stereomatcher import pyramid as pyr


# ----------------------------------------------------------------------
# Halo / boundary primitives (row axis = -2, sharded; width axis local)
# ----------------------------------------------------------------------

def _refresh_pad(x: jnp.ndarray, true_h: int, axis_name: str,
                 boundary: str) -> jnp.ndarray:
    """Rewrite the bottom pad rows (global rows >= true_h) with the exact
    boundary extension the next stencil op expects."""
    n = lax.axis_size(axis_name)
    hl = x.shape[-2]
    if hl * n == true_h:
        return x
    row_global = (lax.axis_index(axis_name) * hl
                  + jnp.arange(hl))[:, None]
    mask = row_global >= true_h
    if boundary == "zero":
        fill = jnp.zeros_like(x[..., :1, :])
    else:
        # the true edge row lives in the last shard (pad < hl is guaranteed
        # by ceil-division); other shards never hit the mask.
        local_edge = max(0, min(hl - 1, true_h - 1 - (n - 1) * hl))
        fill = x[..., local_edge:local_edge + 1, :]
    return jnp.where(mask, fill, x)


def halo_pad_rows(x: jnp.ndarray, halo: int, axis_name: str,
                  boundary: str) -> jnp.ndarray:
    """Extend the local row block with ``halo`` rows from each neighbour
    shard; global top/bottom edges get clamp (edge-replicate) or zero
    extension.  x: (..., Hl, W) -> (..., Hl+2*halo, W)."""
    n = lax.axis_size(axis_name)
    idx = lax.axis_index(axis_name)
    top_rows = x[..., :halo, :]
    bot_rows = x[..., -halo:, :]
    # bottom halo of shard i <- top rows of shard i+1 ; ppermute fills
    # shards with no source with zeros (the zero-boundary case for free).
    from_below = lax.ppermute(top_rows, axis_name,
                              [(i, i - 1) for i in range(1, n)])
    from_above = lax.ppermute(bot_rows, axis_name,
                              [(i, i + 1) for i in range(n - 1)])
    if boundary == "clamp":
        edge_top = jnp.broadcast_to(x[..., :1, :], top_rows.shape)
        edge_bot = jnp.broadcast_to(x[..., -1:, :], bot_rows.shape)
        from_above = jnp.where(idx == 0, edge_top, from_above)
        from_below = jnp.where(idx == n - 1, edge_bot, from_below)
    return jnp.concatenate([from_above, x, from_below], axis=-2)


def _conv_rows_halo(x: jnp.ndarray, kernel, axis_name: str,
                    boundary: str, true_h: int) -> jnp.ndarray:
    """Row-axis (height) 1-D conv of a row-sharded array."""
    kernel = np.asarray(kernel)
    radius = len(kernel) // 2
    x = _refresh_pad(x, true_h, axis_name, boundary)
    xp = halo_pad_rows(x, radius, axis_name, boundary)
    hl = x.shape[-2]
    out = None
    for k in range(-radius, radius + 1):
        w = float(kernel[radius - k])
        if w == 0.0:
            continue
        term = w * xp[..., radius + k: radius + k + hl, :]
        out = term if out is None else out + term
    return out


def sharded_conv_separable(x: jnp.ndarray, kernel, axis_name: str,
                           boundary: str, true_h: int) -> jnp.ndarray:
    """Separable conv of a row-sharded (..., Hl, W) block: width pass is
    local, height pass exchanges halos (order matches ops.conv: rows/width
    first, then columns/height)."""
    x = conv1d(x, kernel, axis=-1, boundary=boundary)
    return _conv_rows_halo(x, kernel, axis_name, boundary, true_h)


def _shift_rows_halo(x: jnp.ndarray, dy: int, axis_name: str,
                     true_h: int) -> jnp.ndarray:
    """Vertical ±1 clamp shift of a row-sharded block."""
    if dy == 0:
        return x
    x = _refresh_pad(x, true_h, axis_name, "clamp")
    xp = halo_pad_rows(x, 1, axis_name, "clamp")
    hl = x.shape[-2]
    return xp[..., 1 + dy: 1 + dy + hl, :]


def _sharded_shift(x: jnp.ndarray, dx: int, dy: int, axis_name: str,
                   true_h: int) -> jnp.ndarray:
    if dx != 0:
        x = shift_image(x, dx, 0)
    return _shift_rows_halo(x, dy, axis_name, true_h)


def _sharded_smooth(disp: jnp.ndarray, conf: jnp.ndarray, axis_name: str,
                    true_h: int) -> jnp.ndarray:
    """Row-sharded confidence-weighted plus-smoothing (ops.smooth)."""
    disp = _refresh_pad(disp, true_h, axis_name, "clamp")
    conf = _refresh_pad(conf, true_h, axis_name, "clamp")
    num = disp * conf
    den = conf
    for (dx, dy) in ((-1, 0), (1, 0), (0, -1), (0, 1)):
        cs = _sharded_shift(conf, dx, dy, axis_name, true_h)
        num = num + _sharded_shift(disp, dx, dy, axis_name, true_h) * cs
        den = den + cs
    out = num / den
    hl = disp.shape[-2]
    row_global = (lax.axis_index(axis_name) * hl + jnp.arange(hl))[:, None]
    col = jnp.arange(disp.shape[-1])[None, :]
    keep = (row_global == 0) | (col == 0)
    return jnp.where(keep, disp, out)


def _sharded_warp(right: jnp.ndarray, disp_x: jnp.ndarray,
                  disp_y: jnp.ndarray, axis_name: str, true_h: int,
                  method: str) -> jnp.ndarray:
    """Row-sharded backward warp: tiled all-gather of the right image, then
    a local gather with global row coordinates (clamped to the true image)."""
    hl = right.shape[-2]
    w = right.shape[-1]
    full = lax.all_gather(right, axis_name, axis=-2, tiled=True)
    row0 = lax.axis_index(axis_name) * hl
    ys = (jnp.arange(hl, dtype=disp_y.dtype) + 0.5)[:, None] + row0 + disp_y
    xs = (jnp.arange(w, dtype=disp_x.dtype) + 0.5)[None, :] + disp_x
    # clamp vertical reads to the true image, not the padded one
    if method == "nearest":
        ix = jnp.clip(jnp.floor(xs), 0, w - 1).astype(jnp.int32)
        iy = jnp.clip(jnp.floor(ys), 0, true_h - 1).astype(jnp.int32)
        flat = full.reshape(full.shape[:-2] + (-1,))
        idx = (iy * w + ix).reshape(-1)
        out = jnp.take(flat, idx, axis=-1)
        return out.reshape(full.shape[:-2] + (hl, w))
    ys = jnp.clip(ys, 0.5, true_h - 0.5)
    return tex_gather(full, xs, ys, method)


# ----------------------------------------------------------------------
# Row-sharded level engine
# ----------------------------------------------------------------------

def _level_body(left, right, disp0, *, cfg: MatcherConfig, level_index: int,
                is_coarsest: bool, true_h: int, axis_name: str):
    """shard_map body: identical math to match.match_level on row blocks."""
    mi = cfg.iters_for_level(level_index)
    n_smooth = cfg.smooth_passes_for_level(level_index)
    thresholds = jnp.asarray(cfg.threshold_schedule(mi), dtype=left.dtype)

    def conv_clamp(x):
        return sharded_conv_separable(x, _GAUSS, axis_name, "clamp", true_h)

    def conv_zero(x):
        return sharded_conv_separable(x, _GAUSS, axis_name, "zero", true_h)

    def conv_avg(x):
        return sharded_conv_separable(x, _AVG, axis_name, "clamp", true_h)

    blurred_l2 = conv_clamp(left * left)

    def body(carry, inputs):
        disp_h, disp_v, conf = carry
        m, threshold = inputs

        warped = _sharded_warp(right, disp_h, disp_v, axis_name, true_h,
                               cfg.interp)
        blurred_w2 = conv_clamp(warped * warped)
        dirs = []
        for (dx, dy) in match_mod.MOVES:
            cross = left * _sharded_shift(warped, dx, dy, axis_name, true_h)
            bcross = conv_zero(cross)
            corr = correlation_ratio(
                bcross, blurred_l2,
                _sharded_shift(blurred_w2, dx, dy, axis_name, true_h))
            dirs.append(jnp.mean(corr, axis=0))
        dir_l, dir_r, dir_u, dir_d, dir_c = dirs

        inc_h, conf_h = parabola_fit(
            dir_l, dir_c, dir_r, threshold, cfg.conf_no_peak,
            cfg.conf_affine_scale, cfg.conf_affine_bias)
        inc_v, conf_v = parabola_fit(
            dir_u, dir_c, dir_d, threshold, cfg.conf_no_peak,
            cfg.conf_affine_scale, cfg.conf_affine_bias)
        conf_new = conf_h * conf_v

        disp_h = inc_h + disp_h
        disp_v = inc_v + disp_v
        blended = blend_confidence(conf_new, conf,
                                   cfg.conf_blend_new, cfg.conf_blend_old)
        if is_coarsest:
            conf = jnp.where(m == 0, conf_new, blended)
        else:
            conf = blended

        for _ in range(n_smooth):
            c0 = conf
            disp_h = _sharded_smooth(disp_h, c0, axis_name, true_h)
            disp_v = _sharded_smooth(disp_v, c0, axis_name, true_h)
            conf = _sharded_smooth(conf, c0, axis_name, true_h)

        disp_h = conv_avg(disp_h)
        disp_v = conv_avg(disp_v)
        conf = conv_avg(conf)
        return (disp_h, disp_v, conf), None

    init = (disp0[0], disp0[1], disp0[2])
    ms = jnp.arange(mi)
    (dh, dv, cf), _ = jax.lax.scan(body, init, (ms, thresholds))
    return jnp.stack([dh, dv, cf])


def _pad_rows_to(x: jnp.ndarray, total: int) -> jnp.ndarray:
    """Zero-pad the row axis (-2) up to ``total`` rows."""
    pad = total - x.shape[-2]
    if pad == 0:
        return x
    cfgpad = [(0, 0)] * (x.ndim - 2) + [(0, pad), (0, 0)]
    return jnp.pad(x, cfgpad)


def _wrap_pairs(body, pairs_axis: Optional[str], n_out: int = 1):
    """Adapt a (3, H, W)-shaped stage body to arrays carrying a leading
    pairs-sharded batch axis (local batch must be exactly 1: the hybrid
    DP x SP matcher feeds one pair per pairs-group per step)."""
    if pairs_axis is None:
        return body

    def wrapped(*xs):
        out = body(*[x[0] for x in xs])
        if n_out == 1:
            return out[None]
        return tuple(o[None] for o in out)

    return wrapped


def _spec_for(ndim: int, axis_name: Optional[str],
              pairs_axis: Optional[str]) -> P:
    """PartitionSpec for a (..., H, W) array: rows over ``axis_name`` (None
    = replicated rows), leading batch over ``pairs_axis`` when present."""
    parts = [None] * ndim
    if axis_name is not None:
        parts[-2] = axis_name
    if pairs_axis is not None:
        parts[0] = pairs_axis
    return P(*parts)


def sharded_match_level(left: jnp.ndarray, right: jnp.ndarray,
                        disp: jnp.ndarray, level_index: int,
                        cfg: MatcherConfig, is_coarsest: bool,
                        mesh: Mesh, axis_name: str = "rows",
                        pairs_axis: Optional[str] = None) -> jnp.ndarray:
    """Row-sharded match_level.  Pads H to a multiple of the row-axis size,
    runs the shard_map level engine, and slices the true rows back out.

    ``pairs_axis``: arrays carry a leading batch axis sharded over that
    mesh axis (hybrid DP x SP; one pair per pairs-group).
    Results match match.match_level exactly up to float rounding."""
    n = mesh.shape[axis_name]
    true_h, w = left.shape[-2], left.shape[-1]
    hl = -(-true_h // n)
    pad = hl * n - true_h
    if pad >= hl:
        # _refresh_pad assumes all pad rows live in the last shard (its
        # clamp fill reads the true edge row locally); with pad >= hl the
        # padding would span multiple shards and silently corrupt clamp
        # boundaries.  Needs true_h > hl * (n - 1).
        raise ValueError(
            f"cannot row-shard H={true_h} over {n} shards exactly "
            f"(padding {pad} >= local rows {hl}); use fewer shards or the "
            f"unsharded match_level")

    # NOTE on equivalence: results match the single-device engine to float
    # noise (collective data movement reorders nothing, but fused-multiply
    # contraction differs), and the nearest-warp feedback amplifies that
    # noise chaotically over many iterations — compare per level with
    # tolerances, not bitwise (see tests/test_sharding.py).
    body = partial(_level_body, cfg=cfg, level_index=level_index,
                   is_coarsest=is_coarsest, true_h=true_h,
                   axis_name=axis_name)
    spec = _spec_for(left.ndim, axis_name, pairs_axis)
    fn = jax.shard_map(_wrap_pairs(body, pairs_axis), mesh=mesh,
                       in_specs=(spec, spec, spec), out_specs=spec,
                       check_vma=False)
    out = fn(_pad_rows_to(left, hl * n), _pad_rows_to(right, hl * n),
             _pad_rows_to(disp, hl * n))
    return out[..., :true_h, :]


# ----------------------------------------------------------------------
# Sharded pyramid-build / resample stages
#
# Each stage is its own shard_map: large stages row-shard with explicit
# halos/windows (1/n work per device), and small stages run replicated
# INSIDE shard_map — every device redundantly computes the full (tiny)
# array instead of paying a collective.  Reference scope:
# CreatePyramidFromImage / subsampleDisp (MatchGPULib.cpp:1033-1125,
# :1526-1590) at multi-device scale.
# ----------------------------------------------------------------------


def _row_ok(true_h: int, n: int, min_rows: int) -> bool:
    """Row-shard a stage?  Needs even-ish division (pad < local rows, the
    _refresh_pad invariant) and enough rows to be worth a collective."""
    hl = -(-true_h // n)
    return (hl * n - true_h) < hl and true_h >= min_rows * n


def replicated_stage(fn, mesh: Mesh, pairs_axis: Optional[str], *arrays):
    """Run ``fn(*arrays)`` replicated inside shard_map: every device
    computes the full result (identical inputs -> identical outputs), with
    the stage's own control flow (e.g. the early-exit while_loop) running
    as local per-device code."""
    specs = tuple(_spec_for(a.ndim, None, pairs_axis) for a in arrays)
    shaped = jax.eval_shape(fn, *[
        jax.ShapeDtypeStruct(a.shape[1:] if pairs_axis else a.shape,
                             a.dtype) for a in arrays])
    out_spec = _spec_for(len(shaped.shape) + (1 if pairs_axis else 0),
                         None, pairs_axis)
    wrapped = jax.shard_map(_wrap_pairs(fn, pairs_axis), mesh=mesh,
                            in_specs=specs, out_specs=out_spec,
                            check_vma=False)
    return wrapped(*arrays)


def sharded_blur(x: jnp.ndarray, boundary: str, mesh: Mesh,
                 axis_name: str = "rows",
                 pairs_axis: Optional[str] = None,
                 min_rows_per_shard: int = 16) -> jnp.ndarray:
    """Row-sharded 5-tap Gaussian blur of a global (..., H, W) array.

    Large inputs: the shard_map body runs the halo-exchange separable conv
    on the local block.  Small inputs run replicated inside shard_map."""
    n = mesh.shape[axis_name]
    true_h = x.shape[-2]
    if _row_ok(true_h, n, min_rows_per_shard):
        hl = -(-true_h // n)

        def body(xl):
            return sharded_conv_separable(xl, _GAUSS, axis_name, boundary,
                                          true_h)

        spec = _spec_for(x.ndim, axis_name, pairs_axis)
        fn = jax.shard_map(_wrap_pairs(body, pairs_axis), mesh=mesh,
                           in_specs=(spec,), out_specs=spec,
                           check_vma=False)
        return fn(_pad_rows_to(x, hl * n))[..., :true_h, :]

    def rep(xl):
        return (blur_gaussian_zero(xl) if boundary == "zero"
                else blur_gaussian_clamp(xl))

    return replicated_stage(rep, mesh, pairs_axis, x)


def _width_resample(x, ix0, ix1, wx):
    if wx is None:
        return jnp.take(x, jnp.asarray(ix0), axis=-1)
    g0 = jnp.take(x, jnp.asarray(ix0), axis=-1)
    g1 = jnp.take(x, jnp.asarray(ix1), axis=-1)
    w = jnp.asarray(wx)
    return g0 * (1.0 - w) + g1 * w


def sharded_resample(x: jnp.ndarray, out_h: int, out_w: int, coord_of,
                     value_scale: float, cfg: MatcherConfig, mesh: Mesh,
                     axis_name: str = "rows",
                     pairs_axis: Optional[str] = None,
                     min_rows_per_shard: int = 16) -> jnp.ndarray:
    """Row-sharded separable texture resample of a global (..., H, W)
    array (ops/resample.resample_coords semantics: texel-centre coords via
    ``coord_of``, clamp addressing, value scaling after the gather).

    Sharded height pass: output shard k's source rows form a bounded,
    host-precomputed window; a ``ppermute`` halo attaches the out-of-block
    rows and a per-shard row ``take`` (static (n, hl_out) index matrix
    selected by axis_index) gathers them, blended with the 2-tap weights
    for bilinear.  Width pass is local with static indices.  Nearest is
    bit-identical to the single-device takes; bilinear interpolates
    width-then-height, tex_gather's order.  Small outputs run replicated."""
    n = mesh.shape[axis_name]
    in_h, in_w = x.shape[-2], x.shape[-1]
    method = cfg.interp

    if not _row_ok(out_h, n, min_rows_per_shard):
        def rep(xl):
            return resample_coords(xl, out_h, out_w, coord_of,
                                   value_scale, method)

        return replicated_stage(rep, mesh, pairs_axis, x)

    ix0, ix1, wx = axis_taps(out_w, in_w, coord_of, method)
    iy0, iy1, wy = axis_taps(out_h, in_h, coord_of, method)
    hl_out = -(-out_h // n)

    def blocks(v):
        """(n, hl_out) per-shard view, padded with the last entry."""
        pad = np.full(hl_out * n - out_h, v[-1], v.dtype)
        return np.concatenate([v, pad]).reshape(n, hl_out)

    iy0m, iy1m = blocks(iy0), blocks(iy1)
    wym = blocks(wy) if wy is not None else None

    in_sharded = _row_ok(in_h, n, min_rows_per_shard)
    halo = 0
    hl_in = in_h
    if in_sharded:
        hl_in = -(-in_h // n)
        base = np.arange(n)[:, None] * hl_in
        halo = int(max((base - iy0m).max(),
                       (iy1m - (base + hl_in - 1)).max(), 0))
        if halo > hl_in:
            # window spans beyond one neighbour block (extreme scale
            # factor for this mesh) — fall back to a replicated input
            in_sharded = False
            halo = 0
            hl_in = in_h
    # Rebase each shard's source rows into its (haloed) local block.  An
    # out-of-block row would make jnp.take fill NaN, so a planner bug
    # raises here instead of corrupting rows.
    base_k = np.arange(n)[:, None] * hl_in - halo if in_sharded else 0
    rows = hl_in + 2 * halo
    r0m = (iy0m - base_k).astype(np.int32)
    r1m = (iy1m - base_k).astype(np.int32)
    lo, hi = min(r0m.min(), r1m.min()), max(r0m.max(), r1m.max())
    if lo < 0 or hi >= rows:
        raise ValueError(
            f"sharded_resample halo planner bug: rebased tap rows "
            f"[{lo}, {hi}] fall outside the haloed block [0, {rows})")

    def body(xl):
        xw = _width_resample(xl, ix0, ix1, wx)
        if in_sharded and halo:
            xw = halo_pad_rows(xw, halo, axis_name, "clamp")
        k = lax.axis_index(axis_name)
        g = jnp.take(xw, jnp.asarray(r0m)[k], axis=-2)
        if wym is not None:
            g1 = jnp.take(xw, jnp.asarray(r1m)[k], axis=-2)
            wv = jnp.asarray(wym)[k][:, None]
            g = g * (1.0 - wv) + g1 * wv
        return g if value_scale == 1.0 else value_scale * g

    in_spec = _spec_for(x.ndim, axis_name if in_sharded else None,
                        pairs_axis)
    out_spec = _spec_for(x.ndim, axis_name, pairs_axis)
    fn = jax.shard_map(_wrap_pairs(body, pairs_axis), mesh=mesh,
                       in_specs=(in_spec,), out_specs=out_spec,
                       check_vma=False)
    xin = _pad_rows_to(x, hl_in * n) if in_sharded else x
    return fn(xin)[..., :out_h, :]


def sharded_upsample_to_level(disp: jnp.ndarray, out_h: int, out_w: int,
                              cfg: MatcherConfig, mesh: Mesh, **kw
                              ) -> jnp.ndarray:
    """Sharded pyramid.upsample_to_level: values x SCALE, with the
    confidence-plane quirk handled exactly as the single-device op."""
    inv = 1.0 / cfg.scale
    up = sharded_resample(disp, out_h, out_w, lambda t: t * inv,
                          cfg.scale, cfg, mesh, **kw)
    if not cfg.scale_conf_on_upsample:
        conf = sharded_resample(disp[..., 2:3, :, :], out_h, out_w,
                                lambda t: t * inv, 1.0, cfg, mesh, **kw)
        up = jnp.concatenate([up[..., :2, :, :], conf], axis=-3)
    return up


def sharded_build_pyramid(image: jnp.ndarray, cfg: MatcherConfig, n: int,
                          mesh: Mesh, axis_name: str = "rows",
                          pairs_axis: Optional[str] = None,
                          min_rows_per_shard: int = 16):
    """Row-sharded pyramid.build_pyramid: per level one sharded blur and
    the even/odd factor-2 resample chain, large stages at 1/n work per
    device.  Nearest interp is bit-identical to the single-device build."""
    h, w = image.shape[-2], image.shape[-1]
    dims = cfg.dims_chain(h, w)
    kw = dict(axis_name=axis_name, pairs_axis=pairs_axis,
              min_rows_per_shard=min_rows_per_shard)
    levels = [None] * n
    levels[0] = image
    scale2 = float(int(cfg.scale * cfg.scale + 0.5))  # == 2.0
    for i in range(n):
        targets = []
        if i == 0 and n > 1:
            targets.append((1, cfg.scale))
        if i + 2 < n:
            targets.append((i + 2, scale2))
        if not targets:
            continue
        blurred = sharded_blur(levels[i], "zero", mesh, **kw)
        for (j, s) in targets:
            h2, w2 = dims[j]
            levels[j] = sharded_resample(
                blurred, h2, w2, lambda t, s=s: t * s, 1.0, cfg, mesh,
                **kw)
    return levels


def sharded_match_pair(left: jnp.ndarray, right: jnp.ndarray,
                       cfg: MatcherConfig, mesh: Mesh,
                       axis_name: str = "rows",
                       min_rows_per_shard: int = 16,
                       foveated: bool = False,
                       pairs_axis: Optional[str] = None
                       ) -> match_mod.PyramidMatchResult:
    """Full coarse-to-fine match with EVERY stage under shard_map: pyramid
    build, level refinement and inter-level upsamples row-shard when large
    (explicit ppermute halos), and run replicated inside shard_map when
    small — so no stage replicates large work.  In foveated mode the fixed-size fovea levels follow the
    same size rule (they are usually below the sharding threshold).

    With ``pairs_axis``, inputs carry a leading batch axis (one pair per
    pairs-group) and the whole graph composes DP x SP over the 2-D mesh."""
    if cfg.early_exit_delta is not None:
        # The row-sharded level bodies run the fixed iteration schedule: an
        # early exit would need a cross-shard convergence collective every
        # iteration.  Only the small replicated levels (full match_level
        # per device) honor the flag here — warn so a user enabling it on
        # a mesh does not silently wait for a speedup that never comes
        # (config.MatcherConfig.early_exit_delta scope note).
        warnings.warn(
            "early_exit_delta is ignored by row-sharded level bodies; "
            "sharded_match_pair runs the fixed iteration schedule on "
            "sharded levels", stacklevel=2)
    h, w = left.shape[-2:]
    n = cfg.num_levels(h, w)
    kw = dict(axis_name=axis_name, pairs_axis=pairs_axis,
              min_rows_per_shard=min_rows_per_shard)
    if pairs_axis is not None and left.shape[0] != mesh.shape[pairs_axis]:
        raise ValueError(
            f"pairs_axis mode needs batch == mesh '{pairs_axis}' size "
            f"({mesh.shape[pairs_axis]}); got {left.shape[0]} — chunk the "
            f"batch (parallel.batch.make_batch_matcher does)")

    # both images' pyramids in one stacked pass (pyramid.build_pyramid_pair
    # rationale: the chain is channel-agnostic; halves sharded stage count)
    c = left.shape[-3]
    stacked = sharded_build_pyramid(
        jnp.concatenate([left, right], axis=-3), cfg, n, mesh, **kw)
    lp = [lv[..., :c, :, :] for lv in stacked]
    rp = [lv[..., c:, :, :] for lv in stacked]
    if foveated:
        lp = pyr.foveate_pyramid(lp, cfg, (h, w))
        rp = pyr.foveate_pyramid(rp, cfg, (h, w))
    dims = match_mod.level_dims_for_matching(cfg, h, w, n, foveated)
    full_chain = cfg.dims_chain(h, w)
    n_shards = mesh.shape[axis_name]

    results = [None] * n
    hh, ww = dims[n - 1]
    bshape = (left.shape[0],) if pairs_axis is not None else ()
    disp = jnp.zeros(bshape + (3, hh, ww), dtype=left.dtype)
    for i in range(n - 1, -1, -1):
        is_coarsest = i == n - 1
        if _row_ok(dims[i][0], n_shards, min_rows_per_shard):
            disp = sharded_match_level(lp[i], rp[i], disp, i, cfg,
                                       is_coarsest, mesh, axis_name,
                                       pairs_axis=pairs_axis)
        else:
            disp = replicated_stage(
                partial(match_mod.match_level, level_index=i, cfg=cfg,
                        is_coarsest=is_coarsest),
                mesh, pairs_axis, lp[i], rp[i], disp)
        results[i] = disp
        if i > 0:
            if (not foveated) or i >= cfg.fovea_level:
                h2, w2 = dims[i - 1]
                disp = sharded_upsample_to_level(disp, h2, w2, cfg, mesh,
                                                 **kw)
            else:
                big_h, big_w = full_chain[cfg.fovea_level - 2]
                disp = replicated_stage(
                    partial(pyr.foveated_upsample, big_h=big_h,
                            big_w=big_w, cfg=cfg),
                    mesh, pairs_axis, disp)
    return match_mod.PyramidMatchResult(levels=tuple(results))
