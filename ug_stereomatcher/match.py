"""Coarse-to-fine iterative matching engine.

``match_level`` is the hot loop — the JAX re-design of the reference's
``matchlevel`` (MatchGPULib.cpp:1662-2489).  Where the reference launches
~25 CUDA kernels per (iteration, channel) with device-to-device copies
between each, this implementation is a single ``lax.scan`` over iterations
whose body is one fused XLA computation: channels are a batched axis, the
five correlation shifts are vectorised, and iteration-invariant terms
(the blurred left-energy map) are hoisted out of the loop.

``match_pyramid`` is the coarse-to-fine scheduler (reference ``matching``,
MatchGPULib.cpp:1196-1318) including the foveated level-size overrides and
the two disparity up-sampling paths.

Every stage runs under a ``jax.named_scope`` (``level_NN``, and inside a
level ``warp``, ``direction_maps``, ``parabola``, ``smooth`` and
``average``) so a profiler trace attributes device time per level and per
stage.
"""

from __future__ import annotations

from typing import List, NamedTuple, Sequence, Tuple

import jax
import jax.numpy as jnp

from ug_stereomatcher.config import MOVES, MatcherConfig
from ug_stereomatcher.ops.conv import (
    blur_average_clamp,
    blur_gaussian_clamp,
    blur_gaussian_zero,
)
from ug_stereomatcher.ops.pointwise import (
    blend_confidence,
    correlation_ratio,
    parabola_fit,
)
from ug_stereomatcher.ops.resample import shift_image, warp_by_disparity
from ug_stereomatcher.ops.smooth import weighted_smooth
from ug_stereomatcher import pyramid as pyr


def direction_maps(left: jnp.ndarray, warped: jnp.ndarray,
                   blurred_l2: jnp.ndarray) -> List[jnp.ndarray]:
    """Five channel-mean correlation maps for the current warp.

    left, warped: (C, H, W); blurred_l2: (C, H, W) precomputed
    G(left^2) with clamp boundary.  Returns [dir_l, dir_r, dir_u, dir_d,
    dir_c], each (H, W).

    Per move d: corr_d = clip(G(L*W_d)^2 / (G(L^2) * G(W^2)(x+d)), 0, 1)
    averaged over channels — the reference's per-channel accumulate/rescale
    chain (MatchGPULib.cpp:1910-2079).  All five moves' cross-products are
    stacked into one (5, C, H, W) batch so the blur runs as a single
    batched stencil instead of five kernel launches."""
    blurred_w2 = blur_gaussian_clamp(warped * warped)
    crosses = jnp.stack(
        [left * shift_image(warped, dx, dy) for (dx, dy) in MOVES])
    bcross = blur_gaussian_zero(crosses)
    out = []
    for k, (dx, dy) in enumerate(MOVES):
        corr = correlation_ratio(bcross[k], blurred_l2,
                                 shift_image(blurred_w2, dx, dy))
        out.append(jnp.mean(corr, axis=0))
    return out


def match_level(left: jnp.ndarray, right: jnp.ndarray, disp: jnp.ndarray,
                level_index: int, cfg: MatcherConfig,
                is_coarsest: bool) -> jnp.ndarray:
    """Iteratively refine the disparity triplet at one pyramid level.

    left, right: (C, H, W) images at this level.
    disp: (3, H, W) state [disp_h, disp_v, confidence].
    level_index: pyramid index i (0 = finest) — sets the iteration count
    mi = 22 for i > 5 else (i+1)*2 and the smoothing repetitions
    (10 for the two finest levels, else 5).
    is_coarsest: the confidence blend is skipped on the very first iteration
    of the coarsest level (MatchGPULib.cpp:2223-2225).

    Returns the refined (3, H, W) triplet.
    """
    mi = cfg.iters_for_level(level_index)
    n_smooth = cfg.smooth_passes_for_level(level_index)
    thresholds = jnp.asarray(cfg.threshold_schedule(mi), dtype=left.dtype)
    # the coarse levels' 22-iteration schedule always runs in full (see
    # MatcherConfig.early_exit_delta)
    early = (cfg.early_exit_delta if level_index < cfg.coarse_min_index
             else None)
    with jax.named_scope(f"level_{level_index:02d}"):
        return _match_level_scan(left, right, disp, cfg, is_coarsest, mi,
                                 n_smooth, thresholds, early)


def _make_level_body(left, right, blurred_l2, cfg: MatcherConfig,
                     is_coarsest, n_smooth):
    """One refinement iteration as a scan/while-compatible body closure:
    ``body(carry, (m, threshold))`` with carry (disp_h, disp_v, conf).
    Shared by the lax.scan loop, the early-exit while_loop and the
    convergence trace so all three run the IDENTICAL per-iteration graph
    (reference matchlevel body, MatchGPULib.cpp:1743-2412)."""
    def body(carry, inputs):
        disp_h, disp_v, conf = carry
        m, threshold = inputs

        with jax.named_scope("warp"):
            warped = warp_by_disparity(right, disp_h, disp_v, cfg.interp)
        with jax.named_scope("direction_maps"):
            dir_l, dir_r, dir_u, dir_d, dir_c = direction_maps(
                left, warped, blurred_l2)

        with jax.named_scope("parabola"):
            inc_h, conf_h = parabola_fit(
                dir_l, dir_c, dir_r, threshold, cfg.conf_no_peak,
                cfg.conf_affine_scale, cfg.conf_affine_bias)
            inc_v, conf_v = parabola_fit(
                dir_u, dir_c, dir_d, threshold, cfg.conf_no_peak,
                cfg.conf_affine_scale, cfg.conf_affine_bias)
            conf_new = conf_h * conf_v  # compCorrelation (MatchLib.cu:884)

            disp_h = inc_h + disp_h  # step scaling is int(1.0)=1
            disp_v = inc_v + disp_v  # (scaleDisparity, MatchGPULib.cpp:2175)

            blended = blend_confidence(conf_new, conf,
                                       cfg.conf_blend_new, cfg.conf_blend_old)
            if is_coarsest:
                conf = jnp.where(m == 0, conf_new, blended)
            else:
                conf = blended
            state = jnp.stack([disp_h, disp_v, conf])

        # Confidence-weighted plus-smoothing: all three maps smoothed against
        # the same pre-pass confidence snapshot (MatchGPULib.cpp:2262-2292),
        # then the 3-tap average filter (:2361-2412).  Stacked so each pass
        # is one batched stencil.
        with jax.named_scope("smooth"):
            for _ in range(n_smooth):
                state = weighted_smooth(state, state[2])
        with jax.named_scope("average"):
            state = blur_average_clamp(state)
        return (state[0], state[1], state[2]), None

    return body


def _level_blurred_l2(left):
    """Iteration-invariant blurred left energy (the reference recomputes
    this every iteration/channel — MatchGPULib.cpp:1809-1880 — pure
    waste)."""
    return blur_gaussian_clamp(left * left)


def _match_level_scan(left, right, disp, cfg: MatcherConfig, is_coarsest,
                      mi, n_smooth, thresholds,
                      early_exit_delta=None) -> jnp.ndarray:
    """The level loop: one fused XLA iteration per ``lax.scan`` step.

    With ``early_exit_delta`` set (opt-in, NON-parity: the reference
    always runs its fixed iteration schedule) the scan becomes a
    ``lax.while_loop`` that stops once the confidence-weighted mean
    absolute disparity change of an iteration drops below the threshold
    on both axes — the reference's own dormant convergence test
    (differenceIterations, MatchGPULib.cpp:1323-1334) finally driving the
    loop it was written for.  The while body runs the identical
    iteration graph, but XLA may fuse across the loop construct
    differently than in the scan, so outputs can differ at the ~1-ulp
    level even at a threshold of 0 (the usual gather-flip chaos amplifies
    that across a full pyramid)."""
    blurred_l2 = _level_blurred_l2(left)
    body = _make_level_body(left, right, blurred_l2, cfg, is_coarsest,
                            n_smooth)

    if early_exit_delta is not None and mi > 1:
        from ug_stereomatcher.ops.convergence import weighted_difference
        thr = jnp.asarray(early_exit_delta, left.dtype)
        big = jnp.asarray(jnp.inf, left.dtype)

        def cond(carry):
            m, _, _, _, delta = carry
            return (m < mi) & (delta >= thr)

        def wbody(carry):
            m, disp_h, disp_v, conf, _ = carry
            (nh, nv, nc), _ = body((disp_h, disp_v, conf),
                                   (m, thresholds[m]))
            delta = jnp.maximum(weighted_difference(nh, disp_h, nc),
                                weighted_difference(nv, disp_v, nc))
            return (m + 1, nh, nv, nc, delta)

        _, disp_h, disp_v, conf, _ = jax.lax.while_loop(
            cond, wbody, (jnp.int32(0), disp[0], disp[1], disp[2], big))
        return jnp.stack([disp_h, disp_v, conf])

    init = (disp[0], disp[1], disp[2])
    (disp_h, disp_v, conf), _ = jax.lax.scan(
        body, init, (jnp.arange(mi), thresholds))
    return jnp.stack([disp_h, disp_v, conf])


def level_convergence_trace(left, right, disp, level_index,
                            cfg: MatcherConfig, is_coarsest):
    """Run one level's full iteration schedule and return
    ``(triplet, deltas)`` where deltas is a (mi, 2) array of per-iteration
    confidence-weighted mean |change| for (disp_h, disp_v) — the
    reference's weightedDifference metric (MatchGPULib.cpp:1336-1437)
    traced through the live loop.  Observability/tuning aid for
    ``cfg.early_exit_delta``; runs the identical body as the serving
    scan."""
    from ug_stereomatcher.ops.convergence import weighted_difference
    mi = cfg.iters_for_level(level_index)
    n_smooth = cfg.smooth_passes_for_level(level_index)
    thresholds = jnp.asarray(cfg.threshold_schedule(mi), dtype=left.dtype)
    body = _make_level_body(left, right, _level_blurred_l2(left), cfg,
                            is_coarsest, n_smooth)

    def traced(carry, inputs):
        disp_h, disp_v, conf = carry
        (nh, nv, nc), _ = body(carry, inputs)
        dh = weighted_difference(nh, disp_h, nc)
        dv = weighted_difference(nv, disp_v, nc)
        return (nh, nv, nc), jnp.stack([dh, dv])

    init = (disp[0], disp[1], disp[2])
    (disp_h, disp_v, conf), deltas = jax.lax.scan(
        traced, init, (jnp.arange(mi), thresholds))
    return jnp.stack([disp_h, disp_v, conf]), deltas


class PyramidMatchResult(NamedTuple):
    """Per-level disparity triplets, index 0 = finest level processed."""
    levels: Tuple[jnp.ndarray, ...]


def level_dims_for_matching(cfg: MatcherConfig, height: int, width: int,
                            num_levels: int, foveated: bool
                            ) -> List[Tuple[int, int]]:
    """Per-level match dimensions.  In foveated mode, levels finer than
    fovea_level-1 are forced to the fixed fovea size
    (MatchGPULib.cpp:1230-1240)."""
    dims = list(cfg.dims_chain(height, width)[:num_levels])
    if foveated:
        fov = dims[cfg.fovea_level - 1]
        for i in range(cfg.fovea_level - 1):
            dims[i] = fov
    return dims


def match_pyramid(left_levels: Sequence[jnp.ndarray],
                  right_levels: Sequence[jnp.ndarray],
                  cfg: MatcherConfig,
                  full_dims: Tuple[int, int],
                  foveated: bool = False) -> PyramidMatchResult:
    """Coarse-to-fine schedule over a (possibly foveated) pyramid.

    left_levels/right_levels: per-level (C, h, w) images, index 0 = finest.
    full_dims: (H, W) of the original image (defines the dimension chain).
    Returns every level's refined triplet (the foveated stack needs them
    all; non-foveated mode uses index 0).

    Reference: matching (MatchGPULib.cpp:1196-1318).  The initial disparity
    at the coarsest level is zero (the reference reads freshly-malloc'd —
    effectively zero-page — memory)."""
    n = len(left_levels)
    height, width = full_dims
    dims = level_dims_for_matching(cfg, height, width, n, foveated)
    full_chain = cfg.dims_chain(height, width)

    results: List[jnp.ndarray] = [None] * n  # type: ignore[list-item]
    h, w = dims[n - 1]
    disp = jnp.zeros((3, h, w), dtype=left_levels[0].dtype)

    for i in range(n - 1, -1, -1):
        disp = match_level(left_levels[i], right_levels[i], disp, i,
                           cfg, is_coarsest=(i == n - 1))
        results[i] = disp
        if i > 0:
            with jax.named_scope(f"upsample_{i:02d}"):
                if (not foveated) or i >= cfg.fovea_level:
                    h2, w2 = dims[i - 1]
                    disp = pyr.upsample_to_level(disp, h2, w2, cfg)
                else:
                    # Fovea-to-fovea transition: upsample onto the next
                    # full-size grid then crop the centred window
                    # (MatchGPULib.cpp:1288-1293; target dims captured
                    # *before* the fovea override, :1231-1232).
                    big_h, big_w = full_chain[cfg.fovea_level - 2]
                    disp = pyr.foveated_upsample(disp, big_h, big_w, cfg)

    return PyramidMatchResult(levels=tuple(results))
