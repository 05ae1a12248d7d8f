"""The XLA level ops against the scalar gold models, at the shapes and
offsets the hot path meets: warps in and far beyond any local window, at
arbitrary absolute offsets, 2-D and 3-D inputs, odd and non-128 widths;
the smoothing chain; the correlation -> parabola -> blend update with
non-default confidence constants; both blur boundaries; and every resample
of a pyramid's dimension chain."""

import numpy as np
import pytest

import jax.numpy as jnp

from ug_stereomatcher import match as match_mod
from ug_stereomatcher import ops
from ug_stereomatcher.config import MOVES, MatcherConfig
from ug_stereomatcher.ops.pointwise import blend_confidence, parabola_fit
from tests.gold import gold_ops as g
from tests.gold import gold_match as gm


def _rng(seed):
    return np.random.RandomState(seed)


def _smooth_field(h, w, amp_v, amp_h, bias_h=0.0, bias_v=0.0):
    yy = np.linspace(0, 1, h)[:, None]
    xx = np.linspace(0, 1, w)[None, :]
    dh = (bias_h + amp_h * np.sin(2 * np.pi * yy)
          * np.cos(2 * np.pi * xx)).astype(np.float32)
    dv = (bias_v + amp_v * np.cos(2 * np.pi * xx)
          + 0.0 * yy).astype(np.float32)
    return dh, dv


def _two_sided_dv(h, w, amp):
    dv = np.zeros((h, w), np.float32)
    dv[64:96] = amp
    dv[96:128] = -amp
    return dv


def _const(h, w, v):
    return np.full((h, w), v, np.float32)


def _uniform(seed, h, w, lo, hi):
    return (_rng(seed).rand(h, w) * (hi - lo) + lo).astype(np.float32)


# (name, channels, h, w, dh, dv): in-window, far beyond a local window,
# large absolute offsets, per-row-band spreads, ragged sizes
WARP_CASES = [
    ("in_window_3d", 3, 40, 160,
     lambda h, w: _uniform(1, h, w, -20, 20), lambda h, w: _uniform(2, h, w, -3, 3)),
    ("far_left_clamps", 1, 16, 512,
     lambda h, w: _const(h, w, -400.0), lambda h, w: _const(h, w, 0.0)),
    ("zero_2d", 1, 24, 128,
     lambda h, w: _const(h, w, 0.0), lambda h, w: _const(h, w, 0.0)),
    ("beyond_both_axes", 3, 32, 512,
     lambda h, w: _uniform(3, h, w, 300, 380), lambda h, w: _uniform(4, h, w, 12, 22)),
    ("vertical_only", 3, 64, 256,
     lambda h, w: _const(h, w, 0.0), lambda h, w: _const(h, w, 40.0)),
    ("half_texel_offsets", 1, 32, 1024,
     lambda h, w: _const(h, w, -255.5), lambda h, w: _const(h, w, 7.5)),
    ("smooth_field", 3, 100, 300,
     lambda h, w: _smooth_field(h, w, 3.0, 10.0)[0],
     lambda h, w: _smooth_field(h, w, 3.0, 10.0)[1]),
    ("smooth_field_far_right", 3, 100, 300,
     lambda h, w: _smooth_field(h, w, 3.0, 10.0, 700.0, 30.0)[0],
     lambda h, w: _smooth_field(h, w, 3.0, 10.0, 700.0, 30.0)[1]),
    ("smooth_field_far_left", 3, 100, 300,
     lambda h, w: _smooth_field(h, w, 3.0, 10.0, -650.0, -25.0)[0],
     lambda h, w: _smooth_field(h, w, 3.0, 10.0, -650.0, -25.0)[1]),
    ("ragged_rows_far", 1, 100, 610,
     lambda h, w: _const(h, w, 500.0), lambda h, w: _const(h, w, -40.0)),
    ("two_sided_bands", 1, 256, 300,
     lambda h, w: _const(h, w, 0.0), lambda h, w: _two_sided_dv(h, w, 80.0)),
    ("opposite_halves", 1, 128, 256,
     lambda h, w: _const(h, w, 0.0),
     lambda h, w: np.where(np.arange(h)[:, None] < 64, 60.0,
                           -60.0).astype(np.float32) + _const(h, w, 0.0)),
]


def _warp_inputs(case):
    name, c, h, w, fdh, fdv = case
    rng = _rng(sum(map(ord, name)))
    shape = (c, h, w) if c > 1 else (h, w)
    img = (rng.rand(*shape) + 1.0).astype(np.float32)   # no zeros
    return img, fdh(h, w), fdv(h, w)


def _gold_warp(img, dh, dv, tex):
    if img.ndim == 2:
        return g.warp(img, dh, dv, tex)
    return np.stack([g.warp(c, dh, dv, tex) for c in img])


class TestWarpGold:
    @pytest.mark.parametrize("case", WARP_CASES, ids=[c[0] for c in WARP_CASES])
    def test_nearest_bit_exact(self, case):
        img, dh, dv = _warp_inputs(case)
        out = np.asarray(ops.warp_by_disparity(
            jnp.asarray(img), jnp.asarray(dh), jnp.asarray(dv)))
        assert out.shape == img.shape
        np.testing.assert_array_equal(out, _gold_warp(img, dh, dv,
                                                      g.tex_point))
        assert np.all(out >= 1.0)   # clamp addressing, never a zero fill

    @pytest.mark.parametrize("case", WARP_CASES[:9],
                             ids=[c[0] for c in WARP_CASES[:9]])
    def test_bilinear_matches_linear_filter(self, case):
        img, dh, dv = _warp_inputs(case)
        out = np.asarray(ops.warp_by_disparity(
            jnp.asarray(img), jnp.asarray(dh), jnp.asarray(dv), "bilinear"))
        np.testing.assert_allclose(out, _gold_warp(img, dh, dv,
                                                   g.tex_linear),
                                   rtol=1e-5, atol=1e-5)


class TestSmoothChainGold:
    @pytest.mark.parametrize("n", [1, 5, 10])
    def test_smooth_then_average(self, n):
        h, w = 40, 150
        st = (_rng(n).rand(3, h, w).astype(np.float32) + 0.05)
        out = jnp.asarray(st)
        for _ in range(n):
            out = ops.weighted_smooth(out, out[2])
        out = np.asarray(ops.blur_average_clamp(out))
        ref = st.copy()
        for _ in range(n):
            c0 = ref[2].copy()
            ref = np.stack([g.weighted_smooth(p, c0) for p in ref])
        ref = np.stack([g.conv_sep_clamp(p, g.AVG) for p in ref])
        np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)


class TestDirectionUpdateGold:
    """correlate -> parabola -> update -> blend, with non-default
    confidence constants so a literal drifting from MatcherConfig shows."""

    @pytest.mark.parametrize("thr,replace", [(1.0, False), (0.55, True)])
    def test_update_matches_gold(self, thr, replace):
        h, w = 36, 140
        rng = _rng(7)
        left = rng.rand(3, h, w).astype(np.float32) * 255
        warped = rng.rand(3, h, w).astype(np.float32) * 255
        disp = (rng.rand(3, h, w).astype(np.float32) - 0.5)
        no_peak, aff_s, aff_b, w_new, w_old = (0.3, 0.2, 0.8, 0.9, 0.1)

        bl2 = ops.blur_gaussian_clamp(jnp.asarray(left * left))
        dirs = match_mod.direction_maps(jnp.asarray(left),
                                        jnp.asarray(warped), bl2)
        ih, ch = parabola_fit(dirs[0], dirs[4], dirs[1], thr, no_peak,
                              aff_s, aff_b)
        iv, cv = parabola_fit(dirs[2], dirs[4], dirs[3], thr, no_peak,
                              aff_s, aff_b)
        cn = ch * cv
        conf = cn if replace else blend_confidence(cn, disp[2], w_new, w_old)
        out = np.asarray(jnp.stack([ih + disp[0], iv + disp[1], conf]))

        gbl2 = [g.conv_sep_clamp(c * c, g.GAUSS) for c in left]
        gbw2 = [g.conv_sep_clamp(c * c, g.GAUSS) for c in warped]
        gdirs = []
        for dx, dy in MOVES:
            acc = 0.0
            for c in range(3):
                cross = left[c] * g.shift(warped[c], dx, dy)
                bc = g.conv_sep_zero(cross, g.GAUSS)
                acc = acc + g.correlation_ratio(bc, gbl2[c], gbw2[c], dx, dy)
            gdirs.append(acc / 3)
        gih, gch = g.parabola_fit(gdirs[0], gdirs[4], gdirs[1], thr,
                                  no_peak, aff_s, aff_b)
        giv, gcv = g.parabola_fit(gdirs[2], gdirs[4], gdirs[3], thr,
                                  no_peak, aff_s, aff_b)
        gcn = gch * gcv
        gconf = gcn if replace else g.blend_confidence(gcn, disp[2], w_new,
                                                       w_old)
        ref = np.stack([gih + disp[0], giv + disp[1], gconf])
        # the gold sums in float64; ratios near a parabola's flat top
        # amplify rounding, so the gate sits well above float32 noise
        np.testing.assert_allclose(out, ref, rtol=5e-4, atol=5e-4)


class TestBlurGold:
    @pytest.mark.parametrize("boundary,shape", [
        ("zero", (3, 37, 210)), ("clamp", (3, 37, 210)),
        ("zero", (24, 140)), ("clamp", (70, 300)), ("zero", (70, 300))])
    def test_blur(self, boundary, shape):
        x = _rng(sum(shape)).rand(*shape).astype(np.float32)
        fn = (ops.blur_gaussian_zero if boundary == "zero"
              else ops.blur_gaussian_clamp)
        gold = g.conv_sep_zero if boundary == "zero" else g.conv_sep_clamp
        out = np.asarray(fn(jnp.asarray(x)))
        ref = (gold(x, g.GAUSS) if x.ndim == 2
               else np.stack([gold(c, g.GAUSS) for c in x]))
        assert out.shape == x.shape
        np.testing.assert_allclose(out, ref, rtol=1e-6, atol=1e-6)


def _chain_resamples(h, w):
    """Every resample a pyramid of (h, w) performs: the build's SCALE and
    factor-2 subsamples and each level-to-level disparity upsample."""
    cfg = MatcherConfig()
    n = cfg.num_levels(h, w)
    dims = cfg.dims_chain(h, w)
    cases = [("build_0_1", dims[0], dims[1], g.SCALE, 1.0)]
    cases += [(f"build_{i}_{i + 2}", dims[i], dims[i + 2], 2.0, 1.0)
              for i in range(n - 2)]
    cases += [(f"upsample_{i}_{i - 1}", dims[i], dims[i - 1], 1 / g.SCALE,
               g.SCALE) for i in range(n - 1, 0, -1)]
    return cases


CHAIN = _chain_resamples(120, 180)


class TestResampleChainGold:
    @pytest.mark.parametrize("case", CHAIN, ids=[c[0] for c in CHAIN])
    @pytest.mark.parametrize("method", ["nearest", "bilinear"])
    def test_chain_resample(self, case, method):
        _, (h, w), (h2, w2), scale, vs = case
        x = _rng(h * w).rand(2, h, w).astype(np.float32)
        out = np.asarray(ops.upsample_disp(jnp.asarray(x), h2, w2, scale, vs,
                                           method))
        tex = g.tex_point if method == "nearest" else g.tex_linear
        ref = np.stack([g.upsample_disp(c, h2, w2, scale, vs, tex)
                        for c in x])
        if method == "nearest":
            np.testing.assert_array_equal(out, ref)
        else:
            np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)

    @pytest.mark.parametrize("src,dst,scale", [
        ((50, 130), (35, 91), g.SCALE),        # 2-D input
        ((200, 300), (7, 11), 27.0),           # output smaller than a tile
        ((1500, 700), (100, 46), 15.0),        # strong downscale
        ((1200, 256), (460, 100), 2.6),        # lane-aligned width, edge tap
    ])
    def test_extreme_shapes_nearest(self, src, dst, scale):
        x = _rng(src[0]).rand(*src).astype(np.float32)
        out = np.asarray(ops.subsample(jnp.asarray(x), *dst, scale))
        np.testing.assert_array_equal(out, g.subsample(x, *dst, scale))

    def test_lane_aligned_width_bilinear(self):
        x = _rng(12).rand(1200, 256).astype(np.float32)
        out = np.asarray(ops.subsample(jnp.asarray(x), 460, 100, 2.6,
                                       "bilinear"))
        ref = g.subsample(x, 460, 100, 2.6, g.tex_linear)
        # the device forms coordinates (up to ~1200 px here) in float32,
        # ~1.4e-4 px of rounding the float64 gold does not have
        np.testing.assert_allclose(out, ref, rtol=2e-4, atol=2e-4)

    def test_part_upsample_nearest(self):
        d = _rng(5).rand(68, 149).astype(np.float32)
        out = np.asarray(ops.part_upsample_disp(jnp.asarray(d), 97, 211,
                                                g.SCALE))
        np.testing.assert_array_equal(
            out, g.part_upsample_disp(d, 97, 211, g.SCALE))


class TestMatchLevelGold:
    """The level loop against the gold matchlevel: a short and a 22-
    iteration coarsest level, and a finer level with a carry-in field."""

    @pytest.mark.parametrize("level_index,is_coarsest,carry", [
        (2, True, 0.0), (6, True, 0.0), (1, False, 1.0)])
    def test_level(self, level_index, is_coarsest, carry):
        h, w = 12, 16
        rng = _rng(level_index)
        base = rng.rand(3, h, w + 2).astype(np.float32) * 255
        base = np.stack([g.conv_sep_zero(c, g.GAUSS) for c in base])
        left, right = base[:, :, 1:w + 1], base[:, :, :w]
        disp = np.zeros((3, h, w), np.float32)
        disp[0] = carry
        out = np.asarray(match_mod.match_level(
            jnp.asarray(left), jnp.asarray(right), jnp.asarray(disp),
            level_index, MatcherConfig(), is_coarsest))
        ref = gm.match_level(left, right, disp, level_index, is_coarsest)
        d = np.abs(out - ref)
        # lockstep from the same state; nearest-warp flips may amplify
        # float noise at isolated pixels (chaos rule), so bound the bulk
        assert np.quantile(d, 0.9) <= 2e-3, np.quantile(d, 0.9)
        assert np.all(np.isfinite(out))
