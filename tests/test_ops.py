"""Unit tests: JAX ops vs scalar NumPy gold models (SURVEY.md §2.2 op table)."""

import numpy as np
import pytest

import jax.numpy as jnp

from ug_stereomatcher import ops
from ug_stereomatcher.config import gaussian_kernel, average_kernel
from tests.gold import gold_ops as gold

RNG = np.random.RandomState(0)


def rand_img(h=13, w=17):
    return RNG.rand(h, w).astype(np.float32) * 255.0


class TestConv:
    def test_gaussian_zero_matches_gold(self):
        x = rand_img()
        ours = np.asarray(ops.blur_gaussian_zero(jnp.asarray(x)))
        ref = gold.conv_sep_zero(x, gold.GAUSS)
        np.testing.assert_allclose(ours, ref, rtol=1e-5, atol=1e-3)

    def test_gaussian_clamp_matches_gold(self):
        x = rand_img()
        ours = np.asarray(ops.blur_gaussian_clamp(jnp.asarray(x)))
        ref = gold.conv_sep_clamp(x, gold.GAUSS)
        np.testing.assert_allclose(ours, ref, rtol=1e-5, atol=1e-3)

    def test_average_clamp_matches_gold(self):
        x = rand_img()
        ours = np.asarray(ops.blur_average_clamp(jnp.asarray(x)))
        ref = gold.conv_sep_clamp(x, gold.AVG)
        np.testing.assert_allclose(ours, ref, rtol=1e-5, atol=1e-3)

    def test_average_kernel_attenuates(self):
        # taps are literal 0.3333 (sum 0.9999) — constant image attenuates
        x = jnp.ones((8, 8), jnp.float32)
        out = np.asarray(ops.blur_average_clamp(x))
        np.testing.assert_allclose(out, 0.9999 ** 2, rtol=1e-5)

    def test_batched_channels(self):
        x = RNG.rand(3, 9, 11).astype(np.float32)
        ours = np.asarray(ops.blur_gaussian_zero(jnp.asarray(x)))
        for c in range(3):
            ref = gold.conv_sep_zero(x[c], gold.GAUSS)
            np.testing.assert_allclose(ours[c], ref, rtol=1e-5, atol=1e-4)

    def test_kernel_values(self):
        k = gaussian_kernel()
        assert abs(k.sum() - 1.0) < 1e-6
        np.testing.assert_allclose(k[0], 0.0816475 / 0.9035905, rtol=1e-4)
        a = average_kernel()
        np.testing.assert_allclose(a, [0.0, 0.3333, 0.3333, 0.3333, 0.0])


class TestResample:
    @pytest.mark.parametrize("scale,oh,ow", [(1.41421356, 9, 12), (2.0, 6, 8)])
    def test_subsample_matches_gold(self, scale, oh, ow):
        x = rand_img(13, 17)
        ours = np.asarray(ops.subsample(jnp.asarray(x), oh, ow, scale))
        ref = gold.subsample(x, oh, ow, scale)
        np.testing.assert_array_equal(ours, ref)

    @pytest.mark.parametrize("scale,oh,ow", [(5.0, 4, 5), (2.5, 8, 10),
                                             (0.7, 19, 24)])
    def test_subsample_cubic_matches_gold(self, scale, oh, ow):
        # INTER_CUBIC parity for the resized-range-map path: the separable
        # static-weight op vs the scalar analytic Keys-kernel gold.
        x = rand_img(20, 25)
        ours = np.asarray(ops.subsample(jnp.asarray(x), oh, ow, scale,
                                        method="cubic"))
        ref = gold.subsample_cubic(x, oh, ow, scale)
        np.testing.assert_allclose(ours, ref, rtol=2e-5, atol=2e-5)

    def test_tex_gather_cubic_matches_gold(self):
        # the generic (non-separable) cubic path: random float coordinates
        rng = np.random.RandomState(3)
        x = rand_img(14, 18)
        xs = rng.rand(6, 7).astype(np.float32) * 20 - 1
        ys = rng.rand(6, 7).astype(np.float32) * 16 - 1
        ours = np.asarray(ops.tex_gather(jnp.asarray(x), jnp.asarray(xs),
                                         jnp.asarray(ys), method="cubic"))
        ref = np.array([[gold.tex_cubic(x, xs[i, j], ys[i, j])
                         for j in range(7)] for i in range(6)])
        # weights are computed in f32 on this path (vs the gold's f64)
        np.testing.assert_allclose(ours, ref, rtol=1e-4, atol=1e-4)

    def test_cubic_interpolates_exactly_on_linear_field(self):
        # Keys kernels reproduce affine functions exactly: resizing a plane
        # must return the plane (away from clamped borders).
        yy, xx = np.mgrid[0:16, 0:20].astype(np.float32)
        plane = 2.0 * xx + 3.0 * yy + 1.0
        out = np.asarray(ops.subsample(jnp.asarray(plane), 8, 10, 2.0,
                                       method="cubic"))
        yy2, xx2 = np.mgrid[0:8, 0:10].astype(np.float32)
        expect = 2.0 * ((xx2 + 0.5) * 2 - 0.5) + 3.0 * ((yy2 + 0.5) * 2 - 0.5) + 1.0
        np.testing.assert_allclose(out[1:-1, 1:-1], expect[1:-1, 1:-1],
                                   rtol=1e-5)

    def test_upsample_disp_matches_gold(self):
        x = rand_img(9, 12)
        ours = np.asarray(
            ops.upsample_disp(jnp.asarray(x), 13, 17, 1 / gold.SCALE, gold.SCALE))
        ref = gold.upsample_disp(x, 13, 17, 1 / gold.SCALE)
        np.testing.assert_allclose(ours, ref, rtol=1e-6)

    def test_part_upsample_matches_gold(self):
        x = rand_img(9, 12)
        ours = np.asarray(
            ops.part_upsample_disp(jnp.asarray(x), 13, 17, gold.SCALE))
        ref = gold.part_upsample_disp(x, 13, 17, gold.SCALE)
        np.testing.assert_allclose(ours, ref, rtol=1e-6)

    def test_warp_matches_gold(self):
        x = rand_img(11, 13)
        dx = (RNG.rand(11, 13).astype(np.float32) - 0.5) * 6
        dy = (RNG.rand(11, 13).astype(np.float32) - 0.5) * 6
        ours = np.asarray(
            ops.warp_by_disparity(jnp.asarray(x), jnp.asarray(dx), jnp.asarray(dy)))
        ref = gold.warp(x, dx, dy)
        np.testing.assert_array_equal(ours, ref)

    def test_warp_zero_disp_is_identity(self):
        x = rand_img(8, 9)
        z = np.zeros_like(x)
        ours = np.asarray(
            ops.warp_by_disparity(jnp.asarray(x), jnp.asarray(z), jnp.asarray(z)))
        np.testing.assert_array_equal(ours, x)

    @pytest.mark.parametrize("dx,dy", [(-1, 0), (1, 0), (0, -1), (0, 1), (0, 0)])
    def test_shift_matches_gold(self, dx, dy):
        x = rand_img(7, 9)
        ours = np.asarray(ops.shift_image(jnp.asarray(x), dx, dy))
        ref = gold.shift(x, dx, dy)
        np.testing.assert_array_equal(ours, ref)

    def test_shift_equals_tex_gather(self):
        x = rand_img(7, 9)
        for dx, dy in ((-1, 0), (1, 1), (0, 1)):
            a = np.asarray(ops.shift_image(jnp.asarray(x), dx, dy))
            h, w = x.shape
            xs = np.broadcast_to(np.arange(w)[None, :] + 0.5 + dx, (h, w)).astype(np.float32)
            ys = np.broadcast_to(np.arange(h)[:, None] + 0.5 + dy, (h, w)).astype(np.float32)
            b = np.asarray(ops.tex_gather(jnp.asarray(x), jnp.asarray(xs), jnp.asarray(ys)))
            np.testing.assert_array_equal(a, b)

    def test_bilinear_midpoint(self):
        x = np.array([[0.0, 1.0]], dtype=np.float32)
        # sampling at texel coordinate 1.0 (midpoint between centres 0.5, 1.5)
        v = np.asarray(ops.tex_gather(
            jnp.asarray(x), jnp.asarray([[1.0]]), jnp.asarray([[0.5]]),
            method="bilinear"))
        np.testing.assert_allclose(v, [[0.5]], atol=1e-6)


class TestPointwise:
    def test_correlation_ratio_matches_gold(self):
        h, w = 9, 11
        bc = RNG.rand(h, w).astype(np.float32)
        bl2 = RNG.rand(h, w).astype(np.float32) + 0.1
        bw2 = RNG.rand(h, w).astype(np.float32) + 0.1
        for (dx, dy) in ((-1, 0), (1, 0), (0, -1), (0, 1), (0, 0)):
            shifted = np.asarray(ops.shift_image(jnp.asarray(bw2), dx, dy))
            ours = np.asarray(ops.correlation_ratio(
                jnp.asarray(bc), jnp.asarray(bl2), jnp.asarray(shifted)))
            ref = gold.correlation_ratio(bc, bl2, bw2, dx, dy)
            np.testing.assert_allclose(ours, ref, rtol=1e-6)

    def test_correlation_ratio_clamps(self):
        ours = np.asarray(ops.correlation_ratio(
            jnp.asarray([[2.0]]), jnp.asarray([[1.0]]), jnp.asarray([[1.0]])))
        np.testing.assert_array_equal(ours, [[1.0]])
        # division by zero -> inf -> clamp to 1 (reference semantics)
        ours = np.asarray(ops.correlation_ratio(
            jnp.asarray([[1.0]]), jnp.asarray([[0.0]]), jnp.asarray([[1.0]])))
        np.testing.assert_array_equal(ours, [[1.0]])

    def test_parabola_matches_gold(self):
        h, w = 13, 11
        l = RNG.rand(h, w).astype(np.float32)
        c = RNG.rand(h, w).astype(np.float32)
        r = RNG.rand(h, w).astype(np.float32)
        for thr in (1.0, 0.55, 0.1):
            off_j, conf_j = ops.parabola_fit(
                jnp.asarray(l), jnp.asarray(c), jnp.asarray(r), thr)
            off_g, conf_g = gold.parabola_fit(l, c, r, thr)
            np.testing.assert_allclose(np.asarray(off_j), off_g, rtol=1e-5, atol=1e-6)
            np.testing.assert_allclose(np.asarray(conf_j), conf_g, rtol=1e-5, atol=1e-6)

    def test_parabola_no_peak(self):
        # c1 >= 0 (no maximum) -> offset 0, confidence 0.4
        off, conf = ops.parabola_fit(
            jnp.asarray([[0.0]]), jnp.asarray([[0.0]]), jnp.asarray([[1.0]]), 1.0)
        np.testing.assert_array_equal(np.asarray(off), [[0.0]])
        np.testing.assert_allclose(np.asarray(conf), [[0.4]])

    def test_parabola_symmetric_peak(self):
        # peak exactly at centre: offset 0, cstar = c
        off, conf = ops.parabola_fit(
            jnp.asarray([[0.5]]), jnp.asarray([[0.9]]), jnp.asarray([[0.5]]), 1.0)
        np.testing.assert_allclose(np.asarray(off), [[0.0]], atol=1e-7)
        np.testing.assert_allclose(np.asarray(conf), [[0.3 * 0.9 + 0.7]], rtol=1e-6)

    def test_blend_confidence(self):
        new = RNG.rand(5, 5).astype(np.float32) * 2
        old = RNG.rand(5, 5).astype(np.float32) * 2
        ours = np.asarray(ops.blend_confidence(jnp.asarray(new), jnp.asarray(old)))
        np.testing.assert_allclose(ours, gold.blend_confidence(new, old), rtol=1e-6)


class TestSmooth:
    def test_weighted_smooth_matches_gold(self):
        disp = rand_img(9, 11)
        conf = RNG.rand(9, 11).astype(np.float32) + 0.05
        ours = np.asarray(ops.weighted_smooth(jnp.asarray(disp), jnp.asarray(conf)))
        ref = gold.weighted_smooth(disp, conf)
        np.testing.assert_allclose(ours, ref, rtol=1e-5, atol=1e-4)

    def test_first_row_col_unchanged(self):
        disp = rand_img(6, 7)
        conf = np.ones_like(disp)
        out = np.asarray(ops.weighted_smooth(jnp.asarray(disp), jnp.asarray(conf)))
        np.testing.assert_array_equal(out[0, :], disp[0, :])
        np.testing.assert_array_equal(out[:, 0], disp[:, 0])

    def test_uniform_confidence_is_mean(self):
        disp = rand_img(6, 7)
        conf = np.ones_like(disp) * 0.5
        out = np.asarray(ops.weighted_smooth(jnp.asarray(disp), jnp.asarray(conf)))
        # interior pixel: plain 5-point mean
        m = (disp[2, 2] + disp[2, 1] + disp[2, 3] + disp[1, 2] + disp[3, 2]) / 5
        np.testing.assert_allclose(out[2, 2], m, rtol=1e-5)
