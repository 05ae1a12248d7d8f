"""Row-sharded XLA level body and the row-take height pass on the virtual
8-device CPU mesh (conftest.py), against the single-device engine."""

import numpy as np
import pytest

import jax.numpy as jnp
from ug_stereomatcher import match as match_mod
from ug_stereomatcher import ops
from ug_stereomatcher import parallel as par
from ug_stereomatcher.config import MatcherConfig
from ug_stereomatcher.ops.conv import _GAUSS
from tests.test_sharding import _rng, _smooth_scene, mesh4  # noqa: F401


class TestShardedLevelShapes:
    """The row-sharded level body (halo exchange + all-gather warp) against
    the single-device level at the shapes and states the multi-device
    engine meets: non-default schedules, a coarsest level's first-iteration
    confidence replace, a field far outside the image, and a whole pair."""

    @pytest.mark.parametrize("h,w,level,coarsest,seed", [
        (64, 144, 1, False, 107), (64, 160, 6, True, 110),
        (16, 26, 1, False, 114)])
    def test_level_matches_unsharded(self, mesh4, h, w, level, coarsest,
                                     seed):
        left = _rng(seed).rand(3, h, w).astype(np.float32) * 255
        right = _rng(seed + 1).rand(3, h, w).astype(np.float32) * 255
        disp = (_rng(seed + 2).rand(3, h, w).astype(np.float32) - 0.5)
        if coarsest:
            disp[:] = 0.0
        cfg = MatcherConfig(level_cutoff=4)
        ref = np.asarray(match_mod.match_level(
            jnp.asarray(left), jnp.asarray(right), jnp.asarray(disp),
            level, cfg, coarsest))
        out = np.asarray(par.sharded_match_level(
            jnp.asarray(left), jnp.asarray(right), jnp.asarray(disp),
            level, cfg, coarsest, mesh4))
        np.testing.assert_allclose(out, ref, rtol=2e-4, atol=2e-4)

    def test_far_field_gathers_across_shards(self, mesh4):
        """One offset far outside the image in shard 0 and a vertical
        field that reads other shards' rows: the all-gather warp must give
        the single-device result."""
        h, w = 64, 144
        left = _rng(112).rand(3, h, w).astype(np.float32) * 255
        right = _rng(113).rand(3, h, w).astype(np.float32) * 255
        disp = np.zeros((3, h, w), np.float32)
        disp[0, 2, 3] = 900.0
        disp[1, 40:] = -30.0
        disp[2] = 0.5
        cfg = MatcherConfig()
        ref = np.asarray(match_mod.match_level(
            jnp.asarray(left), jnp.asarray(right), jnp.asarray(disp),
            0, cfg, False))
        out = np.asarray(par.sharded_match_level(
            jnp.asarray(left), jnp.asarray(right), jnp.asarray(disp),
            0, cfg, False, mesh4))
        np.testing.assert_allclose(out, ref, rtol=2e-4, atol=2e-4)

    def test_correlated_scene_lockstep(self, mesh4):
        h, w = 64, 144
        left = _smooth_scene(_rng(300), 3, h, w)
        right = _smooth_scene(_rng(301), 3, h, w)
        disp = (_rng(302).rand(3, h, w).astype(np.float32) - 0.5)
        cfg = MatcherConfig()
        ref = np.asarray(match_mod.match_level(
            jnp.asarray(left), jnp.asarray(right), jnp.asarray(disp),
            1, cfg, False))
        out = np.asarray(par.sharded_match_level(
            jnp.asarray(left), jnp.asarray(right), jnp.asarray(disp),
            1, cfg, False, mesh4))
        d = np.abs(out - ref)
        assert np.quantile(d, 0.99) <= 1e-3, (np.quantile(d, 0.99), d.max())
        assert d.max() <= 0.05, d.max()

    def test_shifted_pair_full_pipeline(self, mesh4):
        h, w = 64, 160
        left = _rng(117).rand(3, h, w).astype(np.float32) * 255
        right = np.roll(left, 2, axis=-1)
        cfg = MatcherConfig()
        from ug_stereomatcher import pyramid as pyr
        n = cfg.num_levels(h, w)
        lp = pyr.build_pyramid(jnp.asarray(left), cfg, n)
        rp = pyr.build_pyramid(jnp.asarray(right), cfg, n)
        ref = match_mod.match_pyramid(lp, rp, cfg, (h, w))
        out = par.sharded_match_pair(jnp.asarray(left), jnp.asarray(right),
                                     cfg, mesh4, min_rows_per_shard=8)
        d = np.abs(np.asarray(out.levels[0]) - np.asarray(ref.levels[0]))
        # free-running chaos rule: quantile criteria, not maxima
        assert np.median(d) < 0.05
        assert (d > 0.5).mean() < 0.05


class TestRowTakeHeightPass:
    """sharded_resample's height pass: per-shard row takes from a haloed
    block (nearest bit-identical to the single-device takes, bilinear the
    same 2-tap blend), for sharded and replicated inputs, up and down."""

    CASES = [((40, 30), (56, 42), 1 / 1.41421356),   # upsample, sharded in
             ((33, 26), (47, 37), 1 / 1.41421356),   # ragged rows
             ((70, 52), (49, 36), 1.41421356),       # build SCALE step
             ((70, 52), (35, 26), 2.0),              # build factor-2 step
             ((20, 16), (64, 48), 0.3125)]           # input replicated

    @pytest.mark.parametrize("src,dst,scale", CASES)
    @pytest.mark.parametrize("interp", ["nearest", "bilinear"])
    def test_matches_single_device(self, mesh4, src, dst, scale, interp):
        cfg = MatcherConfig(interp=interp)
        x = (_rng(src[0] * dst[0]).rand(3, *src).astype(np.float32) - 0.5)
        ref = np.asarray(ops.upsample_disp(jnp.asarray(x), *dst, scale, 1.5,
                                           interp))
        out = np.asarray(par.sharded_resample(
            jnp.asarray(x), *dst, lambda t: t * scale, 1.5, cfg, mesh4,
            min_rows_per_shard=4))
        assert out.shape == ref.shape
        if interp == "nearest":
            np.testing.assert_array_equal(out, ref)
        else:
            # taps from float64 host coordinates vs the single-device
            # float32 ones: ~1e-6 px apart at these sizes
            np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)

    def test_pairs_axis_batch(self):
        """Leading pairs axis (hybrid DP x SP): each pair resamples on its
        rows-group exactly as alone."""
        mesh = par.make_mesh(n_pairs_axis=2, n_rows_axis=4)
        cfg = MatcherConfig()
        x = _rng(9).rand(2, 3, 40, 30).astype(np.float32)
        s = 1 / 1.41421356
        ref = np.stack([np.asarray(ops.upsample_disp(jnp.asarray(p), 56, 42,
                                                     s, 1.41421356))
                        for p in x])
        out = np.asarray(par.sharded_resample(
            jnp.asarray(x), 56, 42, lambda t: t * s, 1.41421356, cfg, mesh,
            pairs_axis="pairs", min_rows_per_shard=4))
        np.testing.assert_array_equal(out, ref)

    @pytest.mark.parametrize("boundary", ["zero", "clamp"])
    def test_sharded_blur_large_block(self, mesh4, boundary):
        x = _rng(406).rand(3, 64, 144).astype(np.float32)
        ref = np.asarray(ops.conv_separable(jnp.asarray(x), _GAUSS,
                                            boundary))
        out = np.asarray(par.sharded_blur(jnp.asarray(x), boundary, mesh4,
                                          min_rows_per_shard=8))
        np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)
