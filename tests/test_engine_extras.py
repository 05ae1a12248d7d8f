"""Engine batch API, warmup, and visualisation tests."""

import os

import numpy as np
import pytest

from ug_stereomatcher.config import MatcherConfig
from ug_stereomatcher.engine import StereoEngine
from ug_stereomatcher.io import viz


class TestMatchBatch:
    def test_batch_hwc_inputs(self):
        rng = np.random.RandomState(0)
        b, h, w = 2, 48, 64
        left = (rng.rand(b, h, w, 3) * 255).astype(np.uint8)
        right = left.copy()
        eng = StereoEngine(MatcherConfig())
        res = eng.match_batch(left, right)
        assert res.disparity_h.shape == (b, h, w)
        # identical pairs -> small disparity (raw noise images drift more
        # than textured scenes; the EPE quality gate lives in test_eval_cli)
        assert float(np.abs(np.asarray(res.disparity_h))[:, 8:-8, 8:-8].mean()) < 0.5

    def test_batch_matches_single(self):
        rng = np.random.RandomState(1)
        h, w = 48, 64
        left = (rng.rand(1, h, w, 3) * 255).astype(np.uint8)
        right = (rng.rand(1, h, w, 3) * 255).astype(np.uint8)
        eng = StereoEngine(MatcherConfig())
        rb = eng.match_batch(left, right)
        rs = eng.match(left[0], right[0])
        np.testing.assert_allclose(np.asarray(rb.disparity_h[0]),
                                   np.asarray(rs.disparity_h),
                                   rtol=1e-4, atol=1e-4)

    def test_bad_batch_shapes(self):
        eng = StereoEngine(MatcherConfig())
        with pytest.raises(ValueError):
            eng.match_batch(np.zeros((48, 64, 3)), np.zeros((48, 64, 3)))
        with pytest.raises(ValueError):
            eng.match_batch(np.zeros((1, 48, 64, 3)),
                            np.zeros((2, 48, 64, 3)))


class TestWarmup:
    def test_warmup_then_match(self):
        eng = StereoEngine(MatcherConfig())
        eng.warmup(48, 64)
        assert ("match", 48, 64, eng.config) in eng._cache
        img = np.zeros((48, 64, 3), np.uint8)
        res = eng.match(img, img)
        assert res.disparity_h.shape == (48, 64)


class TestViz:
    def test_colorize_disparity_signs(self):
        d = np.array([[-5.0, 0.0, 5.0]], np.float32)
        rgb = viz.colorize_disparity(d, vmin=-5, vmax=5)
        assert rgb.shape == (1, 3, 3)
        assert rgb[0, 0, 2] == 255  # negative -> blue channel saturated
        assert rgb[0, 2, 0] == 255  # positive -> red channel saturated
        assert (rgb[0, 1] > 200).all()  # zero -> near white

    def test_colorize_handles_nan(self):
        d = np.array([[np.nan, 1.0]], np.float32)
        rgb = viz.colorize_disparity(d)
        assert rgb.shape == (1, 2, 3)

    def test_render_panel(self, tmp_path):
        eng = StereoEngine(MatcherConfig())
        img = (np.random.RandomState(3).rand(48, 64, 3) * 255).astype(np.uint8)
        res = eng.match(img, img)
        p = viz.render_panel(res, str(tmp_path / "panel.png"))
        assert os.path.exists(p)
        from ug_stereomatcher.io.image import load_image
        panel = load_image(p)
        assert panel.shape == (48, 64 * 3, 3)


class TestEngineMetrics:
    """StereoEngine instrumentation — the excutionTime-bucket analog
    (MatchGPULib.cpp:39, :1108-1117, :1265-1269)."""

    def _pair(self, h=64, w=96):
        rng = np.random.RandomState(3)
        left = (rng.rand(h, w, 3) * 255).astype(np.uint8)
        right = np.roll(left, 2, axis=1)
        return left, right

    def test_entry_point_buckets_populated(self):
        eng = StereoEngine(MatcherConfig(), sync_timing=True)
        left, right = self._pair()
        eng.match(left, right)
        eng.match(left, right)
        assert eng.metrics["match_s"] > 0
        s = eng.timings.summary()
        assert s["match"]["count"] == 2
        assert s["match"]["total_s"] >= eng.metrics["match_s"]

    def test_profile_match_breakdown(self):
        cfg = MatcherConfig()
        eng = StereoEngine(cfg)
        left, right = self._pair()
        res, prof = eng.profile_match(left, right)
        n = cfg.num_levels(64, 96)
        # one bucket per level, coarsest..finest, with match + upsample
        assert len(prof["levels"]) == n
        for i in range(n):
            lvl = prof["levels"][f"level_{i:02d}"]
            assert lvl["match_s"] > 0
            assert lvl["iterations"] == cfg.iters_for_level(i)
            if i > 0:
                assert "upsample_s" in lvl
        assert prof["pyramid_build_s"] > 0
        assert prof["total_s"] >= prof["match_total_s"]
        assert eng.metrics["profile"] is prof
        # staged results match the fused-jit entry point (chaos rule:
        # quantile tolerance, not maxima)
        base = eng.match(left, right)
        dh_a = np.asarray(res.disparity_h)
        dh_b = np.asarray(base.disparity_h)
        assert np.quantile(np.abs(dh_a - dh_b), 0.9) < 0.35
        assert abs(np.median(dh_a) - np.median(dh_b)) < 0.1
