"""Match engine tests: level engine vs gold, end-to-end pipeline vs gold,
and behavioural property tests (SURVEY.md §4 test-pyramid plan)."""

import numpy as np
import pytest

import jax.numpy as jnp

from ug_stereomatcher import match as match_mod
from ug_stereomatcher import pyramid as pyr
from ug_stereomatcher.config import MatcherConfig
from ug_stereomatcher.engine import StereoEngine
from tests.gold import gold_match as gm



def synthetic_pair(h, w, shift_x=0.0, shift_y=0.0, pad=6, seed=21):
    """Smooth random pair where right(x + shift) == left(x).  Seeded per
    call: scenes must not depend on test execution order (xdist), and the
    gold comparisons are chaos-sensitive to the scene."""
    base = np.random.RandomState(seed).rand(
        3, h + 2 * pad, w + 2 * pad).astype(np.float32) * 255
    # Smooth it so correlation windows are informative
    from tests.gold import gold_ops as g
    base = np.stack([g.conv_sep_zero(c, g.GAUSS) for c in base])
    sx, sy = int(shift_x), int(shift_y)
    left = base[:, pad:pad + h, pad:pad + w]
    right = base[:, pad - sy:pad - sy + h, pad - sx:pad - sx + w]
    return left, right


class TestThresholdSchedule:
    def test_mi_22(self):
        cfg = MatcherConfig()
        s = cfg.threshold_schedule(22)
        # m=1..10 -> 1.0; then decay from m=11 (after update at m=10).
        assert s[:10] == tuple([1.0] * 10)
        np.testing.assert_allclose(s[10:12], [0.55, 0.55])
        np.testing.assert_allclose(s[12:14], [0.46, 0.46])
        np.testing.assert_allclose(s[20:22], [0.1, 0.1])
        np.testing.assert_allclose(s, gm_sched(22), rtol=1e-6)

    def test_small_mi(self):
        cfg = MatcherConfig()
        assert cfg.threshold_schedule(2) == (1.0, 1.0)
        np.testing.assert_allclose(cfg.threshold_schedule(4), (1.0, 1.0, 0.1, 0.1))
        np.testing.assert_allclose(cfg.threshold_schedule(6), gm_sched(6),
                                   rtol=1e-6)

    def test_iteration_counts(self):
        cfg = MatcherConfig()
        assert [cfg.iters_for_level(i) for i in range(8)] == \
            [2, 4, 6, 8, 10, 12, 22, 22]


def gm_sched(mi):
    return tuple(np.float32(v).item() for v in gm.threshold_schedule(mi))


class TestMatchLevel:
    @pytest.mark.parametrize("level_index,is_coarsest", [(0, False), (1, True)])
    def test_matches_gold(self, level_index, is_coarsest):
        h, w = 14, 18
        left, right = synthetic_pair(h, w, shift_x=1)
        disp = (np.random.RandomState(33).rand(
            3, h, w).astype(np.float32) - 0.5)
        disp[2] = np.abs(disp[2]) + 0.2  # plausible confidence
        cfg = MatcherConfig()
        ours = np.asarray(match_mod.match_level(
            jnp.asarray(left), jnp.asarray(right), jnp.asarray(disp),
            level_index, cfg, is_coarsest))
        ref = gm.match_level(left, right, disp, level_index, is_coarsest)
        np.testing.assert_allclose(ours, ref, rtol=2e-3, atol=2e-3)

    def test_zero_disparity_pair_stays_near_zero(self):
        h, w = 20, 24
        left, right = synthetic_pair(h, w)
        disp = np.zeros((3, h, w), dtype=np.float32)
        cfg = MatcherConfig()
        out = np.asarray(match_mod.match_level(
            jnp.asarray(left), jnp.asarray(left), jnp.asarray(disp),
            2, cfg, True))
        # Boundary pixels drift (zero-pad cross blurs vs clamp energy blurs
        # disagree at edges — inherent to the reference algorithm); the
        # interior must stay near zero.
        interior = (slice(4, -4), slice(4, -4))
        assert np.abs(out[0][interior]).max() < 0.3
        assert np.abs(out[1][interior]).max() < 0.3
        assert out[2][interior].mean() > 0.8  # identical pair -> confident


class TestEndToEnd:
    def test_pipeline_matches_gold_small(self):
        h, w = 24, 32
        left, right = synthetic_pair(h, w, shift_x=1)
        cfg = MatcherConfig()
        n = cfg.num_levels(h, w)
        lp = pyr.build_pyramid(jnp.asarray(left), cfg, n)
        rp = pyr.build_pyramid(jnp.asarray(right), cfg, n)
        res = match_mod.match_pyramid(lp, rp, cfg, (h, w), foveated=False)

        gl = gm.build_pyramid(left, n, h, w)
        gr = gm.build_pyramid(right, n, h, w)
        gres = gm.matching(gl, gr, h, w, foveated=False)

        for i in range(n):
            np.testing.assert_allclose(np.asarray(res.levels[i]), gres[i],
                                       rtol=5e-3, atol=5e-3)

    def test_constant_shift_recovered(self):
        h, w = 96, 128
        left, right = synthetic_pair(h, w, shift_x=2)
        eng = StereoEngine(MatcherConfig())
        res = eng.match(np.moveaxis(left, 0, -1), np.moveaxis(right, 0, -1))
        dh = np.asarray(res.disparity_h)[12:-12, 12:-12]
        dv = np.asarray(res.disparity_v)[12:-12, 12:-12]
        assert abs(np.median(dh) - 2.0) < 0.5
        assert abs(np.median(dv)) < 0.3
        assert np.asarray(res.confidence).mean() > 0.7

    def test_vertical_shift_recovered(self):
        h, w = 96, 128
        left, right = synthetic_pair(h, w, shift_y=1)
        eng = StereoEngine(MatcherConfig())
        res = eng.match(np.moveaxis(left, 0, -1), np.moveaxis(right, 0, -1))
        dv = np.asarray(res.disparity_v)[12:-12, 12:-12]
        assert abs(np.median(dv) - 1.0) < 0.5


class TestFoveated:
    def test_foveated_pipeline_matches_gold_lockstep(self):
        """Per-level lockstep comparison: both engines start each level from
        the gold state.  (Free-running end-to-end comparison is chaotic: the
        nearest-neighbour warp is discontinuous, so float32-vs-float64
        accumulation differences flip gather indices and diverge — the
        algorithm contract, not a bug.)"""
        h, w = 72, 96
        fovea_level = 3
        cfg = MatcherConfig(fovea_level=fovea_level)
        left, right = synthetic_pair(h, w, shift_x=1)
        n = cfg.num_levels(h, w)
        lp = pyr.build_pyramid(jnp.asarray(left), cfg, n)
        rp = pyr.build_pyramid(jnp.asarray(right), cfg, n)
        lf = pyr.foveate_pyramid(lp, cfg, (h, w))
        rf = pyr.foveate_pyramid(rp, cfg, (h, w))
        glf = [np.asarray(x) for x in lf]
        grf = [np.asarray(x) for x in rf]

        dims = match_mod.level_dims_for_matching(cfg, h, w, n, True)
        full_chain = cfg.dims_chain(h, w)
        fov = cfg.fovea_dims(h, w)
        disp = np.zeros((3,) + dims[n - 1], dtype=np.float32)
        for i in range(n - 1, -1, -1):
            if i < cfg.fovea_level - 1:
                assert dims[i] == fov
            ours = np.asarray(match_mod.match_level(
                lf[i], rf[i], jnp.asarray(disp), i, cfg, i == n - 1))
            gold = gm.match_level(glf[i], grf[i], disp, i, i == n - 1)
            d = np.abs(ours - gold)
            # tolerate isolated nearest-warp index flips within the level
            assert np.median(d) < 1e-3
            assert (d > 0.02).mean() < 0.02, f"level {i}"
            disp = gold
            if i > 0:
                if i >= cfg.fovea_level:
                    h2, w2 = dims[i - 1]
                    ours_up = np.asarray(pyr.upsample_to_level(
                        jnp.asarray(disp), h2, w2, cfg))
                    gold_up = np.stack([gm.g.upsample_disp(
                        p, h2, w2, 1.0 / gm.SCALE) for p in disp])
                else:
                    big_h, big_w = full_chain[cfg.fovea_level - 2]
                    ours_up = np.asarray(pyr.foveated_upsample(
                        jnp.asarray(disp), big_h, big_w, cfg))
                    up = np.stack([gm.g.upsample_disp(
                        p, big_h, big_w, 1.0 / gm.SCALE) for p in disp])
                    fh, fw = disp.shape[-2:]
                    lm = big_w // 2 - fw // 2
                    um = big_h // 2 - fh // 2
                    gold_up = up[:, um:um + fh, lm:lm + fw]
                np.testing.assert_allclose(ours_up, gold_up, rtol=1e-5,
                                           atol=1e-5)
                disp = gold_up

    def test_foveated_stack_engine(self):
        h, w = 72, 96
        cfg = MatcherConfig(fovea_level=3)
        left, right = synthetic_pair(h, w, shift_x=1)
        eng = StereoEngine(cfg)
        out = eng.match_foveated(np.moveaxis(left, 0, -1),
                                 np.moveaxis(right, 0, -1))
        fov_h, fov_w = cfg.fovea_dims(h, w)
        assert out.roi_height == fov_h and out.roi_width == fov_w
        assert out.num_levels == cfg.fovea_level
        assert out.stack_h.shape == (cfg.fovea_level * fov_h, fov_w)
        assert out.stack_left.shape == (cfg.fovea_level * 3 * fov_h, fov_w)
        # level accessor round-trips
        dh0, dv0, c0 = out.level_disparity(0)
        assert dh0.shape == (fov_h, fov_w)
        img0 = out.level_image(0)
        assert img0.shape == (3, fov_h, fov_w)

    def test_hierarchical_engine(self):
        h, w = 72, 96
        cfg = MatcherConfig(fovea_level=3)
        left, right = synthetic_pair(h, w, shift_x=1)
        eng = StereoEngine(cfg)
        res = eng.match_hierarchical(np.moveaxis(left, 0, -1),
                                     np.moveaxis(right, 0, -1))
        assert res.disparity_h.shape == (h, w)


class TestEarlyExit:
    """Opt-in convergence early exit (cfg.early_exit_delta) — the
    reference's dormant differenceIterations machinery
    (MatchGPULib.cpp:1323-1437) driving the level loop.  Parity default
    (None) is untouched; thr=0.0 runs the full schedule through the
    identical body (delta >= 0 always holds) — but XLA may fuse across
    while_loop differently than across scan (~1 ulp), and gather flips
    amplify that chaotically across a pyramid, so full-pipeline
    comparisons use the suite's quantile gates."""

    def test_threshold_zero_matches_parity(self):
        import dataclasses
        h, w = 96, 128
        left, right = synthetic_pair(h, w, shift_x=2)
        cfg = MatcherConfig(fovea_level=3)
        n = cfg.num_levels(h, w)
        lp = pyr.build_pyramid(jnp.asarray(left), cfg, n)
        rp = pyr.build_pyramid(jnp.asarray(right), cfg, n)
        ref = match_mod.match_pyramid(lp, rp, cfg, (h, w))
        cfg0 = dataclasses.replace(cfg, early_exit_delta=0.0)
        out = match_mod.match_pyramid(lp, rp, cfg0, (h, w))
        d = np.abs(np.asarray(out.levels[0]) - np.asarray(ref.levels[0]))
        assert np.median(d) < 1e-5, np.median(d)
        assert (d > 0.5).mean() < 0.02, (d > 0.5).mean()

    def test_early_exit_still_recovers_shift(self):
        import dataclasses
        h, w = 96, 128
        left, right = synthetic_pair(h, w, shift_x=2)
        cfg = dataclasses.replace(MatcherConfig(fovea_level=3),
                                  early_exit_delta=0.02)
        n = cfg.num_levels(h, w)
        lp = pyr.build_pyramid(jnp.asarray(left), cfg, n)
        rp = pyr.build_pyramid(jnp.asarray(right), cfg, n)
        out = match_mod.match_pyramid(lp, rp, cfg, (h, w))
        med = float(np.median(np.asarray(out.levels[0])[0, 12:-12, 12:-12]))
        assert 1.5 < med < 2.5, med

    def test_convergence_trace_matches_scan_bitwise(self):
        """level_convergence_trace runs the IDENTICAL body as the serving
        scan — outputs must agree bit-for-bit, and the (mi, 2) deltas are
        finite and nonnegative."""
        h, w = 64, 96
        left, right = synthetic_pair(h, w, shift_x=1)
        cfg = MatcherConfig(fovea_level=3)
        n = cfg.num_levels(h, w)
        lp = pyr.build_pyramid(jnp.asarray(left), cfg, n)
        rp = pyr.build_pyramid(jnp.asarray(right), cfg, n)
        dims = match_mod.level_dims_for_matching(cfg, h, w, n, False)
        hh, ww = dims[n - 1]
        disp = jnp.zeros((3, hh, ww), jnp.float32)
        t_out, deltas = match_mod.level_convergence_trace(
            lp[n - 1], rp[n - 1], disp, n - 1, cfg, True)
        s_out = match_mod.match_level(lp[n - 1], rp[n - 1], disp, n - 1,
                                      cfg, True)
        np.testing.assert_array_equal(np.asarray(t_out), np.asarray(s_out))
        d = np.asarray(deltas)
        assert d.shape == (cfg.iters_for_level(n - 1), 2)
        assert np.all(np.isfinite(d)) and np.all(d >= 0)

    def test_large_threshold_runs_one_iteration_per_level(self):
        """delta is initialised to +inf so at least one iteration always
        runs; a huge threshold then exits immediately — equivalent to a
        single-iteration schedule."""
        import dataclasses
        h, w = 64, 96
        left, right = synthetic_pair(h, w, shift_x=1)
        cfg = MatcherConfig(fovea_level=3)
        n = cfg.num_levels(h, w)
        lp = pyr.build_pyramid(jnp.asarray(left), cfg, n)
        rp = pyr.build_pyramid(jnp.asarray(right), cfg, n)
        dims = match_mod.level_dims_for_matching(cfg, h, w, n, False)
        hh, ww = dims[n - 1]
        disp = jnp.zeros((3, hh, ww), jnp.float32)
        cfg_big = dataclasses.replace(cfg, early_exit_delta=1e9)
        out = match_mod.match_level(lp[n - 1], rp[n - 1], disp, n - 1,
                                    cfg_big, True)
        # one full-schedule iteration, manually
        mi = cfg.iters_for_level(n - 1)
        thr = jnp.asarray(cfg.threshold_schedule(mi), jnp.float32)
        one = match_mod._match_level_scan(
            lp[n - 1], rp[n - 1], disp, cfg, True, 1,
            cfg.smooth_passes_for_level(n - 1), thr[:1])
        # while vs scan fusion differs at the ulp level (see class doc)
        np.testing.assert_allclose(np.asarray(out), np.asarray(one),
                                   atol=1e-5)

    def test_coarse_levels_keep_the_full_schedule(self):
        """Levels at coarse_min_index and above ignore early exit: a huge
        threshold there must change nothing."""
        import dataclasses
        h, w = 24, 32
        left, right = synthetic_pair(h, w, shift_x=1)
        cfg = MatcherConfig(coarse_min_index=1)
        disp = jnp.zeros((3, h, w), jnp.float32)
        args = (jnp.asarray(left), jnp.asarray(right), disp, 1)
        full = match_mod.match_level(*args, cfg, True)
        big = match_mod.match_level(
            *args, dataclasses.replace(cfg, early_exit_delta=1e9), True)
        np.testing.assert_array_equal(np.asarray(big), np.asarray(full))
        fine = match_mod.match_level(
            jnp.asarray(left), jnp.asarray(right), disp, 0,
            dataclasses.replace(cfg, early_exit_delta=1e9), True)
        ref = match_mod.match_level(jnp.asarray(left), jnp.asarray(right),
                                    disp, 0, cfg, True)
        assert not np.array_equal(np.asarray(fine), np.asarray(ref))
