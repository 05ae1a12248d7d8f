"""Multi-device tests on the virtual 8-device CPU mesh (conftest.py).

Validates that the explicit halo-exchange / all-gather sharded engine is
*exactly* equivalent to the single-device engine — the correctness contract
that lets the same code scale over several cards.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P
from ug_stereomatcher import match as match_mod
from ug_stereomatcher import ops
from ug_stereomatcher import parallel as par
from ug_stereomatcher.config import MatcherConfig
from ug_stereomatcher.ops.conv import _GAUSS

def _rng(seed: int) -> np.random.RandomState:
    """Per-test generator: a shared module RNG makes scenes depend on
    execution ORDER (xdist / solo runs draw different data and the
    free-running comparisons are chaos-sensitive to the scene)."""
    return np.random.RandomState(seed)


def _smooth_scene(rng, c, h, w):
    """Spatially correlated scene — white noise decorrelates at coarse
    pyramid levels and drives the free-running chain chaotic (bench.py's
    octave-texture rationale)."""
    x = rng.rand(c, h, w).astype(np.float32) * 255
    for axis in (1, 2):
        x = 0.25 * np.roll(x, 1, axis) + 0.5 * x + 0.25 * np.roll(x, -1, axis)
    return x


def row_mesh(n):
    return Mesh(np.array(jax.devices()[:n]), axis_names=("rows",))


@pytest.fixture(scope="module")
def mesh4():
    assert len(jax.devices()) >= 4, "conftest should provide 8 CPU devices"
    return row_mesh(4)


def _run_sharded_conv(x, kernel, mesh, boundary, true_h):
    from functools import partial
    spec = P("rows", None)
    body = partial(par.sharded_conv_separable, kernel=kernel,
                   axis_name="rows", boundary=boundary, true_h=true_h)
    fn = jax.shard_map(body, mesh=mesh, in_specs=(spec,), out_specs=spec,
                       check_vma=False)
    return fn(x)


class TestHaloConv:
    @pytest.mark.parametrize("boundary", ["zero", "clamp"])
    def test_divisible_height(self, mesh4, boundary):
        x = _rng(100).rand(16, 10).astype(np.float32)
        ref = np.asarray(ops.conv_separable(jnp.asarray(x), _GAUSS, boundary))
        out = np.asarray(_run_sharded_conv(jnp.asarray(x), _GAUSS, mesh4,
                                           boundary, true_h=16))
        np.testing.assert_allclose(out, ref, rtol=1e-6, atol=1e-6)

    @pytest.mark.parametrize("boundary", ["zero", "clamp"])
    def test_padded_height(self, mesh4, boundary):
        # 14 rows over 4 shards -> local 4, 2 pad rows in the last shard
        true_h = 14
        x = _rng(101).rand(true_h, 10).astype(np.float32)
        ref = np.asarray(ops.conv_separable(jnp.asarray(x), _GAUSS, boundary))
        xp = np.pad(x, ((0, 2), (0, 0)))
        out = np.asarray(_run_sharded_conv(jnp.asarray(xp), _GAUSS, mesh4,
                                           boundary, true_h=true_h))
        np.testing.assert_allclose(out[:true_h], ref, rtol=1e-6, atol=1e-6)


class TestShardedLevel:
    def test_matches_unsharded_exactly(self, mesh4):
        h, w = 30, 26  # not divisible by 4 -> exercises pad refresh
        left = _rng(102).rand(3, h, w).astype(np.float32) * 255
        right = _rng(103).rand(3, h, w).astype(np.float32) * 255
        disp = (_rng(104).rand(3, h, w).astype(np.float32) - 0.5)
        cfg = MatcherConfig()
        ref = np.asarray(match_mod.match_level(
            jnp.asarray(left), jnp.asarray(right), jnp.asarray(disp),
            1, cfg, False))
        out = np.asarray(par.sharded_match_level(
            jnp.asarray(left), jnp.asarray(right), jnp.asarray(disp),
            1, cfg, False, mesh4))
        np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)

    def test_full_pair_matches_unsharded(self, mesh4):
        # Correlated scene + quantile bounds: the free-running chain
        # amplifies the sharded/unsharded float-contraction differences
        # through nearest-warp index flips at isolated pixels (repo chaos
        # rule) — white noise with an end-to-end max tolerance is flaky.
        h, w = 64, 48
        left = _smooth_scene(_rng(105), 3, h, w)
        right = _smooth_scene(_rng(106), 3, h, w)
        cfg = MatcherConfig()
        from ug_stereomatcher import pyramid as pyr
        n = cfg.num_levels(h, w)
        lp = pyr.build_pyramid(jnp.asarray(left), cfg, n)
        rp = pyr.build_pyramid(jnp.asarray(right), cfg, n)
        ref = match_mod.match_pyramid(lp, rp, cfg, (h, w))
        out = par.sharded_match_pair(jnp.asarray(left), jnp.asarray(right),
                                     cfg, mesh4, min_rows_per_shard=8)
        d = np.abs(np.asarray(out.levels[0]) - np.asarray(ref.levels[0]))
        assert np.quantile(d, 0.99) <= 1e-3, (np.quantile(d, 0.99), d.max())
        assert d.max() <= 0.05, d.max()


class TestShardedBuild:
    """Pyramid build + inter-level upsamples row-shard instead of
    replicating.  Nearest interp
    must be BIT-identical to the single-device ops (static index planning
    is the same float64 host arithmetic; gathers are pure selection)."""

    def test_build_pyramid_bit_identical(self, mesh4):
        h, w = 70, 52   # not divisible by 4: exercises in/out padding
        img = _rng(400).rand(3, h, w).astype(np.float32) * 255
        cfg = MatcherConfig()
        from ug_stereomatcher import pyramid as pyr
        n = cfg.num_levels(h, w)
        ref = pyr.build_pyramid(jnp.asarray(img), cfg, n)
        out = par.sharded_build_pyramid(jnp.asarray(img), cfg, n, mesh4,
                                        min_rows_per_shard=8)
        assert len(out) == n
        for i in range(n):
            np.testing.assert_array_equal(np.asarray(out[i]),
                                          np.asarray(ref[i]), err_msg=f"level {i}")

    def test_build_pyramid_bilinear_close(self, mesh4):
        h, w = 64, 48
        img = _rng(401).rand(3, h, w).astype(np.float32) * 255
        cfg = MatcherConfig(interp="bilinear")
        from ug_stereomatcher import pyramid as pyr
        n = cfg.num_levels(h, w)
        ref = pyr.build_pyramid(jnp.asarray(img), cfg, n)
        out = par.sharded_build_pyramid(jnp.asarray(img), cfg, n, mesh4,
                                        min_rows_per_shard=8)
        for i in range(n):
            np.testing.assert_allclose(np.asarray(out[i]),
                                       np.asarray(ref[i]),
                                       rtol=1e-4, atol=1e-3,
                                       err_msg=f"level {i}")

    @pytest.mark.parametrize("interp", ["nearest", "bilinear"])
    def test_upsample_to_level(self, mesh4, interp):
        cfg = MatcherConfig(interp=interp)
        disp = (_rng(402).rand(3, 33, 26).astype(np.float32) - 0.5) * 4
        from ug_stereomatcher import pyramid as pyr
        ref = np.asarray(pyr.upsample_to_level(jnp.asarray(disp), 47, 37,
                                               cfg))
        out = np.asarray(par.sharded_upsample_to_level(
            jnp.asarray(disp), 47, 37, cfg, mesh4, min_rows_per_shard=8))
        if interp == "nearest":
            np.testing.assert_array_equal(out, ref)
        else:
            np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)

    def test_upsample_conf_quirk_off(self, mesh4):
        cfg = MatcherConfig(scale_conf_on_upsample=False)
        disp = (_rng(403).rand(3, 32, 24).astype(np.float32) - 0.5) * 4
        from ug_stereomatcher import pyramid as pyr
        ref = np.asarray(pyr.upsample_to_level(jnp.asarray(disp), 45, 34,
                                               cfg))
        out = np.asarray(par.sharded_upsample_to_level(
            jnp.asarray(disp), 45, 34, cfg, mesh4, min_rows_per_shard=8))
        np.testing.assert_array_equal(out, ref)

    def test_small_output_replicated_path(self, mesh4):
        """Outputs below the sharding threshold run replicated inside
        shard_map and must still be bit-identical."""
        cfg = MatcherConfig()
        disp = (_rng(404).rand(3, 24, 18).astype(np.float32) - 0.5)
        from ug_stereomatcher import pyramid as pyr
        ref = np.asarray(pyr.upsample_to_level(jnp.asarray(disp), 30, 22,
                                               cfg))
        out = np.asarray(par.sharded_upsample_to_level(
            jnp.asarray(disp), 30, 22, cfg, mesh4,
            min_rows_per_shard=64))   # force the replicated body
        np.testing.assert_array_equal(out, ref)

    def test_sharded_blur_matches(self, mesh4):
        x = _rng(405).rand(3, 40, 28).astype(np.float32)
        from ug_stereomatcher import ops
        for boundary in ("zero", "clamp"):
            ref = np.asarray(ops.conv_separable(jnp.asarray(x),
                                                _GAUSS, boundary))
            out = np.asarray(par.sharded_blur(jnp.asarray(x), boundary,
                                              mesh4, min_rows_per_shard=8))
            np.testing.assert_allclose(out, ref, rtol=1e-6, atol=1e-6)


def _batch_pairs(rng, b, h, w):
    """Structured test pairs: right is a rolled left (matchable scene).
    Pure-noise pairs make the free-running comparison below needlessly
    chaotic (nearest-warp index flips on float noise — CLAUDE.md chaos
    rule); a matchable scene keeps the batch-vs-single comparison tight."""
    left = rng.rand(b, 3, h, w).astype(np.float32) * 255
    right = np.roll(left, 2, axis=-1)
    return left, right


class TestBatch:
    def test_batch_match_data_parallel(self):
        rng = np.random.RandomState(77)  # local: isolate from suite order
        mesh = par.make_mesh(n_pairs_axis=4, n_rows_axis=1)
        b, h, w = 4, 24, 32
        left, right = _batch_pairs(rng, b, h, w)
        cfg = MatcherConfig()
        out = np.asarray(par.batch_match(left, right, cfg, mesh))
        assert out.shape == (b, 3, h, w)
        # per-pair result equals single-pair path (quantile criteria: the
        # lax.map + shard_map graph fuses differently than the plain one,
        # and the free-running loop amplifies the float-contraction noise)
        from ug_stereomatcher import pyramid as pyr
        n = cfg.num_levels(h, w)
        lp = pyr.build_pyramid(jnp.asarray(left[0]), cfg, n)
        rp = pyr.build_pyramid(jnp.asarray(right[0]), cfg, n)
        ref = match_mod.match_pyramid(lp, rp, cfg, (h, w))
        d = np.abs(out[0] - np.asarray(ref.levels[0]))
        assert np.median(d) < 0.05
        assert (d > 0.5).mean() < 0.05

    def test_batch_not_divisible_by_pairs_axis(self):
        """Batches that don't divide the pairs axis pad with the last pair
        and slice back — results must still equal the single-pair path."""
        rng = np.random.RandomState(78)
        mesh = par.make_mesh(n_pairs_axis=4, n_rows_axis=1)
        b, h, w = 6, 24, 32
        left, right = _batch_pairs(rng, b, h, w)
        cfg = MatcherConfig()
        out = np.asarray(par.batch_match(left, right, cfg, mesh))
        assert out.shape == (b, 3, h, w)
        from ug_stereomatcher import pyramid as pyr
        n = cfg.num_levels(h, w)
        for i in (0, b - 1):
            lp = pyr.build_pyramid(jnp.asarray(left[i]), cfg, n)
            rp = pyr.build_pyramid(jnp.asarray(right[i]), cfg, n)
            ref = match_mod.match_pyramid(lp, rp, cfg, (h, w))
            d = np.abs(out[i] - np.asarray(ref.levels[0]))
            assert np.median(d) < 0.05
            assert (d > 0.5).mean() < 0.05

    def test_mesh_shape_heuristic(self):
        assert par.mesh_shape_for(8, n_pairs=16) == (8, 1)
        p, r = par.mesh_shape_for(8, n_pairs=2)
        assert p * r == 8 and p <= 2
        p, r = par.mesh_shape_for(8)
        assert p * r == 8


class TestHybridBatch:
    """batch < devices on a (pairs, rows) mesh: each pairs-group
    row-shards its pair across its rows-group — all devices do useful
    work."""

    def test_hybrid_matches_single_pair_no_warning(self):
        import warnings
        rng = np.random.RandomState(79)
        mesh = par.make_mesh(n_pairs_axis=2, n_rows_axis=4)
        b, h, w = 2, 64, 48
        left, right = _batch_pairs(rng, b, h, w)
        left = _smooth_scene(rng, 3 * b, h, w).reshape(b, 3, h, w)
        right = np.roll(left, 2, axis=-1)
        cfg = MatcherConfig()
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            out = np.asarray(par.batch_match(left, right, cfg, mesh))
        assert out.shape == (b, 3, h, w)
        from ug_stereomatcher import pyramid as pyr
        n = cfg.num_levels(h, w)
        for i in range(b):
            lp = pyr.build_pyramid(jnp.asarray(left[i]), cfg, n)
            rp = pyr.build_pyramid(jnp.asarray(right[i]), cfg, n)
            ref = match_mod.match_pyramid(lp, rp, cfg, (h, w))
            d = np.abs(out[i] - np.asarray(ref.levels[0]))
            assert np.median(d) < 0.05, (i, np.median(d))
            assert (d > 0.5).mean() < 0.05, (i, (d > 0.5).mean())

    def test_hybrid_chunks_uneven_batch(self):
        """batch > pairs axis: host loop walks pairs-sized chunks and the
        tail chunk pads with its last pair."""
        rng = np.random.RandomState(80)
        mesh = par.make_mesh(n_pairs_axis=2, n_rows_axis=4)
        b, h, w = 3, 48, 40
        left = _smooth_scene(rng, 3 * b, h, w).reshape(b, 3, h, w)
        right = np.roll(left, 1, axis=-1)
        cfg = MatcherConfig()
        out = np.asarray(par.batch_match(left, right, cfg, mesh))
        assert out.shape == (b, 3, h, w)
        from ug_stereomatcher import pyramid as pyr
        n = cfg.num_levels(h, w)
        for i in (0, b - 1):
            lp = pyr.build_pyramid(jnp.asarray(left[i]), cfg, n)
            rp = pyr.build_pyramid(jnp.asarray(right[i]), cfg, n)
            ref = match_mod.match_pyramid(lp, rp, cfg, (h, w))
            d = np.abs(out[i] - np.asarray(ref.levels[0]))
            assert np.median(d) < 0.05, (i, np.median(d))
            assert (d > 0.5).mean() < 0.05, (i, (d > 0.5).mean())


def _ref_fovea_stack(left, right, cfg):
    """Per-pair mode-2 reference: foveated coarse-to-fine, levels stacked
    level-major (the engine._match_foveated_impl math)."""
    from ug_stereomatcher import pyramid as pyr
    h, w = left.shape[-2:]
    n = cfg.num_levels(h, w)
    lp = pyr.build_pyramid(jnp.asarray(left), cfg, n)
    rp = pyr.build_pyramid(jnp.asarray(right), cfg, n)
    lf = pyr.foveate_pyramid(lp, cfg, (h, w))
    rf = pyr.foveate_pyramid(rp, cfg, (h, w))
    res = match_mod.match_pyramid(lf, rf, cfg, (h, w), foveated=True)
    return np.concatenate([np.asarray(res.levels[i])
                           for i in range(cfg.fovea_level)], axis=-2)


class TestFoveatedBatch:
    """Batched/DP mode 2: the Glasgow
    batch configuration in the reference's THROUGHPUT mode must shard over
    pairs (and rows, hybrid) like mode 1 does."""

    def test_dp_foveated_matches_single_pair(self):
        rng = np.random.RandomState(81)
        mesh = par.make_mesh(n_pairs_axis=4, n_rows_axis=1)
        b, h, w = 4, 96, 72
        cfg = MatcherConfig(fovea_level=3)
        left = _smooth_scene(rng, 3 * b, h, w).reshape(b, 3, h, w)
        right = np.roll(left, 2, axis=-1)
        out = np.asarray(par.batch_match(left, right, cfg, mesh,
                                         foveated=True))
        fh, fw = cfg.fovea_dims(h, w)
        assert out.shape == (b, 3, cfg.fovea_level * fh, fw)
        for i in (0, b - 1):
            ref = _ref_fovea_stack(left[i], right[i], cfg)
            d = np.abs(out[i] - ref)
            assert np.median(d) < 0.05, (i, np.median(d))
            assert (d > 0.5).mean() < 0.05, (i, (d > 0.5).mean())

    def test_hybrid_foveated_matches_single_pair(self):
        rng = np.random.RandomState(82)
        mesh = par.make_mesh(n_pairs_axis=2, n_rows_axis=4)
        b, h, w = 2, 96, 72
        cfg = MatcherConfig(fovea_level=3)
        left = _smooth_scene(rng, 3 * b, h, w).reshape(b, 3, h, w)
        right = np.roll(left, 2, axis=-1)
        out = np.asarray(par.batch_match(left, right, cfg, mesh,
                                         foveated=True))
        fh, fw = cfg.fovea_dims(h, w)
        assert out.shape == (b, 3, cfg.fovea_level * fh, fw)
        for i in range(b):
            ref = _ref_fovea_stack(left[i], right[i], cfg)
            d = np.abs(out[i] - ref)
            assert np.median(d) < 0.15, (i, np.median(d))
            assert (d > 0.5).mean() < 0.10, (i, (d > 0.5).mean())

    def test_engine_match_batch_foveated(self):
        rng = np.random.RandomState(83)
        from ug_stereomatcher import StereoEngine
        b, h, w = 2, 96, 72
        cfg = MatcherConfig(fovea_level=3)
        left = _smooth_scene(rng, 3 * b, h, w).reshape(b, 3, h, w)
        right = np.roll(left, 2, axis=-1)
        eng = StereoEngine(cfg)
        res = eng.match_batch(left, right, foveated=True)
        fh, fw = cfg.fovea_dims(h, w)
        assert res.stack_h.shape == (b, cfg.fovea_level * fh, fw)
        assert res.stack_left is None
        dh, dv, dc = res.level_disparity(1)
        assert dh.shape == (b, fh, fw)
        # per-pair equivalence with the single-pair engine entry point
        single = eng.match_foveated(left[0], right[0])
        d = np.abs(np.asarray(res.stack_h[0])
                   - np.asarray(single.stack_h))
        assert np.median(d) < 0.05
        assert (d > 0.5).mean() < 0.05


class TestShardedFoveated:
    def test_foveated_pair_matches_unsharded(self, mesh4):
        h, w = 96, 72
        cfg = MatcherConfig(fovea_level=3)
        left = _rng(118).rand(3, h, w).astype(np.float32) * 255
        right = _rng(119).rand(3, h, w).astype(np.float32) * 255
        from ug_stereomatcher import pyramid as pyr
        n = cfg.num_levels(h, w)
        lp = pyr.build_pyramid(jnp.asarray(left), cfg, n)
        rp = pyr.build_pyramid(jnp.asarray(right), cfg, n)
        lf = pyr.foveate_pyramid(lp, cfg, (h, w))
        rf = pyr.foveate_pyramid(rp, cfg, (h, w))
        ref = match_mod.match_pyramid(lf, rf, cfg, (h, w), foveated=True)
        out = par.sharded_match_pair(jnp.asarray(left), jnp.asarray(right),
                                     cfg, mesh4, min_rows_per_shard=8,
                                     foveated=True)
        # Per-level sharding is float-exact (TestShardedLevel), but a free
        # run across 7 levels amplifies float noise through the
        # discontinuous nearest warp — compare with quantile criteria, as
        # the gold end-to-end tests do.
        assert out.levels[n - 1].shape == ref.levels[n - 1].shape
        np.testing.assert_allclose(np.asarray(out.levels[n - 1]),
                                   np.asarray(ref.levels[n - 1]),
                                   rtol=1e-4, atol=1e-4)
        d = np.abs(np.asarray(out.levels[0]) - np.asarray(ref.levels[0]))
        assert np.median(d) < 0.15
        assert (d > 0.5).mean() < 0.10
        fov = cfg.fovea_dims(h, w)
        assert out.levels[0].shape[-2:] == fov
