"""Pyramid construction / foveation / resampling tests vs the gold model."""

import numpy as np

import jax.numpy as jnp

from ug_stereomatcher import pyramid as pyr
from ug_stereomatcher.config import MatcherConfig
from tests.gold import gold_match as gm

RNG = np.random.RandomState(7)


def test_dims_chain_matches_reference_truncation():
    cfg = MatcherConfig()
    dims = cfg.dims_chain(3264, 4928)
    # Reference-documented values: fovea (level 6) is 615 x 407 for a
    # 4928 x 3264 input (README.md:16; MatchGPULib.cpp:406-426).
    assert dims[0] == (3264, 4928)
    assert dims[6] == (407, 615)
    # Truncated chain differs from naive halving: int(int(4928/S)/S) = 2463.
    assert dims[2] == (1631, 2463)


def test_num_levels_16mp():
    cfg = MatcherConfig()
    assert cfg.num_levels(3264, 4928) == 14


def test_num_levels_small_image():
    cfg = MatcherConfig()
    n = cfg.num_levels(16, 22)
    assert n == 2  # (16,22), (11,15); next would be (7,10) < min_dim


def test_fovea_dims():
    cfg = MatcherConfig()
    assert cfg.fovea_dims(3264, 4928) == (407, 615)


def test_build_pyramid_matches_gold():
    cfg = MatcherConfig()
    h, w = 40, 56
    img = RNG.rand(3, h, w).astype(np.float32) * 255
    n = cfg.num_levels(h, w)
    ours = pyr.build_pyramid(jnp.asarray(img), cfg, n)
    ref = gm.build_pyramid(img, n, h, w)
    assert len(ours) == len(ref) == n
    for i in range(n):
        np.testing.assert_allclose(np.asarray(ours[i]), ref[i],
                                   rtol=1e-4, atol=1e-2)


def test_foveate_pyramid_matches_gold():
    cfg = MatcherConfig(fovea_level=3)
    h, w = 40, 56
    img = RNG.rand(3, h, w).astype(np.float32)
    n = cfg.num_levels(h, w)
    levels = pyr.build_pyramid(jnp.asarray(img), cfg, n)
    ours = pyr.foveate_pyramid(levels, cfg, (h, w))
    ref = gm.foveate([np.asarray(l) for l in levels], 3, h, w)
    fov_h, fov_w = cfg.fovea_dims(h, w)
    for i in range(n):
        assert ours[i].shape == ref[i].shape
        np.testing.assert_allclose(np.asarray(ours[i]), ref[i], rtol=1e-6)
        if i < cfg.fovea_level - 1:
            assert ours[i].shape[-2:] == (fov_h, fov_w)


def test_upsample_to_level_scales_values():
    cfg = MatcherConfig()
    disp = jnp.ones((3, 10, 14))
    up = pyr.upsample_to_level(disp, 14, 20, cfg)
    assert up.shape == (3, 14, 20)
    np.testing.assert_allclose(np.asarray(up), cfg.scale, rtol=1e-6)


def test_upsample_conf_scaling_quirk_flag():
    cfg = MatcherConfig(scale_conf_on_upsample=False)
    disp = jnp.ones((3, 10, 14))
    up = pyr.upsample_to_level(disp, 14, 20, cfg)
    np.testing.assert_allclose(np.asarray(up[:2]), cfg.scale, rtol=1e-6)
    np.testing.assert_allclose(np.asarray(up[2]), 1.0, rtol=1e-6)


def test_hierarchical_disparity_matches_gold():
    cfg = MatcherConfig(fovea_level=3)
    h, w = 40, 56
    dims = cfg.dims_chain(h, w)
    fov_h, fov_w = dims[cfg.fovea_level - 1]
    stack = [RNG.rand(3, fov_h, fov_w).astype(np.float32)
             for _ in range(cfg.fovea_level)]
    ours = pyr.hierarchical_disparity([jnp.asarray(s) for s in stack],
                                      cfg, (h, w))
    ref = gm.hierarchical(stack, 3, h, w)
    assert ours.shape == (3, h, w)
    np.testing.assert_allclose(np.asarray(ours), ref, rtol=1e-5, atol=1e-5)


def test_hierarchical_fovea_window_is_finest_level():
    cfg = MatcherConfig(fovea_level=3)
    h, w = 40, 56
    dims = cfg.dims_chain(h, w)
    fov_h, fov_w = dims[cfg.fovea_level - 1]
    stack = [np.full((3, fov_h, fov_w), float(i + 1), dtype=np.float32)
             for i in range(cfg.fovea_level)]
    out = np.asarray(pyr.hierarchical_disparity(
        [jnp.asarray(s) for s in stack], cfg, (h, w)))
    left = w // 2 - fov_w // 2
    upper = h // 2 - fov_h // 2
    np.testing.assert_allclose(
        out[:, upper:upper + fov_h, left:left + fov_w], 1.0)


def test_build_pyramid_pair_bit_identical_to_separate_builds():
    """The stacked (2C, H, W) pair build must equal two separate builds
    per channel exactly (the chain is channel-agnostic)."""
    cfg = MatcherConfig()
    h, w = 75, 103
    left = jnp.asarray(RNG.rand(3, h, w).astype(np.float32))
    right = jnp.asarray(RNG.rand(3, h, w).astype(np.float32))
    n = cfg.num_levels(h, w)
    lp, rp = pyr.build_pyramid_pair(left, right, cfg, n)
    lp_ref = pyr.build_pyramid(left, cfg, n)
    rp_ref = pyr.build_pyramid(right, cfg, n)
    assert len(lp) == len(lp_ref) == n
    for a, b in zip(lp, lp_ref):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    for a, b in zip(rp, rp_ref):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
