"""Left-right consistency tests."""

import numpy as np

import jax.numpy as jnp

from ug_stereomatcher.config import MatcherConfig
from ug_stereomatcher.engine import StereoEngine
from ug_stereomatcher.ops.consistency import (
    apply_consistency,
    lr_consistency_mask,
)
from ug_stereomatcher.eval import synthetic_scene


class TestMaskMath:
    def test_perfectly_consistent_fields(self):
        h, w = 20, 30
        d = np.full((h, w), 3.0, np.float32)
        z = np.zeros((h, w), np.float32)
        # forward +3 everywhere, backward -3 everywhere -> error 0
        mask, err = lr_consistency_mask(jnp.asarray(d), jnp.asarray(z),
                                        jnp.asarray(-d), jnp.asarray(z))
        assert bool(np.all(np.asarray(mask)))
        np.testing.assert_allclose(np.asarray(err), 0.0, atol=1e-6)

    def test_inconsistent_fields_flagged(self):
        h, w = 20, 30
        d = np.full((h, w), 3.0, np.float32)
        z = np.zeros((h, w), np.float32)
        wrong = np.full((h, w), 2.0, np.float32)   # backward says -(-2) != 3
        mask, err = lr_consistency_mask(jnp.asarray(d), jnp.asarray(z),
                                        jnp.asarray(wrong), jnp.asarray(z),
                                        tau=1.0)
        assert not bool(np.any(np.asarray(mask)))
        np.testing.assert_allclose(np.asarray(err), 5.0, atol=1e-6)

    def test_apply_consistency(self):
        d = jnp.ones((4, 5))
        m = jnp.asarray(np.eye(4, 5, dtype=bool))
        out = np.asarray(apply_consistency(d, m, fill_value=-1.0))
        assert out[0, 0] == 1.0 and out[0, 1] == -1.0


class TestEngineConsistency:
    def test_synthetic_scene_mostly_consistent(self):
        left, right, _, _ = synthetic_scene("constant", 128, 160,
                                            magnitude=3.0)
        eng = StereoEngine(MatcherConfig())
        fwd, mask, err = eng.match_with_consistency(left, right, tau=1.0)
        m = np.asarray(mask)[16:-16, 16:-16]
        assert m.mean() > 0.9  # textured constant-shift scene: consistent
        assert fwd.disparity_h.shape == (128, 160)
