"""Convergence metric and undistortion tests."""

import numpy as np

import jax.numpy as jnp

from ug_stereomatcher.ops.convergence import (
    has_converged,
    weighted_difference,
)
from ug_stereomatcher.geom.undistort import (
    distort_normalized,
    undistort_pixels,
)


class TestConvergence:
    def test_weighted_difference_scalar_gold(self):
        from tests.gold import gold_ops as g
        rng = np.random.RandomState(0)
        new = rng.rand(9, 11).astype(np.float32)
        old = rng.rand(9, 11).astype(np.float32)
        conf = rng.rand(9, 11).astype(np.float32)
        gold = g.weighted_difference(new, old, conf)
        ours = float(weighted_difference(jnp.asarray(new), jnp.asarray(old),
                                         jnp.asarray(conf)))
        np.testing.assert_allclose(ours, gold, rtol=1e-6)

    def test_has_converged_threshold(self):
        z = jnp.zeros((5, 5))
        c = jnp.ones((5, 5))
        done, dh, dv = has_converged(z + 0.05, z, z + 0.02, z, c, 0.1)
        assert bool(done)
        done, _, _ = has_converged(z + 0.5, z, z, z, c, 0.1)
        assert not bool(done)


class TestUndistort:
    def _K(self):
        return np.array([[700.0, 0, 320.0], [0, 690.0, 240.0], [0, 0, 1.0]])

    def test_zero_distortion_is_identity(self):
        K = self._K()
        D = np.zeros(5)
        u = jnp.asarray(np.linspace(0, 640, 13))
        v = jnp.asarray(np.linspace(0, 480, 13))
        uu, vv = undistort_pixels(u, v, K, D)
        np.testing.assert_allclose(np.asarray(uu), np.asarray(u), atol=1e-5)
        np.testing.assert_allclose(np.asarray(vv), np.asarray(v), atol=1e-5)

    def test_round_trip(self):
        """distort(undistort(p)) == p for the reference's left-camera
        coefficients (calL.xml D)."""
        K = self._K()
        D = np.array([-0.0558, 0.5239, 0.0, 0.0, 0.0])
        rng = np.random.RandomState(2)
        u = jnp.asarray(rng.rand(50) * 600 + 20)
        v = jnp.asarray(rng.rand(50) * 440 + 20)
        uu, vv = undistort_pixels(u, v, K, D, iterations=12)
        # re-distort the undistorted normalised points
        x = (np.asarray(uu) - K[0, 2]) / K[0, 0]
        y = (np.asarray(vv) - K[1, 2]) / K[1, 1]
        xd, yd = distort_normalized(jnp.asarray(x), jnp.asarray(y), D)
        ur = np.asarray(xd) * K[0, 0] + K[0, 2]
        vr = np.asarray(yd) * K[1, 1] + K[1, 2]
        np.testing.assert_allclose(ur, np.asarray(u), atol=1e-3)
        np.testing.assert_allclose(vr, np.asarray(v), atol=1e-3)
