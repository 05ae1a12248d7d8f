"""Pure-python tests of bench.py's host-side helpers (no backend).

The bench is the driver's certification artifact; its plumbing —
cache-miss accounting, mode validation, scene construction — must not
be the thing that fails on the one run that counts."""

import json
import os
import subprocess
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(__file__)))
import bench  # noqa: E402


class TestCacheCounters:
    def test_delta_counts_and_names(self, tmp_path):
        c = bench._CacheCounters(str(tmp_path))
        snap = c.snapshot()
        c.listener("/jax/compilation_cache/compile_requests_use_cache")
        c.listener("/jax/compilation_cache/compile_requests_use_cache")
        c.listener("/jax/compilation_cache/cache_hits")
        c.listener("/jax/unrelated/event")  # ignored
        (tmp_path / "jit_foo-abc123-cache").write_bytes(b"x")
        d = c.delta(snap)
        assert d["cache_requests"] == 2
        assert d["cache_hits"] == 1
        assert d["cache_misses"] == 1
        assert d["cache_new_entries"] == ["jit_foo"]
        assert d["cache_warm"] is False

    def test_warm_when_no_new_entries(self, tmp_path):
        c = bench._CacheCounters(str(tmp_path))
        snap = c.snapshot()
        c.listener("/jax/compilation_cache/compile_requests_use_cache")
        c.listener("/jax/compilation_cache/cache_hits")
        d = c.delta(snap)
        assert d["cache_misses"] == 0 and d["cache_warm"] is True

    def test_missing_dir_is_tolerated(self, tmp_path):
        c = bench._CacheCounters(str(tmp_path / "never_created"))
        d = c.delta(c.snapshot())
        assert d["cache_warm"] is True


class TestModeValidation:
    def test_unknown_mode_rejected_before_jax(self):
        """A typo'd BENCH_MODE must produce a structured error line and
        rc=2 in under a minute — NOT fall through to the full 16MP
        suite."""
        env = dict(os.environ, BENCH_MODE="bogus")
        r = subprocess.run([sys.executable, "bench.py"],
                           capture_output=True, text=True, timeout=60,
                           env=env,
                           cwd=os.path.dirname(bench.__file__) or ".")
        assert r.returncode == 2, r.stdout + r.stderr
        payload = json.loads(r.stdout.strip().splitlines()[-1])
        assert payload["metric"] == "bench_env_FAILED"
        assert "bogus" in payload["error"]

    def test_mode_whitelist_covers_all_dispatch(self):
        # every mode main() dispatches on is in the whitelist, so no
        # valid name can hit the unknown-mode rejection
        for m in ("all", "mode1", "foveated", "mode1_bilinear",
                  "foveated_bilinear", "mode1_ee", "mode1_bilinear_ee",
                  "throughput", "foveated_throughput", "scaling"):
            assert m in bench._MODES


class TestBenchScene:
    def test_octave_texture_deterministic_and_full_range(self):
        a = bench._octave_texture(64, 96, seed=3)
        b = bench._octave_texture(64, 96, seed=3)
        np.testing.assert_array_equal(a, b)
        assert a.dtype == np.uint8
        assert a.min() == 0 and a.max() == 255

    def test_make_pair_is_constant_3px_shift(self):
        left, right = bench._make_pair(32, 48)
        # left = tex[:, 4:w+4], right = tex[:, 1:w+1]: right shifted
        # 3 px -> right[:, x+3] == left[:, x]
        np.testing.assert_array_equal(right[:, 3:], left[:, :-3])

    def test_make_pair_batched_seeds_differ(self):
        lb, rb = bench._make_pair(16, 24, batch=3)
        assert lb.shape == (3, 16, 24, 3)
        assert not np.array_equal(lb[0], lb[1])


class _FakePoint:
    def __init__(self, n_devices, eff, oversubscribed=False):
        self.n_devices = n_devices
        self.mesh_shape = (n_devices, 1)
        self.batch = n_devices
        self.pairs_per_second = 2.0 * n_devices * eff
        self.seconds_per_batch = 0.5
        self.scaling_efficiency = eff
        self.oversubscribed = oversubscribed


class _FakeJax:
    class _Dev:
        platform = "fake"
        device_kind = "FakeDevice"

    @staticmethod
    def devices():
        return [_FakeJax._Dev()]


class TestScalingHeadline:
    """_scaling's headline must never report another family's numbers
    under the dp label (a silently-wrong certified value is worse than a
    structured diagnostic)."""

    def _run(self, monkeypatch, modes_env, fake):
        from ug_stereomatcher.parallel import throughput as tp
        monkeypatch.setattr(tp, "measure_throughput", fake)
        monkeypatch.setenv("BENCH_SCALING_MODES", modes_env)
        monkeypatch.delenv("BENCH_H", raising=False)
        return bench._scaling(_FakeJax, 64, 96, 1)

    def test_dp_failure_yields_diagnostic_not_other_family(self, monkeypatch):
        def fake(mode="dp", **kw):
            if mode == "dp":
                raise RuntimeError("dp exploded")
            return [_FakePoint(1, 1.0), _FakePoint(2, 0.9)]

        out = self._run(monkeypatch, "dp,sp", fake)
        assert out["value"] == 0
        assert out["unit"].startswith("dp_")
        assert "dp exploded" in out["extra"]["curves"]["dp"]["error"]
        # sp's curve is still recorded as data, just not promoted
        assert len(out["extra"]["curves"]["sp"]) == 2

    def test_dp_less_run_labels_unit_by_actual_family(self, monkeypatch):
        def fake(mode="dp", **kw):
            return [_FakePoint(1, 1.0), _FakePoint(2, 0.8)]

        out = self._run(monkeypatch, "sp", fake)
        assert out["unit"].startswith("sp_")
        assert out["value"] == 0.8

    def test_dp_headline_skips_oversubscribed_points(self, monkeypatch):
        def fake(mode="dp", **kw):
            return [_FakePoint(1, 1.0), _FakePoint(2, 0.9),
                    _FakePoint(8, 0.4, oversubscribed=True)]

        out = self._run(monkeypatch, "dp", fake)
        assert out["unit"].startswith("dp_")
        assert out["value"] == 0.9
        assert out["extra"]["headline_devices"] == 2
