"""Auxiliary subsystem tests: profiling buckets, supervisor watchdog,
native runtime bindings."""

import os

import numpy as np
import pytest

from ug_stereomatcher.config import MatcherConfig
from ug_stereomatcher.engine import StereoEngine
from ug_stereomatcher.pipeline.supervisor import EngineSupervisor
from ug_stereomatcher.profiling import Timings, device_trace
from ug_stereomatcher import native


class TestTimings:
    def test_buckets(self):
        t = Timings()
        with t.bucket("a"):
            pass
        with t.bucket("a"):
            pass
        t.record("b", 1.5)
        s = t.summary()
        assert s["a"]["count"] == 2
        assert s["b"]["total_s"] == 1.5
        assert "a" in t.report()
        t.reset()
        assert t.summary() == {}

    def test_device_trace_degrades(self, tmp_path):
        with device_trace(str(tmp_path)):
            pass  # must not raise even if backend lacks tracing


class TestSupervisor:
    def _pair(self):
        rng = np.random.RandomState(0)
        img = (rng.rand(48, 64, 3) * 255).astype(np.uint8)
        return img, img

    def test_matches_and_counts(self):
        sup = EngineSupervisor(lambda: StereoEngine(MatcherConfig()))
        l, r = self._pair()
        res = sup.match(l, r)
        assert res.disparity_h.shape == (48, 64)
        assert sup.stats.frames == 1
        assert sup.stats.restarts == 0

    def test_input_errors_not_retried(self):
        sup = EngineSupervisor(lambda: StereoEngine(MatcherConfig()))
        with pytest.raises(ValueError):
            sup.match(np.zeros((5, 5)), np.zeros((5, 5)))
        assert sup.stats.restarts == 0

    def test_restart_on_runtime_failure(self):
        calls = {"n": 0}

        class FlakyEngine:
            def match(self, l, r):
                calls["n"] += 1
                if calls["n"] < 3:
                    raise RuntimeError("device lost")
                return StereoEngine(MatcherConfig()).match(l, r)

        sup = EngineSupervisor(lambda: FlakyEngine(), max_retries=2)
        l, r = self._pair()
        res = sup.match(l, r)
        assert res.disparity_h.shape == (48, 64)
        assert sup.stats.failures == 2
        assert sup.stats.restarts == 2

    def test_restart_every_frame_mode(self):
        sup = EngineSupervisor(lambda: StereoEngine(MatcherConfig()),
                               restart_every_frame=True)
        l, r = self._pair()
        sup.match(l, r)
        assert sup.stats.restarts == 1  # reference matcher.py behaviour


class TestNative:
    def test_build_and_pointcloud_roundtrip(self, tmp_path):
        if not native.available():
            pytest.skip("no native toolchain")
        rng = np.random.RandomState(3)
        xyz = rng.rand(500, 3).astype(np.float32)
        rgb = (rng.rand(500, 3) * 255).astype(np.uint8)
        pcd = str(tmp_path / "n.pcd")
        ply = str(tmp_path / "n.ply")
        native.write_pcd(pcd, xyz, rgb)
        native.write_ply(ply, xyz, rgb)

        # native output must be byte-identical to the NumPy writer
        from ug_stereomatcher.geom.pointcloud import (
            PointCloud, save_pcd, save_ply)
        pcd2 = str(tmp_path / "p.pcd")
        ply2 = str(tmp_path / "p.ply")
        save_pcd(pcd2, PointCloud(xyz=xyz, rgb=rgb))
        save_ply(ply2, PointCloud(xyz=xyz, rgb=rgb))
        assert open(pcd, "rb").read() == open(pcd2, "rb").read()
        assert open(ply, "rb").read() == open(ply2, "rb").read()

    def test_ppm_roundtrip(self, tmp_path):
        if not native.available():
            pytest.skip("no native toolchain")
        img = (np.random.RandomState(1).rand(10, 12, 3) * 255).astype(np.uint8)
        p = str(tmp_path / "x.ppm")
        native.write_ppm(p, img)
        np.testing.assert_array_equal(native.read_ppm(p), img)

    def test_prefetcher_order_and_content(self, tmp_path):
        files = []
        for i in range(5):
            p = tmp_path / f"f{i}.bin"
            p.write_bytes(bytes([i]) * (i + 1))
            files.append(str(p))
        pf = native.FilePrefetcher(files, capacity=2)
        got = list(pf)
        pf.close()
        assert [i for i, _ in got] == list(range(5))
        assert got[3][1] == bytes([3]) * 4
