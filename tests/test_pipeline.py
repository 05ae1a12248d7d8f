"""Pipeline tests: capture simulator, batch runner, service analog."""

import os

import numpy as np
import pytest

from ug_stereomatcher.config import MatcherConfig
from ug_stereomatcher.engine import StereoEngine
from ug_stereomatcher.io.image import save_image
from ug_stereomatcher.pipeline import (
    BatchRunner,
    CamerasSync,
    ImageListCapture,
)


@pytest.fixture
def manifest(tmp_path):
    rng = np.random.RandomState(4)
    paths = []
    for i in range(2):
        for side in ("left", "right"):
            p = tmp_path / f"{side}{i}.png"
            save_image(str(p), (rng.rand(48, 64, 3) * 255).astype(np.uint8))
            paths.append(str(p))
    mpath = tmp_path / "list.txt"
    mpath.write_text("\n".join(paths))
    return str(mpath)


class TestCapture:
    def test_capture_frames(self, manifest):
        cap = ImageListCapture(manifest)
        f1 = cap.capture(CamerasSync(time_stamp=0.0, data="full"))
        assert f1.left.shape == (48, 64, 3)
        assert f1.header.seq == 1
        f2 = cap.capture()
        assert f2.header.seq == 2
        # wrap-to-last-pair
        f3 = cap.capture()
        np.testing.assert_array_equal(f3.left, f2.left)

    def test_rejects_preview(self, manifest):
        cap = ImageListCapture(manifest)
        with pytest.raises(ValueError):
            cap.capture(CamerasSync(time_stamp=0.0, data="preview"))

    def test_capture_with_calibration(self, manifest):
        ref = "/root/reference/calibrations/calL.xml"
        if not os.path.exists(ref):
            pytest.skip("no reference calibration")
        cap = ImageListCapture(manifest, camera_info_left=ref,
                               camera_info_right=ref)
        f = cap.capture()
        assert f.camera_info_left.K.shape == (3, 3)


class TestBatchRunner:
    def test_run_all_pairs(self, manifest, tmp_path):
        runner = BatchRunner(StereoEngine(MatcherConfig()),
                             out_dir=str(tmp_path / "out"))
        results = runner.run(ImageListCapture(manifest))
        assert len(results) == 2
        for r in results:
            assert r.result.disparity_h.shape == (48, 64)
            assert r.match_seconds > 0
            assert r.dump_paths is not None
            assert os.path.exists(r.dump_paths["H"])

    def test_no_prefetch_path(self, manifest):
        runner = BatchRunner(StereoEngine(MatcherConfig()), prefetch=False)
        results = runner.run(ImageListCapture(manifest), max_pairs=1)
        assert len(results) == 1


class TestService:
    def test_get_disparities(self, manifest):
        eng = StereoEngine(MatcherConfig())
        cap = ImageListCapture(manifest)
        f = cap.capture()
        res = eng.get_disparities(f.left, f.right, foveated=False)
        assert res.disparity_h.shape == (48, 64)
