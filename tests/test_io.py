"""IO tests: images, manifests (reference XML schema + wrap semantics),
result dumps, calibration-driven capture."""

import os

import numpy as np
import pytest

from ug_stereomatcher import io as uio
from ug_stereomatcher.engine import MatchResult, FoveatedStackResult

REF_LIST = "/root/reference/src/utils/input_images.xml"


class TestImage:
    def test_round_trip_png(self, tmp_path):
        img = (np.random.RandomState(0).rand(8, 9, 3) * 255).astype(np.uint8)
        p = str(tmp_path / "x.png")
        uio.save_image(p, img)
        back = uio.load_image(p)
        np.testing.assert_array_equal(back, img)

    def test_round_trip_float_tiff(self, tmp_path):
        data = np.random.RandomState(1).rand(6, 7).astype(np.float32)
        p = str(tmp_path / "d.tif")
        uio.save_float_tiff(p, data)
        from PIL import Image
        back = np.asarray(Image.open(p))
        np.testing.assert_array_equal(back, data)

    def test_npy_passthrough(self, tmp_path):
        img = np.zeros((4, 5, 3), np.uint8)
        p = str(tmp_path / "x.npy")
        uio.save_image(p, img)
        np.testing.assert_array_equal(uio.load_image(p), img)


class TestManifest:
    @pytest.mark.skipif(not os.path.exists(REF_LIST),
                        reason="reference manifest unavailable")
    def test_reference_xml_schema(self):
        lst = uio.load_image_list(REF_LIST)
        assert lst.paths == ["./left.tif", "./right.tif"]
        assert lst.pairs() == [("./left.tif", "./right.tif")]

    def test_wrap_to_last_pair(self, tmp_path):
        p = tmp_path / "list.txt"
        p.write_text("l1\nr1\nl2\nr2\n")
        lst = uio.load_image_list(str(p))
        assert lst.next_pair() == ("l1", "r1")
        assert lst.next_pair() == ("l2", "r2")
        # settings.h:33-38: past the end, restart at next-to-last entry
        assert lst.next_pair() == ("l2", "r2")
        assert lst.next_pair() == ("l2", "r2")

    def test_json_manifest(self, tmp_path):
        p = tmp_path / "m.json"
        p.write_text('["a", "b"]')
        assert uio.load_image_list(str(p)).paths == ["a", "b"]


class TestDumps:
    def test_save_disparity_maps(self, tmp_path):
        r = MatchResult(disparity_h=np.ones((4, 5), np.float32),
                        disparity_v=np.zeros((4, 5), np.float32),
                        confidence=np.full((4, 5), 0.5, np.float32))
        paths = uio.save_disparity_maps(r, str(tmp_path), prefix="t")
        assert sorted(paths) == ["C", "H", "V"]
        for p in paths.values():
            assert os.path.exists(p)

    def test_save_foveated_stack(self, tmp_path):
        s = FoveatedStackResult(
            stack_h=np.ones((12, 5), np.float32),
            stack_v=np.ones((12, 5), np.float32),
            stack_c=np.ones((12, 5), np.float32),
            stack_left=np.ones((36, 5), np.float32),
            stack_right=np.ones((36, 5), np.float32),
            im_width=20, im_height=16, roi_width=5, roi_height=4,
            num_levels=3)
        paths = uio.save_foveated_stack(s, str(tmp_path))
        assert sorted(paths) == ["FC", "FH", "FV"]


class TestManifestValidation:
    def test_odd_length_list_rejected(self, tmp_path):
        from ug_stereomatcher.io.manifest import ImageList
        import pytest as _pytest
        with _pytest.raises(ValueError, match="whole left/right pairs"):
            ImageList(["l1.png", "r1.png", "l2.png"])

    def test_skip_pair_advances(self):
        from ug_stereomatcher.io.manifest import ImageList
        il = ImageList(["l1", "r1", "l2", "r2"])
        il.skip_pair()
        assert il.next_pair() == ("l2", "r2")


class TestWritePpmValidation:
    def test_rejects_grayscale(self, tmp_path):
        import numpy as np
        import pytest as _pytest
        from ug_stereomatcher.native.bindings import write_ppm
        with _pytest.raises(ValueError, match=r"\(H, W, 3\)"):
            write_ppm(str(tmp_path / "x.ppm"), np.zeros((4, 6), np.uint8))

    def test_header_comment_sharing_line(self, tmp_path):
        import numpy as np
        from ug_stereomatcher.native.bindings import read_ppm
        img = np.arange(4 * 6 * 3, dtype=np.uint8).reshape(4, 6, 3)
        f = tmp_path / "c.ppm"
        with open(f, "wb") as fh:
            fh.write(b"P6\n6 4 # scanner output\n255\n")
            fh.write(img.tobytes())
        out = read_ppm(str(f))
        np.testing.assert_array_equal(out, img)
