"""Evaluation harness + CLI tests."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from ug_stereomatcher import eval as ev
from ug_stereomatcher.config import MatcherConfig
from ug_stereomatcher.engine import StereoEngine
from ug_stereomatcher.io.image import save_image


class TestEpeMetrics:
    def test_zero_error(self):
        d = np.random.RandomState(0).rand(40, 50).astype(np.float32)
        r = ev.epe_metrics(d, d * 0, d, d * 0, margin=4)
        assert r.mean_epe == 0.0
        assert r.bad_0_5 == 0.0
        assert r.pixels == 32 * 42

    def test_known_offset(self):
        h = np.zeros((40, 50), np.float32)
        r = ev.epe_metrics(h + 1.0, h, h, h, margin=4)
        np.testing.assert_allclose(r.mean_epe, 1.0, rtol=1e-6)
        assert r.bad_0_5 == 1.0
        assert r.bad_3_0 == 0.0
        assert r.mean_abs_h == 1.0 and r.mean_abs_v == 0.0


class TestSyntheticScenes:
    @pytest.mark.parametrize("kind", ["constant", "vertical", "slant",
                                      "sine", "step"])
    def test_scene_shapes(self, kind):
        left, right, gt_h, gt_v = ev.synthetic_scene(kind, 64, 96,
                                                     magnitude=3.0)
        assert left.shape == (64, 96, 3) and right.shape == (64, 96, 3)
        assert gt_h.shape == (64, 96)
        assert np.abs(gt_h).max() <= 4.0 and np.abs(gt_v).max() <= 4.0

    def test_zero_disparity_means_identical(self):
        left, right, gt_h, gt_v = ev.synthetic_scene("constant", 32, 48,
                                                     magnitude=0.0)
        np.testing.assert_allclose(right.astype(float), left.astype(float),
                                   atol=1.0)

    def test_engine_beats_epe_threshold(self):
        eng = StereoEngine(MatcherConfig())
        reports = ev.evaluate_engine(eng, height=128, width=160,
                                     suite=(("constant", 3.0),))
        r = reports["constant"]
        # the matcher should recover a constant 3 px shift to subpixel EPE
        assert r.median_epe < 0.5, r.as_dict()
        assert r.mean_abs_v < 0.5


# Per-scene regression gates over the full A/B table:
# thresholds are ~1.5-2x the values measured by `python -m
# ug_stereomatcher eval` (docs/ACCURACY.md) — a regression on ANY scene
# kind, in either interp mode, fails CI.
_GATES = {
    # interp: {scene: (median_epe_max, bad_1_0_max)}
    # step: fronto-parallel depth discontinuity — full-frame gates
    # INCLUDING the band the plus-smoothing blurs (measured r4: nearest
    # 0.330/0.024, bilinear 0.023/0.009 at 192x256)
    "nearest": {"constant": (0.45, 0.03), "vertical": (0.45, 0.02),
                "slant": (0.45, 0.02), "sine": (0.45, 0.02),
                "step": (0.50, 0.05)},
    "bilinear": {"constant": (0.08, 0.03), "vertical": (0.08, 0.02),
                 "slant": (0.08, 0.02), "sine": (0.08, 0.02),
                 "step": (0.05, 0.02)},
}


@pytest.fixture(scope="module")
def ab_table():
    # one engine per interp over the full suite; ~60 s on the CPU backend
    return ev.accuracy_table(height=192, width=256)


class TestPerSceneAccuracyGates:
    @pytest.mark.parametrize("interp", ["nearest", "bilinear"])
    @pytest.mark.parametrize("scene", ["constant", "vertical", "slant",
                                       "sine", "step"])
    def test_scene_gate(self, ab_table, interp, scene):
        r = ab_table[interp][scene]
        med_max, bad1_max = _GATES[interp][scene]
        assert r.median_epe < med_max, (interp, scene, r.as_dict())
        assert r.bad_1_0 < bad1_max, (interp, scene, r.as_dict())

    def test_bilinear_strictly_better(self, ab_table):
        # the quality mode must beat parity mode on every scene (the
        # ACCURACY.md headline claim)
        for scene in _GATES["nearest"]:
            assert (ab_table["bilinear"][scene].median_epe
                    < ab_table["nearest"][scene].median_epe), scene


class TestEarlyExitAccuracy:
    """Accuracy gates behind the measured early-exit throughput claims
    (PERF.md, early exit): nearest at thr=0.1 and
    bilinear at thr=0.02 hold their parity-mode accuracy on the full
    suite (nearest/0.1 measured ~23% faster at 16MP; bilinear/0.1 was
    measured to DESTROY accuracy — 0.469 median, 48% >1px on constant —
    which is why its documented threshold is 5x tighter)."""

    @pytest.mark.parametrize("interp,thr", [("nearest", 0.1),
                                            ("bilinear", 0.02)])
    def test_early_exit_holds_suite_accuracy(self, interp, thr):
        eng = StereoEngine(MatcherConfig(interp=interp,
                                         early_exit_delta=thr))
        reports = ev.evaluate_engine(eng, height=192, width=256)
        for scene, r in reports.items():
            med_max, bad1_max = _GATES[interp][scene]
            # same thresholds as the parity-mode gates: early exit at
            # the documented thresholds must not cost measurable EPE
            assert r.median_epe < med_max, (interp, thr, scene,
                                            r.as_dict())
            assert r.bad_1_0 < max(bad1_max, 0.02), (interp, thr, scene,
                                                     r.as_dict())


class TestStressFamilies:
    """Real-scene stressors: occlusion with an
    exact no-correct-match mask, and photometric asymmetry between eyes.
    Gates measured round 5 at 192x256 (nearest 0.319/0.280 median EPE,
    conf 0.998 matched vs 0.844 occluded; bilinear 0.021/0.040, 0.999 vs
    0.888) with ~1.5-2x headroom."""

    # interp: (matched_median_max, photo_median_max)
    _GATES = {"nearest": (0.50, 0.50), "bilinear": (0.08, 0.10)}

    def test_occlusion_scene_contract(self):
        left, right, gt_h, gt_v, occ = ev.occlusion_scene(96, 128,
                                                          fg_disp=6)
        # exact correspondence holds at every NON-occluded pixel
        for y in (10, 50, 90):
            for x in range(4, 120):
                if occ[y, x]:
                    continue
                d = int(gt_h[y, x])
                if 0 <= x + d < 128:
                    np.testing.assert_array_equal(right[y, x + d],
                                                  left[y, x])
        # the occlusion band is exactly fg_disp - bg_disp wide, at the
        # strip's right edge
        assert occ.any()
        assert occ.sum(axis=1).max() == 6

    @pytest.mark.parametrize("interp", ["nearest", "bilinear"])
    def test_occlusion_gates(self, interp):
        eng = StereoEngine(MatcherConfig(interp=interp))
        r = ev.evaluate_occlusion(eng)
        med_max, _ = self._GATES[interp]
        assert r.matched_epe.median_epe < med_max, r.as_dict()
        assert r.matched_epe.bad_1_0 < 0.02, r.as_dict()
        # the confidence model's discriminative value: materially lower
        # where no correct match exists (first test of MatchLib.cu:884-933
        # as a *detector*, not just a blend weight)
        assert (r.mean_conf_occluded
                < r.mean_conf_matched - 0.05), r.as_dict()
        assert r.mean_conf_matched > 0.9, r.as_dict()

    @pytest.mark.parametrize("interp,tau,min_recall,max_fpr", [
        ("nearest", 1.0, 0.35, 0.01), ("bilinear", 0.5, 0.70, 0.02)])
    def test_lr_consistency_detects_occlusion(self, interp, tau,
                                              min_recall, max_fpr):
        """The production occlusion detector: LR cross-checking flags
        the no-correct-match band far more sharply than the confidence
        map's 0.11-0.15 separation (measured r5: nearest/tau=1.0
        recall 0.50 @ 0.2% FPR; bilinear/tau=0.5 recall 0.87 @ 0.6% —
        gates at ~0.7x those recalls).  Ties engine.match_with_
        consistency to ground truth for the first time."""
        eng = StereoEngine(MatcherConfig(interp=interp))
        left, right, gt_h, gt_v, occ = ev.occlusion_scene(192, 256,
                                                          fg_disp=8)
        _, mask, _ = eng.match_with_consistency(left, right, tau=tau)
        m = np.asarray(mask)
        sl = (slice(16, -16), slice(16, -16))
        occ_in, m_in = occ[sl], m[sl]
        clean = ~ev._dilate(occ | ev._disparity_edges(gt_h), 4)[sl]
        recall = float((~m_in[occ_in]).mean())
        fpr = float((~m_in[clean]).mean())
        assert recall > min_recall, (recall, fpr)
        assert fpr < max_fpr, (recall, fpr)

    @pytest.mark.parametrize("interp", ["nearest", "bilinear"])
    def test_photometric_gates(self, interp):
        eng = StereoEngine(MatcherConfig(interp=interp))
        left, right, gt_h, gt_v = ev.photometric_scene(192, 256)
        res = eng.match(left, right)
        rep = ev.epe_metrics(res.disparity_h, res.disparity_v, gt_h, gt_v,
                             margin=16)
        _, med_max = self._GATES[interp]
        # gain/bias/noise perturb only photometry; the NCC^2 correlation
        # must keep the field sub-pixel (graceful degradation, not
        # collapse)
        assert rep.median_epe < med_max, rep.as_dict()
        assert rep.bad_1_0 < 0.02, rep.as_dict()


class TestCli:
    def _pair(self, tmp_path):
        left, right, _, _ = ev.synthetic_scene("constant", 64, 96,
                                               magnitude=2.0)
        lp = str(tmp_path / "l.png")
        rp = str(tmp_path / "r.png")
        save_image(lp, left)
        save_image(rp, right)
        return lp, rp

    def _run(self, *argv):
        from ug_stereomatcher.cli import main
        import io
        from contextlib import redirect_stdout
        buf = io.StringIO()
        with redirect_stdout(buf):
            rc = main(list(argv))
        return rc, buf.getvalue()

    def test_match_command(self, tmp_path):
        lp, rp = self._pair(tmp_path)
        out = str(tmp_path / "out")
        rc, stdout = self._run("match", lp, rp, "-o", out)
        assert rc == 0
        payload = json.loads(stdout.strip().splitlines()[-1])
        assert os.path.exists(payload["outputs"]["H"])

    def test_batch_command(self, tmp_path):
        lp, rp = self._pair(tmp_path)
        man = tmp_path / "list.txt"
        man.write_text(f"{lp}\n{rp}\n")
        rc, stdout = self._run("batch", str(man), "-o",
                               str(tmp_path / "bout"))
        assert rc == 0
        payload = json.loads(stdout.strip().splitlines()[-1])
        assert payload["pair"] == 0

    def test_cloud_command(self, tmp_path):
        cal = "/root/reference/calibrations/calL.xml"
        if not os.path.exists(cal):
            pytest.skip("no reference calibration")
        lp, rp = self._pair(tmp_path)
        out = str(tmp_path / "c.pcd")
        rc, stdout = self._run("cloud", lp, rp, "--cal-left", cal,
                               "--cal-right", cal, "-o", out,
                               "--sampling", "2")
        assert rc == 0
        assert os.path.getsize(out) > 1000

    def test_eval_command(self):
        rc, stdout = self._run("eval", "--height", "64", "--width", "96",
                               "--interp", "nearest")
        assert rc == 0
        rows = [json.loads(l) for l in stdout.strip().splitlines()]
        assert {r["scene"] for r in rows} == {"constant", "vertical",
                                              "slant", "sine", "step"}
        assert all(r["interp"] == "nearest" for r in rows)

    def test_eval_markdown(self):
        rc, stdout = self._run("eval", "--height", "64", "--width", "96",
                               "--interp", "bilinear", "--markdown")
        assert rc == 0
        assert '## interp="bilinear"' in stdout
        assert "| scene | median EPE (px) |" in stdout

    def test_bad_args(self):
        with pytest.raises(SystemExit):
            self._run("match")  # missing positional args


class TestConfigFile:
    def test_yaml_roundtrip(self, tmp_path):
        from ug_stereomatcher.config import MatcherConfig
        p = tmp_path / "cfg.yaml"
        p.write_text("fovea_level: 3\ninterp: bilinear\nsmooth_passes: 7\n")
        cfg = MatcherConfig.from_file(str(p))
        assert cfg.fovea_level == 3
        assert cfg.interp == "bilinear"
        assert cfg.smooth_passes == 7
        assert cfg.max_level == 14  # defaults preserved

    def test_unknown_key_rejected(self, tmp_path):
        from ug_stereomatcher.config import MatcherConfig
        p = tmp_path / "cfg.json"
        p.write_text('{"fovae_level": 3}')  # typo
        with pytest.raises(ValueError, match="unknown config fields"):
            MatcherConfig.from_file(str(p))

    def test_cli_config_with_override(self, tmp_path):
        from ug_stereomatcher.eval import synthetic_scene
        from ug_stereomatcher.io.image import save_image
        left, right, _, _ = synthetic_scene("constant", 64, 96, magnitude=2.0)
        lp, rp = str(tmp_path / "l.png"), str(tmp_path / "r.png")
        save_image(lp, left)
        save_image(rp, right)
        cfgp = tmp_path / "cfg.yaml"
        cfgp.write_text("fovea_level: 6\n")
        from ug_stereomatcher.cli import main
        import io as _io
        from contextlib import redirect_stdout
        buf = _io.StringIO()
        with redirect_stdout(buf):
            rc = main(["match", lp, rp, "-o", str(tmp_path / "o"),
                       "--config", str(cfgp), "--fovea-level", "3"])
        assert rc == 0
