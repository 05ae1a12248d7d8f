"""Host-side helpers of chip_smoke.py, the compile-cache helper, and the
rule that no code path is chosen by the backend JAX runs on."""

import ast
import json
import os
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
import chip_smoke as cs  # noqa: E402


class TestRefusal:
    def test_cpu_backend_exits_nonzero_without_result(self):
        env = dict(os.environ, JAX_PLATFORMS="cpu")
        r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                           env=env, capture_output=True, text=True,
                           timeout=120)
        assert r.returncode != 0
        assert '"ok"' not in r.stdout
        assert "not a GPU" in r.stderr

    def test_require_gpu(self):
        cs.require_gpu("gpu")
        for backend in ("cpu", "rocm"):
            with pytest.raises(SystemExit):
                cs.require_gpu(backend)


class TestOutputFormat:
    def test_last_line_is_exactly_the_contract(self):
        line = cs.last_line("gpu", "NVIDIA H100 80GB HBM3", 1)
        assert json.loads(line) == {"ok": True, "device": {
            "platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1}}
        assert "\n" not in line

    @pytest.mark.parametrize("line,name,limit", [
        ("NVIDIA H100 80GB HBM3, 700.00 W", "NVIDIA H100 80GB HBM3",
         "700.00 W"),
        ("NVIDIA H100 80GB HBM3, 400.00 W\n", "NVIDIA H100 80GB HBM3",
         "400.00 W"),
        ("NVIDIA H200, [N/A]", "NVIDIA H200", "[N/A]"),
    ])
    def test_parse_gpu_line(self, line, name, limit):
        assert cs.parse_gpu_line(line.strip()) == {"name": name,
                                                   "power_limit": limit}

    def test_parse_gpu_line_rejects_garbage(self):
        with pytest.raises(ValueError):
            cs.parse_gpu_line("no separator here")

    def test_reporter_names_card_and_raises_on_failed_check(self, capsys):
        class FakeDev:
            def memory_stats(self):
                return {"peak_bytes_in_use": 123}

        class FakeJax:
            @staticmethod
            def devices():
                return [FakeDev()]

        rep = cs.Reporter(FakeJax, "CARD, 1 W")
        rep.emit("p", check={"ok": True})
        rec = json.loads(capsys.readouterr().out)
        assert rec["gpu"] == "CARD, 1 W" and rec["peak_bytes_in_use"] == 123
        with pytest.raises(RuntimeError, match="check"):
            rep.emit("q", check={"ok": False})


def _field(h=200, w=300, err=0.0, dv=0.0, seed=0):
    rng = np.random.RandomState(seed)
    dh = cs.SHIFT + err * (rng.rand(h, w) - 0.5) * 2
    return dh, np.full((h, w), dv)


class TestValueGates:
    @pytest.mark.parametrize("interp,err,dv,ok", [
        ("nearest", 0.6, 0.2, True),     # |err| ~ U(0, .6): median .3
        ("nearest", 1.2, 0.2, False),    # median .6 > .5
        ("nearest", 0.2, 0.6, False),    # mean |dv| > .5
        ("bilinear", 0.1, 0.02, True),
        ("bilinear", 0.6, 0.02, False),  # a nearest-grade field fails
        ("nearest", 4.0, 0.0, False),    # frac within 1 px < 0.9
    ])
    def test_gates(self, interp, err, dv, ok):
        dh, dvf = _field(err=err, dv=dv)
        assert cs.value_gates(dh, dvf, interp)["ok"] is ok

    def test_border_is_ignored(self):
        dh, dv = _field()
        dh[:10] = 50.0                    # inside the cropped border
        assert cs.value_gates(dh, dv, "nearest")["ok"]

    def test_batch_gated_pair_by_pair(self):
        a, v = _field()
        b, _ = _field(err=4.0, seed=1)
        g = cs.value_gates(np.stack([a, b]), np.stack([v, v]), "nearest")
        assert g["pairs"] == 2 and not g["ok"]


class TestComparisons:
    def test_close_check_relative_to_reference_scale(self):
        ref = np.array([100.0, -50.0])
        assert cs.close_check(ref + 1e-4, ref)["ok"]
        assert not cs.close_check(ref + 1e-2, ref)["ok"]
        assert not cs.close_check(np.array([np.nan, 0.0]), ref)["ok"]

    def test_nearest_flip_allowed_only_at_texel_edge(self):
        ref = np.zeros((2, 4, 5), np.float32)
        out = ref.copy()
        out[:, 1, 2] = 1.0
        xs = np.full((4, 5), 10.3)
        ys = np.full((4, 5), 7.6)
        assert not cs.nearest_check(out, ref, xs, ys)["ok"]
        xs[1, 2] = 11.00004               # within 1e-4 px of an edge
        chk = cs.nearest_check(out, ref, xs, ys)
        assert chk["ok"] and chk["pixels_differing"] == 1
        assert not cs.nearest_check(out, ref)["ok"]   # resamples: exact

    def test_quantile_gates_ignore_isolated_flips(self):
        ref = np.zeros((100, 100))
        out = ref.copy()
        out[0, :5] = 3.0                  # 5 flipped pixels of 10^4
        assert cs.quantile_gates(out, ref, *cs.LOCKSTEP_GATES)["ok"]
        out[:20] = 3.0
        assert not cs.quantile_gates(out, ref, *cs.LOCKSTEP_GATES)["ok"]


class TestTraceReduction:
    @pytest.mark.parametrize("intervals,total", [
        ([], 0.0), ([(0, 10)], 10.0), ([(0, 10), (5, 15)], 15.0),
        ([(20, 30), (0, 10)], 20.0), ([(0, 10), (2, 3), (10, 12)], 12.0)])
    def test_interval_union(self, intervals, total):
        assert cs.interval_union_ns(intervals) == total

    def test_scope_map_reads_named_scopes_from_compiled_hlo(self):
        import jax
        import jax.numpy as jnp

        def f(x):
            with jax.named_scope("level_03"):
                with jax.named_scope("warp"):
                    y = jnp.sin(x) * 2
                with jax.named_scope("smooth"):
                    y = jnp.cumsum(y)
            return y

        hlo = jax.jit(f).lower(jnp.ones(64)).compile().as_text()
        scopes = cs.scope_map(hlo)
        found = {cs.attribute(ops) for ops in scopes.values()}
        assert ("level_03", "smooth") in found or \
            ("level_03", "warp") in found

    def test_scope_map_gpu_text_with_backend_config(self):
        """XLA:GPU prints a JSON backend_config after the metadata; the
        op_name must still be found, and a fusion without one takes its
        fused body's scopes."""
        hlo = """HloModule jit_mode1

%fused_add.44 (param_0: f32[8]) -> f32[8] {
  %param_0 = f32[8]{0} parameter(0)
  ROOT %add.1 = f32[8]{0} add(%param_0, %param_0), metadata={op_name="jit(mode1)/level_01/while/body/smooth/add" source_file="/x.py" source_line=3}
}

ENTRY %main.9 (p: f32[8]) -> f32[8] {
  %p = f32[8]{0} parameter(0)
  %loop_add_fusion.44 = f32[8]{0} fusion(%p), kind=kLoop, calls=%fused_add.44, backend_config={"operation_queue_id":"0","fusion_backend_config":{"kind":"__loop"}}
  ROOT %gather.2 = f32[8]{0} gather(%loop_add_fusion.44), metadata={op_name="jit(mode1)/level_00/while/body/warp/gather" source_file="/y.py"}, backend_config={"x":"y"}
}
"""
        scopes = cs.scope_map(hlo)
        assert cs.attribute(scopes["loop_add_fusion_44"]) == ("level_01",
                                                             "smooth")
        assert cs.attribute(scopes["gather_2"]) == ("level_00", "warp")

    def test_reduce_device_events(self):
        scopes = {"fusion_1": ["jit(f)/level_00/while/body/warp/gather"],
                  "fusion_2": ["jit(f)/level_00/while/body/smooth/add"],
                  "fusion_3": ["jit(f)/pyramid_build/pad"]}
        events = [("fusion_1", "fusion.1", 0, 10),
                  ("fusion_2", "fusion.2", 10, 20),
                  ("fusion_3", None, 40, 10),
                  ("copy_9", "copy.9", 45, 10)]
        red = cs.reduce_device_events(events, scopes, window_ns=100.0)
        assert red["per_level_ns"] == {"level_00": 30, "pyramid_build": 10,
                                       "other": 10}
        assert red["per_stage_ns"]["level_00/warp"] == 10
        assert red["per_stage_ns"]["level_00/smooth"] == 20
        assert red["busy_ns"] == 45.0
        assert red["idle_share"] == pytest.approx(0.55)
        assert red["unattributed_top_ns"] == {"copy.9": 10}


class TestCompileCache:
    def test_variable_wins_and_code_sets_nothing(self):
        from ug_stereomatcher import compile_cache as cc
        env = {cc.ENV_VAR: "/some/where"}
        assert cc.cache_dir_to_set("gpu", env) is None
        assert cc.cache_dir_to_set("cpu", env) is None

    def test_fixed_checkout_path_on_an_accelerator(self):
        from ug_stereomatcher import compile_cache as cc
        path = cc.cache_dir_to_set("gpu", {})
        assert path == os.path.join(REPO, ".jax_cache")

    def test_cpu_stays_uncached(self):
        from ug_stereomatcher import compile_cache as cc
        assert cc.cache_dir_to_set("cpu", {}) is None

    def test_ensure_on_cpu_configures_nothing(self):
        import jax
        from ug_stereomatcher import compile_cache as cc
        assert jax.config.jax_compilation_cache_dir is None
        assert cc.ensure_compile_cache() is None
        assert jax.config.jax_compilation_cache_dir is None

    def test_gitignored(self):
        with open(os.path.join(REPO, ".gitignore")) as fh:
            assert ".jax_cache/" in fh.read().split()


def _sources():
    pkg = os.path.join(REPO, "ug_stereomatcher")
    files = [os.path.join(d, f) for d, _, fs in os.walk(pkg) for f in fs
             if f.endswith(".py")]
    return files + [os.path.join(REPO, n) for n in
                    ("bench.py", "chip_smoke.py", "__graft_entry__.py")]


class TestNoBackendSpecificPaths:
    def test_no_pallas_import(self):
        bad = []
        for path in _sources():
            tree = ast.parse(open(path).read())
            for node in ast.walk(tree):
                names = []
                if isinstance(node, ast.Import):
                    names = [a.name for a in node.names]
                elif isinstance(node, ast.ImportFrom):
                    names = [node.module or ""] + [
                        f"{node.module}.{a.name}" for a in node.names]
                if any(n.startswith("jax.experimental.pallas") for n in names):
                    bad.append(path)
        assert not bad, bad

    def test_backend_checked_only_by_smoke_and_cache_helper(self):
        users = []
        for path in _sources():
            tree = ast.parse(open(path).read())
            for node in ast.walk(tree):
                if (isinstance(node, ast.Attribute)
                        and node.attr == "default_backend"):
                    users.append(os.path.relpath(path, REPO))
        assert sorted(set(users)) == ["chip_smoke.py",
                                      os.path.join("ug_stereomatcher",
                                                   "compile_cache.py")]
