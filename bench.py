"""Benchmark: the headline metrics on one accelerator.

Default (BENCH_MODE=all) runs all reference-comparable benchmarks and
prints one JSON line per metric, ending with the primary one:

  1. foveated   — 16MP mode-2 foveated stack latency (ref: 3 s/pair)
  2. throughput — batched pairs/s at a 1MP working resolution (ref scaled
                  from 10 s/pair at 16MP)
  3. foveated_throughput — batched mode-2 pairs/s at 1MP (ref scaled from
                  3 s/pair at 16MP; the reference's throughput mode)
  4. mode1_bilinear / foveated_bilinear — the SAME latencies in the
                  quality mode (interp="bilinear", ~10x lower EPE,
                  docs/ACCURACY.md).
  5. mode1_ee / mode1_bilinear_ee — convergence early exit at each
                  mode's accuracy-safe threshold (nearest 0.1,
                  bilinear 0.02; CI-gated to suite-EPE parity).
  6. mode1      — 16MP full-pyramid disparity latency (ref: 10 s/pair);
                  printed LAST with the other results embedded in
                  "extra" so a last-line parser still captures everything.

vs_baseline > 1 means faster than the reference CUDA matcher
(/root/reference/README.md:15-16; BASELINE.md).

Every metric's extra carries persistent-compile-cache accounting
(cache_requests / cache_hits / cache_misses + cache_new_entries, the
names of newly written entries, and cache_warm = no entry written) and
the device it ran on (platform, device_kind, count).

Env overrides: BENCH_H, BENCH_W (default 3264 x 4928 — the Glasgow rig
resolution, calibrations/calL.xml), BENCH_REPEATS (default 3),
BENCH_MODE ("all" | "mode1" | "foveated" | "throughput" |
"foveated_throughput" | "scaling" | the bilinear / early-exit variants),
BENCH_BATCH (throughput mode batch size, default 8),
BENCH_PLATFORM=cpu (+ BENCH_CPU_DEVICES, default 8) for mesh-scaling runs
on virtual CPU devices.
"""

import json
import os
import sys
import time

import numpy as np


def _setup_jax():
    """Import jax (honouring BENCH_PLATFORM) and enable the compile cache."""
    platform = os.environ.get("BENCH_PLATFORM")
    if platform == "cpu":
        n = int(os.environ.get("BENCH_CPU_DEVICES", 8))
        flags = os.environ.get("XLA_FLAGS", "")
        if "host_platform_device_count" not in flags:
            os.environ["XLA_FLAGS"] = (
                flags + f" --xla_force_host_platform_device_count={n}")
    import jax

    if platform:
        jax.config.update("jax_platforms", platform)
    from ug_stereomatcher.compile_cache import ensure_compile_cache
    cache_dir = ensure_compile_cache()
    if cache_dir:
        _install_cache_counters(cache_dir)
    return jax


def _device_info(jax):
    """The device a result was measured on, as JAX reports it."""
    devs = jax.devices()
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}


class _CacheCounters:
    """Per-metric persistent-compile-cache accounting.

    Counts JAX's monitoring events (`compile_requests_use_cache` fires per
    compile that consults the cache, `cache_hits` per retrieval), and names
    the missed programs by diffing the cache directory (a miss that took
    >= min_compile_time writes a new `jit_<name>-<key>-cache` entry), so a
    run says which programs it compiled rather than loaded."""

    def __init__(self, cache_dir):
        self.cache_dir = cache_dir
        self.requests = 0
        self.hits = 0

    def listener(self, event, **kw):
        if event == "/jax/compilation_cache/compile_requests_use_cache":
            self.requests += 1
        elif event == "/jax/compilation_cache/cache_hits":
            self.hits += 1

    def _entries(self):
        try:
            return set(os.listdir(self.cache_dir))
        except OSError:
            return set()

    def snapshot(self):
        return (self.requests, self.hits, self._entries())

    def delta(self, snap):
        """(requests, hits, misses, new_entry_names) since ``snap``.

        ``cache_misses`` counts every compile the cache did not serve —
        including trivial sub-min_compile_time programs that are never
        persisted and therefore always "miss" (harmless; they recompile
        in milliseconds).  The warm-cache criterion is ``cache_warm``:
        no compile expensive enough to persist happened, i.e. no new
        entry was written."""
        req0, hit0, names0 = snap
        new = sorted(n.rsplit("-", 2)[0] for n in self._entries() - names0)
        req = self.requests - req0
        return {"cache_requests": req, "cache_hits": self.hits - hit0,
                "cache_misses": req - (self.hits - hit0),
                "cache_new_entries": new, "cache_warm": not new}


_CACHE_COUNTERS = None


def _install_cache_counters(cache_dir):
    global _CACHE_COUNTERS
    if _CACHE_COUNTERS is not None:
        return
    try:
        from jax._src import monitoring
        _CACHE_COUNTERS = _CacheCounters(cache_dir)
        monitoring.register_event_listener(_CACHE_COUNTERS.listener)
    except Exception:
        _CACHE_COUNTERS = None  # private API moved: counts degrade to absent


def _with_cache_stats(fn):
    """Run a metric fn, annotating its extra with cache-miss accounting."""
    if _CACHE_COUNTERS is None:
        return fn()
    snap = _CACHE_COUNTERS.snapshot()
    out = fn()
    out.setdefault("extra", {}).update(_CACHE_COUNTERS.delta(snap))
    return out


def _octave_texture(h, w, seed=0):
    """Multi-octave (1/f-style) texture — structure at every pyramid scale,
    like a natural photograph.  White noise is the wrong bench scene: it is
    unmatchable at coarse pyramid levels (subsampled noise decorrelates),
    which drives the disparity field to pathological magnitudes —
    benchmarking a failure mode instead of the serving path.  Natural
    images (the
    Glasgow capture distribution) correlate at all scales."""
    rng = np.random.RandomState(seed)
    out = np.zeros((h, w, 3), np.float32)
    scale = 1.0
    size = 4
    while size <= max(h, w):
        base = rng.rand(min(size, h), min(size, w), 3).astype(np.float32)
        yi = np.arange(h) * base.shape[0] // h
        xi = np.arange(w) * base.shape[1] // w
        out += scale * base[yi][:, xi]
        size *= 2
        scale *= 0.85
    out -= out.min()
    out *= 255.0 / out.max()
    return out.astype(np.uint8)


def _make_pair(h, w, batch=None):
    # right: small horizontal shift of left, so the matcher does real work
    if batch is None:
        tex = _octave_texture(h, w + 8)
        return tex[:, 4:w + 4], tex[:, 1:w + 1]
    lefts, rights = [], []
    for b in range(batch):
        tex = _octave_texture(h, w + 8, seed=b)
        lefts.append(tex[:, 4:w + 4])
        rights.append(tex[:, 1:w + 1])
    return np.stack(lefts), np.stack(rights)


def _latency(jax, mode, h, w, repeats):
    """One metric dict for mode1 / foveated latency.  The ``_bilinear``
    variants run the SAME graph with ``interp="bilinear"`` — the quality
    mode (~10x lower EPE, docs/ACCURACY.md).  The ``_ee`` variants
    additionally enable the convergence early exit at each interp mode's
    accuracy-safe threshold (nearest 0.1, bilinear 0.02 — CI-gated to
    suite-EPE parity).  vs_baseline always divides the reference's
    nearest-fixed-schedule time (it has neither mode)."""
    import jax.numpy as jnp

    from ug_stereomatcher import StereoEngine, MatcherConfig

    parts = mode.split("_")
    base_mode = parts[0]
    interp = "bilinear" if "bilinear" in parts else "nearest"
    early = ((0.02 if interp == "bilinear" else 0.1)
             if "ee" in parts else None)
    baseline_s = 10.0 if base_mode == "mode1" else 3.0
    left, right = _make_pair(h, w)
    eng = StereoEngine(MatcherConfig(interp=interp,
                                     early_exit_delta=early))
    run = eng.match if base_mode == "mode1" else eng.match_foveated

    def plane(res):
        return res.disparity_h if hasattr(res, "disparity_h") else res.stack_h

    def once(l, r):
        """One matched pair, timed to device completion."""
        t0 = time.perf_counter()
        jax.block_until_ready(plane(run(l, r)))
        return time.perf_counter() - t0

    compile_s = once(left, right)  # warmup / compile

    # Primary metric: device-resident latency — images already on the
    # device, results consumed there (the serving pattern: capture
    # pipelines feed the device and triangulation runs there too).
    left_dev, right_dev = jax.block_until_ready(
        (jnp.asarray(left), jnp.asarray(right)))
    times = [once(left_dev, right_dev) for _ in range(repeats)]
    value = float(min(times))

    # End-to-end from host numpy arrays (includes the upload), for reference
    host_path_s = min(once(left, right) for _ in range(2))

    return {
        "metric": f"16mp_{mode}_disparity_latency"
                  if (h, w) == (3264, 4928) else
                  f"{mode}_disparity_latency_{h}x{w}",
        "value": round(value, 4),
        "unit": "s/pair",
        "vs_baseline": round(baseline_s / value, 3),
        "extra": {
            "height": h, "width": w, "repeats": repeats,
            "interp": interp, "early_exit_delta": early,
            "compile_plus_first_run_s": round(compile_s, 2),
            "all_runs_s": [round(t, 4) for t in times],
            "host_path_s": round(host_path_s, 3),
            "device": _device_info(jax),
            "baseline_s": baseline_s,
        },
    }


def _throughput(jax, h, w, repeats, foveated=False):
    """Batched pairs/s on the available devices (Glasgow-database-style
    throughput; defaults to a 1MP working resolution).  ``foveated=True``
    benches mode 2 — the reference's throughput configuration (3 s/pair at
    16MP vs 10 s for mode 1, /root/reference/README.md:16)."""
    import jax.numpy as jnp

    from ug_stereomatcher import MatcherConfig, StereoEngine
    from ug_stereomatcher.parallel import make_mesh, mesh_shape_for

    if "BENCH_H" not in os.environ:  # default unset -> use a 1MP batch size
        h, w = 815, 1231
    batch = int(os.environ.get("BENCH_BATCH", 8))
    n_dev = len(jax.devices())
    pairs_ax, rows_ax = mesh_shape_for(n_dev, n_pairs=batch)
    mesh = make_mesh(pairs_ax, rows_ax) if n_dev > 1 else None

    left, right = _make_pair(h, w, batch=batch)
    eng = StereoEngine(MatcherConfig())
    lb = jnp.asarray(left)
    rb = jnp.asarray(right)

    def once():
        t0 = time.perf_counter()
        res = eng.match_batch(lb, rb, mesh, foveated=foveated)
        jax.block_until_ready(res.disparity_h if not foveated
                              else res.stack_h)
        return time.perf_counter() - t0

    compile_s = once()
    times = [once() for _ in range(repeats)]
    sec = min(times)
    # reference throughput at this resolution: s/pair at 16MP scales
    # ~linearly with pixels (3 s for mode 2, 10 s for mode 1)
    base_s = 3.0 if foveated else 10.0
    ref_pps = 1.0 / (base_s * (h * w) / (3264 * 4928))
    pps = batch / sec
    tag = "foveated_throughput" if foveated else "batched_throughput"
    return {
        "metric": f"{tag}_{h}x{w}",
        "value": round(pps, 3),
        "unit": "pairs/s",
        "vs_baseline": round(pps / ref_pps, 3),
        "extra": {"batch": batch, "devices": n_dev,
                  "seconds_per_batch": round(sec, 4),
                  "compile_plus_first_run_s": round(compile_s, 2),
                  "device": _device_info(jax),
                  "baseline_pairs_per_s": round(ref_pps, 4)},
    }


def _scaling(jax, h, w, repeats):
    """Scaling tables via parallel.throughput.measure_throughput across
    1..N available devices (SURVEY.md §6 'frames/s efficiency at 1 chip /
    1 host / N hosts') — four mesh families per run: 'dp' (pairs-only
    throughput), 'sp' (one pair row-sharded, latency scaling), 'hybrid'
    (pairs=2 x rows, the batch<devices pod shape), 'dp_fov' (pairs-only
    mode-2 foveated — the reference's throughput configuration).  Each
    point carries an
    ``oversubscribed`` flag (devices > physical cores) so virtual-CPU-mesh
    curves stay diagnostic: the headline value is the DP efficiency at the
    LARGEST non-oversubscribed device count (on real cards nothing
    is oversubscribed and that is simply the max).  Narrow with
    BENCH_SCALING_MODES=dp,sp,hybrid."""
    from ug_stereomatcher.parallel.throughput import measure_throughput

    if "BENCH_H" not in os.environ:
        h, w = 408, 616   # scaling probe resolution (fovea-sized)
    known = ("dp", "sp", "hybrid", "dp_fov")  # dp_fov = mode-2 foveated
    # DP — the reference's throughput configuration (README.md:16)
    modes = [m.strip() for m in
             os.environ.get("BENCH_SCALING_MODES", ",".join(known)).split(",")
             if m.strip()]
    skipped = [m for m in modes if m not in known]
    modes = [m for m in modes if m in known] or ["dp"]  # bad env var ->
    # diagnostic fallback, not a crash (ditto an all-whitespace value)
    from ug_stereomatcher import MatcherConfig
    curves = {}
    dp_points = None
    last_ok = None  # (family, points) of the last family that measured
    for mode in modes:
        cfg = MatcherConfig()
        if mode.endswith("_fov"):
            # small probe sizes may not carry fovea_level(7) pyramid
            # levels — lower it rather than lose the whole metric
            n = cfg.num_levels(h, w)
            if n < cfg.fovea_level:
                cfg = MatcherConfig(fovea_level=max(2, n))
        try:
            points = measure_throughput(height=h, width=w, repeats=repeats,
                                        mode=mode.removesuffix("_fov"),
                                        cfg=cfg,
                                        foveated=mode.endswith("_fov"))
        except Exception as e:
            # one failing family must not sink the others' curves
            curves[mode] = {"error": f"{type(e).__name__}: {e}"}
            continue
        curves[mode] = [{"devices": p.n_devices, "mesh": list(p.mesh_shape),
                         "batch": p.batch,
                         "pairs_per_s": p.pairs_per_second,
                         "seconds_per_batch": p.seconds_per_batch,
                         "efficiency": p.scaling_efficiency,
                         "oversubscribed": p.oversubscribed}
                        for p in points]
        last_ok = (mode, points)
        if mode == "dp":
            dp_points = points
    # Headline: the DP curve when it was requested AND measured.  If dp was
    # requested but its family errored, do NOT promote another family's
    # points under the dp label (a silently-wrong certified headline is
    # worse than a diagnostic); only a dp-less BENCH_SCALING_MODES may
    # headline a different family, and the unit says which.
    if "dp" in modes:
        head = ("dp", dp_points) if dp_points else None
    else:
        head = last_ok
    if head is None:  # nothing usable: structured diagnostic, not a crash
        return {"metric": f"mesh_scaling_{h}x{w}", "value": 0,
                "unit": "dp_efficiency_at_max_diagnostic_devices",
                "vs_baseline": 0,
                "extra": {"curves": curves, "skipped_modes": skipped}}
    head_mode, head_points = head
    diag = ([p for p in head_points if not p.oversubscribed]
            or list(head_points))
    best = diag[-1]
    return {
        "metric": f"mesh_scaling_{h}x{w}",
        "value": best.scaling_efficiency,
        "unit": f"{head_mode}_efficiency_at_max_diagnostic_devices",
        "vs_baseline": best.scaling_efficiency,  # ref has no multi-device
        "extra": {"curves": curves, "devices": len(jax.devices()),
                  "physical_cores": os.cpu_count(),
                  "headline_devices": best.n_devices,
                  "skipped_modes": skipped,
                  "device": _device_info(jax)},
    }


_MODES = ("all", "throughput", "foveated_throughput", "scaling", "mode1",
          "foveated", "mode1_bilinear", "foveated_bilinear", "mode1_ee",
          "mode1_bilinear_ee")


def main():
    mode = os.environ.get("BENCH_MODE", "all")
    if mode not in _MODES:
        # reject before importing jax: an unknown/typo'd mode must not
        # fall through to the full 16MP suite
        print(json.dumps({"metric": "bench_env_FAILED", "value": 0,
                          "unit": "n/a", "vs_baseline": 0,
                          "error": f"unknown BENCH_MODE {mode!r}; "
                                   f"valid: {', '.join(_MODES)}"}))
        return 2
    jax = _setup_jax()
    h = int(os.environ.get("BENCH_H", 3264))
    w = int(os.environ.get("BENCH_W", 4928))
    repeats = int(os.environ.get("BENCH_REPEATS", 3))

    if mode == "throughput":
        print(json.dumps(_with_cache_stats(
            lambda: _throughput(jax, h, w, repeats))))
        return
    if mode == "foveated_throughput":
        print(json.dumps(_with_cache_stats(
            lambda: _throughput(jax, h, w, repeats, foveated=True))))
        return
    if mode == "scaling":
        print(json.dumps(_with_cache_stats(
            lambda: _scaling(jax, h, w, repeats))))
        return
    if mode in ("mode1", "foveated", "mode1_bilinear", "foveated_bilinear",
                "mode1_ee", "mode1_bilinear_ee"):
        print(json.dumps(_with_cache_stats(
            lambda: _latency(jax, mode, h, w, repeats))))
        return

    # mode == "all": secondary metrics first (each on its own JSON line),
    # the primary mode-1 line LAST with the secondaries embedded so any
    # single-line consumer still records all three headline numbers.
    side = {}
    for name, fn in (("foveated", lambda: _latency(jax, "foveated", h, w,
                                                   repeats)),
                     ("throughput", lambda: _throughput(jax, h, w, repeats)),
                     ("foveated_throughput",
                      lambda: _throughput(jax, h, w, repeats,
                                          foveated=True)),
                     ("mode1_bilinear",
                      lambda: _latency(jax, "mode1_bilinear", h, w,
                                       repeats)),
                     ("foveated_bilinear",
                      lambda: _latency(jax, "foveated_bilinear", h, w,
                                       repeats)),
                     ("mode1_ee",
                      lambda: _latency(jax, "mode1_ee", h, w, repeats)),
                     ("mode1_bilinear_ee",
                      lambda: _latency(jax, "mode1_bilinear_ee", h, w,
                                       repeats))):
        try:
            r = _with_cache_stats(fn)
            side[name] = {k: r[k] for k in
                          ("metric", "value", "unit", "vs_baseline")}
            print(json.dumps(r))
        except Exception as e:  # never let a secondary sink the primary
            side[name] = {"error": f"{type(e).__name__}: {e}"}
            print(json.dumps({"metric": f"{name}_FAILED",
                              "error": side[name]["error"]}))
        sys.stdout.flush()

    primary = _with_cache_stats(
        lambda: _latency(jax, "mode1", h, w, repeats))
    primary["extra"].update(side)
    print(json.dumps(primary))


if __name__ == "__main__":
    sys.exit(main())
