"""Smoke test of the stereo matcher's main path on one NVIDIA GPU.

    python chip_smoke.py               # one card: phases 1-5 below
    python chip_smoke.py --four-cards  # four cards: the multi-device phase only
    python chip_smoke.py --trace-dir D # keep the profile traces in D

Phases (one card):

1. device      — refuse anything but a GPU backend.
2. op_parity   — each level op at 3x3264x4928 (level 0 of the Glasgow rig)
                 on the card and, as the same jitted function, on the
                 process's CPU device.  Nearest gathers/resamples must be
                 bit-exact, except at pixels whose sample coordinate lies
                 within 1e-4 px of a texel edge; stencils, ratios and
                 bilinear agree to max|d| <= 1e-5 * max|ref|.
3. level_lockstep — ``match_level`` at level 3 of the 16MP chain, card vs
                 CPU, under quantile gates (free-running nearest output is
                 chaotic in float noise, so never maxima).
4. main_path   — the user entry points at full width on the bench scene
                 (a 3 px shift): the service in modes 1 and 2, the engine in
                 bilinear and with early exit, hierarchical, a batch of 8
                 pairs at 815x1231, a point cloud, and ``__graft_entry__``.
                 Value gates: nearest med|dh-3| < 0.5 and mean|dv| < 0.5,
                 bilinear both < 0.1, frac(|dh-3| < 1 px) > 0.9 in both.
5. profile     — one profiler trace of a steady mode-1 call: device time
                 per level and stage, the device's idle share, and for
                 levels 0-1 the warp / direction / smooth times beside the
                 bytes each must move at least, against 3.35 TB/s.

``--four-cards`` runs only the distribution layer: DP ``batch_match`` of
8 pairs over a (4, 1) mesh against one card, and ``sharded_match_pair``
row-sharded over (1, 4) at 16MP against single-card mode 1.

Every stdout line before the last names the card and its power limit; the
last line is ``{"ok": true, "device": {...}}``.  Any failure raises, so the
script exits non-zero without that line.
"""

from __future__ import annotations

import argparse
import collections
import dataclasses
import json
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np

H, W = 3264, 4928            # Glasgow rig, calibrations/calL.xml
BATCH, BH, BW = 8, 815, 1231  # batched cell (level 4 of the 16MP chain)
SHIFT = 3.0                   # bench scene: right[:, x+3] == left[:, x]
LOCKSTEP_LEVEL = 3
HBM_BYTES_PER_S = 3.35e12     # H100 SXM data sheet
# value gates per interp: (max median |dh-3|, max mean |dv|)
GATES = {"nearest": (0.5, 0.5), "bilinear": (0.1, 0.1)}
MIN_FRAC_1PX = 0.9
EDGE_TOL = 1e-4               # px: nearest flips allowed this close to an edge
REL_TOL = 1e-5                # stencils / ratios / bilinear vs CPU
# (median, q90, fraction over 0.5 px) of |card - reference|: one level in
# lockstep from the same state, and whole free-running pyramids
LOCKSTEP_GATES = (1e-4, 1e-2, 1e-3)
FREE_RUN_GATES = (0.05, 0.5, 0.05)
# minimum bytes per pixel per iteration (float32 planes read + written)
MIN_BYTES_PER_PX = {
    "warp": (3 + 2 + 3) * 4,             # right(3) + disp(2) -> warped(3)
    "direction_maps": (3 + 3 + 3 + 5) * 4,  # left, warped, G(L^2) -> 5 maps
    "smooth": (3 + 3) * 4,               # state in -> state out, fused
}


# ----------------------------------------------------------------------
# helpers (no device needed; unit-tested on the CPU)
# ----------------------------------------------------------------------

def gpu_line() -> str:
    """``name, power.limit`` of the first card, as nvidia-smi prints it."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0].strip()


def parse_gpu_line(line: str) -> dict:
    """Split nvidia-smi's ``NVIDIA H100 80GB HBM3, 700.00 W``."""
    name, _, limit = line.rpartition(",")
    if not name:
        raise ValueError(f"unexpected nvidia-smi line {line!r}")
    return {"name": name.strip(), "power_limit": limit.strip()}


def require_gpu(backend: str) -> None:
    if backend != "gpu":
        raise SystemExit(f"chip_smoke: JAX backend is {backend!r}, not a GPU; "
                         f"refusing to run")


def last_line(platform: str, kind: str, count: int) -> str:
    return json.dumps({"ok": True, "device": {
        "platform": platform, "kind": kind, "count": count}})


def value_gates(dh, dv, interp: str, shift: float = SHIFT,
                crop: int = 64) -> dict:
    """Known-answer gates on a (..., H, W) disparity field of the bench
    scene, inside a border of ``crop`` px (at most an eighth of a side);
    a leading batch axis is gated pair by pair."""
    dh = np.asarray(dh, np.float64)
    dv = np.asarray(dv, np.float64)
    if dh.ndim == 3:
        per = [value_gates(a, b, interp, shift, crop) for a, b in zip(dh, dv)]
        worst = max(per, key=lambda g: g["med_abs_dh_err"])
        return dict(worst, ok=all(g["ok"] for g in per), pairs=len(per))
    crop = min(crop, dh.shape[-2] // 8, dh.shape[-1] // 8)
    err = np.abs(dh[crop:-crop, crop:-crop] - shift)
    vv = np.abs(dv[crop:-crop, crop:-crop])
    med_max, mv_max = GATES[interp]
    g = {"med_abs_dh_err": float(np.median(err)),
         "mean_abs_dv": float(np.mean(vv)),
         "frac_within_1px": float(np.mean(err < 1.0))}
    g["ok"] = bool(g["med_abs_dh_err"] < med_max and g["mean_abs_dv"] < mv_max
                   and g["frac_within_1px"] > MIN_FRAC_1PX)
    return g


def close_check(out, ref, rel: float = REL_TOL) -> dict:
    out = np.asarray(out, np.float64)
    ref = np.asarray(ref, np.float64)
    d = float(np.max(np.abs(out - ref)))
    scale = float(np.max(np.abs(ref)))
    return {"max_abs_diff": d, "max_abs_ref": scale,
            "ok": bool(np.all(np.isfinite(out)) and d <= rel * scale)}


def near_edge(coord, tol: float = EDGE_TOL):
    """True where a texel coordinate lies within ``tol`` of an integer."""
    c = np.asarray(coord, np.float64)
    return np.abs(c - np.round(c)) < tol


def nearest_check(out, ref, xs=None, ys=None) -> dict:
    """Bit-exact comparison of a nearest gather over (..., H, W); where
    pixels differ, each must have its sample x or y within EDGE_TOL px of
    a texel edge (FMA contraction can move such a coordinate across)."""
    out = np.asarray(out)
    ref = np.asarray(ref)
    diff = np.any(out != ref, axis=tuple(range(out.ndim - 2)))
    n = int(diff.sum())
    ok = n == 0
    if n and xs is not None:
        edge = near_edge(np.asarray(xs)[diff]) | near_edge(
            np.asarray(ys)[diff])
        ok = bool(edge.all())
    return {"pixels_differing": n, "ok": bool(ok)}


def quantile_gates(out, ref, median: float, q90: float,
                   frac_half_px: float) -> dict:
    """Chaos-rule comparison of two free-running outputs: bound the bulk
    with quantiles and the flipped pixels with a fraction, never maxima."""
    d = np.abs(np.asarray(out, np.float64) - np.asarray(ref, np.float64))
    g = {"median": float(np.median(d)), "q90": float(np.quantile(d, 0.9)),
         "q99": float(np.quantile(d, 0.99)),
         "frac_over_half_px": float(np.mean(d > 0.5))}
    g["ok"] = bool(np.all(np.isfinite(out)) and g["median"] <= median
                   and g["q90"] <= q90
                   and g["frac_over_half_px"] <= frac_half_px)
    return g


def interval_union_ns(intervals) -> float:
    """Total length of the union of (start, end) intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


_LEVEL = re.compile(r"(level_\d\d|upsample_\d\d|pyramid_build)")
_STAGE = re.compile(r"/(warp|direction_maps|parabola|smooth|average)/")
_INSTR = re.compile(r"^\s*(?:ROOT )?%?([\w.\-]+) = ")
_CALLS = re.compile(r"calls=%?([\w.\-]+)")
_OP_NAME = re.compile(r'op_name="([^"]*)"')


def _norm(name: str) -> str:
    return re.sub(r"[.\-]", "_", name)


def scope_map(hlo_text: str) -> dict:
    """Map each HLO instruction name (normalised) to the ``op_name`` scope
    path of itself or, for a fusion without one, of its fused body."""
    comp_names, own, calls = {}, {}, {}
    current = None
    for line in hlo_text.splitlines():
        head = re.match(r"^(?:ENTRY )?%?([\w.\-]+) .*\{\s*$", line)
        if head and "=" not in line.split("{")[0]:
            current = head.group(1)
            comp_names[current] = []
            continue
        m = _INSTR.match(line)
        if not m or current is None:
            continue
        name = m.group(1)
        called = _CALLS.search(line)
        called = called.group(1) if called else None
        op = _OP_NAME.search(line)
        op = op.group(1) if op else None
        comp_names[current].append(op or "")
        if op:
            own[name] = op
        if called:
            calls[name] = called
    out = {}
    for name in set(own) | set(calls):
        ops = [own.get(name, "")] + comp_names.get(calls.get(name), [])
        out[_norm(name)] = [o for o in ops if o]
    return out


def attribute(ops) -> tuple:
    """(level, stage) scopes named by an instruction's op_name paths; the
    most frequent wins (a fusion may span stages)."""
    levels = collections.Counter(m.group(1) for o in ops
                                 for m in [_LEVEL.search(o)] if m)
    stages = collections.Counter(m.group(1) for o in ops
                                 for m in [_STAGE.search(o)] if m)
    level = levels.most_common(1)[0][0] if levels else "other"
    stage = stages.most_common(1)[0][0] if stages else "other"
    return level, stage


def reduce_device_events(events, scopes: dict, window_ns: float) -> dict:
    """Per-level / per-stage device time and the idle share over a window.

    ``events``: (name, hlo_op or None, start_ns, duration_ns) of device
    kernels; ``scopes``: scope_map of the traced program."""
    per_level = collections.defaultdict(float)
    per_stage = collections.defaultdict(float)
    other = collections.Counter()
    intervals = []
    for name, hlo_op, start, dur in events:
        intervals.append((start, start + dur))
        ops = scopes.get(_norm(hlo_op or ""), None) or scopes.get(
            _norm(name), [])
        level, stage = attribute(ops)
        if level == "other":
            other[hlo_op or name] += dur
        per_level[level] += dur
        per_stage[(level, stage)] += dur
    busy = interval_union_ns(intervals)
    return {"per_level_ns": dict(per_level),
            "per_stage_ns": {f"{k[0]}/{k[1]}": v
                             for k, v in per_stage.items()},
            "busy_ns": busy, "window_ns": window_ns,
            "idle_share": (1.0 - busy / window_ns) if window_ns else None,
            "kernels": len(intervals),
            "unattributed_top_ns": dict(other.most_common(8))}


# ----------------------------------------------------------------------
# phases (need jax and the package)
# ----------------------------------------------------------------------

class Reporter:
    """Prints one JSON line per phase, each naming the card."""

    def __init__(self, jax, card: str):
        self.jax = jax
        self.card = card

    def peak(self):
        stats = self.jax.devices()[0].memory_stats() or {}
        return stats.get("peak_bytes_in_use")

    def emit(self, phase: str, **fields):
        rec = {"phase": phase, "gpu": self.card, **fields,
               "peak_bytes_in_use": self.peak()}
        print(json.dumps(rec), flush=True)
        bad = [k for k, v in fields.items()
               if isinstance(v, dict) and v.get("ok") is False]
        if bad:
            raise RuntimeError(f"phase {phase}: checks failed: {bad}")


def _ready(jax, out):
    """Wait for every array in ``out`` (result dataclasses included)."""
    if dataclasses.is_dataclass(out):
        jax.block_until_ready([getattr(out, f.name)
                               for f in dataclasses.fields(out)])
        return out
    return jax.block_until_ready(out)


def timed(jax, fn, *args, repeats: int = 2):
    """(result, first_s, [steady_s...]) with device completion."""
    t0 = time.perf_counter()
    out = _ready(jax, fn(*args))
    first = time.perf_counter() - t0
    steady = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        out = _ready(jax, fn(*args))
        steady.append(time.perf_counter() - t0)
    return out, first, steady


def on_cpu(jax, fn, *args):
    cpu = jax.devices("cpu")[0]
    with jax.default_device(cpu):
        return jax.block_until_ready(
            fn(*[jax.device_put(np.asarray(a), cpu) for a in args]))


def phase_op_parity(jax, rep, h=H, w=W, seed=0):
    import jax.numpy as jnp
    from ug_stereomatcher import match as match_mod
    from ug_stereomatcher import ops
    from ug_stereomatcher.config import REFERENCE_SCALE as S

    rng = np.random.RandomState(seed)
    img = (rng.rand(3, h, w) * 255).astype(np.float32)
    # smooth-ish fields so gathers stay roughly local, as in the matcher
    dh = (SHIFT + 6 * np.sin(np.linspace(0, 7, w))[None, :]
          + rng.rand(h, w) - 0.5).astype(np.float32)
    dv = (2 * np.cos(np.linspace(0, 5, h))[:, None]
          + rng.rand(h, w) - 0.5).astype(np.float32)
    conf = (0.05 + 0.95 * rng.rand(h, w)).astype(np.float32)
    xs = np.arange(w, dtype=np.float64)[None, :] + 0.5 + dh
    ys = np.arange(h, dtype=np.float64)[:, None] + 0.5 + dv
    h1, w1 = int(h / S), int(w / S)
    # the pipeline upsamples disparity triplets, which are smooth; on white
    # noise a 1-ulp coordinate difference (FMA contraction) alone moves a
    # bilinear sample by up to ulp(x) * the neighbour step
    yy = np.linspace(0, 1, h1)[:, None]
    xx = np.linspace(0, 1, w1)[None, :]
    small = np.stack([SHIFT + 6 * np.sin(7 * xx) + 0 * yy,
                      2 * np.cos(5 * yy) + 0 * xx,
                      0.5 + 0.4 * np.sin(3 * xx + 2 * yy)]).astype(np.float32)

    def warp(method):
        return lambda i, a, b: ops.warp_by_disparity(i, a, b, method)

    def smooth_chain(state):
        for _ in range(10):
            state = ops.weighted_smooth(state, state[2])
        return ops.blur_average_clamp(state)

    def directions(left, warped):
        return jnp.stack(match_mod.direction_maps(
            left, warped, ops.blur_gaussian_clamp(left * left)))

    cases = [
        ("warp_nearest", warp("nearest"), (img, dh, dv), "nearest_xy"),
        ("warp_bilinear", warp("bilinear"), (img, dh, dv), "close"),
        ("direction_maps", directions, (img, np.roll(img, 3, -1)), "close"),
        ("smooth10_average", smooth_chain,
         (np.stack([dh, dv, conf]),), "close"),
        ("blur_gaussian_zero", ops.blur_gaussian_zero, (img,), "close"),
        ("blur_gaussian_clamp", ops.blur_gaussian_clamp, (img,), "close"),
        ("subsample_nearest",
         lambda i: ops.subsample(i, h1, w1, S, "nearest"), (img,), "exact"),
        ("subsample_bilinear",
         lambda i: ops.subsample(i, h1, w1, S, "bilinear"), (img,), "close"),
        ("upsample_nearest",
         lambda d: ops.upsample_disp(d, h, w, 1 / S, S, "nearest"),
         (small,), "exact"),
        ("upsample_bilinear",
         lambda d: ops.upsample_disp(d, h, w, 1 / S, S, "bilinear"),
         (small,), "close"),
    ]
    for name, fn, args, kind in cases:
        f = jax.jit(fn)
        out, first, steady = timed(jax, f, *[jnp.asarray(a) for a in args])
        ref = on_cpu(jax, f, *args)
        out = np.asarray(out)
        ref = np.asarray(ref)
        if kind == "close":
            check = close_check(out, ref)
        else:
            check = nearest_check(out, ref, *((xs, ys) if kind == "nearest_xy"
                                              else (None, None)))
        rep.emit(f"op_parity/{name}", shape=list(out.shape),
                 first_s=first, steady_s=steady, check=check)


def phase_level_lockstep(jax, rep, h=H, w=W, level=LOCKSTEP_LEVEL):
    import bench
    import jax.numpy as jnp
    from functools import partial
    from ug_stereomatcher.config import MatcherConfig
    from ug_stereomatcher.match import match_level

    cfg = MatcherConfig()
    lh, lw = cfg.dims_chain(h, w)[level]
    left, right = bench._make_pair(lh, lw)
    left = np.moveaxis(left, -1, 0).astype(np.float32)
    right = np.moveaxis(right, -1, 0).astype(np.float32)
    disp = np.zeros((3, lh, lw), np.float32)
    disp[2] = 0.5
    f = jax.jit(partial(match_level, level_index=level, cfg=cfg,
                        is_coarsest=False))
    out, first, steady = timed(jax, f, jnp.asarray(left), jnp.asarray(right),
                               jnp.asarray(disp))
    ref = on_cpu(jax, f, left, right, disp)
    out = np.asarray(out)
    ref = np.asarray(ref)
    rep.emit("level_lockstep", level=level, shape=[lh, lw],
             iterations=cfg.iters_for_level(level), first_s=first,
             steady_s=steady,
             disparity=quantile_gates(out[:2], ref[:2], *LOCKSTEP_GATES),
             confidence=quantile_gates(out[2], ref[2], *LOCKSTEP_GATES))


def phase_main_path(jax, rep, h=H, w=W, batch=BATCH, bh=BH, bw=BW):
    import bench
    import __graft_entry__
    from ug_stereomatcher import MatcherConfig, StereoEngine, geom
    from ug_stereomatcher.geom.calibration import (CameraCalibration,
                                                       StereoCalibration)
    from ug_stereomatcher.pipeline.messages import GetDisparitiesRequest
    from ug_stereomatcher.pipeline.service import DisparityService

    left, right = bench._make_pair(h, w)          # host uint8 (H, W, 3)
    req = GetDisparitiesRequest(left=left, right=right)

    def serve(svc):
        ts, rsp = [], None
        for _ in range(3):
            t0 = time.perf_counter()
            rsp = svc(req)          # maps come back to the host as numpy
            ts.append(time.perf_counter() - t0)
        return rsp, ts

    svc1 = DisparityService(StereoEngine(MatcherConfig()))
    rsp, ts = serve(svc1)
    rep.emit("main_path/service_mode1", first_s=ts[0], steady_s=ts[1:],
             gates=value_gates(rsp.disp_h.image, rsp.disp_v.image,
                               "nearest"))
    mode1 = rsp

    svc2 = DisparityService(StereoEngine(MatcherConfig()), foveated=True)
    rsp, ts = serve(svc2)
    st = rsp.fdisp_h
    fh = st.roi_height
    assert st.image_stack.shape == (st.num_levels * fh, st.roi_width), \
        st.image_stack.shape
    rep.emit("main_path/service_mode2", first_s=ts[0], steady_s=ts[1:],
             stack_shape=list(st.image_stack.shape),
             gates_level0=value_gates(st.image_stack[:fh],
                                      rsp.fdisp_v.image_stack[:fh],
                                      "nearest"))

    import jax.numpy as jnp
    ld, rd = jax.block_until_ready((jnp.asarray(left), jnp.asarray(right)))
    for name, interp, early in (("mode1_bilinear", "bilinear", None),
                                ("mode1_nearest_ee", "nearest", 0.1),
                                ("mode1_bilinear_ee", "bilinear", 0.02)):
        eng = StereoEngine(MatcherConfig(interp=interp,
                                         early_exit_delta=early))
        res, first, steady = timed(jax, eng.match, ld, rd)
        rep.emit(f"main_path/{name}", first_s=first, steady_s=steady,
                 gates=value_gates(res.disparity_h, res.disparity_v, interp))

    # hierarchical: the periphery keeps coarse-level resolution by design
    # (hierarchicalDisparity pastes finer levels only into the centred
    # fovea windows), so the gates apply to the full-resolution fovea
    # window; the whole map must be finite
    eng = svc1.engine
    res, first, steady = timed(jax, eng.match_hierarchical, ld, rd)
    fh, fw = eng.config.fovea_dims(h, w)
    top, lft = h // 2 - fh // 2, w // 2 - fw // 2
    win = (slice(top, top + fh), slice(lft, lft + fw))
    dh_full = np.asarray(res.disparity_h)
    rep.emit("main_path/hierarchical", first_s=first, steady_s=steady,
             finite={"ok": bool(np.isfinite(dh_full).all())},
             whole_map=dict(value_gates(dh_full, res.disparity_v,
                                        "nearest"), ok=None),
             gates_fovea=value_gates(dh_full[win],
                                     np.asarray(res.disparity_v)[win],
                                     "nearest"))

    lb, rb = bench._make_pair(bh, bw, batch=batch)
    lb, rb = jax.block_until_ready((jnp.asarray(lb), jnp.asarray(rb)))
    res, first, steady = timed(jax, eng.match_batch, lb, rb)
    rep.emit("main_path/batch", batch=batch, shape=[bh, bw], first_s=first,
             steady_s=steady,
             gates=value_gates(res.disparity_h, res.disparity_v, "nearest"))

    # rectified rig built in code: right camera at -B on x, so a point at
    # depth Z appears at x + f*B/Z in the right image
    f_px, base = 4000.0, 0.1
    k = np.array([[f_px, 0, w / 2], [0, f_px, h / 2], [0, 0, 1]])
    rig = StereoCalibration(
        left=CameraCalibration(K=k, D=np.zeros(5),
                               P=k @ np.hstack([np.eye(3), np.zeros((3, 1))])),
        right=CameraCalibration(K=k, D=np.zeros(5),
                                P=k @ np.hstack([np.eye(3),
                                                 [[base], [0], [0]]])))
    t0 = time.perf_counter()
    cloud = geom.disparity_to_pointcloud(rig, mode1.disp_h.image,
                                         mode1.disp_v.image, left)
    cloud_s = time.perf_counter() - t0
    # an exact (3, 0) field must give Z = f*B/3 everywhere; the matched
    # field's depth must follow its own disparity (Z ~ f*B/dh on this rig;
    # its nonzero dv leaves a triangulation residual of about 1%)
    z_true = f_px * base / SHIFT
    exact = geom.disparity_to_pointcloud(rig, np.full((h, w), SHIFT),
                                         np.zeros((h, w)), left, sampling=8)
    exact_rel = np.abs(exact.xyz[:, 2] / z_true - 1)
    c = min(64, h // 8, w // 8)
    z = cloud.xyz[:, 2].reshape(h, w)[c:-c, c:-c]
    dh = np.asarray(mode1.disp_h.image, np.float64)[c:-c, c:-c]
    ok_px = dh > 1.0
    rel = float(np.median(np.abs(z[ok_px] * dh[ok_px] / (f_px * base) - 1)))
    rep.emit("main_path/pointcloud", first_s=cloud_s, points=len(cloud),
             median_depth_m=float(np.median(z)), depth_true_m=z_true,
             exact_field={"median_rel_depth_err": float(
                              np.median(exact_rel)),
                          "max_rel_depth_err": float(exact_rel.max()),
                          "ok": bool(exact_rel.max() < 1e-4)},
             check={"median_rel_err_vs_fB_over_dh": rel,
                    "ok": bool(len(cloud) == h * w and rel < 0.05
                               and np.isfinite(cloud.xyz).all())})

    fn, args = __graft_entry__.entry()
    out, first, steady = timed(jax, jax.jit(fn), *args)
    rep.emit("main_path/graft_entry", shape=list(out.shape), first_s=first,
             steady_s=steady,
             check={"ok": bool(out.shape == (3,) + args[0].shape[-2:]
                               and np.isfinite(np.asarray(out)).all())})
    return svc1.engine.config, left, right


def _device_events(pd):
    """(name, hlo_op, start_ns, duration_ns) of GPU kernel events, the host
    span of the ``steady_mode1`` annotation, and a small sample of the
    trace's planes and lines for reading by hand."""
    events, span, sample = [], None, []
    for plane in pd.planes:
        gpu = plane.name.startswith("/device:GPU")
        for line in plane.lines:
            evs = list(line.events)
            if gpu or len(sample) < 40:
                sample.append({"plane": plane.name, "line": line.name,
                               "events": len(evs), "first": [
                                   [e.name, dict(e.stats)] for e in evs[:2]]})
            for ev in evs:
                if ev.name == "steady_mode1":
                    span = (ev.start_ns, ev.start_ns + ev.duration_ns)
                if not gpu:
                    continue
                stats = dict(ev.stats)
                if ("hlo_op" in stats or "hlo_module" in stats
                        or "Stream" in line.name):
                    events.append((line.name, ev.name, stats.get("hlo_op"),
                                   ev.start_ns, ev.duration_ns))
    # a kernel can appear on a stream line and on derived lines; keep the
    # stream copy when there is one
    if any("Stream" in e[0] for e in events):
        events = [e for e in events if "Stream" in e[0]]
    seen, uniq = set(), []
    for _, name, op, start, dur in events:
        if (name, start, dur) not in seen:
            seen.add((name, start, dur))
            uniq.append((name, op, start, dur))
    return uniq, span, sample


def _trace(jax, out_dir, fn, *args):
    """Device events, window and trace sample of one steady call."""
    from jax.profiler import ProfileData

    jax.block_until_ready(fn(*args))  # warm
    trace_dir = tempfile.mkdtemp(dir=out_dir)
    with jax.profiler.trace(trace_dir):
        with jax.profiler.TraceAnnotation("steady_mode1"):
            jax.block_until_ready(fn(*args))
    paths = [os.path.join(d, f) for d, _, fs in os.walk(trace_dir)
             for f in fs if f.endswith(".xplane.pb")]
    events, span, sample = _device_events(ProfileData.from_file(paths[0]))
    with open(os.path.join(trace_dir, "trace_sample.json"), "w") as fh:
        json.dump(sample, fh, default=str, indent=1)
    if not events:
        raise RuntimeError("profile: no GPU kernel events in the trace")
    window = (span[1] - span[0]) if span else (
        max(s + d for _, _, s, d in events) - min(s for _, _, s, _ in events))
    return events, window, trace_dir


def phase_profile(jax, rep, cfg, left, right, out_dir):
    """Trace the mode-1 program twice: as served (XLA:GPU runs each loop
    body as a CUDA-graph command buffer, one event in the trace), for the
    device's busy and idle time; and compiled without command buffers, so
    every kernel is its own event and maps back to its named scope."""
    import jax.numpy as jnp
    from ug_stereomatcher import match as match_mod
    from ug_stereomatcher import pyramid as pyr

    h, w = left.shape[:2]
    args = [jnp.moveaxis(jnp.asarray(x), -1, 0).astype(jnp.float32)
            for x in (left, right)]

    def mode1(lt, rt):
        lp, rp = pyr.build_pyramid_pair(lt, rt, cfg, cfg.num_levels(h, w))
        return match_mod.match_pyramid(lp, rp, cfg, (h, w)).levels[0]

    lowered = jax.jit(mode1).lower(*args)
    served = lowered.compile()
    per_kernel = lowered.compile(
        compiler_options={"xla_gpu_enable_command_buffer": ""})
    events, window, _ = _trace(jax, out_dir, served, *args)
    as_served = reduce_device_events(events, {}, window)
    events, window, trace_dir = _trace(jax, out_dir, per_kernel, *args)
    red = reduce_device_events(events, scope_map(per_kernel.as_text()),
                               window)

    roofline = {}
    for i in (0, 1):
        lh, lw = cfg.dims_chain(h, w)[i]
        iters = cfg.iters_for_level(i)
        for stage, bpp in MIN_BYTES_PER_PX.items():
            t_ns = red["per_stage_ns"].get(f"level_{i:02d}/{stage}", 0.0)
            min_s = bpp * lh * lw * iters / HBM_BYTES_PER_S
            roofline[f"level_{i:02d}/{stage}"] = {
                "device_s": t_ns * 1e-9, "min_bytes": bpp * lh * lw * iters,
                "min_s_at_3.35TBps": min_s,
                "hbm_share": (min_s / (t_ns * 1e-9)) if t_ns else None}
    rep.emit("profile",
             served={"window_s": as_served["window_ns"] * 1e-9,
                     "device_busy_s": as_served["busy_ns"] * 1e-9,
                     "idle_share": as_served["idle_share"]},
             per_kernel={"window_s": red["window_ns"] * 1e-9,
                         "device_busy_s": red["busy_ns"] * 1e-9,
                         "idle_share": red["idle_share"],
                         "kernels": red["kernels"]},
             unattributed_top_s={k: v * 1e-9 for k, v in
                                 red["unattributed_top_ns"].items()},
             per_level_s={k: v * 1e-9
                          for k, v in sorted(red["per_level_ns"].items())},
             per_stage_s={k: v * 1e-9
                          for k, v in sorted(red["per_stage_ns"].items())},
             levels_0_1_vs_hbm=roofline, trace_dir=trace_dir)


def phase_four_cards(jax, rep, h=H, w=W, batch=BATCH, bh=BH, bw=BW):
    import bench
    import jax.numpy as jnp
    from functools import partial
    from ug_stereomatcher import MatcherConfig, StereoEngine
    from ug_stereomatcher import parallel as par

    devices = jax.devices()
    if len(devices) != 4:
        raise RuntimeError(f"--four-cards needs 4 devices, found "
                           f"{len(devices)}")
    cfg = MatcherConfig()

    def spread(x):
        """Devices holding shards of x (must be all four, not the first)."""
        return sorted({s.device.id for s in x.addressable_shards})

    lb, rb = bench._make_pair(bh, bw, batch=batch)
    lb = np.moveaxis(lb, -1, 1).astype(np.float32)
    rb = np.moveaxis(rb, -1, 1).astype(np.float32)
    mesh = par.make_mesh(4, 1)
    dp = jax.jit(lambda a, b: par.batch_match(a, b, cfg, mesh))
    out, first, steady = timed(jax, dp, jnp.asarray(lb), jnp.asarray(rb))
    one = jax.jit(lambda a, b: par.batch_match(a, b, cfg, None))
    with jax.default_device(devices[0]):
        ref, first1, steady1 = timed(jax, one, jnp.asarray(lb),
                                     jnp.asarray(rb))
    rep.emit("four_cards/dp_batch", mesh=[4, 1], batch=batch, shape=[bh, bw],
             devices_used=spread(out), first_s=first, steady_s=steady,
             one_card_first_s=first1, one_card_steady_s=steady1,
             spread={"ok": spread(out) == [d.id for d in devices]},
             vs_one_card=quantile_gates(out[:, :2], ref[:, :2],
                                        *FREE_RUN_GATES),
             gates=value_gates(out[:, 0], out[:, 1], "nearest"),
             gates_one_card=value_gates(ref[:, 0], ref[:, 1], "nearest"))

    left, right = bench._make_pair(h, w)
    ld = jnp.asarray(np.moveaxis(left, -1, 0).astype(np.float32))
    rd = jnp.asarray(np.moveaxis(right, -1, 0).astype(np.float32))
    mesh = par.make_mesh(1, 4)
    sp = jax.jit(lambda a, b: par.sharded_match_pair(
        a, b, cfg, mesh).levels[0])
    out, first, steady = timed(jax, sp, ld, rd)
    with jax.default_device(devices[0]):
        eng = StereoEngine(cfg)
        ref, first1, steady1 = timed(
            jax, lambda a, b: eng.match(a, b).triplet, jnp.asarray(left),
            jnp.asarray(right))
    rep.emit("four_cards/row_sharded_pair", mesh=[1, 4], shape=[h, w],
             devices_used=spread(out), first_s=first, steady_s=steady,
             one_card_first_s=first1, one_card_steady_s=steady1,
             spread={"ok": spread(out) == [d.id for d in devices]},
             vs_one_card=quantile_gates(out[:2], ref[:2], *FREE_RUN_GATES),
             gates=value_gates(out[0], out[1], "nearest"),
             gates_one_card=value_gates(ref[0], ref[1], "nearest"))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the four-card distribution phase")
    ap.add_argument("--trace-dir", default=None,
                    help="keep the profile traces here (default: a new "
                         "temporary directory)")
    args = ap.parse_args(argv)

    import jax
    require_gpu(jax.default_backend())
    card = gpu_line()
    print(card, flush=True)
    from ug_stereomatcher.compile_cache import ensure_compile_cache
    cache = ensure_compile_cache()

    dev = jax.devices()[0]
    rep = Reporter(jax, card)
    rep.emit("device", platform=dev.platform, kind=dev.device_kind,
             count=len(jax.devices()), jax=jax.__version__,
             compile_cache=cache, **parse_gpu_line(card))
    if args.four_cards:
        phase_four_cards(jax, rep)
    else:
        out_dir = args.trace_dir or tempfile.mkdtemp(prefix="chip_smoke_")
        os.makedirs(out_dir, exist_ok=True)
        phase_op_parity(jax, rep)
        phase_level_lockstep(jax, rep)
        cfg, left, right = phase_main_path(jax, rep)
        phase_profile(jax, rep, cfg, left, right, out_dir)
    print(last_line(dev.platform, dev.device_kind, len(jax.devices())),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
