"""StereoEngine — the in-process pipeline API.

Replaces the reference's ROS node layer (UG_GPU_matcher.cpp): one long-lived
jitted engine instead of a per-frame process that re-initialises CUDA and is
killed/respawned by a supervisor to contain leaks (matcher.py;
MatchGPULib.cpp:400 cudaDeviceReset per frame — anti-patterns deliberately
not replicated).

Modes:
  * ``match(left, right)``            — mode 1: full-resolution pyramid
    disparity (UG_GPU_matcher.cpp:421-491 non-foveated branch).
  * ``match_foveated(left, right)``   — mode 2: foveated per-level disparity
    stack + image stacks (UG_GPU_matcher.cpp:163-419).
  * ``match_hierarchical(left, right)`` — foveated match pasted back to a
    full-resolution map (MatchGPULib.cpp:355-360, service-style fov path).

Stacked outputs reproduce the reference's published layouts exactly
(vertical stacks of fovea-sized planes, level-major; image stacks
level-major with channel-major rows inside each level —
UG_GPU_matcher.cpp:203-213, 293-303).
"""

from __future__ import annotations

import dataclasses
import time
from functools import partial
from typing import Dict, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ug_stereomatcher.compile_cache import ensure_compile_cache
from ug_stereomatcher.config import MatcherConfig
from ug_stereomatcher.profiling import Timings
from ug_stereomatcher import match as match_mod
from ug_stereomatcher import pyramid as pyr


@dataclasses.dataclass
class MatchResult:
    """Full-resolution two-axis disparity + confidence (mode 1).

    The analog of the three stereo_msgs/DisparityImage messages published on
    output_disparityH/V/C (UG_GPU_matcher.cpp:50-52, 469-479)."""
    disparity_h: jnp.ndarray   # (H, W)
    disparity_v: jnp.ndarray   # (H, W)
    confidence: jnp.ndarray    # (H, W)

    @property
    def triplet(self) -> jnp.ndarray:
        return jnp.stack([self.disparity_h, self.disparity_v, self.confidence])


@dataclasses.dataclass
class FoveatedStackResult:
    """Foveated disparity stack (mode 2) — the analog of the foveatedstack
    messages on output_stackH/V/C (+ left/right pyramid stacks) with the
    metadata of msg/foveatedstack.msg:7-21."""
    stack_h: jnp.ndarray       # (num_levels * roi_height, roi_width);
    stack_v: jnp.ndarray       # batched results carry a leading (B,) axis
    stack_c: jnp.ndarray
    stack_left: Optional[jnp.ndarray]   # (num_levels*3*roi_height, roi_width)
    stack_right: Optional[jnp.ndarray]  # None for batched (match_batch) runs
    im_width: int
    im_height: int
    roi_width: int
    roi_height: int
    num_levels: int

    def level_disparity(self, level: int) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
        """Un-stack one level's (disp_h, disp_v, confidence); slices the
        row axis, so batched stacks keep their leading batch axis."""
        h = self.roi_height
        sl = slice(level * h, (level + 1) * h)
        return (self.stack_h[..., sl, :], self.stack_v[..., sl, :],
                self.stack_c[..., sl, :])

    def level_image(self, level: int, side: str = "left") -> jnp.ndarray:
        """Un-stack one level's (3, roi_height, roi_width) image."""
        h = self.roi_height
        stack = self.stack_left if side == "left" else self.stack_right
        if stack is None:
            raise ValueError("image stacks are not produced by batched "
                             "(match_batch) foveated runs")
        base = level * 3 * h
        chans = [stack[..., base + c * h: base + (c + 1) * h, :]
                 for c in range(3)]
        return jnp.stack(chans)


def _to_chw(image: np.ndarray | jnp.ndarray, dtype) -> jnp.ndarray:
    """Accept (H, W, 3) uint8/float or (3, H, W); return (3, H, W) float."""
    arr = jnp.asarray(image)
    if arr.ndim != 3:
        raise ValueError(f"expected 3-D RGB image, got shape {arr.shape}")
    if arr.shape[0] != 3 and arr.shape[-1] == 3:
        arr = jnp.moveaxis(arr, -1, 0)
    return arr.astype(dtype)


def _check_pair(left: jnp.ndarray, right: jnp.ndarray) -> None:
    if left.shape != right.shape:
        raise ValueError(
            f"stereo pair shapes differ: left {left.shape} vs right "
            f"{right.shape} — both images must have identical dimensions")


def _check_fovea(cfg: MatcherConfig, height: int, width: int) -> None:
    n = cfg.num_levels(height, width)
    if n < cfg.fovea_level:
        fh, fw = cfg.fovea_dims(height, width)
        raise ValueError(
            f"image {height}x{width} supports only {n} pyramid levels but "
            f"fovea_level={cfg.fovea_level} (fovea would be {fh}x{fw}); use "
            f"a larger image or MatcherConfig(fovea_level<={n})")


class StereoEngine:
    """Long-lived stereo matching engine with per-shape jit caching.

    Instrumentation (the reference's ``excutionTime`` bucket array +
    per-level clock_gettime logs, MatchGPULib.cpp:39, :1108-1117,
    :1265-1269, made first-class):

    * ``timings`` — cumulative per-entry-point wall-clock buckets
      (:class:`profiling.Timings`).
    * ``metrics`` — last-call snapshot: ``{entry}_s`` per entry point,
      plus the per-phase/per-level breakdown after :meth:`profile_match`.
    * ``sync_timing=True`` waits for the device (``block_until_ready``)
      after each call so the recorded time is true completion latency,
      not dispatch time; off by default to keep the hot path asynchronous.
    """

    def __init__(self, config: Optional[MatcherConfig] = None,
                 sync_timing: bool = False):
        ensure_compile_cache()
        self.config = config or MatcherConfig()
        self.sync_timing = sync_timing
        self._cache: Dict[Tuple, object] = {}
        self.timings = Timings()
        self.metrics: Dict[str, object] = {}

    # ------------------------------------------------------------------
    def _record(self, name: str, t0: float, sync_on=None) -> None:
        """Record one entry-point timing bucket + last-call metric."""
        if self.sync_timing and sync_on is not None:
            jax.block_until_ready(sync_on)
        dt = time.perf_counter() - t0
        self.timings.record(name, dt)
        self.metrics[f"{name}_s"] = round(dt, 6)

    # ------------------------------------------------------------------
    def _dtype(self):
        return jnp.dtype(self.config.dtype)

    def _jitted(self, key, builder):
        fn = self._cache.get(key)
        if fn is None:
            fn = builder()
            self._cache[key] = fn
        return fn

    # ------------------------------------------------------------------
    # Mode 1: full-resolution pyramid matching
    # ------------------------------------------------------------------
    def match(self, left, right) -> MatchResult:
        """Full-resolution two-axis disparity for an RGB pair.

        Reference path: MatchGPULib.cpp:303 ``match`` with fov=0 — pyramid
        build, coarse-to-fine matching, return the finest level."""
        cfg = self.config
        left = _to_chw(left, self._dtype())
        right = _to_chw(right, self._dtype())
        _check_pair(left, right)
        h, w = left.shape[-2:]
        fn = self._jitted(("match", h, w, cfg), lambda: jax.jit(
            partial(self._match_impl, height=h, width=w)))
        t0 = time.perf_counter()
        trip = fn(left, right)
        self._record("match", t0, sync_on=trip)
        return MatchResult(trip[0], trip[1], trip[2])

    def _match_impl(self, left, right, *, height, width):
        cfg = self.config
        n = cfg.num_levels(height, width)
        lp, rp = pyr.build_pyramid_pair(left, right, cfg, n)
        res = match_mod.match_pyramid(lp, rp, cfg, (height, width),
                                      foveated=False)
        return res.levels[0]

    # ------------------------------------------------------------------
    # Mode 2: foveated stack matching
    # ------------------------------------------------------------------
    def match_foveated(self, left, right) -> FoveatedStackResult:
        """Foveated per-level disparity stack for an RGB pair.

        Reference path: matchStackPyramid (MatchGPULib.cpp:534) + the node's
        stack reshaping (UG_GPU_matcher.cpp:163-369)."""
        cfg = self.config
        left = _to_chw(left, self._dtype())
        right = _to_chw(right, self._dtype())
        _check_pair(left, right)
        h, w = left.shape[-2:]
        _check_fovea(cfg, h, w)
        fov_h, fov_w = cfg.fovea_dims(h, w)
        fn = self._jitted(("fov", h, w, cfg), lambda: jax.jit(
            partial(self._match_foveated_impl, height=h, width=w)))
        t0 = time.perf_counter()
        out = fn(left, right)
        stack_h, stack_v, stack_c, stack_l, stack_r = out
        self._record("match_foveated", t0, sync_on=out)
        return FoveatedStackResult(
            stack_h=stack_h, stack_v=stack_v, stack_c=stack_c,
            stack_left=stack_l, stack_right=stack_r,
            im_width=w, im_height=h,
            roi_width=fov_w, roi_height=fov_h,
            num_levels=cfg.fovea_level)

    def _match_foveated_impl(self, left, right, *, height, width):
        cfg = self.config
        n = cfg.num_levels(height, width)
        lp, rp = pyr.build_pyramid_pair(left, right, cfg, n)
        lf = pyr.foveate_pyramid(lp, cfg, (height, width))
        rf = pyr.foveate_pyramid(rp, cfg, (height, width))
        res = match_mod.match_pyramid(lf, rf, cfg, (height, width),
                                      foveated=True)
        k = cfg.fovea_level
        # Disparity stacks: level-major vertical stack of fovea-sized planes.
        stack_h = jnp.concatenate([res.levels[i][0] for i in range(k)], axis=0)
        stack_v = jnp.concatenate([res.levels[i][1] for i in range(k)], axis=0)
        stack_c = jnp.concatenate([res.levels[i][2] for i in range(k)], axis=0)
        # Image stacks: level-major, channel-major rows inside each level
        # (UG_GPU_matcher.cpp:203-213).
        stack_l = jnp.concatenate(
            [lf[i].reshape(-1, lf[i].shape[-1]) for i in range(k)], axis=0)
        stack_r = jnp.concatenate(
            [rf[i].reshape(-1, rf[i].shape[-1]) for i in range(k)], axis=0)
        return (stack_h, stack_v, stack_c, stack_l, stack_r)

    # ------------------------------------------------------------------
    def match_hierarchical(self, left, right) -> MatchResult:
        """Foveated match reconstructed to a full-resolution map: sharp
        fovea, progressively blurrier periphery (match(fov=1) path,
        MatchGPULib.cpp:355-360 -> hierarchicalDisparity:2589)."""
        cfg = self.config
        left = _to_chw(left, self._dtype())
        right = _to_chw(right, self._dtype())
        _check_pair(left, right)
        h, w = left.shape[-2:]
        _check_fovea(cfg, h, w)
        fn = self._jitted(("hier", h, w, cfg), lambda: jax.jit(
            partial(self._match_hierarchical_impl, height=h, width=w)))
        t0 = time.perf_counter()
        trip = fn(left, right)
        self._record("match_hierarchical", t0, sync_on=trip)
        return MatchResult(trip[0], trip[1], trip[2])

    def _match_hierarchical_impl(self, left, right, *, height, width):
        cfg = self.config
        n = cfg.num_levels(height, width)
        lp, rp = pyr.build_pyramid_pair(left, right, cfg, n)
        lf = pyr.foveate_pyramid(lp, cfg, (height, width))
        rf = pyr.foveate_pyramid(rp, cfg, (height, width))
        res = match_mod.match_pyramid(lf, rf, cfg, (height, width),
                                      foveated=True)
        return pyr.hierarchical_disparity(res.levels, cfg, (height, width))

    # ------------------------------------------------------------------
    def match_batch(self, left_batch, right_batch, mesh=None,
                    foveated: bool = False):
        """Match a batch of pairs at once (optionally sharded over a mesh's
        'pairs' axis — see parallel.batch_match).  Inputs: (B, H, W, 3) or
        (B, 3, H, W).  Returns a MatchResult whose planes carry a leading
        batch axis, or — with ``foveated=True`` (mode 2, the reference's
        throughput configuration, /root/reference/README.md:16) — a
        FoveatedStackResult whose disparity stacks carry a leading batch
        axis (image stacks are not materialised in batch mode)."""
        from ug_stereomatcher.parallel.batch import make_batch_matcher
        lb = jnp.asarray(left_batch)
        rb = jnp.asarray(right_batch)
        if lb.ndim != 4:
            raise ValueError(f"expected a 4-D batch, got {lb.shape}")
        if lb.shape[1] != 3 and lb.shape[-1] == 3:
            lb = jnp.moveaxis(lb, -1, 1)
            rb = jnp.moveaxis(rb, -1, 1)
        if lb.shape[1] != 3:
            raise ValueError(
                f"expected RGB batches (B,3,H,W) or (B,H,W,3), got {lb.shape}")
        if lb.shape != rb.shape:
            raise ValueError(
                f"batch shapes differ: {lb.shape} vs {rb.shape}")
        lb = lb.astype(self._dtype())
        rb = rb.astype(self._dtype())
        h, w = lb.shape[-2:]
        if foveated:
            _check_fovea(self.config, h, w)
        # cache the jitted batch pipeline per (shape, mesh) like the other
        # entry points — re-tracing 14 pyramid levels per call is slow
        mesh_key = (tuple(mesh.shape.items()),
                    tuple(d.id for d in mesh.devices.flat)) if mesh else None
        fn = self._jitted(
            ("batch", lb.shape, self.config, mesh_key, foveated),
            lambda: make_batch_matcher(self.config, h, w, mesh,
                                       foveated=foveated))
        t0 = time.perf_counter()
        out = fn(lb, rb)
        self._record("match_batch", t0, sync_on=out)
        if foveated:
            fov_h, fov_w = self.config.fovea_dims(h, w)
            return FoveatedStackResult(
                stack_h=out[:, 0], stack_v=out[:, 1], stack_c=out[:, 2],
                stack_left=None, stack_right=None,
                im_width=w, im_height=h,
                roi_width=fov_w, roi_height=fov_h,
                num_levels=self.config.fovea_level)
        return MatchResult(out[:, 0], out[:, 1], out[:, 2])

    def profile_match(self, left, right) -> Tuple[MatchResult, Dict]:
        """Mode-1 match with a per-phase / per-level timing breakdown.

        Runs the same computation as :meth:`match` but split into separately
        jitted stages (pyramid build, each level's refinement, each upsample)
        with a forced scalar readback between stages, so each bucket is true
        device latency — the programmatic form of the reference's per-level
        logs (MatchGPULib.cpp:1265-1269) and ``excutionTime`` phase buckets
        (:39, :1108-1117).

        Per-stage sync serialises the pipeline, so the total runs slower
        than :meth:`match` — use this for analysis, not serving.  Results
        are identical to :meth:`match` (same staged math; only the jit
        partitioning differs... up to XLA cross-stage fusion float noise —
        compare with tolerances, per the chaos rule).

        Returns ``(MatchResult, breakdown)`` and stores the breakdown at
        ``self.metrics["profile"]``."""
        cfg = self.config
        left = _to_chw(left, self._dtype())
        right = _to_chw(right, self._dtype())
        _check_pair(left, right)
        h, w = left.shape[-2:]
        n = cfg.num_levels(h, w)
        dims = match_mod.level_dims_for_matching(cfg, h, w, n, False)

        sync = jax.block_until_ready

        build = self._jitted(("prof_build", h, w, cfg), lambda: jax.jit(
            partial(self._profile_build, n=n)))
        levels: Dict[str, Dict[str, float]] = {}
        t_all = time.perf_counter()

        t0 = time.perf_counter()
        lp, rp = build(left, right)
        sync((lp, rp))
        build_s = time.perf_counter() - t0

        hh, ww = dims[n - 1]
        disp = jnp.zeros((3, hh, ww), dtype=left.dtype)
        trip = None
        for i in range(n - 1, -1, -1):
            step = self._jitted(("prof_level", i, dims[i], cfg),
                                lambda i=i: jax.jit(partial(
                                    match_mod.match_level, level_index=i,
                                    cfg=cfg, is_coarsest=(i == n - 1))))
            t0 = time.perf_counter()
            disp = step(lp[i], rp[i], disp)
            sync(disp)
            lvl = {"match_s": round(time.perf_counter() - t0, 6),
                   "height": dims[i][0], "width": dims[i][1],
                   "iterations": cfg.iters_for_level(i)}
            if i > 0:
                h2, w2 = dims[i - 1]
                up = self._jitted(("prof_up", dims[i], (h2, w2), cfg),
                                  lambda h2=h2, w2=w2: jax.jit(partial(
                                      pyr.upsample_to_level, out_h=h2,
                                      out_w=w2, cfg=cfg)))
                t0 = time.perf_counter()
                disp = up(disp)
                sync(disp)
                lvl["upsample_s"] = round(time.perf_counter() - t0, 6)
            levels[f"level_{i:02d}"] = lvl
            trip = disp

        breakdown = {
            "pyramid_build_s": round(build_s, 6),
            "levels": levels,
            "match_total_s": round(sum(
                v["match_s"] + v.get("upsample_s", 0.0)
                for v in levels.values()), 6),
            "total_s": round(time.perf_counter() - t_all, 6),
        }
        self.metrics["profile"] = breakdown
        return MatchResult(trip[0], trip[1], trip[2]), breakdown

    def _profile_build(self, left, right, *, n):
        lp, rp = pyr.build_pyramid_pair(left, right, self.config, n)
        return tuple(lp), tuple(rp)

    def warmup(self, height: int, width: int, foveated: bool = False) -> None:
        """Pre-compile the pipeline for a given image size (a 16MP first
        compile takes tens of seconds; call this before serving)."""
        z = jnp.zeros((3, height, width), self._dtype())
        if foveated:
            self.match_foveated(z, z)
        else:
            self.match(z, z)

    # ------------------------------------------------------------------
    def match_with_consistency(self, left, right, tau: float = 1.0):
        """Bidirectional match + left-right consistency validation.

        Runs the matcher both ways (the backward pass swaps the images) and
        cross-checks the fields; returns (MatchResult for left->right,
        consistency mask (H, W) bool, LR error (H, W)).  Not in the
        reference — a production validity layer over its algorithm."""
        from ug_stereomatcher.ops.consistency import lr_consistency_mask
        fwd = self.match(left, right)
        bwd = self.match(right, left)
        mask, err = lr_consistency_mask(
            fwd.disparity_h, fwd.disparity_v,
            bwd.disparity_h, bwd.disparity_v,
            tau=tau, method=self.config.interp)
        return fwd, mask, err

    # ------------------------------------------------------------------
    def get_disparities(self, left, right, foveated: bool = False):
        """Synchronous service-style entry point — the GetDisparitiesGPU
        service analog (srv/GetDisparitiesGPU.srv; UG_GPU_matcher.cpp:497).

        Returns a MatchResult (non-foveated) or FoveatedStackResult."""
        if foveated:
            return self.match_foveated(left, right)
        return self.match(left, right)
