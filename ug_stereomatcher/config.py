"""Typed configuration for the stereo matcher.

Replaces the reference's three config tiers (ROS parameter server, argv, and
compile-time constants in src/gpu_matcher/MatchLib_common.h:10-28 plus host
globals at src/gpu_matcher/MatchGPULib.cpp:35-40) with one frozen dataclass
consumed by pure functions.  Every numerical constant is documented against
the reference behaviour it reproduces.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import numpy as np

# The reference's SCALE constant (MatchLib_common.h:15).  Note this is the
# *truncated* literal 1.41421356, not math.sqrt(2); the integer dimension
# chains divide by this exact double, so we must too.
REFERENCE_SCALE = 1.41421356

# Hard-coded normalized 5-tap Gaussian the reference actually uses: the
# computed sigma=1.1 kernel is overwritten at MatchGPULib.cpp:761-765 and then
# re-normalized by its own sum (:766-774).
_RAW_GAUSSIAN = np.array(
    [0.0816475, 0.218507, 0.303281, 0.218507, 0.0816475], dtype=np.float64
)

# 3-tap average kernel in 5-tap storage (MatchGPULib.cpp:344-350).  The taps
# are the literal 0.3333 (not 1/3) — each separable pass attenuates by
# 0.9999, which is observable over 22 iterations, so we keep the literal.
_AVERAGE = np.array([0.0, 0.3333, 0.3333, 0.3333, 0.0], dtype=np.float64)

# Correlation search moves (MatchGPULib.cpp:1677): left, right, up, down,
# centre.  The horizontal parabola reads (left, centre, right); vertical
# reads (up, centre, down) — calculatePolyDisparity call sites,
# MatchGPULib.cpp:2129-2154.  One canonical copy: the single-device and the
# row-sharded level bodies iterate the SAME moves in the SAME order.
MOVES: Tuple[Tuple[int, int], ...] = ((-1, 0), (1, 0), (0, -1), (0, 1),
                                      (0, 0))


def gaussian_kernel() -> np.ndarray:
    """The effective 5-tap Gaussian blur kernel (float32, sums to 1)."""
    k = _RAW_GAUSSIAN / _RAW_GAUSSIAN.sum()
    return k.astype(np.float32)


def average_kernel() -> np.ndarray:
    """The 5-tap 'average' kernel used for final per-iteration smoothing."""
    return _AVERAGE.astype(np.float32)


def analytic_gaussian_kernel(sigma: float = 1.1, radius: int = 2,
                             precision: int = 5) -> np.ndarray:
    """The 5-sample-averaged discrete Gaussian the reference *computes*
    (MatchGPULib.cpp:735-760) before overwriting it.  Provided for
    completeness/experimentation; not used on the default path."""
    length = 2 * radius + 1
    mid = length // 2 + 1
    k = np.zeros(length, dtype=np.float64)
    for i in range(length):
        acc = 0.0
        for n in range(precision):
            t = i + 0.5 - mid + (n / (precision - 1.0))
            acc += math.exp(-(t * t) / (2 * sigma * sigma)) / (
                math.sqrt(2 * math.pi) * sigma
            )
        k[i] = acc / precision
    k /= k.sum()
    return k.astype(np.float32)


@dataclasses.dataclass(frozen=True)
class MatcherConfig:
    """Algorithm configuration.

    Defaults reproduce the reference contract exactly; see field comments for
    the file:line provenance of each constant.
    """

    # Pyramid ------------------------------------------------------------
    max_level: int = 14              # MatchLib_common.h:13 (MAX_LEVEL)
    scale: float = REFERENCE_SCALE   # MatchLib_common.h:15 (SCALE)
    min_dim: int = 8                 # auto-clamp pyramid depth for small inputs
                                     # (the reference assumes 16MP inputs and
                                     # would degenerate to 0-size levels)

    # Foveation ----------------------------------------------------------
    fovea_level: int = 7             # MatchGPULib.cpp:259-264 (argv override, default 7)

    # Iteration schedule -------------------------------------------------
    level_cutoff: int = 22           # MatchGPULib.cpp:37 (levelcutoff)
    coarse_min_index: int = 6        # levels with pyramid index > 5 get
                                     # level_cutoff iterations (MatchGPULib.cpp:1741)
    # Opt-in convergence early exit (NON-parity: the reference always runs
    # the full schedule, but ships the dormant machinery for this —
    # weightedDifference + differenceIterations, MatchGPULib.cpp:1323-1437).
    # When set, the level loop of each level finer than coarse_min_index
    # becomes a lax.while_loop that stops once an iteration's
    # confidence-weighted mean |disparity change| drops below this value
    # on BOTH axes.  The coarse levels always run their full 22-iteration
    # schedule: they cost little, and exiting there early leaves vertical
    # disparity unconverged that the short fine schedules cannot repair
    # (bilinear at 0.02 on a 1MP or 16MP octave-texture pair: mean |dv|
    # error > 1 px, q99 ~48 px, against 0.02 px with the coarse schedule
    # intact).  Scope: the
    # single-device scan path and the pure-DP batch path (lax.map runs the
    # same while_loop per pair) honor it; the ROW-SHARDED level bodies
    # (parallel/spatial.py, i.e. sharded_match_pair and hybrid DP x SP
    # meshes) run the fixed schedule regardless — an early exit there
    # would need a cross-shard convergence collective every iteration,
    # which costs more than the iterations it saves on the coarse levels
    # it could skip.  sharded_match_pair warns once if it is set.
    # Typical useful range 1e-3..1e-2 px; None = parity.
    early_exit_delta: Optional[float] = None
    smooth_passes: int = 5           # MatchGPULib.cpp:38 (smoothtime)
    smooth_passes_fine: int = 10     # MatchGPULib.cpp:2259-2261 (level>11 → 10)
    fine_smooth_levels: int = 2      # pyramid indices i<2 use smooth_passes_fine

    # Confidence ---------------------------------------------------------
    conf_blend_new: float = 0.75     # MatchLib.cu:1005 (TrueConfidence)
    conf_blend_old: float = 0.25
    conf_no_peak: float = 0.4        # MatchLib.cu:835 (no parabola maximum)
    conf_affine_scale: float = 0.3   # MatchLib.cu:830 (0.3*cstar + 0.7)
    conf_affine_bias: float = 0.7

    # Threshold (clamp) decay schedule ----------------------------------
    threshold_init: float = 1.0      # MatchGPULib.cpp:1673
    threshold_floor: float = 0.1     # MatchGPULib.cpp:2301
    threshold_decay_window: int = 7  # MatchGPULib.cpp:2300

    # Sampling semantics -------------------------------------------------
    # The reference's CUDA texture objects never set filterMode, so they use
    # the default cudaFilterModePoint (nearest) with clamp addressing — every
    # resample/warp/shift is a nearest-neighbour gather at (ix+0.5)+offset
    # coordinates (MatchLib.cu:56-60, :322-323, :512-514).  "bilinear" is the
    # higher-quality option this framework adds.
    interp: str = "nearest"

    # Reference quirks kept for parity (each documented; flip deliberately) -
    # subsampleDisp / partsubsampleDisp scale *all three* channels by SCALE —
    # including the confidence plane (MatchGPULib.cpp:1279 applies the kernel
    # to channels [H,V,C]).
    scale_conf_on_upsample: bool = True

    # Numerics -----------------------------------------------------------
    # Compute dtype for the iteration state; float32 matches the reference.
    dtype: str = "float32"

    # ---------------------------------------------------------------------
    def num_levels(self, height: int, width: int) -> int:
        """Number of usable pyramid levels for an input of (height, width).

        The reference always builds max_level levels (assuming 16MP inputs);
        we clamp so no level dimension falls below min_dim."""
        dims = self.dims_chain(height, width)
        n = 0
        for (h, w) in dims:
            if h < self.min_dim or w < self.min_dim:
                break
            n += 1
        return max(1, n)

    def dims_chain(self, height: int, width: int) -> Tuple[Tuple[int, int], ...]:
        """The truncated-integer dimension chain dims[i+1] = int(dims[i]/SCALE).

        Reproduces MatchGPULib.cpp:1224-1228 exactly (C++ int division by the
        double SCALE)."""
        out = [(height, width)]
        h, w = height, width
        for _ in range(self.max_level - 1):
            h = int(h / self.scale)
            w = int(w / self.scale)
            out.append((h, w))
        return tuple(out)

    def fovea_dims(self, height: int, width: int) -> Tuple[int, int]:
        """Fovea (h, w): dims of level fovea_level-1 (MatchGPULib.cpp:406-426)."""
        dims = self.dims_chain(height, width)
        return dims[self.fovea_level - 1]

    def iters_for_level(self, level_index: int) -> int:
        """Iteration count mi for pyramid index i (0 = finest).

        mi = level_cutoff if i > 5 else (i+1)*2   (MatchGPULib.cpp:1741)."""
        if level_index >= self.coarse_min_index:
            return self.level_cutoff
        return (level_index + 1) * 2

    def smooth_passes_for_level(self, level_index: int) -> int:
        """Smoothing repetitions per iteration (MatchGPULib.cpp:2257-2261)."""
        if level_index < self.fine_smooth_levels:
            return self.smooth_passes_fine
        return self.smooth_passes

    def threshold_schedule(self, mi: int) -> Tuple[float, ...]:
        """Clamp threshold for each iteration m=1..mi.

        The reference updates `threshold` after every even iteration
        (MatchGPULib.cpp:2299-2306):

            if (mi/2 - m/2) < 7:  threshold = ((mi/2 - m/2) - 1)*(0.9/(mi/2 - 1)) + 0.1
            else:                 threshold = 1.0

        (integer division).  The new value takes effect from iteration m+1.
        For mi == 2 the update divides by zero, but the result is never used
        (the level has already finished); we simply don't emit it."""
        th = self.threshold_init
        sched = []
        half = mi // 2
        for m in range(1, mi + 1):
            sched.append(th)
            if m % 2 == 0 and m < mi:
                rem = half - m // 2
                if rem < self.threshold_decay_window:
                    span = 1.0 - self.threshold_floor
                    th = (rem - 1) * (span / (half - 1.0)) + self.threshold_floor
                else:
                    th = self.threshold_init
        return tuple(sched)

    # The five correlation search moves (MatchGPULib.cpp:1677): left, right,
    # up, down, centre — in that order.  The first two feed the horizontal
    # parabola fit, the middle two the vertical one.
    @property
    def moves(self) -> Tuple[Tuple[float, float], ...]:
        t = self.threshold_init
        return ((-t, 0.0), (t, 0.0), (0.0, -t), (0.0, t), (0.0, 0.0))

    # -----------------------------------------------------------------
    @classmethod
    def from_file(cls, path: str) -> "MatcherConfig":
        """Load a config from a YAML or JSON file — the launch-file /
        parameter-server analog (stereo_nodes*.launch parameters become
        plain keys).  Unknown keys raise, so typos don't silently fall
        back to defaults (unlike ROS param lookups)."""
        import json

        with open(path) as fh:
            if path.endswith((".yaml", ".yml")):
                import yaml
                data = yaml.safe_load(fh) or {}
            else:
                data = json.load(fh)
        if not isinstance(data, dict):
            raise ValueError(f"{path}: expected a mapping of config fields")
        valid = {f.name for f in dataclasses.fields(cls)}
        unknown = set(data) - valid
        if unknown:
            raise ValueError(
                f"{path}: unknown config fields {sorted(unknown)}; valid "
                f"fields: {sorted(valid)}")
        return cls(**data)
