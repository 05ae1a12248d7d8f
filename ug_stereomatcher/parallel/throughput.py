"""Throughput / scaling harness.

Measures matched pairs per second for the batched (data-parallel) engine at
1..N devices — the Glasgow-database throughput configuration of SURVEY.md
§2.5/§7.  On real hardware the mesh spans cards/hosts; in tests it runs
on the virtual CPU device mesh, validating scaling *efficiency* (the
collective-free DP path should scale ~linearly).
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Dict, List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ug_stereomatcher.config import MatcherConfig
from ug_stereomatcher.parallel.batch import make_batch_matcher
from ug_stereomatcher.parallel.mesh import make_mesh


@dataclasses.dataclass
class ThroughputPoint:
    n_devices: int
    batch: int
    seconds_per_batch: float
    pairs_per_second: float
    scaling_efficiency: float  # vs the 1-device point
    mesh_shape: tuple = (1, 1)  # (pairs_axis, rows_axis)
    oversubscribed: bool = False  # more devices than physical cores


def _mesh_shape(mode: str, nd: int, pairs_per_device: int
                ) -> Tuple[int, int, int]:
    """(pairs_axis, rows_axis, batch) for a scaling point.

    * ``dp``     — pairs-only: (nd, 1), batch = nd * ppd (the collective-
      free Glasgow-database configuration).
    * ``sp``     — rows-only spatial parallelism: (1, nd), batch = ppd —
      latency scaling of ONE pair row-sharded across all devices
      (SURVEY.md §5 long-context analog).
    * ``hybrid`` — DP x SP: pairs axis capped at 2, rows take the rest —
      the pod-slice shape when batch < devices (parallel/batch.py
      _make_hybrid_matcher)."""
    if mode == "dp":
        return nd, 1, nd * pairs_per_device
    if mode == "sp":
        return 1, nd, pairs_per_device
    if mode == "hybrid":
        p = min(2, nd)
        return p, nd // p, p * pairs_per_device
    raise ValueError(f"unknown scaling mode {mode!r}")


def measure_throughput(height: int = 192, width: int = 256,
                       device_counts: Optional[Sequence[int]] = None,
                       pairs_per_device: int = 1,
                       cfg: Optional[MatcherConfig] = None,
                       repeats: int = 3,
                       mode: str = "dp",
                       foveated: bool = False) -> List[ThroughputPoint]:
    """Run the batched matcher at each device count; returns scaling
    points.  ``mode`` picks the mesh shape per point (see _mesh_shape):
    'dp' measures throughput scaling, 'sp' latency scaling of a single
    row-sharded pair, 'hybrid' the DP x SP composition.  ``foveated``
    benches mode 2 (the stacked fovea triplet per pair) — the
    reference's throughput configuration (README.md:16); requires
    enough pyramid levels for ``cfg.fovea_level`` at this size."""
    cfg = cfg or MatcherConfig()
    if foveated and cfg.num_levels(height, width) < cfg.fovea_level:
        raise ValueError(
            f"{height}x{width} supports only "
            f"{cfg.num_levels(height, width)} levels but fovea_level="
            f"{cfg.fovea_level}; lower MatcherConfig.fovea_level")
    devices = jax.devices()
    if device_counts is None:
        n = len(devices)
        device_counts = [d for d in (1, 2, 4, 8, 16, 32) if d <= n]
    if mode == "hybrid":
        device_counts = [d for d in device_counts if d % 2 == 0 or d == 1]
    cores = os.cpu_count() or 1
    rng = np.random.RandomState(0)

    points: List[ThroughputPoint] = []
    base_pps = None
    for nd in device_counts:
        pairs_ax, rows_ax, b = _mesh_shape(mode, nd, pairs_per_device)
        left = rng.rand(b, 3, height, width).astype(np.float32) * 255
        right = np.roll(left, 2, axis=-1)
        mesh = make_mesh(n_pairs_axis=pairs_ax, n_rows_axis=rows_ax,
                         devices=devices[:nd])
        lj, rj = jnp.asarray(left), jnp.asarray(right)
        # Build the jitted matcher ONCE per device count and time calls to
        # the cached fn — a fresh make_batch_matcher per repeat would
        # re-trace the whole pyramid and measure compile time instead of
        # steady-state throughput (same per-shape caching rule as
        # StereoEngine.match_batch).
        fn = make_batch_matcher(cfg, height, width, mesh,
                                foveated=foveated)

        def run():
            return jax.block_until_ready(fn(lj, rj))

        run()  # compile
        times = []
        for _ in range(repeats):
            t0 = time.perf_counter()
            run()
            times.append(time.perf_counter() - t0)
        sec = min(times)
        pps = b / sec
        if base_pps is None:
            base_pps = pps / nd  # per-device baseline from the first point
        eff = pps / (base_pps * nd)
        points.append(ThroughputPoint(
            n_devices=nd, batch=b, seconds_per_batch=round(sec, 4),
            pairs_per_second=round(pps, 3),
            scaling_efficiency=round(eff, 3),
            mesh_shape=(pairs_ax, rows_ax),
            oversubscribed=nd > cores))
    return points
