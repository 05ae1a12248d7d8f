"""Pair-batch data parallelism.

Shards a batch of stereo pairs across the 'pairs' mesh axis — the
multi-device counterpart of running the Glasgow 80-pair database through
the matcher (SURVEY.md §2.5 'pair-batch data parallelism').  No cross-pair
communication is needed.

Dispatch shape: each device's local batch runs through ``lax.map`` (a scan —
one trace, sequential execution), NOT ``vmap``: one pair at a time bounds
the peak device memory to a single pair's pyramid and level intermediates,
where ``vmap`` would hold the whole local batch's at once.  Cross-pair
parallelism comes from the mesh's 'pairs' axis via ``shard_map``.
"""

from __future__ import annotations

from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh, PartitionSpec as P

from ug_stereomatcher.config import MatcherConfig
from ug_stereomatcher import match as match_mod
from ug_stereomatcher import pyramid as pyr


def _single_pair(left, right, cfg: MatcherConfig, height: int, width: int):
    n = cfg.num_levels(height, width)
    lp, rp = pyr.build_pyramid_pair(left, right, cfg, n)
    res = match_mod.match_pyramid(lp, rp, cfg, (height, width),
                                  foveated=False)
    return res.levels[0]


def _stack_fovea_levels(levels, k: int):
    """Level-major vertical stack of the k fovea-sized (…, 3, fh, fw)
    planes — the per-pair analog of the node's output_stackH/V/C layout
    (UG_GPU_matcher.cpp:203-213), kept as one (…, 3, k*fh, fw) triplet."""
    return jnp.concatenate([levels[i] for i in range(k)], axis=-2)


def _single_pair_foveated(left, right, cfg: MatcherConfig, height: int,
                          width: int):
    """Mode-2 (foveated) single-pair body: returns the stacked per-level
    disparity triplet (3, fovea_level*fh, fw).  Reference path:
    matchStackPyramid (MatchGPULib.cpp:534) — the throughput mode
    (3 s vs 10 s per 16MP pair, /root/reference/README.md:16)."""
    n = cfg.num_levels(height, width)
    lp, rp = pyr.build_pyramid_pair(left, right, cfg, n)
    lf = pyr.foveate_pyramid(lp, cfg, (height, width))
    rf = pyr.foveate_pyramid(rp, cfg, (height, width))
    res = match_mod.match_pyramid(lf, rf, cfg, (height, width),
                                  foveated=True)
    return _stack_fovea_levels(res.levels, cfg.fovea_level)


def make_batch_matcher(cfg: MatcherConfig, height: int, width: int,
                       mesh: Optional[Mesh] = None,
                       foveated: bool = False):
    """Build a reusable jitted batch matcher: (B,3,H,W) x2 -> (B,3,H,W)
    (mode 1), or -> (B,3,fovea_level*fh,fw) stacked fovea triplets with
    ``foveated=True`` (mode 2 — the reference's throughput configuration).

    Build it once and call it per batch — a fresh jax.jit wrapper per call
    would re-trace the whole pyramid each time.  With a mesh, the batch
    axis shards over 'pairs' (batches that don't divide the axis are padded
    with the last pair and sliced back)."""
    single = partial(_single_pair_foveated if foveated else _single_pair,
                     cfg=cfg, height=height, width=width)

    def local_map(lb, rb):
        return lax.map(lambda pair: single(pair[0], pair[1]), (lb, rb))

    if mesh is None:
        return jax.jit(local_map)

    if "rows" in mesh.shape and mesh.shape["rows"] > 1:
        # Hybrid DP x SP: each pairs-group row-shards its pair across its
        # rows-group (sharded_match_pair with a pairs axis), so ALL mesh
        # devices do useful work when batch < n_devices (SURVEY.md §2.5:
        # pair-batch DP x tile sharding as one mesh).  The batch is
        # processed in chunks of the pairs-axis size by ONE cached jitted
        # step (a host loop, not one unrolled graph per batch size).
        return _make_hybrid_matcher(cfg, height, width, mesh,
                                    foveated=foveated)

    n_pairs = mesh.shape["pairs"]
    spec = P("pairs")
    sharded = jax.shard_map(local_map, mesh=mesh, in_specs=(spec, spec),
                            out_specs=spec, check_vma=False)

    def fn(lb, rb):
        b = lb.shape[0]
        pad = (-b) % n_pairs
        if pad:
            lb = jnp.concatenate([lb, jnp.broadcast_to(
                lb[-1:], (pad,) + lb.shape[1:])])
            rb = jnp.concatenate([rb, jnp.broadcast_to(
                rb[-1:], (pad,) + rb.shape[1:])])
        return sharded(lb, rb)[:b]

    # no explicit in_shardings: an uneven batch can't satisfy a P('pairs')
    # input constraint — the shard_map inside the jit pins the (padded)
    # batch layout and GSPMD inserts the reshard
    return jax.jit(fn)


def _make_hybrid_matcher(cfg: MatcherConfig, height: int, width: int,
                         mesh: Mesh, foveated: bool = False):
    """DP x SP batch matcher for a (pairs, rows) mesh with rows > 1.

    One jitted step matches ``pairs_ax`` pairs at once, each row-sharded
    over its rows-group via sharded_match_pair(pairs_axis='pairs'); a host
    loop walks the batch in pairs_ax-sized chunks (padding the last chunk
    with its final pair) and reuses the single compiled step.  With
    ``foveated=True`` each pair yields the stacked fovea triplet instead
    of the full-resolution level-0 map."""
    from jax.sharding import NamedSharding
    from ug_stereomatcher.parallel.spatial import sharded_match_pair

    p = mesh.shape["pairs"]
    # Pin the step's input layout to the shard_map body's consumption spec
    # (pair per pairs-group, rows split over the rows-group) — without it
    # GSPMD batch-shards the (p,3,H,W) chunk over ALL devices and pays an
    # involuntary full rematerialisation resharding it on entry.
    in_shard = NamedSharding(mesh, P("pairs", None, "rows", None))

    @partial(jax.jit, in_shardings=(in_shard, in_shard))
    def step(lb, rb):
        res = sharded_match_pair(lb, rb, cfg, mesh, pairs_axis="pairs",
                                 foveated=foveated)
        if foveated:
            return _stack_fovea_levels(res.levels, cfg.fovea_level)
        return res.levels[0]

    def fn(lb, rb):
        b = lb.shape[0]
        outs = []
        for s in range(0, b, p):
            lc = lb[s:s + p]
            rc = rb[s:s + p]
            pad = p - lc.shape[0]
            if pad:
                lc = jnp.concatenate([lc, jnp.broadcast_to(
                    lc[-1:], (pad,) + lc.shape[1:])])
                rc = jnp.concatenate([rc, jnp.broadcast_to(
                    rc[-1:], (pad,) + rc.shape[1:])])
            out = step(lc, rc)
            outs.append(out[:min(p, b - s)])
        return jnp.concatenate(outs) if len(outs) > 1 else outs[0]

    return fn


def batch_match(left_batch, right_batch, cfg: Optional[MatcherConfig] = None,
                mesh: Optional[Mesh] = None, foveated: bool = False):
    """Match a batch of pairs, sharded over the mesh 'pairs' axis.

    left_batch/right_batch: (B, 3, H, W) float arrays.
    Returns (B, 3, H, W) disparity triplets, or (B, 3, fovea_level*fh, fw)
    stacked fovea triplets with ``foveated=True``.  One-shot convenience —
    long-lived callers should hold a make_batch_matcher (or use
    StereoEngine.match_batch, which caches per shape)."""
    cfg = cfg or MatcherConfig()
    b, _, h, w = left_batch.shape
    fn = make_batch_matcher(cfg, h, w, mesh, foveated=foveated)
    return fn(jnp.asarray(left_batch), jnp.asarray(right_batch))
