"""Distribution layer: device meshes, pair-batch data parallelism, and
spatial (row-tile) sharding with explicit halo exchange.

The reference is single-process single-GPU (SURVEY.md §2.5) — this module is
new capability: ``pairs`` axis shards batched stereo pairs across chips/hosts
(Glasgow-database throughput), ``rows`` axis shards image tiles within a pair
with halo exchanges (``lax.ppermute``) for the stencil ops and a tiled
row all-gather for the disparity-driven warp.
"""

from ug_stereomatcher.parallel.mesh import make_mesh, mesh_shape_for
from ug_stereomatcher.parallel.batch import batch_match
from ug_stereomatcher.parallel.multihost import (
    initialize_distributed,
    pod_mesh,
)
from ug_stereomatcher.parallel.throughput import (
    ThroughputPoint,
    measure_throughput,
)
from ug_stereomatcher.parallel.spatial import (
    halo_pad_rows,
    replicated_stage,
    sharded_blur,
    sharded_build_pyramid,
    sharded_conv_separable,
    sharded_match_level,
    sharded_match_pair,
    sharded_resample,
    sharded_upsample_to_level,
)

__all__ = [
    "make_mesh",
    "mesh_shape_for",
    "batch_match",
    "initialize_distributed",
    "pod_mesh",
    "ThroughputPoint",
    "measure_throughput",
    "halo_pad_rows",
    "replicated_stage",
    "sharded_blur",
    "sharded_build_pyramid",
    "sharded_conv_separable",
    "sharded_match_level",
    "sharded_match_pair",
    "sharded_resample",
    "sharded_upsample_to_level",
]
