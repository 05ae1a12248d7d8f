"""ug_stereomatcher — dense stereo matching framework in JAX.

A from-scratch JAX/XLA re-design of the University of Glasgow
coarse-to-fine correlation stereo matcher (reference: gerac83/ug_stereomatcher).
Produces two-axis (horizontal + vertical) disparity maps plus a confidence map
in two modes:

  1. full-resolution pyramid matching of RGB pairs
     (reference: src/gpu_matcher/MatchGPULib.cpp:303 ``match``)
  2. foveated matching emitting a fixed-size disparity stack per pyramid level
     (reference: src/gpu_matcher/MatchGPULib.cpp:534 ``matchStackPyramid``)

plus calibrated two-view triangulation into RGB point clouds
(reference: src/pointcloud/getPointCloud.cpp).

Design stance: the reference is a single-GPU CUDA/ROS package; this framework
is a pure-functional JAX core (jit/scan/vmap) with explicit sharding for
multi-chip meshes, Pallas kernels for the hot stencil chain, and a thin
in-process pipeline API replacing ROS topics/services.
"""

from ug_stereomatcher.config import MatcherConfig
from ug_stereomatcher.engine import StereoEngine, MatchResult, FoveatedStackResult
from ug_stereomatcher import ops
from ug_stereomatcher import pyramid
from ug_stereomatcher import match
from ug_stereomatcher import geom

__version__ = "0.1.0"

__all__ = [
    "MatcherConfig",
    "StereoEngine",
    "MatchResult",
    "FoveatedStackResult",
    "ops",
    "pyramid",
    "match",
    "geom",
]
