"""Pipeline layer: the in-process replacement for the ROS node graph.

The reference wires five OS processes over TCPROS topics (SURVEY.md §1 data
plane); here the same data plane is a composable in-process pipeline with an
optional background-prefetch executor.
"""

from ug_stereomatcher.pipeline.messages import (
    CamerasSync,
    StereoFrame,
    DisparityMessage,
    FoveatedStackMessage,
)
from ug_stereomatcher.pipeline.capture import ImageListCapture
from ug_stereomatcher.pipeline.runner import BatchRunner, PipelineResult
from ug_stereomatcher.pipeline.service import DisparityService
from ug_stereomatcher.pipeline.supervisor import EngineSupervisor

__all__ = [
    "DisparityService",
    "EngineSupervisor",
    "CamerasSync",
    "StereoFrame",
    "DisparityMessage",
    "FoveatedStackMessage",
    "ImageListCapture",
    "BatchRunner",
    "PipelineResult",
]
