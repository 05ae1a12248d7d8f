"""Geometry subsystem: calibration, triangulation, fovea coordinate mapping,
point clouds — the JAX replacement of src/pointcloud/getPointCloud.cpp
(the reference's O(W*H) scalar CPU loops become vectorised jit/vmap code).
"""

from ug_stereomatcher.geom.calibration import (
    CameraCalibration,
    StereoCalibration,
    load_opencv_xml,
)
from ug_stereomatcher.geom.triangulate import (
    triangulate_points,
    triangulate_disparity,
    range_map,
)
from ug_stereomatcher.geom.fovea_map import (
    fovea_margins,
    map_fovea_coords,
)
from ug_stereomatcher.geom.pointcloud import (
    PointCloud,
    disparity_to_pointcloud,
    foveated_disparity_to_pointcloud,
    foveated_range_map,
    foveated_resized_pointcloud,
    resized_pointcloud,
    save_pcd,
    save_ply,
)

__all__ = [
    "CameraCalibration",
    "StereoCalibration",
    "load_opencv_xml",
    "triangulate_points",
    "triangulate_disparity",
    "range_map",
    "fovea_margins",
    "map_fovea_coords",
    "PointCloud",
    "disparity_to_pointcloud",
    "foveated_disparity_to_pointcloud",
    "foveated_range_map",
    "foveated_resized_pointcloud",
    "resized_pointcloud",
    "save_pcd",
    "save_ply",
]
