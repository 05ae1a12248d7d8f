"""IO subsystem: images, manifests, result dumps.

Replaces the reference's OpenCV/file plumbing: settings.h image-list reader,
publish_images.cpp capture simulator inputs, and the disparity viz/save nodes
(UG_dispImgTest.cpp / UG_FdispImgTest.cpp TIFF dumps).
"""

from ug_stereomatcher.io.image import load_image, save_image, save_float_tiff
from ug_stereomatcher.io.manifest import ImageList, load_image_list
from ug_stereomatcher.io.dumps import save_disparity_maps, save_foveated_stack

__all__ = [
    "load_image",
    "save_image",
    "save_float_tiff",
    "ImageList",
    "load_image_list",
    "save_disparity_maps",
    "save_foveated_stack",
]
