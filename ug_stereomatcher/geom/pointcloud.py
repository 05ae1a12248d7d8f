"""RGB point-cloud generation and serialisation.

Replaces the reference point-cloud node's reconstruction paths
(getPointCloud.cpp doReconstructionRGB:675, doReconstructionRGB_FOV:615,
doReconstruction_resized:724, doReconstructionFOV_resized:802) with
vectorised jit code, and PCL's PCD writer (pcl::io::savePCDFileASCII,
getPointCloud.cpp:330) with native writers (ASCII + binary PCD, binary PLY).
"""

from __future__ import annotations

import dataclasses
import struct
from typing import Optional, Tuple

import jax.numpy as jnp
import numpy as np

from ug_stereomatcher.config import MatcherConfig
from ug_stereomatcher.geom.fovea_map import map_fovea_coords
from ug_stereomatcher.geom.triangulate import triangulate_points
from ug_stereomatcher.ops.resample import subsample


@dataclasses.dataclass
class PointCloud:
    """Flat point cloud: xyz (N, 3) float32, rgb (N, 3) uint8."""
    xyz: np.ndarray
    rgb: np.ndarray

    def __len__(self) -> int:
        return self.xyz.shape[0]


def _rgb_from_image(image: np.ndarray) -> np.ndarray:
    """Accept (H, W, 3) or (3, H, W); return (H, W, 3) uint8."""
    arr = np.asarray(image)
    if arr.ndim != 3:
        raise ValueError("expected RGB image")
    if arr.shape[0] == 3 and arr.shape[-1] != 3:
        arr = np.moveaxis(arr, 0, -1)
    return arr.astype(np.uint8)


def disparity_to_pointcloud(calib, disp_h, disp_v, left_image,
                            sampling: int = 1) -> PointCloud:
    """Full-resolution reconstruction (doReconstructionRGB,
    getPointCloud.cpp:675-722).  ``sampling`` keeps every Nth pixel in each
    axis (the node's ``sampling`` stride, :698)."""
    P1, P2 = calib.left.P, calib.right.P
    dh = np.asarray(disp_h)[::sampling, ::sampling]
    dv = np.asarray(disp_v)[::sampling, ::sampling]
    h, w = np.asarray(disp_h).shape
    yy, xx = np.mgrid[0:h:sampling, 0:w:sampling].astype(np.float32)
    X, Y, Z = (np.asarray(v) for v in triangulate_points(
        P1, P2, jnp.asarray(xx), jnp.asarray(yy),
        jnp.asarray(xx + dh), jnp.asarray(yy + dv)))
    rgb = _rgb_from_image(left_image)[::sampling, ::sampling]
    xyz = np.stack([X, Y, Z], axis=-1).reshape(-1, 3).astype(np.float32)
    return PointCloud(xyz=xyz, rgb=rgb.reshape(-1, 3))


def foveated_disparity_to_pointcloud(calib, cfg: MatcherConfig,
                                     stack_h, stack_v, left_image,
                                     src_level: int = 0,
                                     sampling: int = 1) -> PointCloud:
    """Foveated reconstruction from a disparity stack
    (doReconstructionRGB_FOV + get3DPoint fovea branch,
    getPointCloud.cpp:615-673, 892-907).

    The stack row-block of ``src_level`` is selected, both endpoints are
    mapped into full-resolution coordinates via the fovea coordinate mapping,
    and colours are sampled from the full-resolution left image at the
    mapped (integer-truncated) coordinates."""
    stack_h = np.asarray(stack_h)
    stack_v = np.asarray(stack_v)
    rgb_img = _rgb_from_image(left_image)
    H, W = rgb_img.shape[:2]
    fov_h = stack_h.shape[0] // cfg.fovea_level
    sl = slice(src_level * fov_h, (src_level + 1) * fov_h)
    dh = stack_h[sl][::sampling, ::sampling]
    dv = stack_v[sl][::sampling, ::sampling]
    fov_w = stack_h.shape[1]
    yy, xx = np.mgrid[0:fov_h:sampling, 0:fov_w:sampling].astype(np.float32)

    x1, y1 = map_fovea_coords(cfg, H, W, src_level, xx, yy)
    x2, y2 = map_fovea_coords(cfg, H, W, src_level, xx + dh, yy + dv)
    X, Y, Z = (np.asarray(v) for v in triangulate_points(
        calib.left.P, calib.right.P,
        jnp.asarray(x1), jnp.asarray(y1), jnp.asarray(x2), jnp.asarray(y2)))

    ix = np.clip(x1.astype(np.int64), 0, W - 1)
    iy = np.clip(y1.astype(np.int64), 0, H - 1)
    rgb = rgb_img[iy, ix]
    xyz = np.stack([X, Y, Z], axis=-1).reshape(-1, 3).astype(np.float32)
    return PointCloud(xyz=xyz, rgb=rgb.reshape(-1, 3))


def resized_pointcloud(calib, disp_h, disp_v, left_image,
                       resize_factor: float = 0.2,
                       resize_method: str = "bilinear") -> PointCloud:
    """Resized-range-map reconstruction (doReconstruction_resized,
    getPointCloud.cpp:724-800): compute the Z range map at full resolution,
    resize it, and emit one point per resized pixel with XY from the
    corresponding full-resolution pixel.

    ``resize_method="cubic"`` reproduces the reference's cv::INTER_CUBIC
    range-map resize (:772); the default stays bilinear (the resized map is
    a preview product, and cubic can overshoot at depth discontinuities)."""
    P1, P2 = calib.left.P, calib.right.P
    dh = jnp.asarray(disp_h)
    dv = jnp.asarray(disp_v)
    h, w = dh.shape
    from ug_stereomatcher.geom.triangulate import triangulate_disparity
    _, _, z = triangulate_disparity(P1, P2, dh, dv)
    out_h, out_w = int(h * resize_factor), int(w * resize_factor)
    z_res = np.asarray(subsample(z, out_h, out_w, 1.0 / resize_factor,
                                 method=resize_method))
    yy, xx = np.mgrid[0:out_h, 0:out_w]
    sx = (xx / resize_factor).astype(np.int64)
    sy = (yy / resize_factor).astype(np.int64)
    sx = np.clip(sx, 0, w - 1)
    sy = np.clip(sy, 0, h - 1)
    dh_n = np.asarray(dh)
    dv_n = np.asarray(dv)
    X, Y, _ = (np.asarray(v) for v in triangulate_points(
        P1, P2,
        jnp.asarray(sx.astype(np.float32)), jnp.asarray(sy.astype(np.float32)),
        jnp.asarray(sx + dh_n[sy, sx]), jnp.asarray(sy + dv_n[sy, sx])))
    rgb = _rgb_from_image(left_image)[sy, sx]
    xyz = np.stack([X, Y, z_res], axis=-1).reshape(-1, 3).astype(np.float32)
    return PointCloud(xyz=xyz, rgb=rgb.reshape(-1, 3))


def foveated_range_map(calib, cfg: MatcherConfig, stack_h, stack_v,
                       full_dims: Tuple[int, int],
                       src_level: int = 0) -> np.ndarray:
    """Z-only range map over the fovea grid of one stack level
    (getRangePointFOV, getPointCloud.cpp:984-1021).

    Both match endpoints are mapped into full-resolution coordinates first
    — including the disparity endpoint, which the reference maps *after*
    adding the raw (fovea-scale) disparity (:994-995) — then the least-squares
    triangulation's Z component is evaluated.  Returns (fov_h, fov_w)
    float32."""
    H, W = full_dims
    stack_h = np.asarray(stack_h)
    stack_v = np.asarray(stack_v)
    fov_h = stack_h.shape[0] // cfg.fovea_level
    fov_w = stack_h.shape[1]
    sl = slice(src_level * fov_h, (src_level + 1) * fov_h)
    dh = stack_h[sl]
    dv = stack_v[sl]
    yy, xx = np.mgrid[0:fov_h, 0:fov_w].astype(np.float32)
    x1, y1 = map_fovea_coords(cfg, H, W, src_level, xx, yy)
    x2, y2 = map_fovea_coords(cfg, H, W, src_level, xx + dh, yy + dv)
    _, _, Z = triangulate_points(
        calib.left.P, calib.right.P,
        jnp.asarray(x1), jnp.asarray(y1), jnp.asarray(x2), jnp.asarray(y2))
    return np.asarray(Z, dtype=np.float32)


def foveated_resized_pointcloud(calib, cfg: MatcherConfig, stack_h, stack_v,
                                left_image, src_level: int = 0,
                                resize_factor: float = 0.2,
                                map_rgb_coords: bool = False,
                                resize_method: str = "bilinear") -> PointCloud:
    """Foveated resized-range-map reconstruction (doReconstructionFOV_resized,
    getPointCloud.cpp:802-884): compute the fovea-level Z range map via
    :func:`foveated_range_map`, resize it by ``resize_factor``, and emit one
    point per resized pixel — XY from the full least-squares triangulation at
    the corresponding fovea pixel (get3DPoint's foveated branch, :892-907),
    Z from the resized range map.

    Parity notes: the reference resizes with cv::INTER_CUBIC (:841);
    ``resize_method="cubic"`` reproduces that (gold-tested vs a scalar
    bicubic model); the default stays bilinear (same choice as
    :func:`resized_pointcloud` — the resized map is a preview product, not a
    matched quantity).  The reference also samples the point colour from the
    full-resolution left image at the *unmapped* fovea coordinates
    (:864-867 reads ``imgL`` at ``(yy, xx)`` where ``xx, yy`` are fovea-grid
    indices — unlike doReconstructionRGB_FOV, which maps first at :651-652).
    That top-left-corner colour read is kept as the parity default;
    ``map_rgb_coords=True`` samples at the mapped coordinates instead."""
    stack_h = np.asarray(stack_h)
    stack_v = np.asarray(stack_v)
    rgb_img = _rgb_from_image(left_image)
    H, W = rgb_img.shape[:2]
    fov_h = stack_h.shape[0] // cfg.fovea_level
    fov_w = stack_h.shape[1]

    rmap = foveated_range_map(calib, cfg, stack_h, stack_v, (H, W), src_level)
    out_h = int(fov_h * resize_factor)
    out_w = int(fov_w * resize_factor)
    z_res = np.asarray(subsample(jnp.asarray(rmap), out_h, out_w,
                                 1.0 / resize_factor, method=resize_method))

    # int(ii / resizeFactor) source lookup per resized pixel (:860-861)
    yy, xx = np.mgrid[0:out_h, 0:out_w]
    sx = np.clip((xx / resize_factor).astype(np.int64), 0, fov_w - 1)
    sy = np.clip((yy / resize_factor).astype(np.int64), 0, fov_h - 1)

    sl = slice(src_level * fov_h, (src_level + 1) * fov_h)
    dh = stack_h[sl]
    dv = stack_v[sl]
    fx = sx.astype(np.float32)
    fy = sy.astype(np.float32)
    x1, y1 = map_fovea_coords(cfg, H, W, src_level, fx, fy)
    x2, y2 = map_fovea_coords(cfg, H, W, src_level,
                              fx + dh[sy, sx], fy + dv[sy, sx])
    X, Y, _ = (np.asarray(v) for v in triangulate_points(
        calib.left.P, calib.right.P,
        jnp.asarray(x1), jnp.asarray(y1), jnp.asarray(x2), jnp.asarray(y2)))

    if map_rgb_coords:
        cx = np.clip(x1.astype(np.int64), 0, W - 1)
        cy = np.clip(y1.astype(np.int64), 0, H - 1)
    else:  # reference behaviour: unmapped fovea-grid coordinates (:864)
        cx = np.clip(sx, 0, W - 1)
        cy = np.clip(sy, 0, H - 1)
    rgb = rgb_img[cy, cx]
    xyz = np.stack([X, Y, z_res], axis=-1).reshape(-1, 3).astype(np.float32)
    return PointCloud(xyz=xyz, rgb=rgb.reshape(-1, 3))


# ----------------------------------------------------------------------
# Serialisation (replaces pcl::io::savePCDFileASCII and PLY tooling)
# ----------------------------------------------------------------------

def _packed_rgb_float(rgb: np.ndarray) -> np.ndarray:
    """PCL packs rgb as a float whose bits are 0x00RRGGBB
    (getPointCloud.cpp:660-666)."""
    r = rgb[:, 0].astype(np.uint32)
    g = rgb[:, 1].astype(np.uint32)
    b = rgb[:, 2].astype(np.uint32)
    packed = (r << 16) | (g << 8) | b
    return packed.view(np.float32) if packed.dtype == np.uint32 else \
        packed.astype(np.uint32).view(np.float32)


def save_pcd(path: str, cloud: PointCloud, binary: bool = True) -> None:
    """Write a PCL-compatible .pcd file (x y z rgb)."""
    n = len(cloud)
    rgbf = _packed_rgb_float(cloud.rgb)
    header = (
        "# .PCD v0.7 - Point Cloud Data file format\n"
        "VERSION 0.7\n"
        "FIELDS x y z rgb\n"
        "SIZE 4 4 4 4\n"
        "TYPE F F F F\n"
        "COUNT 1 1 1 1\n"
        f"WIDTH {n}\nHEIGHT 1\nVIEWPOINT 0 0 0 1 0 0 0\nPOINTS {n}\n"
        f"DATA {'binary' if binary else 'ascii'}\n"
    )
    data = np.concatenate(
        [cloud.xyz.astype(np.float32), rgbf[:, None]], axis=1)
    with open(path, "wb") as fh:
        fh.write(header.encode())
        if binary:
            fh.write(np.ascontiguousarray(data, dtype=np.float32).tobytes())
        else:
            np.savetxt(fh, data, fmt="%.6f %.6f %.6f %.9e")


def save_ply(path: str, cloud: PointCloud) -> None:
    """Write a binary little-endian PLY with per-vertex colour."""
    n = len(cloud)
    header = (
        "ply\nformat binary_little_endian 1.0\n"
        f"element vertex {n}\n"
        "property float x\nproperty float y\nproperty float z\n"
        "property uchar red\nproperty uchar green\nproperty uchar blue\n"
        "end_header\n"
    )
    rec = np.empty(n, dtype=[("xyz", np.float32, 3), ("rgb", np.uint8, 3)])
    rec["xyz"] = cloud.xyz.astype(np.float32)
    rec["rgb"] = cloud.rgb.astype(np.uint8)
    with open(path, "wb") as fh:
        fh.write(header.encode())
        fh.write(rec.tobytes())
