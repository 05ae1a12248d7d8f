"""Geometry tests: calibration parsing, triangulation (incl. a scalar gold
re-derivation of the reference's closed form), fovea mapping, point clouds."""

import os

import numpy as np
import pytest

import jax.numpy as jnp

from ug_stereomatcher import geom
from ug_stereomatcher.config import MatcherConfig

REF_CAL_L = "/root/reference/calibrations/calL.xml"
REF_CAL_R = "/root/reference/calibrations/calR.xml"


def make_rig():
    """Simple rectified-ish rig + a slightly verged right camera."""
    fx, fy, cx, cy = 700.0, 690.0, 320.0, 240.0
    P1 = np.array([[fx, 0, cx, 0], [0, fy, cy, 0], [0, 0, 1, 0]], np.float64)
    # Right camera: translated baseline 0.1, small rotation about y
    th = 0.03
    R = np.array([[np.cos(th), 0, np.sin(th)],
                  [0, 1, 0],
                  [-np.sin(th), 0, np.cos(th)]])
    t = np.array([-0.1, 0.0, 0.0])
    K = np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1]])
    P2 = K @ np.hstack([R, t[:, None]])
    calL = geom.CameraCalibration(K=K, D=np.zeros(5), P=P1)
    calR = geom.CameraCalibration(K=K, D=np.zeros(5), P=P2)
    return geom.StereoCalibration(left=calL, right=calR)


def scalar_gold_triangulate(P1, P2, x1, y1, x2, y2):
    """Independent least-squares solve of the same 4-equation system the
    reference solved symbolically: rows 0/1 of P1 (axis-aligned) and the full
    P2."""
    A = np.array([
        [P1[0, 0], 0.0, P1[0, 2] - x1],
        [0.0, P1[1, 1], P1[1, 2] - y1],
        [P2[0, 0] - x2 * P2[2, 0], P2[0, 1] - x2 * P2[2, 1],
         P2[0, 2] - x2 * P2[2, 2]],
        [P2[1, 0] - y2 * P2[2, 0], P2[1, 1] - y2 * P2[2, 1],
         P2[1, 2] - y2 * P2[2, 2]],
    ])
    rhs = np.array([
        0.0, 0.0,
        x2 * P2[2, 3] - P2[0, 3],
        y2 * P2[2, 3] - P2[1, 3],
    ])
    sol, *_ = np.linalg.lstsq(A, rhs, rcond=None)
    return sol


class TestCalibration:
    @pytest.mark.skipif(not os.path.exists(REF_CAL_L),
                        reason="reference calibrations unavailable")
    def test_load_reference_xml(self):
        cal = geom.load_opencv_xml(REF_CAL_L)
        assert cal.K.shape == (3, 3)
        assert cal.P.shape == (3, 4)
        assert cal.D.shape == (5,)
        np.testing.assert_allclose(cal.K[0, 0], 7323.0899280915291, rtol=1e-9)
        assert cal.name == "left_camera"

    @pytest.mark.skipif(not os.path.exists(REF_CAL_R),
                        reason="reference calibrations unavailable")
    def test_right_camera_is_full_projective(self):
        cal = geom.load_opencv_xml(REF_CAL_R)
        # Verged rig: bottom row of P2 is not [0,0,1,0]
        assert abs(cal.P[2, 0]) > 1e-3
        rig = geom.StereoCalibration.from_xml(REF_CAL_L, REF_CAL_R)
        assert rig.right.name == "right_camera"


class TestTriangulation:
    def test_matches_scalar_lstsq_gold(self):
        rig = make_rig()
        P1, P2 = rig.left.P, rig.right.P
        rng = np.random.RandomState(11)
        pts = rng.rand(20, 3) * [2.0, 1.5, 3.0] + [-1.0, -0.75, 2.0]
        for X in pts:
            u1 = P1 @ np.append(X, 1.0)
            u2 = P2 @ np.append(X, 1.0)
            x1, y1 = u1[0] / u1[2], u1[1] / u1[2]
            x2, y2 = u2[0] / u2[2], u2[1] / u2[2]
            gold = scalar_gold_triangulate(P1, P2, x1, y1, x2, y2)
            ours = geom.triangulate_points(
                P1, P2, jnp.float64(x1), jnp.float64(y1),
                jnp.float64(x2), jnp.float64(y2))
            ours = np.array([float(v) for v in ours])
            np.testing.assert_allclose(ours, gold, rtol=1e-3, atol=1e-4)
            # Exact reprojected points reconstruct X itself
            np.testing.assert_allclose(ours, X, rtol=1e-2, atol=1e-3)

    def test_float32_verged_rig_precision(self):
        """16MP verged rig in float32: nearly parallel rays make the
        expanded closed form lose ~1% of depth; the QR solve must stay
        within float32 noise of the float64 least-squares gold."""
        f, base, h, w = 4000.0, 0.1, 3264, 4928
        k = np.array([[f, 0, w / 2], [0, f, h / 2], [0, 0, 1]])
        ang = 0.05
        rot = np.array([[np.cos(ang), 0, np.sin(ang)], [0, 1, 0],
                        [-np.sin(ang), 0, np.cos(ang)]])
        P1 = k @ np.hstack([np.eye(3), np.zeros((3, 1))])
        P2 = k @ np.hstack([rot, [[base], [0.01], [0.002]]])
        rng = np.random.RandomState(5)
        n = 400
        x1, y1 = rng.rand(n) * w, rng.rand(n) * h
        z = 50 + rng.rand(n) * 100
        pts = np.stack([(x1 - w / 2) * z / f, (y1 - h / 2) * z / f, z,
                        np.ones(n)])
        p2 = P2 @ pts
        x2 = p2[0] / p2[2]
        y2 = p2[1] / p2[2] + rng.randn(n) * 0.3   # off the epipolar line
        ours = np.stack([np.asarray(v) for v in geom.triangulate_points(
            P1.astype(np.float32), P2.astype(np.float32),
            *(jnp.asarray(v, jnp.float32) for v in (x1, y1, x2, y2)))])
        gold = np.stack([scalar_gold_triangulate(P1, P2, *args)
                         for args in zip(x1, y1, x2, y2)], axis=1)
        rel = np.abs(ours[2] - gold[2]) / gold[2]
        assert np.isfinite(ours).all()
        assert np.median(rel) < 1e-4 and rel.max() < 2e-3, (
            np.median(rel), rel.max())

    def test_disparity_field_triangulation(self):
        rig = make_rig()
        h, w = 12, 16
        dh = jnp.full((h, w), 5.0, dtype=jnp.float32)
        dv = jnp.zeros((h, w), dtype=jnp.float32)
        X, Y, Z = geom.triangulate_disparity(rig.left.P, rig.right.P, dh, dv)
        assert X.shape == (h, w)
        z = np.asarray(Z)
        assert np.all(np.isfinite(z))
        rm = np.asarray(geom.range_map(rig.left.P, rig.right.P, dh, dv))
        np.testing.assert_allclose(rm, z, rtol=1e-6)


class TestFoveaMapping:
    def test_margins_centered(self):
        cfg = MatcherConfig()
        H, W = 3264, 4928
        left, upper = geom.fovea_margins(cfg, H, W, src_level=0, dest_level=0)
        # fovea is 615x407 at level 6; window is centred in the full image
        assert left == W // 2 - 615 // 2
        assert upper == H // 2 - 407 // 2

    def test_src_level_reduces_scale(self):
        cfg = MatcherConfig()
        H, W = 3264, 4928
        x0, y0 = geom.map_fovea_coords(cfg, H, W, 0, 0.0, 0.0)
        x1, y1 = geom.map_fovea_coords(cfg, H, W, 1, 0.0, 0.0)
        # coarser src level -> window is bigger -> smaller left margin
        assert x1 < x0 and y1 < y0
        # one fovea pixel at src_level s spans sqrt(2)^s full-res pixels
        xa, _ = geom.map_fovea_coords(cfg, H, W, 2, 10.0, 0.0)
        xb, _ = geom.map_fovea_coords(cfg, H, W, 2, 11.0, 0.0)
        np.testing.assert_allclose(xb - xa, np.sqrt(2.0) ** 2, rtol=1e-6)


class TestPointCloud:
    def test_full_res_cloud(self, tmp_path):
        rig = make_rig()
        h, w = 10, 14
        rng = np.random.RandomState(5)
        dh = rng.rand(h, w).astype(np.float32) * 3 + 3
        dv = rng.rand(h, w).astype(np.float32) * 0.2
        img = (rng.rand(h, w, 3) * 255).astype(np.uint8)
        cloud = geom.disparity_to_pointcloud(rig, dh, dv, img)
        assert len(cloud) == h * w
        assert cloud.xyz.shape == (h * w, 3)
        assert cloud.rgb.shape == (h * w, 3)
        np.testing.assert_array_equal(cloud.rgb[0], img[0, 0])

        # serialisation round-trips header + sizes
        pcd = tmp_path / "c.pcd"
        ply = tmp_path / "c.ply"
        geom.save_pcd(str(pcd), cloud)
        geom.save_ply(str(ply), cloud)
        head = pcd.read_bytes()[:200].decode(errors="ignore")
        assert f"POINTS {h*w}" in head
        body = ply.read_bytes()
        assert f"element vertex {h*w}".encode() in body

    def test_sampling_stride(self):
        rig = make_rig()
        h, w = 12, 16
        dh = np.ones((h, w), np.float32) * 4
        dv = np.zeros((h, w), np.float32)
        img = np.zeros((h, w, 3), np.uint8)
        cloud = geom.disparity_to_pointcloud(rig, dh, dv, img, sampling=2)
        assert len(cloud) == (h // 2) * (w // 2)

    def test_foveated_cloud(self):
        rig = make_rig()
        cfg = MatcherConfig(fovea_level=3)
        H, W = 72, 96
        fov_h, fov_w = cfg.fovea_dims(H, W)
        rng = np.random.RandomState(9)
        stack_h = rng.rand(cfg.fovea_level * fov_h, fov_w).astype(np.float32)
        stack_v = rng.rand(cfg.fovea_level * fov_h, fov_w).astype(np.float32)
        img = (rng.rand(H, W, 3) * 255).astype(np.uint8)
        cloud = geom.foveated_disparity_to_pointcloud(
            rig, cfg, stack_h, stack_v, img, src_level=0)
        assert len(cloud) == fov_h * fov_w

    def test_resized_cloud(self):
        rig = make_rig()
        h, w = 20, 30
        dh = np.ones((h, w), np.float32) * 4
        dv = np.zeros((h, w), np.float32)
        img = np.zeros((h, w, 3), np.uint8)
        cloud = geom.resized_pointcloud(rig, dh, dv, img, resize_factor=0.5)
        assert len(cloud) == (h // 2) * (w // 2)


def scalar_gold_map_coord(cfg, full_dims, src_level, v, axis):
    """Scalar re-derivation of mapXcoord/mapYcoord + margins
    (getPointCloud.cpp:387-484) for the usual src >= dest=0 case."""
    dims = cfg.dims_chain(*full_dims)
    scaled = (cfg.fovea_level - 1) - src_level
    dest = dims[0][axis]
    src = dims[scaled][axis]
    margin = dest // 2 - src // 2
    return margin + v * (np.sqrt(2.0) ** src_level)


class TestFoveatedResized:
    """Gold tests for doReconstructionFOV_resized / getRangePointFOV
    (getPointCloud.cpp:802-884, :984-1021)."""

    def _setup(self, src_level=0):
        rig = make_rig()
        cfg = MatcherConfig(fovea_level=3)
        H, W = 72, 96
        fov_h, fov_w = cfg.fovea_dims(H, W)
        rng = np.random.RandomState(21)
        stack_h = (rng.rand(cfg.fovea_level * fov_h, fov_w)
                   .astype(np.float32) * 3 + 2)
        stack_v = (rng.rand(cfg.fovea_level * fov_h, fov_w)
                   .astype(np.float32) * 0.4 - 0.2)
        img = (rng.rand(H, W, 3) * 255).astype(np.uint8)
        return rig, cfg, (H, W), (fov_h, fov_w), stack_h, stack_v, img

    def test_range_map_matches_scalar_gold(self):
        for src_level in (0, 1):
            (rig, cfg, (H, W), (fov_h, fov_w),
             stack_h, stack_v, _) = self._setup(src_level)
            rmap = geom.foveated_range_map(rig, cfg, stack_h, stack_v,
                                           (H, W), src_level=src_level)
            assert rmap.shape == (fov_h, fov_w)
            # scalar gold: the getRangePointFOV loop, via the independent
            # least-squares solve of the same system
            for (yy, xx) in [(0, 0), (3, 5), (fov_h - 1, fov_w - 1),
                             (fov_h // 2, fov_w // 3)]:
                d_h = stack_h[src_level * fov_h + yy, xx]
                d_v = stack_v[src_level * fov_h + yy, xx]
                x1 = scalar_gold_map_coord(cfg, (H, W), src_level, xx, 1)
                y1 = scalar_gold_map_coord(cfg, (H, W), src_level, yy, 0)
                x2 = scalar_gold_map_coord(cfg, (H, W), src_level, xx + d_h, 1)
                y2 = scalar_gold_map_coord(cfg, (H, W), src_level, yy + d_v, 0)
                gold = scalar_gold_triangulate(rig.left.P, rig.right.P,
                                               x1, y1, x2, y2)
                np.testing.assert_allclose(rmap[yy, xx], gold[2],
                                           rtol=2e-3, atol=1e-4)

    def test_resized_cloud_shapes_and_z(self):
        (rig, cfg, (H, W), (fov_h, fov_w),
         stack_h, stack_v, img) = self._setup()
        f = 0.5
        cloud = geom.foveated_resized_pointcloud(
            rig, cfg, stack_h, stack_v, img, src_level=0, resize_factor=f)
        out_h, out_w = int(fov_h * f), int(fov_w * f)
        assert len(cloud) == out_h * out_w
        # Z comes from the resized range map (reference :874), not from the
        # per-point triangulation
        rmap = geom.foveated_range_map(rig, cfg, stack_h, stack_v, (H, W))
        from ug_stereomatcher.ops.resample import subsample
        import jax.numpy as jnp
        z_res = np.asarray(subsample(jnp.asarray(rmap), out_h, out_w,
                                     1.0 / f, method="bilinear"))
        np.testing.assert_allclose(cloud.xyz[:, 2],
                                   z_res.reshape(-1), rtol=1e-6)

    def test_resized_cloud_cubic_matches_gold(self):
        # resize_method="cubic" = INTER_CUBIC parity (getPointCloud.cpp:841):
        # the resized Z channel must equal the scalar bicubic gold resample
        # of the range map.
        from tests.gold.gold_ops import subsample_cubic
        (rig, cfg, (H, W), (fov_h, fov_w),
         stack_h, stack_v, img) = self._setup()
        f = 0.5
        cloud = geom.foveated_resized_pointcloud(
            rig, cfg, stack_h, stack_v, img, src_level=0, resize_factor=f,
            resize_method="cubic")
        out_h, out_w = int(fov_h * f), int(fov_w * f)
        rmap = geom.foveated_range_map(rig, cfg, stack_h, stack_v, (H, W))
        z_gold = subsample_cubic(rmap, out_h, out_w, 1.0 / f)
        np.testing.assert_allclose(cloud.xyz[:, 2], z_gold.reshape(-1),
                                   rtol=1e-4, atol=1e-4)

    def test_resized_cloud_xy_matches_get3dpoint_gold(self):
        (rig, cfg, (H, W), (fov_h, fov_w),
         stack_h, stack_v, img) = self._setup()
        f = 0.5
        cloud = geom.foveated_resized_pointcloud(
            rig, cfg, stack_h, stack_v, img, src_level=0, resize_factor=f)
        out_w = int(fov_w * f)
        # spot-check XY against the scalar get3DPoint foveated branch
        for (jj, ii) in [(0, 0), (2, 3), (int(fov_h * f) - 1, out_w - 1)]:
            xx = int(ii / f)
            yy = int(jj / f)
            d_h = stack_h[yy, xx]
            d_v = stack_v[yy, xx]
            x1 = scalar_gold_map_coord(cfg, (H, W), 0, xx, 1)
            y1 = scalar_gold_map_coord(cfg, (H, W), 0, yy, 0)
            x2 = scalar_gold_map_coord(cfg, (H, W), 0, xx + d_h, 1)
            y2 = scalar_gold_map_coord(cfg, (H, W), 0, yy + d_v, 0)
            gold = scalar_gold_triangulate(rig.left.P, rig.right.P,
                                           x1, y1, x2, y2)
            pt = cloud.xyz[jj * out_w + ii]
            np.testing.assert_allclose(pt[:2], gold[:2], rtol=2e-3, atol=1e-4)

    def test_rgb_parity_quirk(self):
        # The reference reads colours at the UNMAPPED fovea coordinates
        # (getPointCloud.cpp:864-867) — the parity default keeps that;
        # map_rgb_coords=True samples at the mapped full-res coordinates.
        (rig, cfg, (H, W), (fov_h, fov_w),
         stack_h, stack_v, img) = self._setup()
        f = 0.5
        cloud = geom.foveated_resized_pointcloud(
            rig, cfg, stack_h, stack_v, img, src_level=0, resize_factor=f)
        out_w = int(fov_w * f)
        jj, ii = 1, 2
        xx, yy = int(ii / f), int(jj / f)
        np.testing.assert_array_equal(cloud.rgb[jj * out_w + ii],
                                      img[yy, xx])
        mapped = geom.foveated_resized_pointcloud(
            rig, cfg, stack_h, stack_v, img, src_level=0, resize_factor=f,
            map_rgb_coords=True)
        mx = int(scalar_gold_map_coord(cfg, (H, W), 0, xx, 1))
        my = int(scalar_gold_map_coord(cfg, (H, W), 0, yy, 0))
        np.testing.assert_array_equal(mapped.rgb[jj * out_w + ii],
                                      img[my, mx])
