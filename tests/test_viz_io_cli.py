"""BEV rasterization, KITTI ingest, and CLI end-to-end tests."""

import os
import struct
import subprocess
import sys

import numpy as np
import jax.numpy as jnp
import pytest

from patchwork_tpu.viz.bev import (
    bev_enhanced_image,
    bev_ground_nonground_image,
    bev_height_image,
    save_png,
)
from patchwork_tpu.io.kitti import list_sequence, pad_to_capacity, read_bin
from patchwork_tpu.io.synthetic import demo_point_cloud


class TestBEV:
    def test_height_image_colors(self):
        # single point at origin with z=1 -> intensity 150, pixel (75, 150)
        xyz = jnp.asarray([[0.0, 0.0, 1.0]], jnp.float32)
        img = np.asarray(bev_height_image(xyz, jnp.ones(1, bool)))
        assert img.shape == (150, 300, 3)
        assert tuple(img[75, 150]) == (255, 150, 150)
        assert img.sum() == 255 + 150 + 150  # only one pixel set

    def test_out_of_bounds_dropped(self):
        xyz = jnp.asarray([[1e5, 1e5, 0.0]], jnp.float32)
        img = np.asarray(bev_height_image(xyz, jnp.ones(1, bool)))
        assert img.sum() == 0

    def test_invalid_mask_dropped(self):
        xyz = jnp.asarray([[0.0, 0.0, 1.0]], jnp.float32)
        img = np.asarray(bev_height_image(xyz, jnp.zeros(1, bool)))
        assert img.sum() == 0

    def test_ground_nonground_precedence(self):
        # same pixel: ground + non-ground -> red wins (drawn second)
        xyz = jnp.asarray([[0.0, 0.0, 0.0], [0.1, 0.1, 1.0]], jnp.float32)
        img = np.asarray(
            bev_ground_nonground_image(
                xyz, jnp.asarray([True, False]), jnp.asarray([False, True])
            )
        )
        assert tuple(img[75, 150]) == (255, 0, 0)

    def test_enhanced_image(self):
        xyz = jnp.asarray([[0.0, 0.0, 0.0]], jnp.float32)
        img = np.asarray(bev_enhanced_image(xyz, jnp.ones(1, bool)))
        assert tuple(img[75, 150]) == (100, 127, 100)

    def test_save_png(self, tmp_path):
        xyz = jnp.asarray(demo_point_cloud(1000, seed=0))
        img = bev_height_image(xyz, jnp.ones(1000, bool))
        out = tmp_path / "t.png"
        save_png(img, str(out))
        data = out.read_bytes()
        assert data[:8] == b"\x89PNG\r\n\x1a\n"
        assert struct.unpack(">II", data[16:24]) == (300, 150)  # IHDR w, h


class TestKittiIO:
    def test_roundtrip(self, tmp_path):
        pts = np.random.default_rng(0).normal(size=(100, 4)).astype(np.float32)
        p = tmp_path / "0000000000.bin"
        pts.tofile(p)
        back = read_bin(str(p))
        np.testing.assert_array_equal(back, pts[:, :3])
        back4 = read_bin(str(p), with_intensity=True)
        np.testing.assert_array_equal(back4, pts)

    def test_sequence_listing(self, tmp_path):
        for i in [2, 0, 1]:
            (np.zeros((4, 4), np.float32)).tofile(tmp_path / f"{i:010d}.bin")
        paths = list_sequence(str(tmp_path))
        assert [os.path.basename(p) for p in paths] == [
            "0000000000.bin", "0000000001.bin", "0000000002.bin",
        ]

    def test_pad_to_capacity(self):
        pts = np.ones((10, 4), np.float32)
        xyz, valid = pad_to_capacity(pts, 16)
        assert xyz.shape == (16, 3) and valid.sum() == 10
        xyz2, valid2 = pad_to_capacity(pts, 4)  # truncation
        assert valid2.sum() == 4

    def test_bad_size(self, tmp_path):
        p = tmp_path / "bad.bin"
        np.zeros(7, np.float32).tofile(p)
        with pytest.raises(ValueError):
            read_bin(str(p))


class TestCLI:
    def run_cli(self, args, cwd):
        repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        env = dict(os.environ, JAX_PLATFORMS="cpu")
        env["PYTHONPATH"] = repo + os.pathsep + env.get("PYTHONPATH", "")
        return subprocess.run(
            [sys.executable, "-m", "patchwork_tpu.cli", *args],
            cwd=cwd, env=env, capture_output=True, text=True, timeout=600,
        )

    @pytest.mark.slow
    def test_demo_patchwork(self, tmp_path):
        r = self.run_cli(
            ["--demo", "--use-patchwork", "--num-points", "3000",
             "--filtering-radius", "50", "--max-levels", "2"],
            tmp_path,
        )
        assert r.returncode == 0, r.stderr
        assert "Ground points:" in r.stdout
        assert (tmp_path / "demo_frame_patchwork.png").exists()

    @pytest.mark.slow
    def test_demo_separate_display(self, tmp_path):
        r = self.run_cli(
            ["--demo", "--use-patchwork", "--separate-display",
             "--num-points", "2000", "--filtering-radius", "50",
             "--max-levels", "2"],
            tmp_path,
        )
        assert r.returncode == 0, r.stderr
        assert (tmp_path / "demo_frame_patchwork.png").exists()
        assert (tmp_path / "demo_frame_enhanced.png").exists()

    def test_kitti_input(self, tmp_path):
        scan = demo_point_cloud(2000, seed=1)
        scan4 = np.column_stack([scan, np.zeros(len(scan), np.float32)])
        scan4.tofile(tmp_path / "0000000000.bin")
        r = self.run_cli(
            ["--kitti", str(tmp_path), "--frame", "0",
             "--filtering-radius", "50"],
            tmp_path,
        )
        assert r.returncode == 0, r.stderr
        assert (tmp_path / "lidar_bev_frame_0.png").exists()
