"""PointCloudProcessor surface, variant presets, and CLI bag/stream modes."""

import os
import subprocess
import sys

import numpy as np
import pytest

from patchwork_tpu import PatchworkConfig, PointCloudProcessor
from patchwork_tpu.io.synthetic import demo_point_cloud

RNG = np.random.default_rng(23)


class TestProcessor:
    def test_remove_nan(self):
        pts = demo_point_cloud(100, seed=0).copy()
        pts[7] = np.nan
        assert len(PointCloudProcessor.remove_nan_points(pts)) == 99

    def test_band_filters(self):
        pts = demo_point_cloud(500, seed=1)
        d = np.hypot(pts[:, 0], pts[:, 1])
        out = PointCloudProcessor.filter_by_distance(pts, 5.0, 20.0)
        assert len(out) == ((d >= 5) & (d <= 20)).sum()
        out = PointCloudProcessor.filter_by_height(pts, 0.0, 1.0)
        assert (out[:, 2] >= 0).all() and (out[:, 2] <= 1).all()

    def test_centroid_cov_pca(self):
        pts = RNG.normal(size=(400, 3)).astype(np.float32)
        c = PointCloudProcessor.compute_centroid(pts)
        np.testing.assert_allclose(c, pts.mean(0), atol=1e-5)
        cov = PointCloudProcessor.compute_covariance(pts)
        np.testing.assert_allclose(cov, np.cov(pts.T, ddof=1), atol=1e-4)
        c2, vecs = PointCloudProcessor.compute_pca(pts)
        assert np.isfinite(vecs).all() and vecs.shape == (3, 3)
        # n < 3 sentinels (cpp:89-91)
        c3, v3 = PointCloudProcessor.compute_pca(pts[:2])
        np.testing.assert_array_equal(v3, np.eye(3, dtype=np.float32))

    def test_plane_distances(self):
        pts = RNG.normal(size=(50, 3)).astype(np.float32)
        n = np.array([0, 0, 1], np.float32)
        d = PointCloudProcessor.compute_distances_to_plane(pts, np.zeros(3), n)
        np.testing.assert_allclose(d, np.abs(pts[:, 2]), atol=1e-6)
        d1 = PointCloudProcessor.compute_point_to_plane_distance(
            pts[0], np.zeros(3), n
        )
        assert abs(d1 - abs(pts[0, 2])) < 1e-6

    def test_sampling(self):
        pts = demo_point_cloud(1000, seed=2)
        sub = PointCloudProcessor.random_subsample(pts, 100, seed=1)
        assert len(sub) == 100
        assert len(PointCloudProcessor.random_subsample(pts[:50], 100)) == 50
        vox = PointCloudProcessor.voxel_grid_filter(pts, 5.0)
        assert 0 < len(vox) < len(pts)

    def test_validity(self):
        assert PointCloudProcessor.is_valid_point([1, 2, 3])
        assert not PointCloudProcessor.is_valid_point([1, np.nan, 3])
        assert PointCloudProcessor.has_valid_points(demo_point_cloud(10, seed=0))


class TestVariants:
    def test_presets(self):
        assert PatchworkConfig.patchwork().max_split_depth == 0
        assert PatchworkConfig.recursive().max_split_depth == 1000
        assert PatchworkConfig.patchwork_pp().num_sectors == 16
        with pytest.raises(ValueError):
            PatchworkConfig.variant("nope")

    @pytest.mark.slow
    def test_variants_run_and_differ_where_expected(self):
        import jax.numpy as jnp

        from patchwork_tpu.segment.engine import make_filter_ground

        # sloped+step scene where recursion matters (splits to depth 3)
        rng = np.random.default_rng(7)
        n = 20000
        pts = np.empty((n, 3), np.float32)
        pts[:, 0] = rng.uniform(-80, 80, n)
        pts[:, 1] = rng.uniform(-80, 80, n)
        pts[:, 2] = 0.08 * pts[:, 0] + 0.5 * (pts[:, 1] > 20) + rng.normal(0, 0.05, n)
        obst = rng.uniform(-40, 40, (4000, 2))
        oz = rng.uniform(0.5, 3.0, 4000)
        pts = np.concatenate(
            [pts, np.column_stack([obst, oz]).astype(np.float32)]
        ).astype(np.float32)
        n = len(pts)
        counts = {}
        for v in PatchworkConfig.VARIANTS:
            cfg = PatchworkConfig.variant(v, filtering_radius=150.0)
            res = make_filter_ground(cfg)(jnp.asarray(pts), jnp.ones(n, bool))
            counts[v] = int(res.ground.sum())
            assert counts[v] > 0
        # recursive refines where plain patchwork cannot split
        assert counts["recursive"] != counts["patchwork"]


def run_cli(args, cwd):
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env["PYTHONPATH"] = repo + os.pathsep + env.get("PYTHONPATH", "")
    return subprocess.run(
        [sys.executable, "-m", "patchwork_tpu.cli", *args],
        cwd=cwd, env=env, capture_output=True, text=True, timeout=600,
    )


class TestCLIBagAndStream:
    def make_bag(self, tmp_path, topics, frames=2):
        from tests.test_bag_native_node import make_db3
        import sqlite3
        from patchwork_tpu.io.bag import encode_pointcloud2_cdr

        p = str(tmp_path / "multi.db3")
        conn = sqlite3.connect(p)
        conn.executescript(
            """
            CREATE TABLE topics(id INTEGER PRIMARY KEY, name TEXT, type TEXT,
                                serialization_format TEXT, offered_qos_profiles TEXT);
            CREATE TABLE messages(id INTEGER PRIMARY KEY, topic_id INTEGER,
                                  timestamp INTEGER, data BLOB);
            """
        )
        for tid, name in enumerate(topics, 1):
            conn.execute("INSERT INTO topics VALUES (?, ?, 'x', 'cdr', '')",
                         (tid, name))
            for f in range(frames):
                conn.execute(
                    "INSERT INTO messages VALUES (NULL, ?, ?, ?)",
                    (tid, f, encode_pointcloud2_cdr(
                        demo_point_cloud(1500, seed=tid * 10 + f))),
                )
        conn.commit()
        conn.close()
        return p

    @pytest.mark.slow
    def test_bag_single_topic(self, tmp_path):
        bag = self.make_bag(tmp_path, ["/lidar_points"])
        r = run_cli([bag, "--use-patchwork", "--filtering-radius", "50",
                     "--max-levels", "1"], tmp_path)
        assert r.returncode == 0, r.stderr
        assert "Ground points:" in r.stdout

    def test_bag_multi_topic_fusion(self, tmp_path):
        bag = self.make_bag(tmp_path, ["/lidar_front", "/lidar_left",
                                       "/lidar_right"])
        r = run_cli([bag, "--use-patchwork", "--filtering-radius", "50",
                     "--max-levels", "1"], tmp_path)
        assert r.returncode == 0, r.stderr
        assert "Topics: /lidar_front /lidar_left /lidar_right" in r.stdout

    def test_stream_kitti(self, tmp_path):
        for i in range(3):
            scan = demo_point_cloud(1200, seed=i)
            scan4 = np.column_stack([scan, np.zeros(len(scan), np.float32)])
            scan4.tofile(tmp_path / f"{i:010d}.bin")
        r = run_cli(["--stream", "--kitti", str(tmp_path),
                     "--filtering-radius", "50", "--max-levels", "1",
                     "--num-points", "2048"], tmp_path)
        assert r.returncode == 0, r.stderr
        assert "Processed frame 2" in r.stdout
        assert (tmp_path / "stream_masks.npz").exists()

    def test_variant_flag(self, tmp_path):
        r = run_cli(["--demo", "--use-patchwork", "--variant", "patchwork",
                     "--num-points", "2000", "--filtering-radius", "50"],
                    tmp_path)
        assert r.returncode == 0, r.stderr
