"""Metrics, checkpointing, and the parity harness tool."""

import os
import subprocess
import sys

import numpy as np
import pytest

from patchwork_tpu.core.config import PatchworkConfig
from patchwork_tpu.io.synthetic import simulate_sequence, simulate_world
from patchwork_tpu.utils.checkpoint import (
    load_masks,
    load_odometry,
    save_masks,
    save_odometry,
)
from patchwork_tpu.utils.metrics import format_metrics, mask_metrics


class TestMetrics:
    def test_perfect(self):
        t = np.array([1, 1, 0, 0], bool)
        m = mask_metrics(t, t)
        assert m["iou"] == 1.0 and m["f1"] == 1.0

    def test_half(self):
        pred = np.array([1, 1, 0, 0], bool)
        truth = np.array([1, 0, 1, 0], bool)
        m = mask_metrics(pred, truth)
        assert abs(m["iou"] - 1 / 3) < 1e-9
        assert abs(m["precision"] - 0.5) < 1e-9
        assert abs(m["recall"] - 0.5) < 1e-9

    def test_valid_filter(self):
        pred = np.array([1, 0, 1], bool)
        truth = np.array([1, 0, 0], bool)
        valid = np.array([1, 1, 0], bool)
        m = mask_metrics(pred, truth, valid)
        assert m["iou"] == 1.0
        assert "IoU" in format_metrics(m)


class TestCheckpoint:
    def test_masks_roundtrip(self, tmp_path):
        rng = np.random.default_rng(0)
        g = rng.random((5, 1000)) < 0.5
        v = rng.random((5, 1000)) < 0.9
        p = str(tmp_path / "masks.npz")
        save_masks(p, g, v)
        g2, v2, ids = load_masks(p)
        np.testing.assert_array_equal(g, g2)
        np.testing.assert_array_equal(v, v2)
        np.testing.assert_array_equal(ids, np.arange(5))

    def test_odometry_roundtrip(self, tmp_path):
        from patchwork_tpu.slam import LidarOdometry, OdometryConfig

        world = simulate_world(seed=3, num_pillars=40)
        scans, _ = simulate_sequence(num_frames=3, seed=3, world=world)
        odo = LidarOdometry(
            patchwork=PatchworkConfig(filtering_radius=80.0, max_levels=1),
            cfg=OdometryConfig(capacity=16384, obstacle_samples=512,
                               ground_samples=256, icp_iters=5),
        )
        for i, s in enumerate(scans):
            odo.add_scan(s, seed=i)
        p = str(tmp_path / "odo.npz")
        save_odometry(p, odo)
        poses, edges, cfg = load_odometry(p)
        assert poses.shape == (3, 4, 4)
        assert len(edges) == 2
        assert cfg.filtering_radius == 80.0


class TestParityTool:
    @pytest.mark.slow
    def test_runs_and_passes(self, tmp_path):
        repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        env = dict(os.environ, JAX_PLATFORMS="cpu")
        r = subprocess.run(
            [sys.executable, os.path.join(repo, "tools", "parity_bench.py"),
             "--points", "4096", "--impls", "scatter", "onehot", "--reps", "1"],
            capture_output=True, text=True, timeout=600, env=env, cwd=repo,
        )
        assert r.returncode == 0, r.stdout + r.stderr
        assert "ALL PARITY PASS" in r.stdout


class TestDeviceAndDebug:
    @pytest.mark.slow
    def test_device_info(self):
        from patchwork_tpu.core.device import (
            accelerator_available,
            cleanup,
            device_info,
            initialize,
        )

        assert isinstance(accelerator_available(), bool)
        assert initialize() in (True, False)
        info = device_info()
        assert len(info) >= 1 and "platform" in info[0]
        cleanup()

    def test_enable_compilation_cache(self, tmp_path, monkeypatch):
        """core/device.enable_compilation_cache: JAX_COMPILATION_CACHE_DIR
        wins, the call is idempotent, and JAX's config points at the dir
        (restored afterwards, so no later test inherits a deleted path)."""
        import jax

        from patchwork_tpu.core.device import enable_compilation_cache

        before = jax.config.jax_compilation_cache_dir
        d = str(tmp_path / "xla_cache")
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", d)
        try:
            assert enable_compilation_cache() == d
            assert enable_compilation_cache() == d
            assert os.path.isdir(d)
            assert jax.config.jax_compilation_cache_dir == d
        finally:
            jax.config.update("jax_compilation_cache_dir", before)

    def test_multihost_noop(self):
        from patchwork_tpu.parallel.multihost import (
            host_summary,
            initialize_multihost,
            is_multihost,
        )

        assert initialize_multihost() is False  # no coordinator configured
        assert is_multihost() is False
        assert "process 0/1" in host_summary()

    def test_debug_nans_toggle(self):
        import jax
        import jax.numpy as jnp
        import pytest as _pytest

        from patchwork_tpu.utils.debug import assert_finite, debug_nans

        # the 0/0 executable may already be compiled (and cached) WITHOUT
        # nan-checking by an earlier test; debug_nans only instruments
        # fresh compilations
        jax.clear_caches()
        with debug_nans(True):
            with _pytest.raises(FloatingPointError):
                jax.block_until_ready(jnp.zeros(4) / jnp.zeros(4))
        # restored afterwards
        assert not jax.config.jax_debug_nans
        with _pytest.raises(FloatingPointError):
            assert_finite(np.array([1.0, np.nan]))
        assert_finite(np.ones(3))
