"""Hard labeled scenes + per-round accuracy eval (VERDICT r4 item 6).

The reference's synthetic tests assert only counts
(test/test_recursive_patchwork.cpp:74-76); these assert real segmentation
quality against by-construction labels on geometry the flat demo scene
never exercises.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from patchwork_tpu import PatchworkConfig
from patchwork_tpu.io.synthetic import HARD_SCENES, hard_labeled_scene
from patchwork_tpu.segment.engine import make_filter_ground
from patchwork_tpu.utils.metrics import mask_metrics


class TestHardScenes:
    @pytest.mark.parametrize("name", sorted(HARD_SCENES))
    def test_generator_shape_and_labels(self, name):
        xyz, labels = hard_labeled_scene(name, 4096, seed=1)
        assert xyz.shape == (4096, 3) and xyz.dtype == np.float32
        assert labels.shape == (4096,) and labels.dtype == bool
        # every scene has a substantial ground AND obstacle population
        frac = labels.mean()
        assert 0.4 < frac < 0.95, frac
        assert np.isfinite(xyz).all()
        # determinism
        xyz2, labels2 = hard_labeled_scene(name, 4096, seed=1)
        np.testing.assert_array_equal(xyz, xyz2)
        np.testing.assert_array_equal(labels, labels2)
        # labels are shuffled: not a contiguous block
        assert labels[: int(4096 * frac)].mean() < 0.99

    @pytest.mark.parametrize("name", sorted(HARD_SCENES))
    def test_engine_quality_floor(self, name):
        """Default-config engine stays above a per-scene IoU floor.

        Floors are set ~5 IoU points below the measured round-5 values
        (EVAL_r05.json) so a real accuracy regression trips, while seed /
        backend noise does not."""
        floors = {"slope": 0.88, "curb_ramp": 0.93, "overhang": 0.92,
                  "sparse_far": 0.85, "valley": 0.90}
        n = 16384
        xyz, labels = hard_labeled_scene(name, n, seed=0)
        fn = make_filter_ground(PatchworkConfig())
        res = fn(jnp.asarray(xyz), jnp.ones((n,), bool))
        m = mask_metrics(np.asarray(res.ground), labels)
        assert m["iou"] >= floors[name], (name, m)

    def test_eval_tool_runs(self, tmp_path):
        import json
        import subprocess
        import sys
        import os

        env = dict(os.environ, JAX_PLATFORMS="cpu")
        out = tmp_path / "eval.json"
        r = subprocess.run(
            [sys.executable, "tools/eval_scenes.py", "--points", "4096",
             "--seeds", "1", "--json-out", str(out)],
            capture_output=True, text=True, timeout=600, env=env,
            cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
        assert r.returncode == 0, r.stderr[-2000:]
        doc = json.loads(out.read_text())
        assert doc["metric"] == "hard_scene_mean_iou"
        assert set(doc["scenes"]) == set(HARD_SCENES)
        assert 0.0 < doc["value"] <= 1.0
