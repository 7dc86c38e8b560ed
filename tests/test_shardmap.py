"""Explicit-collective shard_map engine vs the GSPMD/single-device paths."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from patchwork_tpu import PatchworkConfig
from patchwork_tpu.io.synthetic import demo_point_cloud
from patchwork_tpu.oracle.reference import filter_ground_oracle
from patchwork_tpu.parallel.mesh import make_mesh
from patchwork_tpu.parallel.shardmap_engine import make_shardmap_patchwork
from patchwork_tpu.segment.engine import make_filter_ground

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs 8 virtual devices"
)

CFG = PatchworkConfig.patchwork(filtering_radius=60.0)


def batch(b=4, n=4096):
    xyz = np.stack([demo_point_cloud(n, seed=100 + i) for i in range(b)])
    return jnp.asarray(xyz), jnp.ones((b, n), bool)


class TestShardMapEngine:
    def test_matches_single_device(self):
        xyz, valid = batch()
        mesh = make_mesh(8, dp=2, sp=4)
        fn = make_shardmap_patchwork(CFG, mesh)
        g_sm = np.asarray(fn(xyz, valid))
        single = make_filter_ground(CFG, impl="scatter")
        for i in range(xyz.shape[0]):
            g_1 = np.asarray(single(xyz[i], valid[i]).ground)
            mm = (g_sm[i] != g_1).sum()
            assert mm == 0, f"scan {i}: {mm} mismatches"

    def test_matches_oracle(self):
        xyz, valid = batch(b=2)
        mesh = make_mesh(8, dp=1, sp=8)
        fn = make_shardmap_patchwork(CFG, mesh)
        g_sm = np.asarray(fn(xyz, valid))
        for i in range(2):
            g_o, *_ = filter_ground_oracle(np.asarray(xyz[i]), CFG)
            assert (g_sm[i] == g_o).all()

    def test_deficient_fallback_global_tiebreak(self):
        # all points above z_th -> 3-lowest fallback must pick GLOBAL
        # lowest indices across shards, same as single-device
        rng = np.random.default_rng(9)
        n = 2048
        pts = np.empty((n, 3), np.float32)
        pts[:, 0] = rng.uniform(2, 40, n)
        pts[:, 1] = rng.uniform(-40, 40, n)
        pts[:, 2] = rng.uniform(1.6, 3.5, n)
        xyz = jnp.asarray(pts[None])
        valid = jnp.ones((1, n), bool)
        mesh = make_mesh(8, dp=1, sp=8)
        g_sm = np.asarray(make_shardmap_patchwork(CFG, mesh)(xyz, valid))[0]
        g_1 = np.asarray(
            make_filter_ground(CFG, impl="scatter")(xyz[0], valid[0]).ground
        )
        np.testing.assert_array_equal(g_sm, g_1)

    def test_rejects_multi_level_config(self):
        mesh = make_mesh(8, dp=2, sp=4)
        with pytest.raises(ValueError):
            make_shardmap_patchwork(PatchworkConfig(), mesh)


@pytest.mark.slow
class TestProductionScaleParity:
    """Bench-shape sharded-vs-single-device bit parity (VERDICT r4 item 6).

    The dryrun covers only reduced configs (2048 pts, radius 60,
    max_levels 3); this runs the dp shard_map engine at the REAL bench
    shape — 131,072-pt velodyne scans, B=8, default PatchworkConfig — on
    the virtual 8-device dp mesh and asserts every mask bit matches a
    single-device run.
    """

    def test_dp_bench_shape(self):
        from patchwork_tpu.io.synthetic import velodyne_like_cloud
        from patchwork_tpu.parallel.sharded import (
            make_dp_sharded_filter_ground)

        b, n = 8, 131072
        xyz = jnp.asarray(np.stack(
            [velodyne_like_cloud(n, seed=i) for i in range(b)]))
        valid = jnp.ones((b, n), bool)
        cfg = PatchworkConfig()  # production default, all levels

        mesh = make_mesh(8, dp=8, sp=1)
        g_sm = np.asarray(
            make_dp_sharded_filter_ground(cfg, mesh)(xyz, valid).ground)

        single = make_filter_ground(cfg)
        for i in range(b):
            g_1 = np.asarray(single(xyz[i], valid[i]).ground)
            mm = int((g_sm[i] != g_1).sum())
            assert mm == 0, f"scan {i}: {mm}/{n} mask bits differ"
