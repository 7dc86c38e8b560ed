"""Mesh-sharded execution on the virtual 8-device CPU mesh.

The reference has no distributed tests at all (SURVEY.md §4); this suite
validates that the dp x sp sharded engine produces bit-identical masks to
the single-device path and to the recursive oracle."""

import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from patchwork_tpu import PatchworkConfig
from patchwork_tpu.io.synthetic import demo_point_cloud
from patchwork_tpu.oracle.reference import filter_ground_oracle
from patchwork_tpu.parallel.mesh import make_mesh, scan_batch_sharding
from patchwork_tpu.parallel.sharded import (
    make_dp_sharded_filter_ground,
    make_sharded_filter_ground,
    make_sharded_pipeline,
)

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs 8 virtual devices"
)

CFG = PatchworkConfig(filtering_radius=60.0, max_levels=3)


def batch(b=8, n=2048):
    xyz = np.stack([demo_point_cloud(n, seed=i) for i in range(b)])
    return jnp.asarray(xyz), jnp.ones((b, n), bool)


class TestSharded:
    def test_dp_only_matches_oracle(self):
        mesh = make_mesh(8, dp=8, sp=1)
        fn = make_sharded_filter_ground(CFG, mesh, shard_points=False)
        xyz, valid = batch()
        res = fn(xyz, valid)
        g = np.asarray(res.ground)
        for i in (0, 3, 7):
            g_o, *_ = filter_ground_oracle(np.asarray(xyz[i]), CFG)
            np.testing.assert_array_equal(g[i], g_o)

    def test_dp_sp_matches_oracle(self):
        mesh = make_mesh(8, dp=4, sp=2)
        fn = make_sharded_filter_ground(CFG, mesh, shard_points=True)
        xyz, valid = batch()
        res = fn(xyz, valid)
        g = np.asarray(res.ground)
        for i in (0, 5):
            g_o, *_ = filter_ground_oracle(np.asarray(xyz[i]), CFG)
            np.testing.assert_array_equal(g[i], g_o)

    @pytest.mark.slow
    def test_sp4_matches_dp(self):
        xyz, valid = batch(b=4)
        m1 = make_mesh(8, dp=4, sp=2)
        m2 = make_mesh(8, dp=2, sp=4)
        r1 = make_sharded_filter_ground(CFG, m1)(xyz, valid)
        r2 = make_sharded_filter_ground(CFG, m2)(xyz, valid)
        np.testing.assert_array_equal(np.asarray(r1.ground), np.asarray(r2.ground))

    def test_pipeline_counts(self):
        mesh = make_mesh(8, dp=4, sp=2)
        fn = make_sharded_pipeline(CFG, mesh)
        xyz, valid = batch()
        res, g_cnt, ng_cnt = fn(xyz, valid)
        g_cnt, ng_cnt = np.asarray(g_cnt), np.asarray(ng_cnt)
        np.testing.assert_array_equal(
            g_cnt, np.asarray(res.ground).sum(axis=1)
        )
        assert (g_cnt > 0).all() and (ng_cnt > 0).all()

    @pytest.mark.slow
    def test_dp_shardmap_bitparity(self):
        """The dp-sharded engine under shard_map: masks bit-identical to
        the single-device batched engine AND the oracle."""
        from patchwork_tpu.segment.engine import make_filter_ground_batched

        mesh = make_mesh(8, dp=8, sp=1)
        xyz, valid = batch(b=8, n=1024)
        res = make_dp_sharded_filter_ground(CFG, mesh)(xyz, valid)
        g = np.asarray(res.ground)
        g_single = np.asarray(
            make_filter_ground_batched(CFG)(xyz, valid).ground)
        np.testing.assert_array_equal(g, g_single)
        g_o, *_ = filter_ground_oracle(np.asarray(xyz[0]), CFG)
        np.testing.assert_array_equal(g[0], g_o)

    @pytest.mark.slow
    def test_dp_shardmap_with_counts(self):
        mesh = make_mesh(8, dp=4, sp=2)  # sp>1: replicated over sp
        xyz, valid = batch(b=4, n=1024)
        res, g_cnt, ng_cnt = make_dp_sharded_filter_ground(
            CFG, mesh, with_counts=True)(xyz, valid)
        np.testing.assert_array_equal(
            np.asarray(g_cnt), np.asarray(res.ground).sum(axis=1))
        assert (np.asarray(g_cnt) > 0).all()

    @pytest.mark.slow
    def test_impl_routing(self):
        """shard_points=False routes through the dp shard_map engine and
        sp>1 through GSPMD, with the configured impl on both."""
        cfg = CFG.replace(segment_impl="onehot")
        mesh = make_mesh(8, dp=8, sp=1)
        xyz, valid = batch(b=8, n=1024)
        res = make_sharded_filter_ground(cfg, mesh, shard_points=False)(
            xyz, valid)
        g_o, *_ = filter_ground_oracle(np.asarray(xyz[0]), CFG)
        np.testing.assert_array_equal(np.asarray(res.ground)[0], g_o)
        mesh2 = make_mesh(8, dp=4, sp=2)
        res2 = make_sharded_filter_ground(cfg, mesh2, shard_points=True)(
            xyz, valid)
        np.testing.assert_array_equal(
            np.asarray(res2.ground), np.asarray(res.ground))

    def test_input_shardings_applied(self):
        mesh = make_mesh(8, dp=4, sp=2)
        xyz_s, valid_s = scan_batch_sharding(mesh)
        xyz, valid = batch()
        xs = jax.device_put(xyz, xyz_s)
        assert len(xs.addressable_shards) == 8


class TestGraftEntry:
    def test_entry_compiles(self):
        import sys
        sys.path.insert(0, os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))
        import __graft_entry__ as ge

        fn, args = ge.entry()
        out = jax.jit(fn)(*args)
        jax.block_until_ready(out)
        assert int(out[0].sum()) > 0

    @pytest.mark.slow
    def test_dryrun_multichip(self):
        import __graft_entry__ as ge

        ge.dryrun_multichip(8)
