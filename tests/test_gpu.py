"""Tests that need the card: they skip elsewhere (the ``gpu`` fixture) and
run on the GPU in phase (f) of chip_smoke.py.

They pin what the CPU suite cannot see: the engine's masks on the card at
bench size against the NumPy oracle, the two segment-op impls against each
other there, and full f32 precision where a default-precision matmul could
run in TF32.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from patchwork_tpu import PatchworkConfig, make_filter_ground
from patchwork_tpu.oracle.reference import filter_ground_oracle

pytestmark = pytest.mark.gpu


def _scene(name, n, seed):
    from patchwork_tpu.io import synthetic

    gen = {"velodyne": synthetic.velodyne_like_cloud,
           "demo": synthetic.demo_point_cloud,
           "fused_iac": synthetic.fused_iac_cloud}[name]
    return gen(n, seed=seed)


@pytest.mark.parametrize("impl", ["scatter", "onehot"])
@pytest.mark.parametrize("scene", ["velodyne", "demo", "fused_iac"])
def test_bench_size_masks_match_oracle(gpu, scene, impl):
    pts = _scene(scene, 131072, seed=7)
    cfg = PatchworkConfig()
    res = make_filter_ground(cfg, impl=impl)(
        jnp.asarray(pts), jnp.ones(len(pts), bool))
    assert res.ground.devices() == {gpu}
    g_o, *_ = filter_ground_oracle(pts, cfg)
    np.testing.assert_array_equal(np.asarray(res.ground), g_o)


@pytest.mark.parametrize("cfg", [
    PatchworkConfig(filtering_radius=50.0, num_sectors=8, max_iter=50),
    PatchworkConfig(adaptive_seed_height=False, filtering_radius=60.0),
    PatchworkConfig(max_split_depth=0),
], ids=["testsuite", "non_adaptive", "no_split"])
def test_impls_agree_on_card(gpu, cfg):
    from patchwork_tpu.io.synthetic import demo_point_cloud

    pts = jnp.asarray(demo_point_cloud(20000, seed=3))
    valid = jnp.ones(pts.shape[0], bool)
    g_s = np.asarray(make_filter_ground(cfg, impl="scatter")(pts, valid).ground)
    g_o = np.asarray(make_filter_ground(cfg, impl="onehot")(pts, valid).ground)
    np.testing.assert_array_equal(g_s, g_o)


def test_small_inverses_full_f32(gpu):
    """The Schur solver's 6x6 block inverse keeps f32 accuracy on the card
    (a TF32 matmul would leave ~1e-3 relative error)."""
    from patchwork_tpu.slam.ba import _inv6x6

    rng = np.random.default_rng(0)
    a = rng.normal(size=(64, 6, 6))
    spd = a @ np.swapaxes(a, 1, 2) + 6 * np.eye(6)
    inv = np.asarray(jax.jit(_inv6x6)(jnp.asarray(spd, jnp.float32)))
    ref = np.linalg.inv(spd)
    rel = np.abs(inv - ref).max() / np.abs(ref).max()
    assert rel < 1e-4, rel
