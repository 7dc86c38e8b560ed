"""Mesh-sharded batch segmentation (pjit/GSPMD + dp shard_map).

Two sharded execution paths, both running the default segment-op impl
(segops.DEFAULT_IMPL) unless ``cfg.segment_impl`` names one:

* ``sp > 1`` (points sharded within a scan): the engine jit-compiles under
  GSPMD — XLA partitions the segment reductions and inserts the
  collectives.  Per-node arrays stay replicated (tiny next to the
  points), so collective traffic per step is O(nodes), not O(points).
* ``sp == 1`` (whole scans per device): scans are independent across
  ``dp``, so :func:`make_dp_sharded_filter_ground` runs the batched engine
  on each device's local shard under ``shard_map``; no collective is
  needed until the summary reduce.  Masks are bit-identical to a
  single-device run (asserted in __graft_entry__.dryrun_multichip).

The reference has no multi-device analogue at all (single
cudaSetDevice(0), cuda/cuda_interface.cu:68).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from ..core.config import PatchworkConfig
from ..segment.engine import filter_ground
from .mesh import DATA_AXIS, scan_batch_sharding

__all__ = ["make_sharded_filter_ground", "make_sharded_pipeline",
           "make_dp_sharded_filter_ground"]


def _counts(res):
    ground_cnt = jnp.sum(res.ground, axis=-1, dtype=jnp.int32)
    nong_cnt = jnp.sum(res.valid & ~res.ground, axis=-1, dtype=jnp.int32)
    return res, ground_cnt, nong_cnt


def make_dp_sharded_filter_ground(cfg: PatchworkConfig, mesh,
                                  with_counts: bool = False):
    """dp-sharded batched engine: each device segments its local scans.

    fn(xyz (B,N,3), valid (B,N)) -> GroundResult of (B,N) masks (plus
    per-frame (B,) ground / non-ground counts when ``with_counts``).
    B must divide by the mesh's dp size.  If the mesh has an sp axis of
    size > 1 the computation is replicated across it (inputs and outputs
    are unsharded along points) — prefer an sp=1 mesh.
    """

    def local(xyz, valid):
        res = jax.vmap(lambda p, v: filter_ground(p, v, cfg))(xyz, valid)
        return _counts(res) if with_counts else res

    mask_spec = P(DATA_AXIS, None)
    out_specs = (mask_spec, P(DATA_AXIS), P(DATA_AXIS)) if with_counts \
        else mask_spec
    smapped = jax.shard_map(
        local,
        mesh=mesh,
        in_specs=(P(DATA_AXIS, None, None), P(DATA_AXIS, None)),
        out_specs=out_specs,
        check_vma=False,
    )
    return jax.jit(smapped)


def make_sharded_filter_ground(
    cfg: PatchworkConfig, mesh, shard_points: bool = True
):
    """jit-compiled (B, N) batched engine with mesh input/output shardings.

    Returns fn(xyz (B,N,3), valid (B,N)) -> GroundResult of (B,N) masks.
    ``shard_points=False`` routes through
    :func:`make_dp_sharded_filter_ground`; otherwise GSPMD partitions the
    engine over the point axis too.
    """
    if not shard_points:
        return make_dp_sharded_filter_ground(cfg, mesh)

    xyz_s, valid_s = scan_batch_sharding(mesh, shard_points)

    @functools.partial(
        jax.jit,
        in_shardings=(xyz_s, valid_s),
        out_shardings=valid_s,
    )
    def fn(xyz, valid):
        return jax.vmap(lambda p, v: filter_ground(p, v, cfg))(xyz, valid)

    return fn


def make_sharded_pipeline(cfg: PatchworkConfig, mesh, shard_points: bool = True):
    """Full streaming step: segmentation + per-frame summary stats.

    The summary (ground/non-ground counts per frame — what the reference's
    ROS2 node publishes as markers, recursive_patchwork_node.cpp:159-221)
    reduces on device so only (B, 2) ints cross to the host.
    """
    if not shard_points:
        return make_dp_sharded_filter_ground(cfg, mesh, with_counts=True)

    xyz_s, valid_s = scan_batch_sharding(mesh, shard_points)

    @functools.partial(jax.jit, in_shardings=(xyz_s, valid_s))
    def fn(xyz, valid):
        return _counts(jax.vmap(lambda p, v: filter_ground(p, v, cfg))(
            xyz, valid))

    return fn
