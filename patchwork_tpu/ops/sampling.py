"""Sampling / downsampling ops: seeded random subsample, voxel-grid filter.

Device-side re-design of the reference's host-side samplers:

* ``random_subsample_mask`` replaces the unseeded rejection-sampling loop in
  PointCloudProcessor::randomSubsample (point_cloud_processor.cpp:122-148)
  with a seeded, parallel Gumbel top-k draw — uniform without replacement,
  reproducible, fixed-shape (returns a selection mask).
* ``voxel_grid_filter`` replaces the string-keyed hash map centroid filter
  (point_cloud_processor.cpp:150-196) with sort + run-segmentation +
  segment-sum — exact voxel centroids, fixed-capacity padded output.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

__all__ = ["random_subsample_mask", "voxel_grid_filter"]


def random_subsample_mask(
    key: jax.Array, valid: jax.Array, target_size: int
) -> jax.Array:
    """Mask selecting min(target_size, n_valid) points uniformly w/o replacement.

    If fewer than ``target_size`` points are valid, all valid points are
    selected (reference returns the input unchanged in that case,
    point_cloud_processor.cpp:124-126).
    """
    n = valid.shape[-1]
    k = min(target_size, n)
    g = jax.random.gumbel(key, valid.shape, jnp.float32)
    g = jnp.where(valid, g, -jnp.inf)
    _, top_idx = jax.lax.top_k(g, k)
    sel = jnp.zeros(valid.shape, bool).at[..., top_idx].set(True) if valid.ndim == 1 \
        else _batched_scatter_topk(valid, top_idx)
    return sel & valid


def _batched_scatter_topk(valid: jax.Array, top_idx: jax.Array) -> jax.Array:
    sel = jnp.zeros(valid.shape, bool)
    return jax.vmap(lambda s, i: s.at[i].set(True))(sel, top_idx)


def voxel_grid_filter(xyz: jax.Array, valid: jax.Array, voxel_size: float):
    """Exact voxel-grid centroid filter with fixed-capacity output.

    Returns (centroids (N, 3), out_valid (N,)): one centroid per occupied
    voxel, padded to the input capacity.  Voxel index is floor(x / s) per
    axis, matching point_cloud_processor.cpp:161-163.
    """
    n = xyz.shape[0]
    inv = jnp.float32(1.0 / voxel_size)
    vox = jnp.floor(xyz * inv).astype(jnp.int32)  # (N, 3)

    # Lexicographic 3-key sort on voxel coords (int64 packing would need
    # x64 mode; multi-key lax.sort does not).  Invalid rows sort last.
    big = jnp.int32(2**31 - 1)
    kx = jnp.where(valid, vox[:, 0], big)
    ky = jnp.where(valid, vox[:, 1], big)
    kz = jnp.where(valid, vox[:, 2], big)
    idx = jnp.arange(n, dtype=jnp.int32)
    skx, sky, skz, order = jax.lax.sort((kx, ky, kz, idx), num_keys=3)
    sxyz = xyz[order]
    svalid = valid[order]

    same = (skx[1:] == skx[:-1]) & (sky[1:] == sky[:-1]) & (skz[1:] == skz[:-1])
    is_first = jnp.concatenate([jnp.ones((1,), bool), ~same]) & svalid
    run_id = jnp.cumsum(is_first.astype(jnp.int32)) - 1  # (N,) voxel run per point
    run_id = jnp.where(svalid, run_id, n - 1)  # park invalid in the last slot

    w = svalid.astype(jnp.float32)
    sums = jax.ops.segment_sum(sxyz * w[:, None], run_id, num_segments=n)
    cnts = jax.ops.segment_sum(w, run_id, num_segments=n)
    centroids = sums / jnp.maximum(cnts, 1.0)[:, None]

    num_runs = jnp.sum(is_first.astype(jnp.int32))
    slot = jnp.arange(n)
    out_valid = slot < num_runs
    return jnp.where(out_valid[:, None], centroids, 0.0), out_valid
