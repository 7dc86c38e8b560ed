"""Polar-grid (ring x sector) patch assignment.

Replaces the reference's hot O(rings*sectors*N) membership rescan
(src/recursive_patchwork.cpp:360-378) with a single vectorized pass that
assigns every point its patch id directly.  Ring/sector membership uses the
exact same edge values and comparison directions as the reference
(d >= r0 && d < r1, a >= a0 && a < a1), so the binning is bit-identical.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp

from ..core.config import PatchworkConfig
from ..ops.pointcloud import distance_2d, finite_mask, polar_angle

__all__ = ["ring_edges", "sector_edges", "PatchAssignment", "assign_patches"]


def ring_edges(cfg: PatchworkConfig) -> np.ndarray:
    """Log-spaced ring edges r_min * (R/r_min)^(i/num_rings), float32.

    Computed in float32 exactly as the reference's powf expression
    (src/recursive_patchwork.cpp:344-350).  Shared with the NumPy oracle
    so both implementations bin against bit-identical edges.
    """
    i = np.arange(cfg.num_rings + 1, dtype=np.float32)
    ratio = np.float32(cfg.filtering_radius) / np.float32(cfg.r_min)
    return np.float32(cfg.r_min) * np.power(
        ratio, i / np.float32(cfg.num_rings), dtype=np.float32
    )


def sector_edges(cfg: PatchworkConfig) -> np.ndarray:
    """Sector edges float32(s) * float32(2*pi/num_sectors), s=0..num_sectors.

    The same float32 product the reference evaluates per sector
    (src/recursive_patchwork.cpp:352,364).  Shared with the NumPy oracle.
    """
    s = np.arange(cfg.num_sectors + 1, dtype=np.float32)
    return s * np.float32(2.0 * math.pi / cfg.num_sectors)


class PatchAssignment(NamedTuple):
    patch: jax.Array      # (N,) int32 patch id in [0, P); P (=trash) if not in a patch
    in_patch: jax.Array   # (N,) bool
    in_zone: jax.Array    # (N,) bool: finite & d <= filtering_radius
    finite: jax.Array     # (N,) bool
    dist: jax.Array       # (N,) float32 2D range
    rel_dist: jax.Array   # (P+1,) float32 per-patch mean dist / filtering_radius


def assign_patches(
    xyz: jax.Array, valid: jax.Array, cfg: PatchworkConfig, impl: str = "scatter"
) -> PatchAssignment:
    """Assign each point a ring*num_sectors+sector patch id in one pass."""
    num_p = cfg.num_patches
    fin = valid & finite_mask(xyz)
    # Zero non-finite coordinates: they are excluded from every patch by
    # `fin` anyway, but a NaN value would otherwise poison the one-hot
    # matmul segment reductions (0 * NaN = NaN in IEEE; the 'onehot'
    # impl multiplies every point row into every segment column).
    xyz = jnp.where(fin[:, None], xyz, 0.0)
    d = distance_2d(xyz)
    ang = polar_angle(xyz)
    in_zone = fin & (d <= jnp.float32(cfg.filtering_radius))

    r_edges = jnp.asarray(ring_edges(cfg))
    s_edges = jnp.asarray(sector_edges(cfg))

    # ring = #(interior edges <= d); valid iff edges[0] <= d < edges[-1]
    ring = jnp.sum(d[:, None] >= r_edges[None, 1:-1], axis=1).astype(jnp.int32)
    in_ring = (d >= r_edges[0]) & (d < r_edges[-1])
    # sector = #(interior edges <= a); valid iff a < edges[-1] (a >= 0 always)
    sector = jnp.sum(ang[:, None] >= s_edges[None, 1:-1], axis=1).astype(jnp.int32)
    in_sector = ang < s_edges[-1]

    in_patch = in_zone & in_ring & in_sector
    patch = jnp.where(
        in_patch, ring * cfg.num_sectors + sector, jnp.int32(num_p)
    ).astype(jnp.int32)

    # Per-patch mean 2D distance (reference computes it per patch at the
    # top-level call and threads it unchanged through the recursion,
    # src/recursive_patchwork.cpp:383-390).
    from .segops import SegOps

    w = in_patch.astype(jnp.float32)
    ops = SegOps(patch, num_p + 1, impl)
    sums = ops.sum(jnp.stack([d * w, w], axis=1))
    mean_dist = sums[:, 0] / jnp.maximum(sums[:, 1], 1.0)
    rel_dist = mean_dist / jnp.float32(cfg.filtering_radius)

    return PatchAssignment(patch, in_patch, in_zone, fin, d, rel_dist)
