"""Core array containers.

Point clouds are fixed-capacity SoA ``(N, 3)`` float32
arrays with a validity mask, registered as JAX pytrees so they flow through
``jit``/``vmap``/``pjit`` unchanged.  This replaces the reference's
AoS ``std::vector<Point3D>`` (include/recursive_patchwork.hpp:18-22) and the
per-op AoS<->SoA repacking its CUDA layer does on every call
(cuda/cuda_interface.cu:119-132) — here the SoA layout is the one and only
layout, resident in device memory from ingest onward.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class PointCloud:
    """A fixed-capacity batch-free point cloud.

    ``xyz``   : (N, 3) float32 point coordinates (padding rows arbitrary).
    ``valid`` : (N,)   bool    which rows are real points.
    """

    xyz: jax.Array
    valid: jax.Array

    @property
    def capacity(self) -> int:
        return self.xyz.shape[0]

    def count(self) -> jax.Array:
        return jnp.sum(self.valid.astype(jnp.int32))

    @staticmethod
    def from_numpy(pts: np.ndarray, capacity: Optional[int] = None) -> "PointCloud":
        """Pad a (n, 3)[+] float array into a fixed-capacity PointCloud."""
        pts = np.asarray(pts, dtype=np.float32)
        if pts.ndim != 2 or pts.shape[1] < 3:
            raise ValueError(f"expected (n, >=3) array, got {pts.shape}")
        n = pts.shape[0]
        cap = capacity if capacity is not None else n
        if cap < n:
            raise ValueError(f"capacity {cap} < number of points {n}")
        xyz = np.zeros((cap, 3), dtype=np.float32)
        xyz[:n] = pts[:, :3]
        valid = np.zeros((cap,), dtype=bool)
        valid[:n] = True
        return PointCloud(jnp.asarray(xyz), jnp.asarray(valid))

    def to_numpy(self) -> np.ndarray:
        """Compact back to a (n, 3) numpy array of the valid points."""
        xyz = np.asarray(self.xyz)
        valid = np.asarray(self.valid)
        return xyz[valid]


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class ScanBatch:
    """A batch of fixed-capacity scans: SoA ``(B, N, 3)`` + ``(B, N)`` mask.

    This is the unit of data-parallel work: frames shard over the mesh's
    data axis, points over the model axis (see patchwork_tpu.parallel).
    """

    xyz: jax.Array    # (B, N, 3) float32
    valid: jax.Array  # (B, N) bool

    @property
    def batch(self) -> int:
        return self.xyz.shape[0]

    @property
    def capacity(self) -> int:
        return self.xyz.shape[1]

    @staticmethod
    def stack(clouds) -> "ScanBatch":
        return ScanBatch(
            jnp.stack([c.xyz for c in clouds]),
            jnp.stack([c.valid for c in clouds]),
        )

    def __getitem__(self, i: int) -> PointCloud:
        return PointCloud(self.xyz[i], self.valid[i])


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class GroundResult:
    """Output of the segmentation engine for one scan (all fixed-shape masks).

    The reference returns two compacted vectors (ground, non-ground)
    (src/recursive_patchwork.cpp:310-426); here we keep fixed shapes and
    return masks over the input rows instead.  ``ground & valid`` and
    ``~ground & valid`` recover the reference's two sets exactly
    (finite-ness is folded into ``valid``).
    """

    ground: jax.Array    # (N,) bool: valid & classified ground
    valid: jax.Array     # (N,) bool: finite input points (reference cleanPoints)
    in_zone: jax.Array   # (N,) bool: valid & within filtering radius
    in_patch: jax.Array  # (N,) bool: valid & assigned to a ring/sector patch

    def num_ground(self) -> jax.Array:
        return jnp.sum(self.ground.astype(jnp.int32))

    def num_non_ground(self) -> jax.Array:
        return jnp.sum((self.valid & ~self.ground).astype(jnp.int32))


def as_xyz(points) -> jax.Array:
    """Coerce list/ndarray of shape (n,3) to a float32 jnp array."""
    arr = jnp.asarray(points, dtype=jnp.float32)
    if arr.ndim != 2 or arr.shape[-1] != 3:
        raise ValueError(f"expected (n, 3), got {arr.shape}")
    return arr
