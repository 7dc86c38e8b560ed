"""Multi-LiDAR fusion as one device computation.

The reference fuses sensors one at a time on the host: per-sensor rotate
(GPU round-trip) then ego removal then std::vector concatenation
(src/lidar_fusion.cpp:42-107).  Here all sensors process in ONE fused
device computation: scans are stacked ``(S, N, 3)``, per-sensor extrinsics
are a stacked ``(S, 4, 4)`` tensor applied with a single einsum, ego
removal is a mask, and "concatenation" is a reshape — no host staging, no
per-sensor dispatch.
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import jax
import jax.numpy as jnp

from ..core.config import LidarConfig, default_lidar_configs
from ..core.types import PointCloud
from ..ops.pointcloud import ego_mask, transform_4x4

__all__ = [
    "rotation_matrix_2d",
    "translation_matrix",
    "stack_extrinsics",
    "fuse_stacked",
    "LidarFusion",
]


def rotation_matrix_2d(angle_degrees: float) -> np.ndarray:
    """4x4 homogeneous Z-rotation (reference: lidar_fusion.cpp:161-173)."""
    r = math.radians(angle_degrees)
    c, s = math.cos(r), math.sin(r)
    m = np.eye(4, dtype=np.float32)
    m[0, 0], m[0, 1] = c, -s
    m[1, 0], m[1, 1] = s, c
    return m


def translation_matrix(x: float, y: float, z: float) -> np.ndarray:
    """4x4 homogeneous translation (reference: lidar_fusion.cpp:175-182)."""
    m = np.eye(4, dtype=np.float32)
    m[:3, 3] = [x, y, z]
    return m


def stack_extrinsics(configs: Sequence[LidarConfig]) -> np.ndarray:
    """(S, 4, 4) stacked per-sensor transforms from LidarConfigs."""
    return np.stack([rotation_matrix_2d(c.rotation_angle_deg) for c in configs])


def fuse_stacked(
    xyz: jax.Array,       # (S, N, 3)
    valid: jax.Array,     # (S, N)
    extrinsics: jax.Array,  # (S, 4, 4)
    ego_radius: jax.Array,  # (S,)
):
    """Transform each sensor's cloud by its extrinsic, mask the ego vehicle,
    and flatten to one fused cloud.

    Returns (fused_xyz (S*N, 3), fused_valid (S*N,)).  jit/pjit-friendly:
    all shapes static, one einsum for all sensors' transforms.
    Reference semantics: processSingleLidar (lidar_fusion.cpp:88-107) —
    rotation applied only when the angle is nonzero is equivalent to always
    applying (identity at 0 degrees); ego removal keeps d > radius.
    """
    out = transform_4x4(xyz, extrinsics)  # (S, N, 3), batched over S
    keep = valid & ego_mask(out, ego_radius[:, None])
    s, n, _ = out.shape
    return out.reshape(s * n, 3), keep.reshape(s * n)


class LidarFusion:
    """Convenience wrapper mirroring the reference LidarFusion class
    (include/lidar_fusion.hpp:10-44), with the default 3-LiDAR IAC layout.
    """

    def __init__(self, configs: Sequence[LidarConfig] | None = None):
        self.configs = list(configs) if configs is not None else list(
            default_lidar_configs()
        )
        self._jit_fuse = jax.jit(fuse_stacked)

    def add_lidar(self, config: LidarConfig) -> None:
        self.configs.append(config)

    def clear_lidars(self) -> None:
        self.configs.clear()

    def fuse(self, clouds: Sequence[np.ndarray]) -> PointCloud:
        """Fuse per-sensor (n_i, 3) arrays into one PointCloud.

        Like the reference (lidar_fusion.cpp:49-58), extra clouds beyond
        the configured sensors are ignored with a warning.
        """
        if not clouds:
            return PointCloud(jnp.zeros((0, 3), jnp.float32), jnp.zeros((0,), bool))
        k = min(len(clouds), len(self.configs))
        if len(clouds) != len(self.configs):
            print(
                f"Warning: {len(clouds)} clouds vs {len(self.configs)} configs; "
                f"fusing first {k}"
            )
        cap = max(len(c) for c in clouds[:k])
        xyz = np.zeros((k, cap, 3), np.float32)
        valid = np.zeros((k, cap), bool)
        for i, c in enumerate(clouds[:k]):
            c = np.asarray(c, np.float32)[:, :3]
            xyz[i, : len(c)] = c
            valid[i, : len(c)] = True
        ext = stack_extrinsics(self.configs[:k])
        ego = np.array([c.ego_radius for c in self.configs[:k]], np.float32)
        fx, fv = self._jit_fuse(
            jnp.asarray(xyz), jnp.asarray(valid), jnp.asarray(ext), jnp.asarray(ego)
        )
        return PointCloud(fx, fv)
