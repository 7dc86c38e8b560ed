"""Pure-JAX point-cloud ops — the golden, jit-able op kit.

This mirrors, 1:1, the reference's accelerated op inventory
(cuda/cuda_wrapper.cu:13-111 kernels + cuda/cuda_interface.cu:537-654
dispatch + src/point_cloud_processor.cpp utilities), re-designed as array
programs:

* masks instead of compaction (fixed shapes; no dynamic-size outputs),
* SoA ``(N, 3)`` arrays resident on device — no per-op host staging,
* everything composes under ``jit`` / ``vmap`` / ``pjit`` and fuses in XLA.

tools/parity_bench.py times them against host NumPy (the reference's
test_cuda.cpp CPU-vs-GPU pattern, src/test_cuda.cpp:39-56).
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp

__all__ = [
    "finite_mask",
    "rotate_2d",
    "transform_4x4",
    "distance_2d",
    "polar_angle",
    "radius_mask",
    "ego_mask",
    "height_band_mask",
    "distance_band_mask",
    "plane_distances",
]


def finite_mask(xyz: jax.Array) -> jax.Array:
    """True where all three coordinates are finite.

    Reference: RecursivePatchwork::cleanPoints (src/recursive_patchwork.cpp:19-35)
    and PointCloudProcessor::removeNaNPoints (src/point_cloud_processor.cpp:16-27),
    which compact; here we mask.
    """
    return jnp.all(jnp.isfinite(xyz), axis=-1)


def rotate_2d(xyz: jax.Array, angle_degrees) -> jax.Array:
    """Rotate points about +Z by ``angle_degrees``; Z unchanged.

    Reference: rotatePointsKernel (cuda/cuda_wrapper.cu:13-23) /
    LidarFusion::applyRotation2D (src/lidar_fusion.cpp:109-126).
    """
    angle = jnp.asarray(angle_degrees, jnp.float32) * (math.pi / 180.0)
    c, s = jnp.cos(angle), jnp.sin(angle)
    x, y, z = xyz[..., 0], xyz[..., 1], xyz[..., 2]
    return jnp.stack([x * c - y * s, x * s + y * c, z], axis=-1)


def transform_4x4(xyz: jax.Array, matrix: jax.Array) -> jax.Array:
    """Apply a homogeneous 4x4 transform with perspective divide.

    Reference: transformPointsKernel (cuda/cuda_wrapper.cu:26-45) /
    LidarFusion::applyTransform (src/lidar_fusion.cpp:128-146).
    Batched over leading dims of ``xyz``; ``matrix`` may carry its own
    leading batch dims (e.g. (S, 4, 4) stacked extrinsics for fusion).
    """
    matrix = jnp.asarray(matrix, jnp.float32)
    hom = jnp.concatenate([xyz, jnp.ones_like(xyz[..., :1])], axis=-1)
    out = jnp.einsum("...ij,...nj->...ni", matrix, hom, precision="highest")
    return out[..., :3] / out[..., 3:4]


def distance_2d(xyz: jax.Array) -> jax.Array:
    """sqrt(x^2 + y^2). Reference: computeDistances2DKernel (cuda_wrapper.cu:48-55)."""
    x, y = xyz[..., 0], xyz[..., 1]
    return jnp.sqrt(x * x + y * y)


def polar_angle(xyz: jax.Array) -> jax.Array:
    """atan2(y, x) wrapped to [0, 2*pi).

    Reference: computeAnglesKernel (cuda/cuda_wrapper.cu:67-74) — note the
    wrap is ``if (angle < 0) angle += 2*pi`` which maps -0.0 to 2*pi; we
    reproduce the same wrap (strictly-negative test) for parity.
    """
    a = jnp.arctan2(xyz[..., 1], xyz[..., 0])
    return jnp.where(a < 0, a + jnp.float32(2.0 * math.pi), a)


def radius_mask(distances: jax.Array, radius) -> jax.Array:
    """d <= radius. Reference: filterPointsByRadiusKernel (cuda_wrapper.cu:58-64)."""
    return distances <= jnp.asarray(radius, jnp.float32)


def ego_mask(xyz: jax.Array, radius) -> jax.Array:
    """True for points to KEEP (outside the ego radius): d > radius.

    Reference: RecursivePatchwork::removeEgoVehicle (cpp:64-75, strict >)
    and LidarFusion::isPointInEgoRadius (src/lidar_fusion.cpp:184-187,
    keeps d > radius).
    """
    return distance_2d(xyz) > jnp.asarray(radius, jnp.float32)


def height_band_mask(xyz: jax.Array, min_height, max_height) -> jax.Array:
    """min <= z <= max. Reference: filterByHeight (point_cloud_processor.cpp:44-56)."""
    z = xyz[..., 2]
    return (z >= jnp.asarray(min_height, jnp.float32)) & (
        z <= jnp.asarray(max_height, jnp.float32)
    )


def distance_band_mask(xyz: jax.Array, min_dist, max_dist) -> jax.Array:
    """min <= d2 <= max. Reference: filterByDistance (point_cloud_processor.cpp:29-42)."""
    d = distance_2d(xyz)
    return (d >= jnp.asarray(min_dist, jnp.float32)) & (
        d <= jnp.asarray(max_dist, jnp.float32)
    )


def plane_distances(xyz: jax.Array, centroid: jax.Array, normal: jax.Array) -> jax.Array:
    """|(p - c) . n| per point.

    Reference: computePlaneDistancesKernel (cuda/cuda_wrapper.cu:89-102) /
    PointCloudProcessor::computePointToPlaneDistance (cpp:102-107).
    ``centroid``/``normal`` broadcast against leading dims of ``xyz``.
    """
    d = xyz - centroid[..., None, :]
    return jnp.abs(jnp.einsum("...ni,...i->...n", d, normal, precision="highest"))
