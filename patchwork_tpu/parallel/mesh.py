"""Device mesh construction for multi-device execution.

The reference has no multi-device compute at all (single cudaSetDevice(0),
cuda/cuda_interface.cu:68; its "distribution" is ROS2 pub-sub between OS
processes).  Here the scaling model is SPMD over a ``jax.sharding.Mesh``:
scans batch-shard over the ``dp`` axis, and points within a scan shard
over the ``sp`` axis; XLA inserts the collectives (psum/all-gather, NCCL
on GPUs).  The cards of one host are joined all to all, so the mesh shape
follows the algorithm alone.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

__all__ = ["make_mesh", "scan_batch_sharding", "replicated", "P"]

DATA_AXIS = "dp"
POINT_AXIS = "sp"


def make_mesh(
    n_devices: Optional[int] = None,
    dp: Optional[int] = None,
    sp: int = 1,
    devices: Optional[Sequence] = None,
) -> Mesh:
    """Build a (dp, sp) mesh over the first n_devices devices.

    With only ``n_devices`` given, all devices go to the data axis.
    """
    if devices is None:
        devices = jax.devices()
    if n_devices is None:
        n_devices = len(devices)
    devices = list(devices)[:n_devices]
    if dp is None:
        dp = n_devices // sp
    if dp * sp != n_devices:
        raise ValueError(f"dp*sp = {dp}*{sp} != n_devices {n_devices}")
    arr = np.array(devices).reshape(dp, sp)
    return Mesh(arr, (DATA_AXIS, POINT_AXIS))


def scan_batch_sharding(mesh: Mesh, shard_points: bool = True):
    """(xyz, valid) shardings for a (B, N, 3)/(B, N) scan batch."""
    pt = POINT_AXIS if shard_points else None
    return (
        NamedSharding(mesh, P(DATA_AXIS, pt, None)),
        NamedSharding(mesh, P(DATA_AXIS, pt)),
    )


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())
