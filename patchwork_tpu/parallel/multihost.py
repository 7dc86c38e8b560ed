"""Multi-host SPMD process-group setup.

The reference's only "distribution" is ROS2/DDS pub-sub between OS
processes (SURVEY.md §2); here the model is one JAX process per host,
all hosts executing the same program over a global mesh, with XLA
inserting the collectives between them.

Call :func:`initialize_multihost` once at startup on every host (it no-ops
in single-process settings), then build meshes with
``patchwork_tpu.parallel.mesh.make_mesh`` over ``jax.devices()`` — which,
after initialization, spans ALL hosts' devices.

This module is exercised in CI only in its single-process no-op form (no
multi-host hardware in the dev environment); the code path follows the
standard jax.distributed contract.
"""

from __future__ import annotations

import os
from typing import Optional

import jax

__all__ = ["initialize_multihost", "is_multihost", "host_summary"]


def initialize_multihost(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> bool:
    """Join the jax.distributed process group.

    With no arguments, reads the standard env vars
    (JAX_COORDINATOR_ADDRESS / JAX_NUM_PROCESSES / JAX_PROCESS_ID) or the
    cluster-autodetect path; returns False (no-op) when neither is
    configured — single-host runs need no setup.
    """
    coordinator_address = coordinator_address or os.environ.get(
        "JAX_COORDINATOR_ADDRESS"
    )
    if num_processes is None and os.environ.get("JAX_NUM_PROCESSES"):
        num_processes = int(os.environ["JAX_NUM_PROCESSES"])
    if process_id is None and os.environ.get("JAX_PROCESS_ID"):
        process_id = int(os.environ["JAX_PROCESS_ID"])

    if coordinator_address is None and num_processes is None:
        return False
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )
    return True


def is_multihost() -> bool:
    return jax.process_count() > 1


def host_summary() -> str:
    return (
        f"process {jax.process_index()}/{jax.process_count()}: "
        f"{jax.local_device_count()} local / {jax.device_count()} global devices"
    )
