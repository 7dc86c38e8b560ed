"""Supported platforms and device introspection — the CudaManager analogue.

The reference's CudaManager (include/cuda_interface.hpp:12-56,
cuda/cuda_interface.cu:44-95) lazily initializes device 0 and lets every
op silently fall back to CPU.  Here the opposite holds: the program runs
on the platforms in :data:`PLATFORMS` — ``cpu`` (tests, host runs) and
``gpu`` (NVIDIA H100, the accelerator) — and any other default backend is
an error (:func:`check_platform`); it never becomes the CPU branch.  Both
platforms take the same code paths: the engine's segment-op impl is
``segment/segops.DEFAULT_IMPL`` and BA's segment sums
``slam/ba.SEG_SUM_IMPL`` on each.
"""

from __future__ import annotations

import os
from typing import Dict, List

import jax

__all__ = ["PLATFORMS", "UnsupportedPlatformError", "check_platform",
           "require_gpu", "accelerator_available", "device_info",
           "initialize", "cleanup", "enable_compilation_cache",
           "DEFAULT_CACHE_DIR"]

PLATFORMS = ("cpu", "gpu")


class UnsupportedPlatformError(RuntimeError):
    """The default JAX backend is not a platform in :data:`PLATFORMS`."""


def check_platform(platform: str | None = None) -> str:
    """``platform`` (default: JAX's default backend), if supported."""
    name = platform or jax.default_backend()
    if name not in PLATFORMS:
        raise UnsupportedPlatformError(
            f"platform {name!r} is not supported; supported platforms: "
            f"{list(PLATFORMS)}")
    return name


def require_gpu() -> jax.Device:
    """First GPU device, or UnsupportedPlatformError naming what was found.

    For measurement paths (bench.py, chip_smoke.py): a number taken on the
    CPU must never be reported as a device number.
    """
    try:
        backend = jax.default_backend()
    except RuntimeError as e:
        raise UnsupportedPlatformError(f"no GPU found: {e}") from None
    if backend != "gpu":
        raise UnsupportedPlatformError(
            f"no GPU found: JAX's default backend is {backend!r} "
            f"({jax.devices()[0].device_kind})")
    return jax.devices()[0]


# Fixed, gitignored directory in the checkout: the cache key includes the
# path, so a directory that moves between runs never hits.
DEFAULT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache")


def enable_compilation_cache() -> str:
    """Enable JAX's persistent compilation cache; returns its directory.

    ``JAX_COMPILATION_CACHE_DIR`` wins when set, and no other directory is
    set in code then.  Otherwise the cache lives in
    :data:`DEFAULT_CACHE_DIR`.  Entry points (cli, bench, tools) call this
    before building jit functions: every invocation is a fresh process.
    """
    path = os.environ.get("JAX_COMPILATION_CACHE_DIR") or DEFAULT_CACHE_DIR
    os.makedirs(path, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", path)
    return path


def accelerator_available() -> bool:
    """True when the default backend is the GPU (CudaManager::isAvailable)."""
    try:
        return jax.default_backend() == "gpu"
    except RuntimeError:
        return False


def initialize() -> bool:
    """Force backend initialization; returns availability.

    (CudaManager::initialize, cuda_interface.cu:61-88 — JAX initializes
    lazily on first use; this just triggers it eagerly.)
    """
    try:
        jax.devices()
        return accelerator_available()
    except RuntimeError:
        return False


def cleanup() -> None:
    """Release cached backend clients (CudaManager::cleanup)."""
    jax.clear_caches()


def device_info() -> List[Dict[str, str]]:
    """One record per visible device."""
    return [
        {
            "id": str(d.id),
            "platform": d.platform,
            "kind": d.device_kind,
            "process": str(d.process_index),
        }
        for d in jax.devices()
    ]
