"""BEV (bird's-eye-view) rasterization as device-side scatter ops.

Reference: src/visualization.cpp renders with per-point OpenCV writes on
the host (createBEVImage :18-47, createGroundNonGroundImage :49-81,
createEnhancedFilteredImage :83-113).  Here rasterization is a jit-able
scatter onto an ``(H, W, 3)`` uint8 canvas — it composes with the engine
on device, and only the finished image crosses to the host for PNG
encoding (stdlib zlib + struct, :func:`save_png`).

Color parity (the reference stores OpenCV BGR; we emit the same on-disk
RGB): height image pixel = (255, i, i) with i = clip((z+2)*50, 0, 255);
ground overlay green (0,255,0), non-ground red (255,0,0); enhanced =
(clip((z+1)*100), 127, clip((z+2)*50)).

Determinism note: the reference's last-point-wins overwrite order is
nondeterministic under parallel scatter, so per-class images use
max-reduction per pixel (deterministic); the ground/non-ground overlay
preserves the reference's class precedence (non-ground drawn over ground,
visualization.cpp:60-78) by scattering classes in order.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np
import jax.numpy as jnp

__all__ = [
    "bev_height_image",
    "bev_ground_nonground_image",
    "bev_enhanced_image",
    "encode_png",
    "save_png",
]

GROUND_RGB = (0, 255, 0)
NON_GROUND_RGB = (255, 0, 0)


def _pixel_coords(xyz, mask, width, height, x_min, y_min, x_max, y_max):
    """World -> integer pixel coords + in-bounds mask (visualization.cpp:29-38)."""
    x_scale = jnp.float32(width) / (x_max - x_min)
    y_scale = jnp.float32(height) / (y_max - y_min)
    xi = ((xyz[:, 0] - x_min) * x_scale).astype(jnp.int32)
    yi = ((xyz[:, 1] - y_min) * y_scale).astype(jnp.int32)
    ok = mask & (xi >= 0) & (xi < width) & (yi >= 0) & (yi < height)
    return xi, yi, ok


def _scatter_max(image, yi, xi, ok, colors):
    """Scatter colors with per-channel max; out-of-bounds rows dropped."""
    yi = jnp.where(ok, yi, -1)  # out-of-range -> dropped by scatter
    xi = jnp.where(ok, xi, -1)
    colors = jnp.where(ok[:, None], colors, 0)
    return image.at[yi, xi, :].max(colors, mode="drop")


def bev_height_image(
    xyz, mask, width=300, height=150, x_min=-150.0, y_min=-75.0, x_max=150.0, y_max=75.0
):
    """Height-colored BEV (createBEVImage, visualization.cpp:18-47)."""
    xi, yi, ok = _pixel_coords(xyz, mask, width, height, x_min, y_min, x_max, y_max)
    inten = jnp.clip((xyz[:, 2] + 2.0) * 50.0, 0.0, 255.0).astype(jnp.uint8)
    colors = jnp.stack([jnp.full_like(inten, 255), inten, inten], axis=1)
    img = jnp.zeros((height, width, 3), jnp.uint8)
    return _scatter_max(img, yi, xi, ok, colors)


def bev_ground_nonground_image(
    xyz, ground, non_ground,
    width=300, height=150, x_min=-150.0, y_min=-75.0, x_max=150.0, y_max=75.0,
):
    """Green/red class overlay (createGroundNonGroundImage, :49-81);
    non-ground takes precedence (drawn second in the reference)."""
    xi, yi, okg = _pixel_coords(xyz, ground, width, height, x_min, y_min, x_max, y_max)
    img = jnp.zeros((height, width, 3), jnp.uint8)
    gcol = jnp.broadcast_to(jnp.array(GROUND_RGB, jnp.uint8), (xyz.shape[0], 3))
    img = _scatter_max(img, yi, xi, okg, gcol)
    xi, yi, okn = _pixel_coords(
        xyz, non_ground, width, height, x_min, y_min, x_max, y_max
    )
    ncol = jnp.broadcast_to(jnp.array(NON_GROUND_RGB, jnp.uint8), (xyz.shape[0], 3))
    # overwrite (set) so red wins over green wherever both classes land
    yi = jnp.where(okn, yi, -1)
    xi = jnp.where(okn, xi, -1)
    return img.at[yi, xi, :].set(
        jnp.where(okn[:, None], ncol, 0), mode="drop"
    )


def bev_enhanced_image(
    xyz, mask, width=300, height=150, x_min=-150.0, y_min=-75.0, x_max=150.0, y_max=75.0
):
    """Enhanced height-RGB image (createEnhancedFilteredImage, :83-113)."""
    xi, yi, ok = _pixel_coords(xyz, mask, width, height, x_min, y_min, x_max, y_max)
    z = xyz[:, 2]
    red = jnp.clip((z + 1.0) * 100.0, 0.0, 255.0).astype(jnp.uint8)
    green = jnp.full_like(red, 127)
    blue = jnp.clip((z + 2.0) * 50.0, 0.0, 255.0).astype(jnp.uint8)
    colors = jnp.stack([red, green, blue], axis=1)
    img = jnp.zeros((height, width, 3), jnp.uint8)
    return _scatter_max(img, yi, xi, ok, colors)


def encode_png(image) -> bytes:
    """(H, W, 3) uint8 RGB array -> PNG file bytes (8-bit truecolor)."""
    img = np.ascontiguousarray(np.asarray(image, np.uint8))
    if img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"expected (H, W, 3) uint8, got {img.shape}")
    h, w, _ = img.shape

    def chunk(tag: bytes, data: bytes) -> bytes:
        body = tag + data
        return (struct.pack(">I", len(data)) + body
                + struct.pack(">I", zlib.crc32(body) & 0xFFFFFFFF))

    # every scanline prefixed with filter type 0 (None)
    raw = np.concatenate(
        [np.zeros((h, 1), np.uint8), img.reshape(h, w * 3)], axis=1)
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
            + chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
            + chunk(b"IEND", b""))


def save_png(image, filename: str) -> None:
    """Write an (H, W, 3) uint8 RGB array to a PNG file."""
    with open(filename, "wb") as f:
        f.write(encode_png(image))
