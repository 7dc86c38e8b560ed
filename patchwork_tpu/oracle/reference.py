"""NumPy oracle: a faithful, recursive re-statement of the reference
algorithm's semantics (src/recursive_patchwork.cpp), used ONLY as the
differential-test golden path for the array engine.

This adopts the reference's own test strategy — a trusted slow path vs the
accelerated path on identical inputs (src/test_cuda.cpp:39-56) — with this
module playing the "CPU reference" role.

Deliberate deviation (documented per SURVEY.md §7): the reference's
split-combine writes child labels in left-then-right order instead of the
original patch order (src/recursive_patchwork.cpp:290-302), permuting labels
whenever a patch splits.  This oracle performs the *correct*
order-preserving combine; the engine matches the oracle.  On
configurations where no split triggers, oracle and reference are
semantically identical.

Everything is float32, mirroring the reference's float pipeline.
"""

from __future__ import annotations

import numpy as np

from ..core.config import PatchworkConfig

__all__ = [
    "clean_mask",
    "fit_plane_pca",
    "fit_plane_and_split",
    "filter_ground_oracle",
]


def clean_mask(points: np.ndarray) -> np.ndarray:
    """Finite-coordinate mask (cpp:19-35)."""
    return np.isfinite(points).all(axis=1)


def fit_plane_pca(points: np.ndarray):
    """PCA plane fit (cpp:77-107): returns (centroid, normal, residual)."""
    if len(points) < 3:
        return (
            np.zeros(3, np.float32),
            np.array([0, 0, 1], np.float32),
            np.float32(np.inf),
        )
    centroid = points.mean(axis=0, dtype=np.float64).astype(np.float32)
    d = points - centroid
    cov = (d.astype(np.float64).T @ d.astype(np.float64)) / (len(points) - 1)
    _, vecs = np.linalg.eigh(cov)
    normal = vecs[:, 0].astype(np.float32)  # smallest eigenvalue
    if normal[2] < 0:
        normal = -normal
    resid = np.float32(np.abs(d @ normal).mean(dtype=np.float64))
    return centroid, normal, resid


def fit_plane_and_split(
    patch_points: np.ndarray, mean_dist: float, depth: int, cfg: PatchworkConfig
) -> np.ndarray:
    """Recursive seeded iterative plane fit + variance-axis median split
    (cpp:109-308).  Returns a bool ground mask in ORIGINAL patch order."""
    n = len(patch_points)
    if n < 3 or depth > cfg.max_split_depth:
        return np.zeros(n, bool)

    x, y, z = patch_points[:, 0], patch_points[:, 1], patch_points[:, 2]

    # Minimum-area early-out (cpp:116-129).
    area = (x.max() - x.min()) * (y.max() - y.min())
    if area < cfg.flat_area_m2 and depth > 0:
        return np.ones(n, bool)

    # Flatness early-out (cpp:132-140).
    if (z.max() - z.min()) < cfg.flat_dz and n > cfg.flat_min_points:
        return np.ones(n, bool)

    # Seed selection (cpp:143-182).
    rel_dist = np.float32(mean_dist) / np.float32(cfg.filtering_radius)
    if cfg.adaptive_seed_height:
        z_th = np.float32(cfg.sensor_height) + np.float32(cfg.seed_slope) * rel_dist
    else:
        sorted_z = np.sort(z)
        idx = int(cfg.seed_percentile * len(sorted_z))
        z_th = sorted_z[idx] + np.float32(cfg.th_seeds)

    seed_mask = z < z_th
    if seed_mask.sum() < cfg.min_seed_points:
        lowest = np.argsort(z, kind="stable")[: cfg.min_seed_points]
        seed_mask = np.zeros(n, bool)
        seed_mask[lowest] = True

    # Iterative plane fitting (cpp:186-217).
    ground_mask = seed_mask.copy()
    threshold = np.float32(cfg.th_dist) * (
        np.float32(1.0) + np.float32(cfg.tau_slope) * rel_dist
    )
    for _ in range(cfg.max_iter):
        ground_points = patch_points[ground_mask]
        if len(ground_points) < 3:
            break
        centroid, normal, _ = fit_plane_pca(ground_points)
        dists = np.abs((patch_points - centroid) @ normal)
        new_mask = dists < threshold
        if np.array_equal(new_mask, ground_mask):
            break
        ground_mask = new_mask

    # Final fit + split decision (cpp:219-235).
    _, _, residual = fit_plane_pca(patch_points[ground_mask])
    split_threshold = np.float32(cfg.th_dist) * (
        np.float32(1.0) + np.float32(cfg.split_residual_slope) * depth
    )
    min_patch_size = cfg.split_min_points_base + cfg.split_min_points_slope * depth

    if (
        residual > split_threshold
        and depth < cfg.max_split_depth
        and n >= min_patch_size
    ):
        # Variance-axis median split (cpp:237-283): population variance
        # about the full-patch centroid, median = sorted[n // 2].
        centroid = patch_points.mean(axis=0, dtype=np.float64).astype(np.float32)
        var_x = np.mean((x - centroid[0]) ** 2, dtype=np.float64)
        var_y = np.mean((y - centroid[1]) ** 2, dtype=np.float64)
        vals = x if var_x > var_y else y
        median_val = np.sort(vals)[len(vals) // 2]

        left_sel = vals <= median_val
        left_res = fit_plane_and_split(patch_points[left_sel], mean_dist, depth + 1, cfg)
        right_res = fit_plane_and_split(
            patch_points[~left_sel], mean_dist, depth + 1, cfg
        )
        # Order-preserving combine (deviation from cpp:290-302 — see module doc).
        result = np.zeros(n, bool)
        result[left_sel] = left_res
        result[~left_sel] = right_res
        return result

    return ground_mask


def filter_ground_oracle(points: np.ndarray, cfg: PatchworkConfig):
    """End-to-end polar-grid segmentation (cpp:310-426).

    ``points``: (N, 3) float32.  Returns (ground, valid, in_zone, in_patch)
    boolean masks over the input rows — mask form of the reference's
    (ground_points, non_ground_points) compaction: ground points are
    ``ground``, non-ground points are ``valid & ~ground``.
    """
    points = np.asarray(points, np.float32)
    n = len(points)
    valid = clean_mask(points)
    ground = np.zeros(n, bool)
    in_zone = np.zeros(n, bool)
    in_patch = np.zeros(n, bool)
    if valid.sum() == 0:
        return ground, valid, in_zone, in_patch

    d = np.sqrt(points[:, 0] ** 2 + points[:, 1] ** 2).astype(np.float32)
    in_zone = valid & (d <= np.float32(cfg.filtering_radius))
    if in_zone.sum() < 3:
        return ground, valid, in_zone, in_patch

    # Ring/sector edges shared with the engine's binning (single source of
    # truth, segment/binning.py — the same f32 expressions as cpp:344-352).
    from ..segment.binning import ring_edges, sector_edges

    edges = ring_edges(cfg)
    s_edges = sector_edges(cfg)

    # atan2 via the same math library as the engine (XLA): libm vs XLA
    # differ by 1 ulp on some inputs, which would flip sector membership
    # for points exactly on a sector edge.  The oracle defines the
    # ALGORITHM's semantics, not a particular atan2 rounding.
    import jax.numpy as jnp

    ang = np.asarray(jnp.arctan2(jnp.asarray(points[:, 1]),
                                 jnp.asarray(points[:, 0])))
    ang = np.where(ang < 0, ang + np.float32(2.0 * np.pi), ang)

    for ring in range(cfg.num_rings):
        r0, r1 = edges[ring], edges[ring + 1]
        for sector in range(cfg.num_sectors):
            a0 = s_edges[sector]
            a1 = s_edges[sector + 1]
            sel = in_zone & (d >= r0) & (d < r1) & (ang >= a0) & (ang < a1)
            idxs = np.nonzero(sel)[0]
            if len(idxs) == 0:
                continue
            in_patch[idxs] = True
            mean_dist = np.float32(d[idxs].mean(dtype=np.float64))
            mask = fit_plane_and_split(points[idxs], mean_dist, 0, cfg)
            ground[idxs[mask]] = True

    return ground, valid, in_zone, in_patch
