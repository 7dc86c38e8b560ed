"""Pure-JAX op kit (golden, jit-able): the reference's accelerated op
inventory re-designed as fixed-shape array ops (see pointcloud.py /
geometry.py / sampling.py)."""

from .geometry import (
    eigh3x3,
    eigvals3x3,
    fit_plane_masked,
    masked_centroid,
    masked_covariance,
    smallest_eigenvector3x3,
)
from .pointcloud import (
    distance_2d,
    distance_band_mask,
    ego_mask,
    finite_mask,
    height_band_mask,
    plane_distances,
    polar_angle,
    radius_mask,
    rotate_2d,
    transform_4x4,
)
from .sampling import random_subsample_mask, voxel_grid_filter
