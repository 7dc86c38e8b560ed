"""Explicit-collective engine: single-level Patchwork under shard_map.

The main engine relies on GSPMD to partition its segment ops (sharded.py).
This module is the hand-written alternative for the single-level
('patchwork' variant) pipeline: points shard over the mesh's ``sp`` axis,
every per-node statistic is computed as a LOCAL partial on each device and
combined with explicit collectives — ``psum`` for sums/counts/moments,
``pmin``/``pmax`` for bounding boxes and the lexicographic seed fallback —
so the collective traffic is exactly the (num_nodes, channels) block per
reduction step and nothing else.

Restrictions (asserted): effective_levels == 1 (no split machinery — the
recursive path needs per-level segment sorts, which GSPMD handles in the
main engine) and adaptive seeds (no percentile sort).

Differentially tested against the GSPMD engine: masks bit-identical on
the virtual 8-device CPU mesh (tests/test_shardmap.py).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from ..core.config import PatchworkConfig
from ..segment.binning import ring_edges, sector_edges
from ..segment.engine import _cov_normal
from ..ops.pointcloud import distance_2d, finite_mask, polar_angle
from .mesh import DATA_AXIS, POINT_AXIS

__all__ = ["make_shardmap_patchwork"]

_F32 = jnp.float32


def _local_seg_sum(data, seg, num_segs):
    """Local partial segment sum via one-hot matmul (data (n, C))."""
    oh = (seg[:, None] == jnp.arange(num_segs, dtype=jnp.int32)[None, :]).astype(
        jnp.bfloat16
    )
    return jnp.einsum("ns,nc->sc", oh, data, precision="highest",
                      preferred_element_type=jnp.float32)


def _gather(table, seg):
    oh = (seg[:, None] == jnp.arange(table.shape[0], dtype=jnp.int32)[None, :]
          ).astype(jnp.bfloat16)
    return jnp.einsum("ns,sc->nc", oh, table, precision="highest",
                      preferred_element_type=jnp.float32)


def make_shardmap_patchwork(cfg: PatchworkConfig, mesh, idx_offset_fn=None):
    """fn(xyz (B, N, 3), valid (B, N)) -> ground (B, N) bool.

    B shards over 'dp', N over 'sp'.  N must divide by the sp axis size.
    """
    if cfg.effective_levels != 1:
        raise ValueError("shard_map engine supports single-level configs only "
                         "(use PatchworkConfig.patchwork())")
    if not cfg.adaptive_seed_height:
        raise ValueError("shard_map engine supports adaptive seeds only")

    num_p = cfg.num_patches
    num_segs = num_p + 1
    trash = num_p
    r_edges = jnp.asarray(ring_edges(cfg))
    s_edges = jnp.asarray(sector_edges(cfg))
    axis = POINT_AXIS

    def one_scan(xyz, valid, shard_start):
        """xyz (n, 3) local shard; shard_start = global index of row 0."""
        fin = valid & finite_mask(xyz)
        # Zero non-finite coords before any one-hot matmul (0 * NaN = NaN
        # would poison every segment column); they are masked out by `fin`.
        xyz = jnp.where(fin[:, None], xyz, 0.0)
        x, y, z = xyz[:, 0], xyz[:, 1], xyz[:, 2]
        d = distance_2d(xyz)
        ang = polar_angle(xyz)
        in_zone = fin & (d <= _F32(cfg.filtering_radius))

        ring = jnp.sum(d[:, None] >= r_edges[None, 1:-1], axis=1).astype(jnp.int32)
        in_ring = (d >= r_edges[0]) & (d < r_edges[-1])
        sector = jnp.sum(ang[:, None] >= s_edges[None, 1:-1], axis=1).astype(jnp.int32)
        in_sector = ang < s_edges[-1]
        in_patch = in_zone & in_ring & in_sector
        seg = jnp.where(in_patch, ring * cfg.num_sectors + sector, trash)

        w = in_patch.astype(_F32)
        # per-patch mean distance: local partials + psum over the point axis
        md = jax.lax.psum(
            _local_seg_sum(jnp.stack([d * w, w], axis=1), seg, num_segs), axis
        )
        rel = (md[:, 0] / jnp.maximum(md[:, 1], 1.0)) / _F32(cfg.filtering_radius)
        tau_node = _F32(cfg.th_dist) * (1.0 + _F32(cfg.tau_slope) * rel)
        zth_node = _F32(cfg.sensor_height) + _F32(cfg.seed_slope) * rel

        tg = _gather(jnp.stack([zth_node, tau_node], axis=1), seg)
        zth_pt, tau_pt = tg[:, 0], tg[:, 1]
        active = in_patch
        seed = active & (z < zth_pt)
        cnts = jax.lax.psum(
            _local_seg_sum(
                jnp.stack([active.astype(_F32), seed.astype(_F32)], axis=1),
                seg, num_segs,
            ),
            axis,
        )
        cnt, seed_cnt = cnts[:, 0], cnts[:, 1]

        # bbox: local masked minmax + pmin/pmax collectives
        big = _F32(jnp.inf)
        sel = (seg[:, None] == jnp.arange(num_segs)[None, :]) & active[:, None]
        mins = jax.lax.pmin(
            jnp.min(jnp.where(sel[:, :, None], xyz[:, None, :], big), axis=0),
            axis,
        )  # (S, 3)
        maxs = jax.lax.pmax(
            jnp.max(jnp.where(sel[:, :, None], xyz[:, None, :], -big), axis=0),
            axis,
        )

        node_ids = jnp.arange(num_segs, dtype=jnp.int32)
        real = node_ids < trash
        too_small = cnt < 3.0
        flat_z = ((maxs[:, 2] - mins[:, 2]) < _F32(cfg.flat_dz)) & (
            cnt > cfg.flat_min_points
        )
        flat_z = flat_z & ~too_small  # no area early-out at depth 0 (cpp:127)
        finished = real & (too_small | flat_z)
        fit_node = real & ~finished
        deficient = fit_node & (seed_cnt < cfg.min_seed_points)

        t1 = _gather(
            jnp.stack([finished.astype(_F32), flat_z.astype(_F32),
                       fit_node.astype(_F32), deficient.astype(_F32)], axis=1),
            seg,
        )
        finished_pt = t1[:, 0] > 0.5
        label_pt = t1[:, 1] > 0.5
        fit_pt = t1[:, 2] > 0.5
        deficient_pt = t1[:, 3] > 0.5

        # 3-lowest-z fallback: (z, global index) lexicographic pmin rounds
        any_def = jnp.any(deficient)
        idx_f = shard_start + jnp.arange(z.shape[0], dtype=_F32)
        sentinel = _F32(3.0e38)

        def low_cond(st):
            return (st[1] < cfg.min_seed_points) & any_def

        def low_body(st):
            chosen, r = st
            cand = active & deficient_pt & ~chosen
            zc = jnp.where(cand[:, None] & sel, z[:, None], big)
            m = jax.lax.pmin(jnp.min(zc, axis=0), axis)  # (S,)
            m_pt = _gather(jnp.where(jnp.isfinite(m), m, sentinel)[:, None], seg)[:, 0]
            is_min = cand & (z == m_pt)
            ic = jnp.where(is_min[:, None] & sel, idx_f[:, None], big)
            mi = jax.lax.pmin(jnp.min(ic, axis=0), axis)
            mi_pt = _gather(jnp.where(jnp.isfinite(mi), mi, sentinel)[:, None], seg)[:, 0]
            pick = is_min & (idx_f == mi_pt)
            return chosen | pick, r + 1

        low3, _ = jax.lax.while_loop(
            low_cond, low_body, (jnp.zeros_like(seed), jnp.int32(0))
        )
        seed = jnp.where(deficient_pt, low3, seed) & active

        ground = jnp.where(active & fit_pt, seed, ground_init(z))
        ground = jnp.where(active & finished_pt, label_pt, ground)

        # iterative fit: local moment partials + psum; plane math replicated
        def cond(st):
            return (st[2] < cfg.max_iter) & st[1]

        def body(st):
            g_mask, _, it = st
            g = (g_mask & active).astype(_F32)
            m1 = jax.lax.psum(
                _local_seg_sum(
                    jnp.concatenate([g[:, None], xyz * g[:, None]], axis=1),
                    seg, num_segs,
                ),
                axis,
            )
            gcnt = m1[:, 0]
            centroid = m1[:, 1:4] / jnp.maximum(gcnt, 1.0)[:, None]
            c_pt = _gather(centroid, seg)
            d_all = xyz - c_pt
            dd = d_all * g[:, None]
            dx, dy, dz = dd[:, 0], dd[:, 1], dd[:, 2]
            m2 = jax.lax.psum(
                _local_seg_sum(
                    jnp.stack([dx * dx, dx * dy, dx * dz,
                               dy * dy, dy * dz, dz * dz], axis=1),
                    seg, num_segs,
                ),
                axis,
            )
            normal = _cov_normal(m2, gcnt)
            n_pt = _gather(normal, seg)
            dist = jnp.abs(jnp.einsum("ni,ni->n", d_all, n_pt,
                                      precision="highest"))
            can_pt = _gather((gcnt >= 3.0).astype(_F32)[:, None], seg)[:, 0] > 0.5
            new_g = dist < tau_pt
            apply_pt = active & fit_pt & can_pt
            changed = apply_pt & (new_g != g_mask)
            any_changed = jax.lax.psum(
                jnp.sum(changed.astype(jnp.int32)), axis
            ) > 0
            return jnp.where(apply_pt, new_g, g_mask), any_changed, it + 1

        ground, _, _ = jax.lax.while_loop(
            cond, body, (ground, jnp.bool_(True), jnp.int32(0))
        )
        return ground & in_patch

    def ground_init(z):
        return jnp.zeros(z.shape, bool)

    def shard_fn(xyz, valid):
        # xyz: (B/dp, N/sp, 3) local block
        sp_idx = jax.lax.axis_index(POINT_AXIS)
        n_local = xyz.shape[1]
        start = (sp_idx * n_local).astype(_F32)
        return jax.vmap(lambda p, v: one_scan(p, v, start))(xyz, valid)

    smapped = jax.shard_map(
        shard_fn,
        mesh=mesh,
        in_specs=(P(DATA_AXIS, POINT_AXIS, None), P(DATA_AXIS, POINT_AXIS)),
        out_specs=P(DATA_AXIS, POINT_AXIS),
        check_vma=False,
    )
    return jax.jit(smapped)
