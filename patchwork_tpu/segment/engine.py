"""The Recursive Patchwork engine as one fixed-shape array program.

The reference algorithm (src/recursive_patchwork.cpp:109-426) is a
host-side loop nest: for each of rings*sectors patches, gather the patch's
points (O(rings*sectors*N) rescans), run a data-dependent iterative PCA
plane fit, and recurse into median splits of unbounded depth — with a GPU
round-trip per plane-distance evaluation (cpp:206).

Here the same semantics are re-stated as a fixed-shape SPMD program:

* every point carries a *node id*; the recursion is flattened into
  ``max_levels`` batched levels.  Node ids are COMPACT: level 0 uses the
  num_patches patch ids; deeper levels renumber the (rare) split children
  into a fixed pool of ``max_active_nodes`` slots, so the segment count —
  and with it the cost of every segment op — stays bounded instead of
  doubling per level;
* per-node statistics (counts, bounding boxes, seeds, plane moments,
  medians) are segment reductions / segment sorts over the whole cloud
  (segops.SegOps; default impl segops.DEFAULT_IMPL);
* the <= max_iter re-fit loop runs as ONE ``lax.while_loop`` over the
  whole level.  There is no per-node freeze bookkeeping: converged nodes
  re-fit idempotently (same mask -> same plane -> same mask), nodes whose
  ground support drops below 3 points stop updating by construction
  (their mask never changes again), and the loop exits when no node
  changed — exactly the reference's per-patch break conditions
  (cpp:196,215) without the control flow;
* ALL split machinery (variance axis, per-node median sort, child slot
  assignment) lives INSIDE the deeper-level while_loop, which exits as
  soon as no node split: a scan with no recursion pays for level 0's
  fit only — the data-dependent skipping the reference gets from plain
  recursion, recovered without dynamic shapes;
* plane normals come from the batched closed-form 3x3 eigensolve
  (ops/geometry.py) instead of per-patch host Eigen calls (cpp:89).

Everything is jit-compiled once per (capacity, config); arrays never leave
device; ``vmap`` batches scans and ``pjit``/``shard_map`` shard them across
a device mesh (patchwork_tpu.parallel).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..core.config import PatchworkConfig
from ..core.types import GroundResult
from ..ops.geometry import eigh3x3
from .binning import assign_patches
from .segops import SegOps, default_impl, sort_by_segment

__all__ = ["filter_ground", "make_filter_ground", "make_filter_ground_batched"]

_F32 = jnp.float32
# np scalar, NOT jnp.float32(inf): materializing a device array at import
# time initializes the XLA backend (which breaks jax.distributed.initialize
# for any later multi-process setup).
_INF = np.float32(np.inf)


def _cov_normal(m2: jax.Array, gcnt: jax.Array):
    """(S, 6) centered second moments -> plane normal per segment.

    Mirrors fitPlanePCA's covariance/(n-1) + smallest-eigenvector + flip
    to +Z (cpp:86-95).
    """
    denom = jnp.maximum(gcnt - 1.0, 1.0)[:, None]
    m = m2 / denom  # xx, xy, xz, yy, yz, zz
    cov = jnp.stack(
        [
            jnp.stack([m[:, 0], m[:, 1], m[:, 2]], axis=-1),
            jnp.stack([m[:, 1], m[:, 3], m[:, 4]], axis=-1),
            jnp.stack([m[:, 2], m[:, 4], m[:, 5]], axis=-1),
        ],
        axis=-2,
    )
    _, normal = eigh3x3(cov)
    return jnp.where(normal[:, 2:3] < 0, -normal, normal)


def _fit_step(ops: SegOps, xyz, gmask):
    """One batched masked PCA fit: returns (gcnt, dist).

    ``dist`` is each point's |(p - c_seg) . n_seg| against its own
    segment's plane (fitPlanePCA cpp:77-107 + computePlaneDistances).
    Two segment passes (sums, then centered products) keep f32 accuracy —
    the same two-pass structure as the reference.
    """
    g = gmask.astype(_F32)
    m1 = ops.sum(jnp.concatenate([g[:, None], xyz * g[:, None]], axis=1))
    gcnt = m1[:, 0]
    centroid = m1[:, 1:4] / jnp.maximum(gcnt, 1.0)[:, None]

    c_pt = ops.gather(centroid)  # (N, 3)
    d_all = xyz - c_pt
    d = d_all * g[:, None]
    dx, dy, dz = d[:, 0], d[:, 1], d[:, 2]
    m2 = ops.sum(
        jnp.stack([dx * dx, dx * dy, dx * dz, dy * dy, dy * dz, dz * dz], axis=1)
    )
    normal = _cov_normal(m2, gcnt)
    n_pt = ops.gather(normal)
    dist = jnp.abs(jnp.einsum("ni,ni->n", d_all, n_pt, precision="highest"))
    return gcnt, dist


def _level_body(cfg, impl, xyz, pa, tau_patch, zth_patch, lvl, num_segs,
                is_level0, node, node_patch_in, done, ground):
    """Stats -> early-outs -> seeds -> iterative fit -> split flags for one
    level (every active node simultaneously).  Split EXECUTION (median,
    child assignment) is deferred to :func:`_child_remap` so it only runs
    when a split actually happened.

    Returns (done, ground, split (num_segs,) bool).
    """
    x, y, z = xyz[:, 0], xyz[:, 1], xyz[:, 2]
    eff_levels = cfg.effective_levels
    trash = num_segs - 1

    # level-0 node->patch map is the identity; deeper levels carry a table
    if is_level0:
        node_patch = jnp.arange(num_segs, dtype=jnp.int32)
    else:
        node_patch = node_patch_in[:num_segs]
    tau_node = tau_patch[node_patch]  # (S,) tiny gathers
    zth_node = zth_patch[node_patch]

    active = pa.in_patch & ~done
    seg = jnp.where(active, node, trash)
    ops = SegOps(seg, num_segs, impl)

    node_ids = jnp.arange(num_segs, dtype=jnp.int32)
    real = node_ids < trash

    # ---- stats + seed candidates, op-fused ----
    # Adaptive (default) path: the seed threshold depends only on the base
    # patch, so seed candidacy is known BEFORE any per-node statistic —
    # one 2-channel gather ([z_th, tau]), then ONE 2-channel sum fuses the
    # node count with the seed count, and the bbox is two multi-channel
    # reduces.  Non-adaptive needs the percentile sort first.
    if cfg.adaptive_seed_height:
        tg = ops.gather(jnp.stack([zth_node, tau_node], axis=1))
        zth_pt, tau_pt = tg[:, 0], tg[:, 1]
        seed = active & (z < zth_pt)
        cnts = ops.sum(
            jnp.stack([active.astype(_F32), seed.astype(_F32)], axis=1)
        )
        cnt_i = cnts[:, 0].astype(jnp.int32)
        seed_cnt = cnts[:, 1].astype(jnp.int32)
    else:
        sortz = sort_by_segment(seg, z, num_segs)
        cnt_i = ops.count(active)
        k10 = (_F32(cfg.seed_percentile) * cnt_i.astype(_F32)).astype(jnp.int32)
        z_th = sortz.order_stat(k10) + _F32(cfg.th_seeds)
        tg = ops.gather(jnp.stack([z_th, tau_node], axis=1))
        zth_pt, tau_pt = tg[:, 0], tg[:, 1]
        seed = active & (z < zth_pt)
        seed_cnt = ops.count(seed)

    mins, maxs = ops.bbox(xyz, active)
    xmin, ymin, zmin = mins[0], mins[1], mins[2]
    xmax, ymax, zmax = maxs[0], maxs[1], maxs[2]

    # ---- early-outs, in reference order (cpp:111-140) ----
    too_small = cnt_i < 3
    area = (xmax - xmin) * (ymax - ymin)
    if is_level0:  # area early-out requires depth > 0 (cpp:127)
        flat_area = jnp.zeros_like(too_small)
    else:
        flat_area = (area < _F32(cfg.flat_area_m2)) & ~too_small
    flat_z = ((zmax - zmin) < _F32(cfg.flat_dz)) & (cnt_i > cfg.flat_min_points)
    flat_z = flat_z & ~too_small & ~flat_area
    finished_now = real & (too_small | flat_area | flat_z)
    label_true = flat_area | flat_z
    fit_node = real & ~finished_now

    # ---- seed selection (cpp:143-182) ----
    deficient = fit_node & (seed_cnt < cfg.min_seed_points)
    # one bundled per-point gather: [finished, label, fit, deficient]
    t1 = ops.gather(
        jnp.stack(
            [
                finished_now.astype(_F32),
                label_true.astype(_F32),
                fit_node.astype(_F32),
                deficient.astype(_F32),
            ],
            axis=1,
        )
    )
    finished_pt = t1[:, 0] > 0.5
    label_pt = t1[:, 1] > 0.5
    fit_pt = t1[:, 2] > 0.5
    deficient_pt = t1[:, 3] > 0.5

    # "min_seed_points lowest-z points" fallback for deficient nodes
    # (cpp:171-182).  Iterative (z, index)-lexicographic min extraction in
    # a while_loop that runs ZERO trips when no node is deficient — the
    # common case pays nothing (a full z-sort would cost ~30% of the
    # engine).  Ties broken by lowest original index (matches the oracle's
    # stable argsort).
    any_deficient = jnp.any(deficient)
    idx_f = jnp.arange(z.shape[0], dtype=_F32)

    def _low_cond(st):
        _, r = st
        return (r < cfg.min_seed_points) & any_deficient

    big = _F32(3.0e38)  # finite sentinel: inf would NaN the one-hot matmul gather

    def _low_body(st):
        chosen, r = st
        cand = active & deficient_pt & ~chosen
        m = ops.min(z, cand)
        m_pt = ops.gather(jnp.where(jnp.isfinite(m), m, big))
        is_min = cand & (z == m_pt)
        mi = ops.min(idx_f, is_min)
        mi_pt = ops.gather(jnp.where(jnp.isfinite(mi), mi, big))
        pick = is_min & (idx_f == mi_pt)
        return chosen | pick, r + 1

    low3, _ = jax.lax.while_loop(
        _low_cond, _low_body, (jnp.zeros_like(seed), jnp.int32(0))
    )
    seed = jnp.where(deficient_pt, low3, seed) & active

    # ---- write early-out labels; init fitting nodes with seeds ----
    ground = jnp.where(active & finished_pt, label_pt, ground)
    ground = jnp.where(active & fit_pt, seed, ground)
    done = done | (active & finished_pt)

    # ---- batched iterative plane fitting (cpp:186-217) ----
    def _cond(st):
        _, any_changed, it = st
        return (it < cfg.max_iter) & any_changed

    def _body(st):
        g_mask, _, it = st
        gcnt, dist = _fit_step(ops, xyz, g_mask & active)
        can_pt = ops.gather((gcnt >= 3.0).astype(_F32)) > 0.5
        new_g = dist < tau_pt
        apply_pt = active & fit_pt & can_pt
        changed = apply_pt & (new_g != g_mask)
        g_next = jnp.where(apply_pt, new_g, g_mask)
        return g_next, jnp.any(changed), it + 1

    ground, _, _ = jax.lax.while_loop(
        _cond, _body, (ground, jnp.bool_(True), jnp.int32(0))
    )

    # ---- final fit, residual (cpp:219-228) ----
    g_final = ground & active
    gcnt, dist = _fit_step(ops, xyz, g_final)
    resid = ops.sum(dist * g_final.astype(_F32)) / jnp.maximum(gcnt, 1.0)
    resid = jnp.where(gcnt >= 3.0, resid, _INF)

    # ---- split decision (cpp:231-235) ----

    # split allowed while below both the depth cap and the level budget
    lvl_f = jnp.asarray(lvl, _F32)
    split_thresh = _F32(cfg.th_dist) * (1.0 + _F32(cfg.split_residual_slope) * lvl_f)
    min_sz = (
        cfg.split_min_points_base
        + cfg.split_min_points_slope * jnp.asarray(lvl, jnp.int32)
    )
    depth_ok = jnp.asarray(lvl, jnp.int32) < min(cfg.max_split_depth, eff_levels - 1)
    split = fit_node & (resid > split_thresh) & (cnt_i >= min_sz) & depth_ok

    # fitting nodes that do NOT split are finished with their converged
    # mask; split-node points stay live for _child_remap
    split_pt = ops.gather_bool(split)
    done = done | (active & fit_pt & ~split_pt)

    return done, ground, split


def _child_remap(cfg, impl, xyz, pa, node, node_patch, done, ground, split_pad):
    """Execute the parent level's splits: variance axis, per-node median,
    compact child slot assignment (cpp:237-304, order-preserving combine).

    Runs INSIDE the deeper-level while_loop, i.e. only when some node
    split.  ``split_pad`` is the (cap_a+1,) padded parent split mask; the
    only still-active points are those of split nodes (everything else was
    marked done by _level_body).
    """
    x, y = xyz[:, 0], xyz[:, 1]
    num_p = cfg.num_patches
    cap_a = max(cfg.max_active_nodes, num_p)
    num_segs = cap_a + 1
    trash = cap_a

    active = pa.in_patch & ~done
    seg = jnp.where(active, node, trash)
    ops = SegOps(seg, num_segs, impl)
    w = active.astype(_F32)

    cnt_i = ops.count(active)

    # population-variance axis about the full-node centroid (cpp:237-250)
    sums = ops.sum(jnp.stack([x * w, y * w], axis=1))
    c_all = sums / jnp.maximum(cnt_i.astype(_F32), 1.0)[:, None]
    c_pt = ops.gather(c_all)
    dx = (x - c_pt[:, 0]) * w
    dy = (y - c_pt[:, 1]) * w
    var = ops.sum(jnp.stack([dx * dx, dy * dy], axis=1))
    axis_is_x = var[:, 0] > var[:, 1]

    # exact per-node median: sorted[cnt // 2] (cpp:253-269)
    val = jnp.where(ops.gather_bool(axis_is_x), x, y)
    sortv = sort_by_segment(seg, val, num_segs)
    median = sortv.order_stat(cnt_i // 2)

    # compact child slots: children of split nodes renumber into
    # [0, cap_a); overflowing nodes keep their converged mask (depth
    # truncation — raise cfg.max_active_nodes for pathological scenes)
    split = split_pad[:num_segs]
    split_i = split.astype(jnp.int32)
    rank = jnp.cumsum(split_i) - split_i
    base_slot = 2 * rank
    ok = split & (base_slot + 1 < cap_a)

    t2 = ops.gather(
        jnp.stack([median, ok.astype(_F32), base_slot.astype(_F32)], axis=1)
    )
    median_pt = t2[:, 0]
    ok_pt = t2[:, 1] > 0.5
    slot_pt = t2[:, 2].astype(jnp.int32)

    done = done | (active & ~ok_pt)
    go_right = (val > median_pt).astype(jnp.int32)  # val <= median -> left
    node = jnp.where(active & ok_pt, slot_pt + go_right, node)

    # next level's node -> patch table ((cap_a+1,), unused slots -> P)
    idx0 = jnp.where(ok, base_slot, cap_a + 1)
    np_next = jnp.full((cap_a + 3,), num_p, jnp.int32)
    np_next = np_next.at[idx0].set(jnp.where(ok, node_patch[:num_segs], num_p))
    np_next = np_next.at[idx0 + 1].set(jnp.where(ok, node_patch[:num_segs], num_p))
    node_patch_out = np_next[: cap_a + 1]

    return node, node_patch_out, done


def filter_ground(
    xyz: jax.Array, valid: jax.Array, cfg: PatchworkConfig, impl: str | None = None
) -> GroundResult:
    """Segment one scan into ground / non-ground masks.

    ``xyz``: (N, 3) float32, ``valid``: (N,) bool.  Shapes are static; jit
    this with ``cfg`` static (see :func:`make_filter_ground`).  ``impl``
    selects the segment-op backend (None = auto per platform).
    """
    impl = impl or cfg.segment_impl or default_impl()
    pa = assign_patches(xyz, valid, cfg, impl=impl)
    # Non-finite coords are outside every patch (pa.finite), but their raw
    # values must not reach the segment matmuls: 0 * NaN = NaN would poison
    # every segment column of the 'onehot' reductions.
    xyz = jnp.where(pa.finite[:, None], xyz, 0.0)
    num_p = cfg.num_patches
    cap_a = max(cfg.max_active_nodes, num_p)
    eff_levels = cfg.effective_levels
    n_points = xyz.shape[0]

    # Per-base-patch thresholds, threaded unchanged through all split
    # levels (reference passes mean_dist down the recursion, cpp:286-287).
    tau_patch = _F32(cfg.th_dist) * (1.0 + _F32(cfg.tau_slope) * pa.rel_dist)
    zth_patch = _F32(cfg.sensor_height) + _F32(cfg.seed_slope) * pa.rel_dist

    node = pa.patch.astype(jnp.int32)  # level-0 node id == patch id
    done = ~pa.in_patch
    ground = jnp.zeros((n_points,), bool)

    done, ground, split0 = _level_body(
        cfg, impl, xyz, pa, tau_patch, zth_patch, 0, num_p + 1, True,
        node, None, done, ground,
    )

    if eff_levels > 1:
        split_pad = jnp.zeros((cap_a + 1,), bool).at[: num_p + 1].set(split0)
        node_patch0 = jnp.full((cap_a + 1,), num_p, jnp.int32)
        node_patch0 = node_patch0.at[: num_p + 1].set(
            jnp.arange(num_p + 1, dtype=jnp.int32)
        )

        def _cond(carry):
            lvl, _, _, _, _, split = carry
            return (lvl < eff_levels) & jnp.any(split)

        def _body(carry):
            lvl, nd, np_tab, dn, gr, split = carry
            nd, np_tab, dn = _child_remap(
                cfg, impl, xyz, pa, nd, np_tab, dn, gr, split
            )
            dn, gr, split_next = _level_body(
                cfg, impl, xyz, pa, tau_patch, zth_patch, lvl, cap_a + 1,
                False, nd, np_tab, dn, gr,
            )
            return lvl + 1, nd, np_tab, dn, gr, split_next

        carry = (jnp.int32(1), node, node_patch0, done, ground, split_pad)
        _, _, _, done, ground, _ = jax.lax.while_loop(_cond, _body, carry)

    ground = ground & pa.in_patch
    return GroundResult(
        ground=ground, valid=pa.finite, in_zone=pa.in_zone, in_patch=pa.in_patch
    )


def make_filter_ground(cfg: PatchworkConfig, impl: str | None = None):
    """jit-compiled single-scan engine: (xyz (N,3), valid (N,)) -> GroundResult."""

    @jax.jit
    def fn(xyz, valid):
        return filter_ground(xyz, valid, cfg, impl=impl)

    return fn


def make_filter_ground_batched(cfg: PatchworkConfig, impl: str | None = None):
    """jit-compiled batched engine: (xyz (B,N,3), valid (B,N)) -> GroundResult."""

    @jax.jit
    @functools.partial(jax.vmap, in_axes=(0, 0))
    def fn(xyz, valid):
        return filter_ground(xyz, valid, cfg, impl=impl)

    return fn
