"""Segment primitives: reductions, gathers, and order statistics over node ids.

These replace the reference's O(rings*sectors*N) per-patch membership
rescans and per-patch std::sort calls (src/recursive_patchwork.cpp:372-378,
259-268): every patch/node of a level is processed in one batched pass,
with points addressed by a segment id.

Two interchangeable implementations (differentially tested against each
other, the reference test_cuda.cpp pattern):

* ``scatter`` — jax.ops.segment_sum/min/max + native gathers.  Exact,
  and the bit-exact golden path for parity tests.
* ``onehot`` — segment reductions and per-point table lookups expressed as
  one-hot matmuls/masked reductions over an ``(N, S)`` one-hot: the
  one-hot is generated from the ids (XLA fuses the generator into the
  consumers), sums are f32 matmuls at ``precision="highest"``, and the
  result does not depend on the order of any atomic update.

``DEFAULT_IMPL`` is ``scatter`` on every supported platform: it is the
exact golden path, and on an H100 it is 11.6-14.4x faster than
``onehot`` at 8 x 131,072 points (PERF.md).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..core.config import SEGMENT_IMPLS as IMPLS
from ..core.device import check_platform

__all__ = [
    "IMPLS",
    "DEFAULT_IMPL",
    "default_impl",
    "SegOps",
    "seg_sum",
    "seg_min",
    "seg_max",
    "SegmentSort",
    "sort_by_segment",
]

DEFAULT_IMPL = "scatter"


def default_impl() -> str:
    """Trace-time segment-op impl; raises on an unsupported platform."""
    check_platform()
    return DEFAULT_IMPL


# ---------------------------------------------------------------------------
# scatter-based primitives (also used directly by binning / sampling)
# ---------------------------------------------------------------------------

def seg_sum(data: jax.Array, seg: jax.Array, num_segments: int) -> jax.Array:
    return jax.ops.segment_sum(data, seg, num_segments=num_segments)


def seg_min(data: jax.Array, seg: jax.Array, num_segments: int) -> jax.Array:
    return jax.ops.segment_min(data, seg, num_segments=num_segments)


def seg_max(data: jax.Array, seg: jax.Array, num_segments: int) -> jax.Array:
    return jax.ops.segment_max(data, seg, num_segments=num_segments)


# ---------------------------------------------------------------------------
# per-level segment-op bundle
# ---------------------------------------------------------------------------

class SegOps:
    """Segment reductions/gathers for one level's (seg, num_segs) binding.

    ``seg`` is (N,) int32 in [0, num_segs); out-of-segment points must be
    parked on a trash slot by the caller.  ``impl`` is one of
    :data:`IMPLS`.
    """

    def __init__(self, seg: jax.Array, num_segs: int, impl: str):
        if impl not in IMPLS:
            raise ValueError(f"unknown segment impl {impl!r}")
        self.seg = seg
        self.S = num_segs
        self.impl = impl
        if impl == "onehot":
            ids = jax.lax.broadcasted_iota(jnp.int32, (1, num_segs), 1)
            # (N, S) one-hot; exact in bf16 (values 0/1); XLA fuses the
            # comparison into each consumer, so this is not necessarily
            # materialized in HBM.
            self._ohb = seg[:, None] == ids
            self._oh = self._ohb.astype(jnp.bfloat16)

    # -- reductions: (N, C) -> (S, C) ------------------------------------
    def sum(self, data: jax.Array) -> jax.Array:
        if data.ndim == 1:
            return self.sum(data[:, None])[:, 0]
        if self.impl == "scatter":
            return seg_sum(data, self.seg, self.S)
        return jnp.einsum(
            "ns,nc->sc", self._oh, data, precision="highest",
            preferred_element_type=jnp.float32,
        )

    def count(self, mask: jax.Array) -> jax.Array:
        """Integer count per segment."""
        if self.impl == "scatter":
            return seg_sum(mask.astype(jnp.int32), self.seg, self.S)
        return self.sum(mask.astype(jnp.float32)).astype(jnp.int32)

    def min(self, vals: jax.Array, where: jax.Array) -> jax.Array:
        """(N,) -> (S,) masked min; +inf for empty segments."""
        if self.impl == "scatter":
            v = jnp.where(where, vals, jnp.inf)
            return seg_min(v, self.seg, self.S)
        m = jnp.where(
            self._ohb & where[:, None], vals[:, None], jnp.float32(jnp.inf)
        )
        return jnp.min(m, axis=0)

    def max(self, vals: jax.Array, where: jax.Array) -> jax.Array:
        if self.impl == "scatter":
            v = jnp.where(where, vals, -jnp.inf)
            return seg_max(v, self.seg, self.S)
        m = jnp.where(
            self._ohb & where[:, None], vals[:, None], jnp.float32(-jnp.inf)
        )
        return jnp.max(m, axis=0)

    def bbox(self, xyz: jax.Array, where: jax.Array):
        """Fused masked min/max of x, y, z: returns (mins (3, S), maxs (3, S)).

        Two multi-channel reduces in the onehot impl (instead of six
        single-channel ones); per-channel scatter ops otherwise.
        """
        if self.impl == "onehot":
            # (N, S, 3) masked values, one fused reduce per direction
            sel = (self._ohb & where[:, None])[:, :, None]
            v = xyz[:, None, :]
            mins = jnp.min(jnp.where(sel, v, jnp.inf), axis=0)   # (S, 3)
            maxs = jnp.max(jnp.where(sel, v, -jnp.inf), axis=0)
            return mins.T, maxs.T
        mins = jnp.stack([self.min(xyz[:, i], where) for i in range(3)])
        maxs = jnp.stack([self.max(xyz[:, i], where) for i in range(3)])
        return mins, maxs

    # -- gathers: (S, C) -> (N, C) ---------------------------------------
    def gather(self, table: jax.Array) -> jax.Array:
        """Per-point lookup of a per-segment table."""
        if table.ndim == 1:
            return self.gather(table[:, None])[:, 0]
        if self.impl == "scatter":
            return table[self.seg]
        return jnp.einsum(
            "ns,sc->nc", self._oh, table, precision="highest",
            preferred_element_type=jnp.float32,
        )

    def gather_bool(self, table: jax.Array) -> jax.Array:
        if self.impl == "scatter":
            return table[self.seg]
        return self.gather(table.astype(jnp.float32)) > 0.5


# ---------------------------------------------------------------------------
# segment sort / order statistics
# ---------------------------------------------------------------------------

class SegmentSort(NamedTuple):
    """Result of a stable (segment, value) sort of N points.

    sorted_seg : (N,) segment id of each sorted slot
    sorted_val : (N,) values in (segment, value) order
    order      : (N,) original index of each sorted slot
    starts     : (S,) first sorted slot of each segment (exclusive cumsum)
    counts     : (S,) number of points per segment
    rank       : (N,) rank of each sorted slot within its segment
    """

    sorted_seg: jax.Array
    sorted_val: jax.Array
    order: jax.Array
    starts: jax.Array
    counts: jax.Array
    rank: jax.Array

    def order_stat(self, k_per_segment: jax.Array) -> jax.Array:
        """Per-segment k-th smallest value (k may differ per segment).

        Undefined (but in-bounds) for empty segments or k >= count — callers
        mask those out.  Batched equivalent of the reference's per-patch
        ``std::sort`` + ``sorted[k]`` median / percentile lookups
        (src/recursive_patchwork.cpp:156-159, 253-269).
        """
        n = self.sorted_val.shape[0]
        pos = jnp.clip(self.starts + k_per_segment, 0, n - 1)
        return self.sorted_val[pos]

    def scatter_rank_below(self, k: int) -> jax.Array:
        """Bool mask (original order): point has within-segment rank < k.

        Used for the reference's "3 lowest-z points" seed fallback
        (src/recursive_patchwork.cpp:171-182).
        """
        n = self.sorted_val.shape[0]
        mask_sorted = self.rank < k
        return jnp.zeros((n,), bool).at[self.order].set(mask_sorted)


def sort_by_segment(seg: jax.Array, val: jax.Array, num_segments: int) -> SegmentSort:
    """Stable lexicographic sort by (segment id, value)."""
    n = seg.shape[0]
    idx = jnp.arange(n, dtype=jnp.int32)
    sorted_seg, sorted_val, order = jax.lax.sort(
        (seg.astype(jnp.int32), val, idx), num_keys=2
    )
    counts = seg_sum(jnp.ones((n,), jnp.int32), seg, num_segments)
    starts = jnp.cumsum(counts) - counts
    rank = idx - starts[sorted_seg]
    return SegmentSort(sorted_seg, sorted_val, order, starts, counts, rank)
