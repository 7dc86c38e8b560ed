"""Ground-constrained LiDAR odometry pipeline.

Per frame: Patchwork segmentation (ground/obstacle masks) -> fixed-size
downsample of each class -> ground-constrained ICP against the previous
keyframe -> odometry edge into the keyframe pose graph.  Everything
device-side except the tiny keyframe bookkeeping.

BASELINE.json configs[4]: "Ground-constrained LiDAR odometry + pose graph
with distributed Schur-complement BA" — this module is the front end; the
graph solvers live in pose_graph.py / ba.py.
"""

from __future__ import annotations

import dataclasses
import os
from typing import List, Optional

import numpy as np
import jax
import jax.numpy as jnp

from ..core.config import PatchworkConfig
from ..ops.sampling import random_subsample_mask
from ..segment.engine import filter_ground
from .pose_graph import PoseGraph, ate_rmse, optimize_pose_graph
from .scan_matching import icp_ground_constrained

__all__ = ["OdometryConfig", "LidarOdometry"]

_FRAME_KEYS = ("obst", "obst_valid", "ground", "ground_valid")

# Opt-in scan-upload quantization (PATCHWORK_TPU_UPLOAD_QUANT=int16):
# int16 fixed-point at 5 mm resolution halves the xyz payload of the
# extract stage's host->device upload.  The +-2.5 mm quantization error
# sits well under the simulated sensor noise (10-20 mm) and real LiDAR
# range accuracy, but the knob stays OFF until an ATE + loop-closure A/B
# on the card clears it (quality gates decide, not plausibility).
_QUANT_SCALE = np.float32(0.005)   # meters per int16 step (+-163.8 m range)


def _upload_quant() -> str:
    return os.environ.get("PATCHWORK_TPU_UPLOAD_QUANT", "")


class _StackedFrames:
    """Sequence of per-keyframe feature dicts backed by STACKED arrays.

    Materializing K per-frame dicts eagerly costs 4 device slice ops per
    frame (~4000 dispatches at 1000 kf).  This keeps the (K, ...) stacks
    resident and slices a frame dict only on demand;
    bulk consumers (chunk-vmapped loop-closure verification, the BA
    landmark extraction) read ``.stacked`` directly with zero per-frame
    ops.  ``append`` (add_scan after a parallel ingest) goes to an
    overflow list; the stacked fast paths require ``not extra``.
    """

    def __init__(self, stacked: dict):
        self.stacked = stacked
        self._k = int(stacked["obst"].shape[0])
        self.extra: List[dict] = []

    def __len__(self):
        return self._k + len(self.extra)

    def __getitem__(self, i):
        if i < 0:
            i += len(self)
        if i < self._k:
            return {k: self.stacked[k][i] for k in _FRAME_KEYS}
        return self.extra[i - self._k]

    def append(self, frame: dict):
        self.extra.append(frame)


@dataclasses.dataclass(frozen=True)
class OdometryConfig:
    capacity: int = 65536          # padded points per scan
    obstacle_samples: int = 2048   # ICP obstacle correspondences
    ground_samples: int = 1024     # ground-plane constraint points
    icp_iters: int = 12
    max_corr_dist: float = 2.0
    coarse_factor: float = 8.0   # initial ICP gate = coarse_factor * max_corr_dist
    keyframe_every: int = 1        # keyframe cadence (frames)
    edge_info_trans: float = 100.0  # odometry edge information (1/sigma^2)
    edge_info_rot: float = 400.0


class LidarOdometry:
    """Streaming odometry: feed scans, accumulate a keyframe pose graph."""

    def __init__(
        self,
        patchwork: Optional[PatchworkConfig] = None,
        cfg: Optional[OdometryConfig] = None,
    ):
        self.pw = patchwork or PatchworkConfig()
        self.cfg = cfg or OdometryConfig()
        self._frames: List[dict] = []        # device features per keyframe
        self.poses: List[np.ndarray] = []    # world_T_keyframe
        self.edges: List[tuple] = []         # (i, j, T_ij (4,4) np)
        pw, c = self.pw, self.cfg

        @jax.jit
        def extract(xyz, valid, key):
            """Segment + class-wise fixed-size downsample of one scan."""
            res = filter_ground(xyz, valid, pw)
            obst = res.valid & ~res.ground
            k1, k2 = jax.random.split(key)
            obst_sel = random_subsample_mask(k1, obst, c.obstacle_samples)
            gnd_sel = random_subsample_mask(k2, res.ground, c.ground_samples)

            def take(sel, cap):
                idx = jnp.nonzero(sel, size=cap, fill_value=0)[0]
                n = jnp.sum(sel)
                v = jnp.arange(cap) < n
                return xyz[idx], v

            o_pts, o_val = take(obst_sel, c.obstacle_samples)
            g_pts, g_val = take(gnd_sel, c.ground_samples)
            return o_pts, o_val, g_pts, g_val

        @jax.jit
        def match(src, tgt, init):
            return icp_ground_constrained(
                src["obst"], src["obst_valid"], src["ground"], src["ground_valid"],
                tgt["obst"], tgt["obst_valid"], tgt["ground"], tgt["ground_valid"],
                init=init, iters=c.icp_iters, max_corr_dist=c.max_corr_dist,
                coarse_factor=c.coarse_factor,
            )

        self._extract = extract
        self._extract_batched = jax.jit(jax.vmap(extract))

        @jax.jit
        def extract_batched_q(q, valid, keys):
            """int16 fixed-point upload variant: dequantize on device
            inside the same dispatch (no extra op round trip)."""
            xyz = q.astype(jnp.float32) * _QUANT_SCALE
            return jax.vmap(extract)(xyz, valid, keys)

        self._extract_batched_q = extract_batched_q
        self._match = match
        self._match_pairs = jax.jit(jax.vmap(match))

        @jax.jit
        def match_idx(stacked, src_idx, tgt_idx, inits):
            """Gather-then-vmapped-match in ONE dispatch (the per-chunk
            host-side tree_map gathers cost ~10 device ops each)."""
            src = {k: stacked[k][src_idx] for k in _FRAME_KEYS}
            tgt = {k: stacked[k][tgt_idx] for k in _FRAME_KEYS}
            return jax.vmap(match)(src, tgt, inits)

        self._match_idx = match_idx

        @jax.jit
        def match_many(stacked, src_idx, tgt_idx, inits):
            """A whole pass of pair solves in ONE device dispatch.

            (C, chunk)-shaped index arrays; lax.map runs the vmapped
            chunk solver sequentially ON DEVICE, which removes the host
            round trip per chunk from the loop entirely
            (tools/icp_bench.py attributes the stage)."""
            def one_chunk(args):
                si, ti, init = args
                src = {k: stacked[k][si] for k in _FRAME_KEYS}
                tgt = {k: stacked[k][ti] for k in _FRAME_KEYS}
                return jax.vmap(match)(src, tgt, init)

            return jax.lax.map(one_chunk, (src_idx, tgt_idx, inits))

        self._match_many = match_many

    def _pad_host(self, pts: np.ndarray, cap: int | None = None):
        cap = self.cfg.capacity if cap is None else cap
        n = min(len(pts), cap)
        xyz = np.zeros((cap, 3), np.float32)
        xyz[:n] = np.asarray(pts, np.float32)[:n, :3]
        valid = np.zeros(cap, bool)
        valid[:n] = True
        return xyz, valid

    def _pad(self, pts: np.ndarray):
        xyz, valid = self._pad_host(pts)
        return jnp.asarray(xyz), jnp.asarray(valid)

    def add_scan(self, pts: np.ndarray, seed: int = 0) -> np.ndarray:
        """Process one scan; returns the current world pose estimate.

        Every scan is matched against the LAST KEYFRAME; a new keyframe
        (graph node + odometry edge) is created every
        ``cfg.keyframe_every`` frames — intermediate frames update the
        live pose without growing the graph.
        """
        xyz, valid = self._pad(pts)
        o, ov, g, gv = self._extract(xyz, valid, jax.random.key(seed))
        frame = {"obst": o, "obst_valid": ov, "ground": g, "ground_valid": gv}
        return self._ingest(frame)

    def add_scans(self, scans, seeds=None, batch: int = 8,
                  parallel_icp: bool = False,
                  pair_chunk: int = 32) -> np.ndarray:
        """Batched ingest of a scan sequence; returns the (K, 4, 4) poses.

        The expensive per-scan stage — segmentation + class-wise
        downsample — has NO sequential dependency, so it runs vmapped in
        chunks of ``batch`` (one device dispatch per chunk).  By default the ICP chain then consumes the precomputed
        features in order, preserving the exact constant-velocity
        warm-start semantics of calling :meth:`add_scan` scan by scan.

        ``parallel_icp=True`` (requires ``keyframe_every == 1``) replaces
        the sequential chain with a two-pass vmapped solve over ALL
        consecutive pairs at once — the throughput mode for long mapping
        sessions where frame latency does not matter:

        * pass 1: every pair matched from the identity init (the annealed
          coarse gate covers ordinary inter-frame motion);
        * pass 2 (selective): pairs whose inlier RMSE is an outlier are
          re-matched warm-started from their *predecessor's* pass-1 delta
          — the parallel analogue of the constant-velocity prediction —
          keeping whichever result has the lower inlier RMSE.

        Each pass runs ``pair_chunk`` ICPs per device dispatch; poses are
        composed on the host afterwards (K tiny 4x4 matmuls).
        """
        import time as _time

        if seeds is None:
            seeds = range(len(scans))
        seeds = list(seeds)
        feats = []   # parallel mode: collect features, defer matching
        t0 = _time.perf_counter()
        o = None
        # auto-shrink the padded capacity to the batch's real need:
        # cfg.capacity is an upper bound, but scans are usually far
        # smaller (~19k pts padded to 32768 made ~40% of the upload
        # zeros).  Rounding up to 4096 keeps the shape-bucket
        # count (and thus jit specializations) tiny; the persistent
        # compile cache amortizes each bucket once ever.
        longest = max((len(p) for p in scans), default=0)
        cap = min(self.cfg.capacity, max(4096, -(-longest // 4096) * 4096))
        for s0 in range(0, len(scans), batch):
            chunk = scans[s0 : s0 + batch]
            # pad + stack on HOST, upload each chunk as ONE transfer
            # instead of 2B small uploads (per-scan xyz + valid) and a
            # device-side stack.
            padded = [self._pad_host(p, cap) for p in chunk]
            stack = np.stack([x for x, _ in padded])
            val_b = jnp.asarray(np.stack([v for _, v in padded]))
            keys = jax.vmap(jax.random.key)(
                jnp.asarray(seeds[s0 : s0 + len(chunk)], jnp.uint32))
            if _upload_quant() == "int16":
                q_b = np.clip(np.round(stack / _QUANT_SCALE),
                              -32767, 32767).astype(np.int16)
                o, ov, g, gv = self._extract_batched_q(
                    jnp.asarray(q_b), val_b, keys)
            else:
                o, ov, g, gv = self._extract_batched(
                    jnp.asarray(stack), val_b, keys)
            if parallel_icp:
                feats.append((o, ov, g, gv))
            else:
                for i in range(len(chunk)):
                    self._ingest({"obst": o[i], "obst_valid": ov[i],
                                  "ground": g[i], "ground_valid": gv[i]})
        # stage attribution (meaningful in parallel mode, where extraction
        # and matching are distinct passes; the sequential chain interleaves
        # them inside _ingest): wait for the device before taking the split.
        if parallel_icp and o is not None:
            jax.block_until_ready(o)
            key = "extract_s"
        else:
            key = "extract_and_icp_s"
        self.last_timings = {key: round(_time.perf_counter() - t0, 2)}
        t0 = _time.perf_counter()
        if parallel_icp:
            if self.cfg.keyframe_every != 1:
                raise ValueError("parallel_icp requires keyframe_every == 1")
            if self._frames:
                raise ValueError(
                    "parallel_icp rebuilds the whole trajectory; call it on "
                    "a fresh LidarOdometry (no scans ingested yet)")
            stacked = {
                "obst": jnp.concatenate([f[0] for f in feats]),
                "obst_valid": jnp.concatenate([f[1] for f in feats]),
                "ground": jnp.concatenate([f[2] for f in feats]),
                "ground_valid": jnp.concatenate([f[3] for f in feats]),
            }
            self._ingest_parallel(stacked, pair_chunk)
        self.last_timings["icp_s"] = round(_time.perf_counter() - t0, 2)
        return np.stack(self.poses)

    def _solve_pairs(self, stacked: dict, pair_idx: np.ndarray,
                     inits: np.ndarray, pair_chunk: int):
        """Vmapped ICP of pairs (i -> i+1), ``pair_chunk`` per dispatch."""
        m = len(pair_idx)
        pair_chunk = min(pair_chunk, max(m, 1))
        # whole pass in ONE dispatch: (C, chunk) index grid, ragged tail
        # REPEATS the last pair.  C buckets to a power of two below 4 and
        # to the next multiple of 4 above — bounded redundant work (<= 3
        # chunks; a pure pow2 bucket would solve up to ~2x extra pairs
        # when n_chunks just exceeds a power of two) while the distinct
        # (C, chunk) jit specializations stay few, each compiled once
        # EVER under the persistent compilation cache.
        n_chunks = -(-m // pair_chunk)
        c = n_chunks if n_chunks in (1, 2) else -(-n_chunks // 4) * 4
        at = np.minimum(np.arange(c * pair_chunk), m - 1)
        idx = pair_idx[at].reshape(c, pair_chunk)
        init_g = jnp.asarray(np.asarray(inits)[at].reshape(
            c, pair_chunk, 4, 4))
        res = self._match_many(stacked, jnp.asarray(idx + 1),
                               jnp.asarray(idx), init_g)
        Ts = np.asarray(res.transform).reshape(-1, 4, 4)[:m]
        rmses = np.asarray(res.rmse).reshape(-1)[:m]
        return Ts, rmses

    def _ingest_parallel(self, stacked: dict, pair_chunk: int) -> None:
        """Parallel ICP chain: full pass from identity, selective retry."""
        k = int(stacked["obst"].shape[0])
        eye = np.eye(4, dtype=np.float32)
        if k == 0:
            return
        if k > 1:
            all_pairs = np.arange(k - 1)
            inits1 = np.broadcast_to(eye, (k - 1, 4, 4))
            T1, r1 = self._solve_pairs(stacked, all_pairs, inits1, pair_chunk)
            # selective pass 2: identity inits converge except on sharp
            # motion (a rotation displaces far structure by r*theta), which
            # shows up as an outlier inlier-RMSE.  Only those pairs are
            # re-matched, warm-started from their predecessor's pass-1
            # delta — the parallel analogue of the constant-velocity
            # prediction — keeping whichever result scores lower.
            med = float(np.median(r1))
            bad = np.where(r1 > max(2.0 * med, 0.05))[0]
            T = T1
            if len(bad):
                inits2 = np.where((bad > 0)[:, None, None],
                                  T1[np.maximum(bad - 1, 0)], eye[None])
                T2, r2 = self._solve_pairs(stacked, bad,
                                           inits2.astype(np.float32),
                                           pair_chunk)
                win = bad[r2 < r1[bad]]
                T = T1.copy()
                T[win] = T2[r2 < r1[bad]]
            T = T.astype(np.float32)
        else:
            T = np.zeros((0, 4, 4), np.float32)
        # compose + populate exactly what the sequential chain would —
        # but frames stay STACKED (lazy per-frame slicing; see
        # _StackedFrames: eager slicing cost ~4 dispatches/frame)
        self._frames = _StackedFrames(stacked)
        self.poses = [eye.copy()]
        self.edges = []
        for i in range(k - 1):
            self.poses.append((self.poses[-1] @ T[i]).astype(np.float32))
            self.edges.append((i, i + 1, T[i]))
        self._frame_counter = k - 1
        self.current_pose = self.poses[-1]
        self._last_delta = T[-1] if k > 1 else eye.copy()

    def _ingest(self, frame: dict) -> np.ndarray:
        if not self._frames:
            self._frames.append(frame)
            self.poses.append(np.eye(4, dtype=np.float32))
            self._frame_counter = 0
            self.current_pose = self.poses[-1]
            self._last_delta = np.eye(4, dtype=np.float32)
            return self.poses[-1]

        prev = self._frames[-1]
        # constant-velocity warm start: predict this frame's pose from the
        # last inter-frame motion, express relative to the keyframe.  This
        # keeps turning sequences inside the ICP correspondence gate (a
        # rotation displaces far structure by r*theta, far beyond
        # max_corr_dist without a prediction).
        predicted = self.current_pose @ self._last_delta
        init = jnp.asarray(
            np.linalg.inv(self.poses[-1]) @ predicted, jnp.float32
        )
        res = self._match(frame, prev, init)
        T_key_cur = np.asarray(res.transform)
        pose = (self.poses[-1] @ T_key_cur).astype(np.float32)
        self._last_delta = (
            np.linalg.inv(self.current_pose) @ pose
        ).astype(np.float32)
        self.current_pose = pose

        self._frame_counter += 1
        if self._frame_counter % self.cfg.keyframe_every == 0:
            self._frames.append(frame)
            self.poses.append(pose)
            self.edges.append((len(self.poses) - 2, len(self.poses) - 1, T_key_cur))
        return pose

    def add_loop_closure(self, i: int, j: int, seed: int = 0) -> np.ndarray:
        """Match keyframe j against keyframe i and add a closure edge."""
        init = jnp.asarray(
            np.linalg.inv(self.poses[i]) @ self.poses[j], jnp.float32
        )
        res = self._match(self._frames[j], self._frames[i], init)
        T_ij = np.asarray(res.transform)
        self.edges.append((i, j, T_ij))
        return T_ij

    def detect_loop_closures(
        self,
        radius: float = 5.0,
        min_separation: int = 4,
        max_rmse: float = 0.5,
        min_inliers: int = 200,
        max_candidates: int | None = 10,
        pair_chunk: int = 32,
    ) -> List[tuple]:
        """Find and verify loop closures automatically.

        Candidates: keyframe pairs whose estimated positions lie within
        ``radius`` but are at least ``min_separation`` keyframes apart
        (revisited places).  ``max_candidates=None`` sizes the budget
        adaptively (~K/3, at least 10); the budget is spent SPREAD along
        the trajectory (nearest candidate per keyframe bucket, remainder
        by distance) rather than on the globally nearest pairs — on a
        multi-lap drive the nearest candidates all cluster in one region,
        which left long trajectory spans unconstrained (VERDICT r4 item
        4: exactly 10 closures on every 1000-kf run was this cap + the
        cluster effect).  Verification is CHUNKED-VMAPPED: candidates are
        ICP-matched ``pair_chunk`` per device dispatch (reusing the
        parallel-ICP trace shape), not one dispatch each.
        Edges are added only when the match clears the inlier-count and
        RMSE gates.  Returns the accepted (i, j) pairs.
        """
        if len(self.poses) < min_separation + 2:
            return []
        pos = np.stack(self.poses)[:, :3, 3]
        d = np.linalg.norm(pos[:, None, :] - pos[None, :, :], axis=-1)
        k = len(pos)
        if max_candidates is None:
            # ~K/3: on the 1000-kf multi-lap drive ATE improved
            # monotonically with the closure budget (95 -> 187 -> 375
            # closures), while the chunk-vmapped verification keeps the
            # loops stage flat and the degree cap bounds the graph cost.
            max_candidates = max(10, k // 3)
        ii, jj = np.triu_indices(k, k=min_separation)
        near = d[ii, jj] < radius
        ii, jj, dd = ii[near], jj[near], d[ii, jj][near]
        existing = {(a, b) for a, b, _ in self.edges}
        fresh = np.array([(int(a), int(b)) not in existing
                          for a, b in zip(ii, jj)], bool)
        ii, jj, dd = ii[fresh], jj[fresh], dd[fresh]
        if len(ii) == 0:
            return []
        # spread: nearest candidate per bucket of the later keyframe
        spacing = max(1, -(-k // max_candidates))
        order = np.argsort(dd, kind="stable")
        picked, picked_set, seen_bins = [], set(), set()
        for t in order:
            b = int(jj[t]) // spacing
            if b not in seen_bins:
                seen_bins.add(b)
                picked.append(t)
                picked_set.add(int(t))
        for t in order:  # fill any remaining budget by distance
            if len(picked) >= max_candidates:
                break
            if int(t) not in picked_set:
                picked.append(t)
                picked_set.add(int(t))
        picked = np.asarray(picked[:max_candidates])
        cand = [(int(ii[t]), int(jj[t])) for t in picked]

        # chunked-vmapped verification (ragged tail repeats the last pair
        # so every dispatch reuses one compiled (pair_chunk, ...) trace)
        m = len(cand)
        pair_chunk = min(pair_chunk, m)
        inits = np.stack([
            (np.linalg.inv(self.poses[i]) @ self.poses[j]).astype(np.float32)
            for i, j in cand])
        stacked = (self._frames.stacked
                   if isinstance(self._frames, _StackedFrames)
                   and not self._frames.extra else None)
        Ts, rmses, inliers = [], [], []
        for s0 in range(0, m, pair_chunk):
            at = np.minimum(np.arange(s0, s0 + pair_chunk), m - 1)
            if stacked is not None:  # one gather+match dispatch per chunk
                res = self._match_idx(
                    stacked,
                    jnp.asarray(np.array([cand[t][1] for t in at])),
                    jnp.asarray(np.array([cand[t][0] for t in at])),
                    jnp.asarray(inits[at]))
            else:
                src = {key: jnp.stack(
                    [self._frames[cand[t][1]][key] for t in at])
                    for key in _FRAME_KEYS}
                tgt = {key: jnp.stack(
                    [self._frames[cand[t][0]][key] for t in at])
                    for key in _FRAME_KEYS}
                res = self._match_pairs(src, tgt, jnp.asarray(inits[at]))
            keep = min(pair_chunk, m - s0)
            Ts.append(res.transform[:keep])
            rmses.append(res.rmse[:keep])
            inliers.append(res.num_inliers[:keep])
        Ts = np.asarray(jnp.concatenate(Ts))
        rmses = np.asarray(jnp.concatenate(rmses))
        inliers = np.asarray(jnp.concatenate(inliers))

        accepted = []
        for t, (i, j) in enumerate(cand):
            if inliers[t] >= min_inliers and rmses[t] <= max_rmse:
                self.edges.append((i, j, Ts[t]))
                accepted.append((i, j))
        return accepted

    def build_graph(self) -> PoseGraph:
        c = self.cfg
        k = len(self.poses)
        e = max(len(self.edges), 1)
        info = np.zeros((e, 6, 6), np.float32)
        info[:, :3, :3] = np.eye(3) * c.edge_info_trans
        info[:, 3:, 3:] = np.eye(3) * c.edge_info_rot
        ei = np.array([x[0] for x in self.edges] or [0], np.int32)
        ej = np.array([x[1] for x in self.edges] or [0], np.int32)
        eT = np.stack([x[2] for x in self.edges] or [np.eye(4, dtype=np.float32)])
        return PoseGraph(
            poses=jnp.asarray(np.stack(self.poses)),
            edge_i=jnp.asarray(ei),
            edge_j=jnp.asarray(ej),
            edge_T=jnp.asarray(eT.astype(np.float32)),
            edge_info=jnp.asarray(info),
        )

    def optimize(self, iters: int = 10, solver: str | None = None,
                 max_degree: int | None = None) -> np.ndarray:
        """Optimize the pose graph; updates and returns all poses.

        solver: None auto-selects dense LU vs matrix-free PCG by K
        (pose_graph.optimize_pose_graph).  max_degree: if set, prune
        loop edges first (pose_graph.sparsify_pose_graph) — bounds the
        per-CG-product cost on long, densely-closed trajectories.
        """
        g = self.build_graph()
        if max_degree is not None:
            from .pose_graph import sparsify_pose_graph

            g = sparsify_pose_graph(g, max_degree=max_degree)
        g = optimize_pose_graph(g, iters=iters, solver=solver)
        poses = np.asarray(g.poses)
        self.poses = [p for p in poses]
        return poses

    def trajectory_error(self, gt_poses: np.ndarray) -> float:
        return float(
            ate_rmse(jnp.asarray(np.stack(self.poses)), jnp.asarray(gt_poses))
        )
