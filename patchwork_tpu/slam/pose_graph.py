"""Keyframe pose-graph optimization, vectorized and mesh-shardable.

State: K SE(3) keyframe poses.  Constraints: relative-pose edges
(odometry, loop closures) with 6x6 information matrices.  Gauss-Newton
with right perturbations; per-edge 6-dof Jacobian blocks come from
``jax.jacfwd`` through the residual (exact autodiff through se3 log/exp),
vmapped over all edges at once.

Structure: the normal equations assemble as segment-sums of
per-edge outer-product blocks into a dense (6K, 6K) system (keyframe
counts here are 10^2-10^3, so the dense solve is tiny next to the edge
math); edge batches shard over the mesh's data axis in the distributed
variant (parallel/), with a psum over partial (H, b) — the same
reduce-then-solve structure as the Schur-complement BA in ba.py.

No reference equivalent (the reference is per-scan segmentation only);
built per BASELINE.json configs[4].
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from .ba import _batched_inv
from .se3 import se3_compose, se3_exp, se3_inverse, se3_log

__all__ = ["PoseGraph", "edge_residuals", "optimize_pose_graph",
           "sparsify_pose_graph", "ate_rmse"]

_F32 = jnp.float32


class PoseGraph(NamedTuple):
    poses: jax.Array     # (K, 4, 4)
    edge_i: jax.Array    # (E,) int32 source keyframe index
    edge_j: jax.Array    # (E,) int32 target keyframe index
    edge_T: jax.Array    # (E, 4, 4) measured T_i^-1 T_j
    edge_info: jax.Array # (E, 6, 6) information (weight) matrices


def edge_residuals(poses: jax.Array, g: PoseGraph) -> jax.Array:
    """(E, 6) twist residuals r_e = log(T_meas^-1 T_i^-1 T_j)."""
    Ti = poses[g.edge_i]
    Tj = poses[g.edge_j]
    return se3_log(se3_compose(
        se3_compose(se3_inverse(g.edge_T), se3_inverse(Ti)), Tj))


def _edge_jacobians(poses: jax.Array, g: PoseGraph):
    """Per-edge residual + 6x6 Jacobian blocks wrt xi_i, xi_j.

    Impls (PATCHWORK_TPU_PG_JAC): 'analytic' (default) — with
    E = Tm^-1 Ti^-1 Tj and r = log(E), right perturbations give
    Jj = Jr^-1(r) and Ji = -Jr^-1(r) Ad(Tj^-1 Ti) (Barfoot §7.1.5;
    se3.se3_right_jacobian_inv carries the exact Q coupling block) —
    straight-line code instead of forward-mode AD through the
    log/compose/exp chain, whose jaxpr was the compile hog measured in
    the BA solver (ba_bench: jacfwd ~60 s of compile);
    'jacfwd' keeps the AD path as the differential oracle
    (tests/test_slam.py asserts both agree to f32 rounding).
    """
    import os

    from .se3 import se3_adjoint, se3_right_jacobian_inv

    Ti = poses[g.edge_i]
    Tj = poses[g.edge_j]
    Tm = g.edge_T

    if os.environ.get("PATCHWORK_TPU_PG_JAC", "analytic") == "jacfwd":
        def res_one(Ti, Tj, Tm, xi_i, xi_j):
            return se3_log(
                se3_compose(se3_compose(
                    se3_inverse(Tm),
                    se3_inverse(se3_compose(Ti, se3_exp(xi_i)))),
                    se3_compose(Tj, se3_exp(xi_j)))
            )

        zeros = jnp.zeros((6,), _F32)

        def one(Ti, Tj, Tm):
            r = res_one(Ti, Tj, Tm, zeros, zeros)
            Ji = jax.jacfwd(lambda xi: res_one(Ti, Tj, Tm, xi, zeros))(zeros)
            Jj = jax.jacfwd(lambda xi: res_one(Ti, Tj, Tm, zeros, xi))(zeros)
            return r, Ji, Jj

        return jax.vmap(one)(Ti, Tj, Tm)

    E = se3_compose(se3_compose(se3_inverse(Tm), se3_inverse(Ti)), Tj)
    r = se3_log(E)
    Jr_inv = se3_right_jacobian_inv(r)
    Jj = Jr_inv
    Ji = -jnp.matmul(
        Jr_inv, se3_adjoint(se3_compose(se3_inverse(Tj), Ti)),
        precision="highest")
    return r, Ji, Jj


def _edge_normal_blocks(poses, g: PoseGraph):
    """Per-edge Gauss-Newton blocks: H_ii, H_ij, H_jj (E,6,6), b_i, b_j (E,6)."""
    r, Ji, Jj = _edge_jacobians(poses, g)  # (E,6), (E,6,6), (E,6,6)
    info = g.edge_info

    JiT_I = jnp.einsum("eai,eab->eib", Ji, info, precision="highest")
    JjT_I = jnp.einsum("eai,eab->eib", Jj, info, precision="highest")
    H_ii = jnp.einsum("eib,ebj->eij", JiT_I, Ji, precision="highest")
    H_ij = jnp.einsum("eib,ebj->eij", JiT_I, Jj, precision="highest")
    H_jj = jnp.einsum("eib,ebj->eij", JjT_I, Jj, precision="highest")
    b_i = jnp.einsum("eib,eb->ei", JiT_I, r, precision="highest")
    b_j = jnp.einsum("eib,eb->ei", JjT_I, r, precision="highest")
    return H_ii, H_ij, H_jj, b_i, b_j


def _normal_equations(poses, g: PoseGraph):
    """Assemble dense H (6K, 6K), b (6K,) from all edges (vectorized)."""
    k = poses.shape[0]
    H_ii, H_ij, H_jj, b_i, b_j = _edge_normal_blocks(poses, g)

    H = jnp.zeros((k, 6, k, 6), _F32)
    H = H.at[g.edge_i, :, g.edge_i, :].add(H_ii)
    H = H.at[g.edge_j, :, g.edge_j, :].add(H_jj)
    H = H.at[g.edge_i, :, g.edge_j, :].add(H_ij)
    H = H.at[g.edge_j, :, g.edge_i, :].add(jnp.swapaxes(H_ij, -1, -2))
    b = jnp.zeros((k, 6), _F32)
    b = b.at[g.edge_i].add(b_i)
    b = b.at[g.edge_j].add(b_j)
    return H.reshape(6 * k, 6 * k), b.reshape(6 * k)


def _pcg_solve(g, blocks, b, damping, anchor_weight, cg_iters, cg_tol):
    """Matrix-free block-Jacobi preconditioned CG for H delta = b.

    H is never materialized: Hv applies the per-edge 6x6 blocks and
    segment-adds — O(E*36) per product instead of the dense solve's
    O((6K)^3), making K >~ 1000 keyframe graphs tractable (the dense
    (6K,6K) assembly alone is 144 MB at K=1000).  The preconditioner is
    the exact block diagonal of H (per-pose 6x6 inverses, vmapped).
    """
    H_ii, H_ij, H_jj, _, _ = blocks
    k = b.shape[0]
    ei, ej = g.edge_i, g.edge_j
    anchor = jnp.zeros((k, 1), _F32).at[0, 0].set(_F32(anchor_weight))

    def hvp(v):  # v (K, 6)
        vi, vj = v[ei], v[ej]
        yi = (jnp.einsum("eij,ej->ei", H_ii, vi, precision="highest")
              + jnp.einsum("eij,ej->ei", H_ij, vj, precision="highest"))
        yj = (jnp.einsum("eji,ej->ei", H_ij, vi, precision="highest")
              + jnp.einsum("eij,ej->ei", H_jj, vj, precision="highest"))
        y = jnp.zeros((k, 6), _F32).at[ei].add(yi).at[ej].add(yj)
        return y + _F32(damping) * v + anchor * v

    # block-Jacobi preconditioner: exact 6x6 diagonal blocks of H.
    # _batched_inv (closed-form block-Schur, ba.py) instead of
    # jnp.linalg.inv: the batched LU lowers to dynamic control flow and
    # cost ~7 s of compile in the BA solver (ba_bench A/B).
    diag = jnp.zeros((k, 6, 6), _F32).at[g.edge_i].add(H_ii).at[g.edge_j].add(H_jj)
    diag = diag + _F32(damping) * jnp.eye(6, dtype=_F32)[None]
    diag = diag.at[0].add(_F32(anchor_weight) * jnp.eye(6, dtype=_F32))
    m_inv = _batched_inv(diag)

    def prec(r):
        return jnp.einsum("kij,kj->ki", m_inv, r, precision="highest")

    b_norm2 = jnp.sum(b * b)
    tol2 = _F32(cg_tol) ** 2 * jnp.maximum(b_norm2, 1e-30)

    x0 = jnp.zeros_like(b)
    r0 = b
    z0 = prec(r0)
    p0 = z0
    rz0 = jnp.sum(r0 * z0)

    def cond(st):
        _, r, _, _, _, it = st
        return (jnp.sum(r * r) > tol2) & (it < cg_iters)

    def body(st):
        x, r, z, p, rz, it = st
        hp = hvp(p)
        alpha = rz / jnp.maximum(jnp.sum(p * hp), 1e-30)
        x = x + alpha * p
        r = r - alpha * hp
        z = prec(r)
        rz_new = jnp.sum(r * z)
        beta = rz_new / jnp.maximum(rz, 1e-30)
        return x, r, z, z + beta * p, rz_new, it + 1

    x, *_ = jax.lax.while_loop(cond, body, (x0, r0, z0, p0, rz0, jnp.int32(0)))
    return x


def optimize_pose_graph(
    g: PoseGraph,
    iters: int = 10,
    damping: float = 1e-6,
    anchor_weight: float = 1e6,
    solver: str | None = None,
    cg_iters: int | None = None,
    cg_tol: float = 1e-8,
) -> PoseGraph:
    """Gauss-Newton over all poses; pose 0 is gauge-anchored by a prior.

    solver: 'dense' (LU on the assembled (6K, 6K) system), 'cg'
    (matrix-free block-Jacobi PCG — the path for K >~ 500 keyframes
    where dense assembly/solve memory becomes the ceiling), or None to
    choose by K.  cg_iters defaults to 2K: odometry-chain-dominated
    graphs condition like a 1-D Laplacian (kappa ~ K^2), so CG needs
    O(K) products to resolve the sloppy modes.
    """
    k = g.poses.shape[0]
    if solver is None:
        solver = "cg" if k > 384 else "dense"
    if solver not in ("dense", "cg"):
        raise ValueError(f"unknown solver {solver!r}")
    if cg_iters is None:
        cg_iters = min(max(256, 2 * k), 4096)

    def step(poses, _):
        if solver == "dense":
            H, b = _normal_equations(poses, g)
            # gauge fixing: strong prior on pose 0 + Levenberg damping
            anchor = jnp.zeros((6 * k,), _F32).at[:6].set(_F32(anchor_weight))
            H = H + jnp.diag(anchor) + damping * jnp.eye(6 * k, dtype=_F32)
            delta = -jnp.linalg.solve(H, b).reshape(k, 6)
        else:
            blocks = _edge_normal_blocks(poses, g)
            b = jnp.zeros((k, 6), _F32)
            b = b.at[g.edge_i].add(blocks[3]).at[g.edge_j].add(blocks[4])
            delta = -_pcg_solve(g, blocks, b, damping, anchor_weight,
                                cg_iters, cg_tol)
        return se3_compose(poses, se3_exp(delta)), None

    poses, _ = jax.lax.scan(step, g.poses, None, length=iters)
    return g._replace(poses=poses)


def sparsify_pose_graph(g: PoseGraph, max_degree: int = 6) -> PoseGraph:
    """Degree-capped loop-edge pruning for large keyframe graphs.

    Keeps the full odometry chain (|i - j| == 1, the graph's backbone)
    and, per keyframe, at most ``max_degree`` additional loop edges,
    preferring the most informative ones (largest information-matrix
    trace).  Host-side (NumPy) — graph construction happens on host in
    odometry.build_graph; the optimizer then runs on fewer edges, which
    bounds both the CG cost (O(E) per product) and the graph's memory.
    """
    import numpy as np

    ei = np.asarray(g.edge_i)
    ej = np.asarray(g.edge_j)
    info = np.asarray(g.edge_info)
    odo = np.abs(ei - ej) == 1

    w = np.trace(info, axis1=-2, axis2=-1)
    order = np.argsort(-w, kind="stable")  # most informative first
    deg = np.zeros(int(g.poses.shape[0]), np.int32)
    keep = odo.copy()
    for e in order:
        if keep[e]:
            continue
        i, j = int(ei[e]), int(ej[e])
        if deg[i] < max_degree and deg[j] < max_degree:
            keep[e] = True
            deg[i] += 1
            deg[j] += 1

    idx = np.nonzero(keep)[0]
    return PoseGraph(
        poses=g.poses,
        edge_i=jnp.asarray(ei[idx]),
        edge_j=jnp.asarray(ej[idx]),
        edge_T=jnp.asarray(np.asarray(g.edge_T)[idx]),
        edge_info=jnp.asarray(info[idx]),
    )


def ate_rmse(poses: jax.Array, gt_poses: jax.Array) -> jax.Array:
    """Absolute trajectory error (translation RMSE) after aligning the
    first pose (no global alignment; keyframe 0 is the gauge)."""
    align = se3_compose(gt_poses[0], se3_inverse(poses[0]))
    aligned = se3_compose(align[None], poses)
    d = aligned[:, :3, 3] - gt_poses[:, :3, 3]
    return jnp.sqrt(jnp.mean(jnp.sum(d * d, axis=-1)))
