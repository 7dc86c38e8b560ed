"""Ground-constrained scan matching (frame-to-frame LiDAR odometry).

Design:

* correspondences by brute-force nearest neighbor over voxel-downsampled
  obstacle points — the (N, M) squared-distance matrix is ONE matmul
  (|p-q|^2 = |p|^2 + |q|^2 - 2 p.q), the array-program alternative to
  k-d trees (pointer chasing does not vectorize);
* residuals: point-to-point on obstacle correspondences (constrain x, y,
  yaw) + point-to-plane against the target's GROUND plane from the
  Patchwork segmentation (constrain z, roll, pitch) — the segmentation
  engine is what makes the odometry "ground-constrained";
* Gauss-Newton on SE(3) with right perturbation; the 6-dof Jacobian is
  the closed form R [I | -[s]x] (point-to-point) / [(R^T n)^T, (g x
  R^T n)^T] (point-to-plane) — ``jax.jacfwd`` through the residual is
  kept as the differential oracle (PATCHWORK_TPU_ICP_JAC=jacfwd; the AD
  chain's jaxpr compiles far slower, as measured in ba_bench);
  fixed iteration count under ``lax.scan``.
"""

from __future__ import annotations

import os
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..ops.geometry import fit_plane_masked
from .se3 import se3_apply, se3_compose, se3_exp

__all__ = ["MatchResult", "nearest_neighbors", "icp_ground_constrained"]

_F32 = jnp.float32

# Gauss-Newton Jacobian impl: 'analytic' closed form (default) or the
# forward-mode AD oracle; see the branch inside icp_ground_constrained.
_ANALYTIC_JAC = os.environ.get("PATCHWORK_TPU_ICP_JAC", "analytic") != "jacfwd"
# NN correspondence-search matmul precision (see nearest_neighbors)
_NN_PRECISION = ("default"
                 if os.environ.get("PATCHWORK_TPU_ICP_NN") == "default"
                 else "highest")


class MatchResult(NamedTuple):
    transform: jax.Array      # (4, 4) mapping source frame -> target frame
    num_inliers: jax.Array    # () int32
    rmse: jax.Array           # () float32 inlier point-to-point RMSE


def nearest_neighbors(src: jax.Array, tgt: jax.Array, tgt_valid: jax.Array):
    """Index + squared distance of each src point's nearest valid tgt point.

    One matmul: d2 = |p|^2 + |q|^2 - 2 p.q; invalid targets -> +inf.

    PATCHWORK_TPU_ICP_NN=default opts the cross-term matmul into default
    precision (TF32 on the GPU) — unlike the SE(3) compose bias that
    full precision fixed, a distance error here only swaps near-tied
    NEIGHBORS, which Gauss-Newton is robust to, and the returned d2
    (inlier gating/RMSE) is recomputed exactly from the gathered pair.
    OFF by default until an ATE + loop-closure A/B on the card clears
    it.
    """
    d2 = (
        jnp.sum(src * src, axis=1)[:, None]
        + jnp.sum(tgt * tgt, axis=1)[None, :]
        - 2.0 * jnp.einsum("nc,mc->nm", src, tgt, precision=_NN_PRECISION)
    )
    d2 = jnp.where(tgt_valid[None, :], d2, jnp.inf)
    idx = jnp.argmin(d2, axis=1)
    if _NN_PRECISION == "highest":
        return idx, jnp.take_along_axis(d2, idx[:, None], axis=1)[:, 0]
    # exact squared distance of the CHOSEN pair (gating/RMSE stay f32-
    # exact even when the search matmul ran at reduced precision).
    # If every target is invalid, argmin over an all-inf row returns 0 —
    # keep d2 = inf so the gate rejects the bogus pair (ADVICE r4).
    diff = src - tgt[idx]
    d2_exact = jnp.where(tgt_valid[idx], jnp.sum(diff * diff, axis=1),
                         jnp.inf)
    return idx, d2_exact


def icp_ground_constrained(
    src_obst: jax.Array,       # (N, 3) source obstacle points (padded)
    src_obst_valid: jax.Array, # (N,)
    src_ground: jax.Array,     # (G, 3) source ground points (padded)
    src_ground_valid: jax.Array,
    tgt_obst: jax.Array,       # (M, 3) target obstacle points (padded)
    tgt_obst_valid: jax.Array,
    tgt_ground: jax.Array,     # (G2, 3) target ground points (padded)
    tgt_ground_valid: jax.Array,
    init: jax.Array | None = None,   # (4, 4) initial guess
    iters: int = 12,
    max_corr_dist: float = 2.0,
    ground_weight: float = 1.0,
    coarse_factor: float = 8.0,
) -> MatchResult:
    """Estimate T such that T . src ~= tgt.

    Coarse-to-fine: the correspondence gate anneals geometrically from
    ``coarse_factor * max_corr_dist`` down to ``max_corr_dist`` over the
    iterations, so large initial rotations (which displace far structure
    by r*theta) still find correspondences early, while the final
    iterations reject outliers tightly.
    """
    if init is None:
        init = jnp.eye(4, dtype=_F32)

    # target ground plane (centroid + normal) from the segmentation masks
    g_c, g_n, _, g_cnt = fit_plane_masked(tgt_ground, tgt_ground_valid)
    use_ground = g_cnt >= 3

    anneal = jnp.asarray(
        max_corr_dist
        * (coarse_factor ** (1.0 - jnp.arange(iters, dtype=_F32)
                             / max(iters - 1, 1))),
        _F32,
    )  # coarse_factor*d ... d

    def gn_step(T, gate):
        p = se3_apply(T, src_obst)
        nn_idx, nn_d2 = nearest_neighbors(p, tgt_obst, tgt_obst_valid)
        q = tgt_obst[nn_idx]
        w_obst = (src_obst_valid & (nn_d2 < gate * gate)).astype(_F32)

        pg = se3_apply(T, src_ground)
        w_ground = src_ground_valid.astype(_F32) * use_ground.astype(_F32) * _F32(
            ground_weight
        )

        if _ANALYTIC_JAC:
            # closed-form right-perturbation Jacobians (the jacfwd chain
            # through se3_exp/compose/apply compiles far slower, as
            # measured in ba_bench; jacfwd kept below as the
            # differential oracle, PATCHWORK_TPU_ICP_JAC=jacfwd):
            #   d[(T exp(xi)) s]/dxi = R [I | -[s]x]      (s in src frame)
            #   d[n . (T exp(xi)) g]/dxi = [(R^T n)^T, (g x R^T n)^T]
            R = T[:3, :3]
            r_pp = (p - q) * w_obst[:, None]
            r_pl = (jnp.einsum("ni,i->n", pg - g_c, g_n,
                               precision="highest") * w_ground)
            sx = src_obst[:, 0]
            sy = src_obst[:, 1]
            sz = src_obst[:, 2]
            o = jnp.zeros_like(sx)
            skew_s = jnp.stack([
                jnp.stack([o, -sz, sy], axis=-1),
                jnp.stack([sz, o, -sx], axis=-1),
                jnp.stack([-sy, sx, o], axis=-1),
            ], axis=-2)                                     # (N, 3, 3)
            eye = jnp.broadcast_to(jnp.eye(3, dtype=_F32), skew_s.shape)
            Jpp = jnp.concatenate([eye, -skew_s], axis=-1)  # (N, 3, 6)
            Jpp = jnp.einsum("ij,njk->nik", R, Jpp,
                             precision="highest") * w_obst[:, None, None]
            nR = jnp.einsum("ij,i->j", R, g_n, precision="highest")  # R^T n
            Jpl = jnp.concatenate([
                jnp.broadcast_to(nR, src_ground.shape),
                jnp.cross(src_ground, jnp.broadcast_to(nR, src_ground.shape)),
            ], axis=-1) * w_ground[:, None]                 # (G, 6)
            H = (jnp.einsum("nik,nil->kl", Jpp, Jpp, precision="highest")
                 + jnp.einsum("gk,gl->kl", Jpl, Jpl, precision="highest"))
            b = (jnp.einsum("nik,ni->k", Jpp, r_pp, precision="highest")
                 + jnp.einsum("gk,g->k", Jpl, r_pl, precision="highest"))
        else:
            def residuals(xi):
                Txi = se3_compose(T, se3_exp(xi))
                r_pp = (se3_apply(Txi, src_obst) - q) * w_obst[:, None]
                r_pl = (
                    jnp.einsum("ni,i->n", se3_apply(Txi, src_ground) - g_c,
                               g_n, precision="highest")
                    * w_ground
                )  # (G,)
                return jnp.concatenate([r_pp.ravel(), r_pl])

            xi0 = jnp.zeros((6,), _F32)
            r0 = residuals(xi0)
            J = jax.jacfwd(residuals)(xi0)  # (R, 6)
            H = jnp.einsum("ri,rj->ij", J, J, precision="highest")
            b = jnp.einsum("ri,r->i", J, r0, precision="highest")
        # Levenberg damping for robustness on poor geometry
        H = H + 1e-4 * jnp.eye(6, dtype=_F32) * jnp.maximum(jnp.trace(H) / 6.0, 1.0)
        delta = -jnp.linalg.solve(H, b)
        T_new = se3_compose(T, se3_exp(delta))

        n_in = jnp.sum(w_obst).astype(jnp.int32)
        rmse = jnp.sqrt(
            jnp.sum(nn_d2 * w_obst) / jnp.maximum(jnp.sum(w_obst), 1.0)
        )
        return T_new, (n_in, rmse)

    T, (n_in, rmse) = jax.lax.scan(gn_step, init, anneal)
    return MatchResult(transform=T, num_inliers=n_in[-1], rmse=rmse[-1])
