"""Bundle adjustment with Schur-complement reduction, single- and
multi-device.

Problem shape: K keyframe poses (SE(3)) + L landmarks (3D points — e.g.
pillar/feature centroids extracted from the obstacle segmentation),
observations (k, l, p_local): landmark l seen from keyframe k at local
coordinates p_local.  Residual r = T_k^-1 . X_l - p_local.

Solver: Gauss-Newton normal equations

    [ A   B ] [dp]   [ba]
    [ B^T C ] [dx] = [bx]

with C block-diagonal over landmarks (3x3) — eliminated by the Schur
complement S = A - B C^-1 B^T; solve S dp = ba - B C^-1 bx, then
back-substitute dx.  All blocks assemble as vmapped einsums +
segment-sums over the observation array; pose Jacobians come from
``jax.jacfwd`` (exact).

Distributed form (BASELINE.json configs[4], MegBA-style): observations
shard over the mesh's data axis via ``shard_map``; each device reduces
partial (A, B, C, ba, bx) over its shard, a ``psum`` over the mesh
axis combines them, and the (small) reduced solve is replicated.  The
collective payload is O(K^2 + K L) block data — independent of the
observation count.
"""

from __future__ import annotations

import os
from typing import NamedTuple

import jax
import jax.numpy as jnp

from .se3 import se3_apply, se3_compose, se3_exp, se3_inverse

__all__ = ["BAProblem", "ba_residuals", "bundle_adjust", "bundle_adjust_sharded"]

_F32 = jnp.float32


class BAProblem(NamedTuple):
    poses: jax.Array    # (K, 4, 4) world_T_keyframe
    points: jax.Array   # (L, 3) landmark positions (world)
    obs_k: jax.Array    # (O,) int32 keyframe index
    obs_l: jax.Array    # (O,) int32 landmark index
    obs_p: jax.Array    # (O, 3) observed local coordinates
    obs_w: jax.Array    # (O,) observation weights (0 disables)


def ba_residuals(poses, points, prob: BAProblem) -> jax.Array:
    """(O, 3) weighted residuals T_k^-1 X_l - p."""
    Tk = poses[prob.obs_k]
    Xl = points[prob.obs_l]
    local = se3_apply(se3_inverse(Tk), Xl[:, None, :])[:, 0, :]
    return (local - prob.obs_p) * prob.obs_w[:, None]


def _obs_blocks(poses, points, prob: BAProblem):
    """Per-observation residual + Jacobian blocks (Jp (O,3,6), Jx (O,3,3)).

    Impls (PATCHWORK_TPU_BA_JAC): 'analytic' (default) closed-form
    Jacobians of the right-perturbation residual — for T' = T.exp(xi),
    xi = (v, omega), y = R^T (X - t): dr/dv = -w I, dr/domega = w [y]x,
    dr/dX = w R^T (three tiny einsums, no exp-map chain in the jaxpr);
    'jacfwd' differentiates through se3_exp/compose/inverse/apply with
    forward-mode AD (the original path, kept as the differential oracle —
    tests/test_ba.py asserts both agree).  A/B on hardware with
    tools/ba_bench.py before changing the default (CLAUDE.md rule).
    """
    if os.environ.get("PATCHWORK_TPU_BA_JAC", "analytic") == "jacfwd":
        def one(Tk, Xl, p, w):
            def res(xi, dx):
                T = se3_compose(Tk, se3_exp(xi))
                return (se3_apply(se3_inverse(T), (Xl + dx)[None, :])[0] - p) * w

            z6 = jnp.zeros((6,), _F32)
            z3 = jnp.zeros((3,), _F32)
            r = res(z6, z3)
            Jp = jax.jacfwd(res, argnums=0)(z6, z3)  # (3, 6)
            Jx = jax.jacfwd(res, argnums=1)(z6, z3)  # (3, 3)
            return r, Jp, Jx

        return jax.vmap(one)(
            poses[prob.obs_k], points[prob.obs_l], prob.obs_p, prob.obs_w
        )

    Tk = poses[prob.obs_k]                       # (O, 4, 4)
    R = Tk[:, :3, :3]
    w = prob.obs_w[:, None]
    y = jnp.einsum("oij,oi->oj", R, points[prob.obs_l] - Tk[:, :3, 3],
                   precision="highest")          # R^T (X - t): local coords
    r = (y - prob.obs_p) * w

    o = jnp.zeros_like(y[:, 0])
    skew_y = jnp.stack([
        jnp.stack([o, -y[:, 2], y[:, 1]], axis=-1),
        jnp.stack([y[:, 2], o, -y[:, 0]], axis=-1),
        jnp.stack([-y[:, 1], y[:, 0], o], axis=-1),
    ], axis=-2)                                  # (O, 3, 3) [y]x
    eye = jnp.broadcast_to(jnp.eye(3, dtype=_F32), skew_y.shape)
    Jp = jnp.concatenate([-eye, skew_y], axis=-1) * w[:, :, None]  # (O, 3, 6)
    Jx = jnp.swapaxes(R, -1, -2) * w[:, :, None]                   # (O, 3, 3)
    return r, Jp, Jx


def _partial_normal_eqs(poses, points, prob: BAProblem, k: int, l: int):
    """Assemble (A, B, C, ba, bx) from (a shard of) the observations."""
    r, Jp, Jx = _obs_blocks(poses, points, prob)

    A = jnp.zeros((k, 6, 6), _F32).at[prob.obs_k].add(
        jnp.einsum("oai,oaj->oij", Jp, Jp, precision="highest")
    )
    C = jnp.zeros((l, 3, 3), _F32).at[prob.obs_l].add(
        jnp.einsum("oai,oaj->oij", Jx, Jx, precision="highest")
    )
    B = jnp.zeros((k, 6, l, 3), _F32).at[prob.obs_k, :, prob.obs_l, :].add(
        jnp.einsum("oai,oaj->oij", Jp, Jx, precision="highest")
    )
    ba = jnp.zeros((k, 6), _F32).at[prob.obs_k].add(
        jnp.einsum("oai,oa->oi", Jp, r, precision="highest")
    )
    bx = jnp.zeros((l, 3), _F32).at[prob.obs_l].add(
        jnp.einsum("oai,oa->oi", Jx, r, precision="highest")
    )
    return A, B, C, ba, bx


def _schur_solve(A, B, C, ba, bx, k, l, damping, anchor_weight):
    """Eliminate landmarks, solve reduced pose system, back-substitute."""
    C = C + damping * jnp.eye(3, dtype=_F32)[None]
    C_inv = _batched_inv(C)  # (L, 3, 3) closed-form (see _inv3x3)

    # S = A_dense - B C^-1 B^T over the pose-pair structure
    BCi = jnp.einsum("kilc,lcd->kild", B, C_inv, precision="highest")
    S = -jnp.einsum("kild,mjld->kimj", BCi, B, precision="highest")
    S = S.at[jnp.arange(k), :, jnp.arange(k), :].add(A)
    rhs = ba - jnp.einsum("kild,ld->ki", BCi, bx, precision="highest")

    S = S.reshape(6 * k, 6 * k)
    anchor = jnp.zeros((6 * k,), _F32).at[:6].set(_F32(anchor_weight))
    S = S + jnp.diag(anchor) + damping * jnp.eye(6 * k, dtype=_F32)
    dp = -jnp.linalg.solve(S, rhs.reshape(6 * k)).reshape(k, 6)

    # back-substitute landmarks: dx = -C^-1 (bx + B^T dp)
    bTdp = jnp.einsum("kild,ki->ld", B, dp, precision="highest")
    dx = -jnp.einsum("lcd,ld->lc", C_inv, bx + bTdp, precision="highest")
    return dp, dx


# segment-sum impl of the PCG matvecs on every platform (_make_seg_sums):
# deterministic, and on an H100 within 11 ms per K=1000 solve of the
# fastest ('scatter'; PERF.md)
SEG_SUM_IMPL = "sort"

# direct (n, O) one-hot indicator budget; beyond it the 'onehot' segment
# sums scan over fixed observation chunks (tests/benches force chunking
# by lowering this via env or monkeypatch)
_ONEHOT_DIRECT_BYTES = int(
    os.environ.get("PATCHWORK_TPU_BA_ONEHOT_DIRECT", 400_000_000))


def _inv3x3(m: jax.Array) -> jax.Array:
    """Batched closed-form 3x3 inverse (adjugate / det).

    jnp.linalg.inv lowers through a batched LU with dynamic control
    flow; for the tiny PD blocks of the Schur solver the adjugate form
    is branch-free straight-line code (PATCHWORK_TPU_BA_INV
    knob; A/B with tools/ba_bench.py before changing the default)."""
    a, b, c = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    d, e, f = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    g, h, i = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    A = e * i - f * h
    B = -(d * i - f * g)
    C = d * h - e * g
    det = a * A + b * B + c * C
    inv_det = 1.0 / det
    adj = jnp.stack([
        jnp.stack([A, -(b * i - c * h), b * f - c * e], axis=-1),
        jnp.stack([B, a * i - c * g, -(a * f - c * d)], axis=-1),
        jnp.stack([C, -(a * h - b * g), a * e - b * d], axis=-1),
    ], axis=-2)
    return adj * inv_det[..., None, None]


def _inv6x6(m: jax.Array) -> jax.Array:
    """Batched 6x6 inverse via the 2x2-of-3x3 block Schur complement —
    every sub-inverse is the branch-free :func:`_inv3x3` (valid for the
    PD pose blocks this solver inverts)."""
    def mm(a, b):  # full f32: a default-precision f32 matmul may run in TF32
        return jnp.matmul(a, b, precision="highest")

    P, Q = m[..., :3, :3], m[..., :3, 3:]
    R, S = m[..., 3:, :3], m[..., 3:, 3:]
    Pi = _inv3x3(P)
    RPi = mm(R, Pi)
    D = S - mm(RPi, Q)
    Di = _inv3x3(D)
    PiQ = mm(Pi, Q)
    tl = Pi + mm(mm(PiQ, Di), RPi)
    tr = -mm(PiQ, Di)
    bl = -mm(Di, RPi)
    top = jnp.concatenate([tl, tr], axis=-1)
    bot = jnp.concatenate([bl, Di], axis=-1)
    return jnp.concatenate([top, bot], axis=-2)


def _batched_inv(m: jax.Array) -> jax.Array:
    """Impl-selectable batched small-matrix inverse ((...,3,3) or (...,6,6))."""
    if os.environ.get("PATCHWORK_TPU_BA_INV", "closed") == "lapack":
        return jnp.linalg.inv(m)
    return _inv3x3(m) if m.shape[-1] == 3 else _inv6x6(m)


def _make_seg_sums(idx: jax.Array, n: int, impl: str = SEG_SUM_IMPL):
    """Segment-sum closure for a fixed index vector, impl-selectable.

    The PCG matvec is two segment reductions per application, so this is
    the solver's inner loop.  Impls (A/B with tools/ba_bench.py --seg):

    * 'sort' (default, every platform): sort the observations once per
      index vector; every segment reduction becomes gather + cumsum + two
      boundary gathers.  The argsort / searchsorted are loop-invariant:
      XLA hoists them out of the CG while_loop and the GN scan.
      Deterministic (no atomics).  Caveat: the global f32 prefix sum can
      catastrophically cancel for very large O with wide-magnitude values.
    * 'onehot': materialize the (n, O) one-hot indicator once (loop-
      invariant, trace-time closure) and reduce every segment sum as ONE
      matmul, chunked over observations above a memory budget.  f32-exact:
      one-hot rows select, never mix, so precision='highest' matmul
      accumulation matches a per-segment tree reduce.
    * 'scatter': plain '.at[].add' (XLA scatter-add) — the golden path.
    """
    if impl == "scatter":
        def seg_sum(vals):  # (O, ...) -> (n, ...)
            return jnp.zeros((n,) + vals.shape[1:], vals.dtype).at[idx].add(vals)

        return seg_sum

    if impl == "onehot":
        o = int(idx.shape[0])
        seg_ids = jnp.arange(n, dtype=idx.dtype)
        if n * o * 4 <= _ONEHOT_DIRECT_BYTES:
            oh = (idx[None, :] == seg_ids[:, None]).astype(_F32)
            # (n, O), built once at trace time (loop-invariant: XLA hoists
            # it out of the CG while_loop and the GN scan)

            def seg_sum(vals):  # (O, ...) -> (n, ...)
                flat = vals.reshape(vals.shape[0], -1)
                out = jnp.matmul(oh, flat, precision="highest")
                return out.reshape((n,) + vals.shape[1:])

            return seg_sum

        # Large O: the full (n, O) indicator would not fit — scan over fixed-size
        # observation chunks, building each chunk's (n, CH) one-hot
        # inside the scan body.  Compile stays small (one chunk's jaxpr),
        # memory is O(n * CH), and each chunk is still one matmul.
        ch = 16384
        pad = (-o) % ch
        idx_p = jnp.concatenate(
            [idx, jnp.full((pad,), n, idx.dtype)]) if pad else idx
        idx_c = idx_p.reshape(-1, ch)

        def seg_sum(vals):  # (O, ...) -> (n, ...)
            flat = vals.reshape(o, -1)
            if pad:
                flat = jnp.concatenate(
                    [flat, jnp.zeros((pad, flat.shape[1]), flat.dtype)])
            v_c = flat.reshape(-1, ch, flat.shape[1])

            def body(acc, xs):
                ic, vc = xs
                oh = (ic[None, :] == seg_ids[:, None]).astype(_F32)
                return acc + jnp.matmul(oh, vc, precision="highest"), None

            acc0 = jnp.zeros((n, flat.shape[1]), _F32)
            out, _ = jax.lax.scan(body, acc0, (idx_c, v_c))
            return out.reshape((n,) + vals.shape[1:])

        return seg_sum

    perm = jnp.argsort(idx)
    sorted_idx = idx[perm]
    seg = jnp.arange(n, dtype=idx.dtype)
    starts = jnp.searchsorted(sorted_idx, seg, side="left")
    ends = jnp.searchsorted(sorted_idx, seg, side="right")

    def seg_sum(vals):  # (O, ...) in original obs order -> (n, ...)
        v = vals[perm]
        c = jnp.cumsum(v, axis=0)
        c = jnp.concatenate(
            [jnp.zeros((1,) + v.shape[1:], v.dtype), c], axis=0)
        return c[ends] - c[starts]

    return seg_sum


def _schur_pcg_step(poses, points, prob: BAProblem, k, l, damping,
                    anchor_weight, cg_iters, cg_tol, axis=None,
                    seg_impl: str = SEG_SUM_IMPL):
    """One Gauss-Newton step with the reduced pose system solved by
    MATRIX-FREE preconditioned CG — nothing of size O(K*L) is ever
    materialized (the dense path's ``B (K,6,L,3)`` block is 2.8 GB at
    K=1000/L=40k, and applying C^-1 to it materializes another O(K*L)
    broadcast).  Every S-matvec is four
    per-observation gathers/segment-sums + the block-diagonal terms:
    O(O) work and memory, MegBA-style.

    ``axis``: inside shard_map, the mesh axis observations are sharded
    over — every per-observation reduction is psum-combined so all
    devices run the identical (replicated) CG iteration; the collective
    payload per matvec is O(K + L) block data, observation-independent.
    """
    red = (lambda x: jax.lax.psum(x, axis)) if axis is not None else (lambda x: x)
    r, Jp, Jx = _obs_blocks(poses, points, prob)
    eye3 = jnp.eye(3, dtype=_F32)
    eye6 = jnp.eye(6, dtype=_F32)
    seg_k = _make_seg_sums(prob.obs_k, k, seg_impl)
    seg_l = _make_seg_sums(prob.obs_l, l, seg_impl)

    A = red(seg_k(jnp.einsum("oai,oaj->oij", Jp, Jp, precision="highest")))
    C = red(seg_l(jnp.einsum("oai,oaj->oij", Jx, Jx, precision="highest")))
    C_inv = _batched_inv(C + damping * eye3[None])
    W = jnp.einsum("oai,oaj->oij", Jp, Jx, precision="highest")  # (O,6,3)
    ba = red(seg_k(jnp.einsum("oai,oa->oi", Jp, r, precision="highest")))
    bx = red(seg_l(jnp.einsum("oai,oa->oi", Jx, r, precision="highest")))

    cb = jnp.einsum("lcd,ld->lc", C_inv, bx, precision="highest")
    rhs = ba - red(seg_k(
        jnp.einsum("oic,oc->oi", W, cb[prob.obs_l], precision="highest")))

    anchor = jnp.zeros((k,), _F32).at[0].set(_F32(anchor_weight))

    def hvp(v):  # v (K,6) -> S v, never forming S
        av = (jnp.einsum("kij,kj->ki", A, v, precision="highest")
              + damping * v + anchor[:, None] * v)
        y = red(seg_l(
            jnp.einsum("oic,oi->oc", W, v[prob.obs_k], precision="highest")))
        z = jnp.einsum("lcd,ld->lc", C_inv, y, precision="highest")
        bz = red(seg_k(
            jnp.einsum("oic,oc->oi", W, z[prob.obs_l], precision="highest")))
        return av - bz

    # block-Jacobi preconditioner from the (always PD) A + damping + anchor
    M_inv = _batched_inv(
        A + (damping + anchor[:, None, None]) * eye6[None])

    def prec(res):
        return jnp.einsum("kij,kj->ki", M_inv, res, precision="highest")

    b_norm2 = jnp.sum(rhs * rhs)
    tol2 = _F32(cg_tol) ** 2 * jnp.maximum(b_norm2, 1e-30)
    x0 = jnp.zeros((k, 6), _F32)
    r0 = rhs
    z0 = prec(r0)

    def cond(st):
        _, res, *_, it = st
        return (jnp.sum(res * res) > tol2) & (it < cg_iters)

    def body(st):
        x, res, z, p, rz, it = st
        sp_ = hvp(p)
        alpha = rz / jnp.maximum(jnp.sum(p * sp_), 1e-30)
        x = x + alpha * p
        res = res - alpha * sp_
        z = prec(res)
        rz_new = jnp.sum(res * z)
        p = z + (rz_new / jnp.maximum(rz, 1e-30)) * p
        return x, res, z, p, rz_new, it + 1

    x, *_ = jax.lax.while_loop(
        cond, body, (x0, r0, z0, z0, jnp.sum(r0 * z0), jnp.int32(0)))
    dp = -x

    y = red(seg_l(
        jnp.einsum("oic,oi->oc", W, dp[prob.obs_k], precision="highest")))
    dx = -jnp.einsum("lcd,ld->lc", C_inv, bx + y, precision="highest")
    return dp, dx


# dense-B block-assembly budget: above this many (pose, landmark) cells the
# O(K*L) blocks would not fit (or compile) on a single chip -> matrix-free
_DENSE_KL_LIMIT = 1_000_000
# dense reduced-solve budget: the direct solve factorizes the (6K, 6K)
# Schur complement at O((6K)^3) — at K=1000 that is ~2e11 FLOPs of LU per
# GN iteration regardless of L.  (Found in round 5: better loop closures
# merged landmarks 1236 -> 414 at 1000 kf, K*L dropped under the KL limit,
# and the auto-select silently flipped a 8 s PCG solve into a 27 s dense
# one.)  Auto-select takes dense only when BOTH budgets pass.
_DENSE_K_LIMIT = 256


def _auto_solver(k: int, l: int) -> str:
    return ("dense" if k * l <= _DENSE_KL_LIMIT and k <= _DENSE_K_LIMIT
            else "pcg")


def bundle_adjust(
    prob: BAProblem,
    iters: int = 8,
    damping: float = 1e-4,
    anchor_weight: float = 1e6,
    solver: str | None = None,
    cg_iters: int | None = None,
    cg_tol: float = 1e-6,
    seg_impl: str = SEG_SUM_IMPL,
) -> BAProblem:
    """Single-device Schur-complement Gauss-Newton BA.

    solver: 'dense' (explicit B / S, direct solve — exact, small
    problems), 'pcg' (matrix-free Schur matvecs + block-Jacobi CG —
    O(observations) memory, any scale), or None to auto-select by the
    K*L block count (dense below _DENSE_KL_LIMIT).  seg_impl: the PCG
    path's segment sums (:func:`_make_seg_sums`).
    """
    k = prob.poses.shape[0]
    l = prob.points.shape[0]
    if solver is None:
        solver = _auto_solver(k, l)
    if cg_iters is None:
        cg_iters = min(max(128, k), 2048)

    def step(state, _):
        poses, points = state
        if solver == "dense":
            A, B, C, ba, bx = _partial_normal_eqs(poses, points, prob, k, l)
            dp, dx = _schur_solve(A, B, C, ba, bx, k, l, damping,
                                  anchor_weight)
        else:
            dp, dx = _schur_pcg_step(poses, points, prob, k, l, damping,
                                     anchor_weight, cg_iters, cg_tol,
                                     seg_impl=seg_impl)
        return (se3_compose(poses, se3_exp(dp)), points + dx), None

    (poses, points), _ = jax.lax.scan(
        step, (prob.poses, prob.points), None, length=iters
    )
    return prob._replace(poses=poses, points=points)


def bundle_adjust_sharded(
    prob: BAProblem,
    mesh,
    axis: str = "dp",
    iters: int = 8,
    damping: float = 1e-4,
    anchor_weight: float = 1e6,
    solver: str | None = None,
    cg_iters: int | None = None,
    cg_tol: float = 1e-6,
) -> BAProblem:
    """Distributed BA: observations shard over ``axis``; each device
    reduces partial normal equations, psum combines them over the
    mesh axis, the reduced solve is replicated.  Observation count must be
    divisible by the axis size (pad with obs_w = 0).

    solver follows bundle_adjust: 'dense' psums the explicit blocks
    (O(K*L) payload), 'pcg' psums per-observation reductions inside the
    matrix-free CG (O(K + L) payload per matvec), None auto-selects.
    """
    from jax.sharding import PartitionSpec as P

    k = prob.poses.shape[0]
    l = prob.points.shape[0]
    if solver is None:
        solver = _auto_solver(k, l)
    if cg_iters is None:
        cg_iters = min(max(128, k), 2048)

    def step_sharded(poses, points, obs_k, obs_l, obs_p, obs_w):
        shard = BAProblem(poses, points, obs_k, obs_l, obs_p, obs_w)
        if solver == "dense":
            parts = _partial_normal_eqs(poses, points, shard, k, l)
            A, B, C, ba, bx = jax.lax.psum(parts, axis)
            dp, dx = _schur_solve(A, B, C, ba, bx, k, l, damping,
                                  anchor_weight)
        else:
            dp, dx = _schur_pcg_step(poses, points, shard, k, l, damping,
                                     anchor_weight, cg_iters, cg_tol,
                                     axis=axis)
        return se3_compose(poses, se3_exp(dp)), points + dx

    smapped = jax.shard_map(
        step_sharded,
        mesh=mesh,
        in_specs=(P(), P(), P(axis), P(axis), P(axis), P(axis)),
        out_specs=(P(), P()),
        check_vma=False,
    )

    @jax.jit
    def run(poses, points, ok, ol, op, ow):
        def body(state, _):
            p, x = state
            return smapped(p, x, ok, ol, op, ow), None

        (p, x), _ = jax.lax.scan(body, (poses, points), None, length=iters)
        return p, x

    poses, points = run(
        prob.poses, prob.points, prob.obs_k, prob.obs_l, prob.obs_p, prob.obs_w
    )
    return prob._replace(poses=poses, points=points)
