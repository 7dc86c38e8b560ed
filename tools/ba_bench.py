#!/usr/bin/env python
"""Isolated bundle-adjustment solver benchmark: attribute the BA stage.

The end-to-end SLAM bench folds host association, problem build, jit
compile, and the actual solve into one "ba" stage number; this tool
separates them so a kernel change can be judged on the part it touches
(A/B on the card, in one process).  Builds a synthetic
problem at the 1000-keyframe scale (circular trajectory over a pillar
world — the same shape tools/slam_bench.py produces), then reports

  build_s    host-side problem construction (numpy)
  compile_s  first jitted call (trace + XLA compile + first run)
  solve_s    steady-state per-solve wall, around block_until_ready

for the selected segment-sum impl (--seg: sort / onehot / scatter;
default slam/ba.SEG_SUM_IMPL) and solver.  One JSON line on stdout.

Usage:
  python tools/ba_bench.py [--k 1000] [--landmarks 300] [--obs-per-kf 40]
                           [--iters 4] [--seg sort] [--solver pcg]
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def synth_problem(k: int, n_landmarks: int, obs_per_kf: int, seed: int = 0):
    """Circular-drive BA problem mirroring slam_bench's regime."""
    from patchwork_tpu.slam.ba import BAProblem
    import jax.numpy as jnp

    rng = np.random.default_rng(seed)
    # pillar landmarks on an annulus around the loop
    ang = rng.uniform(0, 2 * np.pi, n_landmarks)
    rad = rng.uniform(5.0, 25.0, n_landmarks)
    points = np.stack(
        [rad * np.cos(ang), rad * np.sin(ang),
         rng.uniform(0.5, 3.0, n_landmarks)], axis=1).astype(np.float32)

    # poses on a circle (radius ~ loop of slam_bench)
    t = np.linspace(0, 2 * np.pi, k, endpoint=False)
    poses = np.tile(np.eye(4, dtype=np.float32), (k, 1, 1))
    c, s = np.cos(t), np.sin(t)
    poses[:, 0, 0] = c; poses[:, 0, 1] = -s
    poses[:, 1, 0] = s; poses[:, 1, 1] = c
    poses[:, 0, 3] = 12.0 * c
    poses[:, 1, 3] = 12.0 * s

    # each keyframe observes its obs_per_kf nearest landmarks
    obs_k, obs_l, obs_p = [], [], []
    for i in range(k):
        d = np.linalg.norm(points[:, :2] - poses[i, :2, 3], axis=1)
        near = np.argsort(d)[:obs_per_kf]
        R, tt = poses[i, :3, :3], poses[i, :3, 3]
        local = (points[near] - tt) @ R
        local += rng.normal(0, 0.02, local.shape)
        obs_k.append(np.full(obs_per_kf, i, np.int32))
        obs_l.append(near.astype(np.int32))
        obs_p.append(local.astype(np.float32))
    obs_k = np.concatenate(obs_k)
    obs_l = np.concatenate(obs_l)
    obs_p = np.concatenate(obs_p)
    # perturb initial poses (what BA must correct)
    poses_init = poses.copy()
    poses_init[:, 0, 3] += rng.normal(0, 0.3, k).astype(np.float32)
    poses_init[:, 1, 3] += rng.normal(0, 0.3, k).astype(np.float32)
    return BAProblem(
        jnp.asarray(poses_init), jnp.asarray(points),
        jnp.asarray(obs_k), jnp.asarray(obs_l), jnp.asarray(obs_p),
        jnp.asarray(np.ones(len(obs_k), np.float32)))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--k", type=int, default=1000)
    ap.add_argument("--landmarks", type=int, default=300)
    ap.add_argument("--obs-per-kf", type=int, default=40)
    ap.add_argument("--iters", type=int, default=4)
    ap.add_argument("--seg", default=None,
                    choices=[None, "sort", "onehot", "scatter"])
    ap.add_argument("--jac", default=None, choices=[None, "analytic", "jacfwd"])
    ap.add_argument("--inv", default=None, choices=[None, "closed", "lapack"])
    ap.add_argument("--solver", default="pcg", choices=["pcg", "dense"])
    ap.add_argument("--cg-iters", type=int, default=None)
    ap.add_argument("--reps", type=int, default=2)
    args = ap.parse_args()
    if args.jac:
        os.environ["PATCHWORK_TPU_BA_JAC"] = args.jac
    if args.inv:
        os.environ["PATCHWORK_TPU_BA_INV"] = args.inv

    import jax
    from patchwork_tpu.core.device import enable_compilation_cache
    from patchwork_tpu.slam.ba import SEG_SUM_IMPL, bundle_adjust, ba_residuals

    enable_compilation_cache()

    t0 = time.perf_counter()
    prob = synth_problem(args.k, args.landmarks, args.obs_per_kf)
    build_s = time.perf_counter() - t0

    seg = args.seg or SEG_SUM_IMPL
    fn = jax.jit(lambda p: bundle_adjust(
        p, iters=args.iters, solver=args.solver, cg_iters=args.cg_iters,
        seg_impl=seg))

    t0 = time.perf_counter()
    out = jax.block_until_ready(fn(prob))
    compile_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    for _ in range(args.reps):
        out = fn(prob)
    jax.block_until_ready(out)
    solve_s = (time.perf_counter() - t0) / args.reps

    r0 = float(np.abs(np.asarray(
        ba_residuals(prob.poses, prob.points, prob))).mean())
    r1 = float(np.abs(np.asarray(
        ba_residuals(out.poses, out.points, prob))).mean())

    print(json.dumps({
        "metric": "ba_solve_s",
        "value": round(solve_s, 3),
        "unit": "s",
        "platform": jax.devices()[0].platform,
        "device_kind": jax.devices()[0].device_kind,
        "k": args.k, "landmarks": args.landmarks,
        "obs": int(prob.obs_k.shape[0]),
        "solver": args.solver,
        "seg": seg,
        "jac": os.environ.get("PATCHWORK_TPU_BA_JAC", "analytic"),
        "inv": os.environ.get("PATCHWORK_TPU_BA_INV", "closed"),
        "iters": args.iters,
        "build_s": round(build_s, 3),
        "compile_s": round(compile_s, 3),
        "mean_abs_residual_before": round(r0, 5),
        "mean_abs_residual_after": round(r1, 5),
    }))


if __name__ == "__main__":
    sys.exit(main())
