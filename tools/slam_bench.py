#!/usr/bin/env python
"""SLAM end-to-end benchmark: a 100+ keyframe simulated drive through the
full back end, emitting ONE JSON line with ATE + wall time.

Pipeline (BASELINE configs[4], the north-star extension): segmentation ->
ground-constrained ICP odometry -> automatic loop-closure detection ->
degree-capped pose-graph sparsification -> matrix-free PCG optimization ->
landmark bundle adjustment (grid-bucketed association, VERDICT round-1
item 4).  The simulated drive is a closed loop so the detector has real
revisits to find and the ATE measures global consistency, not just local
drift.

Usage:
  python tools/slam_bench.py [--keyframes 100] [--json-out slam_bench.json]
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def simulate_loop_drive(num_frames: int, seed: int = 0,
                        num_pillars: int = 70, noise: float = 0.01,
                        laps: int = 1):
    """Closed circular drive through a pillar world; returns (scans, gt).

    ``laps`` > 1 keeps the per-frame motion (and therefore the ICP
    difficulty) constant as ``num_frames`` grows: the vehicle circles the
    same loop repeatedly, so long runs exercise SOLVER scale (many
    keyframes, many loop closures) rather than an ever-larger world.
    """
    from patchwork_tpu.io.synthetic import simulate_world

    world = simulate_world(seed=seed, num_pillars=num_pillars)
    rng = np.random.default_rng(seed)
    scans, gt = [], []
    pose = np.eye(4, dtype=np.float32)
    yaw_step = 2 * np.pi * laps / num_frames
    for _ in range(num_frames):
        inv = np.linalg.inv(pose).astype(np.float32)
        local = world @ inv[:3, :3].T + inv[:3, 3]
        local = local + rng.normal(0, noise, local.shape).astype(np.float32)
        scans.append(local.astype(np.float32))
        gt.append(pose.copy())
        c, s = np.cos(yaw_step), np.sin(yaw_step)
        step = np.eye(4, dtype=np.float32)
        step[:3, :3] = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32)
        step[0, 3] = 0.8
        pose = (pose @ step).astype(np.float32)
    return scans, np.stack(gt)


def run(num_keyframes: int = 100, seed: int = 3, ba_iters: int = 4,
        laps: int | None = None, icp: str = "sequential",
        batch: int = 8, pair_chunk: int = 32,
        max_candidates: int | None = None, map_out: str | None = None,
        log=print):
    from patchwork_tpu import PatchworkConfig
    from patchwork_tpu.core.device import enable_compilation_cache
    from patchwork_tpu.slam import LidarOdometry
    from patchwork_tpu.slam.landmarks import refine_with_ba
    from patchwork_tpu.slam.odometry import OdometryConfig

    enable_compilation_cache()  # one-shot process: reuse XLA compiles

    if laps is None:
        laps = max(1, num_keyframes // 100)   # constant per-frame motion
    scans, gt = simulate_loop_drive(num_keyframes, seed=seed, laps=laps)

    t0 = time.perf_counter()
    odo = LidarOdometry(
        patchwork=PatchworkConfig(filtering_radius=80.0, max_levels=1),
        cfg=OdometryConfig(capacity=32768, obstacle_samples=1024,
                           ground_samples=512, icp_iters=12),
    )
    # batched front end: vmapped segmentation+downsample in chunks.
    # icp='sequential' keeps the exact constant-velocity chain;
    # icp='parallel' solves all consecutive pairs vmapped (identity init +
    # selective warm-start retry) — the throughput mode for long sessions.
    odo.add_scans(scans, parallel_icp=(icp == "parallel"),
                  batch=batch, pair_chunk=pair_chunk)
    t_odo = time.perf_counter() - t0

    ate_odo = float(odo.trajectory_error(gt))

    t0 = time.perf_counter()
    # separation gate: half a lap, so lap-over-lap revisits qualify while
    # trajectory-adjacent frames never do; candidate radius widens with
    # lap count (odometric drift accumulates ~1 m/lap before correction)
    accepted = odo.detect_loop_closures(
        radius=3.0 + 0.5 * (laps - 1),
        min_separation=max(10, num_keyframes // laps // 2),
        min_inliers=100,
        max_candidates=max_candidates,  # None: adaptive ~K/3, spread
        pair_chunk=pair_chunk)          # along the trajectory
    t_loops = time.perf_counter() - t0

    t0 = time.perf_counter()
    # degree-capped sparsification + solver auto-select (matrix-free PCG
    # at large K); relinearization count grows with loop count so multi-lap
    # graphs converge
    odo.optimize(iters=max(8, 2 * laps), max_degree=6)
    t_graph = time.perf_counter() - t0
    ate_graph = float(odo.trajectory_error(gt))

    t0 = time.perf_counter()
    ba_detail = {}
    refine_with_ba(odo, iters=ba_iters, timings=ba_detail)
    t_ba = time.perf_counter() - t0
    ate_ba = float(odo.trajectory_error(gt))

    if map_out:
        from patchwork_tpu.slam import save_map_ply

        n_vert = save_map_ply(map_out, odo, voxel=0.5)
        print(f"# map: {n_vert} vertices -> {map_out}", file=sys.stderr)

    total = t_odo + t_loops + t_graph + t_ba
    out = {
        "metric": f"slam_e2e_{num_keyframes}kf_ate_rmse",
        "value": round(min(ate_graph, ate_ba), 4),
        "unit": "m",
        "keyframes": num_keyframes,
        "icp": icp,
        "batch": batch,
        "pair_chunk": pair_chunk,
        "loop_closures": len(accepted),
        "ate_odometry_m": round(ate_odo, 4),
        "ate_posegraph_m": round(ate_graph, 4),
        "ate_ba_m": round(ate_ba, 4),
        "wall_s": round(total, 2),
        "stage_s": {"odometry": round(t_odo, 2), "loops": round(t_loops, 2),
                    "graph": round(t_graph, 2), "ba": round(t_ba, 2)},
        "odometry_detail": getattr(odo, "last_timings", {}),
        "ba_detail": ba_detail,
    }
    log(json.dumps(out))
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--keyframes", type=int, default=100)
    ap.add_argument("--seed", type=int, default=3)
    ap.add_argument("--laps", type=int, default=None,
                    help="loop laps (default keyframes//100: constant "
                         "per-frame motion at any scale)")
    ap.add_argument("--icp", default="sequential",
                    choices=["sequential", "parallel"],
                    help="odometry ICP chain: exact sequential warm-start "
                         "chain, or vmapped parallel pair solves")
    ap.add_argument("--batch", type=int, default=8,
                    help="scans per batched segmentation dispatch")
    ap.add_argument("--pair-chunk", type=int, default=32,
                    help="ICP pair solves per dispatch (parallel mode)")
    ap.add_argument("--max-candidates", type=int, default=None,
                    help="loop-closure candidate budget (default ~K/3)")
    ap.add_argument("--json-out", default=None)
    ap.add_argument("--map-out", default=None,
                    help="write the optimized world-frame map as PLY "
                         "(colored by class, trajectory in blue)")
    args = ap.parse_args()
    out = run(args.keyframes, args.seed, laps=args.laps, icp=args.icp,
              batch=args.batch, pair_chunk=args.pair_chunk,
              max_candidates=args.max_candidates, map_out=args.map_out)
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump(out, f)
    return 0


if __name__ == "__main__":
    sys.exit(main())
