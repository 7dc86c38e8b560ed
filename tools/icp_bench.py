"""ICP-stage attribution: compile vs run vs dispatch/transfer overhead.

VERDICT r4 item 3: the parallel-ICP chain is the largest compute stage of
the 1000-kf SLAM run (25-30 s in the v9/r5 runs) and never got the
compile/run/transfer breakdown that fixed BA (78.5 -> 14.3 s).  This tool
isolates, for the real odometry shapes (2048 obstacle + 1024 ground
samples per frame, pair_chunk vmapped ICPs per dispatch):

  * compile_s        — first-call XLA compile of the vmapped pair solver
  * kernel_s_per_pair — steady-state rate, inputs pre-gathered + resident
                        (slope-timed: (t(2R)-t(R))/R cancels fetch costs)
  * whole_pass_overhead_s — the _solve_pairs path as production runs it
                        (one lax.map dispatch over a (C, chunk) grid +
                        one fetch), minus the kernel time of the pairs
                        actually solved -> dispatch/fetch/map overhead
  * e2e_icp_s        — LidarOdometry._ingest_parallel on K synthetic
                        feature frames (the production code path)

Usage (GPU):  python tools/icp_bench.py --frames 250 --pair-chunk 32
CPU check:    JAX_PLATFORMS=cpu python tools/icp_bench.py --frames 64
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def synth_features(k: int, n_obst: int, n_ground: int, seed: int = 0):
    """K consecutive-frame feature sets with known inter-frame motion."""
    rng = np.random.default_rng(seed)
    # one world of pillars + ground, viewed from a moving pose
    n_pil = 40
    centers = rng.uniform(-40, 40, (n_pil, 2))
    obst_w = np.empty((n_obst * 4, 3), np.float32)
    pick = rng.integers(0, n_pil, len(obst_w))
    obst_w[:, 0] = centers[pick, 0] + rng.normal(0, 0.2, len(obst_w))
    obst_w[:, 1] = centers[pick, 1] + rng.normal(0, 0.2, len(obst_w))
    obst_w[:, 2] = rng.uniform(0.3, 2.5, len(obst_w))
    gnd_w = np.empty((n_ground * 4, 3), np.float32)
    gnd_w[:, 0] = rng.uniform(-50, 50, len(gnd_w))
    gnd_w[:, 1] = rng.uniform(-50, 50, len(gnd_w))
    gnd_w[:, 2] = rng.normal(0, 0.02, len(gnd_w))

    obst = np.empty((k, n_obst, 3), np.float32)
    gnd = np.empty((k, n_ground, 3), np.float32)
    pose = np.eye(4)
    for i in range(k):
        inv = np.linalg.inv(pose)
        ow = obst_w[rng.choice(len(obst_w), n_obst, replace=False)]
        gw = gnd_w[rng.choice(len(gnd_w), n_ground, replace=False)]
        obst[i] = (ow @ inv[:3, :3].T + inv[:3, 3]).astype(np.float32)
        gnd[i] = (gw @ inv[:3, :3].T + inv[:3, 3]).astype(np.float32)
        yaw = 0.02
        c, s = np.cos(yaw), np.sin(yaw)
        step = np.eye(4)
        step[:3, :3] = [[c, -s, 0], [s, c, 0], [0, 0, 1]]
        step[0, 3] = 0.8
        pose = pose @ step
    return obst, gnd


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=250)
    ap.add_argument("--pair-chunk", type=int, default=32)
    ap.add_argument("--reps", type=int, default=4)
    ap.add_argument("--json-out", default=None)
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    from patchwork_tpu.core.device import enable_compilation_cache
    from patchwork_tpu.slam.odometry import LidarOdometry, OdometryConfig

    enable_compilation_cache()

    cfg = OdometryConfig()
    odo = LidarOdometry(cfg=cfg)
    k, pc = args.frames, args.pair_chunk

    obst, gnd = synth_features(k, cfg.obstacle_samples, cfg.ground_samples)
    stacked = {
        "obst": jnp.asarray(obst),
        "obst_valid": jnp.ones(obst.shape[:2], bool),
        "ground": jnp.asarray(gnd),
        "ground_valid": jnp.ones(gnd.shape[:2], bool),
    }

    sync = jax.block_until_ready
    sync(stacked["obst"])  # resident

    # --- (a) compile: first call of the vmapped pair solver at chunk shape
    idx = np.arange(pc)
    src = jax.tree_util.tree_map(lambda a: a[idx + 1], stacked)
    tgt = jax.tree_util.tree_map(lambda a: a[idx], stacked)
    inits = jnp.broadcast_to(jnp.eye(4, dtype=jnp.float32), (pc, 4, 4))
    sync(src["obst"])
    t0 = time.perf_counter()
    res = odo._match_pairs(src, tgt, inits)
    sync(res.transform)
    compile_s = time.perf_counter() - t0

    # --- (b) steady-state kernel rate, inputs resident
    t0 = time.perf_counter()
    for _ in range(args.reps):
        res = odo._match_pairs(src, tgt, inits)
    sync(res.transform)
    kernel_chunk_s = (time.perf_counter() - t0) / args.reps
    kernel_pair_ms = 1000.0 * kernel_chunk_s / pc

    # --- (c) the production whole-pass path (_solve_pairs: ONE lax.map
    #     dispatch over a (C, chunk) grid + one result fetch), slope-
    #     timed over the SAME pair count.  Overhead = pass time minus the
    #     kernel time of the pairs ACTUALLY SOLVED (C*chunk, including
    #     the padded tail) — it prices the dispatch + fetch + lax.map
    #     iteration cost, the quantity the r5 fixes targeted (the
    #     pre-fix per-chunk host-gather path measured 48.7 ms/chunk).
    pair_idx = np.arange(min(k - 1, 4 * pc))
    inits_np = np.broadcast_to(np.eye(4, dtype=np.float32),
                               (len(pair_idx), 4, 4))
    odo._solve_pairs(stacked, pair_idx, inits_np, pc)  # warm
    t_at = {}
    for r in (args.reps, 2 * args.reps):
        t0 = time.perf_counter()
        for _ in range(r):
            out = odo._solve_pairs(stacked, pair_idx, inits_np, pc)
        t_at[r] = time.perf_counter() - t0
    solve_pairs_s = max(t_at[2 * args.reps] - t_at[args.reps],
                        1e-9) / args.reps
    n_chunks = -(-len(pair_idx) // pc)
    c_solved = n_chunks if n_chunks in (1, 2) else -(-n_chunks // 4) * 4
    pass_overhead_s = solve_pairs_s - kernel_chunk_s * c_solved

    # --- (d) end-to-end production path on a fresh odometry
    odo2 = LidarOdometry(cfg=cfg)
    t0 = time.perf_counter()
    odo2._ingest_parallel(stacked, pc)
    e2e_icp_s = time.perf_counter() - t0
    drift = float(np.linalg.norm(odo2.poses[-1][:3, 3]
                                 - np.asarray([0.0, 0.0, 0.0]))) > 1.0

    out = {
        "metric": "icp_kernel_ms_per_pair",
        "value": round(kernel_pair_ms, 3),
        "unit": "ms",
        "platform": jax.devices()[0].platform,
        "frames": k,
        "pair_chunk": pc,
        "compile_s": round(compile_s, 3),
        "kernel_chunk_s": round(kernel_chunk_s, 4),
        "solve_pairs_s_per_rep": round(solve_pairs_s, 3),
        "n_chunks_timed": n_chunks,
        "chunks_solved_incl_padding": c_solved,
        "whole_pass_overhead_s": round(pass_overhead_s, 4),
        "e2e_icp_s": round(e2e_icp_s, 3),
        "e2e_s_per_pair_ms": round(1000 * e2e_icp_s / max(k - 1, 1), 3),
        "sanity_moved": drift,
    }
    print(json.dumps(out))
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump(out, f, indent=2)
    return 0


if __name__ == "__main__":
    sys.exit(main())
