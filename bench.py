"""Benchmark: scans/s of the batched engine on the GPU vs the CPU oracle.

Prints ONE JSON line:
  {"metric": ..., "value": N, "unit": ..., "vs_baseline": N,
   "device": {...}, "extra": {...}}

The headline is the HARD scene — the spinning-LiDAR-like ``velodyne``
cloud (dense near field, ring structure, split-heavy); the easy uniform
demo scene and the merged 3-sensor IAC scene are recorded in ``extra``.

The reference publishes no numbers (BASELINE.md), so the baseline is
self-established per BASELINE.json: the single-threaded recursive oracle
(exact reference semantics, NumPy) on this host's CPU, against the
batched jit engine on the GPU.  Without a GPU the benchmark fails: a CPU
number is never reported as a device number.
"""

import argparse
import json
import subprocess
import sys
import time

import numpy as np


def _measure(gen, n, b, reps, cfg):
    """Engine scans/s for one scene: batched jit, block_until_ready."""
    import jax
    import jax.numpy as jnp

    from patchwork_tpu.segment.engine import make_filter_ground_batched

    scans = [gen(n, seed=i) for i in range(b)]
    xyz = jnp.asarray(np.stack(scans))
    valid = jnp.ones((b, n), bool)
    fn = make_filter_ground_batched(cfg)
    jax.block_until_ready(fn(xyz, valid))  # compile
    t0 = time.perf_counter()
    for _ in range(reps):
        res = fn(xyz, valid)
    jax.block_until_ready(res)
    return reps * b / (time.perf_counter() - t0), scans


def _oracle_scans_per_s(scan, cfg, min_time=0.5):
    from patchwork_tpu.oracle.reference import filter_ground_oracle

    t0 = time.perf_counter()
    reps = 0
    while True:
        filter_ground_oracle(scan, cfg)
        reps += 1
        dt = time.perf_counter() - t0
        if dt >= min_time or reps >= 3:
            return reps / dt


def _nvidia_smi():
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"],
                           capture_output=True, text=True, timeout=30)
        return r.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return None


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--points", type=int, default=131072,
                    help="points per scan (128 beams x 1024 columns)")
    ap.add_argument("--batch", type=int, default=8, help="scans per step")
    ap.add_argument("--reps", type=int, default=20, help="timed steps")
    ap.add_argument("--skip-baseline", action="store_true")
    ap.add_argument("--cloud", choices=["velodyne", "demo"], default="velodyne",
                    help="headline scan distribution (velodyne = realistic "
                         "spinning-LiDAR; demo = easy uniform scene)")
    ap.add_argument("--headline-only", action="store_true",
                    help="measure only the headline cell")
    args = ap.parse_args()

    import jax

    from patchwork_tpu import PatchworkConfig
    from patchwork_tpu.core.device import (UnsupportedPlatformError,
                                           enable_compilation_cache,
                                           require_gpu)

    try:
        dev = require_gpu()
    except UnsupportedPlatformError as e:
        sys.exit(f"bench: {e}")
    enable_compilation_cache()
    from patchwork_tpu.io.synthetic import (demo_point_cloud,
                                            fused_iac_cloud,
                                            velodyne_like_cloud)

    b, n, reps = args.batch, args.points, args.reps
    cfg = PatchworkConfig()
    gens = {"demo": demo_point_cloud, "velodyne": velodyne_like_cloud}

    head_rate, head_scans = _measure(gens[args.cloud], n, b, reps, cfg)
    extra = {}
    if not args.headline_only:
        other = "demo" if args.cloud == "velodyne" else "velodyne"
        extra[f"{other}_scans_per_s"], other_scans = _measure(
            gens[other], n, b, reps, cfg)
        # multi-LiDAR end-to-end (BASELINE configs[3]): merged 3-sensor
        # IAC scene through the same engine path
        extra["fused_iac_scans_per_s"], _ = _measure(
            fused_iac_cloud, n, b, reps, cfg)

    vs_baseline = None
    if not args.skip_baseline:
        cpu_rate = _oracle_scans_per_s(head_scans[0], cfg)
        vs_baseline = head_rate / cpu_rate
        extra[f"{args.cloud}_oracle_scans_per_s"] = cpu_rate
        if not args.headline_only:
            extra[f"{other}_oracle_scans_per_s"] = _oracle_scans_per_s(
                other_scans[0], cfg)

    print(json.dumps({
        "metric": f"synthetic_{args.cloud}_{n}pt_scans_per_s",
        "value": head_rate,
        "unit": "scans/s",
        "vs_baseline": vs_baseline,
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices()),
                   "nvidia_smi": _nvidia_smi()},
        "extra": extra,
    }))


if __name__ == "__main__":
    main()
