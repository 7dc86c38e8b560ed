#!/usr/bin/env python
"""Run-to-run determinism of the engine's masks on the GPU.

    python tools/determinism.py [--runs 20] [--batch-runs 10] \
        [--json-out chiprun_out/determinism.json]

GPU scatter-add sums in an order that may change between runs, so a
point within f32 noise of a threshold may flip.  This runs the same
compiled engine on the same input many times and counts what comes back:

* the streaming node's config (``NodeParams().to_config()``: th_dist
  0.1, max_iter 50) at B=1, on velodyne-like frames ``--frame-seeds``
  (chip_smoke.py's stream phase uses seeds 100 + i, so 108 and 110 are
  its frames 8 and 10, the two that differ from the oracle): distinct
  masks over ``--runs`` runs, and the most bits any run differs from
  the first;
* the default config at B=8 x 131,072 points (the bench shape):
  distinct masks over ``--batch-runs`` runs.

It also prints each shape's median step time.  To try XLA's
deterministic GPU ops, run it with
``XLA_FLAGS=--xla_gpu_deterministic_ops=true``; the flags in effect are
printed.  A measurement path: without a GPU it exits non-zero.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def distinct(masks) -> tuple[int, int]:
    """(number of distinct masks, most bits any mask differs from the first)."""
    seen = {m.tobytes() for m in masks}
    worst = max(int((m != masks[0]).sum()) for m in masks)
    return len(seen), worst


def repeat(fn, args, runs: int):
    """``runs`` masks and step times of fn(*args).ground."""
    import jax
    import numpy as np

    masks, times = [], []
    for _ in range(runs):
        t0 = time.perf_counter()
        res = jax.block_until_ready(fn(*args))
        times.append(time.perf_counter() - t0)
        masks.append(np.asarray(res.ground))
    return masks, times


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--points", type=int, default=131072)
    ap.add_argument("--runs", type=int, default=20)
    ap.add_argument("--frame-seeds", type=int, nargs="+", default=[108, 110])
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--batch-runs", type=int, default=10)
    ap.add_argument("--json-out", default=None)
    args = ap.parse_args()

    import jax.numpy as jnp
    import numpy as np

    from patchwork_tpu import PatchworkConfig, make_filter_ground
    from patchwork_tpu.core.device import (UnsupportedPlatformError,
                                           enable_compilation_cache,
                                           require_gpu)
    from patchwork_tpu.io.synthetic import velodyne_like_cloud
    from patchwork_tpu.node import NodeParams
    from patchwork_tpu.segment.engine import make_filter_ground_batched

    try:
        dev = require_gpu()
    except UnsupportedPlatformError as e:
        print(f"determinism: {e}", file=sys.stderr)
        return 1
    enable_compilation_cache()
    n = args.points
    out = {"device": dev.device_kind,
           "xla_flags": os.environ.get("XLA_FLAGS", ""), "b1": {}}
    print(f"XLA_FLAGS={out['xla_flags']}", flush=True)

    node_fn = make_filter_ground(NodeParams().to_config())
    valid1 = jnp.ones(n, bool)
    b1_times = []
    for seed in args.frame_seeds:
        xyz = jnp.asarray(velodyne_like_cloud(n, seed=seed))
        node_fn(xyz, valid1)  # compile / warm
        masks, times = repeat(node_fn, (xyz, valid1), args.runs)
        b1_times += times
        k, worst = distinct(masks)
        out["b1"][seed] = {"distinct": k, "max_diff_bits": worst}
        print(f"B1 seed {seed} distinct masks over {args.runs} runs: {k} "
              f"max diff bits {worst}", flush=True)

    xyz8 = jnp.asarray(np.stack([velodyne_like_cloud(n, seed=i)
                                 for i in range(args.batch)]))
    valid8 = jnp.ones((args.batch, n), bool)
    fn8 = make_filter_ground_batched(PatchworkConfig())
    fn8(xyz8, valid8)  # compile / warm
    masks, times = repeat(fn8, (xyz8, valid8), args.batch_runs)
    k, worst = distinct(masks)
    out["b8"] = {"distinct": k, "max_diff_bits": worst}
    print(f"B{args.batch} default cfg distinct masks over {args.batch_runs} "
          f"runs: {k} max diff bits {worst}", flush=True)
    out["b1_step_ms_median"] = float(np.median(b1_times)) * 1e3
    out["b8_step_ms_median"] = float(np.median(times)) * 1e3
    print(f"B1 node-cfg step median ms {out['b1_step_ms_median']}; "
          f"B{args.batch} default step median ms {out['b8_step_ms_median']}",
          flush=True)
    if args.json_out:
        os.makedirs(os.path.dirname(os.path.abspath(args.json_out)),
                    exist_ok=True)
        with open(args.json_out, "w") as f:
            json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
