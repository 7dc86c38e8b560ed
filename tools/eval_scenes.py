"""Per-scene segmentation ACCURACY eval on hard labeled synthetics.

Real KITTI-360 cannot be mounted in this environment, so segmentation
quality is tracked per round on the hard labeled scenes in
io/synthetic.HARD_SCENES (slope, curb+ramp, overhanging structure,
sparse far field, rolling valley) — exactly the geometry the flat-ground
demo scene and the reference's own synthetic tests never exercise (the
reference asserts only point counts, test/test_recursive_patchwork.cpp:
74-76; this records IoU/F1 against by-construction labels).

The engine's masks match the NumPy oracle bit for bit on every platform
(tests/test_engine_parity.py, tests/test_gpu.py), so accuracy measured on
the CPU holds on the card.

Usage:
  JAX_PLATFORMS=cpu python tools/eval_scenes.py \
      [--points 65536] [--seeds 2] [--json-out EVAL_r05.json]

Prints one JSON line; per-scene detail in "scenes".
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def _log_stderr(msg):
    print(msg, file=sys.stderr)


def run(points: int = 65536, seeds: int = 2, log=_log_stderr):
    import jax.numpy as jnp

    from patchwork_tpu import PatchworkConfig
    from patchwork_tpu.io.synthetic import HARD_SCENES, hard_labeled_scene
    from patchwork_tpu.segment.engine import make_filter_ground
    from patchwork_tpu.utils.metrics import mask_metrics

    fn = make_filter_ground(PatchworkConfig())

    scenes = {}
    for name in HARD_SCENES:
        per_seed = []
        for seed in range(seeds):
            xyz, labels = hard_labeled_scene(name, points, seed=seed)
            res = fn(jnp.asarray(xyz), jnp.ones((points,), bool))
            per_seed.append(mask_metrics(np.asarray(res.ground), labels))
        scenes[name] = {k: round(float(np.mean([m[k] for m in per_seed])), 4)
                        for k in ("iou", "f1", "precision", "recall")}
        log(f"# {name}: IoU {scenes[name]['iou']:.4f}")

    mean_iou = float(np.mean([s["iou"] for s in scenes.values()]))
    return {
        "metric": "hard_scene_mean_iou",
        "value": round(mean_iou, 4),
        "unit": "IoU",
        "points": points,
        "seeds": seeds,
        "scenes": scenes,
    }


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--points", type=int, default=65536)
    ap.add_argument("--seeds", type=int, default=2)
    ap.add_argument("--json-out", default=None)
    args = ap.parse_args()
    t0 = time.perf_counter()
    out = run(args.points, args.seeds)
    out["wall_s"] = round(time.perf_counter() - t0, 2)
    print(json.dumps(out))
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump(out, f, indent=2)
    return 0


if __name__ == "__main__":
    sys.exit(main())
