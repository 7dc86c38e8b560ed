#!/usr/bin/env python
"""Weak-scaling efficiency of the batched engine over a device mesh.

A fixed per-device scan load, mesh sizes 1..D, efficiency = t(1) / t(D)
(for weak scaling the ideal is a constant time per step as devices and
total work grow together).  ``--sp 1`` runs the dp-sharded engine
(parallel/sharded.make_dp_sharded_filter_ground, whole scans per device);
``--sp > 1`` the GSPMD point-sharded engine.

On the CPU it runs on virtual devices (XLA_FLAGS=
--xla_force_host_platform_device_count=8 JAX_PLATFORMS=cpu), which only
validates the mechanism: they share the host's cores.

Usage: python tools/scaling_bench.py [--points 32768] [--per-device 2] [--sp 1]
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--points", type=int, default=32768)
    ap.add_argument("--per-device", type=int, default=2, help="scans per device")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--sp", type=int, default=1, help="point-shard factor")
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    from patchwork_tpu import PatchworkConfig
    from patchwork_tpu.io.synthetic import demo_point_cloud
    from patchwork_tpu.parallel.mesh import make_mesh
    from patchwork_tpu.parallel.sharded import make_sharded_filter_ground

    n_dev = len(jax.devices())
    cfg = PatchworkConfig()
    sizes = [d for d in (1, 2, 4, 8, 16, 32) if d * args.sp <= n_dev]
    print(f"devices: {n_dev} x {jax.devices()[0].device_kind}; "
          f"weak scaling (sp={args.sp}), "
          f"{args.per_device} x {args.points}-pt scans/device")
    if jax.default_backend() == "cpu":
        print("  NOTE: virtual CPU devices share the same host cores - "
              "efficiency numbers here only validate the mechanism")

    times = {}
    for d in sizes:
        b = d * args.per_device
        xyz = jnp.asarray(
            np.stack([demo_point_cloud(args.points, seed=i) for i in range(b)])
        )
        valid = jnp.ones((b, args.points), bool)
        mesh = make_mesh(d * args.sp, dp=d, sp=args.sp)
        fn = make_sharded_filter_ground(cfg, mesh, shard_points=args.sp > 1)
        jax.block_until_ready(fn(xyz, valid))
        t0 = time.perf_counter()
        for _ in range(args.reps):
            res = fn(xyz, valid)
        jax.block_until_ready(res)
        times[d] = (time.perf_counter() - t0) / args.reps
        eff = times[sizes[0]] / times[d]
        print(f"  dp={d:3d} (batch {b:3d}): {times[d]*1e3:9.2f} ms/step  "
              f"weak-scaling efficiency {eff*100:6.1f}%")

    if len(sizes) > 1:
        final_eff = times[sizes[0]] / times[sizes[-1]]
        print(json.dumps({
            "metric": f"weak_scaling_efficiency_sp{args.sp}_dp{sizes[-1]}",
            "value": round(final_eff, 4),
            "unit": "ratio",
            "extra": {
                "sp": args.sp,
                "backend": jax.default_backend(),
                "device_kind": jax.devices()[0].device_kind,
                "points": args.points,
                "per_device": args.per_device,
                "ms_per_step": {str(d): round(t * 1e3, 2)
                                for d, t in times.items()},
            },
        }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
