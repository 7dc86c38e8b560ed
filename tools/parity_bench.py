#!/usr/bin/env python
"""Backend parity + latency harness — the reference test_cuda analogue.

The reference's test_cuda.cpp (src/test_cuda.cpp:58-138) times each op on
CPU vs GPU on a 100k-point uniform cube and checks elementwise parity at
1e-6.  Here the compared backends are the segment-op implementations
(scatter golden path, one-hot matmul formulation) of the full engine, on
the reference's cube cloud and a realistic scene.

Usage: python tools/parity_bench.py [--points 100000] [--impls scatter onehot]
"""

import argparse
import sys
import time

sys.path.insert(0, __import__("os").path.dirname(__import__("os").path.dirname(
    __import__("os").path.abspath(__file__))))

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--points", type=int, default=100000)
    ap.add_argument("--impls", nargs="+", default=["scatter", "onehot"])
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    from patchwork_tpu import PatchworkConfig
    from patchwork_tpu.io.synthetic import demo_point_cloud, uniform_cube_cloud
    from patchwork_tpu.ops.pointcloud import ego_mask, rotate_2d, transform_4x4
    from patchwork_tpu.segment.engine import make_filter_ground

    n = args.points
    print(f"device: {jax.devices()[0]}  points: {n}")

    # --- elementwise ops (test_cuda's rotation/transform/ego trio) ---
    cube = jnp.asarray(uniform_cube_cloud(n, seed=0))
    rot = jax.jit(lambda p: rotate_2d(p, 45.0))
    t = np.eye(4, dtype=np.float32); t[:3, 3] = [1, 2, 3]
    tr = jax.jit(lambda p: transform_4x4(p, jnp.asarray(t)))
    ego = jax.jit(lambda p: ego_mask(p, 2.5))
    for name, fn in [("rotate_2d", rot), ("transform_4x4", tr), ("ego_mask", ego)]:
        jax.block_until_ready(fn(cube))  # compile outside timed region
        t0 = time.perf_counter()
        for _ in range(args.reps):
            out = fn(cube)
        jax.block_until_ready(out)
        print(f"  {name:16s} {(time.perf_counter()-t0)/args.reps*1e3:8.3f} ms")

    # numeric parity of rotation vs numpy at 1e-6-ish (test_cuda.cpp:39-56)
    ref = np.asarray(cube).copy()
    c, s_ = np.cos(np.deg2rad(45.0)), np.sin(np.deg2rad(45.0))
    expect = ref.copy()
    expect[:, 0] = ref[:, 0] * c - ref[:, 1] * s_
    expect[:, 1] = ref[:, 0] * s_ + ref[:, 1] * c
    err = np.abs(np.asarray(rot(cube)) - expect).max()
    print(f"  rotation parity vs host: max err {err:.2e} "
          f"({'PASS' if err < 1e-4 else 'FAIL'})")

    # --- full engine across segment-op impls ---
    scene = demo_point_cloud(n, seed=0)
    xyz = jnp.asarray(scene)
    valid = jnp.ones(n, bool)
    cfg = PatchworkConfig()
    masks = {}
    for impl in args.impls:
        fn = make_filter_ground(cfg, impl=impl)
        try:
            jax.block_until_ready(fn(xyz, valid))
            t0 = time.perf_counter()
            for _ in range(args.reps):
                res = fn(xyz, valid)
            jax.block_until_ready(res)
            g = int(res.ground.sum())
            dt = (time.perf_counter() - t0) / args.reps
            masks[impl] = np.asarray(res.ground)
            print(f"  engine[{impl:8s}] {dt*1e3:8.2f} ms/scan "
                  f"({1.0/dt:7.1f} scans/s)  ground={g}")
        except Exception as e:  # pragma: no cover
            print(f"  engine[{impl:8s}] FAILED: {type(e).__name__}: {e}")

    impls = list(masks)
    ok = True
    for a in impls[1:]:
        mm = int((masks[impls[0]] != masks[a]).sum())
        # contract (PARITY.md): the impls are bitwise-identical
        ok &= mm == 0
        print(f"  mask parity {impls[0]} vs {a}: {mm} mismatches "
              f"({'PASS' if mm == 0 else 'FAIL'})")
    print("ALL PARITY PASS" if ok else "PARITY FAILURES", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
