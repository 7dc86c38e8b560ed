#!/usr/bin/env python
"""Real multi-process SPMD check: N OS processes, one jax.distributed
group, cross-process collectives, bitwise mask parity.

The reference's only multi-process story is the ROS2/DDS graph
(src/recursive_patchwork_node.cpp:43-53), which it never tests.  Here the
model is one JAX process per host over a global mesh
(parallel/multihost.py).  The launcher spawns ``--procs`` worker
processes of this same script on the CPU backend (2 virtual devices
each, gloo cross-process collectives: the same program shape a
multi-host run has), and every worker:

* joins the process group (``initialize_multihost``) and builds meshes
  spanning ALL processes' devices;
* runs the dp-sharded batched engine (parallel/sharded.py
  make_dp_sharded_filter_ground) on a default-config batch: masks must be
  BIT-IDENTICAL to a local single-device run;
* runs the GSPMD point-sharded engine (shard_points=True): the segment
  reductions all-reduce ACROSS PROCESSES, masks bit-identical to the
  local single-device run;
* runs the distributed Schur-PCG bundle adjustment
  (slam/ba.py bundle_adjust_sharded): observations shard over the global
  dp axis, every CG matvec psums across processes; poses must match the
  single-device solver to f32 reduction-order tolerance.

Usage:
  python tools/multihost_bench.py [--procs 2] [--points 2048] [--batch 4]
                                  [--json-out mh.json]

This checks correctness only: the workers share one host's cores, so
their wall times measure core oversubscription, not communication.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

_LOCAL_DEVICES = 2  # virtual CPU devices per process


def _worker(args) -> int:
    # CPU with gloo collectives, set before the backend initializes
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_cpu_collectives_implementation", "gloo")

    from patchwork_tpu.parallel.multihost import (
        host_summary, initialize_multihost, is_multihost)

    assert initialize_multihost(
        f"127.0.0.1:{args.port}", num_processes=args.procs,
        process_id=args.worker,
    ), "worker must join the process group"
    assert is_multihost() == (args.procs > 1)

    import numpy as np
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from patchwork_tpu import PatchworkConfig
    from patchwork_tpu.io.synthetic import demo_point_cloud
    from patchwork_tpu.parallel.mesh import make_mesh, scan_batch_sharding
    from patchwork_tpu.parallel.sharded import (
        make_dp_sharded_filter_ground, make_sharded_filter_ground)
    from patchwork_tpu.segment.engine import make_filter_ground_batched

    n_global = jax.device_count()
    assert n_global == args.procs * _LOCAL_DEVICES, host_summary()
    b, n = args.batch, args.points
    assert b % n_global == 0, "batch must divide over the global dp axis"

    # identical inputs on every process (SPMD: same program, same data)
    xyz = np.stack([demo_point_cloud(n, seed=i) for i in range(b)])
    valid = np.ones((b, n), bool)
    cfg = PatchworkConfig()  # DEFAULT config: splits enabled, full radius
    ref = np.asarray(make_filter_ground_batched(cfg)(
        jnp.asarray(xyz), jnp.asarray(valid)).ground)

    def _shard_parity(global_arr):
        """Mask bits of this process's addressable shards that differ
        from the local single-device run."""
        return sum(int((np.asarray(s.data) != ref[s.index]).sum())
                   for s in global_arr.addressable_shards)

    result = {"process": args.worker, "procs": args.procs,
              "global_devices": n_global, "summary": host_summary()}

    # --- (a) dp-sharded batched engine ---------------------------------
    mesh_dp = make_mesh(n_global, dp=n_global, sp=1)
    fn = make_dp_sharded_filter_ground(cfg, mesh_dp)
    gxyz = jax.device_put(xyz, NamedSharding(mesh_dp, P("dp", None, None)))
    gval = jax.device_put(valid, NamedSharding(mesh_dp, P("dp", None)))
    t0 = time.perf_counter()
    res = jax.block_until_ready(fn(gxyz, gval))
    result["dp_bit_errors"] = _shard_parity(res.ground)
    result["dp_wall_s"] = round(time.perf_counter() - t0, 3)

    # --- (b) GSPMD point-sharded engine: cross-process collectives -----
    mesh2 = make_mesh(n_global, dp=n_global // 2, sp=2)
    fn2 = make_sharded_filter_ground(cfg, mesh2, shard_points=True)
    xyz_s, valid_s = scan_batch_sharding(mesh2, shard_points=True)
    g2 = jax.block_until_ready(
        fn2(jax.device_put(xyz, xyz_s), jax.device_put(valid, valid_s)))
    result["gspmd_sp_bit_errors"] = _shard_parity(g2.ground)

    # --- (c) distributed Schur-PCG BA: psum every CG matvec ------------
    from patchwork_tpu.slam import BAProblem, bundle_adjust, bundle_adjust_sharded
    from patchwork_tpu.slam.se3 import se3_exp

    k, l = 6, 16
    rng = np.random.default_rng(0)
    poses = np.stack([
        np.asarray(se3_exp(jnp.asarray(
            np.array([i * 0.8, 0, 0, 0, 0, 0.05 * i], np.float32))))
        for i in range(k)])
    points = rng.uniform(-5, 5, (l, 3)).astype(np.float32)
    obs_k = np.repeat(np.arange(k, dtype=np.int32), l)
    obs_l = np.tile(np.arange(l, dtype=np.int32), k)
    n_obs = len(obs_k)
    pad = (-n_obs) % n_global
    obs_k = np.concatenate([obs_k, np.zeros(pad, np.int32)])
    obs_l = np.concatenate([obs_l, np.zeros(pad, np.int32)])
    obs_p = rng.normal(0, 0.5, (len(obs_k), 3)).astype(np.float32)
    obs_w = np.concatenate([np.ones(n_obs), np.zeros(pad)]).astype(np.float32)

    mesh_ba = make_mesh(n_global, dp=n_global, sp=1)
    rep = NamedSharding(mesh_ba, P())
    shard = NamedSharding(mesh_ba, P("dp"))
    prob_g = BAProblem(
        jax.device_put(poses, rep), jax.device_put(points, rep),
        jax.device_put(obs_k, shard), jax.device_put(obs_l, shard),
        jax.device_put(obs_p, shard), jax.device_put(obs_w, shard))
    out = bundle_adjust_sharded(prob_g, mesh_ba, axis="dp", iters=3,
                                solver="pcg")
    jax.block_until_ready(out.poses)

    prob_local = BAProblem(*(jnp.asarray(a) for a in (
        poses, points, obs_k, obs_l, obs_p, obs_w)))
    ref_ba = bundle_adjust(prob_local, iters=3, solver="pcg")
    pose_diff = float(np.max(np.abs(
        np.asarray(out.poses) - np.asarray(ref_ba.poses))))
    result["ba_pose_max_abs_diff"] = pose_diff
    result["ba_pose_ok"] = bool(pose_diff < 1e-4)

    result["ok"] = bool(
        result["dp_bit_errors"] == 0
        and result["gspmd_sp_bit_errors"] == 0
        and result["ba_pose_ok"])
    print("MHRESULT " + json.dumps(result), flush=True)
    jax.distributed.shutdown()
    return 0 if result["ok"] else 1


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _launch(args) -> int:
    port = _free_port()
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    flags = env.get("XLA_FLAGS", "")
    if "host_platform_device_count" not in flags:
        env["XLA_FLAGS"] = (
            flags + f" --xla_force_host_platform_device_count={_LOCAL_DEVICES}"
        ).strip()

    t0 = time.perf_counter()
    workers = [
        subprocess.Popen(
            [sys.executable, os.path.abspath(__file__),
             "--worker", str(i), "--procs", str(args.procs),
             "--port", str(port), "--points", str(args.points),
             "--batch", str(args.batch)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True, env=env, cwd=REPO)
        for i in range(args.procs)
    ]
    try:
        outs = [w.communicate(timeout=args.timeout)[0] for w in workers]
    finally:
        # never leave a worker behind: a timeout or a failed peer would
        # otherwise leave processes holding the rendezvous port
        for w in workers:
            if w.poll() is None:
                w.kill()
                w.wait()
    wall = time.perf_counter() - t0

    results = []
    for i, (w, out) in enumerate(zip(workers, outs)):
        lines = [ln for ln in out.splitlines() if ln.startswith("MHRESULT ")]
        if w.returncode != 0 or not lines:
            print(f"--- worker {i} failed (rc={w.returncode}) ---\n{out[-3000:]}",
                  file=sys.stderr)
            return 1
        results.append(json.loads(lines[-1][len("MHRESULT "):]))

    doc = {
        "procs": args.procs,
        "local_devices_per_proc": _LOCAL_DEVICES,
        "batch": args.batch,
        "points": args.points,
        "wall_s": round(wall, 2),
        "all_ok": all(r["ok"] for r in results),
        "workers": results,
    }
    print(json.dumps({
        "metric": f"multihost_{args.procs}proc_parity",
        "value": int(doc["all_ok"]),
        "unit": "bool",
        "dp_bit_errors": sum(r["dp_bit_errors"] for r in results),
        "gspmd_sp_bit_errors": sum(r["gspmd_sp_bit_errors"] for r in results),
        "ba_pose_max_abs_diff": max(r["ba_pose_max_abs_diff"] for r in results),
    }))
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump(doc, f, indent=2)
    return 0 if doc["all_ok"] else 1


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--procs", type=int, default=2)
    ap.add_argument("--points", type=int, default=2048)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--timeout", type=float, default=1800.0)
    ap.add_argument("--json-out", default=None)
    ap.add_argument("--worker", type=int, default=None,
                    help=argparse.SUPPRESS)
    ap.add_argument("--port", type=int, default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker is not None:
        return _worker(args)
    return _launch(args)


if __name__ == "__main__":
    sys.exit(main())
