#!/usr/bin/env python
"""Smoke run of the whole system on one NVIDIA GPU, through its entry points.

    python chip_smoke.py                 # phases (a)-(f) on one card
    python chip_smoke.py --four-cards    # only the mesh paths, on four cards

Every phase checks its result against something independent of the code
under test — the NumPy oracle (oracle/reference.py), the other segment-op
impl, the single-device run, or the SLAM accuracy gates — and raises on a
mismatch; nothing catches a phase's failure, so any failure is a non-zero
exit.  The last line of standard output is one JSON object,
``{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}``,
printed only when every phase passed.  Without a GPU the script exits
non-zero before any phase.  Everything runs in this one JAX process (the
card-marked tests of phase (f) too), so no second process competes for
the card.
"""

from __future__ import annotations

import argparse
import contextlib
import importlib.util
import io
import json
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))

# Bench shape: 131,072 points (128 beams x 1024 columns), 8 scans per step.
POINTS = 131072
BATCH = 8
SCENES = ("velodyne", "demo", "fused_iac")
STREAM_FRAMES = 20
SLAM_KEYFRAMES = 100
# tools/slam_bench.py --keyframes 100 (seed 3) on the CPU platform:
# ATE of the odometry, the pose graph and BA, in metres.
SLAM_CPU_ATE = {"ate_odometry_m": 1.0438, "ate_posegraph_m": 0.2541,
                "ate_ba_m": 0.159}
# Allowed |GPU - CPU| per ATE, in metres.  f32 sums run in another order
# on the card, so ICP takes slightly different steps and the odometry's
# drift differs a little; the largest gap measured on an H100 was 0.003 m
# (odometry; PERF.md).  About 3x that, so a precision regression (a TF32
# matmul on a SLAM path) fails the gate.
SLAM_ATE_TOL_M = 0.01
# Stream phase: the node's config (th_dist 0.1, max_iter 50) puts a few
# points of some frames within f32 summation-order noise of the distance
# threshold: the engine sums in f32 in segment order, the oracle in
# float64.  The same flips show on the CPU platform (1 bit of frame 8,
# 7 bits of frame 10 for the 'onehot' impl).  Allowed: 1e-4 of the points
# of a frame.
STREAM_ORACLE_TOL = 1e-4
# bundle_adjust_sharded vs bundle_adjust: psum reorders the f32 sums of
# the normal equations; poses may differ by this much (metres / radians).
BA_SHARDED_TOL = 1e-3


def log(msg: str) -> None:
    print(msg, flush=True)


def _import_tool(name: str):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(REPO, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def scenes(n: int = POINTS, b: int = BATCH, names=SCENES):
    """{name: (b, n, 3) float32} seeded scans of each scene."""
    from patchwork_tpu.io.synthetic import (
        demo_point_cloud, fused_iac_cloud, velodyne_like_cloud)

    gens = {"velodyne": velodyne_like_cloud, "demo": demo_point_cloud,
            "fused_iac": fused_iac_cloud}
    return {s: np.stack([gens[s](n, seed=i) for i in range(b)]) for s in names}


def oracle_mismatches(xyz: np.ndarray, ground: np.ndarray, cfg) -> list:
    """Per-scan count of mask bits that differ from the NumPy oracle."""
    from patchwork_tpu.oracle.reference import filter_ground_oracle

    return [int((filter_ground_oracle(x, cfg)[0] != g).sum())
            for x, g in zip(xyz, ground)]


def nvidia_smi() -> str:
    try:
        r = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30)
        return r.stdout.strip() or r.stderr.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable: {e}"


def memory_summary(compiled) -> str:
    m = compiled.memory_analysis()
    if m is None:
        return "memory_analysis unavailable"
    return ", ".join(
        f"{k}={getattr(m, k) / 2**20:.1f} MiB"
        for k in ("argument_size_in_bytes", "output_size_in_bytes",
                  "temp_size_in_bytes", "generated_code_size_in_bytes")
        if hasattr(m, k))


def peak_bytes() -> int:
    import jax

    stats = jax.devices()[0].memory_stats() or {}
    return int(stats.get("peak_bytes_in_use", -1))


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_device():
    """(a) The card JAX sees, its name and power limit; GPU or fail."""
    import jax

    from patchwork_tpu.core.device import (enable_compilation_cache,
                                           require_gpu)

    dev = require_gpu()
    log(f"[device] jax {jax.__version__}  devices={jax.devices()}")
    log(f"[device] kind={dev.device_kind}  count={len(jax.devices())}")
    log(f"[device] compile cache: {enable_compilation_cache()}")
    log(f"[device] nvidia-smi: {nvidia_smi()}")
    return dev


def timed_steps(fn, args, reps: int) -> list:
    import jax

    out = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        out.append(time.perf_counter() - t0)
    return out


def phase_engine(n: int = POINTS, b: int = BATCH, reps: int = 10,
                 names=SCENES) -> dict:
    """(b) Batched engine, both segment-op impls, against the oracle."""
    import jax.numpy as jnp

    from patchwork_tpu import PatchworkConfig
    from patchwork_tpu.segment.engine import make_filter_ground_batched
    from patchwork_tpu.segment.segops import IMPLS, default_impl

    cfg = PatchworkConfig()
    log(f"[engine] B={b} N={n} default impl={default_impl()}")
    report, failures = {}, []
    for name, xyz_np in scenes(n, b, names).items():
        xyz = jnp.asarray(xyz_np)
        valid = jnp.ones((b, n), bool)
        compiled, masks, times = {}, {}, {}
        for impl in IMPLS:
            t0 = time.perf_counter()
            compiled[impl] = make_filter_ground_batched(cfg, impl=impl).lower(
                xyz, valid).compile()
            compile_s = time.perf_counter() - t0
            masks[impl] = np.asarray(compiled[impl](xyz, valid).ground)
            again = np.asarray(compiled[impl](xyz, valid).ground)
            log(f"[engine] {name} {impl}: compile {compile_s:.2f} s; "
                f"{memory_summary(compiled[impl])}; repeat-run mismatches "
                f"{int((again != masks[impl]).sum())}")
            times[impl] = []
        # interleaved timing: each impl sees the same card state
        for r in range(reps):
            order = IMPLS if r % 2 == 0 else IMPLS[::-1]
            for impl in order:
                times[impl] += timed_steps(compiled[impl], (xyz, valid), 1)
        row = {}
        for impl in IMPLS:
            bad = oracle_mismatches(xyz_np, masks[impl], cfg)
            med = float(np.median(times[impl]))
            row[impl] = {"step_ms_median": med * 1e3,
                         "step_ms_min": min(times[impl]) * 1e3,
                         "scans_per_s": b / med,
                         "oracle_mismatch_bits": bad,
                         "ground_points": int(masks[impl].sum())}
            log(f"[engine] {name} {impl}: step median {med * 1e3:.3f} ms "
                f"(min {min(times[impl]) * 1e3:.3f}) = {b / med:.1f} scans/s; "
                f"oracle mismatch bits per scan {bad}")
            if any(bad):
                failures.append(f"{name}/{impl} vs oracle: {bad}")
        diff = int((masks[IMPLS[0]] != masks[IMPLS[1]]).sum())
        log(f"[engine] {name}: {IMPLS[0]} vs {IMPLS[1]} mismatch bits {diff}")
        if diff:
            failures.append(f"{name}: {IMPLS[0]} vs {IMPLS[1]} {diff} bits")
        report[name] = row
    log(f"[engine] peak_bytes_in_use {peak_bytes() / 2**20:.1f} MiB")
    if failures:
        raise AssertionError("engine parity: " + "; ".join(failures))
    return report


def phase_cli(num_points: int = 10000) -> dict:
    """(c) The CLI in-process; its printed counts against the engine's."""
    import jax.numpy as jnp

    from patchwork_tpu import PatchworkConfig, make_filter_ground
    from patchwork_tpu import cli
    from patchwork_tpu.io.synthetic import demo_point_cloud
    from patchwork_tpu.oracle.reference import filter_ground_oracle

    with tempfile.TemporaryDirectory() as tmp:
        prefix = os.path.join(tmp, "smoke")
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = cli.main(["--demo", "--use-patchwork", "--separate-display",
                           "--num-points", str(num_points),
                           "--out-prefix", prefix])
        out = buf.getvalue()
        pngs = [f"{prefix}_patchwork.png", f"{prefix}_enhanced.png"]
        for p in pngs:
            with open(p, "rb") as f:
                if f.read(8) != b"\x89PNG\r\n\x1a\n":
                    raise AssertionError(f"{p} is not a PNG")
    got_g = int(re.search(r"Ground points: (\d+)", out).group(1))
    got_n = int(re.search(r"Non-ground points: (\d+)", out).group(1))
    pts = demo_point_cloud(num_points, seed=0)
    cfg = PatchworkConfig()
    res = make_filter_ground(cfg)(jnp.asarray(pts), jnp.ones(len(pts), bool))
    eng_g = int(res.num_ground())
    eng_n = int(res.num_non_ground())
    g_o, v_o, *_ = filter_ground_oracle(pts, cfg)
    log(f"[cli] rc={rc} printed ground={got_g} non-ground={got_n}; engine "
        f"{eng_g}/{eng_n}; oracle {int(g_o.sum())}/{int((v_o & ~g_o).sum())}")
    if rc != 0 or (got_g, got_n) != (eng_g, eng_n) or \
            got_g != int(g_o.sum()):
        raise AssertionError("CLI counts differ from the engine / oracle")
    return {"ground": got_g, "non_ground": got_n}


def phase_stream(frames: int = STREAM_FRAMES, n: int = POINTS,
                 tol: float = STREAM_ORACLE_TOL) -> dict:
    """(d) PatchworkNode over velodyne frames; no frame may be dropped."""
    from patchwork_tpu.io.synthetic import velodyne_like_cloud
    from patchwork_tpu.node import PatchworkNode

    scans = [velodyne_like_cloud(n, seed=100 + i) for i in range(frames)]
    node = PatchworkNode(capacity=n)
    t0 = time.perf_counter()
    node.process(scans[0])  # compile
    compile_s = time.perf_counter() - t0
    runs = [node.run(scans) for _ in range(2)]
    for results in runs:
        if len(results) != frames:
            raise AssertionError(
                f"stream: {len(results)}/{frames} frames came back "
                "(see 'Error processing frame' above)")
    results = runs[1]
    lat = np.array([r.latency_s for r in results]) * 1e3
    masks = [np.stack([r.ground_mask for r in res]) for res in runs]
    rerun_bits = int((masks[0] != masks[1]).sum())
    bad = oracle_mismatches(np.stack(scans), masks[1], node.config)
    counts_ok = all(r.num_ground == int(r.ground_mask.sum()) for r in results)
    log(f"[stream] {frames} frames of {n} points; first call {compile_s:.2f} s;"
        f" latency p50 {np.percentile(lat, 50):.3f} ms, p99 "
        f"{np.percentile(lat, 99):.3f} ms, max {lat.max():.3f} ms; oracle "
        f"mismatch bits per frame {bad} (allowed {int(tol * n)}); rerun "
        f"mismatch bits {rerun_bits}; counts consistent {counts_ok}")
    if max(bad) > tol * n or not counts_ok:
        raise AssertionError("stream masks differ from the oracle")
    return {"p50_ms": float(np.percentile(lat, 50)),
            "p99_ms": float(np.percentile(lat, 99)), "compile_s": compile_s,
            "oracle_mismatch_bits": bad, "rerun_mismatch_bits": rerun_bits}


def phase_slam(keyframes: int = SLAM_KEYFRAMES, cpu_ate=SLAM_CPU_ATE,
               tol: float = SLAM_ATE_TOL_M) -> dict:
    """(e) tools/slam_bench.py scenario: odometry, loops, graph, BA."""
    out = _import_tool("slam_bench").run(
        keyframes, log=lambda s: log(f"[slam] {s}"))
    a_o, a_g, a_b = (out["ate_odometry_m"], out["ate_posegraph_m"],
                     out["ate_ba_m"])
    log(f"[slam] ATE odometry {a_o} posegraph {a_g} ba {a_b} m; CPU "
        f"{cpu_ate}; tolerance {tol} m; "
        f"wall {out['wall_s']} s")
    if not a_b <= a_g <= a_o:
        raise AssertionError("SLAM: ATE does not fall odometry >= graph >= BA")
    far = {k: out[k] for k, v in cpu_ate.items()
           if abs(out[k] - v) > tol}
    if far:
        raise AssertionError(f"SLAM ATE too far from the CPU value: {far}")
    return out


class _Outcomes:
    """pytest plugin counting the call-phase outcomes of the run."""

    def __init__(self):
        self.passed, self.failed, self.skipped = [], [], []

    def pytest_runtest_logreport(self, report):
        if report.when == "call" or report.outcome != "passed":
            getattr(self, report.outcome).append(report.nodeid)


def phase_tests() -> dict:
    """(f) The gpu-marked tests, in this process, on the card."""
    import pytest

    counter = _Outcomes()
    rc = pytest.main([os.path.join(REPO, "tests"), "-m", "gpu", "-q",
                      "-p", "no:cacheprovider", "-p", "no:randomly"],
                     plugins=[counter])
    log(f"[tests] rc={rc} passed={len(counter.passed)} "
        f"failed={counter.failed} skipped={counter.skipped}")
    if rc != 0 or counter.failed or counter.skipped or not counter.passed:
        raise AssertionError("gpu-marked tests did not all pass")
    return {"passed": len(counter.passed)}


def phase_four_cards(n: int = POINTS, b: int = BATCH,
                     ba_size=(400, 300, 40)) -> dict:
    """The mesh paths on four cards, each against its single-device run."""
    import jax
    import jax.numpy as jnp

    from patchwork_tpu import PatchworkConfig
    from patchwork_tpu.parallel.mesh import make_mesh
    from patchwork_tpu.parallel.sharded import (
        make_dp_sharded_filter_ground, make_sharded_filter_ground)
    from patchwork_tpu.segment.engine import make_filter_ground_batched
    from patchwork_tpu.slam import bundle_adjust, bundle_adjust_sharded

    if len(jax.devices()) != 4:
        raise AssertionError(f"--four-cards needs 4 devices, "
                             f"found {len(jax.devices())}")
    cfg = PatchworkConfig()
    xyz_np = scenes(n, b, ("velodyne",))["velodyne"]
    xyz = jnp.asarray(xyz_np)
    valid = jnp.ones((b, n), bool)
    single = np.asarray(make_filter_ground_batched(cfg)(xyz, valid).ground)
    out = {}
    for name, fn in (
            ("dp4_shard_map", make_dp_sharded_filter_ground(
                cfg, make_mesh(4, dp=4, sp=1))),
            ("dp2_sp2_gspmd", make_sharded_filter_ground(
                cfg, make_mesh(4, dp=2, sp=2), shard_points=True))):
        t0 = time.perf_counter()
        g = np.asarray(fn(xyz, valid).ground)
        first = time.perf_counter() - t0
        step = float(np.median(timed_steps(fn, (xyz, valid), 5)))
        diff = int((g != single).sum())
        log(f"[four-cards] {name}: B={b} N={n} first call {first:.2f} s, "
            f"step {step * 1e3:.3f} ms; mismatch bits vs single device {diff}")
        if diff:
            raise AssertionError(f"{name}: {diff} mask bits differ")
        out[name] = {"step_ms": step * 1e3, "mismatch_bits": diff}

    k, num_l, per_kf = ba_size
    prob = _import_tool("ba_bench").synth_problem(k, num_l, per_kf)
    ref = bundle_adjust(prob, iters=4)
    dist = bundle_adjust_sharded(prob, make_mesh(4, dp=4, sp=1), iters=4)
    dpos = float(np.abs(np.asarray(ref.poses) - np.asarray(dist.poses)).max())
    dpts = float(np.abs(np.asarray(ref.points)
                        - np.asarray(dist.points)).max())
    log(f"[four-cards] bundle_adjust_sharded vs bundle_adjust (K={k}, "
        f"L={num_l}, O={prob.obs_k.shape[0]}): max |d pose| {dpos:.3e}, max |d point| "
        f"{dpts:.3e}, tolerance {BA_SHARDED_TOL}")
    if max(dpos, dpts) > BA_SHARDED_TOL:
        raise AssertionError("sharded BA differs from single-device BA")
    out["ba"] = {"max_pose_diff": dpos, "max_point_diff": dpts}
    return out


PHASES = {"engine": phase_engine, "cli": phase_cli, "stream": phase_stream,
          "slam": phase_slam, "tests": phase_tests}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the mesh paths on four cards")
    ap.add_argument("--phases", nargs="+", choices=list(PHASES),
                    default=list(PHASES), help="one-card phases to run")
    ap.add_argument("--json-out", help="also write the phase reports here")
    args = ap.parse_args(argv)

    sys.path.insert(0, REPO)
    try:
        from patchwork_tpu.core.device import UnsupportedPlatformError
    except ImportError as e:
        print(f"chip_smoke: the patchwork_tpu package is missing: {e}",
              file=sys.stderr)
        return 2
    try:
        dev = phase_device()
    except UnsupportedPlatformError as e:
        print(f"chip_smoke: {e}", file=sys.stderr)
        return 1

    import jax

    report = {}
    if args.four_cards:
        report["four_cards"] = phase_four_cards()
    else:
        for name in args.phases:
            t0 = time.perf_counter()
            report[name] = PHASES[name]()
            log(f"[{name}] ok in {time.perf_counter() - t0:.1f} s")
    if args.json_out:
        os.makedirs(os.path.dirname(os.path.abspath(args.json_out)),
                    exist_ok=True)
        with open(args.json_out, "w") as f:
            json.dump({"nvidia_smi": nvidia_smi(), "report": report}, f,
                      indent=1, default=str)
    log(f"{nvidia_smi()}")
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
