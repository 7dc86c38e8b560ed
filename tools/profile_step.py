#!/usr/bin/env python
"""Where the batched engine's step time goes on the GPU: a profiler trace
of a few steps, reduced to device busy / idle share and per-kernel time.

    python tools/profile_step.py [--scene velodyne] [--steps 3] \
        [--json-out chiprun_out/profile.json]

Runs ``make_filter_ground_batched`` (8 x 131,072 points, default
config, the platform's segment-op impl) once to compile, then traces
``--steps`` steps, each inside a ``StepTraceAnnotation`` and ending in
``block_until_ready``.  The reduction (:func:`reduce_trace`):

* window: from the start of the first step annotation to the end of the
  last, on the host plane (host and device events share one clock);
* kernel events: the events of the device plane's ``Stream`` lines (the
  kernels as CUPTI records them; the derived ``XLA Ops`` / ``XLA
  Modules`` lines would count each kernel twice);
* busy: the union of the kernel intervals clipped to the window;
  idle share = 1 - busy / window;
* per kernel name: total device time and launch count, divided by the
  number of steps.

A measurement path: without a GPU it exits non-zero.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

STEP_NAME = "engine_step"


def union_ns(intervals) -> int:
    """Total length of the union of (start, end) intervals."""
    total, cur_s, cur_e = 0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def reduce_events(kernels, window, steps: int, top: int = 12) -> dict:
    """Busy / idle share and per-name time from kernel events.

    kernels: iterable of (name, start_ns, duration_ns); window: (start_ns,
    end_ns).  Events are clipped to the window.
    """
    w0, w1 = window
    per, spans = {}, []
    for name, s, d in kernels:
        s, e = max(s, w0), min(s + d, w1)
        if e <= s:
            continue
        spans.append((s, e))
        t, c = per.get(name, (0, 0))
        per[name] = (t + (e - s), c + 1)
    busy = union_ns(spans)
    win = w1 - w0
    ranked = sorted(per.items(), key=lambda kv: -kv[1][0])
    return {
        "window_ms": win / 1e6,
        "busy_ms": busy / 1e6,
        "idle_share": 1.0 - busy / win if win > 0 else None,
        "steps": steps,
        "kernels": [{"name": k, "ms_per_step": t / 1e6 / steps,
                     "launches_per_step": c / steps}
                    for k, (t, c) in ranked[:top]],
        "other_ms_per_step": sum(t for _, (t, _) in ranked[top:]) / 1e6 / steps,
    }


def reduce_trace(path: str, device_plane: str = "/device:GPU:0",
                 kernel_lines: str = "Stream",
                 step_name: str = STEP_NAME) -> dict:
    """Reduce one ``.xplane.pb`` file (see the module docstring).

    Kernel events are those of ``device_plane``'s lines whose name starts
    with ``kernel_lines``; step annotations come from the host planes.
    """
    import jax

    pd = jax.profiler.ProfileData.from_file(path)
    steps, kernels, lines = [], [], {}
    for plane in pd.planes:
        if plane.name.startswith("/host:"):
            for line in plane.lines:
                steps += [(e.start_ns, e.start_ns + e.duration_ns)
                          for e in line.events if e.name == step_name]
        if plane.name == device_plane:
            for line in plane.lines:
                evs = list(line.events)
                lines[line.name] = len(evs)
                if line.name.startswith(kernel_lines):
                    kernels += [(e.name, e.start_ns, e.duration_ns)
                                for e in evs]
    if not steps:
        raise RuntimeError(f"no '{step_name}' annotation in {path}")
    if not kernels:
        raise RuntimeError(f"no kernel events on {device_plane}; "
                           f"lines: {lines}")
    window = (min(s for s, _ in steps), max(e for _, e in steps))
    out = reduce_events(kernels, window, len(steps))
    out["device_lines"] = lines
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--scene", default="velodyne",
                    choices=["velodyne", "demo", "fused_iac"])
    ap.add_argument("--points", type=int, default=131072)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--json-out", default=None)
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp
    import numpy as np

    from patchwork_tpu import PatchworkConfig
    from patchwork_tpu.core.device import (UnsupportedPlatformError,
                                           enable_compilation_cache,
                                           require_gpu)
    from patchwork_tpu.io.synthetic import (
        demo_point_cloud, fused_iac_cloud, velodyne_like_cloud)
    from patchwork_tpu.segment.engine import make_filter_ground_batched
    from patchwork_tpu.segment.segops import default_impl

    try:
        dev = require_gpu()
    except UnsupportedPlatformError as e:
        print(f"profile_step: {e}", file=sys.stderr)
        return 1
    enable_compilation_cache()
    gen = {"velodyne": velodyne_like_cloud, "demo": demo_point_cloud,
           "fused_iac": fused_iac_cloud}[args.scene]
    xyz = jnp.asarray(np.stack([gen(args.points, seed=i)
                                for i in range(args.batch)]))
    valid = jnp.ones(xyz.shape[:2], bool)
    fn = make_filter_ground_batched(PatchworkConfig())
    jax.block_until_ready(fn(xyz, valid))  # compile outside the trace
    with tempfile.TemporaryDirectory() as tmp:
        with jax.profiler.trace(tmp):
            for i in range(args.steps):
                with jax.profiler.StepTraceAnnotation(STEP_NAME, step_num=i):
                    jax.block_until_ready(fn(xyz, valid))
        (path,) = glob.glob(os.path.join(tmp, "**", "*.xplane.pb"),
                            recursive=True)
        out = reduce_trace(path)
    out.update(scene=args.scene, batch=args.batch, points=args.points,
               impl=default_impl(), device=dev.device_kind)
    print(json.dumps(out, indent=1))
    if args.json_out:
        os.makedirs(os.path.dirname(os.path.abspath(args.json_out)),
                    exist_ok=True)
        with open(args.json_out, "w") as f:
            json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
