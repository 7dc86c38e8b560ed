"""Real multi-process SPMD execution (slow, subprocess-spawned).

Complements test_utils.py's single-process no-op check of
parallel/multihost.py: here tools/multihost_bench.py spawns actual OS
processes that join one jax.distributed group and run the dp-sharded
batched engine, the GSPMD point-sharded engine, and the distributed
Schur-PCG bundle adjustment with REAL cross-process (gloo) collectives,
the same program shape a multi-host run has (reference analogue: none;
its multi-process story is the untested ROS2 graph,
recursive_patchwork_node.cpp:43-53).
"""

import json
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.slow
def test_two_process_spmd_parity(tmp_path):
    out_path = tmp_path / "mh.json"
    env = dict(os.environ)
    # the launcher sets up its own CPU-only worker env; it must not
    # inherit the suite's 8-device XLA_FLAGS (workers use 2 each)
    env.pop("XLA_FLAGS", None)
    proc = subprocess.run(
        [sys.executable, os.path.join(REPO, "tools", "multihost_bench.py"),
         "--procs", "2", "--points", "2048", "--batch", "4",
         "--json-out", str(out_path)],
        capture_output=True, text=True, timeout=900, env=env, cwd=REPO,
    )
    assert proc.returncode == 0, proc.stderr[-3000:] + proc.stdout[-2000:]
    doc = json.loads(out_path.read_text())
    assert doc["all_ok"]
    assert len(doc["workers"]) == 2
    for w in doc["workers"]:
        assert w["global_devices"] == 4
        assert w["dp_bit_errors"] == 0
        assert w["gspmd_sp_bit_errors"] == 0
        assert w["ba_pose_ok"]
