"""The measurement tools' reductions, on the CPU.

tools/profile_step.py turns a profiler trace into device busy / idle
share and per-kernel time; tools/determinism.py counts distinct masks.
Their numbers come from the GPU, but the arithmetic is checked here, on
hand-made events and on a small trace recorded on the CPU.
"""

import glob
import importlib.util
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _tool(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(REPO, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def profile_step():
    return _tool("profile_step")


@pytest.mark.parametrize("intervals,want", [
    ([], 0),
    ([(0, 10)], 10),
    ([(0, 10), (5, 15)], 15),          # overlap
    ([(0, 10), (20, 30)], 20),         # gap
    ([(20, 30), (0, 10), (2, 4)], 20),  # unsorted, nested
    ([(0, 10), (10, 20)], 20),         # touching
])
def test_union_ns(profile_step, intervals, want):
    assert profile_step.union_ns(intervals) == want


def test_reduce_events_busy_idle_and_ranking(profile_step):
    kernels = [("a", 0, 40), ("b", 30, 20), ("a", 60, 20),
               ("c", 95, 20),   # clipped to the window's end
               ("d", 200, 5)]   # outside the window
    r = profile_step.reduce_events(kernels, (0, 100), steps=2, top=2)
    assert r["window_ms"] == pytest.approx(100e-6)
    assert r["busy_ms"] == pytest.approx(75e-6)   # [0,50) + [60,80) + [95,100)
    assert r["idle_share"] == pytest.approx(0.25)
    assert [k["name"] for k in r["kernels"]] == ["a", "b"]
    assert r["kernels"][0]["launches_per_step"] == 1.0
    assert r["kernels"][0]["ms_per_step"] == pytest.approx(30e-6)
    assert r["other_ms_per_step"] == pytest.approx(2.5e-6)   # 'c', clipped


def test_reduce_trace_on_a_cpu_trace(profile_step, tmp_path):
    f = jax.jit(lambda x: jnp.sin(x) @ x)
    x = jnp.ones((128, 128))
    f(x).block_until_ready()
    with jax.profiler.trace(str(tmp_path)):
        for i in range(2):
            with jax.profiler.StepTraceAnnotation(profile_step.STEP_NAME,
                                                  step_num=i):
                f(x).block_until_ready()
    (path,) = glob.glob(str(tmp_path / "**" / "*.xplane.pb"), recursive=True)
    r = profile_step.reduce_trace(path, device_plane="/host:CPU",
                                  kernel_lines="tf_XLA")
    assert r["steps"] == 2
    assert 0 < r["busy_ms"] <= r["window_ms"]
    assert 0 <= r["idle_share"] < 1
    with pytest.raises(RuntimeError, match="no kernel events"):
        profile_step.reduce_trace(path)   # no GPU plane in a CPU trace


@pytest.mark.parametrize("flips,want", [
    ([], (1, 0)),
    ([[], [3]], (2, 1)),
    ([[3], [3], [1, 2, 5]], (3, 3)),
])
def test_determinism_distinct(flips, want):
    distinct = _tool("determinism").distinct
    base = np.zeros(16, bool)
    masks = [base.copy()]
    for idx in flips:
        m = base.copy()
        m[idx] = True
        masks.append(m)
    assert distinct(masks) == want
