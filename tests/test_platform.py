"""Supported platforms, host-side repairs and chip_smoke.py, on the CPU.

core/device.PLATFORMS is the one place that knows the platforms; an
unknown one is an error, and both known ones take the same impls.  The
two segment-op impls must agree bit for bit; the dp-sharded engine must match a
single-device run; the compile cache, the native library build and the
PNG writer must behave as documented; and chip_smoke.py's phases must run
(at tiny sizes) and its script must refuse to report without a GPU.
"""

import os
import struct
import subprocess
import sys
import zlib

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from patchwork_tpu import PatchworkConfig, make_filter_ground
from patchwork_tpu.core import device
from patchwork_tpu.io.synthetic import demo_point_cloud
from patchwork_tpu.segment.segops import DEFAULT_IMPL, IMPLS, default_impl

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# ---------------------------------------------------------------------------
# backend policy
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("platform", ["cpu", "gpu"])
def test_policy_per_platform(platform, monkeypatch):
    assert device.check_platform(platform) == platform
    monkeypatch.setattr(jax, "default_backend", lambda: platform)
    assert default_impl() == DEFAULT_IMPL == "scatter"


@pytest.mark.parametrize("platform", ["rocm", "METAL", "neuron"])
def test_unknown_platform_is_an_error(platform):
    with pytest.raises(device.UnsupportedPlatformError, match=platform):
        device.check_platform(platform)


def test_default_impl_follows_policy():
    assert jax.default_backend() == "cpu"
    assert device.check_platform() == "cpu"
    assert default_impl() == "scatter"


def test_unknown_default_backend_is_an_error(monkeypatch):
    monkeypatch.setattr(jax, "default_backend", lambda: "rocm")
    with pytest.raises(device.UnsupportedPlatformError):
        default_impl()


def test_require_gpu_refuses_cpu():
    with pytest.raises(device.UnsupportedPlatformError, match="no GPU"):
        device.require_gpu()
    assert device.accelerator_available() is False


@pytest.mark.parametrize("impl", ["fused", "pallas"])
def test_removed_impls_rejected(impl):
    with pytest.raises(ValueError, match="segment_impl"):
        PatchworkConfig(segment_impl=impl)


def test_ba_segment_sums_follow_policy():
    """slam/ba's segment sums: 'sort' by default, every impl exact."""
    from patchwork_tpu.slam import ba

    assert ba.SEG_SUM_IMPL == "sort"
    idx = jnp.asarray([0, 2, 2, 1, 0], jnp.int32)
    vals = jnp.arange(5.0, dtype=jnp.float32)[:, None]
    want = np.array([[4.0], [3.0], [3.0]], np.float32)
    np.testing.assert_array_equal(
        np.asarray(ba._make_seg_sums(idx, 3)(vals)), want)
    for impl in ("sort", "onehot", "scatter"):
        np.testing.assert_array_equal(
            np.asarray(ba._make_seg_sums(idx, 3, impl)(vals)), want)


# ---------------------------------------------------------------------------
# the two segment-op impls agree bit for bit on the parity scenes
# ---------------------------------------------------------------------------

def _split_scene():
    rng = np.random.default_rng(7)
    n = 20000
    pts = np.empty((n, 3), np.float32)
    pts[:, 0] = rng.uniform(-80, 80, n)
    pts[:, 1] = rng.uniform(-80, 80, n)
    pts[:, 2] = 0.08 * pts[:, 0] + 0.5 * (pts[:, 1] > 20) + rng.normal(0, 0.05, n)
    return pts


def _nan_scene():
    pts = demo_point_cloud(5000, seed=3).copy()
    pts[::97, 0] = np.nan
    pts[::131, 2] = np.inf
    return pts


PARITY_SCENES = {
    "testsuite": (lambda: demo_point_cloud(5000, seed=42),
                  PatchworkConfig(filtering_radius=50.0, num_sectors=8,
                                  max_iter=50)),
    "default": (lambda: demo_point_cloud(10000, seed=1), PatchworkConfig()),
    "split_recursion": (_split_scene, PatchworkConfig()),
    "nan_inf": (_nan_scene, PatchworkConfig(filtering_radius=50.0)),
    "non_adaptive": (lambda: demo_point_cloud(8000, seed=9),
                     PatchworkConfig(adaptive_seed_height=False,
                                     filtering_radius=60.0)),
    "no_split": (lambda: demo_point_cloud(8000, seed=11),
                 PatchworkConfig(max_split_depth=0)),
}


@pytest.mark.parametrize("scene", sorted(PARITY_SCENES))
def test_scatter_onehot_bit_parity(scene):
    gen, cfg = PARITY_SCENES[scene]
    pts = jnp.asarray(gen())
    valid = jnp.ones(pts.shape[0], bool)
    g = {impl: np.asarray(make_filter_ground(cfg, impl=impl)(pts, valid).ground)
         for impl in IMPLS}
    np.testing.assert_array_equal(g["scatter"], g["onehot"])
    assert g["scatter"].sum() > 0


# ---------------------------------------------------------------------------
# dp-sharded engine on 4 virtual devices
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("with_counts", [False, True])
def test_dp_sharded_matches_single_device(with_counts):
    from patchwork_tpu.parallel.mesh import make_mesh
    from patchwork_tpu.parallel.sharded import make_dp_sharded_filter_ground
    from patchwork_tpu.segment.engine import make_filter_ground_batched

    cfg = PatchworkConfig(filtering_radius=60.0, max_levels=3)
    xyz = jnp.asarray(np.stack(
        [demo_point_cloud(2048, seed=50 + i) for i in range(4)]))
    valid = jnp.ones(xyz.shape[:2], bool)
    mesh = make_mesh(4, dp=4, sp=1)
    out = make_dp_sharded_filter_ground(cfg, mesh, with_counts)(xyz, valid)
    single = np.asarray(make_filter_ground_batched(cfg)(xyz, valid).ground)
    res = out[0] if with_counts else out
    np.testing.assert_array_equal(np.asarray(res.ground), single)
    assert len(res.ground.sharding.device_set) == 4
    if with_counts:
        np.testing.assert_array_equal(np.asarray(out[1]), single.sum(axis=1))


# ---------------------------------------------------------------------------
# compile cache, native build, PNG writer
# ---------------------------------------------------------------------------

@pytest.fixture
def restore_cache_dir():
    before = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", before)


def test_compile_cache_default_dir(monkeypatch, restore_cache_dir):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = device.enable_compilation_cache()
    assert path == device.DEFAULT_CACHE_DIR
    assert os.path.dirname(path) == REPO
    assert jax.config.jax_compilation_cache_dir == path
    ignored = subprocess.run(
        ["git", "check-ignore", "-q", path], cwd=REPO).returncode
    assert ignored in (0, 128)  # ignored, or not a git checkout


def test_native_build_key_rebuilds_stale(tmp_path):
    from patchwork_tpu.io import native

    src = tmp_path / "lib.cpp"
    src.write_text('extern "C" int pw_probe() { return 1; }\n')
    build = tmp_path / "build"
    first = native.build_library(str(src), str(build))
    assert native.build_library(str(src), str(build)) == first  # cached
    src.write_text('extern "C" int pw_probe() { return 2; }\n')
    second = native.build_library(str(src), str(build))
    assert second != first and os.path.exists(second)
    import ctypes

    assert ctypes.CDLL(second).pw_probe() == 2
    assert "-march=native" not in native.CXX_FLAGS
    assert native.BUILD_DIR.startswith(os.path.join(REPO, "build"))


def test_native_library_built_from_tracked_source():
    from patchwork_tpu.io import native

    assert native.native_available()
    assert native.SOURCE == os.path.join(REPO, "native", "patchwork_native.cpp")
    assert not os.path.exists(
        os.path.join(REPO, "patchwork_tpu", "io", "_patchwork_native.so"))


def _decode_png(data: bytes) -> np.ndarray:
    """Minimal stdlib decoder for 8-bit RGB, filter-0 PNGs."""
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    pos, idat, w, h = 8, b"", None, None
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        tag = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + length]
        (crc,) = struct.unpack(">I", data[pos + 8 + length:pos + 12 + length])
        assert crc == zlib.crc32(tag + body) & 0xFFFFFFFF
        if tag == b"IHDR":
            w, h, depth, ctype = struct.unpack(">IIBB", body[:10])
            assert (depth, ctype) == (8, 2)
        elif tag == b"IDAT":
            idat += body
        pos += 12 + length
    raw = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, 1 + 3 * w)
    assert (raw[:, 0] == 0).all()
    return raw[:, 1:].reshape(h, w, 3)


def test_png_round_trip(tmp_path):
    from patchwork_tpu.viz.bev import save_png

    img = np.random.default_rng(0).integers(0, 256, (37, 53, 3), np.uint8)
    path = tmp_path / "x.png"
    save_png(jnp.asarray(img), str(path))
    np.testing.assert_array_equal(_decode_png(path.read_bytes()), img)


def test_png_rejects_non_rgb():
    from patchwork_tpu.viz.bev import encode_png

    with pytest.raises(ValueError):
        encode_png(np.zeros((4, 4), np.uint8))


# ---------------------------------------------------------------------------
# chip_smoke.py
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def smoke():
    sys.path.insert(0, REPO)
    import chip_smoke

    return chip_smoke


def test_smoke_engine_phase_tiny(smoke):
    rep = smoke.phase_engine(n=2048, b=2, reps=1, names=("velodyne", "demo"))
    for row in rep.values():
        for impl in IMPLS:
            assert row[impl]["oracle_mismatch_bits"] == [0, 0]


def test_smoke_cli_phase_tiny(smoke):
    rep = smoke.phase_cli(num_points=2000)
    assert rep["ground"] > 0 and rep["non_ground"] > 0


def test_smoke_stream_phase_tiny(smoke):
    rep = smoke.phase_stream(frames=3, n=4096)
    assert rep["p99_ms"] >= rep["p50_ms"] > 0


@pytest.mark.parametrize("ate,ok", [
    ((1.0408, 0.2518, 0.1602), True),   # an H100 run
    ((1.0438, 0.2541, 0.30), False),    # BA worse than the pose graph
    ((1.0438, 0.45, 0.40), False),      # ordered, but far from the CPU value
    ((1.0438, 0.2541, 0.175), False),   # BA 0.016 m off: outside 0.01 m
])
def test_smoke_slam_gates(smoke, monkeypatch, ate, ok):
    class FakeBench:
        @staticmethod
        def run(keyframes, log):
            return dict(zip(("ate_odometry_m", "ate_posegraph_m", "ate_ba_m"),
                            ate), wall_s=1.0)

    monkeypatch.setattr(smoke, "_import_tool", lambda name: FakeBench)
    if ok:
        smoke.phase_slam()
    else:
        with pytest.raises(AssertionError):
            smoke.phase_slam()


def _run_script(args, cwd, env_extra):
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env.update(JAX_PLATFORMS="cpu", **env_extra)
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_smoke_script_fails_without_gpu():
    r = _run_script([os.path.join(REPO, "chip_smoke.py")], REPO, {})
    assert r.returncode != 0
    assert "no GPU found" in r.stderr
    assert '"ok"' not in r.stdout


def test_smoke_script_fails_alone(tmp_path):
    alone = tmp_path / "chip_smoke.py"
    alone.write_bytes(open(os.path.join(REPO, "chip_smoke.py"), "rb").read())
    r = _run_script([str(alone)], str(tmp_path), {"PYTHONPATH": ""})
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def test_smoke_four_cards_on_virtual_devices():
    code = ("import chip_smoke as c; "
            "r = c.phase_four_cards(n=2048, b=4, ba_size=(16, 24, 8)); "
            "print(r['ba']['max_pose_diff'])")
    r = _run_script(["-c", code], REPO, {
        "XLA_FLAGS": "--xla_force_host_platform_device_count=4"})
    assert r.returncode == 0, r.stderr[-2000:]
    assert "mismatch bits vs single device 0" in r.stdout


def test_bench_fails_without_gpu():
    r = _run_script([os.path.join(REPO, "bench.py")], REPO, {})
    assert r.returncode != 0
    assert "no GPU found" in r.stderr
