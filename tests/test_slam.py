"""SLAM back-end tests: SE(3) algebra, ground-constrained ICP, pose-graph
optimization, and end-to-end odometry on a simulated drive."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from patchwork_tpu.core.config import PatchworkConfig
from patchwork_tpu.io.synthetic import simulate_sequence, simulate_world
from patchwork_tpu.slam import (
    LidarOdometry,
    OdometryConfig,
    PoseGraph,
    ate_rmse,
    edge_residuals,
    icp_ground_constrained,
    nearest_neighbors,
    optimize_pose_graph,
    se3_apply,
    se3_exp,
    se3_inverse,
    se3_log,
    so3_exp,
    so3_log,
)

RNG = np.random.default_rng(0)


def rand_twists(n, rot=0.5, trans=2.0):
    xi = RNG.normal(size=(n, 6)).astype(np.float32)
    xi[:, :3] *= trans
    xi[:, 3:] *= rot
    return jnp.asarray(xi)


class TestSE3:
    def test_so3_roundtrip(self):
        w = rand_twists(50)[:, 3:]
        R = so3_exp(w)
        # orthonormal, det +1
        eye = jnp.einsum("nij,nkj->nik", R, R)
        np.testing.assert_allclose(np.asarray(eye), np.eye(3)[None].repeat(50, 0),
                                   atol=1e-5)
        back = so3_log(R)
        np.testing.assert_allclose(np.asarray(back), np.asarray(w), atol=1e-4)

    def test_se3_roundtrip(self):
        xi = rand_twists(50)
        T = se3_exp(xi)
        back = se3_log(T)
        np.testing.assert_allclose(np.asarray(back), np.asarray(xi), atol=2e-4)

    def test_inverse_and_apply(self):
        T = se3_exp(rand_twists(1)[0])
        pts = jnp.asarray(RNG.normal(size=(100, 3)).astype(np.float32))
        there = se3_apply(T, pts)
        back = se3_apply(se3_inverse(T), there)
        np.testing.assert_allclose(np.asarray(back), np.asarray(pts), atol=1e-4)

    def test_identity_log_is_zero(self):
        np.testing.assert_allclose(
            np.asarray(se3_log(jnp.eye(4))), np.zeros(6), atol=1e-7
        )


class TestNearestNeighbors:
    def test_exact_match(self):
        tgt = jnp.asarray(RNG.normal(size=(128, 3)).astype(np.float32))
        idx, d2 = nearest_neighbors(tgt[:32], tgt, jnp.ones(128, bool))
        np.testing.assert_array_equal(np.asarray(idx), np.arange(32))
        np.testing.assert_allclose(np.asarray(d2), 0.0, atol=1e-4)

    def test_invalid_excluded(self):
        tgt = jnp.asarray(np.array([[0, 0, 0], [10, 0, 0]], np.float32))
        src = jnp.asarray(np.array([[0.1, 0, 0]], np.float32))
        valid = jnp.asarray([False, True])
        idx, _ = nearest_neighbors(src, tgt, valid)
        assert int(idx[0]) == 1


def make_icp_problem(xi_true, n_obst=800, n_ground=600, noise=0.01, seed=3):
    rng = np.random.default_rng(seed)
    obst = np.empty((n_obst, 3), np.float32)
    obst[:, :2] = rng.uniform(-20, 20, (n_obst, 2))
    obst[:, 2] = rng.uniform(0.5, 3.0, n_obst)
    ground = np.empty((n_ground, 3), np.float32)
    ground[:, :2] = rng.uniform(-20, 20, (n_ground, 2))
    ground[:, 2] = rng.normal(0, 0.02, n_ground)

    T = se3_exp(jnp.asarray(xi_true, jnp.float32))
    inv = se3_inverse(T)
    src_obst = np.array(se3_apply(inv, jnp.asarray(obst)))
    src_ground = np.array(se3_apply(inv, jnp.asarray(ground)))
    src_obst += rng.normal(0, noise, src_obst.shape).astype(np.float32)
    src_ground += rng.normal(0, noise, src_ground.shape).astype(np.float32)
    ones = lambda n: jnp.ones(n, bool)
    return (
        jnp.asarray(src_obst), ones(n_obst),
        jnp.asarray(src_ground), ones(n_ground),
        jnp.asarray(obst), ones(n_obst),
        jnp.asarray(ground), ones(n_ground),
        np.asarray(T),
    )


class TestICP:
    @pytest.mark.parametrize("xi", [
        [0.3, -0.2, 0.05, 0.0, 0.0, 0.05],
        [0.5, 0.4, -0.1, 0.02, -0.02, 0.1],
    ])
    def test_recovers_transform(self, xi):
        *args, T_true = make_icp_problem(xi)
        res = icp_ground_constrained(*args, iters=15)
        err = np.asarray(se3_log(
            se3_inverse(jnp.asarray(T_true)) @ res.transform
        ))
        assert np.abs(err[:3]).max() < 0.03, err
        assert np.abs(err[3:]).max() < 0.01, err
        assert int(res.num_inliers) > 700

    def test_identity_stays(self):
        *args, T_true = make_icp_problem([0, 0, 0, 0, 0, 0], noise=0.005)
        res = icp_ground_constrained(*args, iters=8)
        err = np.asarray(se3_log(res.transform))
        assert np.abs(err).max() < 0.02

    def test_nn_precision_knob(self, monkeypatch):
        """PATCHWORK_TPU_ICP_NN=default (bf16 correspondence search) must
        still recover the transform — on CPU precisions coincide, so this
        drives the alternate code path (exact recomputed pair distances)
        and pins it to the highest-precision result."""
        from patchwork_tpu.slam import scan_matching

        *args, T_true = make_icp_problem([0.3, -0.2, 0.05, 0.0, 0.0, 0.05])
        ref = np.asarray(icp_ground_constrained(*args, iters=12).transform)
        monkeypatch.setattr(scan_matching, "_NN_PRECISION", "default")
        alt = np.asarray(icp_ground_constrained(*args, iters=12).transform)
        np.testing.assert_allclose(alt, ref, rtol=1e-4, atol=1e-4)

    def test_analytic_jacobians_match_jacfwd(self, monkeypatch):
        """The closed-form GN Jacobians (R [I|-[s]x] point-to-point,
        [(R^T n), g x R^T n] point-to-plane) must land on the same ICP
        solution as the forward-mode AD oracle."""
        from patchwork_tpu.slam import scan_matching

        *args, T_true = make_icp_problem([0.4, -0.3, 0.05, 0.01, 0.0, 0.08])
        outs = {}
        for analytic in (True, False):
            monkeypatch.setattr(scan_matching, "_ANALYTIC_JAC", analytic)
            outs[analytic] = np.asarray(
                icp_ground_constrained(*args, iters=12).transform)
        np.testing.assert_allclose(outs[True], outs[False],
                                   rtol=1e-4, atol=1e-4)


def chain_graph(k=12, drift=0.03, seed=5, closure=True):
    """Ground-truth circle-ish chain + noisy odometry edges + a loop edge."""
    rng = np.random.default_rng(seed)
    gt = [np.eye(4, dtype=np.float32)]
    step = np.asarray(se3_exp(jnp.asarray([1.0, 0, 0, 0, 0, 2 * np.pi / k],
                                          jnp.float32)))
    for _ in range(k - 1):
        gt.append((gt[-1] @ step).astype(np.float32))
    gt = np.stack(gt)

    ei, ej, eT = [], [], []
    for i in range(k - 1):
        noise = se3_exp(jnp.asarray(
            rng.normal(0, drift, 6).astype(np.float32)))
        meas = np.linalg.inv(gt[i]) @ gt[i + 1] @ np.asarray(noise)
        ei.append(i); ej.append(i + 1); eT.append(meas.astype(np.float32))
    if closure:
        for a, b in [(0, k - 1), (0, k // 2)]:
            meas = np.linalg.inv(gt[a]) @ gt[b]
            ei.append(a); ej.append(b); eT.append(meas.astype(np.float32))

    # initial poses: integrate the noisy odometry
    init = [np.eye(4, dtype=np.float32)]
    for i in range(k - 1):
        init.append((init[-1] @ eT[i]).astype(np.float32))
    info = np.tile(np.eye(6, dtype=np.float32) * 100.0, (len(ei), 1, 1))
    if closure:
        info[-2:] *= 100.0
    g = PoseGraph(
        poses=jnp.asarray(np.stack(init)),
        edge_i=jnp.asarray(np.array(ei, np.int32)),
        edge_j=jnp.asarray(np.array(ej, np.int32)),
        edge_T=jnp.asarray(np.stack(eT)),
        edge_info=jnp.asarray(info),
    )
    return g, gt


class TestPoseGraph:
    def test_analytic_edge_jacobians_match_jacfwd(self, monkeypatch):
        """The closed-form edge Jacobians (Jr^-1 + adjoint, slam/se3.py
        right-Jacobian machinery incl. the Q coupling block) must match
        forward-mode AD through log(Tm^-1 (Ti exp(xi_i))^-1 Tj exp(xi_j))
        to f32 rounding — including at sizable residuals."""
        from patchwork_tpu.slam.pose_graph import _edge_jacobians

        # noisy graph -> non-trivial residuals at the linearization point
        g, _ = chain_graph(k=10, drift=0.15, closure=True)
        rng = np.random.default_rng(3)
        poses = np.asarray(g.poses).copy()
        for i in range(1, len(poses)):
            xi = rng.normal(0, 0.2, 6).astype(np.float32)
            poses[i] = poses[i] @ np.asarray(se3_exp(jnp.asarray(xi)))
        poses = jnp.asarray(poses)

        outs = {}
        for impl in ("analytic", "jacfwd"):
            monkeypatch.setenv("PATCHWORK_TPU_PG_JAC", impl)
            outs[impl] = _edge_jacobians(poses, g)
        for a, b, name in zip(outs["analytic"], outs["jacfwd"],
                              ("r", "Ji", "Jj")):
            np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                       rtol=2e-3, atol=2e-4, err_msg=name)

    def test_optimize_impls_agree(self, monkeypatch):
        """Full pose-graph optimization must land on the same poses under
        both Jacobian impls."""
        g, gt = chain_graph(k=12, drift=0.05, closure=True)
        outs = {}
        for impl in ("analytic", "jacfwd"):
            monkeypatch.setenv("PATCHWORK_TPU_PG_JAC", impl)
            outs[impl] = np.asarray(optimize_pose_graph(g, iters=8).poses)
        np.testing.assert_allclose(outs["analytic"], outs["jacfwd"],
                                   rtol=1e-4, atol=1e-4)

    def test_residuals_zero_on_truth(self):
        g, gt = chain_graph(drift=0.0, closure=True)
        r = edge_residuals(jnp.asarray(gt), g)
        np.testing.assert_allclose(np.asarray(r), 0.0, atol=1e-4)

    def test_optimization_reduces_ate(self):
        g, gt = chain_graph(k=12, drift=0.05)
        ate_before = float(ate_rmse(g.poses, jnp.asarray(gt)))
        g2 = optimize_pose_graph(g, iters=10)
        ate_after = float(ate_rmse(g2.poses, jnp.asarray(gt)))
        assert ate_after < ate_before * 0.5, (ate_before, ate_after)
        # total weighted residual must also drop
        def chi2(poses):
            r = edge_residuals(poses, g)
            return float(jnp.einsum("ei,eij,ej->", r, g.edge_info, r))
        assert chi2(g2.poses) < chi2(g.poses) * 0.1

    def test_perfect_edges_give_exact_graph(self):
        g, gt = chain_graph(drift=0.0, closure=True)
        g2 = optimize_pose_graph(g, iters=5)
        assert float(ate_rmse(g2.poses, jnp.asarray(gt))) < 1e-3


class TestOdometry:
    def test_simulated_drive(self):
        world = simulate_world(seed=2, num_pillars=50)
        scans, gt = simulate_sequence(num_frames=6, seed=2, world=world,
                                      step_xy=0.8, sensor_noise=0.01)
        odo = LidarOdometry(
            patchwork=PatchworkConfig(filtering_radius=80.0, max_levels=2),
            cfg=OdometryConfig(capacity=32768, obstacle_samples=1024,
                               ground_samples=512, icp_iters=10),
        )
        for i, s in enumerate(scans):
            odo.add_scan(s, seed=i)
        ate = odo.trajectory_error(gt)
        assert ate < 0.15, ate

    @pytest.mark.slow
    def test_loop_closure_and_optimize(self):
        world = simulate_world(seed=4, num_pillars=50)
        scans, gt = simulate_sequence(num_frames=5, seed=4, world=world,
                                      step_xy=0.6, sensor_noise=0.01)
        odo = LidarOdometry(
            patchwork=PatchworkConfig(filtering_radius=80.0, max_levels=2),
            cfg=OdometryConfig(capacity=32768, obstacle_samples=1024,
                               ground_samples=512, icp_iters=10),
        )
        for i, s in enumerate(scans):
            odo.add_scan(s, seed=i)
        odo.add_loop_closure(0, len(scans) - 1)
        poses = odo.optimize(iters=8)
        assert poses.shape == (5, 4, 4)
        ate = odo.trajectory_error(gt)
        assert ate < 0.15, ate

    def test_parallel_icp_matches_sequential(self):
        """parallel_icp (vmapped pair solves + selective warm-start retry)
        reproduces the sequential chain's trajectory to mm accuracy."""
        world = simulate_world(seed=2, num_pillars=50)
        scans, gt = simulate_sequence(num_frames=6, seed=2, world=world,
                                      step_xy=0.8, sensor_noise=0.01)

        def mk():
            return LidarOdometry(
                patchwork=PatchworkConfig(filtering_radius=80.0,
                                          max_levels=2),
                cfg=OdometryConfig(capacity=32768, obstacle_samples=1024,
                                   ground_samples=512, icp_iters=10),
            )

        seq = mk()
        seq.add_scans(scans)
        par = mk()
        par.add_scans(scans, parallel_icp=True, pair_chunk=4)
        assert par.trajectory_error(gt) < 0.15
        p1, p2 = np.stack(seq.poses), np.stack(par.poses)
        assert np.abs(p1[:, :3, 3] - p2[:, :3, 3]).max() < 0.02
        # same graph structure: odometry edges between consecutive frames
        assert len(par.edges) == len(scans) - 1
        # frames populated -> loop closures still work on top
        assert len(par._frames) == len(scans)

    def test_parallel_icp_guards(self):
        odo = LidarOdometry(
            cfg=OdometryConfig(capacity=1024, keyframe_every=2))
        with pytest.raises(ValueError):
            odo.add_scans([np.zeros((8, 3), np.float32)], parallel_icp=True)

    def test_keyframe_cadence(self):
        world = simulate_world(seed=6, num_pillars=50)
        scans, gt = simulate_sequence(num_frames=7, seed=6, world=world,
                                      step_xy=0.4, sensor_noise=0.01)
        odo = LidarOdometry(
            patchwork=PatchworkConfig(filtering_radius=80.0, max_levels=1),
            cfg=OdometryConfig(capacity=32768, obstacle_samples=1024,
                               ground_samples=512, icp_iters=8,
                               keyframe_every=2),
        )
        for i, s in enumerate(scans):
            pose = odo.add_scan(s, seed=i)
        # 7 frames at cadence 2 -> keyframes at frames 0,2,4,6
        assert len(odo.poses) == 4
        assert len(odo.edges) == 3
        # live pose still tracks ground truth
        d = pose[:3, 3] - gt[-1][:3, 3]
        assert np.linalg.norm(d) < 0.2

    @pytest.mark.slow
    def test_automatic_loop_closure_detection(self):
        """Drive a circular loop (small per-frame motion, as a real frame
        rate gives): the detector must find the revisit, verify it by ICP,
        and graph optimization must keep the trajectory tight."""
        world = simulate_world(seed=12, num_pillars=70)
        import numpy as _np
        scans, gt = [], []
        pose = _np.eye(4, dtype=_np.float32)
        k = 20
        steps = [(0.8, 2 * _np.pi / k)] * k  # closes after k frames
        rng = _np.random.default_rng(12)
        for fwd, yaw in steps:
            inv = _np.linalg.inv(pose).astype(_np.float32)
            local = world @ inv[:3, :3].T + inv[:3, 3]
            local = local + rng.normal(0, 0.01, local.shape).astype(_np.float32)
            scans.append(local.astype(_np.float32))
            gt.append(pose.copy())
            c, s = _np.cos(yaw), _np.sin(yaw)
            step = _np.eye(4, dtype=_np.float32)
            step[:3, :3] = _np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]],
                                     _np.float32)
            step[0, 3] = fwd
            pose = (pose @ step).astype(_np.float32)
        gt = _np.stack(gt)

        odo = LidarOdometry(
            patchwork=PatchworkConfig(filtering_radius=80.0, max_levels=1),
            cfg=OdometryConfig(capacity=32768, obstacle_samples=1024,
                               ground_samples=512, icp_iters=12),
        )
        for i, s in enumerate(scans):
            odo.add_scan(s, seed=i)
        ate_odo = odo.trajectory_error(gt)
        accepted = odo.detect_loop_closures(radius=2.0, min_separation=10,
                                            min_inliers=100)
        assert accepted, "no loop closures detected on a closed loop"
        odo.optimize(iters=8)
        ate_opt = odo.trajectory_error(gt)
        assert ate_opt < 0.35, (ate_odo, ate_opt)
        assert ate_opt < ate_odo * 0.6  # closures must actually correct drift


class TestLoopClosureSelection:
    """Adaptive budget + trajectory-spread candidate selection + chunked
    vmapped verification (VERDICT r4 item 4: the fixed max_candidates=10
    cap left exactly 10 clustered closures on every 1000-kf run)."""

    def _fake_odo(self, k=200, laps=2):
        import numpy as _np

        odo = LidarOdometry(
            patchwork=PatchworkConfig(filtering_radius=80.0, max_levels=1),
            cfg=OdometryConfig(capacity=1024, obstacle_samples=64,
                               ground_samples=32),
        )
        yaw_step = 2 * _np.pi * laps / k
        pose = _np.eye(4, dtype=_np.float32)
        for i in range(k):
            odo.poses.append(pose.copy())
            odo._frames.append({
                "obst": jnp.zeros((64, 3)), "obst_valid": jnp.ones(64, bool),
                "ground": jnp.zeros((32, 3)),
                "ground_valid": jnp.ones(32, bool)})
            c, s = _np.cos(yaw_step), _np.sin(yaw_step)
            step = _np.eye(4, dtype=_np.float32)
            step[:3, :3] = [[c, -s, 0], [s, c, 0], [0, 0, 1]]
            step[0, 3] = 0.8
            pose = (pose @ step).astype(_np.float32)

        from patchwork_tpu.slam.scan_matching import MatchResult

        calls = []

        def fake_match_pairs(src, tgt, inits):
            calls.append(int(inits.shape[0]))
            m = inits.shape[0]
            return MatchResult(transform=inits,
                               num_inliers=jnp.full((m,), 1000, jnp.int32),
                               rmse=jnp.zeros((m,)))

        odo._match_pairs = fake_match_pairs
        return odo, calls

    def test_adaptive_budget_and_spread(self):
        import numpy as _np

        k = 200
        odo, calls = self._fake_odo(k=k, laps=2)
        accepted = odo.detect_loop_closures(
            radius=3.0, min_separation=50, max_candidates=None,
            pair_chunk=8)
        # adaptive budget is ~K/3, far beyond the old fixed 10
        budget = max(10, k // 3)
        assert len(accepted) == budget, len(accepted)
        # verification was chunked (8 per dispatch), not per-candidate
        assert all(c == 8 for c in calls)
        assert len(calls) == -(-budget // 8)
        # closures are SPREAD: the later keyframes cover (nearly) every
        # trajectory bucket in the revisit span (second lap), not one
        # revisit cluster
        spacing = max(1, -(-k // budget))
        bins = {j // spacing for _, j in accepted}
        span_bins = k // 2 // spacing  # buckets in the second lap
        assert len(bins) >= span_bins, (len(bins), span_bins, accepted)
        # all accepted edges were recorded, none duplicated
        pairs = [(i, j) for i, j, _ in odo.edges]
        assert len(pairs) == len(set(pairs)) == len(accepted)
        # re-detection skips existing edges rather than re-adding them
        accepted2 = odo.detect_loop_closures(
            radius=3.0, min_separation=50, max_candidates=None,
            pair_chunk=8)
        inter = set(accepted) & set(accepted2)
        assert not inter

    def test_fixed_budget_unchanged(self):
        odo, _ = self._fake_odo(k=120, laps=2)
        accepted = odo.detect_loop_closures(
            radius=3.0, min_separation=30, max_candidates=5, pair_chunk=4)
        assert len(accepted) == 5


class TestMapping:
    """World-frame map assembly + npz/PLY export (slam/mapping.py)."""

    def _run_odo(self):
        world = simulate_world(seed=5, num_pillars=40)
        scans, gt = simulate_sequence(num_frames=5, seed=2, world=world,
                                      step_xy=0.8)
        odo = LidarOdometry(
            patchwork=PatchworkConfig(filtering_radius=80.0, max_levels=1),
            cfg=OdometryConfig(capacity=16384, obstacle_samples=512,
                               ground_samples=256),
        )
        odo.add_scans(scans, parallel_icp=True, batch=3)
        return odo, world

    def test_build_map_world_frame(self):
        from patchwork_tpu.slam import build_map

        odo, world = self._run_odo()
        m = build_map(odo, voxel=None)
        assert len(m["points"]) > 0
        assert m["trajectory"].shape == (5, 3)
        assert set(np.unique(m["classes"])) <= {0, 1}
        # obstacle map points must lie near true pillar locations: with
        # good odometry the world-frame re-projection reconstructs the
        # world (coarse gate: within 1 m of SOME world obstacle point)
        obst = m["points"][m["classes"] == 1]
        wobst = world[world[:, 2] > 0.4]
        sub = obst[:: max(1, len(obst) // 200)]
        d = np.linalg.norm(sub[:, None, :2] - wobst[None, :, :2], axis=-1)
        frac_near = (d.min(axis=1) < 1.0).mean()
        assert frac_near > 0.9, frac_near
        # voxel dedup shrinks the cloud
        m2 = build_map(odo, voxel=1.0)
        assert 0 < len(m2["points"]) < len(m["points"])

    def test_export_roundtrip(self, tmp_path):
        from patchwork_tpu.slam import save_map_npz, save_map_ply

        odo, _ = self._run_odo()
        npz = tmp_path / "map.npz"
        m = save_map_npz(str(npz), odo, voxel=1.0)
        loaded = np.load(npz)
        np.testing.assert_array_equal(loaded["points"], m["points"])
        np.testing.assert_array_equal(loaded["poses"], m["poses"])

        ply = tmp_path / "map.ply"
        n = save_map_ply(str(ply), odo, voxel=1.0)
        lines = ply.read_text().splitlines()
        assert lines[0] == "ply"
        assert f"element vertex {n}" in "\n".join(lines[:8])
        body = [ln for ln in lines[lines.index("end_header") + 1:] if ln]
        assert len(body) == n
        assert len(body[0].split()) == 6  # x y z r g b


class TestMatchMany:
    """The single-dispatch whole-pass solver (lax.map over (C, chunk)
    grids) must produce the same transforms as per-chunk vmapped solves —
    it is pure dispatch restructuring, not a numerical change."""

    def test_matches_match_pairs(self):
        import numpy as _np

        from patchwork_tpu.slam.odometry import _FRAME_KEYS

        odo = LidarOdometry(
            patchwork=PatchworkConfig(filtering_radius=80.0, max_levels=1),
            cfg=OdometryConfig(capacity=2048, obstacle_samples=256,
                               ground_samples=128, icp_iters=6),
        )
        rng = _np.random.default_rng(7)
        k = 9
        stacked = {
            "obst": jnp.asarray(rng.uniform(-20, 20, (k, 256, 3)).astype(
                _np.float32)),
            "obst_valid": jnp.ones((k, 256), bool),
            "ground": jnp.asarray(_np.concatenate([
                rng.uniform(-20, 20, (k, 128, 2)),
                rng.normal(0, 0.02, (k, 128, 1))], axis=-1).astype(
                    _np.float32)),
            "ground_valid": jnp.ones((k, 128), bool),
        }
        pair_idx = _np.arange(k - 1)
        inits = _np.broadcast_to(_np.eye(4, dtype=_np.float32),
                                 (k - 1, 4, 4))
        # production whole-pass path (pads 2 chunks of 4 for 8 pairs)
        Ts, rmses = odo._solve_pairs(stacked, pair_idx, inits, 4)
        assert Ts.shape == (k - 1, 4, 4) and rmses.shape == (k - 1,)
        # reference: per-chunk vmapped solves
        for s0 in range(0, k - 1, 4):
            at = _np.minimum(_np.arange(s0, s0 + 4), k - 2)
            src = {key: stacked[key][at + 1] for key in _FRAME_KEYS}
            tgt = {key: stacked[key][at] for key in _FRAME_KEYS}
            ref = odo._match_pairs(src, tgt, jnp.asarray(inits[at]))
            keep = min(4, k - 1 - s0)
            np.testing.assert_allclose(
                Ts[s0:s0 + keep], np.asarray(ref.transform)[:keep],
                rtol=1e-5, atol=1e-5)
            np.testing.assert_allclose(
                rmses[s0:s0 + keep], np.asarray(ref.rmse)[:keep],
                rtol=1e-4, atol=1e-5)


class TestUploadQuant:
    """Opt-in int16 fixed-point scan upload (PATCHWORK_TPU_UPLOAD_QUANT).

    Halves the upload payload of the extract stage; +-2.5 mm
    quantization error must stay noise-level for the pipeline."""

    def test_int16_roundtrip_error_bound(self):
        from patchwork_tpu.slam.odometry import _QUANT_SCALE

        rng = np.random.default_rng(0)
        xyz = rng.uniform(-120, 120, (4096, 3)).astype(np.float32)
        q = np.clip(np.round(xyz / _QUANT_SCALE), -32767, 32767).astype(
            np.int16)
        back = q.astype(np.float32) * _QUANT_SCALE
        # half a quantization step plus the f32 ulp of the dequant product
        assert np.abs(back - xyz).max() <= _QUANT_SCALE / 2 * 1.02

    def test_pipeline_quality_with_quant(self, monkeypatch):
        monkeypatch.setenv("PATCHWORK_TPU_UPLOAD_QUANT", "int16")
        world = simulate_world(seed=5, num_pillars=50)
        scans, gt = simulate_sequence(num_frames=6, seed=2, world=world,
                                      step_xy=0.8)
        odo = LidarOdometry(
            patchwork=PatchworkConfig(filtering_radius=80.0, max_levels=1),
            cfg=OdometryConfig(capacity=16384, obstacle_samples=512,
                               ground_samples=256),
        )
        odo.add_scans(scans, parallel_icp=True, batch=3)
        ate = odo.trajectory_error(gt)
        assert ate < 0.25, ate  # same bound as the unquantized path


class TestCGSolver:
    """Matrix-free block-Jacobi PCG vs the dense LU path (pose_graph.py)."""

    def test_cg_matches_dense(self):
        from patchwork_tpu.slam.pose_graph import ate_rmse

        g, gt = chain_graph(k=24, drift=0.05, seed=11)
        gd = optimize_pose_graph(g, iters=8, solver="dense")
        gc = optimize_pose_graph(g, iters=8, solver="cg")
        # both converge to the same optimum (gauge-anchored at pose 0)
        d = np.asarray(gd.poses) - np.asarray(gc.poses)
        assert np.abs(d).max() < 1e-3, np.abs(d).max()
        ate_d = float(ate_rmse(gd.poses, jnp.asarray(gt)))
        ate_c = float(ate_rmse(gc.poses, jnp.asarray(gt)))
        assert abs(ate_d - ate_c) < 1e-4
        assert ate_c < float(ate_rmse(g.poses, jnp.asarray(gt)))

    @pytest.mark.slow
    def test_cg_large_graph(self):
        # K where the dense (6K,6K) path starts to hurt; CG stays O(E).
        # A 400-pose circle with 2 closures is gauge-sloppy (flat modes),
        # so the meaningful check is chi2 convergence, not ATE to gt.
        from patchwork_tpu.slam.pose_graph import ate_rmse

        g, gt = chain_graph(k=400, drift=0.01, seed=13)
        g2 = optimize_pose_graph(g, iters=5, solver="cg")

        def chi2(p):
            r = np.asarray(edge_residuals(p, g))
            return float((r * r).sum())

        before, after = chi2(g.poses), chi2(g2.poses)
        assert after < before / 1000.0, (before, after)
        assert float(ate_rmse(g2.poses, jnp.asarray(gt))) <= float(
            ate_rmse(g.poses, jnp.asarray(gt)))

    def test_auto_solver_selection(self):
        g, _ = chain_graph(k=12, drift=0.02, seed=7)
        # None -> dense for small K; both must run and reduce chi2
        g2 = optimize_pose_graph(g, iters=5, solver=None)
        r0 = np.abs(np.asarray(edge_residuals(g.poses, g))).sum()
        r1 = np.abs(np.asarray(edge_residuals(g2.poses, g))).sum()
        assert r1 < r0


class TestSparsify:
    def test_keeps_backbone_caps_degree(self):
        from patchwork_tpu.slam.pose_graph import sparsify_pose_graph

        g, _ = chain_graph(k=16, drift=0.02, seed=9)
        # add many redundant low-information loop edges onto node 0
        import numpy as _np
        extra = 10
        ei = _np.concatenate([_np.asarray(g.edge_i), _np.zeros(extra, _np.int32)])
        ej = _np.concatenate([_np.asarray(g.edge_j),
                              _np.arange(3, 3 + extra, dtype=_np.int32)])
        eT = _np.concatenate([_np.asarray(g.edge_T),
                              _np.tile(_np.eye(4, dtype=_np.float32),
                                       (extra, 1, 1))])
        info = _np.concatenate([_np.asarray(g.edge_info),
                                _np.tile(_np.eye(6, dtype=_np.float32),
                                         (extra, 1, 1))])
        from patchwork_tpu.slam.pose_graph import PoseGraph as PG
        g_big = PG(g.poses, jnp.asarray(ei), jnp.asarray(ej),
                   jnp.asarray(eT), jnp.asarray(info))
        g_sp = sparsify_pose_graph(g_big, max_degree=2)

        ei_s = _np.asarray(g_sp.edge_i)
        ej_s = _np.asarray(g_sp.edge_j)
        # full odometry backbone survives
        odo = set(zip(ei_s.tolist(), ej_s.tolist()))
        for i in range(15):
            assert (i, i + 1) in odo
        # loop degree capped: node 0 has at most 2 non-backbone edges
        nonbb = [(a, b) for a, b in zip(ei_s, ej_s) if abs(a - b) != 1]
        deg0 = sum(1 for a, b in nonbb if a == 0 or b == 0)
        assert deg0 <= 2, deg0
        # the high-information original closures outrank the padding
        assert (0, 15) in odo or (0, 8) in odo


class TestLandmarkGrid:
    def test_matches_bruteforce_association(self):
        """The voxel-hash NN index must reproduce the greedy sequential
        association exactly (same accept/reject, same landmark ids)."""
        from patchwork_tpu.slam.landmarks import _LandmarkGrid

        rng = np.random.default_rng(0)
        gate = 1.0
        grid = _LandmarkGrid(gate)
        # brute-force twin
        pos, counts = [], []
        for step in range(400):
            w = rng.uniform(-20, 20, 3).astype(np.float32)
            # occasionally revisit an existing landmark
            if pos and rng.random() < 0.5:
                w = pos[int(rng.integers(len(pos)))] + rng.normal(0, 0.3, 3).astype(np.float32)
            # brute force
            if pos:
                d = np.linalg.norm(np.stack(pos) - w, axis=1)
                jb = int(np.argmin(d))
                hit_b = d[jb] < gate
            else:
                hit_b = False
            jg = grid.nearest(w)
            assert (jg >= 0) == hit_b, step
            if hit_b:
                assert jg == jb, (step, jg, jb)
                c = counts[jb]
                pos[jb] = ((pos[jb] * c + w) / (c + 1)).astype(np.float32)
                counts[jb] = c + 1
                grid.update(jg, w)
                np.testing.assert_allclose(grid.pos[jg], pos[jb], rtol=1e-6)
            else:
                grid.insert(w)
                pos.append(np.asarray(w, np.float32))
                counts.append(1)

    def test_scales_past_bruteforce(self):
        # 100-keyframe-scale association finishes fast (the old
        # per-observation re-stack scan was quadratic)
        import time

        from patchwork_tpu.slam.landmarks import build_ba_problem

        rng = np.random.default_rng(1)
        world = rng.uniform(-60, 60, (600, 3)).astype(np.float32)
        poses = np.tile(np.eye(4, dtype=np.float32), (120, 1, 1))
        poses[:, 0, 3] = np.linspace(0, 50, 120)
        obs = []
        for k in range(120):
            sel = world[rng.random(len(world)) < 0.3]
            local = sel - poses[k][:3, 3]
            obs.append((local + rng.normal(0, 0.05, local.shape)).astype(np.float32))
        t0 = time.perf_counter()
        prob, n_obs = build_ba_problem(poses, obs, gate=1.0)
        dt = time.perf_counter() - t0
        assert n_obs > 1000
        assert dt < 10.0, f"association took {dt:.1f}s"

    def test_batched_matches_sequential_exactly(self):
        """build_ba_problem's batched associator (kd-tree snapshot +
        dirty-overlay) must reproduce the sequential _LandmarkGrid walk
        EXACTLY: same landmark ids, running means, and counts — including
        intra-keyframe matches against landmarks born/updated earlier in
        the same keyframe (the duplicated observations below force those)."""
        from patchwork_tpu.slam.landmarks import (
            _BatchedAssociator,
            _LandmarkGrid,
        )

        rng = np.random.default_rng(7)
        world = rng.uniform(-15, 15, (120, 3)).astype(np.float32)
        K = 40
        poses = np.tile(np.eye(4, dtype=np.float32), (K, 1, 1))
        poses[:, 0, 3] = np.linspace(0, 10, K)
        frames = []
        for k in range(K):
            sel = world[rng.random(len(world)) < 0.6]
            dup = sel[:10] + rng.normal(0, 0.2, (min(10, len(sel)), 3)).astype(
                np.float32
            )
            local = np.concatenate([sel, dup]) - poses[k][:3, 3]
            frames.append(
                (local + rng.normal(0, 0.15, local.shape)).astype(np.float32)
            )

        grid = _LandmarkGrid(1.0)
        seq_ids = []
        assoc = _BatchedAssociator(1.0)
        bat_ids = []
        for k, obs in enumerate(frames):
            R, t = poses[k][:3, :3], poses[k][:3, 3]
            w = (obs @ R.T + t).astype(np.float32)
            bat_ids.append(assoc.associate(w))
            for p in w:
                j = grid.nearest(p)
                if j >= 0:
                    grid.update(j, p)
                else:
                    j = grid.insert(p)
                seq_ids.append(j)
        assert np.array_equal(np.array(seq_ids), np.concatenate(bat_ids))
        assert assoc.n == len(grid.pos)
        np.testing.assert_allclose(
            assoc.pos[: assoc.n], np.stack(grid.pos), rtol=1e-5, atol=1e-6
        )
        assert np.array_equal(assoc.counts[: assoc.n], np.array(grid.counts))

    def test_native_matches_batched_exactly(self):
        """The C++ associator (production path) must agree with the Python
        batched associator observation-for-observation."""
        from patchwork_tpu.io.native import NativeAssociator
        from patchwork_tpu.slam.landmarks import _BatchedAssociator

        try:
            na = NativeAssociator(1.0)
        except RuntimeError:
            pytest.skip("native library unavailable")
        ba = _BatchedAssociator(1.0)
        rng = np.random.default_rng(13)
        world = rng.uniform(-25, 25, (200, 3)).astype(np.float32)
        for k in range(60):
            sel = world[rng.random(len(world)) < 0.5]
            dup = sel[:15] + rng.normal(0, 0.25, (min(15, len(sel)), 3))
            w = np.concatenate([sel, dup.astype(np.float32)])
            w = (w + rng.normal(0, 0.1, w.shape)).astype(np.float32)
            assert np.array_equal(na.associate(w), ba.associate(w)), k
        pos, cnt = na.export()
        assert na.n == ba.n
        np.testing.assert_allclose(pos, ba.pos[: ba.n], rtol=1e-5, atol=1e-6)
        assert np.array_equal(cnt, ba.counts[: ba.n])

    @pytest.mark.slow
    def test_thousand_keyframe_association_under_5s(self):
        """VERDICT r2 item 7 'done' bar: 1000-kf association < 5 s."""
        import time

        from patchwork_tpu.slam.landmarks import build_ba_problem

        rng = np.random.default_rng(1)
        world = rng.uniform(-300, 300, (5000, 3)).astype(np.float32)
        K = 1000
        poses = np.tile(np.eye(4, dtype=np.float32), (K, 1, 1))
        poses[:, 0, 3] = np.linspace(0, 400, K)
        obs = []
        for k in range(K):
            sel = world[rng.random(len(world)) < 0.04]
            local = sel - poses[k][:3, 3]
            obs.append(
                (local + rng.normal(0, 0.05, local.shape)).astype(np.float32)
            )
        t0 = time.perf_counter()
        prob, n_obs = build_ba_problem(poses, obs, gate=1.0)
        dt = time.perf_counter() - t0
        assert n_obs > 100_000
        assert dt < 5.0, f"association took {dt:.1f}s"


class TestSlamBench:
    @pytest.mark.slow
    def test_end_to_end_small(self):
        import os
        import sys

        sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..",
                                        "tools"))
        import slam_bench

        out = slam_bench.run(20, seed=3, ba_iters=2, log=lambda *a: None)
        assert out["keyframes"] == 20
        assert out["ate_posegraph_m"] < 0.5
        assert out["value"] < 0.5
