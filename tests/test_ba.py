"""Schur-complement bundle adjustment: single-device recovery + sharded
parity on the virtual 8-device CPU mesh."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from patchwork_tpu.parallel.mesh import make_mesh
from patchwork_tpu.slam import (
    BAProblem,
    ba_residuals,
    bundle_adjust,
    bundle_adjust_sharded,
    se3_apply,
    se3_exp,
    se3_inverse,
)

RNG = np.random.default_rng(11)


def make_problem(k=6, l=24, noise=0.01, pose_pert=0.05, point_pert=0.1):
    # ground-truth poses along a line, landmarks scattered around
    gt_poses = []
    for i in range(k):
        xi = np.zeros(6, np.float32)
        xi[0] = i * 1.0
        xi[5] = 0.05 * i
        gt_poses.append(np.asarray(se3_exp(jnp.asarray(xi))))
    gt_poses = np.stack(gt_poses)
    gt_points = RNG.uniform(-10, 10, (l, 3)).astype(np.float32)
    gt_points[:, 2] = RNG.uniform(0.5, 3.0, l)

    # every keyframe observes every landmark (dense, padded to multiple of 8)
    ok, ol, op = [], [], []
    for ki in range(k):
        inv = np.asarray(se3_inverse(jnp.asarray(gt_poses[ki])))
        for li in range(l):
            local = inv[:3, :3] @ gt_points[li] + inv[:3, 3]
            op.append(local + RNG.normal(0, noise, 3))
            ok.append(ki)
            ol.append(li)
    n_obs = len(ok)
    pad = (-n_obs) % 8
    ok += [0] * pad
    ol += [0] * pad
    op += [np.zeros(3)] * pad
    w = np.concatenate([np.ones(n_obs), np.zeros(pad)]).astype(np.float32)

    # perturb initial estimates (keyframe 0 is the gauge anchor)
    init_poses = gt_poses.copy()
    for i in range(1, k):
        xi = RNG.normal(0, pose_pert, 6).astype(np.float32)
        init_poses[i] = init_poses[i] @ np.asarray(se3_exp(jnp.asarray(xi)))
    init_points = gt_points + RNG.normal(0, point_pert, (l, 3)).astype(np.float32)

    prob = BAProblem(
        poses=jnp.asarray(init_poses),
        points=jnp.asarray(init_points),
        obs_k=jnp.asarray(np.array(ok, np.int32)),
        obs_l=jnp.asarray(np.array(ol, np.int32)),
        obs_p=jnp.asarray(np.array(op, np.float32)),
        obs_w=jnp.asarray(w),
    )
    return prob, gt_poses, gt_points


def pose_err(poses, gt):
    d = np.asarray(poses)[:, :3, 3] - gt[:, :3, 3]
    return float(np.sqrt((d * d).sum(axis=1).mean()))


class TestBA:
    def test_recovers_geometry(self):
        prob, gt_poses, gt_points = make_problem()
        err0 = pose_err(prob.poses, gt_poses)
        out = bundle_adjust(prob, iters=8)
        err1 = pose_err(out.poses, gt_poses)
        assert err1 < max(err0 * 0.2, 0.02), (err0, err1)
        pt_err = float(np.abs(np.asarray(out.points) - gt_points).mean())
        assert pt_err < 0.05

    def test_residual_decreases(self):
        prob, *_ = make_problem()
        r0 = float(jnp.sum(ba_residuals(prob.poses, prob.points, prob) ** 2))
        out = bundle_adjust(prob, iters=8)
        r1 = float(jnp.sum(ba_residuals(out.poses, out.points, prob) ** 2))
        assert r1 < r0 * 0.1

    def test_zero_noise_exact(self):
        prob, gt_poses, gt_points = make_problem(noise=0.0)
        out = bundle_adjust(prob, iters=10)
        assert pose_err(out.poses, gt_poses) < 1e-3
        assert float(np.abs(np.asarray(out.points) - gt_points).max()) < 1e-2

    def test_pcg_matches_dense(self):
        """The matrix-free Schur-PCG solver (the large-K*L path that never
        materializes the O(K*L) B block — slam/ba.py _schur_pcg_step) must
        agree with the explicit dense solve on a problem small enough to
        run both."""
        prob, gt_poses, _ = make_problem(k=8, l=32)
        outd = bundle_adjust(prob, iters=5, solver="dense")
        outp = bundle_adjust(prob, iters=5, solver="pcg")
        diff = float(np.abs(np.asarray(outd.poses) - np.asarray(outp.poses)).max())
        assert diff < 1e-3, diff
        rd = float(jnp.sum(ba_residuals(outd.poses, outd.points, prob) ** 2))
        rp = float(jnp.sum(ba_residuals(outp.poses, outp.points, prob) ** 2))
        assert rp < rd * 1.05 + 1e-6

    def test_auto_solver_switches_at_scale(self, monkeypatch):
        from patchwork_tpu.slam import ba as ba_mod

        # 1000 kf x 40k landmarks (2.8 GB of dense B blocks) must route
        # to the matrix-free path: K*L far beyond the dense block budget
        assert 1000 * 40000 > ba_mod._DENSE_KL_LIMIT
        # while the test problems stay on the (bitwise-stable) dense path
        assert 8 * 32 <= ba_mod._DENSE_KL_LIMIT

        # actually DRIVE the solver=None auto-dispatch (ADVICE r3): with
        # the limit forced below this problem's K*L, auto must take the
        # pcg branch — bitwise-identical poses to an explicit solver='pcg'
        prob, *_ = make_problem(k=8, l=32)
        monkeypatch.setattr(ba_mod, "_DENSE_KL_LIMIT", 8 * 32 - 1)
        out_auto = ba_mod.bundle_adjust(prob, iters=3, solver=None)
        out_pcg = ba_mod.bundle_adjust(prob, iters=3, solver="pcg")
        assert np.array_equal(np.asarray(out_auto.poses),
                              np.asarray(out_pcg.poses))
        # and with the limit restored above K*L, auto takes the dense path
        monkeypatch.setattr(ba_mod, "_DENSE_KL_LIMIT", 8 * 32 + 1)
        out_auto_d = ba_mod.bundle_adjust(prob, iters=3, solver=None)
        out_dense = ba_mod.bundle_adjust(prob, iters=3, solver="dense")
        assert np.array_equal(np.asarray(out_auto_d.poses),
                              np.asarray(out_dense.poses))

    def test_auto_solver_caps_k(self):
        """The dense direct solve is O((6K)^3) regardless of L: a K=1000
        problem must route to PCG even when K*L sits under the dense
        block budget (round 5: landmark merging flipped a 1000-kf solve
        dense and tripled the BA stage)."""
        from patchwork_tpu.slam.ba import (_DENSE_K_LIMIT, _DENSE_KL_LIMIT,
                                           _auto_solver)

        assert _auto_solver(1000, 414) == "pcg"       # the run-5 shape
        assert 1000 * 414 <= _DENSE_KL_LIMIT          # ...despite KL ok
        assert _auto_solver(100, 500) == "dense"
        assert _auto_solver(_DENSE_K_LIMIT + 1, 10) == "pcg"
        assert _auto_solver(10, 2_000_000) == "pcg"

    def test_seg_sum_impls_agree(self):
        """All three segment-sum impls (sort-cumsum / one-hot matmul /
        scatter-add, slam/ba.py _make_seg_sums) must agree; 'onehot' and
        'scatter' agree to f32 summation-order tolerance, 'sort' to
        prefix-sum f32 tolerance (ADVICE r3 precision note)."""
        from patchwork_tpu.slam.ba import _make_seg_sums

        rng = np.random.default_rng(5)
        n, o = 37, 4096
        idx = jnp.asarray(rng.integers(0, n, o).astype(np.int32))
        vals = jnp.asarray(rng.normal(0, 1, (o, 6)).astype(np.float32))
        outs = {impl: np.asarray(_make_seg_sums(idx, n, impl=impl)(vals))
                for impl in ("sort", "onehot", "scatter")}
        np.testing.assert_allclose(outs["onehot"], outs["scatter"],
                                   rtol=1e-5, atol=1e-4)
        np.testing.assert_allclose(outs["sort"], outs["scatter"],
                                   rtol=1e-4, atol=1e-3)

    def test_onehot_chunked_matches_direct(self, monkeypatch):
        """Above the direct-indicator budget, 'onehot' scans over fixed
        observation chunks (the large-O path, whose compile stays one
        chunk's jaxpr); the chunked sum must match the direct matmul."""
        from patchwork_tpu.slam import ba as ba_mod

        rng = np.random.default_rng(7)
        n, o = 23, 40000  # > 16384: several chunks + a ragged tail
        idx = jnp.asarray(rng.integers(0, n, o).astype(np.int32))
        vals = jnp.asarray(rng.normal(0, 1, (o, 3)).astype(np.float32))
        direct = np.asarray(ba_mod._make_seg_sums(idx, n, impl="onehot")(vals))
        monkeypatch.setattr(ba_mod, "_ONEHOT_DIRECT_BYTES", 0)
        chunked = np.asarray(ba_mod._make_seg_sums(idx, n, impl="onehot")(vals))
        np.testing.assert_allclose(chunked, direct, rtol=1e-5, atol=1e-3)

    def test_analytic_jacobians_match_jacfwd(self, monkeypatch):
        """The closed-form right-perturbation Jacobians (slam/ba.py
        _obs_blocks 'analytic') must match forward-mode AD through the
        full exp-map chain to f32 rounding."""
        from patchwork_tpu.slam.ba import _obs_blocks

        prob, *_ = make_problem(k=5, l=16)
        outs = {}
        for impl in ("analytic", "jacfwd"):
            monkeypatch.setenv("PATCHWORK_TPU_BA_JAC", impl)
            outs[impl] = _obs_blocks(prob.poses, prob.points, prob)
        for a, b, name in zip(outs["analytic"], outs["jacfwd"],
                              ("r", "Jp", "Jx")):
            np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                       rtol=1e-4, atol=1e-5, err_msg=name)

    def test_closed_form_inverses(self):
        """_inv3x3/_inv6x6 (branch-free adjugate + block-Schur) vs
        jnp.linalg.inv on random PD batches."""
        from patchwork_tpu.slam.ba import _inv3x3, _inv6x6

        rng = np.random.default_rng(2)
        for d, fn in ((3, _inv3x3), (6, _inv6x6)):
            a = rng.normal(0, 1, (64, d, d)).astype(np.float32)
            m = a @ a.transpose(0, 2, 1) + 0.1 * np.eye(d, dtype=np.float32)
            got = np.asarray(fn(jnp.asarray(m)))
            ref = np.linalg.inv(m)
            np.testing.assert_allclose(got, ref, rtol=2e-3, atol=2e-3)

    def test_pcg_jac_inv_impls_match(self, monkeypatch):
        """bundle_adjust(solver='pcg') poses must agree across the
        Jacobian and inverse impl knobs (the compile-time levers)."""
        prob, *_ = make_problem(k=8, l=32)
        outs = {}
        for jac, inv in (("analytic", "closed"), ("jacfwd", "lapack")):
            monkeypatch.setenv("PATCHWORK_TPU_BA_JAC", jac)
            monkeypatch.setenv("PATCHWORK_TPU_BA_INV", inv)
            outs[jac] = np.asarray(
                bundle_adjust(prob, iters=4, solver="pcg").poses)
        np.testing.assert_allclose(outs["analytic"], outs["jacfwd"],
                                   atol=1e-4)

    def test_pcg_seg_impls_match(self):
        """bundle_adjust(solver='pcg') poses must agree across the
        segment-sum impls (seg_impl; the hardware A/B lever,
        tools/ba_bench.py --seg)."""
        prob, *_ = make_problem(k=8, l=32)
        outs = {}
        for impl in ("sort", "onehot", "scatter"):
            outs[impl] = np.asarray(bundle_adjust(
                prob, iters=4, solver="pcg", seg_impl=impl).poses)
        np.testing.assert_allclose(outs["onehot"], outs["scatter"], atol=1e-5)
        np.testing.assert_allclose(outs["sort"], outs["scatter"], atol=1e-4)

    @pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 devices")
    def test_sharded_pcg_matches_single(self):
        """Sharded matrix-free BA (psum'd per-observation reductions inside
        CG, O(K+L) collective payload per matvec) vs the single-device PCG
        solver."""
        prob, gt_poses, _ = make_problem(k=8, l=32)
        mesh = make_mesh(8, dp=8, sp=1)
        out_s = bundle_adjust_sharded(prob, mesh, axis="dp", iters=4,
                                      solver="pcg")
        out_1 = bundle_adjust(prob, iters=4, solver="pcg")
        diff = float(np.abs(np.asarray(out_s.poses) - np.asarray(out_1.poses)).max())
        assert diff < 1e-3, diff

    @pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 devices")
    def test_sharded_matches_single(self):
        prob, gt_poses, _ = make_problem()
        mesh = make_mesh(8, dp=8, sp=1)
        out_s = bundle_adjust_sharded(prob, mesh, axis="dp", iters=6)
        out_1 = bundle_adjust(prob, iters=6)
        np.testing.assert_allclose(
            np.asarray(out_s.poses), np.asarray(out_1.poses), atol=5e-3
        )
        assert pose_err(out_s.poses, gt_poses) < 0.05


class TestLandmarkBA:
    def make_odo(self, frames=5, seed=8):
        from patchwork_tpu.core.config import PatchworkConfig
        from patchwork_tpu.io.synthetic import simulate_sequence, simulate_world
        from patchwork_tpu.slam import LidarOdometry, OdometryConfig

        world = simulate_world(seed=seed, num_pillars=60)
        scans, gt = simulate_sequence(num_frames=frames, seed=seed, world=world,
                                      step_xy=0.7, sensor_noise=0.01)
        odo = LidarOdometry(
            patchwork=PatchworkConfig(filtering_radius=80.0, max_levels=1),
            cfg=OdometryConfig(capacity=32768, obstacle_samples=2048,
                               ground_samples=512, icp_iters=8),
        )
        for i, s in enumerate(scans):
            odo.add_scan(s, seed=i)
        return odo, gt

    def test_extract_observations(self):
        from patchwork_tpu.slam import extract_observations

        rng = np.random.default_rng(0)
        # two tight pillar clusters + ground-level noise
        a = np.array([5.0, 5.0, 1.5]) + rng.normal(0, 0.1, (50, 3))
        b = np.array([-8.0, 2.0, 2.0]) + rng.normal(0, 0.1, (50, 3))
        low = rng.uniform(-20, 20, (30, 3)); low[:, 2] = 0.05
        obs = extract_observations(
            np.concatenate([a, b, low]).astype(np.float32), voxel=1.5
        )
        assert 2 <= len(obs) <= 6
        assert (obs[:, 2] > 0.3).all()

    @pytest.mark.slow
    def test_ba_refines_trajectory(self):
        from patchwork_tpu.slam import refine_with_ba
        from patchwork_tpu.slam.ba import ba_residuals
        from patchwork_tpu.slam.landmarks import build_ba_problem, extract_observations

        odo, gt = self.make_odo()
        ate_before = odo.trajectory_error(gt)
        poses = refine_with_ba(odo, iters=6)
        ate_after = odo.trajectory_error(gt)
        assert poses.shape == (5, 4, 4)
        # BA must not blow up the trajectory, and should keep it tight
        assert ate_after < max(ate_before * 1.5, 0.15), (ate_before, ate_after)

    def test_ba_problem_padding_and_tracks(self):
        from patchwork_tpu.slam.landmarks import build_ba_problem

        poses = np.tile(np.eye(4, dtype=np.float32), (3, 1, 1))
        poses[1, 0, 3], poses[2, 0, 3] = 1.0, 2.0
        lm_world = np.array([[5, 5, 2.0], [9, -3, 1.5]], np.float32)
        obs = []
        for k in range(3):
            local = lm_world - poses[k][:3, 3]
            obs.append(local.astype(np.float32))
        prob, n_obs = build_ba_problem(poses, obs, gate=1.0)
        assert n_obs == 6
        assert prob.obs_w.shape[0] % 8 == 0
        assert int(prob.obs_w.sum()) == 6
        assert prob.points.shape[0] == 2
