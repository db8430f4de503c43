"""Global pose-graph optimizer (matrix-free LM-PCG): synthetic SE(2)/SE(3)
pose graphs with loop closures, gauge behavior, engine integration."""

import numpy as np
import pytest

from srba_tpu.ops.np_lie import NpSE2, NpSE3
from srba_tpu.solver.global_graphslam import (PGOConfig,
                                              optimize_global_pose_graph)


def _circle_problem(group, K=60, noise=0.02, n_closures=6, seed=0):
    """Noisy dead-reckoned circle with exact-ish loop-closure constraints."""
    rng = np.random.default_rng(seed)
    np_g = NpSE2 if group == "SE2" else NpSE3
    dof = 3 if group == "SE2" else 6
    # Ground-truth poses around a circle.
    gt = []
    for k in range(K):
        th = 2 * np.pi * k / K
        if group == "SE2":
            gt.append(np.asarray([5 * np.cos(th), 5 * np.sin(th),
                                  th + np.pi / 2], np.float32))
        else:
            p = NpSE3.pexp(np.asarray(
                [5 * np.cos(th), 5 * np.sin(th), 0.1 * np.sin(2 * th),
                 0, 0, th + np.pi / 2], np.float32))
            gt.append(p.astype(np.float32))
    gt = np.stack(gt)

    def rel(i, j):
        return np_g.compose(np_g.inverse(gt[i]), gt[j]).astype(np.float32)

    edges = []
    # Odometry chain with noise on the measurement.
    for k in range(1, K):
        zn = np_g.retract(rel(k - 1, k),
                          rng.normal(0, noise, dof).astype(np.float32))
        edges.append({"from": k - 1, "to": k,
                      "rel_pose": np.asarray(zn, np.float32)})
    # Loop closures (low noise) spread around the circle.
    for c in range(n_closures):
        i = int(c * K / n_closures)
        j = (i + K // 2) % K
        zn = np_g.retract(rel(i, j),
                          rng.normal(0, noise / 10, dof).astype(np.float32))
        edges.append({"from": i, "to": j,
                      "rel_pose": np.asarray(zn, np.float32)})

    # Initial nodes: dead-reckon the noisy odometry (drifts).
    nodes = np.zeros_like(gt)
    nodes[0] = gt[0]
    for k in range(1, K):
        nodes[k] = np_g.compose(nodes[k - 1], edges[k - 1]["rel_pose"])
    return {"group": group, "nodes": nodes, "edges": edges,
            "reachable": list(range(K))}, gt


def _pos_ate(G, gt, d):
    a = np.asarray(G, np.float64)[:, :d] - np.asarray(gt, np.float64)[:, :d]
    return float(np.sqrt(np.mean(np.sum(a * a, axis=-1))))


@pytest.mark.parametrize("group,d", [("SE2", 2), ("SE3", 3)])
def test_circle_converges(group, d):
    prob, gt = _circle_problem(group)
    ate0 = _pos_ate(prob["nodes"], gt, d)
    G, info = optimize_global_pose_graph(prob)
    ate1 = _pos_ate(G, gt, d)
    assert info["err_final"] < info["err_init"]
    assert ate1 < 0.35 * ate0, (ate0, ate1)
    # Gauge: node 0 untouched.
    np.testing.assert_allclose(G[0], prob["nodes"][0], atol=1e-6)


def test_zero_noise_is_fixpointish():
    prob, gt = _circle_problem("SE2", noise=0.0)
    G, info = optimize_global_pose_graph(prob)
    assert info["err_final"] < 1e-8
    assert _pos_ate(G, gt, 2) < 1e-3


def test_spmd_pgo_matches_single_device():
    import jax

    if len(jax.devices()) < 4:
        pytest.skip("needs >= 4 devices (CPU mesh)")
    from srba_tpu.parallel.sharding import make_mesh

    prob, gt = _circle_problem("SE2", K=40, n_closures=5, seed=3)
    G1, i1 = optimize_global_pose_graph(prob)
    mesh = make_mesh(4)
    GN, iN = optimize_global_pose_graph(prob, mesh=mesh)
    assert iN["err_final"] == pytest.approx(i1["err_final"],
                                            rel=1e-3, abs=1e-7)
    np.testing.assert_allclose(GN, G1, rtol=1e-3, atol=1e-3)


def test_engine_optimize_global_improves_map():
    from srba_tpu import Observation, SrbaEngine, SrbaParams
    from srba_tpu.utils.datasets import make_graph_slam_dataset, \
        make_world_loop_2d

    world = make_world_loop_2d(num_kfs=30, radius=6.0, num_landmarks=1,
                               seed=2)
    ds = make_graph_slam_dataset(world, noise_std=0.01,
                                 loop_closure_range=3.0, seed=2)
    eng = SrbaEngine("RelativePoses2D",
                     params=SrbaParams(max_tree_depth=3,
                                       max_optimize_depth=3))
    for k, frame in enumerate(ds.frames):
        eng.define_new_keyframe(
            [Observation(lm_id=m, z=z) for m, z in frame],
            edge_init={k - 1: ds.odometry[k - 1]} if k > 0 else None)
    err_before = eng.eval_overall_squared_error()
    G_opt, info = eng.optimize_global()
    err_after = eng.eval_overall_squared_error()
    assert np.isfinite(err_after)
    assert info["err_final"] <= info["err_init"] + 1e-9
    # Global refinement must not make the overall map worse.
    assert err_after <= err_before * 1.05 + 1e-6
    # Engine still operates incrementally after global write-back.
    eng.define_new_keyframe(
        [Observation(lm_id=eng.num_keyframes - 1,
                     z=ds.odometry[-1])],
        edge_init={eng.num_keyframes - 1: ds.odometry[-1]})


def test_warm_lambda_is_runtime_operand():
    """lam0 is a traced operand: two different warm starts must share one
    compiled program (periodic refinements warm-start from the previous
    solve's lambda without recompiling) and still converge."""
    from srba_tpu.solver.global_graphslam import _make_pgo_jit

    prob, gt = _circle_problem("SE2", K=50, seed=4)
    # A config no other test uses: the compile-count assertion below must
    # not see cache hits from earlier tests' identical (cfg, bucket) pairs.
    cfg = PGOConfig(group="SE2", cg_iters=47)
    jitted = _make_pgo_jit(cfg)
    base = jitted._cache_size()
    G_a, i_a = optimize_global_pose_graph(prob, cfg)
    n_after_first = jitted._cache_size()
    G_b, i_b = optimize_global_pose_graph(prob, cfg, lam0=1e-2)
    assert jitted._cache_size() == n_after_first > base
    assert i_a["converged"] and i_b["converged"]
    np.testing.assert_allclose(G_a, G_b, atol=5e-3)


def test_engine_periodic_mode_certifies_and_warm_starts():
    """periodic=True must exit certified (diminishing-returns stop) and
    stash the final lambda for the next periodic call's warm start."""
    from srba_tpu import Observation, SrbaEngine, SrbaParams
    from srba_tpu.utils.datasets import make_graph_slam_dataset, \
        make_world_loop_2d

    world = make_world_loop_2d(num_kfs=40, radius=6.0, num_landmarks=1,
                               seed=6)
    ds = make_graph_slam_dataset(world, noise_std=0.01,
                                 loop_closure_range=3.0, seed=6)
    eng = SrbaEngine("RelativePoses2D",
                     params=SrbaParams(max_tree_depth=3,
                                       max_optimize_depth=3))
    for k, frame in enumerate(ds.frames):
        eng.define_new_keyframe(
            [Observation(lm_id=m, z=z) for m, z in frame],
            edge_init={k - 1: ds.odometry[k - 1]} if k > 0 else None)
        if k == 25:
            _, info_mid = eng.optimize_global(periodic=True)
            assert info_mid["converged"] == 1.0
            assert eng._pgo_warm_lam == pytest.approx(info_mid["lam"])
    _, info2 = eng.optimize_global(periodic=True)
    assert info2["converged"] == 1.0
    # Terminal call still runs (strict tolerance) and certifies on this
    # small, well-conditioned graph.
    _, info_t = eng.optimize_global()
    assert info_t["converged"] == 1.0


def test_edge_info_identity_matches_scalar_path():
    """edge_info_sqrt with identity shapes must reproduce the scalar solve
    (the anisotropic whitening is exactly a no-op at W = I)."""
    prob, gt = _circle_problem("SE2", K=50, seed=7)
    G_s, i_s = optimize_global_pose_graph(prob)
    E = len(prob["edges"])
    prob_i = dict(prob)
    prob_i["edge_info_sqrt"] = np.tile(np.eye(3, dtype=np.float32),
                                       (E, 1, 1))
    G_i, i_i = optimize_global_pose_graph(prob_i)
    assert i_i["err_final"] == pytest.approx(i_s["err_final"],
                                             rel=1e-4, abs=1e-8)
    np.testing.assert_allclose(G_i, G_s, atol=1e-4)


def test_edge_info_downweights_unmeasured_direction():
    """A closure whose information shape zeroes (floors) one tangent
    direction must pull less along it: bias the closure's translation-x
    measurement, give it an info shape with a floored x-direction, and the
    x-residual of that edge should stay LARGER (less enforced) than under
    the scalar path while the solve still converges."""
    prob, gt = _circle_problem("SE2", K=40, n_closures=1, seed=8)
    E = len(prob["edges"])
    # Bias the single closure edge (last) along x by 0.5 m.
    prob["edges"][-1]["rel_pose"] = (
        np.asarray(prob["edges"][-1]["rel_pose"], np.float32)
        + np.asarray([0.5, 0, 0], np.float32))
    shapes = np.tile(np.eye(3, dtype=np.float32), (E, 1, 1))
    G_s, i_s = optimize_global_pose_graph(prob)
    shapes[-1, 0, 0] = np.sqrt(0.05)    # x-direction at the 0.05 floor
    prob_i = dict(prob)
    prob_i["edge_info_sqrt"] = shapes
    G_i, i_i = optimize_global_pose_graph(prob_i)
    assert i_i["converged"] == 1.0

    def closure_x_residual(G):
        e = prob["edges"][-1]
        a, b = e["from"], e["to"]
        pred = NpSE2.compose(NpSE2.inverse(G[a]), G[b])
        return abs(float(pred[0] - e["rel_pose"][0]))

    # The biased direction is enforced less -> larger residual left there,
    # and the rest of the map is at least as close to ground truth.
    assert closure_x_residual(G_i) > closure_x_residual(G_s)
    assert _pos_ate(G_i, gt, 2) <= _pos_ate(G_s, gt, 2) + 1e-3


def test_pgo_shape_bucketing_reuses_compiles():
    """Growing-map periodic PGO calls must hit the executable cache:
    problems whose (node, edge) counts round to the same power-of-two
    buckets compile exactly once (each distinct shape is a fresh compile
    of the whole chordal + LM-PCG program)."""
    from srba_tpu.ops.np_lie import NpSE2
    from srba_tpu.solver.global_graphslam import (PGOConfig, _make_pgo_jit,
                                                  optimize_global_pose_graph)

    rng = np.random.default_rng(3)

    def chain_problem(K):
        th = np.linspace(0, 2, K).astype(np.float32)
        gt = np.stack([np.stack([np.cos(t), np.sin(t), t]) for t in th])
        edges = [{"from": k - 1, "to": k,
                  "rel_pose": NpSE2.compose(NpSE2.inverse(gt[k - 1]), gt[k])}
                 for k in range(1, K)]
        nodes = gt + rng.normal(0, 0.01, gt.shape).astype(np.float32)
        nodes[0] = gt[0]
        return {"group": "SE2", "nodes": nodes, "edges": edges}

    cfg = PGOConfig(group="SE2", max_outer=5, cg_iters=10)
    jitted = _make_pgo_jit(cfg)
    base = jitted._cache_size()
    # 300 and 400 nodes both bucket to 512 nodes / 512 edges.
    for K in (300, 400):
        G, info = optimize_global_pose_graph(chain_problem(K), cfg)
        assert G.shape == (K, 3)          # padding sliced back off
        assert np.isfinite(info["err_final"])
    assert jitted._cache_size() == base + 1, (
        "same-bucket problems must share one compiled program")
