"""CLI, dataset file I/O, checkpoint/resume, exporters, and local-areas ECP
loop closures (reference analogs: ``srba-slam`` app behavior, SURVEY.md §4.3
and §6)."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from srba_tpu import Observation, SrbaEngine, SrbaParams
from srba_tpu.cli import main as cli_main
from srba_tpu.ecps import LocalAreasFixedGrid
from srba_tpu.io.checkpoint import load_checkpoint, save_checkpoint
from srba_tpu.io.dataset_io import (load_dataset, load_ground_truth,
                                    save_dataset, save_ground_truth)
from srba_tpu.utils.datasets import (ate_rmse, make_world_loop_2d, observe)


def test_dataset_roundtrip(tmp_path):
    world = make_world_loop_2d(num_kfs=10, radius=6.0, num_landmarks=30,
                               seed=1)
    ds = observe(world, "RangeBearing2D", noise_std=0.01, sensor_range=5.0,
                 odo_noise_std=0.01, seed=1)
    p = tmp_path / "ds.txt"
    save_dataset(ds, str(p))
    save_ground_truth(world, str(p) + ".gt")
    model, frames, odometry = load_dataset(str(p))
    assert model == "RangeBearing2D"
    assert len(frames) == 10
    for k in range(10):
        assert len(frames[k]) == len(ds.frames[k])
        for (m1, z1), (m2, z2) in zip(frames[k], ds.frames[k]):
            assert m1 == m2
            np.testing.assert_allclose(z1, z2, rtol=1e-6)
    for a, b in zip(odometry, ds.odometry):
        np.testing.assert_allclose(a, b, rtol=1e-6)
    gt = load_ground_truth(str(p) + ".gt")
    np.testing.assert_allclose(gt, world.gt_poses, rtol=1e-6)


def _run_small(params=None, n=12):
    world = make_world_loop_2d(num_kfs=n, radius=6.0, num_landmarks=40,
                               seed=2)
    ds = observe(world, "RangeBearing2D", noise_std=0.005, sensor_range=5.0,
                 odo_noise_std=0.01, seed=2)
    eng = SrbaEngine("RangeBearing2D", params=params or SrbaParams(
        max_tree_depth=3, max_optimize_depth=3))
    for k, frame in enumerate(ds.frames):
        eng.define_new_keyframe(
            [Observation(lm_id=m, z=z) for m, z in frame],
            edge_init={k - 1: ds.odometry[k - 1]} if k > 0 else None)
    return eng, world, ds


class TestCheckpoint:
    def test_roundtrip_and_resume(self, tmp_path):
        eng, world, ds = _run_small()
        p = str(tmp_path / "ck.npz")
        save_checkpoint(eng, p)
        eng2 = load_checkpoint(p)
        st1, st2 = eng.state, eng2.state
        assert st2.num_kfs == st1.num_kfs
        assert st2.num_edges == st1.num_edges
        np.testing.assert_allclose(st2.edge_poses, st1.edge_poses)
        np.testing.assert_allclose(st2.landmark_states, st1.landmark_states)
        assert eng2._lm_id_map == eng._lm_id_map
        # Resumed engine keeps working: add another keyframe.
        frame_obs = [Observation(lm_id=m, z=z) for m, z in ds.frames[-1]]
        info = eng2.define_new_keyframe(frame_obs)
        assert info.kf_id == st1.num_kfs
        assert "err_final" in info.optimize_results

    def test_eval_matches_after_reload(self, tmp_path):
        eng, _, _ = _run_small()
        p = str(tmp_path / "ck.npz")
        save_checkpoint(eng, p)
        eng2 = load_checkpoint(p)
        assert eng2.eval_overall_squared_error() == pytest.approx(
            eng.eval_overall_squared_error(), rel=1e-5)

    def test_configuration_fidelity(self, tmp_path):
        """Checkpoint meta restores calib / noise / sensor pose / ECP —
        resuming a stereo run must not silently rebuild the engine with
        defaults (the round-1 hole: cli resume passed none of these)."""
        import jax

        from srba_tpu.models.noise import NoiseConstantMatrix
        from srba_tpu.models.observations import StereoCalib
        from srba_tpu.models.sensor_pose import SensorPoseSE3
        from srba_tpu.ops.np_lie import CAMERA_SENSOR_POSE_SE3
        from srba_tpu.utils.datasets import make_world_loop_3d

        calib = StereoCalib.make(fx=210.0, fy=190.0, cx=155.0, cy=125.0,
                                 baseline=0.14)
        cov = np.diag([0.09, 0.09, 0.16, 0.16])
        eng = SrbaEngine(
            "StereoCamera", calib=calib,
            noise=NoiseConstantMatrix(cov),
            sensor_pose=SensorPoseSE3(CAMERA_SENSOR_POSE_SE3),
            ecp=LocalAreasFixedGrid(submap_size=7,
                                    min_obs_count_loop_closure=5),
            params=SrbaParams(max_tree_depth=3, max_optimize_depth=3))
        world = make_world_loop_3d(num_kfs=6, radius=6.0, num_landmarks=60,
                                   seed=4)
        ds = observe(world, "StereoCamera", calib=calib, noise_std=0.3,
                     sensor_range=8.0, odo_noise_std=0.01, seed=4)
        for k, frame in enumerate(ds.frames):
            eng.define_new_keyframe(
                [Observation(lm_id=m, z=z) for m, z in frame],
                edge_init={k - 1: ds.odometry[k - 1]} if k > 0 else None)
        p = str(tmp_path / "ck.npz")
        save_checkpoint(eng, p)
        eng2 = load_checkpoint(p)  # NO config kwargs: all from the file
        assert float(jax.device_get(eng2.calib.baseline)) == pytest.approx(
            0.14)
        assert float(jax.device_get(eng2.calib.fx)) == pytest.approx(210.0)
        assert eng2.noise.name == "constant_matrix"
        np.testing.assert_allclose(eng2.noise.cov, cov)
        assert not eng2.sensor_pose.is_identity
        np.testing.assert_allclose(
            np.asarray(jax.device_get(eng2.sensor_pose.pose_for(eng2.group))),
            np.asarray(CAMERA_SENSOR_POSE_SE3), rtol=1e-6)
        assert eng2.ecp.name == "local_areas_fixed_grid"
        assert eng2.ecp.submap_size == 7
        assert eng2.ecp.min_obs_count_loop_closure == 5
        np.testing.assert_allclose(eng2._whitener, eng._whitener, rtol=1e-6)
        # The resumed engine keeps optimizing (calib present => no crash).
        frame_obs = [Observation(lm_id=m, z=z) for m, z in ds.frames[-1]]
        info = eng2.define_new_keyframe(frame_obs)
        assert "err_final" in info.optimize_results

    def test_kill_and_resume_matches_uninterrupted(self, tmp_path):
        """A run preempted mid-sequence and resumed from its checkpoint
        finishes with the same ATE as the uninterrupted run."""
        world = make_world_loop_2d(num_kfs=20, radius=6.0, num_landmarks=50,
                                   seed=5)
        ds = observe(world, "RangeBearing2D", noise_std=0.005,
                     sensor_range=5.0, odo_noise_std=0.01, seed=5)

        def feed(eng, lo, hi):
            for k in range(lo, hi):
                eng.define_new_keyframe(
                    [Observation(lm_id=m, z=z) for m, z in ds.frames[k]],
                    edge_init={k - 1: ds.odometry[k - 1]} if k > 0 else None)

        params = SrbaParams(max_tree_depth=3, max_optimize_depth=3)
        eng_a = SrbaEngine("RangeBearing2D", params=params)
        feed(eng_a, 0, 20)
        Ga, _ = eng_a.create_complete_spanning_tree(0)
        ate_a = ate_rmse(Ga[:, :2], world.gt_poses[:, :2])

        eng_b = SrbaEngine("RangeBearing2D", params=params)
        feed(eng_b, 0, 10)
        p = str(tmp_path / "ck.npz")
        save_checkpoint(eng_b, p)
        del eng_b                    # "kill"
        eng_c = load_checkpoint(p)
        feed(eng_c, 10, 20)
        Gc, _ = eng_c.create_complete_spanning_tree(0)
        ate_c = ate_rmse(Gc[:, :2], world.gt_poses[:, :2])
        assert ate_c == pytest.approx(ate_a, abs=0.01)
        assert ate_c < 0.15


class TestLocalAreasECP:
    def test_two_revolutions_create_loop_closures(self):
        """Second pass around the loop re-observes landmarks based in the
        first pass's areas -> votes -> edges to earlier area centers."""
        world = make_world_loop_2d(num_kfs=40, radius=6.0, num_landmarks=80,
                                   seed=3, revolutions=2.0)
        ds = observe(world, "RangeBearing2D", noise_std=0.005,
                     sensor_range=5.0, odo_noise_std=0.02, seed=3)
        eng = SrbaEngine(
            "RangeBearing2D",
            ecp=LocalAreasFixedGrid(submap_size=5,
                                    min_obs_count_loop_closure=3),
            params=SrbaParams(max_tree_depth=4, max_optimize_depth=4))
        for k, frame in enumerate(ds.frames):
            eng.define_new_keyframe(
                [Observation(lm_id=m, z=z) for m, z in frame],
                edge_init={k - 1: ds.odometry[k - 1]} if k > 0 else None)
        # Closures: edges whose endpoints are far apart in KF index.
        st = eng.state
        spans = [abs(int(st.k2k_from[e]) - int(st.k2k_to[e]))
                 for e in range(st.num_edges)]
        assert max(spans) > 10, f"expected loop-closure edges, spans={spans}"
        G, _ = eng.create_complete_spanning_tree(0)
        assert ate_rmse(G[:, :2], world.gt_poses[:, :2]) < 0.4


class TestCLI:
    def test_synthetic_run_json(self, capsys):
        rc = cli_main([
            "--synthetic", "loop2d", "--num-kfs", "12", "--num-landmarks",
            "40", "--noise-std", "0.005", "--max-tree-depth", "3",
            "--max-optimize-depth", "3", "--json",
        ])
        assert rc == 0
        out = capsys.readouterr().out.strip().splitlines()[-1]
        summary = json.loads(out)
        assert summary["num_kfs"] == 12
        assert summary["ate_rmse"] < 0.5
        assert summary["kf_per_sec"] > 0

    def test_dataset_file_run_with_exports(self, tmp_path, capsys):
        ds_path = str(tmp_path / "ds.txt")
        rc = cli_main([
            "--synthetic", "loop2d", "--num-kfs", "10", "--num-landmarks",
            "30", "--save-dataset", ds_path, "--max-tree-depth", "3",
            "--max-optimize-depth", "3", "--json",
        ])
        assert rc == 0
        capsys.readouterr()
        dot = str(tmp_path / "g.dot")
        g2o = str(tmp_path / "g.g2o")
        ck = str(tmp_path / "ck.npz")
        rc = cli_main([
            "--dataset", ds_path, "--gt-path", ds_path + ".gt",
            "--max-tree-depth", "3", "--max-optimize-depth", "3",
            "--export-dot", dot, "--export-g2o", g2o,
            "--save-checkpoint", ck, "--json",
        ])
        assert rc == 0
        summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert summary["num_kfs"] == 10
        assert "ate_rmse" in summary
        assert os.path.exists(dot) and os.path.exists(g2o)
        eng = load_checkpoint(ck)
        assert eng.num_keyframes == 10

    def test_export_html_viewer(self, tmp_path, capsys):
        """--export-html writes a standalone interactive viewer: one file,
        embedded scene JSON, no external resources (headless analog of the
        reference's live GUI; io/html_viewer.py)."""
        html = str(tmp_path / "map.html")
        rc = cli_main([
            "--synthetic", "loop2d", "--num-kfs", "12", "--num-landmarks",
            "30", "--max-tree-depth", "3", "--max-optimize-depth", "3",
            "--export-html", html, "--render-spantree-root", "0", "--json",
        ])
        assert rc == 0
        capsys.readouterr()
        src = open(html).read()
        assert "<canvas" in src and "const SCENE =" in src
        import re
        m = re.search(r"const SCENE = (\{.*?\});\n", src, re.S)
        scene = json.loads(m.group(1))
        assert len(scene["kf_positions"]) == 12
        assert len(scene["landmarks"]) > 0
        assert len(scene["spanning_tree_edges"]) > 0
        # Self-contained: no external fetches.
        assert "http://" not in src and "https://" not in src

    def test_graphslam_synthetic(self, capsys):
        rc = cli_main([
            "--synthetic", "graphslam2d", "--num-kfs", "15",
            "--odo-noise-std", "0.03", "--max-tree-depth", "3",
            "--max-optimize-depth", "3", "--json",
        ])
        assert rc == 0
        summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert summary["ate_rmse"] < 0.3

    def test_missing_input_errors(self, capsys):
        rc = cli_main(["--json"])
        assert rc == 2

    def test_metrics_jsonl_and_render(self, tmp_path, capsys):
        mj = str(tmp_path / "metrics.jsonl")
        png = str(tmp_path / "map.png")
        rc = cli_main([
            "--synthetic", "loop2d", "--num-kfs", "10", "--num-landmarks",
            "30", "--max-tree-depth", "3", "--max-optimize-depth", "3",
            "--metrics-jsonl", mj, "--render", png,
            "--render-spantree-root", "0", "--json",
        ])
        assert rc == 0
        capsys.readouterr()
        rows = [json.loads(ln) for ln in open(mj)]
        assert len(rows) == 10
        assert rows[3]["kf"] == 3 and rows[3]["wall_ms"] > 0
        assert "err_final" in rows[3] and "iters" in rows[3]
        assert os.path.getsize(png) > 10000

    def test_rgbd_cli_run(self, capsys):
        rc = cli_main([
            "--synthetic", "loop3d", "--obs", "RGBDCamera",
            "--sensor-pose-camera", "--num-kfs", "10", "--num-landmarks",
            "120", "--noise-std", "0.05", "--max-tree-depth", "3",
            "--max-optimize-depth", "3", "--json",
        ])
        assert rc == 0
        summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert summary["ate_rmse"] < 0.3

    def test_autosave_preemption_resume(self, tmp_path):
        """SIGTERM mid-run saves a resumable checkpoint and exits 0 — the
        elastic-recovery path (run in a subprocess so the signal is real)."""
        ck = str(tmp_path / "auto.npz")
        env = dict(os.environ, JAX_PLATFORMS="cpu")
        # Autosave every 3 KFs; run 9 KFs: checkpoint exists afterwards even
        # without a signal (periodic path).
        rc = subprocess.run(
            [sys.executable, "-m", "srba_tpu.cli", "--synthetic", "loop2d",
             "--num-kfs", "9", "--num-landmarks", "30", "--max-tree-depth",
             "3", "--max-optimize-depth", "3", "--autosave-checkpoint", ck,
             "--autosave-every", "3", "--json"],
            env=env, capture_output=True, timeout=300)
        assert rc.returncode == 0, rc.stderr[-800:]
        eng = load_checkpoint(ck)
        assert 3 <= eng.num_keyframes <= 9
        # And the checkpoint resumes through the CLI.
        rc = cli_main([
            "--synthetic", "loop2d", "--num-kfs", "9", "--num-landmarks",
            "30", "--max-tree-depth", "3", "--max-optimize-depth", "3",
            "--resume-checkpoint", ck, "--json"])
        assert rc == 0

    def test_subprocess_entry(self, tmp_path):
        """The CLI works as `python -m srba_tpu.cli` in a fresh process."""
        env = dict(os.environ, JAX_PLATFORMS="cpu")
        out = subprocess.run(
            [sys.executable, "-m", "srba_tpu.cli", "--synthetic", "loop2d",
             "--num-kfs", "8", "--num-landmarks", "25", "--max-tree-depth",
             "3", "--max-optimize-depth", "3", "--json"],
            capture_output=True, text=True, env=env,
            cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
            timeout=300)
        assert out.returncode == 0, out.stderr[-2000:]
        summary = json.loads(out.stdout.strip().splitlines()[-1])
        assert summary["num_kfs"] == 8


def test_cli_pgo_g2o_mode(tmp_path, capsys):
    """Standalone pose-graph mode: g2o in -> PGO -> optimized g2o out."""
    from tests.test_g2o import _write_sphere_g2o
    from srba_tpu.io.g2o import load_g2o
    from srba_tpu.utils.datasets import ate_rmse

    src = str(tmp_path / "sphere.g2o")
    out = str(tmp_path / "opt.g2o")
    gt = _write_sphere_g2o(src, n_ring=20, n_rings=6)
    rc = cli_main(["--pgo-g2o", src, "--export-g2o", out, "--json"])
    assert rc == 0
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert summary["converged"] == 1
    assert summary["err_final"] < summary["err_init"]
    opt = load_g2o(out)
    ate = float(ate_rmse(opt["nodes"][:, :3], gt[:, :3]))
    assert ate < 0.2, ate
