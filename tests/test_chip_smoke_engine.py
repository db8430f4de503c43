"""``chip_smoke.py`` engine phases on a 40-KF cut of bench config#3 (the
two share the compiled window programs within one process).  A CPU trace
has no GPU planes, so the four-card phase runs here without its
ran-on-n-GPUs check (``test_chip_smoke_mesh.py`` tests that check)."""

import chip_smoke


def test_phase_engine_small():
    rec = chip_smoke.phase_engine(K=40)
    assert rec["config"] == "config3_stereo" and rec["ate_ok"]


def test_four_optimize_global_small(monkeypatch):
    monkeypatch.setattr(chip_smoke, "_on_gpus", lambda name, n, f: f())
    chip_smoke.four_optimize_global(n=4, K=40)
