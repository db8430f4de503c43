"""Benchmark harnesses (importable so ``chip_smoke.py`` and the tests can
reuse the workload builders, e.g. ``benchmarks.solver_engines.make_batch``)."""
