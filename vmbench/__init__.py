"""Benchmark of ``repro_torch``: filtered top-k served through the
continuous batcher, driven by the cells of ``BENCHMARK.json``.

Entry point: ``python3 vmbench/run.py --workload <cell> --seed <n>
--seconds <s> --trace <0|1>``.  Configurations, traffic mixes and
per-layer metric readers are data files found by name under
``configs/``, ``traffic/`` and ``metrics/``.
"""
