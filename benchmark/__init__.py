"""The benchmark of androidrenderer_tpu_torch on one NVIDIA H100.

``python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>``
runs one cell of ``BENCHMARK.json``. The harness lives in ``harness/``; each
configuration, traffic mix and per-layer metric is a file of its own under
``configs/``, ``traffic/`` and ``metrics/``, found by the name the cell gives;
``reference/`` holds the frozen plain renderer that decides ``correct``.
"""
