"""The benchmark of the PyTorch and CUDA port (``repro_torch``).

``python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` on a CUDA card and
prints one JSON result line.  Everything that belongs to one model
configuration, traffic mix or per-layer metric lives in a file of its own
(``configs/``, ``traffic/``, ``metrics/``), found by the name that
``BENCHMARK.json`` gives it.
"""
