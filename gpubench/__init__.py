"""The benchmark of the PyTorch and CUDA port (``byzantine_aircomp_tpu_torch``).

``run.py`` runs one cell of ``BENCHMARK.json`` once; ``reference/`` is the
plain PyTorch reference that decides ``correct``; ``counts/`` holds the
yardstick (FLOPs, bytes, peaks); ``metrics/`` one reader per per-layer
metric.
"""
