"""The benchmark of the PyTorch and CUDA port (``repro_torch``).

``run.py`` is the entry; ``BENCHMARK.json`` at the repository root names
the cells, the configurations and the metrics, and every one of them is
a file of its own here, found by its name (``harness/catalog.py``).
"""
