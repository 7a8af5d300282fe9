"""The benchmark of ``repro_torch``, the PyTorch and CUDA program: one
command (``python3 perfbench/run.py``) runs one cell of ``BENCHMARK.json``
and prints one JSON line.  See ``perfbench/README.md``."""
