"""The benchmark of the PyTorch and CUDA port (`repro_torch`).

`run.py` runs one cell of `BENCHMARK.json` (one graph configuration under
one traffic mix) and prints one JSON line. Configurations, traffic mixes,
drivers, comparisons and metrics are files found by name; see harness.py.
"""
