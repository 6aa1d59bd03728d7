"""The benchmark of gyroflow_torch, the PyTorch and CUDA port, on an NVIDIA H100.

``python -m portbench --workload <cell> --seed <n> --seconds <s> --trace <0|1>``
runs one cell of ``BENCHMARK.json`` and prints its result as the last line of
standard output. See ``harness.py``.
"""
