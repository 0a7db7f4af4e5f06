"""The benchmark of the PyTorch and CUDA port (``asr_tpu_torch``).

``python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>``
runs one cell of ``BENCHMARK.json`` once; see ``benchmark/README.md``.
"""
