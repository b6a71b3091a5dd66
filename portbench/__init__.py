"""The benchmark of the PyTorch and CUDA port (``mmgclip_tpu_torch``).

``python -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>``
runs one cell of ``BENCHMARK.json`` once; ``portbench/README.md`` says how
cells, configurations, traffic mixes and per-layer metrics are added.
"""
