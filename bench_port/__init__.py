"""The benchmark of the PyTorch and CUDA port of trcnn on one NVIDIA H100.

``python3 bench_port/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once and prints one JSON
line.  Everything that belongs to a configuration, a traffic mix or a
per-layer metric is a file of its own under ``configs/``, ``workloads/``
and ``metrics/``, found by its name."""
