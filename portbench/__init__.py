"""The benchmark of the PyTorch and CUDA port (``siddhi_tpu_torch``).

``python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once and prints one
JSON result line. Everything that belongs to one configuration, traffic
mix, deployment or per-layer metric sits in a file of its own, found by
the name ``BENCHMARK.json`` gives it (``spec.py``).
"""
