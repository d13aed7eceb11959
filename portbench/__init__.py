"""The benchmark of ``openintel_tpu_torch``: ``python3 portbench/run.py
--workload NAME --seed N --seconds S --trace 0|1`` runs one cell of
``BENCHMARK.json`` once and prints one JSON line."""
