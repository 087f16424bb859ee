"""The benchmark of the PyTorch / CUDA port (``repro_torch``).

``python3 fedbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once and prints one
JSON line. Everything a cell needs is found by name: its workload file
under ``workloads/``, its configuration under ``configs/``, its driver
under ``drivers/`` and each per-layer metric's reader under ``metrics/``
(see ``README.md``). Nothing here imports ``jax`` or the JAX package.
"""
