"""The benchmark of ``tomojax_torch`` on NVIDIA GPUs.

``python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once and prints one
JSON result line. Everything that belongs to one configuration, traffic
mix or metric is a file of its own, found by name (see ``README.md``).

Nothing here imports ``jax`` or the JAX package ``tomojax``; the plain
reference under ``reference/`` imports nothing of ``tomojax_torch``.
"""
