"""The benchmark of ``parlayann_tpu_torch`` on one NVIDIA H100.

``python3 -m annbench.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once and prints one
JSON line. Everything that belongs to one configuration, traffic mix,
metric or compared number is a file of its own, found by name (see
:mod:`annbench.spec`). Nothing here imports ``jax`` or the JAX package
``parlayann_tpu``; :mod:`annbench.guard` checks it.
"""
