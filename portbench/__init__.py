"""The benchmark of ``persia_tpu_torch`` on an NVIDIA H100.

``python -m portbench.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` on the card and prints
one JSON line. Everything a cell is made of is found by name:
``configs/<config>.json`` (the model's published widths),
``traffic/<traffic>.json`` (the parameters ``generator.py`` draws batches
from), ``limits/<cell>.json`` (the correctness limits and the readings
they were set from) and ``metrics/<metric>.py`` (a per-layer reader).

Only ``program.py`` imports the system under test; ``reference/`` is
plain PyTorch and imports nothing of it. Nothing here imports jax,
jaxlib, flax, optax or the JAX package ``persia_tpu``.
"""
