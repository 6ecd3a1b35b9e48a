"""cellbench: the serving benchmark of the PyTorch/CUDA port (``repro_torch``).

``run.py`` runs one cell of ``BENCHMARK.json``; everything that belongs to
one configuration, traffic mix or per-layer metric is a file of its own
(``configs/``, ``traffic/``, ``metrics/``, ``limits/``), found by name.
Nothing here imports ``jax`` or the JAX package ``repro``; ``reference/``
imports nothing of ``repro_torch`` either.
"""
