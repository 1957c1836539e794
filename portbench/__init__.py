"""The benchmark of the PyTorch and CUDA port (``gofr_tpu_torch``).

One run measures one cell of ``BENCHMARK.json`` (a model configuration
under a traffic mix) through the port's own serving or training path and
prints one JSON line. ``run.py`` is the entry; ``README.md`` says how a
cell, a mix or a metric is added as files alone. Nothing here imports the
JAX package or JAX.
"""
