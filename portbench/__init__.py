"""The benchmark of the PyTorch and CUDA port (``pio_tpu_torch``).

``python -m portbench.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` on the CUDA device of
the machine it is started on. Everything that belongs to one
configuration, traffic mix, per-layer metric or cell is a file of its
own under this folder, found by the name ``BENCHMARK.json`` gives it (see
``README.md``). Nothing here imports ``jax`` or the JAX package.
"""
