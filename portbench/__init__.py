"""The benchmark of ``quantized_tpu_torch``, the PyTorch and CUDA port:
``python -m portbench.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once and prints one
JSON line. Nothing here imports ``jax``, ``flax`` or ``quantized_tpu``."""
