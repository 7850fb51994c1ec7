"""Command line of the port: ``python -m quantized_tpu_torch.cli.main``."""
