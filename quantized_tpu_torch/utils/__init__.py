"""Utilities of the port: adaptive timing of a step or a chain of calls."""

from quantized_tpu_torch.utils.timing import chain_time, per_iter_time
