"""QAT training of the port (the reference's ``main.py`` train loop and its
``utils.py`` regime engine)."""

from quantized_tpu_torch.training.qat import Trainer, cross_entropy, set_compute_dtype
from quantized_tpu_torch.training.regime import build_optimizer, regime_settings
