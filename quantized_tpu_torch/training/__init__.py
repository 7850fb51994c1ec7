"""Training and evaluation loop of the port (its evaluation half; QAT
training waits for the training slice)."""

from quantized_tpu_torch.training.qat import Trainer, cross_entropy
