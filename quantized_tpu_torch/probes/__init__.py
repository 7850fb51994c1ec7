"""GPU probes of the port, each run with ``python -m`` on a machine with a
CUDA GPU: ``sweep_conv`` (ResNet-50's conv shapes on K2, B7, K1 and a bf16
conv) and ``dma_ring`` (the copy kernels of B9 against ``Tensor.copy_``).
Importing one runs nothing."""
