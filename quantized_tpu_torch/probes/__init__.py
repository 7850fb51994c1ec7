"""GPU probes of the port, each run with ``python -m`` on a machine with a
CUDA GPU: ``sweep_conv`` (ResNet-50's conv shapes on K2, B7, K1 and a bf16
conv), ``dma_ring`` (the copy kernels of B9 against ``Tensor.copy_``),
``gemm_sweep`` (K1 and B6 at the engines' products against ``torch._int_mm``),
``fused_stages`` (B3's stage split), ``pair_stem`` (B5 and K2's gather-K form
at every engine shape) and ``conv_forms`` (B8 and K2's narrow 1x1s beside K2
and the first tile) and ``train_step`` (a QAT fwd + bwd + SGD step).
Importing one runs nothing."""
