"""PyTorch/CUDA port of the quantized CNN inference engine.

The JAX package ``quantized_tpu`` is the reference; this package mirrors its
subpackages (``quantcore``, ``models``, ``ingest``, ``ops``, ``engine``,
``data``) and runs its int8 kernels as CUDA kernels written for Hopper
(``csrc/``, built with nvcc at first use). Entry points run on CUDA unless
the caller passes ``device="cpu"``, where each kernel's plain PyTorch
version runs instead.
"""
