"""Integer engine of the port: the int layers, the conversion from a
calibrated fake-quant model (the module surgery ``convert_to_int`` and the
strict engine), the int8-resident ResNet (float-BN and RangeBN flavors),
MobileNet-v1, EfficientNet-B0 and AlexNet (int8 or int4 weights), the
fused forms, the per-layer backend autotuner, the executor (one CUDA graph
per input shape, pinned host slots) and the throughput hook. Serving (continuous batching
and its HTTP front end) lives in ``engine.batching`` and ``engine.server``;
its multi-host form (each rank's admission queue over one SPMD forward of
the mesh) in ``engine.multihost``."""

from quantized_tpu_torch.engine.autotune import apply_cached_backends, autotune_resident
from quantized_tpu_torch.engine.bench_hook import model_throughput, resnet50_int8_throughput
from quantized_tpu_torch.engine.convert import convert_to_int
from quantized_tpu_torch.engine.executor import IntExecutor
from quantized_tpu_torch.engine.fused import (
    FusedInt8BasicBlock,
    FusedInt8BasicBlockDS,
    FusedInt8Bottleneck,
    FusedInt8BottleneckDS,
    FusedInt8DwPw,
    fusable,
    fuse_block,
    fuse_mobilenet_blocks,
    fuse_resident_blocks,
)
from quantized_tpu_torch.engine.int8_alexnet import Int8AlexNet, build_int8_alexnet
from quantized_tpu_torch.engine.int8_efficientnet import Int8EfficientNet, build_int8_efficientnet
from quantized_tpu_torch.engine.int8_mobilenet import Int8MobileNet, build_int8_mobilenet
from quantized_tpu_torch.engine.int8_resident import (
    Int8BasicBlock,
    Int8Bottleneck,
    Int8ResNet,
    build_int8_resident,
)
from quantized_tpu_torch.engine.int_layers import Identity, IntConv2d, IntLinear
from quantized_tpu_torch.engine.multihost import HostShardedExecutor, MultiHostBatcher, serve_multihost
from quantized_tpu_torch.engine.strict import (
    StrictIntConv2d,
    StrictIntLinear,
    convert_to_int_strict,
    quantize_strict_stored,
    strict_act_qparams,
)
