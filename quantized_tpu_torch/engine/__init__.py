"""Integer engine of the port: the int layers, the conversion from a
calibrated fake-quant model, the int8-resident ResNet, MobileNet-v1 and
AlexNet (int8 or int4 weights), the fused forms and the executor."""

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
from quantized_tpu_torch.engine.int8_mobilenet import Int8MobileNet, build_int8_mobilenet
from quantized_tpu_torch.engine.int8_resident import (
    Int8BasicBlock,
    Int8Bottleneck,
    Int8ResNet,
    build_int8_resident,
)
from quantized_tpu_torch.engine.int_layers import IntConv2d, IntLinear
