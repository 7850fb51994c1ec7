"""Quantization core of the port (affine grid math, observers, STE forward,
RangeBN statistics)."""

from quantized_tpu_torch.quantcore.affine import (
    SCALE_FLOOR,
    chunked_min_max,
    fake_quant_array,
    nudged_qparams,
    qparams_from_range,
    quantize_int,
)
from quantized_tpu_torch.quantcore.observers import QuantMeasureState, ema_update, quant_measure
from quantized_tpu_torch.quantcore.rangebn import (
    RANGE_BN_NUM_CHUNKS,
    range_bn_apply,
    range_bn_scale_fix,
    range_bn_stats,
)
from quantized_tpu_torch.quantcore.ste import fake_quant
