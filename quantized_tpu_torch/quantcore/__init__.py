"""Quantization core of the port (affine grid math, observers, the
straight-through estimators and gradient quantization, RangeBN
statistics); it exports what ``quantized_tpu.quantcore`` exports."""

from quantized_tpu_torch.quantcore.affine import (
    SCALE_FLOOR,
    chunked_min_max,
    dequantize,
    fake_quant_array,
    nudged_qparams,
    qparams_from_range,
    quantize_int,
    storage_shift,
)
from quantized_tpu_torch.quantcore.observers import (
    QuantMeasureState,
    batch_min_max_stat,
    ema_update,
    quant_measure,
)
from quantized_tpu_torch.quantcore.rangebn import (
    RANGE_BN_NUM_CHUNKS,
    range_bn_apply,
    range_bn_scale_fix,
    range_bn_stats,
)
from quantized_tpu_torch.quantcore.ste import biprec, conv_biprec, fake_quant, linear_biprec, quantize_grad
