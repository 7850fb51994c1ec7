"""Integer ops of the port: the hand-written CUDA kernels (K1, K2 and its
fused-residual form B8, the fused bottlenecks B3, BasicBlocks B4 and
depthwise-separable pairs B5, the int4 GEMM B6, the flat-row conv B7, the
copy probes B9, the fused bottleneck's stage probes, the EfficientNet
engine's depthwise conv, squeeze and gate pass), the launch plans of
the Hopper GEMM (``gemm_plan``: K1, B6), conv mainloop (``conv_plan``: K2's
per-tap and residual forms, its pixel-group 1x1s, B7) and block mainloop
(``block_plan``: B3, B4), their plain PyTorch versions, the int4 packing,
the plain forms the JAX package leaves to XLA (``int8_matmul_xla``,
``int8_conv_xla`` with its int16 emission and the RangeBN clamp, the
native-S4 int4 forms, the bf16 conv), and the tensor plumbing around them.
K1 and K2 (every route) take the clamp ``y_clip`` on CLIP instances of
their own, in the form ``kernel_clip`` gives (``requant_clip_bounds``: the
requant's integer bounds). K1's and K2's epilogues take an activation
code (``int8_matmul.activate``: ReLU, SiLU, the sigmoid)."""

from quantized_tpu_torch.ops._cuda import KERNELS, build_kernels, launch_counts, reset_launches, route_counts
from quantized_tpu_torch.ops.copy_probe import bulk_copy, copy_plain, grid_copy, ring_copy
from quantized_tpu_torch.ops.fused_block import (
    block_plan,
    fused_basicblock_ds,
    fused_basicblock_ds_ck,
    fused_basicblock_ds_plain,
    fused_basicblock_s1,
    fused_basicblock_s1_ck,
    fused_basicblock_s1_plain,
    fused_bottleneck_ds,
    fused_bottleneck_ds_ck,
    fused_bottleneck_ds_plain,
    fused_bottleneck_s1,
    fused_bottleneck_s1_ck,
    fused_bottleneck_s1_plain,
    fused_dw_pw,
    fused_dw_pw_ck,
    fused_dw_pw_plain,
    fused_stage,
    fused_stage_ck,
    fused_stage_plain,
)
from quantized_tpu_torch.ops.int4 import (
    int4_conv_s4,
    int4_matmul,
    int4_matmul_nk,
    int4_matmul_plain,
    int4_matmul_s4,
    int4_matmul_unpacked_xla,
    pack_int4,
    pack_int4_conv,
    pack_int4_conv_channels,
    unpack_int4,
    unpack_int4_conv,
    unpack_int4_conv_channels,
    unpack_int4_nk,
)
from quantized_tpu_torch.ops.int8_conv import (
    bf16_conv,
    clip_s16_checked,
    grouped_conv_acc,
    im2col_int8,
    int8_conv_gemm,
    int8_conv_gemm_ck,
    int8_conv_xla,
    pack_conv_weight,
    pad_stored_zp,
    s16_saturated_total,
)
from quantized_tpu_torch.ops.int8_conv_pallas import (
    conv_border_sums,
    conv_plan,
    conv_tapsum,
    int8_conv_direct,
    int8_conv_direct_ck,
    int8_conv_direct_plain,
    int8_conv_flat,
    int8_conv_flat_ck,
    int8_conv_flat_plain,
    int8_conv_pixel_groups_plain,
    int8_conv_zero_filled_plain,
    pixel_group,
    pixel_group_operands,
)
from quantized_tpu_torch.ops.int8_matmul import (
    gemm_plan,
    int8_matmul,
    int8_matmul_nk,
    int8_matmul_plain,
    int8_matmul_requant,
    int8_matmul_requant_nk,
    int8_matmul_requant_plain,
    int8_matmul_xla,
    int8_matmul_xla_nk,
    kernel_clip,
    matmul_epilogue_params,
    requant_clip_bounds,
)
from quantized_tpu_torch.ops.mbconv import (
    dw_conv,
    dw_conv_plain,
    dw_weight_words,
    se_gate,
    se_gate_plain,
    se_squeeze,
    se_squeeze_plain,
)
