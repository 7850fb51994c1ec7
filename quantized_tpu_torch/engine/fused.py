"""Fused-block execution for the int8-resident engines (counterpart of
``quantized_tpu/engine/fused.py``).

``fuse_resident_blocks`` replaces every eligible block of a built
:class:`~quantized_tpu_torch.engine.int8_resident.Int8ResNet` with a twin that
runs the whole block in one kernel (``ops/fused_block.py``): bottlenecks on
``fused_bottleneck_s1`` / ``fused_bottleneck_ds`` (kernel B3), BasicBlocks on
``fused_basicblock_s1`` / ``fused_basicblock_ds`` (kernel B4). The last block
emits f32 for the pool and stays unfused. The epilogue constants
are derived here exactly as the JAX package derives them (``alpha / f32(s)``,
a division, where the unfused ``run_q`` multiplies by ``f32(1/s)``), so the
port's fused blocks equal the JAX package's fused blocks; against the
unfused blocks they agree within 1 int step. The fused downsample blocks
carry the int16 shortcut leg (``S16_FINE``), which the unfused "pallas"
blocks do not.

``fuse_mobilenet_blocks`` rebuilds a built
:class:`~quantized_tpu_torch.engine.int8_mobilenet.Int8MobileNet` as
stages: every depthwise -> pointwise pair whose two output grids are frozen
runs as one kernel (``fused_dw_pw``, kernel B5); the last pair, whose
pointwise conv emits f32 for the pool, stays as two convs. Its constants are
derived the same way, so the port's fused pairs equal the JAX package's.
The autotuner (``engine/autotune.py``) races each block and pair fused
against unfused and fuses the winners through :func:`fuse_block` and
``fuse_mobilenet_blocks(decide=)``.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from quantized_tpu_torch.engine.int8_mobilenet import Int8MobileNet
from quantized_tpu_torch.engine.int8_resident import Int8BasicBlock, Int8Bottleneck, Int8ResNet
from quantized_tpu_torch.engine.int_layers import S16_FINE, IntConv2d
from quantized_tpu_torch.ops.fused_block import (
    fused_basicblock_ds_ck,
    fused_basicblock_s1_ck,
    fused_bottleneck_ds_ck,
    fused_bottleneck_s1_ck,
    fused_dw_pw_ck,
)


def _is_1x1_s1(conv: IntConv2d) -> bool:
    return _is_1x1_s(conv, 1)


def _is_3x3_s1(conv: IntConv2d) -> bool:
    return _is_3x3_s(conv, 1)


# Every eligibility test refuses a conv with packed int4 weights first, as
# the JAX package's do: the fused kernels take int8 weights, so an int4
# engine fuses nothing.


def _is_3x3_s(conv: IntConv2d, s: int) -> bool:
    return (conv.int4_shape is None and conv.groups == 1 and conv.stride == (s, s)
            and conv.padding == (1, 1) and conv.kernel_size == (3, 3))


def _is_1x1_s(conv: IntConv2d, s: int) -> bool:
    return (conv.int4_shape is None and conv.groups == 1 and conv.stride == (s, s)
            and conv.padding == (0, 0) and conv.kernel_size == (1, 1))


def _folded(v: torch.Tensor, scale: float, shift: float = 0.0) -> torch.Tensor:
    """``v / f32(scale) + f32(shift)`` in float32, one rounding per operation,
    computed on the host (a GPU divides by a scalar through its reciprocal)."""
    out = v.detach().cpu().numpy() / np.float32(scale)
    if shift:
        out = out + np.float32(shift)
    return torch.from_numpy(out).to(v.device)


class _FusedBottleneckBase(nn.Module):
    """Buffers and scalars that both fused bottlenecks share. The weights are
    the convs' own K-major tensors: conv1 (Cm, C), conv2 (Cm, 9*Cm), conv3
    (Cout, Cm)."""

    def __init__(self, blk: Int8Bottleneck):
        super().__init__()
        c1, c2, c3 = blk.conv1, blk.conv2, blk.conv3
        s2, zp2 = c2.grid
        s3, zp3 = c3.grid
        s_out, zp_out = blk.out_grid
        shift = zp_out - 128
        self.register_buffer("w1", c1.w_ck)
        self.register_buffer("w2", c2.w_ck)
        self.register_buffer("w3", c3.w_ck)
        # conv1/conv2: requant onto the next conv's grid (ReLU in the clip
        # floor); conv3: prescaled by the out grid
        self.register_buffer("a1", _folded(c1.alpha, s2))
        self.register_buffer("b1", _folded(c1.beta, s2, zp2 - 128))
        self.register_buffer("a2", _folded(c2.alpha, s3))
        self.register_buffer("b2", _folded(c2.beta, s3, zp3 - 128))
        self.register_buffer("a3", _folded(c3.alpha, s_out))
        self.register_buffer("b3", _folded(c3.beta, s_out, shift))
        self.lo1 = float(zp2 - 128)
        self.lo2 = float(zp3 - 128)
        self.shift = float(shift)
        self.zp2_stored = int(zp2 - 128)
        self.in_grid = c1.grid
        self.out_grid = blk.out_grid


class FusedInt8Bottleneck(_FusedBottleneckBase):
    """Identity bottleneck in one kernel launch (``fused_bottleneck_s1``)."""

    def __init__(self, blk: Int8Bottleneck):
        super().__init__(blk)
        s1, zp1 = blk.conv1.grid
        s_out = blk.out_grid[0]
        self.id_k = float(s1 / s_out)
        self.id_c = float((128 - zp1) * (s1 / s_out))

    def forward(self, x_q: torch.Tensor) -> torch.Tensor:
        return fused_bottleneck_s1_ck(
            x_q, self.w1, self.w2, self.w3, self.a1, self.b1, self.a2, self.b2, self.a3, self.b3,
            self.lo1, self.lo2, self.shift, self.zp2_stored, self.id_k, self.id_c)


class FusedInt8BottleneckDS(_FusedBottleneckBase):
    """Downsample bottleneck (1x1 -> 3x3/s -> 1x1, 1x1/s shortcut conv) in one
    kernel launch (``fused_bottleneck_ds``), with the int16 shortcut leg."""

    def __init__(self, blk: Int8Bottleneck):
        super().__init__(blk)
        d = blk.downsample
        s_out = blk.out_grid[0]
        self.register_buffer("wd", d.w_ck)  # (Cout, C)
        self.register_buffer("ad", _folded(d.alpha, s_out))
        self.register_buffer("bd", _folded(d.beta, s_out))
        self.stride = int(blk.conv2.stride[0])

    def forward(self, x_q: torch.Tensor) -> torch.Tensor:
        return fused_bottleneck_ds_ck(
            x_q, self.w1, self.w2, self.w3, self.wd, self.a1, self.b1, self.a2, self.b2,
            self.a3, self.b3, self.ad, self.bd, self.stride, self.lo1, self.lo2, self.shift,
            self.zp2_stored, ds_fine=S16_FINE)  # the int16 shortcut leg


class _FusedBasicBlockBase(nn.Module):
    """Buffers and scalars that both fused BasicBlocks share: the convs' own
    K-major weights, conv1 (Cm, 9*C) and conv2 (Cm, 9*Cm); conv1 requantized
    onto conv2's grid, conv2 prescaled by the out grid."""

    def __init__(self, blk: Int8BasicBlock):
        super().__init__()
        c1, c2 = blk.conv1, blk.conv2
        s2, zp2 = c2.grid
        s_out, zp_out = blk.out_grid
        shift = zp_out - 128
        self.register_buffer("w1", c1.w_ck)
        self.register_buffer("w2", c2.w_ck)
        self.register_buffer("a1", _folded(c1.alpha, s2))
        self.register_buffer("b1", _folded(c1.beta, s2, zp2 - 128))
        self.register_buffer("a2", _folded(c2.alpha, s_out))
        self.register_buffer("b2", _folded(c2.beta, s_out, shift))
        self.lo1 = float(zp2 - 128)
        self.shift = float(shift)
        self.zp1_stored = int(c1.act_zero_point - 128)
        self.zp2_stored = int(zp2 - 128)
        self.in_grid = c1.grid
        self.out_grid = blk.out_grid


class FusedInt8BasicBlock(_FusedBasicBlockBase):
    """Identity 3x3 -> 3x3 block in one kernel launch (``fused_basicblock_s1``)."""

    def __init__(self, blk: Int8BasicBlock):
        super().__init__(blk)
        s1, zp1 = blk.conv1.grid
        s_out = blk.out_grid[0]
        self.id_k = float(s1 / s_out)
        self.id_c = float((128 - zp1) * (s1 / s_out))

    def forward(self, x_q: torch.Tensor) -> torch.Tensor:
        return fused_basicblock_s1_ck(
            x_q, self.w1, self.w2, self.a1, self.b1, self.a2, self.b2, self.lo1, self.shift,
            self.zp1_stored, self.zp2_stored, self.id_k, self.id_c)


class FusedInt8BasicBlockDS(_FusedBasicBlockBase):
    """Downsample BasicBlock (3x3/s -> 3x3, 1x1/s shortcut conv) in one kernel
    launch (``fused_basicblock_ds``), with the int16 shortcut leg."""

    def __init__(self, blk: Int8BasicBlock):
        super().__init__(blk)
        d = blk.downsample
        s_out = blk.out_grid[0]
        self.register_buffer("wd", d.w_ck)  # (Cm, C)
        self.register_buffer("ad", _folded(d.alpha, s_out))
        self.register_buffer("bd", _folded(d.beta, s_out))
        self.stride = int(blk.conv1.stride[0])

    def forward(self, x_q: torch.Tensor) -> torch.Tensor:
        return fused_basicblock_ds_ck(
            x_q, self.w1, self.w2, self.wd, self.a1, self.b1, self.a2, self.b2, self.ad, self.bd,
            self.stride, self.lo1, self.shift, self.zp1_stored, self.zp2_stored,
            ds_fine=S16_FINE)  # the int16 shortcut leg


def fusable(blk) -> bool:
    if not isinstance(blk, (Int8Bottleneck, Int8BasicBlock)) or blk.out_grid is None:
        return False
    if isinstance(blk, Int8Bottleneck):
        if not _is_1x1_s1(blk.conv1) or not _is_1x1_s1(blk.conv3):
            return False
        strided = blk.conv2
    else:
        if not _is_3x3_s1(blk.conv2):
            return False
        strided = blk.conv1
    if blk.downsample is None:
        return _is_3x3_s1(strided)
    s = strided.stride[0]
    return s in (1, 2) and _is_3x3_s(strided, s) and _is_1x1_s(blk.downsample, s)


def fuse_block(blk) -> nn.Module:
    """Fused twin of an eligible block (``fusable(blk)`` must hold)."""
    if isinstance(blk, Int8Bottleneck):
        return FusedInt8BottleneckDS(blk) if blk.downsample is not None else FusedInt8Bottleneck(blk)
    return FusedInt8BasicBlockDS(blk) if blk.downsample is not None else FusedInt8BasicBlock(blk)


def fuse_resident_blocks(model: Int8ResNet) -> int:
    """Replace eligible blocks in place; returns how many were fused."""
    fused = 0
    for i in range(model.num_stages):
        stage = getattr(model, f"layer{i + 1}")
        for j in range(stage.num_blocks):
            blk = getattr(stage, str(j))
            if fusable(blk):
                stage.add_module(str(j), fuse_block(blk))
                fused += 1
    return fused


# ----------------------------------------------------------------- mobilenet


class _ConvStage(nn.Module):
    """Unfused stage of a fused-plan MobileNet: one conv and its output grid."""

    def __init__(self, conv: IntConv2d, out_grid):
        super().__init__()
        self.conv = conv
        self.stage_out_grid = out_grid

    def forward(self, x_q: torch.Tensor) -> torch.Tensor:
        return self.conv.run_q(x_q, relu=True, out_requant=self.stage_out_grid)


class FusedInt8DwPw(nn.Module):
    """Depthwise-separable pair (3x3 dw / stride s -> 1x1 pw) in one kernel
    launch (``fused_dw_pw``); the two chained ``run_q(relu=True,
    out_requant=...)`` calls of the unfused chain, each requant folded into
    its conv's epilogue. The weights are the convs' own K-major tensors:
    depthwise (C, 9), pointwise (Cout, C)."""

    def __init__(self, dw: IntConv2d, pw: IntConv2d, dw_out_grid, pw_out_grid):
        super().__init__()
        s_pw, zp_pw = dw_out_grid  # the pw conv's input grid
        s_nx, zp_nx = pw_out_grid  # the next conv's input grid
        self.register_buffer("wdw", dw.w_ck)
        self.register_buffer("wpw", pw.w_ck)
        self.register_buffer("a1", _folded(dw.alpha, s_pw))
        self.register_buffer("b1", _folded(dw.beta, s_pw, zp_pw - 128))
        self.register_buffer("a2", _folded(pw.alpha, s_nx))
        self.register_buffer("b2", _folded(pw.beta, s_nx, zp_nx - 128))
        self.stride = int(dw.stride[0])
        self.lo1 = float(zp_pw - 128)
        self.lo2 = float(zp_nx - 128)
        self.zp1_stored = int(dw.act_zero_point - 128)
        self.in_grid = dw.grid
        self.stage_out_grid = pw_out_grid

    def forward(self, x_q: torch.Tensor) -> torch.Tensor:
        return fused_dw_pw_ck(x_q, self.wdw, self.wpw, self.a1, self.b1, self.a2, self.b2,
                              self.stride, self.lo1, self.lo2, self.zp1_stored)


def _is_dw3x3(conv: IntConv2d) -> bool:
    return (conv.int4_shape is None and conv.groups == conv.w_ck.shape[0] and conv.kernel_size == (3, 3)
            and conv.w_ck.shape[1] == 9 and conv.stride in ((1, 1), (2, 2)) and conv.padding == (1, 1))


def pair_fusable(dw, pw, dw_grid, pw_grid) -> bool:
    return (isinstance(dw, IntConv2d) and isinstance(pw, IntConv2d) and dw_grid is not None
            and pw_grid is not None and _is_dw3x3(dw) and _is_1x1_s1(pw))


def fuse_mobilenet_blocks(model: Int8MobileNet, decide=None) -> int:
    """Rebuild an Int8MobileNet's conv chain as stages in place, fusing every
    depthwise -> pointwise pair whose intermediate and output grids are both
    frozen (and, when ``decide(dw, pw)`` is given, only the pairs it
    approves). Returns how many pairs were fused; on a model already fused
    it does nothing and returns 0."""
    if not isinstance(model, Int8MobileNet) or model.fused_stages:
        return 0
    convs = [getattr(model, f"conv{i}") for i in range(model.num_convs)]
    grids = model.requant_grids
    stages = []
    i = fused = 0
    while i < model.num_convs:
        if (i + 1 < model.num_convs and pair_fusable(convs[i], convs[i + 1], grids[i], grids[i + 1])
                and (decide is None or decide(convs[i], convs[i + 1]))):
            stages.append(FusedInt8DwPw(convs[i], convs[i + 1], grids[i], grids[i + 1]))
            fused += 1
            i += 2
        else:
            stages.append(_ConvStage(convs[i], grids[i]))
            i += 1
    for j, st in enumerate(stages):
        model.add_module(f"stage{j}", st)
    # every conv now lives in a _ConvStage (the same module) or as a fused
    # pair's buffers: drop the flat conv{i} so no weight is held twice
    for i in range(model.num_convs):
        delattr(model, f"conv{i}")
    model.num_fused_stages = len(stages)
    model.fused_stages = True
    return fused
