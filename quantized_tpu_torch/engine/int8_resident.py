"""Int8-resident ResNet execution (counterpart of
``quantized_tpu/engine/int8_resident.py``): activations stay int8 (logical
uint8 - 128) across the net.

Each activation tensor is quantized once, onto the frozen observer grid of
its first consumer (the block's conv1); requantization is fused into each
conv's epilogue, the maxpool runs on int8 (max commutes with the monotone
affine map), and a block's residual add is one elementwise pass. A block's
downsample conv consumes the conv1-quantized tensor directly, its epilogue
built on conv1's grid.

Both geometries: the ImageNet nets (Bottleneck depths 50/101/152 and
BasicBlock depths 18/34) and the CIFAR nets (BasicBlock, no maxpool).
Every conv runs on kernel K2 (backend ``"pallas"``, the default here), on
im2col + K1 (``"gemm"``) or on one of the plain backends of
``engine/int_layers.py`` (``"xla"``, ``"bf16"``, their ``-split`` forms, and
``"s4"`` on packed int4 weights); ``engine/autotune.py`` picks one per conv.
The fc head runs on K1. A 7x7/s2 ImageNet stem runs in the space-to-depth
form (``space_to_depth=True``, the default), a 4x4 stride-1 conv over Cin =
12, or as the raw 7x7 conv; the CIFAR stem as a plain 3x3 conv over Cin =
3; K2 runs all three in its gather-K form. On the xla and bf16 backends a
downsample block's shortcut leg is int16 at 1/S16_FINE of an output step,
as in the JAX package; on "pallas" and "gemm" it stays f32. The int8
maxpool has two bit-equal forms, ``"interleave"`` and ``"rw"``, pinned per
shape in ``_POOL_IMPL_TABLE`` by the autotuner.
``engine/fused.fuse_resident_blocks`` turns a built engine into its fused
form: every block but the last runs as one fused kernel (B3 for a
bottleneck, B4 for a BasicBlock), with the int16 shortcut leg in the
downsample ones. ``weight_bits=4`` builds the int4 weight-only engine: every
conv with an even Cin keeps packed int4 weights, unpacked for K2 on each
call; the stem (Cin = 3) and the fc head stay int8 storage. Both flavors
build: float BN, and RangeBN (``resnet_quantized``), whose every conv
carries the folded observer clamp ``y_clip`` (the stem's rides both of its
forms). ``engine/fused.fusable`` leaves a clamped block unfused: the fused
kernels carry no clamp.
"""

from __future__ import annotations

import functools
from typing import List, Optional, Sequence, Tuple, Union

import torch
from torch import nn

from quantized_tpu_torch._device import DeviceLike, resolve_device
from quantized_tpu_torch.data.preprocess import IMAGENET_MEAN, IMAGENET_STD
from quantized_tpu_torch.engine.convert import _convert_conv, _convert_linear, observer_grid
from quantized_tpu_torch.engine.int_layers import (
    S16_FINE,
    IntConv2d,
    IntLinear,
    dequantize_stored,
    quantize_input_stored,
)
from quantized_tpu_torch.models.layers import QConv2d, QLinear
from quantized_tpu_torch.models.resnet_common import ResNetCifar, ResNetImageNet
from quantized_tpu_torch.ops.int8_conv import pad_stored_zp
from quantized_tpu_torch.ops.int8_matmul import f32

Grid = Tuple[float, int]


def _prescaled_identity(x_q: torch.Tensor, grid: Grid, out_scale: float) -> torch.Tensor:
    """Identity shortcut dequantized and pre-divided by the output grid's
    scale: ``x * f32(s / s_out) + f32((128 - zp) * (s / s_out))``."""
    scale, zp = grid
    k = f32(scale / out_scale)
    return x_q.to(torch.float32) * k + f32((128 - zp) * (scale / out_scale))


def _residual_requant_prescaled(acc_ps: torch.Tensor, identity_ps: torch.Tensor,
                                shift: int) -> torch.Tensor:
    """Residual tail on pre-divided inputs: one add, round and clip; ReLU is
    the clip floor (the stored zero-point dequantizes to exactly 0)."""
    q = torch.round(acc_ps + identity_ps)
    return torch.clamp(q, float(shift), 127.0).to(torch.int8)


def _residual_tail(block, last: IntConv2d, h: torch.Tensor, x_q: torch.Tensor) -> torch.Tensor:
    """A block's last conv over ``h``, its shortcut over the block input
    ``x_q`` and the residual add: int8 on ``block.out_grid``, or f32 after
    the ReLU for the final block (avgpool/fc)."""
    if block.out_grid is not None:
        s_out, zp_out = block.out_grid
        shift = zp_out - 128
        acc = last.run_q(h, relu=False, out_prescale=(s_out, float(shift)))
        if block.downsample is not None:
            # int16 at 1/S16_FINE of a step on the xla and bf16 backends
            idq = block.downsample.run_q(x_q, relu=False, out_prescale=(s_out, 0.0), prescale_s16=True)
            if idq.dtype == torch.int16:
                idq = idq.to(torch.float32) * f32(1.0 / S16_FINE)
        else:
            idq = _prescaled_identity(x_q, block.conv1.grid, s_out)
        return _residual_requant_prescaled(acc, idq, shift)
    acc = last.run_q(h, relu=False)
    if block.downsample is not None:
        idq = block.downsample.run_q(x_q, relu=False)
    else:
        idq = dequantize_stored(x_q, *block.conv1.grid)
    return torch.clamp_min(acc + idq, 0.0)


class Int8Bottleneck(nn.Module):
    """1x1 -> 3x3 -> 1x1 with int8-resident plumbing. Input int8 on
    ``conv1.grid``; output int8 on ``out_grid`` (or f32 when None)."""

    def __init__(self, conv1: IntConv2d, conv2: IntConv2d, conv3: IntConv2d,
                 downsample: Optional[IntConv2d], out_grid: Optional[Grid]):
        super().__init__()
        self.conv1 = conv1
        self.conv2 = conv2
        self.conv3 = conv3
        self.downsample = downsample
        self.out_grid = out_grid

    def forward(self, x_q: torch.Tensor) -> torch.Tensor:
        h = self.conv1.run_q(x_q, relu=True, out_requant=self.conv2.grid)
        h = self.conv2.run_q(h, relu=True, out_requant=self.conv3.grid)
        return _residual_tail(self, self.conv3, h, x_q)


class Int8BasicBlock(nn.Module):
    """3x3 -> 3x3 variant (ResNet-18/34 and the CIFAR geometry), the same
    int8-resident plumbing as :class:`Int8Bottleneck`."""

    def __init__(self, conv1: IntConv2d, conv2: IntConv2d, downsample: Optional[IntConv2d],
                 out_grid: Optional[Grid]):
        super().__init__()
        self.conv1 = conv1
        self.conv2 = conv2
        self.downsample = downsample
        self.out_grid = out_grid

    def forward(self, x_q: torch.Tensor) -> torch.Tensor:
        h = self.conv1.run_q(x_q, relu=True, out_requant=self.conv2.grid)
        return _residual_tail(self, self.conv2, h, x_q)


class _Int8Stage(nn.Module):
    """Blocks named ``"0"``, ``"1"``, ... like the JAX stage."""

    def __init__(self, blocks: List[nn.Module]):
        super().__init__()
        for i, b in enumerate(blocks):
            self.add_module(str(i), b)
        self.num_blocks = len(blocks)

    def forward(self, x_q: torch.Tensor) -> torch.Tensor:
        for i in range(self.num_blocks):
            x_q = getattr(self, str(i))(x_q)
        return x_q


class Int8SpaceToDepthStem(nn.Module):
    """7x7/s2/p3 ImageNet stem rewritten as space-to-depth + 4x4/s1 conv.

    The zero-point-padded input (B, 230, 230, 3) is re-indexed into 2x2
    blocks, (B, 115, 115, 12), and the 7x7 kernel is remapped onto a 4x4
    kernel over 12 channels (zeros where no tap lands). Exact: the same taps
    meet the same pixels, padded taps contribute 0, and the epilogue is
    unchanged because the tap sum does not depend on its order.

    The raw 7x7 conv stays beside it (``raw``). :meth:`set_backend` picks the
    form: any backend of the 4x4 conv (``"bf16"`` is the JAX stem's: the f32
    conv and a separate requant, the 4x4 conv's ``"bf16-split"``), or
    ``"raw-<backend>"``, the raw conv on that backend. The stem's
    ``y_clip`` (RangeBN) rides the 4x4 conv too; on ``"bf16"`` and
    ``"xla-split"`` the JAX stem clamps the f32 conv output before its ReLU
    (an ``IntConv2d``'s split forms clamp after it), and so does this one."""

    def __init__(self, stem: IntConv2d):
        super().__init__()
        w_src = stem.weights()
        kh, kw, cin, cout = w_src.shape
        if (kh, kw) != (7, 7) or stem.stride != (2, 2) or stem.padding != (3, 3):
            raise ValueError("the space-to-depth stem expects the 7x7/s2/p3 geometry")
        w = torch.zeros((4, 4, 4 * cin, cout), dtype=torch.int8, device=w_src.device)
        for kr in range(7):
            for kc in range(7):
                block = (kr % 2) * 2 + (kc % 2)
                w[kr // 2, kc // 2, block * cin:(block + 1) * cin, :] = w_src[kr, kc]
        self.conv = IntConv2d(w, stem.alpha, stem.beta, stem.act_scale, stem.act_zero_point,
                              stride=(1, 1), padding=(0, 0), y_clip=stem.y_clip)
        self.raw = stem
        self.cin = cin
        self.set_backend(stem.backend)

    @property
    def grid(self) -> Grid:
        return self.conv.grid

    def set_backend(self, backend: str) -> None:
        if backend.startswith("raw-"):
            self.raw.set_backend(backend[len("raw-"):])
        else:
            self.conv.set_backend("bf16-split" if backend == "bf16" else backend)
        self.backend = backend

    def _s2d(self, x_q: torch.Tensor) -> torch.Tensor:
        n = x_q.shape[0]
        xp = pad_stored_zp(x_q, (3, 3), self.conv.stored_zp)  # (B, 230, 230, C)
        h2, w2 = xp.shape[1] // 2, xp.shape[2] // 2
        xs = xp.reshape(n, h2, 2, w2, 2, self.cin)
        return xs.permute(0, 1, 3, 2, 4, 5).reshape(n, h2, w2, 4 * self.cin)

    def run_q(self, x_q: torch.Tensor, relu: bool, out_requant: Grid) -> torch.Tensor:
        if self.backend.startswith("raw-"):
            return self.raw.run_q(x_q, relu=relu, out_requant=out_requant)
        if self.conv.y_clip is not None and self.backend in ("bf16", "xla-split"):
            y = self.conv.run_q(self._s2d(x_q), relu=False)  # clamped f32
            return quantize_input_stored(torch.clamp_min(y, 0.0) if relu else y, *out_requant)
        return self.conv.run_q(self._s2d(x_q), relu=relu, out_requant=out_requant)


# The maxpool form per input shape (N, H, W, C), pinned by the autotuner
# (engine/autotune.py); an unseen shape takes "rw" from this many elements
# up, "interleave" below, as in the JAX package.
_POOL_IMPL_TABLE: dict = {}
_POOL_HEURISTIC_RW_MIN_ELEMS = 100_000_000
POOL_IMPLS = ("rw", "interleave")


def maxpool_3x3_s2_int8(x_q: torch.Tensor, impl: Optional[str] = None) -> torch.Tensor:
    """3x3/stride-2/pad-1 maxpool on stored int8, padded with -128 (the
    stored uint8 zero). Two bit-equal forms:

    - ``"rw"`` (the JAX package's ``reduce_window``): the padded tensor's
      3x3 windows at stride 2 as an ``unfold`` view, reduced by ``amax``;
    - ``"interleave"``: per axis, out[j] = max(x[2j-1], x[2j], x[2j+1]), with
      x[2j] and x[2j+1] the phases of an (n//2, 2) reshape and x[2j-1] the
      odd phase shifted by one (even H and W only).

    ``impl=None`` takes the autotuner's table, then the size rule."""
    n, h, w, c = x_q.shape
    if impl is None:
        impl = _POOL_IMPL_TABLE.get((n, h, w, c))
    if impl is None:
        impl = "rw" if x_q.numel() >= _POOL_HEURISTIC_RW_MIN_ELEMS else "interleave"
    if impl == "rw":
        xp = torch.nn.functional.pad(x_q, (0, 0, 1, 1, 1, 1), value=-128)
        return xp.unfold(1, 3, 2).unfold(2, 3, 2).amax(dim=(-2, -1))
    if impl != "interleave":
        raise ValueError(f"maxpool form {impl!r} is not one of {POOL_IMPLS}")
    if h % 2 or w % 2:
        raise ValueError(f"the interleave maxpool needs even H and W, got {(h, w)}")
    ho, wo = h // 2, w // 2
    xw = x_q.reshape(n, h, wo, 2, c)
    e, o = xw[:, :, :, 0, :], xw[:, :, :, 1, :]
    o_prev = torch.nn.functional.pad(o, (0, 0, 1, 0), value=-128)[:, :, :wo, :]
    pw = torch.maximum(torch.maximum(e, o), o_prev)
    xh = pw.reshape(n, ho, 2, wo, c)
    e2, o2 = xh[:, :, 0], xh[:, :, 1]
    o2_prev = torch.nn.functional.pad(o2, (0, 0, 0, 0, 1, 0), value=-128)[:, :ho]
    return torch.maximum(torch.maximum(e2, o2), o2_prev)


def quantize_u8_stored(u8: torch.Tensor, grid: Grid, mean: torch.Tensor,
                       std: torch.Tensor) -> torch.Tensor:
    """Raw uint8 images -> stored int8 on ``grid``, the preprocessing
    normalize folded in: one per-channel affine ``clip(round(u*a + b))``."""
    scale, zp = grid
    a = 1.0 / (255.0 * std * f32(scale))
    b = f32(zp - 128) - mean / (std * f32(scale))
    q = torch.round(u8.to(torch.float32) * a + b)
    return torch.clamp(q, -128.0, 127.0).to(torch.int8)


@functools.lru_cache(maxsize=None)
def imagenet_stats(device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    """The ImageNet mean and std as f32 tensors on ``device``, built once per
    device: a forward then copies nothing from the host, which a CUDA graph
    could not capture. Read only."""
    return (torch.as_tensor(IMAGENET_MEAN, dtype=torch.float32, device=device),
            torch.as_tensor(IMAGENET_STD, dtype=torch.float32, device=device))


def u8_to_stored(u8: torch.Tensor, grid: Grid, mean=None, std=None) -> torch.Tensor:
    """uint8 images -> stored int8 on ``grid``, ImageNet stats by default."""
    default_mean, default_std = imagenet_stats(u8.device)
    mean = default_mean if mean is None else torch.as_tensor(mean, dtype=torch.float32, device=u8.device)
    std = default_std if std is None else torch.as_tensor(std, dtype=torch.float32, device=u8.device)
    return quantize_u8_stored(u8, grid, mean, std)


class Int8ResNet(nn.Module):
    """Int8-resident ResNet, either geometry. ``forward`` takes f32 NHWC
    images and :meth:`run_u8` raw uint8 NHWC images; both return f32 logits.
    ``imagenet_pool`` runs the int8 maxpool after the stem (the ImageNet
    geometry; the CIFAR geometry has none)."""

    def __init__(self, stem: Union[Int8SpaceToDepthStem, IntConv2d], stem_out_grid: Grid,
                 stages: List[_Int8Stage], fc: IntLinear, imagenet_pool: bool):
        super().__init__()
        self.stem = stem
        self.stem_out_grid = stem_out_grid
        for i, s in enumerate(stages):
            self.add_module(f"layer{i + 1}", s)
        self.num_stages = len(stages)
        self.fc = fc
        self.imagenet_pool = imagenet_pool

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self._forward_q(quantize_input_stored(x, *self.stem.grid))

    def run_u8(self, u8: torch.Tensor, mean=None, std=None) -> torch.Tensor:
        """Forward from raw uint8 NHWC images (values 0..255)."""
        return self._forward_q(u8_to_stored(u8, self.stem.grid, mean, std))

    def _forward_q(self, x_q: torch.Tensor) -> torch.Tensor:
        h = self.stem.run_q(x_q, relu=True, out_requant=self.stem_out_grid)
        if self.imagenet_pool:
            # max commutes with the monotone uint8 affine map: pool on int8
            h = maxpool_3x3_s2_int8(h)
        for i in range(self.num_stages):
            h = getattr(self, f"layer{i + 1}")(h)
        return self.fc(h.mean(dim=(1, 2)))  # f32 from the last block


def _block_convs(block) -> Sequence[Tuple[str, str]]:
    if hasattr(block, "conv3"):
        return [("conv1", "bn1"), ("conv2", "bn2"), ("conv3", "bn3")]
    return [("conv1", "bn1"), ("conv2", "bn2")]


def build_int8_resident(model: nn.Module, weight_bits: int = 8, backend: str = "pallas",
                        device: DeviceLike = "cuda", space_to_depth: bool = True) -> Int8ResNet:
    """Convert a calibrated fake-quant ResNet (float-BN or RangeBN flavor,
    either geometry) into an :class:`Int8ResNet` on ``device``. With
    ``space_to_depth`` a 7x7/s2 ImageNet stem runs in the space-to-depth
    form (:class:`Int8SpaceToDepthStem`); the block kind follows the block's
    conv count.

    ``weight_bits`` is 8, or 4 for int4 weight-only (the convs packed where
    Cin is even; the fc head stays unpacked). ``backend`` is any of
    ``int_layers.CONV_BACKENDS`` for every conv: ``"pallas"`` (the direct
    conv kernel, the port's default; the JAX package's default ``"xla"`` is
    an exact plain reference here), ``"gemm"`` (im2col + the int8 GEMM),
    ``"bf16"`` and the split forms (``"s4"`` needs every conv packed, which
    the stem's Cin = 3 is not)."""
    dev = resolve_device(device)
    if not isinstance(model, (ResNetImageNet, ResNetCifar)):
        raise TypeError(f"the port builds ImageNet- and CIFAR-geometry ResNets, got {type(model).__name__}")
    is_imagenet = isinstance(model, ResNetImageNet)
    stage_names = [n for n in ("layer1", "layer2", "layer3", "layer4") if hasattr(model, n)]

    def conv_of(m, conv_name, bn_name, act_grid=None) -> IntConv2d:
        conv = getattr(m, conv_name)
        if not isinstance(conv, QConv2d):
            raise TypeError(f"{conv_name} is {type(conv).__name__}, expected QConv2d")
        return _convert_conv(conv, getattr(m, bn_name), weight_bits, backend, int4_pack=weight_bits == 4,
                             act_grid=act_grid)

    blocks_src = []
    for sn in stage_names:
        stage = getattr(model, sn)
        blocks_src.extend(getattr(stage, str(i)) for i in range(stage.num_blocks))

    int_blocks: List[nn.Module] = []
    for bi, blk in enumerate(blocks_src):
        convs = [conv_of(blk, cn, bn) for cn, bn in _block_convs(blk)]
        ds = None
        if blk.downsample is not None:
            ds = conv_of(blk.downsample, "conv", "bn", act_grid=observer_grid(blk.conv1))
        out_grid = observer_grid(blocks_src[bi + 1].conv1) if bi + 1 < len(blocks_src) else None
        if len(convs) == 3:
            int_blocks.append(Int8Bottleneck(convs[0], convs[1], convs[2], ds, out_grid))
        else:
            int_blocks.append(Int8BasicBlock(convs[0], convs[1], ds, out_grid))

    stages: List[_Int8Stage] = []
    idx = 0
    for sn in stage_names:
        n = getattr(model, sn).num_blocks
        stages.append(_Int8Stage(int_blocks[idx: idx + n]))
        idx += n

    stem = conv_of(model, "conv1", "bn1")
    if space_to_depth and is_imagenet and stem.kernel_size == (7, 7) and stem.stride == (2, 2):
        stem = Int8SpaceToDepthStem(stem)
    if not isinstance(model.fc, QLinear):
        raise TypeError("model.fc must be QLinear")
    fc = _convert_linear(model.fc, None, weight_bits, int4_pack=False)
    eng = Int8ResNet(stem, observer_grid(blocks_src[0].conv1), stages, fc, imagenet_pool=is_imagenet)
    # serving reads the geometry: a CIFAR engine must not default to 224
    eng.input_size = getattr(model, "input_size", 224)
    return eng.to(dev)
