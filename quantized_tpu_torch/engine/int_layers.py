"""Integer-executing layers (counterparts of ``quantized_tpu/engine/int_layers.py``).

Each layer owns its input grid (from the source model's frozen observer),
per-channel int8 weights with BN folded in, and the fused epilogue
(alpha, beta). Activations are stored int8 (logical uint8 - 128).

The weights are kept in the layout the kernels take, packed once when the
layer is built: a conv holds (Cout, Kh*Kw*Cin) and a dense layer (N, K).
:meth:`IntConv2d.weights` and :attr:`IntLinear.w_q` give them back in the
JAX package's layouts (HWIO and (K, N)).

Int4 weights (``int4_shape`` / ``int4=True``) keep their packed bytes, half
the int8 size (``ops/int4.py``): a conv holds (Cout, Kh*Kw, Cin/2)
channel-split bytes and unpacks them on every call into the (Cout,
Kh*Kw*Cin) int8 operand, as the JAX package's ``weights()`` does (no int8
copy is kept); a dense layer holds (N, K/2) split-half bytes and runs them
on kernel B6.

Backends of :class:`IntConv2d` (:data:`CONV_BACKENDS`, switched by
:meth:`IntConv2d.set_backend`):

- ``"pallas"``: the direct conv, kernel K2 (``ops/int8_conv_pallas.py``);
- ``"gemm"``: im2col + the int8 GEMM, kernel K1;
- ``"xla"``: the exact plain ``int8_conv_xla`` (the JAX package's XLA s8
  conv, which the port leaves to plain PyTorch: on the GPU an im2col and a
  float64 product, so a reference, not a fast path);
- ``"bf16"``: the dequantized conv on bf16 operands with an f32
  accumulator and the epilogue in f32 (``ops.int8_conv.bf16_conv``: cuDNN
  on the GPU), its bf16 weights built when the layer takes a bf16 backend
  (at construction when built with one) and released when it leaves them;
- ``"s4"``: the two-half conv on packed int4 bytes (``ops.int4.int4_conv_s4``,
  packed layers only);
- ``"xla-split"``, ``"bf16-split"``, ``"s4-split"``: the same conv with an
  f32 output and the requant as a separate pass.

A grouped (depthwise) conv takes the exact grouped path of ``int8_conv_xla``
on ``"pallas"`` and ``"gemm"``, as in the JAX package, which routes only
``groups == 1`` to Pallas or gemm; its other backends take ``groups`` too.
The int16 shortcut leg (``prescale_s16``, :data:`S16_FINE`) runs on the
xla and bf16 backends, as in the JAX package; the fused downsample blocks
(``engine/fused.py``) carry it in their kernels. :class:`IntLinear` runs K1
(``"pallas"``; ``"pallas:bm,bn,bk"`` is accepted and runs K1 on its own
launch plan, ``ops.gemm_plan``, since the block sizes are TPU VMEM tiles with
no counterpart there, so the fc autotuner races ``"xla"`` against
``"pallas"`` only) or ``int8_matmul_xla`` (``"xla"``), and B6 on int4
weights.

``y_clip`` (2, Cout), the RangeBN flavor's observer clamp folded into the
conv (``engine.convert._rangebn_y_clip``), clamps ``acc * alpha + beta``
before ReLU, as ``int8_conv_xla(y_clip=)`` does: its prescaled form rides
``out_prescale``, the requant takes it as per-channel integer bounds, the
split forms clamp the f32 output before their requant pass and the bf16
forms map it through their own epilogue, all as in the JAX package. Where
the JAX package sends a clamped conv on ``"pallas"``, ``"gemm"`` or ``"s4"``
to its XLA conv (which XLA fuses with the clamp), the port keeps
``"pallas"`` and ``"gemm"`` on K2 and K1, whose CLIP instances compute the
same function (the port's ``"xla"`` is a plain reference, not a fast
path); ``"s4"`` goes to ``"xla"`` as in the JAX package. The kernels'
bounds are formed once per output grid and kept (``_clip_operands``).
:class:`Identity` takes the place of a folded BN.

``_SHAPE_RECORDER``, when the autotuner sets it to a dict, collects each
layer's input shape by ``id`` during one forward.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
from torch import nn

from quantized_tpu_torch.ops.int4 import int4_conv_s4, int4_matmul_nk, unpack_int4_conv_channels
from quantized_tpu_torch.ops.int8_conv import (
    bf16_conv,
    clip_s16_checked,
    int8_conv_gemm_ck,
    int8_conv_xla_ck,
    pack_conv_weight,
)
from quantized_tpu_torch.ops.int8_conv_pallas import (
    conv_border_sums,
    int8_conv_direct_ck,
    pixel_group,
    pixel_group_operands,
    use_gather_k,
)
from quantized_tpu_torch.ops.int8_matmul import (
    clip_minmax,
    f32,
    int8_matmul_nk,
    int8_matmul_xla_nk,
    kernel_clip,
    relu_only,
    requant_clip_bounds,
)

Grid = Tuple[float, int]
CONV_BACKENDS = ("pallas", "gemm", "xla", "xla-split", "bf16", "bf16-split", "s4", "s4-split")
# Fine grain of the int16 shortcut leg: one count is 1/S16_FINE of the
# consumer's output step (error at most 1/(2*S16_FINE) of a step, range
# +-1024 steps). The unfused downsample leg emits it on the xla and bf16
# backends and stays f32 on "pallas" and "gemm", as in the JAX package.
S16_FINE = 32.0
# the autotuner's shape recorder: {id(layer): input shape} while it is a dict
_SHAPE_RECORDER: Optional[dict] = None


def _check_backend(backend: str, packed: bool) -> None:
    if backend not in CONV_BACKENDS:
        raise ValueError(f"backend {backend!r} is not one of {CONV_BACKENDS}")
    if backend.startswith("s4") and not packed:
        raise ValueError(f"backend {backend!r} needs packed int4 weights")


Identity = nn.Identity  # takes the place of a BN folded into its conv (the JAX package's Identity)


def quantize_input_stored(x: torch.Tensor, scale: float, zero_point: int) -> torch.Tensor:
    """f32 -> stored int8 (logical uint8 - 128) on the layer's activation
    grid: ``clip(round(x * f32(1/s) + f32(zp - 128)), -128, 127)``."""
    q = torch.round(x * f32(1.0 / scale) + f32(zero_point - 128))
    return torch.clamp(q, -128.0, 127.0).to(torch.int8)


def dequantize_stored(x_q: torch.Tensor, scale: float, zero_point: int) -> torch.Tensor:
    """Stored int8 -> f32: ``(u - zp) * scale`` with ``u = stored + 128``."""
    return (x_q.to(torch.float32) + f32(128 - zero_point)) * f32(scale)


def requantize_stored(x_q: torch.Tensor, from_grid: Grid, to_grid: Grid) -> torch.Tensor:
    """Regrid a stored-int8 tensor onto another uint8 grid."""
    return quantize_input_stored(dequantize_stored(x_q, *from_grid), *to_grid)


class IntConv2d(nn.Module):
    """Integer conv with folded BN and the fused epilogue."""

    def __init__(
        self,
        w_q: torch.Tensor,  # (Kh, Kw, Cin/groups, Cout) int8, or (Kh, Kw, Cin/2, Cout) packed int4
        alpha: torch.Tensor,  # (Cout,) f32
        beta: torch.Tensor,  # (Cout,) f32
        act_scale: float,
        act_zero_point: int,
        stride=(1, 1),
        padding=(0, 0),
        groups: int = 1,
        relu: bool = False,
        backend: str = "pallas",
        int4_shape: Optional[Tuple[int, int, int, int]] = None,
        y_clip: Optional[torch.Tensor] = None,  # (2, Cout) f32: the RangeBN observer clamp
    ):
        super().__init__()
        if groups != 1 and (int4_shape is not None or tuple(w_q.shape[2:]) != (1, groups)):
            raise ValueError(f"only depthwise grouped convs are ported (one input and one output channel "
                             f"per group, int8 weights), got groups={groups} over a {tuple(w_q.shape)} kernel")
        _check_backend(backend, int4_shape is not None)
        self.kernel_size = tuple(w_q.shape[:2])
        # int4 weight-only: the channel-split packed bytes, (Cout, Kh*Kw, Cin/2)
        self.int4_shape = None if int4_shape is None else tuple(int(d) for d in int4_shape)
        if self.int4_shape is None:
            self.register_buffer("w_ck", pack_conv_weight(w_q))
        else:
            kh, kw, cin, cout = self.int4_shape
            if tuple(w_q.shape) != (kh, kw, cin // 2, cout) or cin % 2:
                raise ValueError(f"packed int4 kernel {tuple(w_q.shape)} does not hold shape {self.int4_shape}")
            self.register_buffer("w_int4", w_q.permute(3, 0, 1, 2).reshape(cout, kh * kw, cin // 2).contiguous())
        self.register_buffer("alpha", alpha.to(torch.float32).contiguous())
        self.register_buffer("beta", beta.to(torch.float32).contiguous())
        if y_clip is not None and tuple(y_clip.shape) != (2, self.alpha.shape[0]):
            raise ValueError(f"y_clip must be (2, {self.alpha.shape[0]}), got {tuple(y_clip.shape)}")
        if y_clip is not None:
            with torch.inference_mode(False):  # a tensor that counts its in-place changes: see _clip_operands
                y_clip = y_clip.to(torch.float32, copy=True).contiguous()
        self.register_buffer("y_clip", y_clip)
        self._clip_cache, self._clip_src = {}, None  # see _clip_operands
        self.act_scale = float(act_scale)
        self.act_zero_point = int(act_zero_point)
        self.stride = tuple(stride)
        self.padding = tuple(padding)
        self.groups = groups
        self.relu = relu
        # operands of K2's Hopper route, and the bf16 backends' weights and
        # bias: held while the layer is on such a backend
        for name in ("border_sums", "pg_w_ck", "pg_alpha", "pg_beta", "w_bf16", "bias_f"):
            self.register_buffer(name, None, persistent=False)
        self.set_backend(backend)

    def set_backend(self, backend: str) -> None:
        """Switch the execution path, building the operands it needs and
        releasing those of the path it leaves (a tuned engine holds only
        its winners' operands)."""
        _check_backend(backend, self.int4_shape is not None)
        self.backend = backend
        if backend == "pallas" and self.groups == 1:
            self._pallas_operands()
        else:
            self.border_sums = self.pg_w_ck = self.pg_alpha = self.pg_beta = None
        if not backend.startswith("bf16"):
            self.w_bf16 = self.bias_f = None
        elif self.w_bf16 is None:
            self._bf16_operands()

    def refresh_operands(self) -> None:
        """Rebuild what the backend derives from the weights, epilogue and
        clamp, after they were replaced (``parallel.sharding`` slices them
        to a rank's out channels)."""
        self.border_sums = self.pg_w_ck = self.pg_alpha = self.pg_beta = self.w_bf16 = self.bias_f = None
        self._clip_cache, self._clip_src = {}, None
        if self.int4_shape is not None:
            self.int4_shape = (*self.int4_shape[:3], self.alpha.shape[0])
        self.set_backend(self.backend)

    def _pallas_operands(self) -> None:
        """K2's Hopper route reads padded taps as zeros and adds back stored_zp
        times the weights' tap sums (ops.conv_border_sums), and runs a 1x1 over
        Cin % 16 != 0 on pixel groups: diag(W, ..., W) and the tiled alpha,
        beta (ops.pixel_group_operands); both built once."""
        kh, kw = self.kernel_size
        cin = self.w_ck.shape[1] // (kh * kw) if self.int4_shape is None else self.int4_shape[2]
        if (self.border_sums is None and any(self.padding) and cin % 16 == 0
                and not use_gather_k(cin, (kh, kw))):
            self.border_sums = conv_border_sums(self.weights_ck(), (kh, kw))
        g = pixel_group(cin, (kh, kw), self.stride, self.padding)
        if self.pg_w_ck is None and g > 1 and self.int4_shape is None:
            self.pg_w_ck, self.pg_alpha, self.pg_beta = pixel_group_operands(self.w_ck, self.alpha, self.beta, g)

    def _bf16_operands(self) -> None:
        """The bf16 weights ``w * alpha / s_act`` (Cout, Cin/groups, Kh, Kw),
        channels-last, and the f32 bias ``beta - alpha * (128 - zp) * colsum``,
        in float32 in the JAX package's order of operations (on the host: a
        GPU divides by a scalar through its reciprocal)."""
        w_f = self.weights().detach().cpu().numpy().astype(np.float32)  # HWIO
        alpha, beta = (t.detach().cpu().numpy() for t in (self.alpha, self.beta))
        s_w = alpha / np.float32(self.act_scale)
        colsum = np.sum(w_f, axis=(0, 1, 2))
        bias_f = beta - alpha * np.float32(128 - self.act_zero_point) * colsum
        w_bf16 = torch.from_numpy(w_f * s_w).to(torch.bfloat16).permute(3, 2, 0, 1)
        dev = self.alpha.device
        self.w_bf16 = w_bf16.contiguous(memory_format=torch.channels_last).to(dev)
        self.bias_f = torch.from_numpy(bias_f).to(dev)

    def weights_ck(self) -> torch.Tensor:
        """The int8 kernel as the kernels take it, (Cout, Kh*Kw*Cin/groups);
        int4 weights are unpacked on each call."""
        if self.int4_shape is None:
            return self.w_ck
        return unpack_int4_conv_channels(self.w_int4, dim=-1).reshape(self.w_int4.shape[0], -1)

    def weights(self) -> torch.Tensor:
        """The int8 kernel in HWIO: (Kh, Kw, Cin/groups, Cout)."""
        kh, kw = self.kernel_size
        w_ck = self.weights_ck()
        return w_ck.reshape(w_ck.shape[0], kh, kw, -1).permute(1, 2, 3, 0)

    @property
    def stored_zp(self) -> int:
        return self.act_zero_point - 128

    @property
    def grid(self) -> Grid:
        """(scale, zero_point) of the uint8 grid this conv expects its input on."""
        return (self.act_scale, self.act_zero_point)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x_q = quantize_input_stored(x, self.act_scale, self.act_zero_point)
        return self.run_q(x_q, relu=self.relu)

    def w_packed_hwio(self) -> torch.Tensor:
        """Packed int4 weights in the JAX layout, (Kh, Kw, Cin/2, Cout)."""
        kh, kw = self.kernel_size
        cout = self.w_int4.shape[0]
        return self.w_int4.reshape(cout, kh, kw, -1).permute(1, 2, 3, 0)

    def _run_bf16(self, x_q: torch.Tensor, relu: bool, out_requant: Optional[Grid],
                  out_prescale: Optional[Tuple[float, float]] = None, round_s16: bool = False,
                  y_clip=None) -> torch.Tensor:
        """The bf16 path on the same stored-int8 grids (the JAX package's
        ``_run_bf16``): the input dequantized to bf16 (the stored zero point
        to exactly 0.0, so the conv pads with zeros), the f32 conv of
        :func:`~quantized_tpu_torch.ops.int8_conv.bf16_conv`, then the epilogue
        in f32: a requant with 1/s folded into the bias, a prescaled f32 or
        int16 leg, or f32 ``relu?(y + bias)``. ``y_clip``, the clamp's bounds
        of ``y + bias``, goes through each branch's own map, as in JAX."""
        relu = relu_only(relu, f"backend {self.backend!r}")
        xb = ((x_q.to(torch.float32) + f32(128 - self.act_zero_point)) * f32(self.act_scale)).to(torch.bfloat16)
        y = bf16_conv(xb, self.w_bf16, self.stride, self.padding, self.groups)
        if out_requant is not None:
            out_scale, out_zp = out_requant
            inv = f32(1.0 / out_scale)
            lo = f32(out_zp - 128) if relu else -128.0
            q = torch.round(y * inv + (self.bias_f * inv + f32(out_zp - 128)))
            if y_clip is not None:
                return clip_minmax(q, *requant_clip_bounds(y_clip, out_scale, out_zp, relu)).to(torch.int8)
            return torch.clamp(q, lo, 127.0).to(torch.int8)
        if out_prescale is not None:
            scale, shift = out_prescale
            inv = f32(1.0 / scale)
            if round_s16:
                inv, shift = f32(inv * S16_FINE), shift * S16_FINE
            val = y * inv + (self.bias_f * inv + f32(shift))
            if y_clip is not None:
                val = clip_minmax(val, y_clip[0] * inv + f32(shift), y_clip[1] * inv + f32(shift))
            return clip_s16_checked(torch.round(val)) if round_s16 else val
        y = y + self.bias_f
        if y_clip is not None:
            y = clip_minmax(y, *y_clip)
        return torch.clamp_min(y, 0.0) if relu else y

    def _run_xla(self, x_q, alpha, beta, relu, out_requant, round_s16=False, y_clip=None) -> torch.Tensor:
        return int8_conv_xla_ck(x_q, self.weights_ck(), self.kernel_size, alpha, beta, self.stride, self.padding,
                                self.stored_zp, relu, out_requant, self.groups, round_s16, y_clip)

    def _clip_operands(self, inv: Optional[float], shift: float, out_requant: Optional[Grid], relu: bool):
        """The clamp for one call: its bounds in the epilogue's domain (raised
        by the prescale ``y * inv + shift`` where ``inv`` is given) and the
        bounds the kernels take (``kernel_clip``: the requant's integer
        bounds with an s8 output). Formed once per output grid and ``relu``
        and kept, so a served forward adds no passes over them. The kept
        bounds are dropped when ``y_clip`` is replaced (assignment, ``.to``)
        or changed in place (``load_state_dict``, ``mul_``: its version
        counter moves); an inference tensor counts no changes, so with one
        the bounds are formed on every call."""
        src = self.y_clip
        version = None if src.is_inference() else src._version
        if self._clip_src is None or self._clip_src[0] is not src or self._clip_src[1] != version:
            self._clip_cache, self._clip_src = {}, (src, version)
        key = (inv, shift, out_requant, bool(relu))
        hit = self._clip_cache.get(key)
        if hit is None:
            adj = (src[0], src[1])
            if inv is not None:
                adj = (adj[0] * inv + f32(shift), adj[1] * inv + f32(shift))
            hit = (adj, kernel_clip(adj, src.shape[1], out_requant, relu))
            if version is not None:
                self._clip_cache[key] = hit
        return hit

    def _run_s4(self, x_q, alpha, beta, relu, out_requant) -> torch.Tensor:
        return int4_conv_s4(x_q, self.w_packed_hwio(), alpha, beta, self.stride, self.padding, self.stored_zp,
                            relu=relu, out_requant=out_requant, groups=self.groups)

    def run_q(
        self,
        x_q: torch.Tensor,
        relu: Optional[bool] = None,
        out_requant: Optional[Grid] = None,
        out_prescale: Optional[Tuple[float, float]] = None,
        prescale_s16: bool = False,
    ) -> torch.Tensor:
        """Quantized-input entry: ``x_q`` stored int8 on ``self.grid``.
        Returns f32, or int8 on ``out_requant``'s grid with ReLU applied
        before the requant.

        ``out_prescale=(scale, shift)`` returns f32 ``y / scale + shift`` (no
        ReLU, no requant), the division folded into alpha/beta as the JAX
        package folds it. With ``prescale_s16`` the xla and bf16 backends
        return int16 ``round((y / scale + shift) * S16_FINE)`` instead (half
        the bytes of the f32 leg, within 1/(2*S16_FINE) of an output step);
        the other backends return f32, and the caller dispatches on dtype."""
        relu = self.relu if relu is None else relu
        if _SHAPE_RECORDER is not None:
            _SHAPE_RECORDER[id(self)] = tuple(x_q.shape)
        backend = self.backend
        alpha, beta = self.alpha, self.beta
        round_s16 = False
        inv, shift = None, 0.0
        if out_prescale is not None:
            if out_requant is not None or relu:
                raise ValueError("out_prescale excludes out_requant and relu")
            scale, shift = out_prescale
            inv = f32(1.0 / scale)
            if prescale_s16 and backend.startswith(("xla", "bf16")):
                inv, shift, round_s16 = f32(inv * S16_FINE), shift * S16_FINE, True
            alpha = alpha * inv
            beta = beta * inv + f32(shift)
        y_clip = y_clip_raw = clip = None
        if self.y_clip is not None:
            y_clip_raw = (self.y_clip[0], self.y_clip[1])
            y_clip, clip = self._clip_operands(inv, shift, out_requant, relu)
            if backend.startswith("s4"):  # as in the JAX package: the XLA conv carries the clamp
                backend = "xla-split" if backend.endswith("-split") else "xla"
        if backend.endswith("-split") and out_requant is not None:
            # the conv with an f32 epilogue, then the requant as its own pass
            # (the clamp on the f32 output, before the requant pass)
            if backend == "bf16-split":
                y = self._run_bf16(x_q, relu, None)
            elif backend == "s4-split":
                y = self._run_s4(x_q, alpha, beta, relu, None)
            else:
                y = self._run_xla(x_q, alpha, beta, relu, None)
            if y_clip_raw is not None:
                y = clip_minmax(y, *y_clip_raw)
            return quantize_input_stored(y, *out_requant)
        if backend.startswith("bf16"):
            return self._run_bf16(x_q, relu, out_requant, out_prescale, round_s16, y_clip_raw)
        if backend.startswith("s4"):
            return self._run_s4(x_q, alpha, beta, relu, out_requant)
        if backend.startswith("xla") or self.groups != 1:
            return self._run_xla(x_q, alpha, beta, relu, out_requant, round_s16, y_clip)
        if backend == "pallas":
            pixel_groups = None  # with out_prescale, the call tiles its own alpha and beta
            if self.pg_w_ck is not None and out_prescale is None:
                pixel_groups = (self.pg_w_ck, self.pg_alpha, self.pg_beta)
            return int8_conv_direct_ck(x_q, self.weights_ck(), self.kernel_size, alpha, beta, stride=self.stride,
                                       padding=self.padding, stored_zp=self.stored_zp, relu=relu,
                                       out_requant=out_requant, border_sums=self.border_sums,
                                       pixel_groups=pixel_groups, clip=clip)
        return int8_conv_gemm_ck(x_q, self.weights_ck(), self.kernel_size, alpha, beta, stride=self.stride,
                                 padding=self.padding, stored_zp=self.stored_zp, relu=relu,
                                 out_requant=out_requant, clip=clip)


class IntLinear(nn.Module):
    """Integer dense layer; weights (K, N) = (in, out) int8 on kernel K1 (or
    ``int8_matmul_xla`` on backend ``"xla"``), or (K/2, N) split-half packed
    int4 on kernel B6 when ``int4=True``; held K-major as (N, K) or (N, K/2)."""

    def __init__(
        self,
        w_q_kn: torch.Tensor,
        alpha: torch.Tensor,
        beta: torch.Tensor,
        act_scale: float,
        act_zero_point: int,
        relu: bool = False,
        int4: bool = False,
    ):
        super().__init__()
        self.register_buffer("w_nk", w_q_kn.T.contiguous())
        self.register_buffer("alpha", alpha.to(torch.float32).contiguous())
        self.register_buffer("beta", beta.to(torch.float32).contiguous())
        self.act_scale = float(act_scale)
        self.act_zero_point = int(act_zero_point)
        self.relu = relu
        self.int4 = int4
        self.backend = "pallas"

    def set_backend(self, backend: str) -> None:
        """``"pallas"`` (K1), ``"pallas:bm,bn,bk"`` (K1 on its own plan: the
        blocks are the JAX kernel's TPU tiles) or ``"xla"``."""
        if backend not in ("pallas", "xla"):
            blocks = backend[len("pallas:"):].split(",") if backend.startswith("pallas:") else []
            if len(blocks) != 3 or not all(b.strip().isdigit() for b in blocks):
                raise ValueError(f"fc backend {backend!r} is not 'pallas', 'pallas:bm,bn,bk' or 'xla'")
        self.backend = backend

    @property
    def w_q(self) -> torch.Tensor:
        """The weights in the JAX layout: (K, N) int8, or (K/2, N) packed int4."""
        return self.w_nk.T

    @property
    def grid(self) -> Grid:
        return (self.act_scale, self.act_zero_point)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.run_q(quantize_input_stored(x, self.act_scale, self.act_zero_point))

    def run_q(self, x_q: torch.Tensor, relu: Optional[bool] = None,
              out_requant: Optional[Grid] = None) -> torch.Tensor:
        """Quantized-input entry: f32 out, or int8 on ``out_requant``'s grid
        (a separate quantize pass, as in the JAX package, on int4 weights too)."""
        relu = self.relu if relu is None else relu
        if _SHAPE_RECORDER is not None:
            _SHAPE_RECORDER[id(self)] = tuple(x_q.shape)
        if self.int4:
            matmul = int4_matmul_nk
        else:
            matmul = int8_matmul_xla_nk if self.backend == "xla" else int8_matmul_nk
        y = matmul(x_q, self.w_nk, self.alpha, self.beta, relu=relu)
        if out_requant is not None:
            return quantize_input_stored(y, *out_requant)
        return y
