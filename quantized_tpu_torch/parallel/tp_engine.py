"""Explicit-collective tensor parallelism for the integer engines
(counterpart of ``quantized_tpu/parallel/tp_engine.py``).

Each function and module runs on every rank of a (data, model) mesh, on
this rank's rows and its block of the weights, and places its collectives
itself (``parallel.collectives``):

- ``tp_int8_conv``: the conv's out channels sharded over ``model``; each
  rank runs its shard, and one all-gather along channels reassembles the
  output. The gather moves the conv's own output: int8 (requantized),
  int16 (the shortcut leg) or f32.
- ``tp_int8_linear``: a dense layer's output features sharded over
  ``model``, then an all-gather of the columns.
- ``tp_int8_linear_rs``: the contraction sharded over ``model``; the int32
  partial products are reduce-scattered before the f32 epilogue, which each
  rank applies to its columns.

Both are integer-exact against the single-device engine: an output channel
depends on its own weights and epilogue alone.

``ExplicitTPConv``, ``ExplicitTPLinear`` and ``ExplicitTPFc`` take the place
of an engine's ``IntConv2d`` or ``IntLinear``, with the call forms the
engines use (relu, ``out_requant``, ``out_prescale``, ``prescale_s16``).
``apply_explicit_tp`` wraps one stage's convs and the fc head (the CLI's
``--tp-explicit``); ``shard_engine`` wraps every conv and dense layer that
can take it, which is how ``IntExecutor(mesh=...)`` runs an engine.

Two departures from the JAX package:

- (a) The shard's conv runs the wrapped ``IntConv2d``'s own backend through
  its ``run_q`` (on the card under ``"pallas"``: kernel K2), where JAX's
  shard calls its XLA conv. So the ``prescale_s16`` leg has the form that
  backend gives it on one device (int16 on the xla and bf16 backends, f32
  on ``"pallas"`` and ``"gemm"``), and the TP engine equals the
  single-device engine on every backend. JAX's shard always takes the
  int16 leg, which equals its single-device engine on its own default
  backend, ``"xla"``.
- (b) The RangeBN clamp ``y_clip`` (2, Cout) is sliced with the shard's
  channels and applied. JAX's ``tp_int8_conv`` never passes it, so its
  explicit-TP RangeBN engine runs the last stage unclamped (ROADMAP C5).

The partial product of ``tp_int8_linear_rs``, which JAX leaves to
``lax.dot_general`` outside any Pallas kernel, is ``torch._int_mm`` on the
card where it takes the shape (M > 16, K and N multiples of 8; the rows are
padded to 17 where fewer), else the exact product
(``ops.int8_matmul.exact_int_matmul``). ``tp_explicit_head`` pads N and K
with zeros to multiples of 8 x the model degree, where JAX pads to
multiples of the degree: every rank's K block and the N it scatters then
suit ``_int_mm``. The padded columns are sliced off.
"""

from __future__ import annotations

import copy
from typing import List, Optional, Tuple

import torch
from torch import nn
from torch.distributed.device_mesh import DeviceMesh

from quantized_tpu_torch.engine.int_layers import IntConv2d, IntLinear, quantize_input_stored
from quantized_tpu_torch.ops.int4 import unpack_int4_nk
from quantized_tpu_torch.ops.int8_matmul import INT_MM_MIN_M, acc_epilogue, exact_int_matmul
from quantized_tpu_torch.parallel.collectives import all_gather, reduce_scatter
from quantized_tpu_torch.parallel.mesh import MODEL_AXIS, axis_index, axis_size
from quantized_tpu_torch.parallel.sharding import int_engine_partition_spec, shard_int_engine_state, slice_state

Grid = Tuple[float, int]
HEAD_PAD = 8  # tp_explicit_head pads N and K to multiples of HEAD_PAD x the model degree


def tp_int8_conv(mesh: DeviceMesh, x_q: torch.Tensor, conv: IntConv2d, relu: Optional[bool] = None,
                 out_requant: Optional[Grid] = None, out_prescale: Optional[Tuple[float, float]] = None,
                 prescale_s16: bool = False) -> torch.Tensor:
    """Out-channel TP conv: ``conv`` is this rank's shard (its state sliced
    by ``shard_int_engine_state``), ``x_q`` this rank's rows at full width;
    the shard's ``run_q`` in the given form, then one all-gather along
    channels over ``model``."""
    y = conv.run_q(x_q, relu=relu, out_requant=out_requant, out_prescale=out_prescale,
                   prescale_s16=prescale_s16)
    return all_gather(y, mesh, MODEL_AXIS, dim=-1)


def tp_int8_linear(mesh: DeviceMesh, x_q: torch.Tensor, fc: IntLinear, relu: Optional[bool] = None,
                   out_requant: Optional[Grid] = None) -> torch.Tensor:
    """Out-feature TP dense layer: ``fc`` is this rank's shard of the output
    features; its ``run_q``, then one all-gather of the columns over
    ``model``."""
    return all_gather(fc.run_q(x_q, relu=relu, out_requant=out_requant), mesh, MODEL_AXIS, dim=1)


def int_partial(x_q: torch.Tensor, w_nk: torch.Tensor) -> torch.Tensor:
    """int32 ``x_q @ w_nk.T``: ``torch._int_mm`` on the card where it takes
    the shape (the rows padded to INT_MM_MIN_M where fewer), else exact."""
    (m, k), n = x_q.shape, w_nk.shape[0]
    if not (x_q.is_cuda and k % 8 == 0 and n % 8 == 0):
        return exact_int_matmul(x_q, w_nk)
    rows = x_q if m >= INT_MM_MIN_M else torch.cat([x_q, x_q.new_zeros((INT_MM_MIN_M - m, k))])
    return torch._int_mm(rows.contiguous(), w_nk.T)[:m]


def tp_int8_linear_rs(mesh: DeviceMesh, x_q: torch.Tensor, w_nk: torch.Tensor, alpha: torch.Tensor,
                      beta: torch.Tensor, relu: bool = False) -> torch.Tensor:
    """Contraction-sharded int8 GEMM: ``x_q`` (M, K/d) and ``w_nk`` (N, K/d)
    are this rank's K block, ``alpha`` and ``beta`` its N/d columns. The
    int32 partials are reduce-scattered over ``model``, then this rank's
    f32 epilogue: (M, N/d)."""
    acc = reduce_scatter(int_partial(x_q, w_nk), mesh, MODEL_AXIS, dim=1)
    return acc_epilogue(acc, alpha, beta, relu)


def shard_copies(layer: nn.Module, parts: int) -> List[nn.Module]:
    """The ``parts`` out-channel shards of an ``IntConv2d`` or ``IntLinear``,
    each a copy with its state sliced as rank ``i`` of a model axis of
    ``parts`` holds it: the shards a mesh's ranks run, to run in turn in one
    process (their outputs, concatenated along channels, are the layer's)."""
    shards = []
    for i in range(parts):
        shard = copy.deepcopy(layer)
        slice_state(shard, int_engine_partition_spec, i, parts)
        if isinstance(shard, IntConv2d):
            shard.refresh_operands()
        shards.append(shard)
    return shards


def _divides(n: int, mesh: DeviceMesh) -> bool:
    return n % axis_size(mesh, MODEL_AXIS) == 0


class ExplicitTPConv(nn.Module):
    """An ``IntConv2d`` run as :func:`tp_int8_conv`. The conv given becomes
    this rank's shard of its out channels (its weights, epilogue and clamp
    sliced, its backend's operands rebuilt); the layer reads like the conv
    it wraps (grid, stride, ...), so the engines call it unchanged. The mesh
    is a plain attribute, not state."""

    def __init__(self, conv: IntConv2d, mesh: DeviceMesh):
        super().__init__()
        if conv.groups != 1 or not _divides(conv.alpha.shape[0], mesh):
            raise ValueError(f"a conv of {conv.alpha.shape[0]} out channels in {conv.groups} groups does not "
                             f"shard over {axis_size(mesh, MODEL_AXIS)} ranks")
        shard_int_engine_state(conv, mesh)
        conv.refresh_operands()
        self.conv = conv
        self.mesh = mesh

    def __getattr__(self, name):
        try:
            return super().__getattr__(name)
        except AttributeError:
            inner = self.__dict__.get("_modules", {}).get("conv")
            if inner is None:
                raise
            return getattr(inner, name)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x_q = quantize_input_stored(x, self.conv.act_scale, self.conv.act_zero_point)
        return self.run_q(x_q, relu=self.conv.relu)

    def run_q(self, x_q, relu=None, out_requant=None, out_prescale=None, prescale_s16=False) -> torch.Tensor:
        return tp_int8_conv(self.mesh, x_q, self.conv, relu, out_requant, out_prescale, prescale_s16)


class ExplicitTPLinear(nn.Module):
    """An ``IntLinear`` run as :func:`tp_int8_linear`: the layer given
    becomes this rank's shard of its output features."""

    def __init__(self, fc: IntLinear, mesh: DeviceMesh):
        super().__init__()
        if not _divides(fc.alpha.shape[0], mesh):
            raise ValueError(f"{fc.alpha.shape[0]} output features do not shard over "
                             f"{axis_size(mesh, MODEL_AXIS)} ranks")
        shard_int_engine_state(fc, mesh)
        self.fc = fc
        self.mesh = mesh

    def __getattr__(self, name):
        try:
            return super().__getattr__(name)
        except AttributeError:
            inner = self.__dict__.get("_modules", {}).get("fc")
            if inner is None:
                raise
            return getattr(inner, name)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.run_q(quantize_input_stored(x, self.fc.act_scale, self.fc.act_zero_point))

    def run_q(self, x_q, relu=None, out_requant=None) -> torch.Tensor:
        return tp_int8_linear(self.mesh, x_q, self.fc, relu, out_requant)


def head_shard(fc: IntLinear, index: int, parts: int) -> dict:
    """Rank ``index`` of ``parts``'s share of a head in the reduce-scatter
    form: its K block of the weights padded to multiples of HEAD_PAD x
    ``parts`` (N and K), its N block of the padded epilogue, its columns of
    the unpadded input (``k_block``), the zero columns that pad them
    (``pad_k``) and the unpadded N."""
    w = unpack_int4_nk(fc.w_nk) if fc.int4 else fc.w_nk
    n, k = w.shape
    pad_n, pad_k = (-n) % (HEAD_PAD * parts), (-k) % (HEAD_PAD * parts)
    w = nn.functional.pad(w, (0, pad_k, 0, pad_n))
    kb, nb = (k + pad_k) // parts, (n + pad_n) // parts
    hi = min((index + 1) * kb, k)
    lo = min(index * kb, hi)
    return {"w_nk": w[:, index * kb:(index + 1) * kb].contiguous(),
            "alpha": nn.functional.pad(fc.alpha, (0, pad_n))[index * nb:(index + 1) * nb].contiguous(),
            "beta": nn.functional.pad(fc.beta, (0, pad_n))[index * nb:(index + 1) * nb].contiguous(),
            "k_block": (lo, hi), "pad_k": kb - (hi - lo), "n": n}


class ExplicitTPFc(nn.Module):
    """An engine's ``IntLinear`` head run in the reduce-scatter form
    (:func:`tp_explicit_head`, the CLI's ``--tp-explicit``): holds this
    rank's share (:func:`head_shard`)."""

    def __init__(self, fc: IntLinear, mesh: DeviceMesh):
        super().__init__()
        share = head_shard(fc, axis_index(mesh, MODEL_AXIS), axis_size(mesh, MODEL_AXIS))
        for name in ("w_nk", "alpha", "beta"):
            self.register_buffer(name, share[name])
        self.k_block, self.pad_k, self.n = share["k_block"], share["pad_k"], share["n"]
        self.act_scale, self.act_zero_point, self.relu = fc.act_scale, fc.act_zero_point, fc.relu
        self.mesh = mesh

    @property
    def grid(self) -> Grid:
        return (self.act_scale, self.act_zero_point)

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        return tp_explicit_head(self.mesh, self, h)


def tp_explicit_head(mesh: DeviceMesh, fc: ExplicitTPFc, h: torch.Tensor) -> torch.Tensor:
    """f32 features -> f32 logits through the reduce-scatter form: this
    rank's K block of the quantized input against its K block of the
    weights, the int32 partials reduce-scattered, the epilogue on its N
    block, then the blocks gathered over ``model`` so every rank holds the
    whole logits (JAX leaves them column-sharded in its global array)."""
    x_q = quantize_input_stored(h[:, fc.k_block[0]:fc.k_block[1]], fc.act_scale, fc.act_zero_point)
    if fc.pad_k:
        x_q = nn.functional.pad(x_q, (0, fc.pad_k))
    y = tp_int8_linear_rs(mesh, x_q, fc.w_nk, fc.alpha, fc.beta, relu=fc.relu)
    return all_gather(y, mesh, MODEL_AXIS, dim=1)[:, :fc.n]


def apply_explicit_tp(model: nn.Module, mesh: DeviceMesh, conv_stage="last") -> int:
    """Wire the explicit-collective TP forms into a resident engine: the fc
    head (reduce-scatter form) and every groups-1 conv of one stage
    (all-gather form; default the last stage: the smallest activations and
    the widest channels). Returns the number of convs wrapped."""
    wrapped = 0
    num_stages = getattr(model, "num_stages", 0)
    stage = None
    if num_stages and conv_stage is not None:
        idx = num_stages if conv_stage == "last" else int(conv_stage)
        stage = getattr(model, f"layer{idx}", None)
    if stage is not None and hasattr(stage, "num_blocks"):
        for j in range(stage.num_blocks):
            blk = getattr(stage, str(j))
            for name in ("conv1", "conv2", "conv3", "downsample"):
                conv = getattr(blk, name, None)
                if isinstance(conv, IntConv2d) and conv.groups == 1:
                    setattr(blk, name, ExplicitTPConv(conv, mesh))
                    wrapped += 1
    if isinstance(getattr(model, "fc", None), IntLinear):
        model.fc = ExplicitTPFc(model.fc, mesh)
    return wrapped


def shard_engine(model: nn.Module, mesh: DeviceMesh) -> Tuple[int, int]:
    """Shard every groups-1 ``IntConv2d`` and every ``IntLinear`` of an
    engine whose out channels divide the model degree over ``model``
    (:class:`ExplicitTPConv`, :class:`ExplicitTPLinear`); the fused blocks
    and pairs, the depthwise convs and the layers that do not divide stay
    whole on every rank (GSPMD leaves an opaque custom call whole, and
    replicates what does not divide), as do the layers
    :func:`apply_explicit_tp` wrapped. Returns (convs, dense layers)
    sharded."""
    todo = [(parent, name, child) for parent in model.modules() for name, child in parent.named_children()
            if not isinstance(parent, (ExplicitTPConv, ExplicitTPLinear))  # sharded already
            and ((isinstance(child, IntConv2d) and child.groups == 1) or isinstance(child, IntLinear))]
    convs = dense = 0
    for parent, name, child in todo:
        if not _divides(child.alpha.shape[0], mesh):
            continue
        if isinstance(child, IntConv2d):
            setattr(parent, name, ExplicitTPConv(child, mesh))
            convs += 1
        else:
            setattr(parent, name, ExplicitTPLinear(child, mesh))
            dense += 1
    return convs, dense
