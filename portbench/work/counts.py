"""Operations and bytes of the int8 layers at their shapes.

A conv or fc does ``2 * MACs`` integer operations. Its bytes are each
input byte read once, each weight byte read once with 8 bytes of epilogue
(alpha, beta) a channel, and each output byte written once: int8
activations, float32 where a layer feeds the pool or emits logits. A unit
(a residual block, a depthwise/pointwise pair) counts its own input, the
weights of all its convs and its output once each, whatever kernels run
it. The least time of a unit is the larger of its operations over the
int8 peak and its bytes over the memory bandwidth."""

from __future__ import annotations

from typing import Iterable, Tuple


def out_side(side: int, spec) -> int:
    return (side + 2 * spec.pad - spec.k) // spec.stride + 1


def conv_macs(spec, side: int) -> int:
    """Multiply-adds of one image through a conv whose input is side x side."""
    ho = out_side(side, spec)
    return ho * ho * spec.cout * spec.k * spec.k * (spec.cin // spec.groups)


def conv_weight_bytes(spec) -> int:
    return spec.k * spec.k * (spec.cin // spec.groups) * spec.cout + 8 * spec.cout


def conv_work(spec, side: int, batch: int, out_bytes: int = 1) -> Tuple[int, int]:
    """(operations, bytes) of one conv over a batch."""
    ho = out_side(side, spec)
    nbytes = batch * side * side * spec.cin + conv_weight_bytes(spec) + batch * ho * ho * spec.cout * out_bytes
    return 2 * batch * conv_macs(spec, side), nbytes


def fc_work(features: int, classes: int, batch: int) -> Tuple[int, int]:
    """(operations, bytes) of the fc head: int8 input, float32 logits."""
    nbytes = batch * features + features * classes + 8 * classes + batch * classes * 4
    return 2 * batch * features * classes, nbytes


def unit_work(unit: dict, batch: int) -> Tuple[int, int]:
    """(operations, bytes) of a unit over a batch: see the module docstring."""
    ops = sum(2 * batch * conv_macs(spec, side) for spec, side in unit["layers"])
    nbytes = (batch * unit["in_side"] ** 2 * unit["cin"]
              + sum(conv_weight_bytes(spec) for spec, _ in unit["layers"])
              + batch * unit["out_side"] ** 2 * unit["cout"] * unit["out_bytes"])
    return ops, nbytes


def forward_macs(layers: Iterable, features: int, classes: int) -> int:
    """Multiply-adds of one image through every conv and the fc."""
    return sum(conv_macs(spec, side) for spec, side in layers) + features * classes


def least_seconds(ops: int, nbytes: int, peaks: dict) -> float:
    return max(ops / peaks["int8_ops_per_s"], nbytes / peaks["hbm_bytes_per_s"])
