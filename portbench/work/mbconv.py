"""Operations and bytes of the EfficientNet engine's depthwise conv, the
work of its ``block<k>.dw`` span (the depthwise kernel and the zeroing of
its sums): 2 x its MACs, and its input, its weights with 8 bytes of
epilogue (alpha, beta) a channel, its int8 output and its int32 sums of
each (image, channel), each once. A whole block's work is
``counts.unit_work`` of the reference's ``units``."""

from __future__ import annotations

from typing import List, Tuple

from portbench.work import counts


def dw_work(spec, side: int, batch: int) -> Tuple[int, int]:
    """(operations, bytes) of one depthwise conv over a batch."""
    ho = counts.out_side(side, spec)
    nbytes = (batch * side * side * spec.cin + counts.conv_weight_bytes(spec) + batch * ho * ho * spec.cout
              + 4 * batch * spec.cout)
    return 2 * batch * counts.conv_macs(spec, side), nbytes


def dw_layers(ref, cfg) -> List[Tuple[str, object, int]]:
    """Each block's ``block<k>.dw`` span with its conv and input side."""
    return [(f"{b['name']}.dw", b["dw"], b["in_side"]) for b in ref.block_specs(cfg)]
