"""Running-range activation observers (PyTorch port of
``quantized_tpu/quantcore/observers.py``).

- batch statistic: mean over the batch of per-sample min (resp. max);
- inverted EMA: ``running = momentum * running + (1 - momentum) * new``
  with ``momentum = 0.1``;
- observer-update (training) mode quantizes with the current batch
  statistic; eval mode uses the frozen running buffers;
- the quantize call passes ``num_chunks=16`` (dead on the explicit min/max
  path, kept for parity);
- on a mesh (``place``, a ``parallel.sharding.MeshPlace``) the statistic is
  the global batch's: a sample's min and max over the model ranks where
  its channels are split, every sample's gathered over the data ranks and
  their mean taken as one device takes it.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from quantized_tpu_torch.quantcore.ste import fake_quant

DEFAULT_MOMENTUM = 0.1
QUANT_MEASURE_NUM_CHUNKS = 16


class QuantMeasureState(NamedTuple):
    """running_min / running_max buffers, each of shape ``(1,)``."""

    running_min: torch.Tensor
    running_max: torch.Tensor

    @classmethod
    def init(cls, device=None) -> "QuantMeasureState":
        return cls(torch.zeros(1, device=device), torch.zeros(1, device=device))


def batch_min_max_stat(x: torch.Tensor, place=None, channels_sharded: bool = False
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mean over the batch of the per-sample min and max. On a mesh the
    batch is the global one: ``x`` is this rank's rows (and, with
    ``channels_sharded``, its block of the channels)."""
    y = x.reshape(x.shape[0], -1)
    lo, hi = y.amin(dim=-1), y.amax(dim=-1)
    if place is None:
        return lo.mean(), hi.mean()
    return place.sample_means(lo, hi, channels_sharded)


def ema_update(running: torch.Tensor, new: torch.Tensor, momentum: float = DEFAULT_MOMENTUM) -> torch.Tensor:
    """Inverted EMA: ``running*momentum + new*(1-momentum)``."""
    return running * momentum + new * (1.0 - momentum)


def quant_measure(
    x: torch.Tensor,
    state: QuantMeasureState,
    training: bool,
    num_bits: int = 8,
    momentum: float = DEFAULT_MOMENTUM,
    fake_quant_fn=fake_quant,
    place=None,
    channels_sharded: bool = False,
) -> Tuple[torch.Tensor, QuantMeasureState]:
    """Observe + fake-quantize. Returns (quantized x, new state)."""
    if training:
        min_value, max_value = batch_min_max_stat(x.detach(), place, channels_sharded)
        new_state = QuantMeasureState(
            running_min=ema_update(state.running_min, min_value, momentum),
            running_max=ema_update(state.running_max, max_value, momentum),
        )
    else:
        min_value, max_value = state.running_min[0], state.running_max[0]
        new_state = state
    y = fake_quant_fn(
        x,
        num_bits=num_bits,
        min_value=min_value,
        max_value=max_value,
        num_chunks=QUANT_MEASURE_NUM_CHUNKS,
    )
    return y, new_state
