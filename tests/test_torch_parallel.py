"""The port's mesh shape and partition rules against the JAX package's, with
no process group (``tests/test_torch_distributed.py`` runs the collectives).

- ``infer_mesh_shape`` equals JAX's for 1-16 devices and every model degree
  (JAX asserts where a degree does not divide; the port raises ValueError).
- The partition rules for every tensor of the CIFAR ResNet-20 (float BN and
  RangeBN), fake-quant and int engine: the fake-quant keys are JAX's
  (``load_jax_arrays`` takes JAX's flat state), so its specs equal JAX's;
  the int engine's weights are K-major in the port (``w_ck`` (Cout, K),
  ``w_nk`` (N, K)) where JAX holds HWIO ``w_q`` and a (K, N) dense ``w_q``:
  the port's sharded dim is the counterpart of JAX's, and the same tensors
  replicate.
- ``shard_copies`` (the shards ranks hold, run in turn in one process):
  every conv and the fc of the engine, at 2 and 4 shards, concatenate to the
  whole layer's output, bit for bit, on "xla" and "pallas".
- ``local_batch_slice`` and ``activation_spec``.
"""

import copy

import numpy as np
import pytest
import torch
import torch.distributed as dist
from flax import nnx

from quantized_tpu.engine import build_int8_resident as j_build_resident
from quantized_tpu.parallel.mesh import infer_mesh_shape as j_infer_mesh_shape
from quantized_tpu.parallel.sharding import activation_spec as j_activation_spec
from quantized_tpu.parallel.sharding import int_engine_partition_spec as j_int_engine_spec
from quantized_tpu.parallel.sharding import param_partition_spec as j_param_spec
from quantized_tpu_torch.engine import build_int8_resident
from quantized_tpu_torch.engine.int_layers import IntConv2d, IntLinear
from quantized_tpu_torch.ingest import load_jax_arrays
from quantized_tpu_torch.models import get_model
from quantized_tpu_torch.parallel import activation_spec, int_engine_partition_spec, param_partition_spec
from quantized_tpu_torch.parallel.distributed import local_batch_slice
from quantized_tpu_torch.parallel.mesh import MODEL_AXIS, infer_mesh_shape
from quantized_tpu_torch.parallel.tp_engine import shard_copies
from torch_jax_twins import jax_model

FLAVORS = {"float_bn": "resnet_quantized_float_bn", "rangebn": "resnet_quantized"}
# port int-engine leaf -> (JAX leaf, {port dim: JAX dim})
ENGINE_LEAVES = {"w_ck": ("w_q", {0: 3}), "w_nk": ("w_q", {0: 1})}


@pytest.mark.parametrize("n", range(1, 17))
def test_infer_mesh_shape_matches_jax(n):
    for mp in (None, *range(1, 17)):
        try:
            want = j_infer_mesh_shape(n, mp)
        except AssertionError:
            with pytest.raises(ValueError):
                infer_mesh_shape(n, mp)
            continue
        assert infer_mesh_shape(n, mp) == want, (n, mp)


def _flat(model):
    return {".".join(map(str, k)): v.get_value() for k, v in nnx.to_flat_state(nnx.state(model))
            if isinstance(v, (nnx.Param, nnx.BatchStat))}


def _jax_spec(spec, ndim):
    """A JAX PartitionSpec as one entry per dim."""
    entries = tuple(spec)
    return entries + (None,) * (ndim - len(entries))


def _sharded_dim(spec):
    return spec.index(MODEL_AXIS) if MODEL_AXIS in spec else None


@pytest.fixture(scope="module", params=list(FLAVORS))
def twins(request):
    """(port model, JAX model) of one flavor, the port's state loaded from
    JAX's flat state by the weight bridge."""
    name = FLAVORS[request.param]
    jm = jax_model(name, dataset="cifar10", depth=20)
    tm = get_model(name)(dataset="cifar10", depth=20, generator=torch.Generator().manual_seed(0))
    load_jax_arrays(tm, {k: np.asarray(v) for k, v in _flat(jm).items()})
    return tm.eval(), jm


def test_fake_quant_partition_rules_match_jax(twins):
    tm, jm = twins
    jflat = _flat(jm)
    state = tm.state_dict()
    assert set(state) == set(jflat)
    for key, t in state.items():
        want = _jax_spec(j_param_spec(tuple(key.split(".")), jflat[key]), t.ndim)
        assert param_partition_spec(key, t) == want, key


def test_int_engine_partition_rules_match_jax(twins):
    tm, jm = twins
    teng = build_int8_resident(copy.deepcopy(tm), device="cpu")
    jflat = _flat(j_build_resident(jm))
    state = teng.state_dict()
    assert len(state) == len(jflat)
    sharded = 0
    for key, t in state.items():
        prefix, leaf = key.rsplit(".", 1)
        jleaf, dims = ENGINE_LEAVES.get(leaf, (leaf, {d: d for d in range(t.ndim)}))
        jval = jflat[f"{prefix}.{jleaf}"]
        want = _sharded_dim(_jax_spec(j_int_engine_spec(tuple(key.split(".")), jval), jval.ndim))
        got = _sharded_dim(int_engine_partition_spec(key, t))
        assert (got if got is None else dims[got]) == want, key
        sharded += got is not None
    assert sharded == len(state)  # every tensor of the engine is per out channel


@pytest.mark.parametrize("backend", ["xla", "pallas"])
@pytest.mark.parametrize("parts", [2, 4])
def test_shards_in_turn_equal_the_whole_layer(twins, backend, parts):
    """Each conv of the engine fed its input of one forward, and the fc:
    the shards' outputs concatenated along channels equal the layer's, in
    the forms the engine calls (recorded), on the clamped RangeBN convs
    too."""
    tm, _ = twins
    eng = build_int8_resident(copy.deepcopy(tm), backend=backend, device="cpu")
    calls = []
    for layer in eng.modules():
        if isinstance(layer, (IntConv2d, IntLinear)):
            layer.run_q = _recorder(layer, calls)
    x = torch.from_numpy(np.random.default_rng(3).standard_normal((2, 32, 32, 3)).astype(np.float32))
    with torch.inference_mode():
        eng(x)
    assert len(calls) == 22  # 21 convs, the fc
    for layer, args, kwargs, whole in calls:
        if layer.alpha.shape[0] % parts:
            continue
        with torch.inference_mode():
            got = torch.cat([type(s).run_q(s, *args, **kwargs) for s in shard_copies(layer, parts)], dim=-1)
        assert torch.equal(got, whole), (type(layer).__name__, tuple(layer.alpha.shape))


def _recorder(layer, calls):
    run = layer.run_q

    def record(*args, **kwargs):
        out = run(*args, **kwargs)
        calls.append((layer, args, kwargs, out))
        return out

    return record


def test_local_batch_slice(monkeypatch):
    assert local_batch_slice(8) == slice(0, 8)  # one process, no group
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_world_size", lambda: 4)
    for rank in range(4):
        monkeypatch.setattr(dist, "get_rank", lambda rank=rank: rank)
        assert local_batch_slice(8) == slice(2 * rank, 2 * rank + 2)


@pytest.mark.parametrize("rank", [1, 2, 3, 4])
def test_activation_spec_matches_jax(rank):
    assert activation_spec(rank) == tuple(j_activation_spec(rank))
