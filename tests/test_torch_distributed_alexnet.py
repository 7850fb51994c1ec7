"""``IntExecutor(mesh=)`` on the int8 AlexNet over a 4-rank gloo group on
the CPU (``tests/torch_dist.py``), against the port's single-device engine
and the JAX package's engine.

AlexNet takes only 224x224 inputs (its fc1 reads the 6x6x256 map), so the
batch is cut instead: 2 images, one row per data rank. The JAX reference is
JAX's engine on one device, held to JAX's own bound between its sharded
forward and that engine, 2e-3 (``tests/test_int_engine_sharded.py:90``):
JAX's forward sharded over its virtual devices, as that test shards it,
took 20-45 s on the CPU at this batch (its tensor-parallel convs and fc are slow
on XLA's CPU backend), past this file's time. Bounds: equal to the port's
single-device engine on "xla" and "pallas"; within 2e-3 of JAX's engine
on "xla".
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from flax import nnx

from quantized_tpu.engine import build_int8_alexnet as j_build_alexnet
from test_torch_distributed import jax_twin, port_spec, rank_results
from torch_dist import Ranks

BATCH = 2


@pytest.fixture(scope="module")
def alexnet_world(tmp_path_factory):
    spec = port_spec("alexnet_quantized", {})
    x = np.random.default_rng(0).standard_normal((BATCH, 224, 224, 3)).astype(np.float32)
    ranks = Ranks(4, {"cases": [("executor", "executor", dict(tp=2, models={"alexnet": spec}, x={"alexnet": x},
                                                              backends=("xla", "pallas")))]},
                  tmp_path_factory.mktemp("alexnet"))
    graphdef, state = nnx.split(j_build_alexnet(jax_twin(spec)))
    want = np.asarray(jax.jit(lambda s, v: nnx.merge(graphdef, s)(v))(state, jnp.asarray(x)))
    return rank_results(ranks), want


@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_int_executor_over_a_mesh_alexnet(alexnet_world, backend):
    results, want = alexnet_world
    for rank, res in enumerate(results):
        c = res["executor"][("alexnet", backend)]
        np.testing.assert_array_equal(c["mesh"], c["single"])
        assert len(c["sharded"]) == 5 and c["dense"] == 3, c
        assert all(2 * local == full for local, full in c["sharded"].values()), (rank, c["sharded"])
        assert c["counts"] == {"all_gather": {"model": 8, "data": 1}}, c["counts"]
        if backend == "xla":
            np.testing.assert_allclose(c["mesh"], want, atol=2e-3, rtol=0)
