"""The port's distribution layer over real torch.distributed process groups
(gloo, on the CPU) against the JAX package on its 8-device virtual CPU mesh.

One module-scoped fixture starts a 4-rank group and a 2-rank group
(``tests/torch_dist.py``; every rank runs ``tests/torch_dist_worker.py``,
which imports torch and the port only) and, while they run, computes the
JAX references in this process. Each test then asserts its own case.

- ``tp_linear`` and ``tp_linear_reduce_scatter`` at (data 2, model 2)
  against JAX's on the same mesh shape, within JAX's bounds
  (``tests/test_tp_explicit.py:39,57``: 1e-5 and 1e-4); ``dp_psum_grads``;
  ``heartbeat_barrier`` and ``local_batch_slice`` on every rank.
- ``tp_int8_conv`` at (1, 4): equal to the whole conv on each backend, one
  all-gather and no reduce-scatter; against JAX's ``tp_int8_conv`` (its XLA
  conv): f32 within 1e-5, int8 equal on "xla" and within 1 step on "pallas"
  (K2 requantizes relu(y), ``tests/test_pallas_conv.py:73-94``).
- ``apply_explicit_tp`` on the float-BN CIFAR ResNet-20 at (1, 4): 7 convs
  wrapped, logits equal to the port's single-device engine, within 1e-4 of
  JAX's explicit-TP engine (on "xla", the backend JAX's shard runs), and per
  forward 8 all-gathers (the 7 convs' and the head's, which gathers its
  column blocks so every rank holds the whole logits) and 1 reduce-scatter.
- ``IntExecutor(mesh=)`` at (2, 2) on ResNet-20 and MobileNet-v1 (at 64x64,
  the side ``tests/test_torch_mobilenet.py`` uses, as JAX's sharded forward
  at 224 takes about 50 s on the CPU): equal to the port's single-device engine
  on "xla" and "pallas", every rank holding true shards, and against JAX's
  sharded forward on the same mesh shape within JAX's bounds
  (``tests/test_int_engine_sharded.py:53,121``: 1e-4, exact). AlexNet is
  ``tests/test_torch_distributed_alexnet.py``.
- Two-rank ``serve_multihost`` at (1, 2), the JAX test's unequal loads (4
  and 3 requests) and its idle-heartbeat wave
  (``tests/test_multiprocess_distributed.py`` ``_CHILD_SERVE``): every
  answer equal to the single-device engine, the second wave under 8 s;
  then rank 1 is killed (``_CHILD_KILL``) and rank 0's requests fail within
  its 6 s peer timeout.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
from flax import nnx
from jax.sharding import NamedSharding, PartitionSpec as P

from quantized_tpu.engine import build_int8_mobilenet as j_build_mobilenet
from quantized_tpu.engine import build_int8_resident as j_build_resident
from quantized_tpu.ops.int8_matmul import matmul_epilogue_params as j_epilogue_params
from quantized_tpu.parallel import DATA_AXIS as J_DATA_AXIS
from quantized_tpu.parallel import create_mesh as j_create_mesh
from quantized_tpu.parallel import shard_int_engine_state as j_shard_int_engine_state
from quantized_tpu.parallel.collectives import dp_psum_grads as j_dp_psum_grads
from quantized_tpu.parallel.collectives import tp_linear as j_tp_linear
from quantized_tpu.parallel.collectives import tp_linear_reduce_scatter as j_tp_linear_rs
from quantized_tpu.parallel.tp_engine import apply_explicit_tp as j_apply_explicit_tp
from quantized_tpu.parallel.tp_engine import tp_int8_conv as j_tp_int8_conv
from quantized_tpu_torch.entry import _calibrated_model
from torch_dist import Ranks
from torch_jax_twins import jax_model, load_flat_state

R20 = ("resnet_quantized_float_bn", {"dataset": "cifar10", "depth": 20})
MOBILENET = ("mobilenet_quantized", {})
MOBILENET_SIDE = 64
PEER_TIMEOUT_S = 6.0
IDLE_S = 5.0  # rank 0 stays idle, not stopped, this long in the second wave


def port_spec(name, cfg):
    """(name, config, state) of the port model the ranks build: seed 0,
    observers frozen at [-4, 4] (JAX's ``_calibrated``)."""
    model = _calibrated_model(name, device="cpu", generator=torch.Generator().manual_seed(0), **cfg)
    return (name, cfg, {k: v.numpy() for k, v in model.state_dict().items()})


def jax_twin(spec):
    name, cfg, state = spec
    return load_flat_state(jax_model(name, **cfg), state)


def jax_sharded_forward(engine, mesh, x):
    """JAX's engine with its state sharded by ``shard_int_engine_state`` and
    the batch over ``data`` (``tests/test_int_engine_sharded.py``)."""
    graphdef, state = nnx.split(engine)
    state = j_shard_int_engine_state(state, mesh)
    xs = jax.device_put(jnp.asarray(x), NamedSharding(mesh, P(J_DATA_AXIS, None, None, None)))
    return np.asarray(jax.jit(lambda s, v: nnx.merge(graphdef, s)(v))(state, xs))


def rank_results(ranks, expect_codes=None):
    results, codes, outs = ranks.results()
    for r, (res, out) in enumerate(zip(results, outs)):
        assert "error" not in res, f"rank {r}:\n{res.get('error')}\n{out[-2000:]}"
    assert codes == (expect_codes or [0] * len(codes)), (codes, [o[-2000:] for o in outs])
    return results


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    rng = np.random.default_rng(0)
    r20, mobilenet = port_spec(*R20), port_spec(*MOBILENET)
    lin = dict(x=rng.standard_normal((8, 16)).astype(np.float32), w=rng.standard_normal((12, 16)).astype(np.float32),
               b=rng.standard_normal(12).astype(np.float32), g=rng.standard_normal((3, 4)).astype(np.float32),
               delta=rng.standard_normal((3, 4)).astype(np.float32))
    cin, cout = 8, 32  # tests/test_tp_explicit.py's conv
    w_q = rng.integers(-127, 128, (3, 3, cin, cout)).astype(np.int8)
    x_q = rng.integers(-128, 128, (8, 8, 8, cin)).astype(np.int8)
    colsum = jnp.asarray(w_q.astype(np.int32).reshape(-1, cout).sum(0))
    alpha, beta = (np.asarray(a) for a in j_epilogue_params(0.03, 21, jnp.full((cout,), 0.01, jnp.float32), colsum))
    conv = dict(x_q=x_q, w_q=w_q, alpha=alpha, beta=beta, act_scale=0.03, zp=21, grid=(0.05, 100))
    x_r20 = rng.standard_normal((8, 32, 32, 3)).astype(np.float32)
    x_mob = rng.standard_normal((8, MOBILENET_SIDE, MOBILENET_SIDE, 3)).astype(np.float32)
    images = np.random.default_rng(11).standard_normal((8, 32, 32, 3)).astype(np.float32)
    four = Ranks(4, {"cases": [
        ("collectives", "collectives", dict(tp=2, **lin)),
        ("tp_conv", "tp_conv", dict(tp=4, **conv)),
        ("explicit_tp", "explicit_tp", dict(tp=4, model=r20, x=x_r20, backends=("xla", "pallas"))),
        ("executor", "executor", dict(tp=2, models={"r20": r20, "mobilenet": mobilenet},
                                      x={"r20": x_r20, "mobilenet": x_mob}, backends=("xla", "pallas"))),
    ]}, tmp_path_factory.mktemp("four"))
    two = Ranks(2, {"cases": [
        ("serve", "serve", dict(tp=2, model=r20, images=images, idle_s=IDLE_S)),
        ("kill", "kill", dict(tp=2, model=r20, peer_timeout_s=PEER_TIMEOUT_S, shape=(32, 32, 3))),
    ]}, tmp_path_factory.mktemp("two"))

    # the JAX references, while the ranks run
    mesh22 = j_create_mesh(num_devices=4, model_parallel=2)
    mesh14 = j_create_mesh(num_devices=4, model_parallel=4)
    jax_ref = {
        "tp_linear": np.asarray(j_tp_linear(mesh22, jnp.asarray(lin["x"]), jnp.asarray(lin["w"]),
                                            jnp.asarray(lin["b"]))),
        "tp_linear_rs": np.asarray(j_tp_linear_rs(mesh22, jnp.asarray(lin["x"]), jnp.asarray(lin["w"]))),
        "psum": np.asarray(j_dp_psum_grads(mesh22, {"w": jnp.asarray(lin["g"])})["w"]),
    }
    for form, req in (("f32", None), ("s8", conv["grid"])):
        jax_ref[("conv", form)] = np.asarray(j_tp_int8_conv(
            mesh14, jnp.asarray(x_q), jnp.asarray(w_q), jnp.asarray(alpha), jnp.asarray(beta), (1, 1), (1, 1),
            21 - 128, relu=True, out_requant=req))
    jeng = j_build_resident(jax_twin(r20))
    assert j_apply_explicit_tp(jeng, mesh14) == 7
    graphdef, state = nnx.split(jeng)
    jax_ref["explicit_tp"] = np.asarray(jax.jit(lambda s, v: nnx.merge(graphdef, s)(v))(state, jnp.asarray(x_r20)))
    jax_ref["r20"] = jax_sharded_forward(j_build_resident(jax_twin(r20)), mesh22, x_r20)
    jax_ref["mobilenet"] = jax_sharded_forward(j_build_mobilenet(jax_twin(mobilenet)), mesh22, x_mob)
    return {"four": rank_results(four), "two": rank_results(two, [0, -9]), "jax": jax_ref, "lin": lin}


def _rows(a, index, parts, axis=0):
    return np.array_split(a, parts, axis=axis)[index]


def test_tp_linear_matches_jax(world):
    for res in world["four"]:
        c = res["collectives"]
        dp, d, tp, m = c["coords"]
        np.testing.assert_allclose(c["tp_linear"], _rows(world["jax"]["tp_linear"], d, dp), rtol=1e-5, atol=1e-5)
        assert c["counts"] == {"all_gather": {"model": 1}, "reduce_scatter": {"model": 1}}, c["counts"]


def test_tp_linear_reduce_scatter_matches_jax(world):
    for res in world["four"]:
        c = res["collectives"]
        dp, d, tp, m = c["coords"]
        want = _rows(_rows(world["jax"]["tp_linear_rs"], d, dp), m, tp, axis=1)
        np.testing.assert_allclose(c["tp_linear_rs"], want, rtol=1e-5, atol=1e-4)


def test_heartbeat_barrier_and_local_batch_slice(world):
    """Every rank passed the watchdogged barrier (a rank that had not would
    have exited 42); each holds its quarter of a batch of 8."""
    for res in world["four"]:
        c = res["collectives"]
        assert c["batch_slice"] == slice(2 * c["rank"], 2 * c["rank"] + 2)


def test_dp_psum_grads(world):
    """Replicated gradients stay themselves (JAX's ``pmean`` of a replicated
    tree); gradients that differ by data row average over it."""
    lin = world["lin"]
    for res in world["four"]:
        c = res["collectives"]
        np.testing.assert_allclose(c["psum_same"], world["jax"]["psum"], rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(c["psum_mean"]["w"], lin["g"] + 0.5 * lin["delta"], rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(c["psum_mean"]["b"][0], lin["g"][0] + 0.5, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("backend", ["xla", "pallas"])
@pytest.mark.parametrize("form", ["f32", "s8"])
def test_tp_int8_conv(world, backend, form):
    want = world["jax"][("conv", form)]
    for res in world["four"]:
        c = res["tp_conv"][(backend, form)]
        np.testing.assert_array_equal(c["tp"], c["whole"])
        assert c["counts"] == {"all_gather": {"model": 1}}, c["counts"]
        assert c["local_cout"] == 8
        if form == "f32":
            np.testing.assert_allclose(c["tp"], want, rtol=1e-5, atol=1e-5)
        elif backend == "xla":
            np.testing.assert_array_equal(c["tp"], want)
        else:
            assert np.abs(c["tp"].astype(np.int32) - want.astype(np.int32)).max() <= 1


@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_apply_explicit_tp_cifar20(world, backend):
    for res in world["four"]:
        c = res["explicit_tp"][backend]
        assert c["wrapped"] == 7
        np.testing.assert_array_equal(c["tp"], c["single"])
        assert c["counts"] == {"all_gather": {"model": 8}, "reduce_scatter": {"model": 1}}, c["counts"]
        if backend == "xla":
            np.testing.assert_allclose(c["tp"], world["jax"]["explicit_tp"], rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("backend", ["xla", "pallas"])
@pytest.mark.parametrize("model", ["r20", "mobilenet"])
def test_int_executor_over_a_mesh(world, model, backend):
    for rank, res in enumerate(world["four"]):
        c = res["executor"][(model, backend)]
        np.testing.assert_array_equal(c["mesh"], c["single"])
        assert any(local < full for local, full in c["sharded"].values()), (rank, c["sharded"])
        assert all(2 * local == full for local, full in c["sharded"].values()), c["sharded"]
        assert c["counts"] == {"all_gather": {"model": len(c["sharded"]) + c["dense"], "data": 1}}, c["counts"]
        if backend == "xla":
            want = world["jax"][model]
            if model == "mobilenet":
                np.testing.assert_array_equal(c["mesh"], want)
            else:
                np.testing.assert_allclose(c["mesh"], want, rtol=1e-5, atol=1e-4)


def test_serve_multihost_two_ranks(world):
    """Unequal loads agree on a padded bucket; every answer equals the
    single-device engine; rank 1's second-wave request completes while rank
    0 idles (the heartbeat drain), well inside 8 s."""
    served = [res["serve"] for res in world["two"]]
    for rank, s in enumerate(served):
        mine = range(4) if rank == 0 else range(4, 8)
        assert sorted(s["got"]) == list(mine)
        for i in mine:
            np.testing.assert_array_equal(s["got"][i], s["ref"][i])
        assert s["stats"]["requests"] == 4, s["stats"]
    assert served[1]["wave2_s"] < 8.0, served[1]["wave2_s"]


def test_host_death_survivor_fails_fast(world):
    """Rank 1 SIGKILLs itself after a served wave (its exit code is -9, as
    the fixture checks); rank 0's two requests fail (or are refused) within
    the peer timeout, and its batcher refuses further submits."""
    k = world["two"][0]["kill"]
    assert k["shapes"] == [(10,), (10,)]
    assert k["failures"] == 2
    assert k["window_s"] < PEER_TIMEOUT_S + 20, k
    assert k["refused"]
