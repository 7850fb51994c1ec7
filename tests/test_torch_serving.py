"""The port's batcher, server and executor on the CPU.

The scenarios of the JAX package's serving tests
(``tests/test_training_serving.py``: shedding under overload, straggler
futures on ``stop``, buckets and padding, burst and lull under pipelining,
per-batch executor failure, the SLA timeout, client cancel, the HTTP
``/predict`` and ``/stats`` endpoint on an ephemeral port, a bad shape) and
``tests/test_request_replay.py`` (journal, replay, truncated tail), run on
the port's ``ContinuousBatcher`` with the same executors and the same
bounds; then the port's own dispatch path (a handle whose ``wait`` fails
fails that batch only) and ``IntExecutor`` on the CPU; then one parity case:
the same seeded request stream through JAX's batcher with JAX's resident
CIFAR ResNet-20 ("xla", its default) and through the port's with the port's
("pallas", the kernels' plain versions; weights carried by
``load_jax_arrays``), per-request logits within LOGIT_ATOL, the bound of
``tests/test_torch_resident.py`` (the "pallas" requant rounds after the f32
epilogue, XLA folds 1/s into alpha and beta first: 1-step differences that
compound through an untrained net).
"""

import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quantized_tpu.engine import int8_resident as jres
from quantized_tpu.engine.batching import ContinuousBatcher as JContinuousBatcher
from quantized_tpu.engine.executor import IntExecutor as JIntExecutor
from quantized_tpu_torch.engine import int8_resident as tres
from quantized_tpu_torch.engine.batching import ContinuousBatcher, RequestLog, replay_request_log
from quantized_tpu_torch.engine.executor import HostResult, IntExecutor
from quantized_tpu_torch.ingest import load_jax_arrays
from quantized_tpu_torch.models import get_model
from torch_jax_twins import flat_state, jax_model

LOGIT_ATOL = 0.25


def test_overload_shedding_invariant():
    """Open-loop overload with request_timeout_s set (VERDICT r4 missing #2):
    when requests arrive faster than a slow executor can serve, the batcher
    must shed expired requests with TimeoutError at drain time while the
    in-flight work keeps completing — every submitted future RESOLVES
    (result or TimeoutError, completed + shed == submitted), goodput stays
    nonzero, and the queue drains instead of growing without bound."""
    import time as _t

    from quantized_tpu_torch.engine.batching import ContinuousBatcher

    def slow_ex(batch):  # ~25 req/s capacity at bucket 4
        _t.sleep(0.15)
        return batch.reshape(batch.shape[0], -1)

    b = ContinuousBatcher(slow_ex, (2, 2, 1), batch_sizes=(4,), max_wait_ms=1,
                          request_timeout_s=0.3).start()
    img = np.zeros((2, 2, 1), np.float32)
    futs = [b.submit(img) for _ in range(120)]  # ~4.5s of work, SLA 0.3s
    ok = shed = 0
    for f in futs:
        try:
            f.result(timeout=30)
            ok += 1
        except TimeoutError:
            shed += 1
    assert ok + shed == 120
    assert ok >= 8, ok        # goodput held (in-flight batches complete)
    assert shed >= 50, shed   # the backlog was shed, not served late
    st = b.stats()
    assert st["timed_out"] == shed
    # served requests' latency stays bounded near the deadline + one batch
    assert st["latency_p99_ms"] <= (0.3 + 2 * 0.15) * 1e3 + 50, st
    b.stop()


def test_batcher_stop_fails_straggler_futures():
    """A submit() that wins the race past the _stop check can enqueue after
    the scheduler's final queue drain; stop() must fail those futures with
    RuntimeError instead of leaving the client blocked forever (ADVICE r4).
    Deterministic form: enqueue with no scheduler thread running at all."""
    from quantized_tpu_torch.engine.batching import ContinuousBatcher

    b = ContinuousBatcher(lambda batch: batch.reshape(batch.shape[0], -1), (2, 2, 3),
                          batch_sizes=(4,))
    fut = b.submit(np.zeros((2, 2, 3), np.float32))  # no start(): stays queued
    b.stop()
    with pytest.raises(RuntimeError):
        fut.result(timeout=5)


def _linear_executor(weight):
    def ex(batch):
        flat = batch.reshape(batch.shape[0], -1)
        return flat @ weight

    return ex


def test_continuous_batcher_correct_and_padded():
    from quantized_tpu_torch.engine.batching import ContinuousBatcher

    rng = np.random.default_rng(0)
    w = rng.standard_normal((4 * 4 * 3, 7)).astype(np.float32)
    b = ContinuousBatcher(_linear_executor(w), (4, 4, 3), batch_sizes=(1, 4, 16), max_wait_ms=5)
    b.start()
    imgs = rng.standard_normal((23, 4, 4, 3)).astype(np.float32)
    futs = [b.submit(im) for im in imgs]
    outs = np.stack([f.result(timeout=30) for f in futs])
    b.stop()
    want = imgs.reshape(23, -1) @ w
    np.testing.assert_allclose(outs, want, rtol=1e-5, atol=1e-5)
    s = b.stats()
    assert s["requests"] == 23
    assert s["batches"] >= 2  # 23 requests cannot fit one 16-bucket
    assert 0 < s["occupancy"] <= 1.0
    assert s["latency_p50_ms"] > 0
    # per-stage host-cost accounting (round 5): every stage accumulated
    for k in ("drain", "assemble", "dispatch", "resolve"):
        assert s[f"stage_{k}_ms"] >= 0, s


def test_pipelined_batcher_correct_under_burst_and_lull():
    """pipeline_depth>1 (round 4): results stay per-request correct when
    batches are resolved out of the dispatch loop, a traffic lull flushes
    the in-flight queue (no stranded futures), and a slow executor's
    latency is overlapped (dispatch k+1 happens before k's resolve)."""
    import time

    from quantized_tpu_torch.engine.batching import ContinuousBatcher

    rng = np.random.default_rng(1)
    w = rng.standard_normal((4 * 4 * 3, 7)).astype(np.float32)

    calls = []

    class SlowDeviceish:
        """Mimics async dispatch: returns a lazy handle; materialization
        (np.asarray at resolve) pays the latency."""

        def __init__(self, batch):
            self.batch = batch
            self.t = time.perf_counter()

        def __array__(self, dtype=None, copy=None):
            dt = 0.05 - (time.perf_counter() - self.t)
            if dt > 0:
                time.sleep(dt)  # "device still executing"
            out = self.batch.reshape(self.batch.shape[0], -1) @ w
            return out if dtype is None else out.astype(dtype)

    def ex(batch):
        calls.append(time.perf_counter())
        return SlowDeviceish(batch.copy())

    b = ContinuousBatcher(ex, (4, 4, 3), batch_sizes=(4,), max_wait_ms=2,
                          pipeline_depth=3).start()
    imgs = rng.standard_normal((24, 4, 4, 3)).astype(np.float32)
    futs = [b.submit(im) for im in imgs]
    outs = np.stack([f.result(timeout=30) for f in futs])
    np.testing.assert_allclose(outs, imgs.reshape(24, -1) @ w, rtol=1e-5, atol=1e-5)
    # lull: everything resolved without stop() — no stranded futures
    assert all(f.done() for f in futs)
    # overlap: 6 batches of 50 ms serial would take >=300 ms; the pipeline
    # must have dispatched successive batches before resolving older ones
    gaps = np.diff(calls)
    assert len(calls) >= 6 and (gaps < 0.05).any(), gaps
    # burst 2 after the lull: loop still live, results correct
    futs2 = [b.submit(im) for im in imgs[:5]]
    outs2 = np.stack([f.result(timeout=30) for f in futs2])
    np.testing.assert_allclose(outs2, imgs[:5].reshape(5, -1) @ w, rtol=1e-5, atol=1e-5)
    b.stop()
    assert b.stats()["requests"] == 29


def test_pipelined_batcher_executor_failure_is_per_batch():
    """Depth>1 dispatcher: an executor exception fails exactly that batch's
    futures; earlier and later batches still serve correctly."""
    from quantized_tpu_torch.engine.batching import ContinuousBatcher

    rng = np.random.default_rng(3)
    w = rng.standard_normal((4 * 4 * 3, 7)).astype(np.float32)
    calls = [0]

    def flaky(batch):
        calls[0] += 1
        if calls[0] == 2:
            raise RuntimeError("injected device fault")
        return batch.reshape(batch.shape[0], -1) @ w

    b = ContinuousBatcher(flaky, (4, 4, 3), batch_sizes=(4,), max_wait_ms=2,
                          pipeline_depth=3).start()
    imgs = rng.standard_normal((12, 4, 4, 3)).astype(np.float32)
    futs = [b.submit(im) for im in imgs]
    results = [f.exception(timeout=30) or f.result() for f in futs]
    b.stop()
    failed = [i for i, r in enumerate(results) if isinstance(r, RuntimeError)]
    served = [i for i, r in enumerate(results) if not isinstance(r, RuntimeError)]
    assert len(failed) == 4 and failed == list(range(failed[0], failed[0] + 4))
    for i in served:
        np.testing.assert_allclose(results[i], imgs[i].reshape(-1) @ w, rtol=1e-5, atol=1e-5)
    assert b.stats()["requests"] == 8  # the failed batch never resolves as done


def test_batcher_request_timeout_sla():
    """request_timeout_s (round 4): requests that outlive their deadline in
    the queue fail fast with TimeoutError; fresh requests still serve, and
    the timed-out count lands in stats()."""
    import time as _t

    from quantized_tpu_torch.engine.batching import ContinuousBatcher

    rng = np.random.default_rng(2)
    w = rng.standard_normal((4 * 4 * 3, 7)).astype(np.float32)
    b = ContinuousBatcher(
        _linear_executor(w), (4, 4, 3), batch_sizes=(4,), max_wait_ms=2,
        request_timeout_s=0.05,
    )
    imgs = rng.standard_normal((6, 4, 4, 3)).astype(np.float32)
    # submit BEFORE start(): the requests age past the 50 ms deadline in queue
    futs_old = [b.submit(im) for im in imgs]
    _t.sleep(0.12)
    b.start()
    for f in futs_old:
        with pytest.raises(TimeoutError, match="request_timeout_s"):
            f.result(timeout=30)
    # fresh traffic is unaffected
    futs_new = [b.submit(im) for im in imgs]
    outs = np.stack([f.result(timeout=30) for f in futs_new])
    b.stop()
    np.testing.assert_allclose(outs, imgs.reshape(6, -1) @ w, rtol=1e-5, atol=1e-5)
    s = b.stats()
    assert s["timed_out"] == 6 and s["requests"] == 6


def test_batcher_survives_client_cancel_and_rejects_post_stop_submit():
    """A client cancelling its Future must not kill the scheduler thread
    (set_result on a cancelled Future raises InvalidStateError); and
    submit() after stop() raises instead of hanging forever."""
    from quantized_tpu_torch.engine.batching import ContinuousBatcher

    rng = np.random.default_rng(5)
    w = rng.standard_normal((4 * 4 * 3, 7)).astype(np.float32)
    b = ContinuousBatcher(_linear_executor(w), (4, 4, 3), batch_sizes=(4,),
                          max_wait_ms=2, pipeline_depth=2)
    imgs = rng.standard_normal((8, 4, 4, 3)).astype(np.float32)
    futs = [b.submit(im) for im in imgs]
    futs[2].cancel()  # queued, not started -> cancel() succeeds
    b.start()
    for i, f in enumerate(futs):
        if i == 2:
            continue
        np.testing.assert_allclose(f.result(timeout=30), imgs[i].reshape(-1) @ w,
                                   rtol=1e-5, atol=1e-5)
    # scheduler survived the cancelled future: fresh traffic still serves
    f2 = b.submit(imgs[0])
    np.testing.assert_allclose(f2.result(timeout=30), imgs[0].reshape(-1) @ w,
                               rtol=1e-5, atol=1e-5)
    b.stop()
    with pytest.raises(RuntimeError, match="stopped"):
        b.submit(imgs[0])


def test_http_endpoint_predict_and_stats():
    """The serving HTTP surface (/predict with raw bytes + X-Shape/X-Dtype
    headers, /stats JSON) against a live batcher."""
    import json
    import urllib.request

    from quantized_tpu_torch.engine.batching import ContinuousBatcher
    from quantized_tpu_torch.engine.server import _start_http

    rng = np.random.default_rng(4)
    w = rng.standard_normal((4 * 4 * 3, 7)).astype(np.float32)
    b = ContinuousBatcher(_linear_executor(w), (4, 4, 3), batch_sizes=(4,), max_wait_ms=2).start()
    httpd = _start_http(b, 0)  # ephemeral port
    port = httpd.server_address[1]
    try:
        img = rng.standard_normal((4, 4, 3)).astype(np.float32)
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/predict", data=img.tobytes(),
            headers={"X-Shape": "4,4,3", "X-Dtype": "f32"}, method="POST")
        resp = json.loads(urllib.request.urlopen(req, timeout=30).read())
        want = img.reshape(-1) @ w
        assert resp["top5"][0] == int(np.argmax(want))
        np.testing.assert_allclose(resp["logits"][0], want.max(), rtol=1e-5)
        stats = json.loads(urllib.request.urlopen(
            f"http://127.0.0.1:{port}/stats", timeout=30).read())
        assert stats["requests"] == 1 and stats["timed_out"] == 0
    finally:
        httpd.shutdown()
        b.stop()


def test_batcher_rejects_bad_shape():
    from quantized_tpu_torch.engine.batching import ContinuousBatcher

    b = ContinuousBatcher(lambda x: x, (4, 4, 3))
    with pytest.raises(ValueError, match="expected image shape"):
        b.submit(np.zeros((5, 5, 3), np.float32))


def _replay_executor(batch):
    # deterministic per-row function: replay must reproduce it exactly
    return batch.reshape(batch.shape[0], -1) @ np.linspace(
        -1, 1, batch[0].size, dtype=np.float32
    ).reshape(-1, 1)


def test_journal_and_replay_reproduce_outputs(rng, tmp_path):
    log = str(tmp_path / "requests")
    shape = (8, 8, 3)
    b1 = ContinuousBatcher(_replay_executor, shape, batch_sizes=(4,), request_log=log).start()
    images = [rng.standard_normal(shape).astype(np.float32) for _ in range(10)]
    originals = [b1.submit(im).result(timeout=10) for im in images]
    b1.stop()  # "crash": the server goes away; the journal survives on disk

    b2 = ContinuousBatcher(_replay_executor, shape, batch_sizes=(4,)).start()
    futures = replay_request_log(log, b2)
    assert sorted(futures) == list(range(1, 11))
    for rid, fut in sorted(futures.items()):
        np.testing.assert_array_equal(fut.result(timeout=10), originals[rid - 1])
    b2.stop()


def test_journal_tolerates_truncated_tail(rng, tmp_path):
    log = str(tmp_path / "requests")
    shape = (4, 4, 1)
    rl = RequestLog(log)
    imgs = [rng.standard_normal(shape).astype(np.float32) for _ in range(3)]
    for i, im in enumerate(imgs, 1):
        rl.append(i, im)
    rl.close()
    with open(log + ".bin", "r+b") as f:  # a crash mid-append
        f.truncate(f.seek(0, 2) - 10)
    entries = list(RequestLog.read(log))
    assert [rid for rid, _ in entries] == [1, 2]
    for (_, got), want in zip(entries, imgs):
        np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------- the port's dispatch path


class _Handle:
    """What an executor's ``dispatch`` returns: ``wait`` gives the logits,
    or raises the batch's device error."""

    def __init__(self, value, error=None):
        self.value, self.error, self.waited = value, error, 0

    def wait(self):
        self.waited += 1
        if self.error is not None:
            raise self.error
        return self.value


@pytest.mark.parametrize("depth", [1, 3])
def test_dispatch_handles_fail_only_their_batch(depth):
    """An executor with ``dispatch``: the batcher calls it (not ``__call__``),
    resolves through each handle's ``wait`` and nothing else, and an error
    surfacing at one batch's wait (a device fault) fails that batch alone."""
    rng = np.random.default_rng(6)
    w = rng.standard_normal((4 * 4 * 3, 7)).astype(np.float32)
    handles = []

    class Ex:
        def __call__(self, batch):
            raise AssertionError("the batcher must use dispatch")

        def dispatch(self, batch):
            err = RuntimeError("injected device fault") if len(handles) == 1 else None
            handles.append(_Handle(batch.reshape(batch.shape[0], -1) @ w, err))
            return handles[-1]

    b = ContinuousBatcher(Ex(), (4, 4, 3), batch_sizes=(4,), max_wait_ms=2, pipeline_depth=depth)
    imgs = rng.standard_normal((12, 4, 4, 3)).astype(np.float32)
    futs = [b.submit(im) for im in imgs]  # queued before start: three full batches of 4
    b.start()
    results = [f.exception(timeout=30) or f.result() for f in futs]
    b.stop()
    assert [isinstance(r, RuntimeError) for r in results] == [False] * 4 + [True] * 4 + [False] * 4
    for i in (*range(4), *range(8, 12)):
        np.testing.assert_allclose(results[i], imgs[i].reshape(-1) @ w, rtol=1e-5, atol=1e-5)
    assert [h.waited for h in handles] == [1, 1, 1]
    assert b.stats()["requests"] == 8


def test_executor_on_the_cpu_dispatch_and_call_agree():
    """``IntExecutor`` on the CPU: ``dispatch`` returns a HostResult whose
    ``wait`` (and ``np.asarray``) gives the eager forward's logits, equal
    to ``__call__``'s; a CPU executor captures no graph and pins nothing."""
    model = get_model("resnet_quantized_float_bn")(dataset="cifar10", depth=20,
                                                   generator=torch.Generator().manual_seed(0))
    eng = tres.build_int8_resident(model.eval(), device="cpu")
    ex = IntExecutor(eng, ingest="u8", device="cpu")
    u8 = np.random.default_rng(2).integers(0, 256, (4, 32, 32, 3), dtype=np.uint8)
    res = ex.dispatch(u8)
    assert isinstance(res, HostResult)
    got = res.wait()
    np.testing.assert_array_equal(np.asarray(res), got)
    np.testing.assert_array_equal(got, ex(u8).numpy())
    with torch.inference_mode():
        np.testing.assert_array_equal(got, eng.run_u8(torch.from_numpy(u8)).numpy())
    assert ex.graph_stats() == {} and ex.pinned_bytes() == 0
    with pytest.raises(ValueError, match="uint8 ingest"):
        IntExecutor(torch.nn.Linear(2, 2), ingest="u8", device="cpu")


def test_executor_check_finite_raises():
    class NaNModel(torch.nn.Module):
        def forward(self, x):
            return x.reshape(x.shape[0], -1) * float("nan")

    ex = IntExecutor(NaNModel(), device="cpu", check_finite=True)
    with pytest.raises(FloatingPointError):
        ex(np.zeros((2, 4), np.float32))
    with pytest.raises(FloatingPointError):
        ex.dispatch(np.zeros((2, 4), np.float32))


def test_serve_with_demo_traffic_returns_zero():
    """``serve`` on the CPU (u8 ingest, depth 2): warmed buckets, demo
    bursts, a clean shutdown."""
    from quantized_tpu_torch.engine.server import serve

    model = get_model("resnet_quantized_float_bn")(dataset="cifar10", depth=20,
                                                   generator=torch.Generator().manual_seed(0))
    eng = tres.build_int8_resident(model.eval(), device="cpu")
    assert serve(eng, batch_sizes=(1, 4), max_steps=3, ingest="u8", pipeline_depth=2, device="cpu") == 0
    with pytest.raises(TypeError, match="DeviceMesh"):  # a mesh is parallel.create_mesh's
        serve(eng, mesh=object(), max_steps=1, device="cpu")


def test_entry_points_default_to_the_card():
    """A model built on the host and handed to ``serve``, ``make_executor``
    or ``Trainer`` with no ``device`` runs on the card, or refuses where
    there is none: never quietly on the CPU."""
    from quantized_tpu_torch.engine.server import make_executor, serve
    from quantized_tpu_torch.training.qat import Trainer

    model = get_model("resnet_quantized_float_bn")(dataset="cifar10", depth=20,
                                                   generator=torch.Generator().manual_seed(0))
    eng = tres.build_int8_resident(model.eval(), device="cpu")
    if torch.cuda.is_available():
        assert make_executor(eng, ingest="u8").device.type == "cuda"
        assert Trainer(eng).device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        serve(eng, batch_sizes=(1,), max_steps=1, ingest="u8")
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        make_executor(eng, ingest="u8")
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        Trainer(eng)
    assert make_executor(eng, ingest="u8", device="cpu").device.type == "cpu"


@pytest.mark.parametrize("depth", [1, 3])
def test_batches_are_assembled_in_the_lent_slot(depth):
    """An executor that lends its input slots (``input_slot``): the batcher
    assembles each batch in the lent array, zeroes its padded tail (rows of
    an earlier batch stay out), dispatches that very array and answers each
    request with its own row; an executor that lends nothing gets a fresh
    zeroed batch."""
    rng = np.random.default_rng(5)
    w = rng.standard_normal((4 * 4 * 3, 3)).astype(np.float32)

    class Lending:
        def __init__(self):
            self.slots = [np.full((8, 4, 4, 3), np.nan, np.float32) for _ in range(depth + 3)]
            self.turn, self.lent, self.seen = 0, [], []

        def input_slot(self, shape, dtype):
            if shape != (8, 4, 4, 3):
                return None
            slot = self.slots[self.turn % len(self.slots)]
            self.turn += 1
            self.lent.append(slot)
            return slot

        def dispatch(self, batch):
            assert any(batch is s for s in self.lent) or batch.shape[0] == 1
            self.seen.append(batch.copy())
            return batch.reshape(batch.shape[0], -1) @ w

        def __call__(self, batch):
            return batch.reshape(batch.shape[0], -1) @ w

    ex = Lending()
    b = ContinuousBatcher(ex, (4, 4, 3), batch_sizes=(1, 8), max_wait_ms=2, pipeline_depth=depth).warmup()
    imgs = rng.standard_normal((21, 4, 4, 3)).astype(np.float32)
    futs = [b.submit(im) for im in imgs]  # queued before start: batches of 8, 8 and 5
    b.start()
    got = np.stack([f.result(timeout=30) for f in futs])
    b.stop()
    np.testing.assert_allclose(got, imgs.reshape(len(imgs), -1) @ w, rtol=1e-5, atol=1e-5)
    assert len(ex.lent) == 3 and [len(s) for s in ex.seen] == [8, 8, 8]
    np.testing.assert_array_equal(ex.seen[2][5:], 0)  # the padded tail, zeroed over the NaN rows


# ---------------------------------------------------------------- parity with the JAX batcher


def test_request_stream_matches_the_jax_batcher():
    """One seeded stream of 20 uint8 requests through each package's
    batcher and resident CIFAR ResNet-20 (buckets 1, 4 and 8; the port at
    pipeline depth 2): per-request logits within LOGIT_ATOL, the argmax
    equal wherever the top two logits are further apart than twice it."""
    jm = jax_model("resnet_quantized_float_bn", dataset="cifar10", depth=20)
    tm = get_model("resnet_quantized_float_bn")(dataset="cifar10", depth=20)
    load_jax_arrays(tm, flat_state(jm))
    jeng = jres.build_int8_resident(jm)
    teng = tres.build_int8_resident(tm.eval(), device="cpu")
    jex = JIntExecutor(jeng, ingest="u8")
    rng = np.random.default_rng(11)
    imgs = rng.integers(0, 256, (20, 32, 32, 3), dtype=np.uint8)

    def run(batcher):
        batcher.warmup().start()
        futs = [batcher.submit(im) for im in imgs]
        out = np.stack([f.result(timeout=120) for f in futs])
        batcher.stop()
        return out, batcher.stats()

    want, jstats = run(JContinuousBatcher(lambda b: np.asarray(jex(jnp.asarray(b))), (32, 32, 3),
                                          batch_sizes=(1, 4, 8), dtype=np.uint8))
    got, tstats = run(ContinuousBatcher(IntExecutor(teng, ingest="u8", device="cpu"), (32, 32, 3),
                                        batch_sizes=(1, 4, 8), dtype=np.uint8, pipeline_depth=2))
    assert jstats["requests"] == tstats["requests"] == 20
    np.testing.assert_allclose(got, want, atol=LOGIT_ATOL, rtol=0)
    top2 = np.sort(want, axis=-1)[:, -2:]
    clear = top2[:, 1] - top2[:, 0] > 2 * LOGIT_ATOL
    np.testing.assert_array_equal(got.argmax(-1)[clear], want.argmax(-1)[clear])
