"""Serving front end: the continuous-batching loop and an optional HTTP
endpoint (counterpart of ``quantized_tpu/engine/server.py``, one device).

The batcher feeds an :class:`~quantized_tpu_torch.engine.executor.IntExecutor`
that replays one CUDA graph per batch bucket (``graphs=False`` runs the
forward eagerly). Over a mesh (``mesh=``, ``parallel.create_mesh``) every
rank runs its own admission queue and batcher, and the ranks agree on each
step: ``engine.multihost``'s batcher over the rank-sharded executor, with
the weights sharded over the mesh's ``model`` axis and each rank's batches
its rows of the ``data`` axis (``parallel.distributed`` joins the
processes).

The HTTP endpoint (standard library only) accepts POST /predict with a raw
image body (its shape in the X-Shape header, ``X-Dtype: u8`` for uint8,
else float32) and returns the top-5 classes and logits as JSON; GET /stats
returns the scheduler's metrics (``ContinuousBatcher.stats()``: latency and
queue-wait percentiles, occupancy, per-stage host time). The handler
threads only submit to the batcher and wait on futures; they never touch
CUDA.
"""

from __future__ import annotations

import json
import logging
import threading
import time
from typing import Optional, Sequence

import numpy as np

logger = logging.getLogger(__name__)


def make_executor(model, mesh=None, ingest: str = "f32", device="cuda", graphs: bool = True,
                  pipeline_depth: int = 1, check_finite: bool = False):
    """The executor of ``serve``: on ``device`` (the card unless the caller
    asks for the CPU; with a mesh, this rank's device of it), one CUDA
    graph per bucket unless ``graphs=False``, and ``pipeline_depth + 3``
    pinned slots per bucket: the batches in flight, the two queued for
    dispatch and the one being assembled."""
    from quantized_tpu_torch.engine.executor import IntExecutor

    return IntExecutor(model, mesh=mesh, ingest=ingest, device=device, graphs=graphs, slots=pipeline_depth + 3,
                       check_finite=check_finite)


def serve(
    model,
    mesh=None,
    batch_sizes: Sequence[int] = (1, 8, 32),
    input_shape=None,
    max_steps: int = 0,
    http_port: Optional[int] = None,
    demo_traffic: bool = True,
    ingest: str = "f32",
    pipeline_depth: int = 1,
    request_timeout_s=None,
    device="cuda",
    graphs: bool = True,
    check_finite: bool = False,
):
    """Bring up the batcher (+ optional HTTP endpoint); with ``demo_traffic``
    generates synthetic request load and logs latency/throughput stats every
    second. ``ingest='u8'`` serves raw uint8 images through the engine's
    fused normalize+quantize path (a quarter of the f32 request payload and
    input traffic). ``pipeline_depth>1`` keeps batches in flight with
    dispatch-time result copies; depth 1 minimizes latency for sparse
    traffic. ``device``, ``graphs`` and ``check_finite`` go to
    :func:`make_executor`. With ``mesh`` every rank of it calls ``serve``
    alike and serves its own traffic through ``engine.multihost``'s batcher
    (pipeline depth 1). Returns 0 on clean shutdown."""
    from quantized_tpu_torch.engine.batching import ContinuousBatcher

    if input_shape is None:
        size = getattr(model, "input_size", 224)
        input_shape = (size, size, 3)
    dtype = np.uint8 if ingest == "u8" else np.float32
    if mesh is not None:
        from quantized_tpu_torch.engine.multihost import serve_multihost

        if pipeline_depth != 1:
            raise ValueError("serving over a mesh runs the multi-host batcher, at pipeline depth 1")
        batcher = serve_multihost(model, mesh, batch_sizes, input_shape, ingest=ingest, graphs=graphs,
                                  request_timeout_s=request_timeout_s, check_finite=check_finite)
    else:
        ex = make_executor(model, ingest=ingest, device=device, graphs=graphs, pipeline_depth=pipeline_depth,
                           check_finite=check_finite)
        batcher = ContinuousBatcher(ex, input_shape, batch_sizes, dtype=dtype,
                                    pipeline_depth=pipeline_depth,
                                    request_timeout_s=request_timeout_s).warmup().start()
    logger.info("server up: buckets=%s input=%s", tuple(batch_sizes), input_shape)

    httpd = None
    if http_port is not None:
        httpd = _start_http(batcher, http_port)

    try:
        if demo_traffic:
            rng = np.random.default_rng(0)
            step = 0
            last_log = time.time()
            pending = []
            while max_steps == 0 or step < max_steps:
                burst = int(rng.integers(1, max(batch_sizes) + 1))
                for _ in range(burst):
                    if ingest == "u8":
                        img = rng.integers(0, 256, size=input_shape, dtype=np.uint8)
                    else:
                        img = rng.standard_normal(input_shape).astype(np.float32)
                    pending.append(batcher.submit(img))
                step += 1
                if len(pending) > 4 * max(batch_sizes):
                    for f in pending:
                        try:
                            f.result(timeout=120)
                        except TimeoutError:
                            # Only an SLA-expired request (future resolved with
                            # the batcher's stored TimeoutError) is expected
                            # here; a future still PENDING after 120s means the
                            # scheduler is wedged — surface that, don't skip it.
                            if not f.done():
                                raise
                    pending.clear()
                if time.time() - last_log > 1.0:
                    logger.info("serve stats: %s", batcher.stats())
                    last_log = time.time()
            for f in pending:
                try:
                    f.result(timeout=120)
                except TimeoutError:
                    if not f.done():
                        raise  # pending after 120s = wedged scheduler, not SLA
            logger.info("final serve stats: %s", batcher.stats())
        else:
            while max_steps == 0 or batcher.steps < max_steps:
                time.sleep(0.2)
    finally:
        batcher.stop()
        if httpd is not None:
            httpd.shutdown()
    return 0


def _start_http(batcher, port: int):
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet
            pass

        def do_GET(self):
            if self.path == "/stats":
                body = json.dumps(batcher.stats()).encode()
                self.send_response(200)
                self.send_header("Content-Type", "application/json")
                self.end_headers()
                self.wfile.write(body)
            else:
                self.send_response(404)
                self.end_headers()

        def do_POST(self):
            if self.path != "/predict":
                self.send_response(404)
                self.end_headers()
                return
            try:
                shape = tuple(int(s) for s in self.headers["X-Shape"].split(","))
                n = int(self.headers["Content-Length"])
                dt = np.uint8 if self.headers.get("X-Dtype") == "u8" else np.float32
                img = np.frombuffer(self.rfile.read(n), dt).reshape(shape)
                logits = batcher.submit(img).result(timeout=120)
                top = np.argsort(-logits)[:5]
                body = json.dumps(
                    {"top5": [int(i) for i in top], "logits": [float(logits[i]) for i in top]}
                ).encode()
                self.send_response(200)
                self.send_header("Content-Type", "application/json")
                self.end_headers()
                self.wfile.write(body)
            except Exception as e:  # noqa: BLE001 - a bad request is answered 400 and the server goes on
                self.send_response(400)
                self.end_headers()
                self.wfile.write(str(e).encode())

    httpd = ThreadingHTTPServer(("127.0.0.1", port), Handler)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    logger.info("http endpoint on :%d (/predict, /stats)", port)
    return httpd
