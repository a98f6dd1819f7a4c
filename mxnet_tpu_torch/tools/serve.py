"""Model server of the PyTorch port: continuous batching over a TCP
JSON-lines API (counterpart of the repo's ``tools/serve.py``).

Loads a predictor bundle (``predict.export_bundle`` of either package) or
a resilience checkpoint directory of either package (MANIFEST/CRC
verified, f32 masters under AMP) with its symbol JSON, and serves it through ``serving.ServingEngine``: requests coalesce into
the smallest covering batch bucket, dispatch through the executor pool
(on the card one CUDA-graph replay a batch, every bucket captured before
the first request), and scatter back per request. SIGTERM/SIGINT drain
gracefully — in-flight requests finish, new work is rejected, exit 0.

Protocol: one JSON object per line on a TCP connection::

    -> {"inputs": {"data": [[...]]}}          # per-example, no batch axis
    <- {"outputs": [[...], ...], "latency_ms": 1.2}
    <- {"error": "..."}                        # on failure / while draining

Usage::

    python -m mxnet_tpu_torch.tools.serve --bundle model.pred --input data=1x28x28
    python -m mxnet_tpu_torch.tools.serve --bundle model.pred --input data=1x28x28 --cpu
    python -m mxnet_tpu_torch.tools.serve --checkpoint runs/exp1/ckpts/ckpt-000000000100 \
        --symbol model.json --input data=1x28x28 --port 9000
    python -m mxnet_tpu_torch.tools.serve --self-test [--cpu]

The server runs on the card (``gpu(0)``) unless ``--cpu`` is given.
Knobs: ``--max-batch`` / MXTPU_SERVE_MAX_BATCH, ``--timeout-ms`` /
MXTPU_SERVE_BATCH_TIMEOUT_MS, MXTPU_SERVE_QUANT=int8,
MXTPU_SERVE_EXEC_CACHE, ``--metrics-port`` / MXTPU_METRICS_PORT (the
registry in Prometheus text at ``http://127.0.0.1:<port>/metrics`` and a
JSON liveness view at ``/healthz``; port 0 picks a free one, printed as
``metrics on 127.0.0.1:<port>``).
"""
from __future__ import annotations

import argparse
import json
import os
import signal
import socket
import socketserver
import sys
import threading
import time

import numpy as np


def _parse_input_specs(specs):
    """['data=1x28x28'] -> {'data': (1, 28, 28)} (per-example shapes)."""
    shapes = {}
    for spec in specs:
        if "=" not in spec:
            raise SystemExit("--input expects name=DxDxD, got %r" % spec)
        name, _, dims = spec.partition("=")
        shapes[name] = tuple(int(d) for d in dims.split("x") if d)
    if not shapes:
        raise SystemExit("at least one --input name=shape is required")
    return shapes


def _context(use_cpu):
    from mxnet_tpu_torch.context import cpu, gpu

    return cpu() if use_cpu else gpu(0)


def load_predictor(args, feature_shapes):
    from mxnet_tpu_torch import predict

    input_shapes = {n: (1,) + s for n, s in feature_shapes.items()}
    if args.bundle:
        return predict.load_bundle(args.bundle, input_shapes, ctx=_context(args.cpu))
    if args.checkpoint:
        if not args.symbol:
            raise SystemExit("--checkpoint needs --symbol <symbol.json>")
        with open(args.symbol) as f:
            symbol_json = f.read()
        params = predict.params_from_checkpoint(args.checkpoint)
        return predict.Predictor(symbol_json, params, input_shapes, ctx=_context(args.cpu))
    raise SystemExit("one of --bundle / --checkpoint is required")


class _Handler(socketserver.StreamRequestHandler):
    def handle(self):
        engine = self.server.engine
        from mxnet_tpu_torch.serving.engine import ServeClosed

        for line in self.rfile:
            line = line.strip()
            if not line:
                continue
            t0 = time.perf_counter()
            try:
                msg = json.loads(line.decode())
                feeds = {
                    name: np.asarray(value, np.float32)
                    for name, value in msg["inputs"].items()
                }
                outs = engine.submit(**feeds).result(
                    self.server.request_timeout)
                reply = {
                    "outputs": [o.tolist() for o in outs],
                    "latency_ms": (time.perf_counter() - t0) * 1e3,
                }
            except ServeClosed:
                reply = {"error": "draining"}
            except Exception as e:  # malformed request — keep the conn
                reply = {"error": "%s: %s" % (type(e).__name__, e)}
            self.wfile.write((json.dumps(reply) + "\n").encode())
            self.wfile.flush()


class ServeServer(socketserver.ThreadingTCPServer):
    allow_reuse_address = True
    daemon_threads = True

    def __init__(self, addr, engine, request_timeout=60.0):
        super().__init__(addr, _Handler)
        self.engine = engine
        self.request_timeout = request_timeout


def run_server(args):
    from mxnet_tpu_torch import telemetry
    from mxnet_tpu_torch.serving.engine import ServingEngine

    telemetry.enable(metrics_port=args.metrics_port)
    metrics = telemetry.fleet.maybe_start_metrics_server(args.metrics_port)
    if metrics is not None:
        print("metrics on %s:%d" % (metrics.addr, metrics.port), flush=True)
    feature_shapes = _parse_input_specs(args.input)
    predictor = load_predictor(args, feature_shapes)
    engine = ServingEngine(
        predictor, max_batch=args.max_batch,
        batch_timeout_ms=args.timeout_ms)
    engine.start()
    server = ServeServer((args.host, args.port), engine)
    port = server.server_address[1]
    print("serving on %s:%d (max_batch=%d, buckets=%s)"
          % (args.host, port, engine.max_batch, engine.batch_buckets),
          flush=True)

    def _graceful(signum, frame):
        # finish in-flight work, reject new, exit 0
        print("signal %d: draining..." % signum, flush=True)
        threading.Thread(target=_shutdown, daemon=True).start()

    def _shutdown():
        engine.drain()
        server.shutdown()

    signal.signal(signal.SIGTERM, _graceful)
    signal.signal(signal.SIGINT, _graceful)
    try:
        server.serve_forever(poll_interval=0.1)
    finally:
        server.server_close()
        engine.drain()
    print("drained, bye", flush=True)
    return 0


# ---------------------------------------------------------------------------
# self-test: toy LeNet bundle, 100 requests through real sockets
# ---------------------------------------------------------------------------

def _build_toy_bundle(path):
    """The JAX tool's toy LeNet bundle: the same symbol and weights, so the
    same bytes."""
    import mxnet_tpu_torch.ndarray as nd
    from mxnet_tpu_torch import predict
    from mxnet_tpu_torch.context import cpu
    from mxnet_tpu_torch.models import lenet

    sym = lenet.get_symbol(num_classes=10)
    rng = np.random.RandomState(0)
    arg_shapes, _, _ = sym.infer_shape(data=(1, 1, 28, 28))
    with cpu():
        arg_params = {
            n: nd.array((rng.randn(*s) * 0.1).astype(np.float32))
            for n, s in zip(sym.list_arguments(), arg_shapes)
            if n not in ("data", "softmax_label")
        }
    predict.export_bundle(path, sym, arg_params)
    return sym


def _self_test(use_cpu, metrics_port=None):
    import tempfile

    from mxnet_tpu_torch import predict, telemetry
    from mxnet_tpu_torch.serving.engine import ServeClosed, ServingEngine

    telemetry.enable(metrics_port=metrics_port)
    tmp = tempfile.mkdtemp(prefix="serve_selftest_")
    bundle = os.path.join(tmp, "lenet.pred")
    _build_toy_bundle(bundle)

    predictor = predict.load_bundle(bundle, {"data": (1, 1, 28, 28)},
                                    ctx=_context(use_cpu))
    engine = ServingEngine(predictor, max_batch=4, batch_timeout_ms=2.0)
    engine.start()
    server = ServeServer(("127.0.0.1", 0), engine)
    port = server.server_address[1]
    srv_thread = threading.Thread(target=server.serve_forever,
                                  kwargs={"poll_interval": 0.05},
                                  daemon=True)
    srv_thread.start()

    rng = np.random.RandomState(1)
    n_requests = 100
    n_clients = 4
    errors = []
    replies = []
    lock = threading.Lock()

    def client(k):
        try:
            with socket.create_connection(("127.0.0.1", port), 10) as s:
                f = s.makefile("rwb")
                for _ in range(n_requests // n_clients):
                    x = rng.randn(1, 28, 28).astype(np.float32)
                    f.write((json.dumps(
                        {"inputs": {"data": x.tolist()}}) + "\n").encode())
                    f.flush()
                    reply = json.loads(f.readline().decode())
                    assert "outputs" in reply, reply
                    assert len(reply["outputs"][0]) == 10
                    with lock:
                        replies.append(reply)
        except Exception as e:
            errors.append(e)

    threads = [threading.Thread(target=client, args=(k,))
               for k in range(n_clients)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    assert not errors, errors
    assert len(replies) == n_requests, len(replies)
    print("self-test: %d requests served over %d sockets"
          % (n_requests, n_clients))

    snap = telemetry.snapshot()
    for metric in ("serve.e2e_seconds", "serve.queue_wait_seconds",
                   "serve.queue_depth", "serve.batch_occupancy",
                   "serve.requests"):
        assert metric in snap, "missing metric %s" % metric
    e2e = snap["serve.e2e_seconds"]
    total = sum(s["count"] for s in e2e["streams"])
    assert total >= n_requests, (total, e2e)
    print("self-test: latency histogram count=%d, queue metrics present"
          % total)
    if metrics_port is not None:
        import urllib.request

        srv = telemetry.fleet.maybe_start_metrics_server(metrics_port)
        base = "http://127.0.0.1:%d" % srv.port
        with urllib.request.urlopen(base + "/metrics", timeout=10) as r:
            text = r.read().decode()
        served = [float(line.split()[1]) for line in text.splitlines()
                  if line.startswith("mxtpu_serve_requests ")]
        # the process's counter: this test's requests and any served before
        assert served and served[0] == telemetry.total("serve.requests") >= n_requests, \
            text[:500]
        with urllib.request.urlopen(base + "/healthz", timeout=10) as r:
            assert r.status == 200 and json.loads(r.read().decode())["status"] == "ok"
        telemetry.fleet.stop_metrics_server()
        print("self-test: /metrics counts %d requests, /healthz ok" % n_requests)

    server.shutdown()
    server.server_close()
    engine.drain()
    try:
        engine.submit(data=np.zeros((1, 28, 28), np.float32))
        raise AssertionError("drained engine accepted work")
    except ServeClosed:
        pass
    print("self-test: graceful drain rejects new work")
    print("serve self-test PASSED")
    return 0


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="continuous-batching model server")
    ap.add_argument("--bundle", help="predictor bundle file")
    ap.add_argument("--checkpoint",
                    help="resilience checkpoint dir (needs --symbol)")
    ap.add_argument("--symbol", help="symbol JSON file for --checkpoint")
    ap.add_argument("--input", action="append", default=[],
                    metavar="name=DxDxD",
                    help="per-example input shape (repeatable)")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int,
                    default=int(os.environ.get("MXTPU_SERVE_PORT", "9000")))
    ap.add_argument("--max-batch", type=int, default=None,
                    help="batch cap (default MXTPU_SERVE_MAX_BATCH or 8)")
    ap.add_argument("--timeout-ms", type=float, default=None,
                    help="co-rider wait (default "
                         "MXTPU_SERVE_BATCH_TIMEOUT_MS or 2)")
    ap.add_argument("--metrics-port", type=int, default=None,
                    help="Prometheus /metrics port (MXTPU_METRICS_PORT)")
    ap.add_argument("--cpu", action="store_true",
                    help="serve on the host instead of the card")
    ap.add_argument("--self-test", action="store_true")
    args = ap.parse_args(argv)
    if args.self_test:
        return _self_test(args.cpu, args.metrics_port)
    return run_server(args)


if __name__ == "__main__":
    sys.exit(main())
