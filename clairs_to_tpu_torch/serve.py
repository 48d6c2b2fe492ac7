"""Resident calling server: one process that keeps the engines warm.

Counterpart of clairs_to_tpu/serve.py.  A batch ``run`` loads the
checkpoints, moves them to the GPU, builds or loads the GRU kernel and warms
cuDNN before its first chunk; a service that answers request after request
pays that once:

    python -m clairs_to_tpu_torch serve --port 8577 [--preload ont]

    POST /v1/call   {"argv": ["-T", "tumor.bam", "-R", "ref.fa",
                              "-o", "out", "-p", "ont", ...]}
        -> {"returncode": 0, "snv_vcf": ..., "seconds": ...,
            "engines_cached": true|false, "metrics": {...}}
    GET  /health    -> {"status": "ok", "engines": [...], "uptime_s": ...}

``argv`` is the full flag surface of ``run`` (cli/run.py): the server parses
it with the same parser, so a request can do whatever the batch CLI can,
``--device cpu`` included; without it a request needs a GPU and fails when
there is none.  Engines are cached by what decides which engines a run needs
(model paths, device, device count, device batch, indel on or off, matmul
precision).  The first request per key pays the load, a later one starts
calling at once.  On one NVIDIA H100 80GB HBM3 (700 W limit) the two stages
a warm request skips, ``load_engines`` and ``engine_warmup``, took 0.62 to
0.98 s of the same ``run`` as a batch call (``chip_smoke.py`` phase 7, four
runs, line WARM_SAVING); on a 2 Mb genome the host decode varied by more
than that from run to run, so the requests' seconds did not show it.  One
lock serializes calls: one GPU, one compute stream, and ``sys.stdout`` is
teed into the run's log while a call runs.
"""

import argparse
import json
import os
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer


def engine_key(args):
    """Everything that changes which engines a run needs.  The model
    directory is the one ``load_engines`` would resolve, so a request that
    names no ``--model_dir`` meets the engines preloaded for its platform."""
    from clairs_to_tpu_torch.cli.run import default_model_dir

    return (
        args.model_dir or default_model_dir(args.platform, warn=False),
        args.snv_pileup_affirmative_model_path,
        args.snv_pileup_negational_model_path,
        args.indel_pileup_affirmative_model_path,
        args.indel_pileup_negational_model_path,
        args.snv_likelihood_matrix_data,
        args.indel_likelihood_matrix_data,
        args.device_batch,
        str(args.disable_indel_calling).lower(),
        args.matmul_precision,
        args.device,
        args.device_count,
    )


class CallService:
    """The engines of one server and the lock that serializes its calls."""

    def __init__(self):
        self.started = time.time()
        self.lock = threading.Lock()      # one GPU -> one run at a time
        self.engines = {}                 # key -> (snv_engine, indel_engine)

    def get_engines(self, args):
        """Load or reuse the engines of this request; returns
        ((snv, indel), cached).  Call with the lock held."""
        from clairs_to_tpu_torch.cli.run import load_engines, run_devices, warm_engines

        key = engine_key(args)
        hit = self.engines.get(key)
        if hit is not None:
            return hit, True
        engines = load_engines(args, devices=run_devices(args))
        warm_engines(engines)
        self.engines[key] = engines
        return engines, False

    def preload(self, platform, device):
        from clairs_to_tpu_torch.cli.run import build_parser

        args = build_parser().parse_args(
            ["-T", os.devnull, "-R", os.devnull, "-o", os.curdir, "-p", platform,
             "--device", device])
        with self.lock:
            self.get_engines(args)

    def handle_call(self, payload):
        from clairs_to_tpu_torch.cli.run import _main_impl, build_parser

        argv = payload.get("argv") if isinstance(payload, dict) else None
        if not isinstance(argv, list) or not argv:
            return 400, {"error": "body must be {\"argv\": [run flags...]}"}
        try:
            args = build_parser().parse_args([str(a) for a in argv])
        except SystemExit:
            return 400, {"error": "invalid run arguments", "argv": argv}
        t0 = time.time()
        with self.lock:
            engines, cached = self.get_engines(args)
            try:
                rc = _main_impl(args, engines=engines)
            except SystemExit as e:   # the run's own "[ERROR] ..." exits
                return 400, {"error": str(e.code), "argv": argv}
        out = {
            "returncode": int(rc or 0),
            "seconds": round(time.time() - t0, 2),
            "engines_cached": cached,
            "output_dir": args.output_dir,
            "snv_vcf": os.path.join(args.output_dir, f"{args.snv_output_prefix}.vcf"),
        }
        log = os.path.join(args.output_dir, "run_clairs_to_tpu_torch.log")
        try:
            with open(log) as f:
                for line in f:
                    if "RunMetricsSummary:" in line:
                        out["metrics"] = json.loads(line.split("RunMetricsSummary: ", 1)[1])
        except OSError:
            pass
        return 200, out

    def health(self):
        return {
            "status": "ok",
            "uptime_s": round(time.time() - self.started, 1),
            "engines": [" ".join(str(x) for x in k if x is not None) for k in self.engines],
        }


class _Handler(BaseHTTPRequestHandler):
    def _send(self, code, obj):
        body = json.dumps(obj).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):
        if self.path == "/health":
            self._send(200, self.server.service.health())
        else:
            self._send(404, {"error": "unknown path"})

    def do_POST(self):
        if self.path != "/v1/call":
            self._send(404, {"error": "unknown path"})
            return
        try:
            n = int(self.headers.get("Content-Length", 0))
            payload = json.loads(self.rfile.read(n) or b"{}")
        except (ValueError, json.JSONDecodeError):
            self._send(400, {"error": "invalid JSON body"})
            return
        try:
            code, obj = self.server.service.handle_call(payload)
        except Exception as e:  # noqa: BLE001 — a request must not kill the server
            code, obj = 500, {"error": f"{type(e).__name__}: {e}"}
        self._send(code, obj)

    def log_message(self, fmt, *a):  # quiet default request logging
        print(f"[serve] {self.address_string()} {fmt % a}")


def make_server(host="127.0.0.1", port=8577, preload=None, device="cuda"):
    """The HTTP server, bound and with its engines preloaded, not yet
    serving: the caller runs ``serve_forever()`` (on a thread of its own, in
    a test) and ``shutdown()`` + ``server_close()`` when done.  Port 0 binds
    a free port (``server_address`` says which)."""
    service = CallService()
    if preload:
        print(f"[serve] preloading engines for platform {preload} on {device} ...")
        service.preload(preload, device)
        print("[serve] engines ready")
    srv = ThreadingHTTPServer((host, port), _Handler)
    srv.service = service
    return srv


def main(argv=None):
    ap = argparse.ArgumentParser(prog="clairs_to_tpu_torch serve")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8577)
    ap.add_argument("--preload", default=None,
                    help="Platform to preload engines for at startup "
                         "(e.g. 'ont') so the first request is warm.")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="Device of the preloaded engines; a request names its "
                         "own with --device in its argv.")
    a = ap.parse_args(argv)
    srv = make_server(a.host, a.port, a.preload, a.device)
    host, port = srv.server_address[:2]
    print(f"[serve] listening on http://{host}:{port} (POST /v1/call, GET /health)",
          flush=True)
    try:
        srv.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        srv.server_close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
