"""The port's resident server (clairs_to_tpu_torch/serve.py) on the CPU: the
cases of tests/test_serve.py through ``python -m clairs_to_tpu_torch serve``
as a real process, its answers against the JAX package's server for the same
``argv``, the engine cache and its key, ``--preload``, and the refusal to run
on the CPU unasked."""

import json
import os
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import pytest
import torch

from clairs_to_tpu import serve as jax_serve
from clairs_to_tpu.bamio import simulate
from clairs_to_tpu_torch import serve as torch_serve
from clairs_to_tpu_torch.cli.run import build_parser
from test_torch_cli import DEMO, REPO, _rows
from test_torch_scheduler import free_port

torch.set_num_threads(1)
CALL_TIMEOUT = 240


@pytest.fixture(scope="module")
def ds(tmp_path_factory):
    # the dataset of tests/test_serve.py
    return simulate.make_dataset(
        str(tmp_path_factory.mktemp("torchserve_ds")), seed=61, genome_len=25_000,
        coverage=35, read_length=500, n_snv=8, n_indel=0, n_germline=20, error_rate=0.01,
        af_choices=(0.2, 0.4), somatic_hap_aware=True)


def _wait_healthy(base, proc=None, seconds=90):
    deadline = time.time() + seconds
    while time.time() < deadline:
        if proc is not None and proc.poll() is not None:
            raise RuntimeError(f"server exited: {proc.stdout.read()[-3000:]}")
        try:
            with urllib.request.urlopen(base + "/health", timeout=2) as r:
                if json.load(r)["status"] == "ok":
                    return
        except OSError:
            time.sleep(0.25)
    raise RuntimeError("server did not come up")


@pytest.fixture(scope="module")
def server():
    """``python -m clairs_to_tpu_torch serve`` as a process of its own."""
    port = free_port()
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    proc = subprocess.Popen(
        [sys.executable, "-m", "clairs_to_tpu_torch", "serve", "--port", str(port)],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    base = f"http://127.0.0.1:{port}"
    try:
        _wait_healthy(base, proc)
        yield base
    finally:
        proc.kill()
        proc.wait(timeout=30)


def _on_thread(srv):
    """Serve on a thread of this process; returns (base url, stop)."""
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()

    def stop():
        srv.shutdown()
        srv.server_close()
        thread.join(timeout=30)
        assert not thread.is_alive()
    return f"http://127.0.0.1:{srv.server_address[1]}", stop


def _post(base, payload, timeout=CALL_TIMEOUT):
    """(status, body) of POST /v1/call."""
    req = urllib.request.Request(base + "/v1/call", data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.load(r)
    except urllib.error.HTTPError as e:
        return e.code, json.load(e)


def _health(base):
    with urllib.request.urlopen(base + "/health", timeout=10) as r:
        return json.load(r)


def _argv(ds, out_dir, device="cpu"):
    argv = ["-T", ds["bam"], "-R", ds["fasta"], "-p", "ont", "-t", "1", "--model_dir", DEMO,
            "--device_batch", "256", "--disable_verdict", "--disable_indel_calling", "true",
            "-o", str(out_dir)]
    return argv + (["--device", device] if device else [])


def _body(path):
    return [l for l in open(path) if not l.startswith("##")]


def test_serve_two_calls_reuse_engines(server, ds, tmp_path):
    status, r1 = _post(server, {"argv": _argv(ds, tmp_path / "o1")})
    assert status == 200 and r1["returncode"] == 0, r1
    assert os.path.exists(r1["snv_vcf"]) and r1["engines_cached"] is False
    status, r2 = _post(server, {"argv": _argv(ds, tmp_path / "o2")})
    assert status == 200 and r2["returncode"] == 0, r2
    assert r2["engines_cached"] is True
    assert _body(r1["snv_vcf"]) == _body(r2["snv_vcf"]) and len(_body(r1["snv_vcf"])) > 1
    assert r2["metrics"]["counters"]["candidates"] > 0
    assert r2["metrics"]["counters"]["gru_launches"] == 0      # a CPU run launches no kernel
    assert r2["metrics"]["counters"]["dwproj_launches"] == 0
    assert "load_engines" not in r2["metrics"]["stages"]       # the warm call loads nothing
    health = _health(server)
    assert health["status"] == "ok" and len(health["engines"]) == 1
    assert "cpu" in health["engines"][0].split()


@pytest.mark.parametrize("payload", [{"argv": []}, {"argv": "-T x"}, {}, ["-T"],
                                     {"argv": ["--no_such_flag"]}])
def test_serve_bad_request(server, payload):
    status, body = _post(server, payload, timeout=30)
    assert status == 400 and "error" in body


def test_serve_invalid_json_and_unknown_paths(server):
    req = urllib.request.Request(server + "/v1/call", data=b"{not json")
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(req, timeout=30)
    assert e.value.code == 400
    for url, data in ((server + "/nothing", None), (server + "/v1/other", b"{}")):
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(urllib.request.Request(url, data=data), timeout=30)
        assert e.value.code == 404


def test_serve_run_error_is_an_answer_and_the_server_lives(server, ds, tmp_path):
    """A run that exits with its own [ERROR] gives a 400 with the message."""
    status, body = _post(server, {"argv": _argv(ds, tmp_path / "bad") + ["-r", "chrS:9-3"]})
    assert status == 400 and "Invalid region" in body["error"]
    assert _health(server)["status"] == "ok"


def test_serve_without_gpu_does_not_fall_back_to_the_cpu(server, ds, tmp_path):
    """No --device cpu in the request and no GPU here: an error, not a CPU run."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU: the request would rightly run on it")
    status, body = _post(server, {"argv": _argv(ds, tmp_path / "nogpu", device=None)})
    assert status == 500 and "no CUDA device" in body["error"]
    assert not os.path.exists(tmp_path / "nogpu" / "snv.vcf")
    assert not any("cuda" in e.split() for e in _health(server)["engines"])


def test_serve_concurrent_requests_serialize(server, ds, tmp_path):
    """Two calls at once both succeed (the lock serializes them) and agree."""
    results = {}

    def go(tag):
        results[tag] = _post(server, {"argv": _argv(ds, tmp_path / f"c_{tag}")})

    threads = [threading.Thread(target=go, args=(t,)) for t in ("a", "b")]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=2 * CALL_TIMEOUT)
        assert not t.is_alive()
    for tag in ("a", "b"):
        assert results[tag][0] == 200 and results[tag][1]["returncode"] == 0, results[tag]
    assert _body(results["a"][1]["snv_vcf"]) == _body(results["b"][1]["snv_vcf"])


def test_serve_matches_jax_server(server, ds, tmp_path):
    """The same argv to both servers (the port's with --device cpu): the same
    rows, FILTER, INFO, GT and sample fields, QUAL within 0.01."""
    from http.server import ThreadingHTTPServer

    jbase, stop = _on_thread(ThreadingHTTPServer(("127.0.0.1", 0), jax_serve._Handler))
    try:
        # the default flags but for indels (the dataset has none): phasing,
        # the haplotype filter and Verdict run
        argv = [a for a in _argv(ds, "OUT", device=None) if a != "--disable_verdict"]
        jargv = [str(tmp_path / "jax") if a == "OUT" else a for a in argv]
        targv = [str(tmp_path / "torch") if a == "OUT" else a for a in argv]
        js, jr = _post(jbase, {"argv": jargv})
        ts, tr = _post(server, {"argv": targv + ["--device", "cpu"]})
    finally:
        stop()
    assert (js, jr["returncode"]) == (200, 0) and (ts, tr["returncode"]) == (200, 0), (jr, tr)
    want, got = _rows(jr["snv_vcf"]), _rows(tr["snv_vcf"])
    assert want and [r[0] for r in got] == [r[0] for r in want]
    assert max(abs(a[1] - b[1]) for a, b in zip(want, got)) <= 0.01
    assert set(tr) == set(jr)     # the same keys in the answer
    assert tr["metrics"]["counters"]["candidates"] == jr["metrics"]["counters"]["candidates"]


def test_preload_makes_the_first_request_a_cache_hit(ds, tmp_path, monkeypatch):
    """``--preload ont`` and a request that names no --model_dir resolve the
    same default directory, before load_engines fills it in, so they meet."""
    from clairs_to_tpu_torch.cli import run as cli_run

    monkeypatch.setattr(cli_run, "default_model_dir", lambda platform, warn=True: DEMO)
    srv = torch_serve.make_server("127.0.0.1", 0, preload="ont", device="cpu")
    base, stop = _on_thread(srv)
    try:
        assert len(_health(base)["engines"]) == 1
        argv = ["-T", ds["bam"], "-R", ds["fasta"], "-p", "ont", "-t", "1",
                "--disable_verdict", "-o", str(tmp_path / "o"), "--device", "cpu"]
        status, r = _post(base, {"argv": argv})
        assert status == 200 and r["returncode"] == 0 and r["engines_cached"] is True, r
        assert len(_body(r["snv_vcf"])) > 1 and len(_health(base)["engines"]) == 1
        # another precision is another engine: the cache does not hand out the first
        status, r = _post(base, {"argv": argv + ["--matmul_precision", "default"]})
        assert status == 200 and r["engines_cached"] is False
        assert len(_health(base)["engines"]) == 2
    finally:
        stop()


def test_engine_key_names_what_decides_the_engines():
    base = ["-T", "a", "-R", "b", "-o", "c", "-p", "ont"]

    def key(*extra):
        return torch_serve.engine_key(build_parser().parse_args(base + list(extra)))

    assert key() == key("-o", "elsewhere", "-t", "7", "--chunk_num", "3")
    # computed from the resolved directory, so it is the same before and after
    # load_engines has filled args.model_dir in
    args = build_parser().parse_args(base)
    before = torch_serve.engine_key(args)
    from clairs_to_tpu_torch.cli.run import default_model_dir
    args.model_dir = default_model_dir("ont", warn=False)
    assert torch_serve.engine_key(args) == before
    different = [("--device", "cpu"), ("--device_count", "2"), ("--device_batch", "512"),
                 ("--matmul_precision", "default"), ("--disable_indel_calling", "true"),
                 ("--model_dir", DEMO), ("--snv_likelihood_matrix_data", "x.txt")]
    keys = {key(*extra) for extra in different}
    assert len(keys) == len(different) and key() not in keys
