"""Scale-out of ``clairs_to_tpu_torch run`` on the CPU: engine replicas
(``--device_count``) and a real two-process run on torch.distributed (gloo),
against the port's single-process run and against the JAX CLI's two-process
run, on a genome whose Verdict stage runs through ASCAT, so the gathered
allele counts matter."""

import os
import re
import subprocess
import sys

import pytest
import torch

import jax_native_libs
from clairs_to_tpu.bamio import simulate
from clairs_to_tpu_torch.cli.run import main as torch_main
from test_torch_cli import DEMO, DENSE, REPO, _log_lines, _rows
from test_torch_scheduler import free_port

torch.set_num_threads(1)


@pytest.fixture(scope="module", autouse=True)
def _jax_native_libs():
    """The JAX side runs on its C++ libraries (tests/jax_native_libs.py)."""
    jax_native_libs.load_all()


CHILD_TIMEOUT = 300
# the dense-germline genome of test_torch_cli.py (reads link the sites, Verdict
# finds its loci), with indels, so that both outputs have rows in every chunk
DATASET = dict(DENSE, n_indel=16)


@pytest.fixture(scope="module")
def dense(tmp_path_factory):
    return simulate.make_dataset(str(tmp_path_factory.mktemp("torchmulti_dense")), **DATASET)


def _args(ds, out_dir):
    """The default flags: phasing, the haplotype filter, indels, Verdict."""
    return ["-T", ds["bam"], "-R", ds["fasta"], "-o", out_dir, "-t", "2", "-p", "ont",
            "--model_dir", DEMO, "--device_batch", "256", "--chunk_num", "4"]


def _start_ranks(package, argv, extra_env=()):
    """Both ranks of one coordinator as real processes."""
    addr = f"127.0.0.1:{free_port()}"
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""),
               OMP_NUM_THREADS="1", **dict(extra_env))
    return [subprocess.Popen(
        [sys.executable, "-m", package, "run", *argv, "--coordinator_address", addr,
         "--num_processes", "2", "--process_id", str(rank)],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for rank in (0, 1)]


def _outputs(procs):
    """Waits for the processes, with a bound; returns their outputs."""
    try:
        outs = [p.communicate(timeout=CHILD_TIMEOUT)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, text in zip(procs, outs):
        assert p.returncode == 0, f"{' '.join(p.args[2:4])} failed:\n{text[-4000:]}"
    return outs


def _assert_same_calls(want_dir, got_dir, what):
    """Same rows, FILTER, INFO, GT and sample fields; QUAL within 0.01."""
    for name in ("snv.vcf", "indel.vcf"):
        want, got = _rows(os.path.join(want_dir, name)), _rows(os.path.join(got_dir, name))
        assert want, f"{name}: no rows to compare"
        gap = max((abs(a[1] - b[1]) for a, b in zip(want, got)), default=0.0)
        differ = [(a[0], b[0]) for a, b in zip(want, got) if a[0] != b[0]][:3]
        msg = f"{what} {name}: {len(want)} vs {len(got)} rows, QUAL gap {gap:.4f}, {differ}"
        assert [r[0] for r in got] == [r[0] for r in want] and gap <= 0.01, msg


@pytest.fixture(scope="module")
def single(dense, tmp_path_factory):
    """The port's single-process run with --device_count 1."""
    out = str(tmp_path_factory.mktemp("torchmulti_single"))
    assert torch_main(_args(dense, out) + ["--device", "cpu", "--device_count", "1"]) == 0
    verdict = _log_lines(out, "run_clairs_to_tpu_torch.log", "[INFO] Verdict")
    assert verdict and "skipped" not in verdict[0], verdict
    return out, verdict


def test_device_count_2_matches_1(dense, single, tmp_path, capsys):
    out = str(tmp_path / "two_replicas")
    assert torch_main(_args(dense, out) + ["--device", "cpu", "--device_count", "2"]) == 0
    assert "Data-parallel engine replicas on 2 cpu devices" in capsys.readouterr().out
    for name in ("snv.vcf", "indel.vcf"):
        body = [[l for l in open(os.path.join(d, name)) if not l.startswith("##")]
                for d in (single[0], out)]
        assert body[0] == body[1] and len(body[0]) > 1, name
    assert _log_lines(out, "run_clairs_to_tpu_torch.log", "[INFO] Verdict") == single[1]


def test_device_count_above_visible_gpus_is_cut(monkeypatch, capsys):
    from clairs_to_tpu_torch.cli.run import build_parser, run_devices

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    args = build_parser().parse_args(["-T", "a", "-R", "b", "-o", "c", "-p", "ont",
                                      "--device_count", "8"])
    assert run_devices(args) == [torch.device("cuda", 0), torch.device("cuda", 1)]
    out = capsys.readouterr().out
    assert "[INFO] --device_count 8: 2 GPU(s) visible, using 2" in out
    args.device_count = None     # default: every visible GPU
    assert len(run_devices(args)) == 2


def test_two_process_run_matches_single_and_jax(dense, single, tmp_path):
    tdir, jdir = str(tmp_path / "torch2"), str(tmp_path / "jax2")
    procs = _start_ranks("clairs_to_tpu_torch", _args(dense, tdir) + ["--device", "cpu"])
    procs += _start_ranks("clairs_to_tpu", _args(dense, jdir), extra_env={
        "JAX_PLATFORMS": "cpu", "CLAIRS_TO_TPU_AOT": "0",
        "XLA_FLAGS": "--xla_force_host_platform_device_count=1"})
    outs = _outputs(procs)
    touts, jouts = outs[:2], outs[2:]
    for rank, text in enumerate(touts):
        assert f"[INFO] Host {rank}/2: owns 2/4 chunks" in text
        assert '"gru_launches": 0' in text       # the counter is there; no GPU here
        assert '"dwproj_launches": 0' in text
    # rank 1 stops after the barrier: rank 0 alone merges and writes the output
    assert "host 0 merges the output" in touts[1] and "SNV output" not in touts[1]
    assert "SNV output" in touts[0] and "Indel output" in touts[0]
    assert os.path.exists(os.path.join(tdir, "tmp", "verdict_counts_1.npz"))
    assert any("owns" in t for t in jouts)

    _assert_same_calls(single[0], tdir, "two processes vs one")
    _assert_same_calls(jdir, tdir, "port vs JAX, two processes each")
    # Verdict saw the gathered counts of both ranks: the same line as the JAX
    # package's rank 0.  Rank 0 appends the other rank's counts after its own
    # (chunks 0, 2, then 1, 3), so the loci reach the segmentation out of
    # genome order, and in both packages the purity estimate moves in its
    # last digit against one process (0.94 for 0.93 here)
    tv = [l for l in touts[0].splitlines(True) if l.startswith("[INFO] Verdict")]
    jv = [l for l in jouts[0].splitlines(True) if l.startswith("[INFO] Verdict")]
    assert tv == jv and len(tv) == 1, (tv, jv)
    fit = re.compile(r"purity=([\d.]+) ploidy=([\d.]+) tagged=(\d+)")
    two, one = fit.search(tv[0]).groups(), fit.search(single[1][0]).groups()
    assert abs(float(two[0]) - float(one[0])) <= 0.02 and two[1:] == one[1:], (tv, single[1])


def test_missing_shard_after_the_barrier_is_an_error(dense, tmp_path, monkeypatch):
    """Rank 0 with nobody else's shards in --output_dir: an error, not a
    shorter VCF.  (No group exists in this process, so the barrier passes.)"""
    from clairs_to_tpu_torch.parallel import scheduler

    monkeypatch.setattr(scheduler, "init_distributed", lambda *a, **k: (2, 0))
    out = str(tmp_path / "alone")
    with pytest.raises(SystemExit, match="chunk shards missing after the host barrier"):
        torch_main(_args(dense, out) + ["--device", "cpu"])
    assert not os.path.exists(os.path.join(out, "snv.vcf"))
    shards = os.listdir(os.path.join(out, "tmp", "vcf_output"))
    assert sorted(s for s in shards if s.startswith("p_snv_")) == ["p_snv_chrS_0.vcf",
                                                                   "p_snv_chrS_2.vcf"]


def test_coordinator_without_rank_is_an_error(dense, tmp_path):
    with pytest.raises(SystemExit, match="needs --num_processes and --process_id"):
        torch_main(_args(dense, str(tmp_path / "o")) + ["--device", "cpu",
                                                        "--coordinator_address", "127.0.0.1:9"])


@pytest.mark.parametrize("name", ["bamio.native", "postcall.verdict_native", "realign"])
def test_cold_library_is_built_once_by_concurrent_threads(name, tmp_path, monkeypatch):
    """A run's decode workers all reach the loader at once, and with no
    library built yet (a fresh checkout, or a rank of a multi-process run)
    one of them builds it while the others wait; none may start a second
    build over the first one's output or fall back to the slow path."""
    import importlib
    import threading

    from clairs_to_tpu_torch.ops import _native

    mod = importlib.import_module(f"clairs_to_tpu_torch.{name}")
    lib = mod.LIB
    builds, real_start = [], _native.start_compile

    def counting_start(argv, so):
        if so == lib.so:
            builds.append(threading.get_ident())
        return real_start(argv, so)

    monkeypatch.setattr(lib, "so", str(tmp_path / os.path.basename(lib.so)))
    for attr in ("cdll", "fns", "error"):
        monkeypatch.setattr(lib, attr, None)
    monkeypatch.setattr(_native, "start_compile", counting_start)
    got = []
    threads = [threading.Thread(target=lambda: got.append(mod.get_lib())) for _ in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=180)
        assert not t.is_alive()
    assert len(builds) == 1 and len(got) == 6
    assert all(cdll is not None and cdll is got[0] for cdll in got), lib.error
    assert os.listdir(tmp_path) == [os.path.basename(lib.so)]    # no temporary file left


def test_fasta_fetch_from_many_threads(dense):
    """A run's decode workers fetch their chunks' reference through one
    FastaFile at the same time; every fetch must return its own region (a
    chunk decoded against another region, or past the end of the file,
    silently loses or invents calls)."""
    import sys
    import threading

    from clairs_to_tpu_torch.genome.fasta import FastaFile

    fasta = FastaFile(dense["fasta"])
    genome, ctg = dense["genome"], dense["ctg"]
    spans = [(k * 4_000, min(len(genome), k * 4_000 + 9_000)) for k in range(10)]
    wrong = []

    def fetch_all(lo, hi):
        for _ in range(300):
            if fasta.fetch(ctg, lo, hi) != genome[lo:hi]:
                wrong.append((lo, hi))

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=fetch_all, args=span) for span in spans]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
            assert not t.is_alive()
    finally:
        sys.setswitchinterval(interval)
        fasta.close()
    assert not wrong, f"{len(wrong)} fetches returned another region: {wrong[:3]}"

