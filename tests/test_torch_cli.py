"""``clairs_to_tpu_torch run --device cpu`` against ``clairs_to_tpu run`` on
the same simulated BAM, plus the port's import hygiene and its refusal of
stages it does not have yet."""

import os
import subprocess
import sys

import pytest
import torch

from clairs_to_tpu.bamio import simulate
from clairs_to_tpu.cli.run import main as jax_main
from clairs_to_tpu_torch.cli.run import main as torch_main

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEMO = os.path.join(REPO, "assets", "demo_ont_snv")
SLICE_FLAGS = ["--disable_intermediate_phasing", "--disable_verdict",
               "--panel_of_normals", "None"]
# the dataset of tests/test_cli.py, and one with indels
DATASETS = {
    "test_cli": dict(seed=77, genome_len=50_000, coverage=55, n_snv=20, n_germline=8),
    "indels": dict(seed=78, genome_len=30_000, coverage=55, n_snv=10, n_indel=12,
                   n_germline=4),
}


@pytest.fixture(scope="module", params=sorted(DATASETS))
def dataset(request, tmp_path_factory):
    out = tmp_path_factory.mktemp(f"torchcli_{request.param}")
    return simulate.make_dataset(str(out), **DATASETS[request.param])


def _args(ds, out_dir):
    return ["-T", ds["bam"], "-R", ds["fasta"], "-o", out_dir, "-t", "2", "-p", "ont",
            "--model_dir", DEMO, "--device_batch", "256"] + SLICE_FLAGS


def _rows(path):
    out = []
    for line in open(path):
        if line.startswith("#"):
            continue
        c = line.rstrip("\n").split("\t")
        out.append((c[0], int(c[1]), c[3], c[4], c[6], c[9].split(":")[0], float(c[5])))
    return out


def test_run_matches_jax_cli(dataset, tmp_path):
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "torch")
    assert jax_main(_args(dataset, jdir)) == 0
    assert torch_main(_args(dataset, tdir) + ["--device", "cpu"]) == 0
    for name in ("snv.vcf", "indel.vcf"):
        want, got = _rows(os.path.join(jdir, name)), _rows(os.path.join(tdir, name))
        qual_gap = max((abs(a[6] - b[6]) for a, b in zip(want, got)), default=0.0)
        differ = [(a, b) for a, b in zip(want, got) if a[:6] != b[:6]]
        msg = (f"{name}: {len(want)} vs {len(got)} rows, largest QUAL gap "
               f"{qual_gap:.4f}, differing rows {differ[:5]}")
        # same sites, alleles, FILTER and GT; QUAL agrees to float32 rounding
        assert [r[:6] for r in got] == [r[:6] for r in want], msg
        assert qual_gap <= 0.01, msg
    assert _rows(os.path.join(tdir, "snv.vcf")), "no SNV rows"
    if any(not line.startswith("#") for line in open(dataset["truth_indel"])):
        assert _rows(os.path.join(tdir, "indel.vcf")), "no indel rows"


def test_run_refuses_unported_stages(dataset, tmp_path):
    args = _args(dataset, str(tmp_path / "o")) + ["--device", "cpu"]
    args.remove("--disable_verdict")
    with pytest.raises(SystemExit, match="Verdict"):
        torch_main(args)
    args = _args(dataset, str(tmp_path / "o2")) + ["--device", "cpu"]
    args.remove("--disable_intermediate_phasing")
    with pytest.raises(SystemExit, match="haplotype filter"):
        torch_main(args)
    with pytest.raises(SystemExit, match="BAQ"):
        torch_main(_args(dataset, str(tmp_path / "o3")) + ["--device", "cpu", "--apply_baq"])


def test_run_without_gpu_needs_device_cpu(dataset, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        torch_main(_args(dataset, str(tmp_path / "o")))


def test_port_imports_neither_jax_nor_reference():
    code = (
        "import sys\n"
        "import clairs_to_tpu_torch\n"
        "from clairs_to_tpu_torch.cli.run import build_parser\n"
        "import clairs_to_tpu_torch.__main__, clairs_to_tpu_torch.infer.pipeline\n"
        "import clairs_to_tpu_torch.bamio.simulate\n"
        "build_parser().parse_args(['-T', 'a', '-R', 'b', '-o', 'c', '-p', 'ont'])\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "             or m == 'clairs_to_tpu' or m.startswith('clairs_to_tpu.'))\n"
        "assert not bad, bad\n"
        "print('clean')\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0 and "clean" in proc.stdout, proc.stderr


def test_port_sources_import_neither_jax_nor_reference():
    import re

    pattern = re.compile(r"^\s*(import|from)\s+(jax|clairs_to_tpu)(\.|\s|$)", re.M)
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(os.path.join(REPO, "clairs_to_tpu_torch")):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    bad = [f for f in files if pattern.search(open(f).read())]
    assert not bad, bad
