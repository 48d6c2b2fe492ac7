"""``clairs_to_tpu_torch run --device cpu`` against ``clairs_to_tpu run`` on
the same simulated BAM with the default flags (phasing and the haplotype
filter, PoN tagging, Verdict, tabix output), the Illumina path, genotyping,
BAQ and the opt-out run; the host subcommands of both dispatchers on the
same files; and the port's import hygiene."""

import os
import subprocess
import sys

import pytest
import torch

import jax_native_libs
from clairs_to_tpu.bamio import simulate
from clairs_to_tpu.cli.run import main as jax_main
from clairs_to_tpu_torch.cli.run import main as torch_main
from clairs_to_tpu_torch.vcf.tabix import TabixReader, write_tabix_vcf

torch.set_num_threads(1)


@pytest.fixture(scope="module", autouse=True)
def _jax_native_libs():
    """The JAX side runs on its C++ libraries (tests/jax_native_libs.py)."""
    jax_native_libs.load_all()


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEMO = os.path.join(REPO, "assets", "demo_ont_snv")
OPT_OUT_FLAGS = ["--disable_intermediate_phasing", "--disable_verdict",
                 "--panel_of_normals", "None"]
# the dataset of tests/test_cli.py, and one with indels
DATASETS = {
    "test_cli": dict(seed=77, genome_len=50_000, coverage=55, n_snv=20, n_germline=8),
    "indels": dict(seed=78, genome_len=30_000, coverage=55, n_snv=10, n_indel=12,
                   n_germline=4),
}
# germline sites dense enough for reads to link them (the phaser has real
# work) and for Verdict to find its 12 loci
DENSE = dict(seed=33, genome_len=40_000, coverage=45, read_length=700, n_snv=12,
             n_germline=130, somatic_hap_aware=True)
# 150-base reads: the dataset of tests/test_realignment_stage.py
ILMN = dict(seed=91, genome_len=30_000, coverage=50, read_length=150, n_snv=10, n_germline=5)

@pytest.fixture(scope="module", params=sorted(DATASETS))
def dataset(request, tmp_path_factory):
    out = tmp_path_factory.mktemp(f"torchcli_{request.param}")
    return simulate.make_dataset(str(out), **DATASETS[request.param])


@pytest.fixture(scope="module")
def dense(tmp_path_factory):
    return simulate.make_dataset(str(tmp_path_factory.mktemp("torchcli_dense")), **DENSE)


@pytest.fixture(scope="module")
def ilmn(tmp_path_factory):
    return simulate.make_dataset(str(tmp_path_factory.mktemp("torchcli_ilmn")), **ILMN)


def _args(ds, out_dir, platform="ont"):
    return ["-T", ds["bam"], "-R", ds["fasta"], "-o", out_dir, "-t", "2", "-p", platform,
            "--model_dir", DEMO, "--device_batch", "256"]


def _write_pon(ds, path, indexed):
    """A PoN of every other simulated germline site; ``indexed`` writes it
    bgzipped with a .tbi through the port's own writer."""
    germ = sorted((v.pos, v.ref, v.alt) for v in ds["variants"] if v.germline)[::2]
    with open(path, "w") as f:
        f.write("##fileformat=VCFv4.2\n#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\n")
        for pos, ref, alt in germ:
            f.write(f"{ds['ctg']}\t{pos + 1}\t.\t{ref}\t{alt}\t.\t.\t.\n")
    if indexed:
        write_tabix_vcf(path)
        return path + ".gz"
    return path


def _rows(path):
    """Per row: what must be equal, then QUAL and GQ (which follow the
    float32 forward)."""
    out = []
    for line in open(path):
        if line.startswith("#"):
            continue
        c = line.rstrip("\n").split("\t")
        sample = dict(zip(c[8].split(":"), c[9].split(":")))
        gq = float(sample.pop("GQ", 0))
        same = (c[0], int(c[1]), c[3], c[4], c[6], sample["GT"], c[7], c[8],
                tuple(sorted(sample.items())))
        out.append((same, float(c[5]), gq))
    return out


def _log_lines(out_dir, name, prefix):
    with open(os.path.join(out_dir, name)) as f:
        return [line for line in f if line.startswith(prefix)]


def _run_both(argv_of, tmp_path):
    """Run both CLIs; hold the port's outputs to the JAX package's.  Same
    sites, alleles, FILTER, INFO, GT and sample fields; QUAL agrees to the
    float32 rounding of the forward (0.01).  Returns the port's rows."""
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "torch")
    assert jax_main(argv_of(jdir)) == 0
    assert torch_main(argv_of(tdir) + ["--device", "cpu"]) == 0
    got_all = {}
    for name in ("snv.vcf", "indel.vcf"):
        if not os.path.exists(os.path.join(jdir, name)):
            assert not os.path.exists(os.path.join(tdir, name))
            continue
        want, got = _rows(os.path.join(jdir, name)), _rows(os.path.join(tdir, name))
        qual_gap = max((abs(a[1] - b[1]) for a, b in zip(want, got)), default=0.0)
        differ = [(a[0], b[0]) for a, b in zip(want, got) if a[0] != b[0]]
        msg = (f"{name}: {len(want)} vs {len(got)} rows, largest QUAL gap "
               f"{qual_gap:.4f}, differing rows {differ[:5]}")
        assert [r[0] for r in got] == [r[0] for r in want], msg
        assert qual_gap <= 0.01, msg
        assert all(abs(a[2] - b[2]) <= 1 for a, b in zip(want, got)), msg
        # the bgzip + tabix copies exist and read back as the plain file
        gz = os.path.join(tdir, name + ".gz")
        assert os.path.exists(gz + ".tbi") and os.path.exists(os.path.join(jdir, name + ".gz.tbi"))
        plain = [l.rstrip("\n") for l in open(os.path.join(tdir, name)) if not l.startswith("#")]
        ctgs = sorted({l.split("\t")[0] for l in plain})
        back = [l for c in ctgs for l in TabixReader(gz).fetch(c, 0, 10**9)]
        assert back == plain
        got_all[name] = got
    # Verdict took the same way through both: applied, or skipped for the same reason
    jv = _log_lines(jdir, "run_clairs_to_tpu.log", "[INFO] Verdict")
    tv = _log_lines(tdir, "run_clairs_to_tpu_torch.log", "[INFO] Verdict")
    assert jv == tv
    return got_all, tdir, tv


def test_run_matches_jax_cli(dataset, tmp_path):
    """The default flags, with a PoN: no opt-out."""
    pon = _write_pon(dataset, str(tmp_path / "pon.vcf"), indexed=False)
    got, tdir, verdict = _run_both(
        lambda out: _args(dataset, out) + ["--panel_of_normals", pon], tmp_path)
    assert got["snv.vcf"], "no SNV rows"
    if any(not line.startswith("#") for line in open(dataset["truth_indel"])):
        assert got["indel.vcf"], "no indel rows"
    assert any("NonSomatic" in r[0][4] for r in got["snv.vcf"])
    assert any(";SB=" in r[0][6] for r in got["snv.vcf"]), "the haplotype filter did not run"
    assert verdict, "the Verdict stage left no line in the log"


def test_run_dense_germline_matches_jax_cli(dense, tmp_path):
    """Reads link the germline sites: the phaser tags reads, the haplotype
    filter sees phaseable sites, the PoN is read through its index and
    Verdict has its loci."""
    pon = _write_pon(dense, str(tmp_path / "pon.vcf"), indexed=True)
    got, tdir, verdict = _run_both(
        lambda out: _args(dense, out) + ["--panel_of_normals", pon,
                                         "--panel_of_normals_require_allele_matching", "False"],
        tmp_path)
    rows = [r[0] for r in got["snv.vcf"]]
    assert any(r[6].startswith("H;") for r in rows), "no phaseable site"
    assert any("NonSomatic" in r[4] for r in rows)
    assert verdict and "skipped" not in verdict[0], verdict
    log = "".join(_log_lines(tdir, "run_clairs_to_tpu_torch.log", "[INFO] RunMetricsSummary"))
    assert '"reads_haplotagged": 0' not in log and '"reads_haplotagged"' in log
    for stage in ("hard_filters", "pon_tagging", "verdict", "tabix"):
        assert f'"{stage}"' in log


def _sites_vcf(ds, path, n=6):
    """Genotyping sites: some truth SNVs and some sites nothing supports."""
    truth = sorted((v.pos, v.ref, v.alt) for v in ds["variants"]
                   if len(v.ref) == 1 and len(v.alt) == 1)[:n]
    extra = [(p, ds["genome"][p], "ACGT"[("ACGT".index(ds["genome"][p]) + 1) % 4])
             for p in (5_003, 9_017, 14_031)]
    with open(path, "w") as f:
        f.write("##fileformat=VCFv4.2\n#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\t"
                "FORMAT\tS\n")
        for pos, ref, alt in sorted(truth + extra):
            f.write(f"{ds['ctg']}\t{pos + 1}\t.\t{ref}\t{alt}\t30\tPASS\t.\tGT\t0/1\n")
    return path, len(truth) + len(extra)


CASES = {
    # the slice of the first port PR: every post-calling stage opted out
    "opt_out": lambda ds, tmp: OPT_OUT_FLAGS,
    "genotyping": lambda ds, tmp: ["-G", _sites_vcf(ds, str(tmp / "sites.vcf"))[0]],
    "hybrid": lambda ds, tmp: ["-H", _sites_vcf(ds, str(tmp / "sites.vcf"))[0]],
    "exact_fisher": lambda ds, tmp: ["--exact_reference_fisher", "--print_ref_calls"],
    "hifi": lambda ds, tmp: ["--qual", "4"],
    # several chunks in flight: each chunk's filters tag its own decoded views
    "multi_chunk": lambda ds, tmp: ["--chunk_size", "9000", "-t", "3"],
    # no longphase binary is installed: both fall back to the internal phaser
    "longphase_absent": lambda ds, tmp: ["--use_longphase_for_intermediate_phasing", "True",
                                          "--longphase", str(tmp / "no_such_binary")],
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_run_case_matches_jax_cli(case, dataset, dense, tmp_path, capsys):
    ds = dense if case in ("longphase_absent", "exact_fisher", "multi_chunk") else dataset
    extra = CASES[case](ds, tmp_path)
    platform = "hifi_revio" if case == "hifi" else "ont"
    got, tdir, _verdict = _run_both(lambda out: _args(ds, out, platform) + extra, tmp_path)
    assert got["snv.vcf"], "no SNV rows"
    out = capsys.readouterr().out
    if case in ("genotyping", "hybrid"):
        n_sites = _sites_vcf(ds, str(tmp_path / "again.vcf"))[1]
        positions = {r[0][1] for r in got["snv.vcf"]}
        want = {int(l.split("\t")[1]) for l in open(str(tmp_path / "again.vcf"))
                if not l.startswith("#")}
        assert len(want) == n_sites and want <= positions
        if case == "genotyping":
            assert positions == want and out.count("Added back") == 2
    if case == "longphase_absent":
        assert out.count("falling back to the internal phaser") == 2
        assert any(r[0][6].startswith("H;") for r in got["snv.vcf"])
    if case == "multi_chunk":
        assert out.count("chunk 5/5") == 2
        assert any(r[0][6].startswith("H;") for r in got["snv.vcf"])
    if case == "opt_out":
        assert not any(";SB=" in r[0][6] for r in got["snv.vcf"])


def test_run_apply_baq_matches_jax_cli(tmp_path):
    """--apply_baq decodes through the Python pileup and caps every read's
    qualities (bamio/baq.py), which is slow: a few hundred reads."""
    ds = simulate.make_dataset(str(tmp_path / "sim"), seed=79, genome_len=4_000, coverage=30,
                               read_length=300, n_snv=6, n_germline=3)
    got, _tdir, _verdict = _run_both(lambda out: _args(ds, out) + ["--apply_baq"], tmp_path)
    assert got["snv.vcf"], "no SNV rows"


def test_run_ilmn_matches_jax_cli(ilmn, tmp_path, capsys):
    """The default Illumina run: realignment, then the postfilter."""
    from clairs_to_tpu_torch import realign

    assert realign.available()
    got, tdir, _verdict = _run_both(lambda out: _args(ilmn, out, "ilmn"), tmp_path)
    assert got["snv.vcf"], "no SNV rows"
    assert any(";SB=" in r[0][6] for r in got["snv.vcf"]), "the postfilter did not run"
    assert not any(r[0][6].startswith("H") for r in got["snv.vcf"])


def test_run_ilmn_realignment_stage_is_called(ilmn, tmp_path):
    from unittest import mock

    from clairs_to_tpu_torch.postcall import realignment

    with mock.patch.object(realignment, "realign_filter",
                           wraps=realignment.realign_filter) as spy:
        assert torch_main(_args(ilmn, str(tmp_path / "o"), "ilmn")
                          + ["--device", "cpu", "--disable_indel_calling", "true"]) == 0
    assert spy.called and spy.call_args.kwargs["window"] is not None
    assert not os.path.exists(str(tmp_path / "o" / "indel.vcf"))


def test_run_cna_resource_dir_matches_jax_cli(dense, tmp_path, capsys):
    """Verdict with G1000-layout loci and GC / replication-timing tracks."""
    import numpy as np

    rng = np.random.default_rng(5)
    code = {"A": "1", "C": "2", "G": "3", "T": "4"}
    loci = sorted((v.pos + 1, v.ref, v.alt) for v in dense["variants"] if v.germline)
    res_dir = tmp_path / "cna_resources"
    (res_dir / "allele_files").mkdir(parents=True)
    with open(res_dir / "allele_files" / f"G1000_alleles_hg38_{dense['ctg']}.txt", "w") as f:
        f.write("position\tallele_A\tallele_B\n")
        for pos1, ref, alt in loci:
            f.write(f"{pos1}\t{code[ref]}\t{code[alt]}\n")
    for track in ("GC_G1000_hg38.txt", "RT_G1000_hg38.txt"):
        with open(res_dir / track, "w") as f:
            f.write("idx\tchr\tpos\t" + "\t".join(f"c{i}" for i in range(12)) + "\n")
            for k, (pos1, _r, _a) in enumerate(loci):
                vals = "\t".join(f"{rng.random():.4f}" for _ in range(12))
                f.write(f"{k}\tS\t{pos1}\t{vals}\n")
    got, tdir, verdict = _run_both(
        lambda out: _args(dense, out) + ["--cna_resource_dir", str(res_dir),
                                         "--disable_indel_calling", "true"], tmp_path)
    assert capsys.readouterr().out.count("G1000 loci from") == 2
    assert verdict and "skipped" not in verdict[0]
    # the reference's cna_output/ layout, equal in both packages
    jcna = tmp_path / "jax" / "tmp" / "cna_output"
    tcna = tmp_path / "torch" / "tmp" / "cna_output"
    names = sorted(os.listdir(tcna))
    assert names == sorted(os.listdir(jcna)) and "SAMPLE_Tumor_LogR.txt" in names
    for n in names:
        assert (jcna / n).read_text() == (tcna / n).read_text(), n


@pytest.fixture(scope="module")
def chunk_vcfs(dense, tmp_path_factory):
    """A three-chunk run's per-chunk and merged VCFs, and a PoN."""
    out = tmp_path_factory.mktemp("torchcli_subcommands")
    assert torch_main(_args(dense, str(out / "run")) + OPT_OUT_FLAGS
                      + ["--device", "cpu", "--chunk_num", "3"]) == 0
    return dict(shards=str(out / "run" / "tmp" / "vcf_output"),
                merged=str(out / "run" / "tmp" / "vcf_output" / "snv_pileup.vcf"),
                final=str(out / "run" / "snv.vcf"),
                pon=_write_pon(dense, str(out / "pon.vcf"), indexed=True))


SUBCOMMANDS = {
    "sort_vcf": lambda ds, v, out: [
        "--input_dir", v["shards"], "--vcf_fn_prefix", "p_snv_", "--output_fn", f"{out}/o.vcf"],
    "nonsomatic_tagging": lambda ds, v, out: [
        "--pileup_vcf_fn", v["merged"], "--output_vcf_fn", f"{out}/o.vcf",
        "--panel_of_normals", v["pon"], "--panel_of_normals_require_allele_matching", "False"],
    "postprocess_vcf": lambda ds, v, out: [
        "--pileup_vcf_fn", v["merged"], "--output_fn", f"{out}/o.vcf", "--platform", "ont",
        "--ref_fn", ds["fasta"], "--qual", "6", "--compress_vcf"],
    "compare_vcf": lambda ds, v, out: [
        "--truth_vcf_fn", ds["truth"], "--input_vcf_fn", v["final"], "--ctg_name", ds["ctg"]],
    "compare_vcf_region": lambda ds, v, out: [
        "--truth_vcf_fn", ds["truth"], "--input_vcf_fn", v["final"], "--ctg_start", "5000",
        "--ctg_end", "30000", "--skip_genotyping", "False", "--input_filter_tag", "PASS"],
    "gen_contaminated_bam": lambda ds, v, out: [
        "--output_dir", f"{out}/sim", "--purity", "0.6", "--seed", "5", "--genome_len", "8000",
        "--coverage", "20", "--n_snv", "5", "--n_indel", "2", "--n_germline", "3"],
}


@pytest.mark.parametrize("case", sorted(SUBCOMMANDS))
def test_subcommand_matches_jax(case, dense, chunk_vcfs, tmp_path, capsys):
    """Each host subcommand of ``python -m clairs_to_tpu_torch`` against the
    JAX package's on the same files: the same lines printed, the same files
    written, byte for byte."""
    from clairs_to_tpu.__main__ import SUBMODULES as jax_subs
    from clairs_to_tpu_torch.__main__ import SUBMODULES as torch_subs

    name = case.replace("_region", "")
    printed, files = [], []
    for tag, subs in (("jax", jax_subs), ("torch", torch_subs)):
        out = tmp_path / tag
        out.mkdir()
        capsys.readouterr()
        assert subs[name](SUBCOMMANDS[case](dense, chunk_vcfs, str(out))) == 0
        printed.append(capsys.readouterr().out.replace(str(out), "OUT"))
        files.append({os.path.relpath(os.path.join(root, n), out): open(
            os.path.join(root, n), "rb").read() for root, _, ns in os.walk(out) for n in ns})
    assert printed[0] == printed[1] and (printed[1].strip() or name == "postprocess_vcf")
    assert sorted(files[0]) == sorted(files[1])
    for rel in files[0]:
        assert files[0][rel] == files[1][rel], rel
    if name == "compare_vcf":
        assert "Precision" in printed[1] and not files[1]
    elif name == "gen_contaminated_bam":
        assert any(rel.endswith(".bam") for rel in files[1])
    else:
        assert len(files[1]["o.vcf"]) > 200
    if name == "postprocess_vcf":
        assert "o.vcf.gz" in files[1] and "o.vcf.gz.tbi" in files[1]
    if name == "nonsomatic_tagging":
        assert b"NonSomatic" in files[1]["o.vcf"] and "tagged=" in printed[1]


def test_dispatcher_lists_the_ported_subcommands(monkeypatch, capsys):
    from clairs_to_tpu import __main__ as jax_entry
    from clairs_to_tpu_torch import __main__ as entry

    monkeypatch.setattr(sys, "argv", ["clairs_to_tpu_torch", "--help"])
    assert entry.main() == 0
    listed = capsys.readouterr().out.split("Available submodules:")[1].split()
    # every subcommand of the JAX package
    assert listed == sorted(jax_entry.SUBMODULES) == [
        "compare_vcf", "convert_checkpoint", "gen_contaminated_bam", "nonsomatic_tagging",
        "postprocess_vcf", "run", "serve", "sort_vcf", "train"]
    monkeypatch.setattr(sys, "argv", ["clairs_to_tpu_torch", "no_such_stage"])
    assert entry.main() == 1 and "Unknown submodule" in capsys.readouterr().out


@pytest.fixture(scope="module")
def trained_dir(tmp_path_factory):
    """``train --tiny --device cpu`` for both modes, in the layout that
    ``run --model_dir`` reads."""
    from clairs_to_tpu_torch.__main__ import SUBMODULES

    out = tmp_path_factory.mktemp("torchcli_train")
    for mode, sub in (("snv", ""), ("indel", "indel")):
        assert SUBMODULES["train"](["--output_dir", str(out / sub), "--mode", mode, "--tiny",
                                    "--device", "cpu", "--n_train", "300", "--epochs", "1"]) == 0
    return str(out)


def test_train_writes_what_jax_loads(trained_dir):
    import jax.numpy as jnp
    import numpy as np

    from clairs_to_tpu.models import bigru as jbigru
    from clairs_to_tpu.models import cvt as jcvt
    from clairs_to_tpu.ops.posterior import load_likelihood_matrix
    from clairs_to_tpu.train import load_checkpoint_auto as jax_load
    from clairs_to_tpu_torch.models.checkpoint import load_checkpoint_auto

    x = np.random.default_rng(2).integers(-30, 30, size=(5, 33, 34)).astype(np.float32)
    for sub, mode, n_al in (("", "snv", 4), ("indel", "indel", 6)):
        d = os.path.join(trained_dir, sub)
        assert sorted(os.listdir(d)) == sorted(
            ["aff.npz", "neg.npz", "likelihood_matrix.txt"] + (["indel"] if not sub else []))
        for name, kind, fwd in (("aff.npz", "cvt", jcvt.forward), ("neg.npz", "bigru",
                                                                  jbigru.forward)):
            params, jconfig = jax_load(os.path.join(d, name), mode=mode, kind=kind)
            model, config = load_checkpoint_auto(os.path.join(d, name), mode=mode, kind=kind,
                                                 device="cpu")
            assert len(jconfig.alleles) == len(config.alleles) == n_al
            with torch.no_grad():
                got = model(torch.from_numpy(x)).numpy()
            np.testing.assert_allclose(got, np.asarray(fwd(params, jnp.asarray(x), jconfig)),
                                       rtol=1e-5, atol=1e-5)
        lik = load_likelihood_matrix(os.path.join(d, "likelihood_matrix.txt"), n_alleles=n_al)
        assert lik.matrices.shape == (n_al, 10, 10) and np.isfinite(lik.matrices).all()


def test_run_with_trained_model_dir_matches_jax_cli(dataset, trained_dir, tmp_path):
    """Both CLIs call with the port's trained networks; every candidate is
    printed, so the rows are the networks' decisions."""
    got, _tdir, _verdict = _run_both(
        lambda out: _args(dataset, out)[:-4] + ["--model_dir", trained_dir, "--device_batch",
                                                "256", "--print_ref_calls"] + OPT_OUT_FLAGS,
        tmp_path)
    assert got["snv.vcf"], "no SNV rows"


class _PickledModule(torch.nn.Module):
    """Stands in for a reference whole-module pickle: all the converter
    reads of it is ``state_dict()``."""

    def __init__(self, state):
        super().__init__()
        self._state = state

    def state_dict(self, *args, **kwargs):
        return self._state


@pytest.mark.parametrize("kind", ["aff", "neg"])
def test_convert_checkpoint_matches_jax(kind, tmp_path):
    """A whole-module pickle through both packages' ``convert_checkpoint``
    and a plain state-dict pickle through the port's: the same ``.npz``,
    at the flagship SNV widths."""
    import numpy as np

    from clairs_to_tpu.__main__ import SUBMODULES as jax_subs
    from clairs_to_tpu.models import bigru as jbigru
    from clairs_to_tpu.models import cvt as jcvt
    from clairs_to_tpu_torch.__main__ import SUBMODULES as torch_subs
    from clairs_to_tpu_torch.models.checkpoint import load_checkpoint_auto
    from test_torch_convert import reference_state_dict

    net = "cvt" if kind == "aff" else "bigru"
    config = jcvt.SNV_CVT_CONFIG if net == "cvt" else jbigru.SNV_BIGRU_CONFIG
    sd = {k: torch.from_numpy(v) for k, v in reference_state_dict(net, config).items()}
    module_pkl, sd_pkl = str(tmp_path / "module.pkl"), str(tmp_path / "state.pkl")
    torch.save({"model_acgt" if kind == "aff" else "model_nacgt": _PickledModule(sd)},
               module_pkl)
    torch.save(sd, sd_pkl)
    out = {}
    for tag, subs, pkl in (("jax", jax_subs, module_pkl), ("torch", torch_subs, module_pkl),
                           ("torch_state", torch_subs, sd_pkl)):
        path = str(tmp_path / f"{tag}.npz")
        assert subs["convert_checkpoint"](["--torch_pkl", pkl, "--kind", kind, "--mode", "snv",
                                           "--output", path]) == 0
        with np.load(path) as data:
            out[tag] = {k: data[k] for k in data.files}
    for tag in ("torch", "torch_state"):
        assert sorted(out[tag]) == sorted(out["jax"]) and "__arch__" in out[tag]
        assert all(np.array_equal(out[tag][k], out["jax"][k]) for k in out["jax"]), tag
    model, got = load_checkpoint_auto(path, kind=net, device="cpu")
    assert got.alleles == config.alleles
    assert sum(t.numel() for t in model.state_dict().values()) == sum(v.numel() for v in sd.values())


def test_compare_vcf_min_af_matches_jax(dense, chunk_vcfs):
    """compare_vcf's AF-aware path (bench/af_distribution.py recounts the
    tumor support of every truth site) in both packages."""
    from clairs_to_tpu.bench.compare import compare_vcf as jax_compare
    from clairs_to_tpu.genome.fasta import FastaFile as JaxFasta
    from clairs_to_tpu_torch.bench.compare import compare_vcf as torch_compare
    from clairs_to_tpu_torch.genome.fasta import FastaFile as TorchFasta

    kw = dict(ctg_name=dense["ctg"], min_af=0.2, tumor_bam_fn=dense["bam"])
    want = jax_compare(dense["truth"], chunk_vcfs["final"], fasta=JaxFasta(dense["fasta"]), **kw)
    got = torch_compare(dense["truth"], chunk_vcfs["final"], fasta=TorchFasta(dense["fasta"]), **kw)
    plain = torch_compare(dense["truth"], chunk_vcfs["final"], ctg_name=dense["ctg"])
    assert (got.tp, got.fp, got.fn, got.f1, got.best_cutoff) == (
        want.tp, want.fp, want.fn, want.f1, want.best_cutoff)
    assert got.tp_set == want.tp_set and got.fn_set == want.fn_set and got.tp > 0
    assert got.fn <= plain.fn


def test_simulation_profiles_match_jax():
    from clairs_to_tpu.bench.profiles import PROFILES as jax_profiles
    from clairs_to_tpu_torch.bench.profiles import PROFILES as torch_profiles

    assert torch_profiles == jax_profiles


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
        "import clairs_to_tpu_torch.bamio.simulate, clairs_to_tpu_torch.bamio.baq\n"
        "import clairs_to_tpu_torch.vcf.tabix, clairs_to_tpu_torch.vcf.reader\n"
        "import clairs_to_tpu_torch.postcall.hardfilter\n"
        "import clairs_to_tpu_torch.postcall.verdict_native\n"
        "import clairs_to_tpu_torch.postcall.haplotype\n"
        "import clairs_to_tpu_torch.postcall.realignment, clairs_to_tpu_torch.realign\n"
        "import clairs_to_tpu_torch.postcall.nonsomatic\n"
        "import clairs_to_tpu_torch.postcall.addback\n"
        "import clairs_to_tpu_torch.postcall.postprocess\n"
        "import clairs_to_tpu_torch.phasing.phaser, clairs_to_tpu_torch.phasing.external\n"
        "import clairs_to_tpu_torch.verdict.allele_counter\n"
        "import clairs_to_tpu_torch.verdict.resources, clairs_to_tpu_torch.verdict.logr_baf\n"
        "import clairs_to_tpu_torch.verdict.aspcf, clairs_to_tpu_torch.verdict.ascat\n"
        "import clairs_to_tpu_torch.verdict.tagging, clairs_to_tpu_torch.verdict.pipeline\n"
        "import clairs_to_tpu_torch.serve, clairs_to_tpu_torch.parallel.scheduler\n"
        "import clairs_to_tpu_torch.bench.compare, clairs_to_tpu_torch.bench.profiles\n"
        "import clairs_to_tpu_torch.bench.af_distribution\n"
        "import clairs_to_tpu_torch.infer.engine, clairs_to_tpu_torch.ops.gru\n"
        "import clairs_to_tpu_torch.train, clairs_to_tpu_torch.models.convert\n"
        "import clairs_to_tpu_torch.bench.synth, clairs_to_tpu_torch.bench.demo\n"
        "import clairs_to_tpu_torch.bench.grad_check\n"
        "from clairs_to_tpu_torch.__main__ import SUBMODULES\n"
        "assert {'train', 'convert_checkpoint'} <= set(SUBMODULES)\n"
        "assert clairs_to_tpu_torch.parallel.scheduler.init_distributed(None) == (1, 0)\n"
        "clairs_to_tpu_torch.serve.make_server('127.0.0.1', 0).server_close()\n"
        "assert clairs_to_tpu_torch.postcall.verdict_native.available()\n"
        "assert clairs_to_tpu_torch.realign.available()\n"
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
