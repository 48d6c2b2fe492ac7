"""``clairs_to_tpu_torch run --device cpu`` against ``clairs_to_tpu run`` on
the run paths that tests/test_torch_cli.py leaves out: a multi-contig genome
with ``-c``, ``-r``, ``-b`` and the indel regions, ``--resume`` and
``--skip_steps``, the debug dumps, ``--dry_run``, the thresholds, the filter
switches, the output prefixes, the model-path overrides, the phaser and PoN
fallbacks, ``--trace_dir``, ``--aspcf_penalty`` and ``-v``; the host
subcommands' remaining flags, ``serve --host --preload``; and every parser
of both dispatchers, flag by flag."""

import argparse
import os
import threading

import pytest
import torch

import jax_native_libs
from clairs_to_tpu import serve as jax_serve
from clairs_to_tpu.bamio import simulate
from clairs_to_tpu.cli import run as jax_run
from clairs_to_tpu.cli.run import main as jax_main
from clairs_to_tpu_torch import serve as torch_serve
from clairs_to_tpu_torch.cli import run as torch_run
from clairs_to_tpu_torch.cli.run import main as torch_main
from test_torch_cli import DATASETS, DEMO, DENSE, _args, _rows, _run_both, _write_pon
from test_torch_scheduler import free_port
from test_torch_serve import _health, _post

torch.set_num_threads(1)

# the genome of tests/test_multicontig.py, with indels: 3 contigs of 25 kb,
# three chunks of 8,334 bases each under --chunk_size 10000
MULTI = dict(n_contigs=3, seed=6, genome_len=25_000, n_snv=8, n_indel=3, n_germline=4,
             coverage=50)
CHUNK = ["--chunk_size", "10000"]


@pytest.fixture(scope="module", autouse=True)
def _jax_native_libs():
    """The JAX side runs on its C++ libraries (tests/jax_native_libs.py)."""
    jax_native_libs.load_all()


@pytest.fixture(scope="module")
def multi(tmp_path_factory):
    return simulate.make_multi_contig_dataset(str(tmp_path_factory.mktemp("runpaths_multi")),
                                              **MULTI)


@pytest.fixture(scope="module")
def indels(tmp_path_factory):
    return simulate.make_dataset(str(tmp_path_factory.mktemp("runpaths_indels")),
                                 **DATASETS["indels"])


@pytest.fixture(scope="module")
def dense(tmp_path_factory):
    ds = simulate.make_dataset(str(tmp_path_factory.mktemp("runpaths_dense")), **DENSE)
    ds["pon"] = _write_pon(ds, os.path.join(os.path.dirname(ds["bam"]), "pon.vcf"),
                           indexed=True)
    return ds


@pytest.fixture(scope="module")
def baseline(multi, indels, tmp_path_factory):
    """The port's rows with the default flags, per dataset name, for the
    cases that must remove rows or give the same rows by another route."""
    out = tmp_path_factory.mktemp("runpaths_baseline")
    rows = {}
    for name, ds, extra in (("multi", multi, CHUNK), ("indels", indels, [])):
        d = str(out / name)
        assert torch_main(_args(ds, d) + extra + ["--device", "cpu"]) == 0
        rows[name] = {n: _rows(os.path.join(d, n)) for n in ("snv.vcf", "indel.vcf")}
    return rows


def _bed(path, intervals):
    with open(path, "w") as f:
        f.writelines(f"{c}\t{s}\t{e}\n" for c, s, e in intervals)
    return path


def _inside(rows, intervals):
    """Every row's 1-based POS lies in one of the 0-based half-open
    intervals."""
    return all(any(r[0][0] == c and s < r[0][1] <= e for c, s, e in intervals) for r in rows)


def _passing(rows):
    return [r for r in rows if r[0][4] == "PASS"]


BED = [("chr1", 2_000, 14_000), ("chr3", 6_000, 21_000)]
INDEL_BED = [("chr1", 2_000, 9_000), ("chr3", 12_000, 21_000)]


def _model_paths(ds, tmp):
    flags = []
    for mode, sub in (("snv", ""), ("indel", "indel")):
        for kind, name in (("affirmative", "aff.npz"), ("negational", "neg.npz")):
            flags += [f"--{mode}_pileup_{kind}_model_path", os.path.join(DEMO, sub, name)]
        flags += [f"--{mode}_likelihood_matrix_data",
                  os.path.join(DEMO, sub, "likelihood_matrix.txt")]
    return flags


# case: (dataset, flags given the dataset and the test's tmp_path; "{out}"
# in a flag becomes the package's output directory)
CASES = {
    # (a) a subset of the contigs, and every contig
    "contigs": ("multi", lambda ds, tmp: CHUNK + ["-c", "chr1,chr3"]),
    "include_all_ctgs": ("multi", lambda ds, tmp: CHUNK + ["--include_all_ctgs"]),
    # (b) a region with the indel regions, and a BED with them
    "region": ("multi", lambda ds, tmp: CHUNK + [
        "-r", "chr3:6001-21000",
        "--call_indels_only_in_these_regions", _bed(str(tmp / "indel.bed"), INDEL_BED)]),
    "bed": ("multi", lambda ds, tmp: CHUNK + [
        "-b", _bed(str(tmp / "calls.bed"), BED),
        "--call_indels_only_in_these_regions", _bed(str(tmp / "indel.bed"), INDEL_BED)]),
    # (d) the debug dumps, beside the output directories
    "dumps": ("multi", lambda ds, tmp: CHUNK + [
        "--alt_fn", "{out}.alt.tsv", "--output_depth", "true", "--output_alt_info", "true",
        "--predict_fn", "{out}.predict"]),
    # (f) the thresholds; -q supersedes --qual_indel and the four cutoffs, so
    # those run in a case of their own
    "thresholds": ("indels", lambda ds, tmp: [
        "--snv_min_af", "0.12", "--indel_min_af", "0.2", "--min_coverage", "30",
        "--min_bq", "20", "-q", "12"]),
    "qual_cutoffs": ("indels", lambda ds, tmp: [
        "--qual_indel", "14", "--qual_cutoff_phaseable_region", "12",
        "--qual_cutoff_unphaseable_region", "16", "--qual_indel_cutoff_phaseable_region", "12",
        "--qual_indel_cutoff_unphaseable_region", "16", "--max_indel_length", "3"]),
    # (g) the filter switches
    "pon_switches": ("dense", lambda ds, tmp: [
        "--panel_of_normals", ds["pon"], "--panel_of_normals_require_allele_matching", "False",
        "--do_not_print_nonsomatic_calls", "--disable_read_start_end_filtering"]),
    "nonsomatic_off": ("dense", lambda ds, tmp: [
        "--panel_of_normals", ds["pon"], "--disable_nonsomatic_tagging",
        "--phase_tumor", "false", "--apply_haplotype_filtering", "true"]),
    "postfilter_ont": ("indels", lambda ds, tmp: [
        "--apply_haplotype_filtering", "false", "--enable_postfilter", "true",
        "--enable_realignment", "true"]),
    # (h) the output prefixes, the intermediate directory removed
    "prefixes": ("indels", lambda ds, tmp: [
        "--snv_output_prefix", "somatic_snv", "--indel_output_prefix", "somatic_indel",
        "--remove_intermediate_dir"]),
    # (i) every network and matrix by its own flag, no --model_dir
    "model_paths": ("indels", _model_paths),
    # (j) no whatshap binary: both fall back to the internal phaser
    "whatshap_absent": ("dense", lambda ds, tmp: [
        "--use_whatshap_for_intermediate_phasing", "True",
        "--whatshap", str(tmp / "no_such_binary")]),
    # (l) a profiler trace of the calling loop
    "trace_dir": ("indels", lambda ds, tmp: ["--trace_dir", "{out}.trace"]),
    # (m) the segmentation penalty of Verdict, on a genome where Verdict runs
    "aspcf_penalty": ("dense", lambda ds, tmp: ["--aspcf_penalty", "50"]),
}


def _outputs(out_dir):
    """The files a run wrote, its log aside."""
    return {os.path.relpath(os.path.join(root, n), out_dir)
            for root, _, names in os.walk(out_dir) for n in names
            if not n.startswith("run_clairs_to_tpu")}


@pytest.mark.parametrize("case", sorted(CASES))
def test_run_flags_match_jax_cli(case, multi, indels, dense, baseline, tmp_path, capsys):
    """Both CLIs with the case's flags: the same files, the same rows,
    FILTER, INFO, GT and sample fields, QUAL within 0.01 (as the cases of
    tests/test_torch_cli.py), and what the flags must do."""
    ds_name, flags_of = CASES[case]
    ds = {"multi": multi, "indels": indels, "dense": dense}[ds_name]
    flags = flags_of(ds, tmp_path)

    def argv_of(out):
        argv = _args(ds, out)
        if case == "model_paths":   # no --model_dir
            argv = argv[:-4] + argv[-2:]
        return argv + [f.format(out=out) for f in flags]

    if case == "prefixes":
        got = _run_prefixes(argv_of, tmp_path)
    else:
        got, tdir, verdict = _run_both(argv_of, tmp_path)
    out = capsys.readouterr().out
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "torch")
    snv, indel = got.get("snv.vcf", []), got.get("indel.vcf", [])
    ctgs = {r[0][0] for r in snv + indel}
    assert _outputs(jdir) == _outputs(tdir)
    if case == "contigs":
        assert ctgs == {"chr1", "chr3"}
        assert out.count("chr1 chunk 3/3") == out.count("chr3 chunk 3/3") == 2
        assert "chr2 chunk" not in out
    elif case == "include_all_ctgs":
        assert ctgs == {"chr1", "chr2", "chr3"}
        assert [r[0] for r in snv] == [r[0] for r in baseline["multi"]["snv.vcf"]]
    elif case == "region":
        for d in (jdir, tdir):
            assert open(os.path.join(d, "tmp", "region.bed")).read() == "chr3\t6000\t21000\n"
        assert snv and _inside(snv + indel, [("chr3", 6_000, 21_000)])
        assert _inside(indel, INDEL_BED)
    elif case == "bed":
        assert snv and _inside(snv + indel, BED) and _inside(indel, INDEL_BED)
        assert ctgs == {"chr1", "chr3"}
    elif case == "dumps":
        alt = [open(d + ".alt.tsv", "rb").read() for d in (jdir, tdir)]
        assert alt[0] == alt[1] and alt[1].count(b"\n") >= len(snv) > 0
        assert all(len(l.split(b"\t")) == 7 for l in alt[1].splitlines())
        for mode in ("snv", "indel"):
            want, got_p = (open(f"{d}.predict.{mode}").read().splitlines() for d in (jdir, tdir))
            _same_probabilities(want, got_p)
    elif case == "thresholds":
        for name, rows in (("snv.vcf", snv), ("indel.vcf", indel)):
            assert len(_passing(rows)) < len(_passing(baseline["indels"][name])), name
    elif case == "qual_cutoffs":
        assert len(_passing(snv)) < len(_passing(baseline["indels"]["snv.vcf"]))
        assert len(indel) < len(baseline["indels"]["indel.vcf"])
        assert all(max(len(r[0][2]), len(r[0][3])) <= 4 for r in indel)
    elif case == "pon_switches":
        assert snv and not any("NonSomatic" in r[0][4] for r in snv)
        assert any(r[0][6].startswith("H;") for r in snv)
    elif case == "nonsomatic_off":
        assert snv and not any("NonSomatic" in r[0][4] for r in snv)
        assert any(";SB=" in r[0][6] for r in snv)
    elif case == "postfilter_ont":
        assert any(";SB=" in r[0][6] for r in snv)
        assert not any(r[0][6].startswith("H") for r in snv)
    elif case == "prefixes":
        assert got["somatic_snv.vcf"] and not os.path.exists(os.path.join(tdir, "tmp"))
    elif case == "model_paths":
        assert "Using default model assets" in out
        for name, rows in (("snv.vcf", snv), ("indel.vcf", indel)):
            assert [r[0] for r in rows] == [r[0] for r in baseline["indels"][name]], name
    elif case == "whatshap_absent":
        assert out.count("falling back to the internal phaser") == 2
        assert any(r[0][6].startswith("H;") for r in snv)
    elif case == "trace_dir":
        assert os.path.getsize(os.path.join(tdir + ".trace", "trace.json")) > 0
        assert os.listdir(jdir + ".trace")
    elif case == "aspcf_penalty":
        assert verdict and "skipped" not in verdict[0], verdict


def _same_probabilities(want, got):
    """The --predict_fn dumps: the same sites and strand counts, byte for
    byte; the probabilities follow the float32 forward (within 1e-5)."""
    assert len(want) == len(got) and want
    for a, b in zip(want, got):
        a, b = a.split("\t"), b.split("\t")
        assert a[:6] == b[:6]
        pa = [float(x) for col in a[6:] for x in col.split()]
        pb = [float(x) for col in b[6:] for x in col.split()]
        assert len(pa) == len(pb) and max(abs(x - y) for x, y in zip(pa, pb)) <= 1e-5


def _run_prefixes(argv_of, tmp_path):
    """_run_both for outputs under other names: both CLIs, the same rows
    under the prefixes' names, their .gz and .tbi beside them."""
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "torch")
    assert jax_main(argv_of(jdir)) == 0
    assert torch_main(argv_of(tdir) + ["--device", "cpu"]) == 0
    got = {}
    for name in ("somatic_snv.vcf", "somatic_indel.vcf"):
        want, rows = _rows(os.path.join(jdir, name)), _rows(os.path.join(tdir, name))
        assert [r[0] for r in rows] == [r[0] for r in want], name
        assert max((abs(a[1] - b[1]) for a, b in zip(want, rows)), default=0.0) <= 0.01
        for d in (jdir, tdir):
            assert os.path.exists(os.path.join(d, name + ".gz.tbi"))
            assert not os.path.exists(os.path.join(d, "snv.vcf"))
        got[name] = rows
    return got


def test_resume_and_skip_steps_match_jax_cli(multi, tmp_path, capsys):
    """(c) A run; one chunk's shards deleted; the same command with
    ``--resume``, then with ``--skip_steps``: both packages redo that chunk
    alone, report the other eight as resumed and give the first run's rows."""
    def argv_of(out):
        return _args(multi, out) + CHUNK

    first, _tdir, _verdict = _run_both(argv_of, tmp_path)
    first = {tag: {n: _rows(str(tmp_path / tag / n)) for n in ("snv.vcf", "indel.vcf")}
             for tag in ("jax", "torch")}
    for extra in (["--resume"], ["--skip_steps", "1,3"]):
        for tag, main, device in (("jax", jax_main, []),
                                  ("torch", torch_main, ["--device", "cpu"])):
            for kind in ("snv", "indel"):
                os.remove(str(tmp_path / tag / "tmp" / "vcf_output" / f"p_{kind}_chr2_1.vcf"))
            capsys.readouterr()
            assert main(argv_of(str(tmp_path / tag)) + extra + device) == 0
            out = capsys.readouterr().out
            done = [l for l in out.splitlines() if " chunk " in l and "/3: " in l]
            assert len(done) == 9 and sum("resumed from existing output" in l
                                          for l in done) == 8, (tag, extra, done)
            assert any(l.startswith("[INFO] chr2 chunk 2/3: ") and "SNV rows" in l
                       for l in done), (tag, extra, done)
            for name in ("snv.vcf", "indel.vcf"):
                assert _rows(str(tmp_path / tag / name)) == first[tag][name], (tag, extra)


def test_dry_run_matches_jax_cli(multi, tmp_path, capsys):
    """(e) The same chunk list."""
    plans = []
    for tag, main, extra in (("jax", jax_main, []), ("torch", torch_main, ["--device", "cpu"])):
        capsys.readouterr()
        assert main(_args(multi, str(tmp_path / tag)) + CHUNK + ["--dry_run"] + extra) == 0
        out = capsys.readouterr().out
        plans.append([l for l in out.splitlines() if l.startswith(("[DRY RUN]", "  "))])
        assert not os.path.exists(str(tmp_path / tag / "snv.vcf"))
    assert plans[0] == plans[1]
    assert plans[1][0] == "[DRY RUN] 9 chunks:" and plans[1][-1] == "  chr3:16669-25000"


def test_pon_resource_dir_without_databases_matches_jax_cli(indels, tmp_path):
    """(k) An empty --pon_resource_dir: the same exit, the same message."""
    empty = tmp_path / "pon_dir"
    empty.mkdir()
    codes = []
    for tag, main, extra in (("jax", jax_main, []), ("torch", torch_main, ["--device", "cpu"])):
        with pytest.raises(SystemExit) as e:
            main(_args(indels, str(tmp_path / tag)) + ["--pon_resource_dir", str(empty)] + extra)
        codes.append(e.value.code)
    assert codes[0] == codes[1]
    assert codes[1].startswith("[ERROR] file ") and codes[1].endswith(" not found")
    assert str(empty / "gnomad.r2.1.af-ge-0.001.sites.vcf.gz") in codes[1]


def test_version_matches_jax_cli(capsys):
    """(n) The same version line, the package name aside."""
    lines = []
    for main in (jax_main, torch_main):
        with pytest.raises(SystemExit) as e:
            main(["-v"])
        assert e.value.code == 0
        lines.append(capsys.readouterr().out.strip())
    assert lines[1].startswith("clairs_to_tpu_torch ")
    assert lines[1].replace("clairs_to_tpu_torch ", "clairs_to_tpu ", 1) == lines[0]


# --- the host subcommands' remaining flags and serve ----------------------

@pytest.fixture(scope="module")
def run_vcfs(multi, tmp_path_factory):
    """A multi-contig run's chunk shards, merged and final VCFs, a PoN of
    the germline sites and a BED."""
    out = tmp_path_factory.mktemp("runpaths_subcommands")
    run = str(out / "run")
    assert torch_main(_args(multi, run) + CHUNK + ["--device", "cpu"]) == 0
    with open(multi["germline"]) as f:
        germ = f.read()
    with open(out / "pon.vcf", "w") as f:
        f.write(germ)
    shards = os.path.join(run, "tmp", "vcf_output")
    return dict(shards=shards, snv_merged=os.path.join(shards, "snv_pileup.vcf"),
                indel_merged=os.path.join(shards, "indel_pileup.vcf"),
                indel=os.path.join(run, "indel.vcf"), snv=os.path.join(run, "snv.vcf"),
                pon=str(out / "pon.vcf"), bed=_bed(str(out / "calls.bed"), BED))


SUBCOMMAND_FLAGS = {
    "sort_vcf": lambda ds, v, out: [
        "--input_dir", v["shards"], "--vcf_fn_prefix", "p_indel_", "--vcf_fn_suffix", "_0.vcf",
        "--output_fn", f"{out}/o.vcf"],
    "nonsomatic_tagging": lambda ds, v, out: [
        "--pileup_vcf_fn", v["snv_merged"], "--output_vcf_fn", f"{out}/o.vcf",
        "--panel_of_normals", v["pon"], "--skip_pon_md5"],
    "postprocess_vcf": lambda ds, v, out: [
        "--pileup_vcf_fn", v["indel_merged"], "--output_fn", f"{out}/o.vcf", "--platform",
        "ont", "--ref_fn", ds["fasta"], "--sample_name", "TUMOR_1", "--af", "0.15",
        "--is_indel"],
    "compare_vcf": lambda ds, v, out: [
        "--truth_vcf_fn", ds["truth"], "--input_vcf_fn", v["indel"], "--bed_fn", v["bed"],
        "--truth_filter_tag", "PASS", "--benchmark_indel"],
}


@pytest.mark.parametrize("name", sorted(SUBCOMMAND_FLAGS))
def test_subcommand_flags_match_jax(name, multi, run_vcfs, tmp_path, capsys):
    """The twin of tests/test_torch_cli.py::test_subcommand_matches_jax for
    the flags that its cases leave out: the same lines printed, the same
    files written, byte for byte."""
    from clairs_to_tpu.__main__ import SUBMODULES as jax_subs
    from clairs_to_tpu_torch.__main__ import SUBMODULES as torch_subs

    printed, files = [], []
    for tag, subs in (("jax", jax_subs), ("torch", torch_subs)):
        out = tmp_path / tag
        out.mkdir()
        capsys.readouterr()
        assert subs[name](SUBCOMMAND_FLAGS[name](multi, run_vcfs, str(out))) == 0
        printed.append(capsys.readouterr().out.replace(str(out), "OUT"))
        files.append({n: (out / n).read_bytes() for n in os.listdir(out)})
    assert printed[0] == printed[1]
    assert files[0] == files[1]
    if name == "compare_vcf":
        assert "Precision" in printed[1] and not files[1]
    else:
        body = [l for l in files[1]["o.vcf"].decode().splitlines() if not l.startswith("#")]
        assert body
    if name == "sort_vcf":
        # the first of each contig's three chunks: 1-8334
        assert all(int(l.split("\t")[1]) <= 8_334 for l in body)
    elif name == "postprocess_vcf":
        header = [l for l in files[1]["o.vcf"].decode().splitlines() if l.startswith("#CHROM")]
        assert header[0].endswith("\tTUMOR_1")
        assert all(len(l.split("\t")[3]) != len(l.split("\t")[4]) for l in body)
    elif name == "nonsomatic_tagging":
        assert "NonSomatic" in files[1]["o.vcf"].decode() and "tagged=" in printed[1]


def _serve_main_on_thread(module, argv, monkeypatch):
    """A package's ``serve`` main on a thread, until its server is bound;
    returns (base url, the server, stop)."""
    made, bound = [], threading.Event()
    real = module.ThreadingHTTPServer

    def recorded(*args, **kwargs):
        made.append(real(*args, **kwargs))
        bound.set()
        return made[-1]

    monkeypatch.setattr(module, "ThreadingHTTPServer", recorded)
    result = {}
    thread = threading.Thread(target=lambda: result.setdefault("rc", module.main(argv)),
                              daemon=True)
    thread.start()
    assert bound.wait(timeout=300), "the server did not start"
    srv = made[0]

    def stop():
        srv.shutdown()
        thread.join(timeout=60)
        srv.server_close()
        assert not thread.is_alive() and result["rc"] == 0
    return f"http://127.0.0.1:{srv.server_address[1]}", srv, stop


def test_serve_host_and_preload_match_jax(indels, tmp_path, monkeypatch):
    """``serve --host localhost --port P --preload ont`` in both packages
    (the port's with ``--device cpu``): each lists one engine before any
    request, its first request finds the preloaded engines, and the two
    answers hold the same rows."""
    monkeypatch.setattr(jax_run, "default_model_dir", lambda platform, warn=True: DEMO)
    monkeypatch.setattr(torch_run, "default_model_dir", lambda platform, warn=True: DEMO)
    monkeypatch.setattr(jax_serve, "_ENGINES", {})
    answers = []
    for tag, module, extra in (("jax", jax_serve, []), ("torch", torch_serve,
                                                       ["--device", "cpu"])):
        port = free_port()
        base, srv, stop = _serve_main_on_thread(
            module, ["--host", "localhost", "--port", str(port), "--preload", "ont"] + extra,
            monkeypatch)
        try:
            assert srv.server_address == ("127.0.0.1", port)
            assert len(_health(base)["engines"]) == 1
            argv = ["-T", indels["bam"], "-R", indels["fasta"], "-p", "ont", "-t", "2",
                    "--disable_verdict", "-o", str(tmp_path / tag)] + extra
            status, answer = _post(base, {"argv": argv})
            assert status == 200 and len(_health(base)["engines"]) == 1
            answers.append(answer)
        finally:
            stop()
    for r in answers:
        assert r["returncode"] == 0 and r["engines_cached"] is True, r
    want, got = _rows(answers[0]["snv_vcf"]), _rows(answers[1]["snv_vcf"])
    assert want and [r[0] for r in got] == [r[0] for r in want]
    assert max(abs(a[1] - b[1]) for a, b in zip(want, got)) <= 0.01


# --- every parser, flag by flag -------------------------------------------

class _Parsed(Exception):
    def __init__(self, parser):
        super().__init__(parser.prog)
        self.parser = parser


def _parsers(package, monkeypatch):
    """{subcommand: the ArgumentParser it builds} of a package's dispatcher,
    each caught at its ``parse_args``."""
    import importlib

    subs = importlib.import_module(f"{package}.__main__").SUBMODULES

    def catch(self, args=None, namespace=None):
        raise _Parsed(self)

    out = {}
    with monkeypatch.context() as m:
        m.setattr(argparse.ArgumentParser, "parse_args", catch)
        for name, fn in subs.items():
            with pytest.raises(_Parsed) as e:
                fn([])
            out[name] = e.value.parser
    return out


def _flags(parser):
    """{option strings: what argparse does with the flag}."""
    return {tuple(a.option_strings): dict(
        dest=a.dest, default=a.default, type=a.type, choices=a.choices, nargs=a.nargs,
        action=type(a).__name__, required=a.required, const=a.const)
        for a in parser._actions}


def test_every_parser_matches_jax(monkeypatch):
    """Every parser of both dispatchers (``run``'s build_parser, each host
    subcommand's, ``serve``'s, ``train``'s, ``convert_checkpoint``'s): the
    same flags with the same dest, default, type, choices, nargs, action and
    required.  The one flag of the port's own is ``--device``, on ``run``,
    ``serve`` and ``train``, which defaults to ``cuda``."""
    jax_parsers = _parsers("clairs_to_tpu", monkeypatch)
    torch_parsers = _parsers("clairs_to_tpu_torch", monkeypatch)
    assert sorted(jax_parsers) == sorted(torch_parsers)
    assert _flags(jax_run.build_parser()) == _flags(jax_parsers["run"])
    assert _flags(torch_run.build_parser()) == _flags(torch_parsers["run"])
    n_flags = 0
    for name in sorted(jax_parsers):
        want, got = _flags(jax_parsers[name]), _flags(torch_parsers[name])
        device = got.pop(("--device",), None)
        if name in ("run", "serve", "train"):
            assert device == dict(dest="device", default="cuda", type=None,
                                  choices=["cuda", "cpu"], nargs=None, action="_StoreAction",
                                  required=False, const=None), name
        else:
            assert device is None, name
        assert sorted(got) == sorted(want), name
        for flag in want:
            assert got[flag] == want[flag], (name, flag)
        n_flags += len(want)
    assert len(_flags(jax_parsers["run"])) > 90 and n_flags > 150
