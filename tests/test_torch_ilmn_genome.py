"""Illumina tumor-only calling, ``run -p ilmn`` with its default flags,
against the benchmark's plain reference of it
(``h100_bench/reference/genome_ilmn.py``) on the CPU at a small size:
every row of the four VCFs of a whole run, the ``Realignment`` tag, every
postfilter tag and ``SB`` included, at one chunk and at three; and the
run's ``realign_filter`` stage and realignment counters in its
``RunMetricsSummary``."""

import contextlib
import io
import os

import pytest
import torch

from h100_bench import run

CELL = "ilmn_flagship.genome_call"
GENOME = dict(run.load_json(run.BENCH, "workloads", CELL + ".json")["genome"],
              genome_len=100_000)
SEED = 3_000_000_001      # its genome holds a call certain to fail the realignment filter


@pytest.fixture(scope="module", params=[None, 40_000], ids=["one_chunk", "three_chunks"])
def cell(request, tmp_path_factory):
    over = {"genome": GENOME, "device_batch": 256}
    if request.param:
        args = run.load_json(run.BENCH, "workloads", CELL + ".json")["run_args"]
        i = args.index("--chunk_size")
        over["run_args"] = args[:i + 1] + [str(request.param)] + args[i + 2:]
    _man, cell, config, spec, driver = run.load_cell(CELL, over)
    ctx = run.Ctx(cell, config, spec, SEED, 0.0, False, torch.device("cpu"))
    ctx.cache = str(tmp_path_factory.mktemp("ilmn_cell"))
    with contextlib.redirect_stdout(io.StringIO()):
        state = driver.setup(ctx)
        driver.window(ctx, state)
    state = driver.release(ctx, state)
    return ctx, state, driver


def test_rows_equal_the_reference(cell):
    ctx, state, driver = cell
    rows = {k: driver.base.parse_vcf(b) for k, b in state["warm"]["bytes"].items()}
    tags = [t for r in rows["snv_pileup"] for t in r["FILTER"].split(";")]
    assert len(rows["snv_pileup"]) > 50 and rows["indel_pileup"]
    assert "Realignment" in tags and "NonSomatic" in tags
    assert all("SB=" in r["INFO"] for r in rows["snv_pileup"] if "Realignment" not in r["FILTER"])
    assert not any("H" in driver.base._info(r["INFO"]) for r in rows["snv_pileup"])
    assert dict(driver.readings(ctx, state)) == {
        "rows_wrong": 0, "candidates_gap": 0, "qual_excess": 0.0, "sb_gap": 0.0,
        "runs_unlike_warmup": 0}


def test_a_realignment_tag_the_program_left_out_is_wrong(cell):
    """The check reads the tag: the same run's rows with one
    ``Realignment`` tag taken off (QUAL back above 0) are wrong."""
    ctx, state, driver = cell
    exp = state["exp"]
    vcfs = {k: driver.base.parse_vcf(b) for k, b in state["warm"]["bytes"].items()}
    row = next(r for r in vcfs["snv_pileup"] if "Realignment" in r["FILTER"])
    row["FILTER"], row["QUAL"] = "PASS", 1.0
    row["INFO"] += ";SB=1.0"
    assert driver.judge(exp, vcfs)["rows_wrong"] >= 1


def test_the_realignment_stage_and_counters(cell):
    _ctx, state, driver = cell
    summary = state["warm"]["summary"]
    stages, counters = summary["stages"], summary["counters"]
    assert 0 < stages["realign_filter"] <= stages["hard_filters"]
    rows = driver.base.parse_vcf(state["warm"]["bytes"]["snv_pileup"])
    tagged = sum("Realignment" in r["FILTER"] for r in rows)
    assert counters["realign_failed"] == tagged > 0
    # every call under QUAL 8 is checked: the tagged ones and those left under 8
    under = sum(r["QUAL"] < 8 for r in rows if r["FILTER"] in ("PASS", "NonSomatic"))
    assert counters["realign_sites"] >= under + tagged
    assert counters["realign_reads"] > 50 * counters["realign_sites"]
    assert counters["realign_haplotypes"] >= counters["realign_sites"]


def test_run_without_the_realignment_library_raises(tmp_path, monkeypatch):
    """``run -p ilmn`` with its default flags raises when the realignment
    library does not build, and runs with ``--enable_realignment false``."""
    from clairs_to_tpu_torch import realign
    from clairs_to_tpu_torch.cli import run as cli
    from h100_bench.benchlib import genome_sim

    _g, files = genome_sim.load_or_make(SEED, dict(GENOME, genome_len=30_000), str(tmp_path))
    assert realign.available()
    broken = tmp_path / os.path.basename(realign.LIB.source)
    broken.write_text("this is not C++\n")
    for attr, value in (("source", str(broken)), ("so", str(tmp_path / "lib.so")),
                        ("cdll", None), ("fns", None), ("error", None)):
        monkeypatch.setattr(realign.LIB, attr, value)

    def call(*flags):
        args = cli.build_parser().parse_args(
            ["-T", files["bam"], "-R", files["fasta"], "-o", str(tmp_path / "out"), "-p", "ilmn",
             "--device", "cpu", "--disable_verdict", "--panel_of_normals", "None",
             "--device_batch", "256", *flags])
        with contextlib.redirect_stdout(io.StringIO()):
            return cli._main_impl(args)

    with pytest.raises(RuntimeError, match="realignment library"):
        call()
    assert call("--enable_realignment", "false") == 0
