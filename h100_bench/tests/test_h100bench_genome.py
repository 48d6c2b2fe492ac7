"""The genome cell's simulator and plain reference against the program, on
the CPU at a small size: the BAM reads back as the arrays it was written
from; the reference's AFF and NEG tensors and candidates equal the
program's decode of each chunk; the reference's VCF rows equal a whole
``run`` of the program."""

import os

import numpy as np
import pytest
import torch

from h100_bench import run
from h100_bench.benchlib import genome_sim
from h100_bench.reference import genome as ref_genome

GENOME = dict(run.load_json(run.BENCH, "workloads", "ont_flagship.genome_call.json")["genome"],
              genome_len=30_000, n_snv=6, n_indel=6)
SEEDS = (2 ** 31 + 11, 2 ** 33 + 5)


@pytest.fixture(scope="module", params=SEEDS)
def made(request, tmp_path_factory):
    g, files = genome_sim.load_or_make(request.param, GENOME,
                                       str(tmp_path_factory.mktemp("genome")))
    return request.param, g, files


def test_the_same_seed_gives_the_same_genome(made):
    seed, g, _files = made
    again = genome_sim.simulate(seed, GENOME)
    for key in ("genome", "var_pos", "start", "rev", "seq", "qual", "ind_seq", "cig_len", "pon"):
        assert np.array_equal(getattr(g, key), getattr(again, key))
    assert len(g.var_pos) == 6 + 6 + 30_000 // 300 and len(g.start) == 30_000 * 60 // 500


def test_the_bam_reads_back_as_the_arrays(made):
    from clairs_to_tpu_torch.bamio.bam import BamFile

    _seed, g, files = made
    reads = list(BamFile(files["bam"]).fetch(g.contig, 0, len(g.genome)))
    assert len(reads) == len(g.start)
    assert [r.pos for r in reads] == g.start[g.order].tolist()
    plain = {int(r): i for i, r in enumerate(g.plain)}
    for r in reads[::97]:
        k = int(r.name[1:])
        assert r.is_reverse == bool(g.rev[k]) and r.mapq == 60
        if k in plain:
            assert r.seq == genome_sim.BASES[g.seq[plain[k]]].tobytes().decode()
            assert list(r.qual) == g.qual[plain[k]].tolist()
            assert list(r.cigar_ops) == [0] and list(r.cigar_lens) == [g.seq.shape[1]]


@pytest.mark.parametrize("view", ["aff", "neg"])
def test_reference_tensors_and_candidates_equal_the_decode(made, view):
    from clairs_to_tpu_torch.genome.chunks import plan_chunks
    from clairs_to_tpu_torch.genome.fasta import FastaFile
    from clairs_to_tpu_torch.infer.pipeline import CallingPipeline, PipelineOptions

    _seed, g, files = made
    pile = ref_genome.Pileup(g, "cpu")
    counts, depth = pile.channel_counts(pile.rules.min_bq if view == "aff" else 0)
    want = pile.encode(counts)
    snv, indel = pile.candidates(*pile.channel_counts(pile.rules.min_bq))
    fasta = FastaFile(files["fasta"])
    pipe = CallingPipeline(fasta, files["bam"], None, None,
                           PipelineOptions(platform="ont", indel_min_af=0.1,
                                           select_indel_candidates=True))
    got_snv, got_indel = [], []
    for chunk in plan_chunks(fasta, chunk_size=12_000):
        pe, aff, neg, lo, hi = pipe.build_chunk_views(chunk)
        got = aff if view == "aff" else neg
        assert np.array_equal(got[:, :34], want[lo:hi])
        s, i, _ = pe.find_candidates(chunk.ctg_start, chunk.ctg_end, min_bq=pipe.aff_min_bq,
                                     indel_min_af=0.1, select_indel_candidates=True,
                                     with_infos=False)
        inside = lambda p: p - 16 >= lo and p + 17 <= hi  # noqa: E731
        got_snv += [p for p in s if inside(p)]
        got_indel += [p for p in i if inside(p)]
        pipe.evict_views(chunk)
    assert got_snv == snv and got_indel == indel and snv and indel


@pytest.mark.parametrize("chunk_size", [None, 12_000])
def test_reference_rows_equal_a_whole_run(made, chunk_size):
    """At the cell's flags (one chunk here) and at three chunks, whose
    phasers and filters run apart."""
    _seed, g, files = made
    over = {"genome": GENOME, "device_batch": 256}
    if chunk_size:
        args = run.load_json(run.BENCH, "workloads", "ont_flagship.genome_call.json")["run_args"]
        over["run_args"] = args[:args.index("--chunk_size") + 1] + [str(chunk_size)] + \
            args[args.index("--chunk_size") + 2:]
    _man, cell, config, spec, driver = run.load_cell("ont_flagship.genome_call", over)
    ctx = run.Ctx(cell, config, spec, _seed, 0.0, False, torch.device("cpu"))
    ctx.cache = os.path.dirname(os.path.dirname(files["bam"]))
    state = driver.setup(ctx)
    driver.window(ctx, state)
    state = driver.release(ctx, state)
    exp = driver._expected(ctx, state)
    rows = {k: driver.parse_vcf(b) for k, b in state["warm"]["bytes"].items()}
    assert len(rows["snv_pileup"]) > 20 and rows["indel_pileup"]
    tags = [t for r in rows["snv_pileup"] for t in r["FILTER"].split(";")]
    assert sum("H" in driver._info(r["INFO"]) for r in rows["snv_pileup"]) > 20
    assert "MultiHap" in tags and "VariantCluster" in tags
    assert dict(driver.readings(ctx, state, exp)) == {
        "rows_wrong": 0, "candidates_gap": 0, "qual_excess": 0.0, "sb_gap": 0.0,
        "runs_unlike_warmup": 0}


def _read_model(bam, contig, genome, variant_pos):
    """Substitution errors a base by strand (at reads without an indel, off
    the planted sites), the mean base quality and the share under 20."""
    from clairs_to_tpu_torch.bamio.bam import BamFile

    planted = np.zeros(len(genome), bool)
    planted[np.asarray(variant_pos, np.int64)] = True
    err, n, quals = np.zeros(2), np.zeros(2), []
    for r in BamFile(bam).fetch(contig, 0, len(genome)):
        if list(r.cigar_ops) != [0]:
            continue
        seq = np.frombuffer(r.seq.encode(), np.uint8)
        span = slice(r.pos, r.pos + len(seq))
        off = ~planted[span]
        k = int(r.is_reverse)
        err[k] += np.count_nonzero((seq != genome[span]) & off)
        n[k] += np.count_nonzero(off)
        quals.append(np.asarray(r.qual, np.int64))
    q = np.concatenate(quals)
    return err / n, q.mean(), (q < 20).mean()


def test_both_simulators_draw_the_same_read_model(tmp_path):
    """``benchlib/genome_sim.py`` against the repository's simulator it was
    copied from (``bamio/simulate.py::make_dataset``, ``bench/profiles.py``'s
    ``ont`` model) at one recipe: the same error rate on each strand, the
    same base qualities, and as many SNV candidates, to the noise of two
    random streams."""
    from clairs_to_tpu_torch.bamio.simulate import make_dataset
    from clairs_to_tpu_torch.bench.profiles import PROFILES
    from clairs_to_tpu_torch.genome.chunks import plan_chunks
    from clairs_to_tpu_torch.genome.fasta import FastaFile
    from clairs_to_tpu_torch.infer.pipeline import CallingPipeline, PipelineOptions

    p = dict(GENOME, genome_len=60_000, n_snv=6, n_indel=6)
    model = {k: v for k, v in PROFILES["ont"].items() if k != "coverage"}
    ds = make_dataset(str(tmp_path / "original"), seed=3, genome_len=p["genome_len"],
                      coverage=p["coverage"], n_snv=6, n_indel=6,
                      n_germline=p["genome_len"] // p["germline_every"],
                      somatic_hap_aware=True, **model)
    g, files = genome_sim.load_or_make(3, p, str(tmp_path / "copy"))
    seen = {}
    for name, bam, fasta, contig, genome, planted in (
            ("original", ds["bam"], ds["fasta"], ds["ctg"],
             np.frombuffer(ds["genome"].encode(), np.uint8), [v.pos for v in ds["variants"]]),
            ("copy", files["bam"], files["fasta"], g.contig,
             genome_sim.BASES[g.genome], g.var_pos)):
        rates, mean_q, low_q = _read_model(bam, contig, genome, planted)
        fa = FastaFile(fasta)
        pipe = CallingPipeline(fa, bam, None, None, PipelineOptions(platform="ont"))
        (chunk,) = plan_chunks(fa)
        pe = pipe.build_chunk_views(chunk)[0]
        snv = pe.find_candidates(chunk.ctg_start, chunk.ctg_end, min_bq=pipe.aff_min_bq,
                                 with_infos=False)[0]
        seen[name] = (rates, mean_q, low_q, len(snv))
    (r0, q0, l0, c0), (r1, q1, l1, c1) = seen["original"], seen["copy"]
    assert np.allclose(r1, r0, rtol=0.1) and r1[1] > 1.3 * r1[0]
    assert abs(q1 - q0) < 0.02 * q0 and abs(l1 - l0) < 0.1 * l0
    assert abs(c1 - c0) < 0.1 * c0

