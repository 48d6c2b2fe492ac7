"""The port's per-chunk filter stages against the JAX package's: the Fisher
tests, the phaser and its haplotags, the external-phaser plumbing, the
9-verdict haplotype filter, the 4-verdict hard filter and the Illumina
realignment filter.

The JAX side always runs on its C++ libraries: ``_mod`` makes sure of them
(tests/jax_native_libs.py), so a cold parallel build in another test
process cannot leave it on its numpy fallback.  One simulated chunk is decoded by each package's own decoder (the fused
window decode and the full entry table), and the same sites go through each
package's engines.  Everything discrete is held to equality; the Fisher
p-value to 1e-12 (it is the same float64 arithmetic, so it is equal in
practice).  Each engine runs with the C++ verdict library and with it
forced off."""

import importlib
import os
import stat

import numpy as np
import pytest

import jax_native_libs
from clairs_to_tpu.bamio import simulate

PKGS = ("clairs_to_tpu", "clairs_to_tpu_torch")


def _mod(pkg, name):
    if pkg == "clairs_to_tpu":
        jax_native_libs.load_all()
    return importlib.import_module(f"{pkg}.{name}")


def _both(name):
    return tuple(_mod(p, name) for p in PKGS)


def test_native_libraries_build_and_load():
    from clairs_to_tpu_torch import realign
    from clairs_to_tpu_torch.bamio import native
    from clairs_to_tpu_torch.postcall import verdict_native

    assert native.available() and verdict_native.available() and realign.available()
    # each loads the library that lies beside its own source, not the other package's
    for mod in (realign, verdict_native):
        assert os.path.dirname(mod._SO) == os.path.dirname(os.path.abspath(mod.__file__))


def test_failed_jax_library_load_is_rebuilt(tmp_path, monkeypatch):
    """A JAX loader that read a library another process was still writing
    keeps the error; the tests' helper rebuilds it under its lock and loads
    it again, leaving no temporary file."""
    mod = importlib.import_module("clairs_to_tpu.realign")
    so = tmp_path / os.path.basename(mod._SO)
    so.write_bytes(b"\x7fELF")
    monkeypatch.setattr(mod, "_SO", str(so))
    monkeypatch.setattr(mod, "_lib", None)
    monkeypatch.setattr(mod, "_load_error", None)
    assert mod.get_lib() is None and "too short" in str(mod._load_error)
    assert jax_native_libs.loaded("clairs_to_tpu.realign") is mod
    assert mod._lib is not None and mod._load_error is None
    assert mod.get_consensus("ACGT" * 30, ["ACGT" * 10] * 4)
    assert os.listdir(tmp_path) == [so.name]


# --- Fisher --------------------------------------------------------------

def _tables():
    rng = np.random.default_rng(7)
    grid = [(a, b, c, d) for a in (0, 1, 3, 9) for b in (0, 2, 7) for c in (0, 1, 5, 30)
            for d in (0, 4, 25)]
    rand = [tuple(int(x) for x in rng.integers(0, 80, size=4)) for _ in range(300)]
    big = [tuple(int(x) for x in rng.integers(100, 1500, size=4)) for _ in range(40)]
    return grid + rand + big


@pytest.mark.parametrize("fn", ["fisher_exact", "fisher_exact_reference"])
def test_fisher_equal_to_the_last_bit(fn):
    j, t = _both("postcall.hardfilter")
    vals = set()
    for (a, b, c, d) in _tables():
        table = [[a, b], [c, d]]
        x, y = getattr(j, fn)(table), getattr(t, fn)(table)
        assert x == y, (table, x, y)
        vals.add(x)
    assert len(vals) > 100


def test_native_fisher_equal():
    import ctypes

    libs = [m.get_lib() for m in _both("postcall.verdict_native")]
    for (a, b, c, d) in _tables()[:200]:
        args = [ctypes.c_int64(v) for v in (a, b, c, d)]
        assert libs[0].verdict_fisher_exact(*args) == libs[1].verdict_fisher_exact(*args)


@pytest.mark.parametrize("seed", [0, 1])
def test_sequence_entropy_equal(seed):
    rng = np.random.default_rng(seed)
    j, t = _both("postcall.hardfilter")
    for _ in range(50):
        n = int(rng.integers(20, 80))
        seq = "".join(rng.choice(list("ACGT"), size=n)) if rng.random() < 0.7 else "AC" * (n // 2)
        w = int(rng.integers(8, 40))
        assert j.calculate_sequence_entropy(seq, w) == t.calculate_sequence_entropy(seq, w)


# --- one decoded chunk, two decoders -------------------------------------

def _load(pkg, ds, platform, flavor):
    """The dataset's only contig as a PileupEngine of ``pkg``: ``window`` is
    the fused decode with its filter view, ``table`` the full entry table."""
    cfg = _mod(pkg, "config")
    native = _mod(pkg, "bamio.native")
    pile = _mod(pkg, "bamio.pileup")
    fa = _mod(pkg, "genome.fasta").FastaFile(ds["fasta"])
    ctg = ds["ctg"]
    L = fa.contig_length(ctg)
    ref_seq = fa.fetch(ctg, 0, L)
    fam = cfg.platform_family(platform)
    aff_bq = cfg.MIN_BQ_DICT.get(fam, 0)
    if flavor == "table":
        table = native.load_entry_table(ds["bam"], ctg, 0, L,
                                        excl_flags=cfg.SAMTOOLS_VIEW_FILTER_FLAG)
        return pile.PileupEngine.from_entry_table(table, ref_seq, 0, platform=platform), L, aff_bq
    ref_tok_of = _mod(pkg, "postcall.hardfilter")._REF_TOK
    ref_tok = np.full(L + 2 * native.FILT_MARGIN, 10, np.int16)
    ref_u8 = np.frombuffer(ref_seq.upper().encode("latin-1"), np.uint8)
    ref_tok[native.FILT_MARGIN:native.FILT_MARGIN + L] = ref_tok_of[ref_u8]
    win = native.BamStreamReader(ds["bam"]).load_window_reduced(
        ctg, 0, L, excl_flags=cfg.SAMTOOLS_VIEW_FILTER_FLAG, aff_min_bq=aff_bq,
        low_mq_thresh=cfg.LOW_MQ_THRESHOLD, low_bq_thresh=cfg.LOW_BQ_THRESHOLD.get(fam, 10),
        max_indel_length=cfg.MAX_INDEL_LENGTH, filter_view=(ref_tok, cfg.MIN_BQ, cfg.MIN_MQ))
    assert win is not None and win.has_filter_data
    return pile.PileupEngine.from_native_window(win, ref_seq, 0, platform=platform), L, aff_bq


def _inventory(pe, L, aff_bq):
    """(sites [(pos0, ref, alt, af)], het germline, hom germline) read off the
    pileup, as cli/run.py reads them off the chunk's calls."""
    snv_pos, _ind, _infos = pe.find_candidates(0, L, min_bq=aff_bq)
    ai = pe.alt_info_at(snv_pos, min_bq=aff_bq)
    sites, het, hom = [], [], []
    for p in snv_pos:
        info = ai[p][0]
        toks = info.split("-", 1)[1].rsplit("-", 1)[0].split()
        alts = [(toks[k][1:], int(toks[k + 1])) for k in range(0, len(toks), 2)
                if toks[k].startswith("X")]
        if not alts:
            continue
        alt, cnt = alts[0]
        af = min(cnt / (int(info.split("-", 1)[0]) or 1), 1.0)
        sites.append((int(p), pe._ref_base(p), alt, af))
        if af >= 0.75:
            hom.append((int(p), alt))
        elif af >= 0.2:
            het.append((int(p), alt))
    return sites, sorted(het), sorted(hom)


@pytest.fixture(scope="module")
def ont_ds(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("tfilt_ont"))
    return simulate.make_dataset(
        d, seed=47, genome_len=40_000, coverage=40, read_length=700, n_snv=25, n_indel=0,
        n_germline=70, error_rate=0.015, af_choices=(0.06, 0.12, 0.3, 0.5, 0.9),
        lowbq_rate=0.08, somatic_hap_aware=True)


@pytest.fixture(scope="module")
def ilmn_ds(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("tfilt_ilmn"))
    return simulate.make_dataset(
        d, seed=53, genome_len=30_000, coverage=50, read_length=150, n_snv=20, n_indel=0,
        n_germline=50, error_rate=0.008, af_choices=(0.08, 0.15, 0.4), somatic_hap_aware=True)


def _vn_off(monkeypatch):
    for m in _both("postcall.verdict_native"):
        monkeypatch.setattr(m, "available", lambda: False)


FLAVORS = ["window", "table"]


@pytest.mark.parametrize("flavor", FLAVORS)
def test_both_decoders_give_the_same_sites(ont_ds, flavor):
    inv = []
    for pkg in PKGS:
        pe, L, aff_bq = _load(pkg, ont_ds, "ont", flavor)
        inv.append(_inventory(pe, L, aff_bq))
    assert inv[0] == inv[1]
    assert len(inv[0][0]) > 50 and len(inv[0][1]) > 20


# --- phasing -------------------------------------------------------------

@pytest.mark.parametrize("flavor", FLAVORS)
def test_phase_and_tag_same_haplotag_per_read(ont_ds, flavor):
    hps, orients = [], []
    for pkg in PKGS:
        pe, L, aff_bq = _load(pkg, ont_ds, "ont", flavor)
        sites, het, _hom = _inventory(pe, L, aff_bq)
        het_set = {p for p, _a in het}
        anchors = [(p, r, a) for (p, r, a, af) in sites if p in het_set and af >= 0.35]
        ph = _mod(pkg, "phasing.phaser")
        orients.append((ph.phase_het_snps(pe, anchors)[0], ph.phase_het_snps_mst(pe, anchors)[0]))
        hp = ph.phase_and_tag(pe, anchors)
        # the entry table now carries the tags
        np.testing.assert_array_equal(pe._finalize()["hp"], hp[pe._finalize()["read_id"]])
        hps.append(hp)
    np.testing.assert_array_equal(hps[0], hps[1])
    assert orients[0] == orients[1]
    assert (hps[1] > 0).mean() > 0.5, "too few reads were haplotagged to test anything"
    assert {1, 2} <= set(np.unique(hps[1]).tolist())


def test_select_hetero_snps_equal(tmp_path):
    path = str(tmp_path / "germ.vcf")
    rng = np.random.default_rng(3)
    with open(path, "w") as f:
        f.write("##fileformat=VCFv4.2\n#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\tS\n")
        for pos in np.sort(rng.choice(50_000, size=200, replace=False)):
            ref = "ACGT"[int(rng.integers(4))]
            alt = "ACGT"[("ACGT".index(ref) + 1) % 4] if rng.random() < 0.85 else ref + "TT"
            gt = ("0/1", "1/1", "1/0")[int(rng.integers(3))]
            f.write(f"chr1\t{pos + 1}\t.\t{ref}\t{alt}\t{rng.uniform(1, 40):.2f}\tPASS\t.\t"
                    f"GT\t{gt}\n")
    out = []
    for pkg in PKGS:
        r = _mod(pkg, "vcf.reader").VcfReader(path, ctg_name="chr1")
        r.read_vcf()
        out.append(_mod(pkg, "phasing.phaser").select_hetero_snps(r.variant_dict.values()))
    assert out[0] == out[1] and 20 < len(out[1]) < 200


STUB_PHASER = r'''#!/usr/bin/env python3
import sys
args = sys.argv[1:]
assert args[0] == "phase"
opts = dict(zip(args[1::2], args[2::2]))
with open(opts["-s"]) as f, open(opts["-o"] + ".vcf", "w") as g:
    for line in f:
        if line.startswith("#"):
            g.write(line)
            continue
        cols = line.rstrip("\n").split("\t")
        k = int(cols[1]) // 1000
        cols[8] = "GT:PS"
        cols[9] = ("0/1" if k % 5 == 0 else "0|1" if k % 2 == 0 else "1|0") + ":1"
        g.write("\t".join(cols) + "\n")
'''


def test_external_phaser_path_equal(ont_ds, tmp_path):
    """Binary resolution, the het VCF, the subprocess call (a stand-in
    script for longphase: no real binary is installed), the phased VCF's
    parsing and the tags from its orientations."""
    stub = tmp_path / "longphase"
    stub.write_text(STUB_PHASER)
    stub.chmod(stub.stat().st_mode | stat.S_IEXEC)
    got = []
    for pkg in PKGS:
        ext = _mod(pkg, "phasing.external")
        assert ext.resolve_binary(str(tmp_path / "absent"), "longphase") is None
        assert ext.resolve_binary("None", "no-such-phaser-binary") is None
        assert ext.resolve_binary(str(stub), "longphase") == str(stub)
        assert ext.run_external_phase("longphase", None, "x", "y", "z", "p", "c") is None
        assert ext.run_external_phase("whatshap", str(tmp_path / "absent"), "x", "y", "z",
                                      str(tmp_path / "w"), "c") is None
        pe, L, aff_bq = _load(pkg, ont_ds, "ont", "window")
        sites, het, _hom = _inventory(pe, L, aff_bq)
        het_set = {p for p, _a in het}
        anchors = [(p, r, a) for (p, r, a, af) in sites if p in het_set and af >= 0.35]
        het_vcf = ext.write_het_vcf(str(tmp_path / f"{pkg}_het.vcf"), ont_ds["ctg"], anchors,
                                    sample="S1")
        phased = ext.run_external_phase("longphase", str(stub), het_vcf, ont_ds["bam"],
                                        ont_ds["fasta"], str(tmp_path / f"{pkg}_phased"),
                                        ont_ds["ctg"])
        assert phased is not None and os.path.exists(phased)
        orient = ext.load_phase_orientations(phased, anchors)
        hp = ext.phase_and_tag_with_orientations(pe, anchors, orient)
        internal = _mod(pkg, "phasing.phaser").phase_and_tag(
            _load(pkg, ont_ds, "ont", "window")[0], anchors)
        with open(het_vcf) as f:
            got.append((f.read(), orient, hp, ext.compare_haplotags(hp, internal)))
    assert got[0][0] == got[1][0] and "\tGT\t0/1\n" in got[1][0]
    assert got[0][1] == got[1][1] and 0 < len(got[1][1]) < len(got[1][0].splitlines())
    np.testing.assert_array_equal(got[0][2], got[1][2])
    assert got[0][3] == got[1][3]
    assert (got[1][2] > 0).any()


# --- the verdict engines -------------------------------------------------

def _verdict_tuple(v, fields):
    return tuple(getattr(v, f) for f in fields) + (v.strand_table,)


def _assert_same_verdicts(a, b, fields):
    assert sorted(a) == sorted(b)
    for p in a:
        assert _verdict_tuple(a[p], fields) == _verdict_tuple(b[p], fields), p
        assert abs(a[p].strand_bias_p - b[p].strand_bias_p) <= 1e-12, p
        assert a[p].pass_all == b[p].pass_all


@pytest.mark.parametrize("fisher", ["fisher_exact", "fisher_exact_reference"])
@pytest.mark.parametrize("vn", ["native", "numpy"])
@pytest.mark.parametrize("flavor", FLAVORS)
def test_haplotype_verdicts_equal(ont_ds, monkeypatch, flavor, vn, fisher):
    if vn == "numpy":
        _vn_off(monkeypatch)
    out, rows_out = [], []
    for pkg in PKGS:
        pe, L, aff_bq = _load(pkg, ont_ds, "ont", flavor)
        sites, het, hom = _inventory(pe, L, aff_bq)
        het_set = {p for p, _a in het}
        _mod(pkg, "phasing.phaser").phase_and_tag(
            pe, [(p, r, a) for (p, r, a, af) in sites if p in het_set and af >= 0.35])
        hap = _mod(pkg, "postcall.haplotype")
        engine = hap.HaplotypeFilterEngine(
            pe, hetero_germline=het, homo_germline=hom, site_positions=[s[0] for s in sites],
            fisher=getattr(_mod(pkg, "postcall.hardfilter"), fisher))
        batch = engine.verdict_batch(sites)
        out.append(batch)
        rows = [dict(CHROM="chrS", POS=p + 1, REF=r, ALT=a, QUAL=12.0, FILTER="PASS", INFO=".")
                for (p, r, a, _af) in sites]
        n = hap.apply_haplotype_filters(rows, {("chrS", p + 1): v for p, v in batch.items()})
        rows_out.append((n, rows))
    fields = out[0][next(iter(out[0]))].FIELDS + ("phaseable",)
    _assert_same_verdicts(out[0], out[1], fields)
    assert rows_out[0] == rows_out[1]
    verdicts = list(out[1].values())
    assert any(v.phaseable for v in verdicts), "nothing was phaseable"
    assert any(not v.pass_all for v in verdicts) and any(v.pass_all for v in verdicts)
    assert any(r["INFO"].startswith("H;") for r in rows_out[1][1])


@pytest.mark.parametrize("rse_off", [False, True], ids=["rse", "no_rse"])
@pytest.mark.parametrize("vn", ["native", "numpy"])
@pytest.mark.parametrize("flavor", FLAVORS)
def test_hard_filter_verdicts_equal(ilmn_ds, monkeypatch, flavor, vn, rse_off):
    if vn == "numpy":
        _vn_off(monkeypatch)
    out, rows_out = [], []
    for pkg in PKGS:
        pe, L, aff_bq = _load(pkg, ilmn_ds, "ilmn", flavor)
        sites, _het, _hom = _inventory(pe, L, aff_bq)
        hf = _mod(pkg, "postcall.hardfilter")
        engine = hf.HardFilterEngine(pe, site_positions=[s[0] for s in sites],
                                     disable_read_start_end_filtering=rse_off)
        batch = engine.verdict_batch([s[:3] for s in sites])
        out.append(batch)
        rows = [dict(CHROM="chrS", POS=p + 1, REF=r, ALT=a, QUAL=12.0, FILTER="PASS", INFO=".")
                for (p, r, a, _af) in sites]
        n = hf.apply_hard_filters(rows, {("chrS", p + 1): v for p, v in batch.items()})
        rows_out.append((n, rows))
    fields = ("pass_read_start_end", "pass_co_exist", "pass_strand_bias",
              "pass_sequence_entropy")
    _assert_same_verdicts(out[0], out[1], fields)
    assert rows_out[0] == rows_out[1] and len(out[1]) > 30
    assert all(";SB=" in r["INFO"] for r in rows_out[1][1])


def test_hard_filter_flags_an_indel_site_the_same(ilmn_ds):
    """Indel sites take the per-site Python path in both packages."""
    got = []
    for pkg in PKGS:
        pe, L, aff_bq = _load(pkg, ilmn_ds, "ilmn", "table")
        sites, _h, _o = _inventory(pe, L, aff_bq)
        hf = _mod(pkg, "postcall.hardfilter")
        engine = hf.HardFilterEngine(pe)
        p, r, _a, _af = sites[3]
        v = engine.verdict_batch([(p, r, r + "AT")])[p]
        got.append((v.pass_all, v.pass_sequence_entropy, v.strand_bias_p, v.strand_table))
    assert got[0] == got[1]


# --- realignment ---------------------------------------------------------

def _reference_rule(raw_support, raw_depth, realign_support, realign_depth):
    if raw_depth <= 0 or realign_depth <= 0:
        return False
    return (raw_support / float(raw_depth) > realign_support / realign_depth
            and realign_support < raw_support)


def test_realign_decision_golden_table():
    rng = np.random.default_rng(5)
    cases = [(0, 0, 0, 0), (3, 30, 3, 30), (3, 30, 2, 30), (3, 30, 2, 29),
             (3, 30, 3, 20), (4, 40, 0, 0), (4, 40, 4, 39), (5, 50, 4, 51)]
    for _ in range(500):
        rd = int(rng.integers(0, 60))
        nd = int(rng.integers(0, 60))
        cases.append((int(rng.integers(0, rd + 1)), rd, int(rng.integers(0, nd + 1)), nd))
    j, t = _both("postcall.realignment")
    for case in cases:
        assert t.realign_decision(*case) == j.realign_decision(*case) == _reference_rule(*case), case


@pytest.mark.parametrize("with_window", [True, False], ids=["window", "bam"])
def test_realign_filter_same_filter_per_row(ilmn_ds, with_window):
    got = []
    for pkg in PKGS:
        pe, L, aff_bq = _load(pkg, ilmn_ds, "ilmn", "window")
        sites, _h, _o = _inventory(pe, L, aff_bq)
        rows = [dict(CHROM="chrS", POS=p + 1, REF=r, ALT=a, QUAL=3.0 if k % 4 else 30.0,
                     FILTER="PASS", INFO=".")
                for k, (p, r, a, _af) in enumerate(sites[:40 if with_window else 12])]
        fasta = _mod(pkg, "genome.fasta").FastaFile(ilmn_ds["fasta"])
        n = _mod(pkg, "postcall.realignment").realign_filter(
            ilmn_ds["bam"], fasta, rows, window=pe._win if with_window else None)
        got.append((n, rows))
    assert got[0] == got[1]
    assert all(r["FILTER"] in ("PASS", "LowQual;Realignment") for r in got[1][1])


def test_realign_native_consensus_and_reads_equal():
    rng = np.random.default_rng(8)
    ref = "".join(rng.choice(list("ACGT"), size=160))
    alt = ref[:80] + "G" + ref[81:]
    reads = [(alt if k % 3 else ref)[s:s + 70] for k, s in enumerate(range(0, 90, 6))]
    j, t = _both("realign")
    haps = t.get_consensus(ref, reads)
    assert j.get_consensus(ref, reads) == haps and len(haps) >= 1
    # reads with an unmodelled 2-base deletion: realignment has work to do
    seqs = reads + [(ref[:60] + ref[62:])[s:s + 70] for s in range(10, 50, 8)]
    (pos_j, cig_j), (pos_t, cig_t) = (m.realign_reads(ref, 1000, seqs, haps) for m in (j, t))
    np.testing.assert_array_equal(pos_j, pos_t)
    assert cig_j == cig_t and len(cig_t) == len(seqs)
    assert (pos_t >= 1000).any()
