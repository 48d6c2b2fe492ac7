"""The port's Verdict chain (allele counts, LogR/BAF, GC correction, germline
genotypes, ASPCF, ASCAT, tagging, the resource loaders and ``run_verdict``)
against the JAX package's on the same seeded counts.  Both are the same numpy
and scipy calls in float64, so floats are held to 1e-12 and everything
discrete (segments, copy numbers, tags, files) to equality."""

import dataclasses
import importlib
import os

import numpy as np
import pytest

PKGS = ("clairs_to_tpu", "clairs_to_tpu_torch")
TOL = dict(rtol=0, atol=1e-12)


def _both(name):
    return tuple(importlib.import_module(f"{p}.{name}") for p in PKGS)


PROFILES = {
    # a gain on chr1, an LOH and a balanced gain on chr2, at purity 0.45
    "gain_loh": (0.45, {"chr1": [((1, 1), 350), ((2, 1), 350)],
                        "chr2": [((1, 0), 350), ((2, 2), 350)]}),
    # a one-copy deletion over half of one contig, at purity 0.5
    "deletion": (0.5, {"chr1": [((1, 1), 300), ((1, 0), 300)]}),
    # a pure diploid sample: nothing aberrant
    "flat": (0.3, {"chr1": [((1, 1), 400)], "chr2": [((1, 1), 300)]}),
}


def _scenario(name, seed=424242, depth=30.0):
    """Per-contig (positions0, ref counts, alt counts) under a known copy
    number profile, as the chunk loop accumulates them."""
    rho, profile = PROFILES[name]
    rng = np.random.default_rng(seed)
    out = {}
    for ctg, segs in profile.items():
        pos, positions, refc, altc = 0, [], [], []
        for (n_a, n_b), count in segs:
            for _ in range(count):
                pos += int(rng.integers(800, 2200))
                tot_cn = rho * (n_a + n_b) + (1 - rho) * 2
                total = max(int(rng.poisson(depth * tot_cn / 2.0)), 1)
                if rng.random() < 0.3:
                    p_alt = 0.995 if rng.random() < 0.5 else 0.005
                else:
                    p_alt = (rho * n_b + (1 - rho)) / tot_cn
                alt = int(rng.binomial(total, p_alt))
                positions.append(pos)
                refc.append(total - alt)
                altc.append(alt)
        out[ctg] = (np.asarray(positions, np.int64), np.asarray(refc, np.int64),
                    np.asarray(altc, np.int64))
    return out


def _flat(counts):
    ctgs = sorted(counts)
    chrom = np.concatenate([np.full(len(counts[c][0]), i) for i, c in enumerate(ctgs)])
    refc = np.concatenate([counts[c][1] for c in ctgs])
    altc = np.concatenate([counts[c][2] for c in ctgs])
    return chrom, refc, altc


def _rows(counts, seed):
    """VCF row dicts spread over the loci span, PASS and not."""
    rng = np.random.default_rng(seed)
    rows = []
    for ctg, (pos, _r, _a) in sorted(counts.items()):
        for p in rng.choice(np.arange(pos[0], pos[-1]), size=80, replace=False):
            rows.append(dict(
                CHROM=ctg, POS=int(p) + 1, REF="A", ALT="C", QUAL=20.0,
                FILTER="PASS" if rng.random() < 0.85 else "LowQual", INFO=".",
                AF=float(np.round(rng.choice([0.04, 0.12, 0.22, 0.5, 0.72, 0.98])
                                  + rng.normal(0, 0.01), 4)),
                DP=int(rng.integers(25, 90))))
    rows.sort(key=lambda r: (r["CHROM"], r["POS"]))
    return rows


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_logr_baf_equal_and_same_draws(seed):
    _chrom, refc, altc = _flat(_scenario("gain_loh", seed=seed))
    refc[::17] = 0
    altc[::17] = 0  # zero-depth loci are masked out
    j, t = _both("verdict.logr_baf")
    # the default generator (seed 0) and an explicit one: same draws, same order
    for mk in (lambda: None, lambda: np.random.default_rng(seed + 5)):
        a, b = j.logr_baf(refc, altc, rng=mk()), t.logr_baf(refc, altc, rng=mk())
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
        assert not a[2].all() and a[2].sum() == len(a[0])


def test_correct_logr_equal():
    rng = np.random.default_rng(9)
    _chrom, refc, altc = _flat(_scenario("gain_loh"))
    j, t = _both("verdict.logr_baf")
    logr, _baf, _keep = j.logr_baf(refc, altc)
    gc = rng.uniform(0.3, 0.7, size=(len(logr), 12))
    rt = rng.uniform(0.0, 1.0, size=(len(logr), 8))
    logr = logr + 0.4 * (gc[:, 5] - 0.5) - 0.2 * (rt[:, 2] - 0.5)
    a, b = j.correct_logr(logr, gc, rt), t.correct_logr(logr, gc, rt)
    np.testing.assert_allclose(b, a, **TOL)
    assert np.abs(a - logr).max() > 1e-3


@pytest.mark.parametrize("name", sorted(PROFILES))
def test_genotypes_aspcf_ascat_equal(name):
    counts = _scenario(name)
    chrom, refc, altc = _flat(counts)
    jl, tl = _both("verdict.logr_baf")
    ja, ta = _both("verdict.aspcf")
    js, ts = _both("verdict.ascat")
    logr, baf, _keep = jl.logr_baf(refc, altc)
    chrom = chrom[_keep]
    hom_j = jl.predict_germline_genotypes(baf, chrom)
    hom_t = tl.predict_germline_genotypes(baf, chrom)
    np.testing.assert_array_equal(hom_j, hom_t)
    assert 0 < hom_j.sum() < len(hom_j)
    seg_j = ja.aspcf_segment(logr, baf, hom_j, chrom, penalty=1000)
    seg_t = ta.aspcf_segment(logr, baf, hom_t, chrom, penalty=1000)
    for x, y in zip(seg_j, seg_t):
        np.testing.assert_allclose(y, x, **TOL)
    res_j = js.run_ascat(seg_j[0], seg_j[1], seg_j[2], baf)
    res_t = ts.run_ascat(seg_t[0], seg_t[1], seg_t[2], baf)
    assert (res_j is None) == (res_t is None)
    if res_j is not None:
        assert res_t.segments == res_j.segments
        assert res_t.nonaberrant == res_j.nonaberrant
        for f in ("purity", "ploidy", "psi", "goodness_of_fit"):
            assert getattr(res_t, f) == pytest.approx(getattr(res_j, f), rel=0, abs=1e-12), f
        np.testing.assert_array_equal(res_t.n_major, res_j.n_major)
        np.testing.assert_array_equal(res_t.n_minor, res_j.n_minor)
    if name == "gain_loh":
        assert res_j is not None and len(res_j.segments) >= 3


@pytest.mark.parametrize("kmin,gamma", [(5, 1.0), (8, 25.0)])
def test_exact_pcf_and_fast_aspcf_equal(kmin, gamma):
    rng = np.random.default_rng(4)
    n = 400
    logr = np.concatenate([np.zeros(150), np.full(130, 0.58), np.full(120, -0.4)])
    logr = logr + 0.05 * rng.normal(size=n)
    baf = np.concatenate([np.full(150, 0.5), np.full(130, 0.33), np.full(120, 0.2)])
    baf = baf + 0.02 * rng.normal(size=n)
    j, t = _both("verdict.aspcf")
    np.testing.assert_allclose(t.exact_pcf(logr, kmin, gamma), j.exact_pcf(logr, kmin, gamma),
                               **TOL)
    for x, y in zip(j.fast_aspcf(logr, baf, kmin, gamma * 40),
                    t.fast_aspcf(logr, baf, kmin, gamma * 40)):
        np.testing.assert_allclose(y, x, **TOL)
    assert len(np.unique(j.exact_pcf(logr, kmin, gamma))) >= 2


def test_classify_call_grid_equal():
    j, t = _both("verdict.tagging")
    seen = set()
    for af in (0.02, 0.05, 0.11, 0.2, 0.33, 0.5, 0.66, 0.8, 0.98):
        for depth in (12, 40, 90):
            for purity in (0.15, 0.4, 0.6):
                for (cn_a, cn_b) in ((1, 1), (2, 1), (1, 0), (2, 2), (3, 0), (0, 0)):
                    a = j.classify_call(af, depth, purity, cn_a, cn_b)
                    b = t.classify_call(af, depth, purity, cn_a, cn_b)
                    assert a == b, (af, depth, purity, cn_a, cn_b)
                    seen.add(a[1])
    assert {"Verdict_Germline", "Verdict_Somatic", "Verdict_SubclonalSomatic"} <= seen


@pytest.mark.parametrize("purity", [0.35, 0.8])
def test_tag_vcf_rows_equal(purity):
    counts = _scenario("gain_loh")
    segs = [("chr1", 1, 400_000, 1, 1), ("chr1", 400_001, 2_000_000, 2, 1),
            ("chr2", 1, 2_000_000, 1, 0)]
    j, t = _both("verdict.tagging")
    rows_j, rows_t = _rows(counts, 3), _rows(counts, 3)
    assert j.tag_vcf_rows(rows_j, purity, segs) == t.tag_vcf_rows(rows_t, purity, segs)
    assert rows_j == rows_t
    assert any("Verdict_" in r["INFO"] for r in rows_t) == (purity <= 0.6)


def _tree(path):
    out = {}
    for name in sorted(os.listdir(path)):
        with open(os.path.join(path, name)) as f:
            out[name] = f.read()
    return out


@pytest.mark.parametrize("name", sorted(PROFILES))
@pytest.mark.parametrize("tracks", [False, True], ids=["plain", "gc_rt"])
def test_run_verdict_equal(name, tracks, tmp_path):
    counts = _scenario(name)
    gc_lookup = rt_lookup = None
    if tracks:
        rng = np.random.default_rng(6)
        gc_lookup, rt_lookup = {}, {}
        for ctg, (pos, _r, _a) in counts.items():
            for p in pos[5:]:  # a few loci lack the tracks and are dropped
                gc_lookup[(ctg, int(p))] = rng.uniform(0.3, 0.7, size=12)
                rt_lookup[(ctg, int(p))] = rng.uniform(0.0, 1.0, size=8)
    results, rows_out, files = [], [], []
    for pkg, mod in zip(PKGS, _both("verdict.pipeline")):
        rows = _rows(counts, 8)
        out_dir = str(tmp_path / pkg)
        results.append(mod.run_verdict(
            None, None, rows, cna_output_dir=out_dir, sample_name="S", penalty=1000,
            gc_lookup=gc_lookup, rt_lookup=rt_lookup, counts_by_ctg=counts))
        rows_out.append(rows)
        files.append(_tree(out_dir))
    a, b = results
    assert (a.applied, a.reason, a.n_tagged, a.segments) == \
        (b.applied, b.reason, b.n_tagged, b.segments)
    for f in ("purity", "ploidy"):
        x, y = getattr(a, f), getattr(b, f)
        assert (x is None) == (y is None)
        if x is not None:
            assert y == pytest.approx(x, rel=0, abs=1e-12)
    assert rows_out[0] == rows_out[1]
    assert files[0] == files[1] and "S_Tumor_LogR.txt" in files[1]
    if name == "gain_loh":
        assert b.applied and b.n_tagged > 0, (b.reason, b.purity)
        assert "S_Tumor_CNA.txt" in files[1]


def test_run_verdict_too_few_loci_same_reason():
    counts = {"chr1": (np.arange(5) * 1000, np.full(5, 20), np.full(5, 18))}
    out = [m.run_verdict(None, None, [], counts_by_ctg=counts)
           for m in _both("verdict.pipeline")]
    assert dataclasses.asdict(out[0]) == dataclasses.asdict(out[1])
    assert out[1].reason == "too few usable loci" and not out[1].applied


def test_allele_counts_at_equal(tmp_path):
    """The same BAM through each package's own pileup and counter."""
    rng = np.random.default_rng(2)
    ref = "".join(rng.choice(list("ACGT"), size=400))
    got = []
    for pkg in PKGS:
        bw = importlib.import_module(f"{pkg}.bamio.bam_writer")
        bam = importlib.import_module(f"{pkg}.bamio.bam")
        pile = importlib.import_module(f"{pkg}.bamio.pileup")
        ac = importlib.import_module(f"{pkg}.verdict.allele_counter")
        r2 = np.random.default_rng(12)
        recs = []
        for i in range(60):
            start = int(r2.integers(0, 250))
            seq = list(ref[start:start + 120])
            for k in r2.choice(120, size=3, replace=False):
                seq[k] = "ACGT"[int(r2.integers(4))]
            quals = r2.integers(5, 40, size=120).tolist()
            recs.append((start, bw.encode_record(f"r{i}", 0, 0, start, int(r2.choice([10, 60])),
                                                 [("M", 120)], "".join(seq), quals)))
        recs.sort(key=lambda x: x[0])
        path = str(tmp_path / f"{pkg}.bam")
        bw.write_bam(path, ["c"], [400], [r for _s, r in recs])
        eng = pile.PileupEngine(ref, 0)
        for r in bam.BamFile(path):
            eng.add_read(r)
        positions = np.arange(100, 300, 3)
        counts = ac.allele_counts_at(eng, positions)
        tsv = str(tmp_path / f"{pkg}.tsv")
        ac.write_allele_counts(tsv, "c", positions, counts)
        with open(tsv) as f:
            got.append((counts, f.read()))
    np.testing.assert_array_equal(got[0][0], got[1][0])
    assert got[0][1] == got[1][1]
    assert got[1][0].sum() > 300


def test_load_cna_resources_equal(tmp_path):
    rng = np.random.default_rng(5)
    res = tmp_path / "cna"
    (res / "allele_files").mkdir(parents=True)
    for ctg in ("chr1", "chr2"):
        with open(res / "allele_files" / f"G1000_alleles_hg38_{ctg}.txt", "w") as f:
            f.write("position\tallele_A\tallele_B\n")
            for k, pos in enumerate(np.sort(rng.choice(100_000, size=50, replace=False))):
                a, b = rng.choice(4, size=2, replace=False) + 1
                f.write(f"{pos + 1}\t{a}\t{b if k % 11 else 'X'}\n")
    for track, n in (("GC_G1000_hg38.txt", 12), ("RT_G1000_hg38.txt", 8)):
        with open(res / track, "w") as f:
            f.write("idx\tchr\tpos\t" + "\t".join(f"c{i}" for i in range(n)) + "\n")
            for k in range(60):
                vals = "\t".join(f"{v:.4f}" for v in rng.random(n))
                f.write(f"{k}\t{1 + k % 2}\t{1000 + 37 * k}\t{vals}\n")
    out = [m.load_cna_resources(str(res), ["chr1", "chr2", "chr3"])
           for m in _both("verdict.resources")]
    for (loci_a, gc_a, rt_a), (loci_b, gc_b, rt_b) in [out]:
        assert sorted(loci_a) == sorted(loci_b) == ["chr1", "chr2"]
        for ctg in loci_a:
            for x, y in zip(loci_a[ctg], loci_b[ctg]):
                np.testing.assert_array_equal(x, y)
        for ta, tb in ((gc_a, gc_b), (rt_a, rt_b)):
            assert sorted(ta) == sorted(tb) and len(tb) == 60
            for k in ta:
                np.testing.assert_array_equal(ta[k], tb[k])
