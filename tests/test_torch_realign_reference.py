"""The port's realignment library (``realign/``) and filter
(``postcall/realignment.py``) against the benchmark's plain reference of
them (``h100_bench/reference/realign.py``), on windows with a planted SNV
or a 1-3-base insertion or deletion: the consensus haplotypes in their
order, each read's new position and CIGAR, the counts and the decision.
And the filter raises, where realignment is on, when the library does not
build."""

import os

import numpy as np
import pytest

from clairs_to_tpu_torch import realign
from clairs_to_tpu_torch.postcall import realignment
from h100_bench.reference import realign as ref_realign

CASES = [(kind, seed) for kind in ("snv", "ins", "del", "none") for seed in (1, 2, 3)]
CASES += [("repeat", 4), ("burst", 5)]


def _window(kind, seed):
    """(reference window, its start, reads as (position, CIGAR, sequence),
    the site, its alt): 150-base reads over the site +- 100, a third from
    the planted haplotype, with substitution errors."""
    rng = np.random.default_rng(seed)
    big = "".join(rng.choice(list("ACGT"), size=1000, p=[0.295, 0.205, 0.205, 0.295]))
    if kind == "repeat":                 # a repeated 40-mer: no k holds, no assembly
        big = big[:520] + big[450:490] + big[560:]
    site = 500
    alt_base = "ACGT"[("ACGT".index(big[site]) + 1) % 4]
    if kind in ("snv", "burst", "repeat"):
        hap, ops = big[:site] + alt_base + big[site + 1:], None
    elif kind == "ins":
        k = int(rng.integers(1, 4))
        hap, ops = big[:site + 1] + "".join(rng.choice(list("ACGT"), size=k)) + big[site + 1:], k
    elif kind == "del":
        k = int(rng.integers(1, 4))
        hap, ops = big[:site + 1] + big[site + 1 + k:], -k
    else:
        hap, ops = big, None
    reads = []
    for s in sorted(rng.integers(site - 249, site + 100, size=110).tolist()):
        planted = rng.random() < 0.35
        src = hap if planted else big
        seq = list(src[s:s + 150])
        err = 0.02 if kind == "burst" else 0.003
        for j in np.nonzero(rng.random(150) < err)[0]:
            seq[j] = "ACGT"[("ACGT".index(seq[j]) + 1 + int(rng.integers(0, 3))) % 4]
        cigar = "150M"
        if planted and ops and s <= site < s + 149:
            a = site + 1 - s
            cigar = f"{a}M{ops}I{150 - a - ops}M" if ops > 0 else f"{a}M{-ops}D{150 - a}M"
        reads.append((s, cigar, "".join(seq)))
    lo, hi = site - 100, site + 101
    reads = [r for r in reads if r[0] < hi and r[0] + 150 > lo]
    ref_lo = lo - 20
    return big[ref_lo:hi + 20], ref_lo, reads, site, alt_base


@pytest.mark.parametrize("kind, seed", CASES)
def test_the_library_realigns_as_the_reference(kind, seed):
    ref, ref_lo, reads, site, alt = _window(kind, seed)
    seqs = [s for _p, _c, s in reads]
    haps = realign.get_consensus(ref, seqs)
    assert haps == ref_realign.consensus(ref, seqs)
    if kind == "repeat":
        assert haps == [ref]
    elif kind != "none":
        assert len(haps) >= 2
    pos, cigars = realign.realign_reads(ref, ref_lo, seqs, haps)
    want_pos, want_cigars = ref_realign.realign(ref, ref_lo, seqs, haps)
    np.testing.assert_array_equal(pos, want_pos)
    assert cigars == want_cigars
    assert (pos >= 0).sum() > len(reads) // 2
    # the counts and the decision, as realign_filter makes them
    new = [(int(p), c, r[2]) if p >= 0 and c else r for r, p, c in zip(reads, pos, cigars)]
    before = realignment._counts(reads, site, alt)
    after = realignment._counts(new, site, alt)
    want = ref_realign.site(ref, ref_lo, reads, site, alt)
    assert (before, after) == (want["before"], want["after"])
    assert realignment.realign_decision(*before, *after) == want["fail"]


def test_the_reference_alignment_ties():
    """The reference's own rules where the score ties: an exact copy aligns
    at its rightmost occurrence; an unplaceable read keeps its alignment."""
    target = "ACGTACGTAAACCCGGGTTT" + "ACGTACGT"
    assert ref_realign.align(["ACGTACGT"], target) == [(20, [("M", 8)])]
    assert ref_realign.compose(np.full(5, -1), np.arange(10), 100) == (-1, "")
    start, runs = ref_realign.align(["AAACCCTTT"], "GGAAACCCGGGTTTGG")[0]
    assert sum(n for op, n in runs if op != "D") == 9


def test_the_filter_raises_without_its_library(tmp_path, monkeypatch):
    """With realignment on, a realignment library that does not build makes
    the filter raise with the compiler's message, not pass every call."""
    assert realign.available()
    broken = tmp_path / os.path.basename(realign.LIB.source)
    broken.write_text("this is not C++\n")
    for attr, value in (("source", str(broken)), ("so", str(tmp_path / "lib.so")),
                        ("cdll", None), ("fns", None), ("error", None)):
        monkeypatch.setattr(realign.LIB, attr, value)
    rows = [dict(CHROM="chr1", POS=500, REF="A", ALT="C", QUAL=2.0, FILTER="PASS", INFO=".")]
    with pytest.raises(RuntimeError, match="failed on"):
        realignment.realign_filter("unused.bam", None, rows)
    assert rows[0]["FILTER"] == "PASS"
