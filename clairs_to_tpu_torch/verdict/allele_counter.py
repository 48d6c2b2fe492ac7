# Port copy of clairs_to_tpu/verdict/allele_counter.py.
"""Per-locus allele counting for Verdict.

Replaces the reference's vendored Sanger alleleCounter C binary
(ClairS-TO src/verdict/allele_counter/c, invoked with -m 20 -q 20
-F 2316 --dense-snps, src/cna_germline_tagging.py:60-69): counts A/C/G/T
bases at the G1000 het loci.  Here the counts come straight from the shared
entry table (bamio/pileup.py) — base quality >= 20, mapping quality >= 20,
flags already excluded at decode time — so no extra BAM pass is needed.
"""

import numpy as np


def allele_counts_at(pileup_engine, positions, min_bq=20, min_mq=20):
    """ACGT counts at 0-based positions.

    Returns (n, 4) int64 array ordered A,C,G,T (strand-summed), matching the
    alleleCounter output columns (Count_A..Count_T).
    """
    positions = np.asarray(positions, dtype=np.int64)
    if hasattr(pileup_engine, "ensure_sites"):
        pileup_engine.ensure_sites(positions, 0)
    a = pileup_engine._finalize()
    sel = (
        (a["mq"] >= min_mq)
        & (a["bq"] >= min_bq)
        & (a["code"] < 8)            # pure base entries only
        & (a["ikind"] == 0)
    )
    idx = np.nonzero(sel)[0]
    pos = a["pos"][idx]
    base = a["code"][idx] % 4
    order = np.argsort(pos, kind="stable")
    pos, base = pos[order], base[order]
    out = np.zeros((len(positions), 4), dtype=np.int64)
    lo = np.searchsorted(pos, positions, side="left")
    hi = np.searchsorted(pos, positions, side="right")
    for i in range(len(positions)):
        if hi[i] > lo[i]:
            out[i] = np.bincount(base[lo[i] : hi[i]], minlength=4)
    return out


def write_allele_counts(path, ctg, positions, counts):
    """alleleCounter-compatible TSV (#CHR POS Count_A..Count_T Good_depth)."""
    with open(path, "w") as f:
        f.write("#CHR\tPOS\tCount_A\tCount_C\tCount_G\tCount_T\tGood_depth\n")
        for p, c in zip(positions, counts):
            f.write(
                f"{ctg}\t{p + 1}\t{c[0]}\t{c[1]}\t{c[2]}\t{c[3]}\t{c.sum()}\n"
            )
    return path
