# Port copy of clairs_to_tpu/postcall/realignment.py.
"""Short-read realignment filter.

Port of ClairS-TO src/realign_variants.py:59-180: for Illumina PASS
calls below the qual threshold, locally reassemble the +-100bp window
(de Bruijn consensus haplotypes), realign the window's reads, recount the
alt support, and fail the call (FILTER += ';Realignment', LowQual) when BOTH
the alt read count and the alt AF decreased after realignment.

Uses the native realign library (clairs_to_tpu_torch/realign) and counts alleles
directly from alignments — no samtools round-trip.
"""

import re
from typing import List

import numpy as np

from clairs_to_tpu_torch import config as cfg
from clairs_to_tpu_torch import realign
from clairs_to_tpu_torch.bamio.bam import BamFile

WINDOW = 100
QUAL_THRESHOLD = 8  # realign_variants.py:72 — only low-qual calls re-checked

_CIGAR_RE = re.compile(r"(\d+)([MIDNSHP=X])")


def _base_at(pos0, read_pos, cigar_str, seq):
    """Base of a read at ref position pos0 given a CIGAR string; None if the
    read does not align a base there."""
    ref = read_pos
    q = 0
    for num, op in _CIGAR_RE.findall(cigar_str):
        ln = int(num)
        if op in "M=X":
            if ref <= pos0 < ref + ln:
                return seq[q + (pos0 - ref)]
            ref += ln
            q += ln
        elif op == "I":
            q += ln
        elif op in "DN":
            if ref <= pos0 < ref + ln:
                return None  # deleted
            ref += ln
        elif op == "S":
            q += ln
    return None


def _counts(reads_info, pos0, alt_base):
    depth = 0
    alt = 0
    for (rpos, cigar, seq) in reads_info:
        b = _base_at(pos0, rpos, cigar, seq)
        if b is None:
            continue
        depth += 1
        if b.upper() == alt_base:
            alt += 1
    return alt, depth


def realign_decision(raw_support, raw_depth, new_support, new_depth):
    """True = call FAILS the realignment check.

    The reference's rule (realign_variants.py:119-122): fail when the alt
    AF strictly decreased AND the alt read count strictly decreased.  An
    empty realigned pileup is a skip, not a fail (:109-112 returns pass
    when the re-mpileup row is missing)."""
    if raw_depth <= 0 or new_depth <= 0:
        return False
    return (raw_support / float(raw_depth) > new_support / float(new_depth)
            and new_support < raw_support)


def realign_filter(
    bam_path: str,
    fasta,
    rows: List[dict],
    qual_threshold: float = QUAL_THRESHOLD,
    min_mq: int = cfg.MIN_MQ,
    window=None,
    metrics=None,
):
    """Apply the realignment filter to SNV row dicts in place.

    ``window``: optional bamio.native.NativeWindow — per-site reads then
    come from the fused decode's retained records (zero extra BAM I/O).
    Without it, each site re-fetches through the pure-Python reader,
    which is far slower on a deep chunk.

    ``metrics``: optional RunMetrics, which counts the calls checked
    (``realign_sites``), their reads (``realign_reads``), consensus
    haplotypes (``realign_haplotypes``) and the calls failed
    (``realign_failed``).

    Returns the number of rows failed.  Raises with the compiler's message
    when the realignment library does not build: without it no call would
    be realigned."""
    if not realign.available():
        raise RuntimeError("the realignment filter needs the realignment library, which "
                           f"did not build: {realign.LIB.error}")
    counts = {"realign_sites": 0, "realign_reads": 0, "realign_haplotypes": 0}
    bam = None
    n_failed = 0
    for row in rows:
        if row["FILTER"] != "PASS":
            continue
        if float(row["QUAL"]) >= qual_threshold:
            continue
        if len(row["REF"]) != 1 or len(row["ALT"]) != 1:
            continue
        ctg = row["CHROM"]
        pos0 = row["POS"] - 1
        win_lo = max(pos0 - WINDOW, 0)
        win_hi = pos0 + WINDOW + 1
        if window is not None:
            ori_info = [
                (rpos, cig, seq)
                for (rpos, _flag, _mq, cig, seq)
                in window.reads_overlapping(win_lo, win_hi, min_mapq=min_mq)
            ]
        else:
            if bam is None:
                bam = BamFile(bam_path)
            reads = [
                r
                for r in bam.fetch(
                    ctg, win_lo, win_hi,
                    excl_flags=cfg.SAMTOOLS_VIEW_FILTER_FLAG,
                    min_mapq=min_mq,
                )
            ]
            ori_info = [(r.pos, _cigar_string(r), r.seq) for r in reads]
        if not ori_info:
            continue
        ori_alt, ori_depth = _counts(ori_info, pos0, row["ALT"])
        # assemble + realign
        ref_lo = max(win_lo - 20, 0)
        ref_hi = win_hi + 20
        ref_window = fasta.fetch(ctg, ref_lo, ref_hi)
        seqs = [seq for (_p, _c, seq) in ori_info]
        haps = realign.get_consensus(ref_window, seqs)
        counts["realign_sites"] += 1
        counts["realign_reads"] += len(seqs)
        counts["realign_haplotypes"] += len(haps)
        new_pos, new_cigars = realign.realign_reads(
            ref_window, ref_lo, seqs, haps
        )
        new_info = []
        for k, oi in enumerate(ori_info):
            if new_pos[k] < 0 or not new_cigars[k]:
                new_info.append(oi)
            else:
                new_info.append((int(new_pos[k]), new_cigars[k], oi[2]))
        new_alt, new_depth = _counts(new_info, pos0, row["ALT"])
        if realign_decision(ori_alt, ori_depth, new_alt, new_depth):
            row["QUAL"] = 0.0
            row["FILTER"] = "LowQual;Realignment"
            n_failed += 1
    if metrics is not None:
        for name, n in counts.items():
            metrics.count(name, n)
        metrics.count("realign_failed", n_failed)
    return n_failed


def _cigar_string(read):
    from clairs_to_tpu_torch.bamio.bam import CIGAR_OPS

    return "".join(
        f"{int(l)}{CIGAR_OPS[int(o)]}" for o, l in zip(read.cigar_ops, read.cigar_lens)
    )
