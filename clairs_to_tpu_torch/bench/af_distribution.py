# Port copy of clairs_to_tpu/bench/af_distribution.py.
"""AF distribution: recount coverage/alt support at given sites.

Port of the reference's src/cal_af_distribution.py (cal_af :137): for each
truth/query site, count tumor coverage and alt-supporting reads — used by
compare_vcf's AF-aware FN exclusion (--min_af path, compare_vcf.py:146-172).
Counts come from the shared entry table instead of per-site mpileup.
"""

from collections import defaultdict

import numpy as np

from clairs_to_tpu_torch import config as cfg
from clairs_to_tpu_torch.bamio.bam import BamFile
from clairs_to_tpu_torch.bamio.pileup import PileupEngine


def cal_af(bam_path, fasta, sites, platform="ont", min_bq=None, min_mq=cfg.MIN_MQ):
    """sites: [(ctg, pos1, ref, alt)]; returns {(ctg,pos1): (cov, alt_count)}."""
    if min_bq is None:
        min_bq = cfg.MIN_BQ_DICT.get(cfg.platform_family(platform), 0)
    by_ctg = defaultdict(list)
    for (ctg, pos1, ref, alt) in sites:
        by_ctg[ctg].append((pos1, ref, alt))
    bam = BamFile(bam_path)
    out = {}
    for ctg, items in by_ctg.items():
        positions = sorted(p - 1 for (p, _r, _a) in items)
        lo = max(min(positions) - 200, 0)
        hi = max(positions) + 200
        ctg_len = fasta.contig_length(ctg)
        hi = min(hi, ctg_len)
        ref_seq = fasta.fetch(ctg, lo, hi)
        pe = PileupEngine(ref_seq, lo, platform=platform)
        for read in bam.fetch(ctg, lo, hi, excl_flags=cfg.SAMTOOLS_VIEW_FILTER_FLAG):
            pe.add_read(read)
        a = pe._finalize()
        sel = (a["mq"] >= min_mq) & (a["bq"] >= min_bq) & (a["code"] != 10)
        idx = np.nonzero(sel)[0]
        pos_arr = a["pos"][idx]
        order = np.argsort(pos_arr, kind="stable")
        idx, pos_arr = idx[order], pos_arr[order]
        for (p1, ref, alt) in items:
            p0 = p1 - 1
            lo_i = np.searchsorted(pos_arr, p0, "left")
            hi_i = np.searchsorted(pos_arr, p0, "right")
            cov = 0
            alt_count = 0
            is_snv = len(ref) == 1 and len(alt) == 1
            for j in idx[lo_i:hi_i]:
                c = int(a["code"][j])
                if c < 8:
                    cov += 1
                    if is_snv and c % 4 == "ACGT".index(alt[0]):
                        alt_count += 1
                elif c in (8, 9):
                    cov += 1
                if not is_snv and a["ikind"][j] != 0:
                    if len(alt) > len(ref) and a["ikind"][j] == 1:
                        alt_count += 1
                    elif len(ref) > len(alt) and a["ikind"][j] == 2:
                        alt_count += 1
            out[(ctg, p1)] = (cov, alt_count)
    return out
