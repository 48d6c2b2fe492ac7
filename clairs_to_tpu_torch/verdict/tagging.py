# Port copy of clairs_to_tpu/verdict/tagging.py.
"""Verdict germline/somatic/subclonal binomial tagging.

Port of ClairS-TO src/verdict/tag_germline_variant.py:30-190: skip when
estimated purity > 0.6; for each PASS call inside a CNA segment compute the
expected germline/somatic AFs

    AF_G = (p*M + (1-p)) / (p*C + 2(1-p)),  AF_S = p*M / (p*C + 2(1-p))

for both minor/major allele assignments, binomial-test the observed support,
and walk the reference's log-odds decision tree to assign
Verdict_Germline (+LowQual) / Verdict_Somatic / Verdict_SubclonalSomatic.
"""

import sys
from math import inf, log10, nan, isnan

import numpy as np
from scipy.stats import binomtest

ALPHA = 0.01
EPS = sys.float_info.epsilon


def _nanmax(a, b):
    if isnan(a):
        return b
    if isnan(b):
        return a
    return max(a, b)


def classify_call(frequency, depth, purity, cn_major, cn_minor):
    """Returns (status, tag) where tag in {None, 'Verdict_Germline',
    'Verdict_Somatic', 'Verdict_SubclonalSomatic'}; Verdict_Germline also
    implies FILTER=LowQual (tag_germline_variant.py:113-186)."""
    p = purity
    M = cn_minor
    C = cn_major + cn_minor
    if M == 0:
        M = C - M
    AF_G1 = (p * M + (1 - p)) / (p * C + 2 * (1 - p) + EPS)
    AF_S1 = (p * M + 0) / (p * C + 2 * (1 - p) + EPS)
    k = round(depth * frequency)
    P_G1 = binomtest(min(k, depth), depth, min(AF_G1, 1.0)).pvalue
    P_S1 = binomtest(min(k, depth), depth, min(AF_S1, 1.0)).pvalue
    if M != C - M:
        AF_G2 = (p * (C - M) + (1 - p)) / (p * C + 2 * (1 - p) + EPS)
        P_G2 = binomtest(min(k, depth), depth, min(AF_G2, 1.0)).pvalue
        if C - M != 0:
            AF_S2 = (p * (C - M) + 0) / (p * C + 2 * (1 - p) + EPS)
            P_S2 = binomtest(min(k, depth), depth, min(AF_S2, 1.0)).pvalue
        else:
            AF_S2 = P_S2 = nan
    else:
        AF_G2 = AF_S2 = P_G2 = P_S2 = nan

    max_g = _nanmax(P_G1, P_G2)
    max_s = _nanmax(P_S1, P_S2)
    if max_s == 0:
        logodds = inf
    elif max_g == 0:
        logodds = -inf
    else:
        logodds = log10(max_g) - log10(max_s)

    if frequency < 0.05 and 0.2 < p < 0.6:
        return "subclonal somatic", "Verdict_SubclonalSomatic"
    if frequency > 0.95:
        return "germline", "Verdict_Germline"
    if max_g > ALPHA and max_s < ALPHA:
        if logodds < 2:
            return "probable germline", None
        if frequency > 0.25:
            return "germline", "Verdict_Germline"
        return "probable germline", None
    if max_g < ALPHA and max_s > ALPHA:
        if logodds > -2:
            return "probable somatic", None
        return "somatic", "Verdict_Somatic"
    if max_g > ALPHA and max_s > ALPHA:
        return "ambiguous_both_G_and_S", None
    if max_g < ALPHA and max_s < ALPHA:
        min_soma = AF_S1 if isnan(AF_S2) else min(AF_S1, AF_S2)
        min_germ = AF_G1 if isnan(AF_G2) else min(AF_G1, AF_G2)
        if p >= 0.3 and frequency < 0.25 and frequency < min_soma / 1.5 and min_soma <= min_germ:
            return "subclonal somatic", "Verdict_SubclonalSomatic"
        if p >= 0.3 and frequency < 0.25 and frequency < min_germ / 2.0 and min_germ < min_soma:
            return "subclonal somatic", "Verdict_SubclonalSomatic"
        if logodds < -5 and max_s > 1e-10:
            return "somatic", "Verdict_Somatic"
        if logodds > 5 and max_g > 1e-4:
            return "germline", "Verdict_Germline"
        return "ambiguous_neither_G_nor_S", None
    return "unknown", None


def tag_vcf_rows(rows, purity, segments):
    """Tag in-memory VCF row dicts.

    rows: dicts with CHROM/POS/AF/DP/FILTER/INFO; segments: list of
    (ctg, start_1based, end_1based, cn_major, cn_minor).  Skips entirely if
    purity > 0.6 (tag_germline_variant.py:38-40).  Returns tagged count.
    """
    if purity > 0.6:
        return 0
    n = 0
    for row in rows:
        if row["FILTER"] != "PASS":
            continue
        for (ctg, start, end, cn_major, cn_minor) in segments:
            if ctg == row["CHROM"] and start <= row["POS"] <= end:
                status, tag = classify_call(
                    row["AF"], int(row["DP"]), purity, cn_major, cn_minor
                )
                if tag is not None:
                    row["INFO"] = row["INFO"] + ";" + tag
                    if tag == "Verdict_Germline":
                        row["FILTER"] = "LowQual"
                    n += 1
                break
    return n
