# Port copy of clairs_to_tpu/verdict/logr_baf.py.
"""LogR / BAF computation + GC-replication correction + germline genotyping.

Array-native ports of the first half of the Verdict chain:

* ``logr_baf``       — src/verdict/get_logr_and_baf.py:14-160 (tumor-only):
  per-locus total depth and B-allele fraction (randomly picking ref- or
  alt-fraction like ASCAT), LogR = log2(total / mean(total)).
* ``correct_logr``   — src/verdict/correct_logr.py:8-95: residuals of LogR
  against B-spline bases of the best-correlated GC-content and replication
  timing columns (OLS via lstsq; sklearn not required).
* ``predict_germline_genotypes`` — src/verdict/predict_germline_genotypes.py
  (tumor-only branch): classify loci hom/het from the folded BAF
  distribution with windowed nearest-median rescue of ambiguous probes.
"""

import math

import numpy as np
from scipy.interpolate import BSpline


def logr_baf(ref_counts, alt_counts, rng=None):
    """Tumor-only LogR/BAF from per-locus ref/alt counts.

    Returns (logr, baf, keep_mask) over the input loci; loci with zero depth
    are masked out (get_logr_and_baf.py:77-82).
    """
    rng = rng or np.random.default_rng(0)
    ref_counts = np.asarray(ref_counts, dtype=np.float64)
    alt_counts = np.asarray(alt_counts, dtype=np.float64)
    total = ref_counts + alt_counts
    keep = total > 0
    totals = total[keep]
    # random choice of ref- or alt-fraction per locus (ASCAT convention)
    pick_ref = rng.random(keep.sum()) < 0.5
    baf = np.where(pick_ref, ref_counts[keep] / totals, alt_counts[keep] / totals)
    logr = np.log2(totals / totals.mean())
    return logr, baf, keep


def _bspline_basis(x, df=5, degree=3):
    # correct_logr.py:8-15
    n_knots = df - degree + 1
    knots = np.linspace(np.min(x), np.max(x), n_knots)
    knots = np.concatenate(([knots[0]] * degree, knots, [knots[-1]] * degree))
    spline = BSpline(knots, np.eye(len(knots) - degree - 1), degree)
    return np.vstack([spline(xi) for xi in x])


def correct_logr(logr, gc_content, replication_timing, index_1kb=5, index_max=11):
    """LogR residuals after GC + replication-timing spline regression.

    gc_content: (n, >=index_max+1) window-GC columns; replication_timing:
    (n, k).  Column choice by max |corr| (correct_logr.py:57-75).
    """
    logr = np.asarray(logr, dtype=np.float64)
    gc = np.asarray(gc_content, dtype=np.float64)
    rt = np.asarray(replication_timing, dtype=np.float64)

    # The reference takes row 0, columns 1: of the correlation matrix
    # (correct_logr.py:60,72) — i.e. correlations of the FIRST track column
    # against [the remaining columns, logr], indexed back into the raw
    # columns — not logr-vs-track.  Behavior-parity quirk kept verbatim
    # (golden-pinned by tests/test_golden_verdict_chain.py).
    corr_gc = np.abs(np.corrcoef(np.column_stack([gc, logr]),
                                 rowvar=False))[0, 1:]
    max_insert = int(np.argmax(corr_gc[: index_1kb + 1]))
    max_amplic = int(np.argmax(corr_gc[index_1kb + 2 : index_max + 1])) + index_1kb + 2
    corr_rep = np.abs(np.corrcoef(np.column_stack([rt, logr]),
                                  rowvar=False))[0, 1:]
    max_rep = int(np.argmax(corr_rep))

    X = np.hstack(
        [
            _bspline_basis(gc[:, max_insert]),
            _bspline_basis(gc[:, max_amplic]),
            _bspline_basis(rt[:, max_rep]),
            np.ones((len(logr), 1)),
        ]
    )
    coef, *_ = np.linalg.lstsq(X, logr, rcond=None)
    return logr - X @ coef


def predict_germline_genotypes(
    baf,
    chrom_index,
    max_homozygous=0.02,
    proportion_hetero=0.30,
    proportion_homo=0.65,
    proportion_open=0.03,
    segment_length=100,
):
    """Tumor-only hom/het classification (predict_germline_genotypes.py:8-166).

    Args: baf (n,), chrom_index (n,) int labels grouping loci by contig.
    Returns hom (n,) bool (True = homozygous).
    """
    baf = np.asarray(baf, dtype=np.float64)
    n = len(baf)
    bsm = np.where(baf < 0.5, baf, 1 - baf)
    sorted_bsm = np.sort(bsm)
    index = round(n * proportion_homo)
    value = sorted_bsm[min(index, n - 1)]
    homo_limit = max(value, max_homozygous)

    hom = np.where(bsm < homo_limit, 1.0, np.nan)  # 1=hom, nan=undecided
    undecided = int(np.sum(np.isnan(hom)))
    extra_hetero = round(min(proportion_hetero * n, undecided - proportion_open * n))

    if extra_hetero > 0:
        all_probes = np.arange(n)
        non_homo = all_probes[np.isnan(hom) | (hom == 0.0)]
        bsm_hna = bsm.copy()
        bsm_hna[hom == 1.0] = np.nan

        chrom_index = np.asarray(chrom_index)
        lowest_dist = []
        for c in np.unique(chrom_index):
            chr_probes = np.nonzero(chrom_index == c)[0]
            chr_nh = sorted(set(non_homo).intersection(chr_probes))
            if len(chr_nh) > 5:
                seg2 = min(len(chr_nh) - 1, segment_length)
                mid = seg2 // 2
                chr_nh_arr = np.asarray(chr_nh, dtype=float)
                sw_left = np.concatenate([np.full(seg2, np.nan), chr_nh_arr[: len(chr_nh) - seg2]])
                ew_left = np.concatenate([[np.nan], chr_nh_arr[:-1]])
                sw_right = np.concatenate([chr_nh_arr[1:], [np.nan]])
                ew_right = np.concatenate([chr_nh_arr[seg2:], np.full(seg2, np.nan)])
                sw_mid = np.concatenate([np.full(mid, np.nan), chr_nh_arr[: len(chr_nh) - mid]])
                ew_mid = np.concatenate([chr_nh_arr[mid:], np.full(mid, np.nan)])

                def _median(lo, hi):
                    if math.isnan(lo) or math.isnan(hi):
                        return np.nan
                    vals = bsm_hna[int(lo) : int(hi) + 1]
                    vals = vals[~np.isnan(vals)]
                    return np.median(vals) if len(vals) else np.nan

                chr_dist = []
                for k, probe in enumerate(chr_nh):
                    med_l = _median(sw_left[k], ew_left[k])
                    med_r = _median(sw_right[k], ew_right[k])
                    if not (math.isnan(sw_mid[k]) or math.isnan(ew_mid[k])):
                        left_vals = (
                            bsm_hna[int(sw_mid[k]) : int(ew_left[k]) + 1]
                            if not math.isnan(ew_left[k])
                            else np.array([])
                        )
                        right_vals = (
                            bsm_hna[int(sw_right[k]) : int(ew_mid[k]) + 1]
                            if not math.isnan(sw_right[k])
                            else np.array([])
                        )
                        both = np.concatenate([left_vals, right_vals])
                        both = both[~np.isnan(both)]
                        med_m = np.median(both) if both.size else np.nan
                    else:
                        med_m = np.nan
                    diffs = [
                        abs(m - bsm[probe])
                        for m in (med_l, med_r, med_m)
                        if not np.isnan(m)
                    ]
                    chr_dist.append(min(diffs) if diffs else np.inf)
            else:
                chr_dist = [1] * len(chr_nh)
            lowest_dist.extend(chr_dist)

        undecided_mask = np.isnan(hom[non_homo])
        cand = [lowest_dist[i] for i in range(len(non_homo)) if undecided_mask[i]]
        cand_idx = [non_homo[i] for i in range(len(non_homo)) if undecided_mask[i]]
        order = np.argsort(cand)
        for i in order[: min(len(order), extra_hetero)]:
            hom[cand_idx[i]] = 0.0

    hom[np.isnan(hom)] = 1.0
    return hom.astype(bool)
