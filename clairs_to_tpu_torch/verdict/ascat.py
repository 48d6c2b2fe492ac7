# Port copy of clairs_to_tpu/verdict/ascat.py.
"""ASCAT purity/ploidy grid search + copy-number segment assembly.

Math port of ClairS-TO src/verdict/run_ascat.py: segments from the
PCF-ed (logR, BAF) pair, a psi x rho distance grid (vectorized — the
reference's double loop over ~101x96 grid cells becomes one broadcasted
einsum-style reduction), local-minimum search with ASCAT's four fallback
ladders, and per-probe (nMajor, nMinor) assignment.
"""

from dataclasses import dataclass
from typing import Optional

import numpy as np


def make_segments(r, b):
    """Run-length segments of the (segmented logR, segmented BAF) pair
    (run_ascat.py:6-28). Returns (nseg, 3): logR, BAF, probe count."""
    r = np.asarray(r, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    segs = []
    prev_r, prev_b = 1e10, -1.0
    count = 0
    for i in range(len(r)):
        if b[i] != prev_b or r[i] != prev_r:
            if count > 0:
                segs[-1][-1] = count
            count = 1
            segs.append([r[i], b[i], count])
        else:
            count += 1
        prev_r, prev_b = r[i], b[i]
    if count > 0:
        segs[-1][-1] = count
    return np.asarray(segs, dtype=np.float64)


def _nA_nB(s, rho, psi, gamma):
    scale = 2 ** (s[:, 0] / gamma) * ((1 - rho) * 2 + rho * psi)
    nA = (rho - 1 - (s[:, 1] - 1) * scale) / rho
    nB = (rho - 1 + s[:, 1] * scale) / rho
    return nA, nB


def create_distance_matrix(s, gamma, psi_pos=None, rho_pos=None):
    """Vectorized psi x rho distance grid (run_ascat.py:31-60)."""
    if psi_pos is None:
        psi_pos = np.arange(1, 6.05, 0.05)
    if rho_pos is None:
        rho_pos = np.arange(0.1, 1.06, 0.01)
    w = s[:, 2] * np.where(s[:, 1] == 0.5, 0.05, 1.0)          # (nseg,)
    psi = psi_pos[:, None, None]
    rho = rho_pos[None, :, None]
    scale = 2 ** (s[None, None, :, 0] / gamma) * ((1 - rho) * 2 + rho * psi)
    nA = (rho - 1 - (s[None, None, :, 1] - 1) * scale) / rho   # (P, R, nseg)
    nB = (rho - 1 + s[None, None, :, 1] * scale) / rho
    use_a = np.nansum(nA, axis=2) < np.nansum(nB, axis=2)      # (P, R)
    nMinor = np.where(use_a[:, :, None], nA, nB)
    return np.nansum(
        np.abs(nMinor - np.maximum(np.round(nMinor), 0)) ** 2 * w[None, None, :],
        axis=2,
    )


def rle(x):
    x = np.asarray(x)
    n = len(x)
    y = x[1:] != x[:-1]
    i = np.append(np.nonzero(y)[0], n - 1)
    lengths = np.diff(np.append(-1, i))
    return lengths, x[i]


@dataclass
class AscatResult:
    purity: float
    ploidy: float
    psi: float
    goodness_of_fit: float
    nonaberrant: bool
    segments: list          # [(start_idx, end_idx, nMajor, nMinor)] probe idx
    n_major: np.ndarray     # per-probe
    n_minor: np.ndarray


def run_ascat(
    logr_seg_all,      # segmented logR over ALL probes (aspcf output)
    baf_seg_het,       # segmented BAF over het probes
    het_mask,          # bool over all probes
    baf_all,           # raw BAF over all probes
    gamma=1.0,
    min_ploidy=1.5,
    max_ploidy=5.5,
) -> Optional[AscatResult]:
    """Grid search + CNA assembly (run_ascat.py:72-470)."""
    het_indices = np.nonzero(het_mask)[0]
    if len(het_indices) == 0:
        return None
    r = np.asarray(logr_seg_all, dtype=np.float64)[het_indices]
    b = np.asarray(baf_seg_het, dtype=np.float64)
    r_ori = np.asarray(logr_seg_all, dtype=np.float64)

    s = make_segments(r, b)
    d = create_distance_matrix(s, gamma)
    w = s[:, 2] * np.where(s[:, 1] == 0.5, 0.05, 1.0)
    theoret_max = np.sum(0.25 * w)

    MINABB, MINABBREGION = 0.03, 0.005
    percent_abb = np.sum(np.where(s[:, 1] == 0.5, 0, 1) * s[:, 2]) / np.sum(s[:, 2])
    maxseg_abb = np.max(np.where(s[:, 1] == 0.5, 0, s[:, 2])) / np.sum(s[:, 2])
    nonaberrant = percent_abb <= MINABB and maxseg_abb <= MINABBREGION

    MINRHO = 0.2
    MINGOF = 60
    MINPERCZERO = 0.02
    MINPERCZEROABB = 0.1
    MINPERCODDEVEN = 0.05
    MINPLOIDYSTRICT, MAXPLOIDYSTRICT = 1.7, 2.3
    psi_values = np.arange(1.05, 6.05, 0.05)
    rho_values = np.round(np.arange(0.11, 1.06, 0.01), 2)

    def local_minima():
        mins = []
        for i in range(3, d.shape[0] - 3):
            for j in range(3, d.shape[1] - 3):
                m = d[i, j]
                seld = d[i - 3 : i + 4, j - 3 : j + 4].copy()
                seld[3, 3] = np.max(seld)
                if np.min(seld) > m:
                    mins.append((i, j, m))
        return mins

    minima = local_minima()

    def stats(i, j):
        psi, rho = psi_values[i], rho_values[j]
        nA, nB = _nA_nB(s, rho, psi, gamma)
        ploidy = np.sum((nA + nB) * s[:, 2]) / np.sum(s[:, 2])
        pz = (
            np.sum((np.round(nA) == 0) * s[:, 2]) + np.sum((np.round(nB) == 0) * s[:, 2])
        ) / np.sum(s[:, 2])
        abb = s[:, 1] != 0.5
        denom_abb = np.sum(s[:, 2] * abb)
        pz_abb = (
            (
                np.sum((np.round(nA) == 0) * s[:, 2] * abb)
                + np.sum((np.round(nB) == 0) * s[:, 2] * abb)
            )
            / denom_abb
            if denom_abb > 0
            else 0.0
        )
        podd = np.sum(
            (
                ((np.round(nA) % 2 == 0) & (np.round(nB) % 2 == 1))
                | ((np.round(nA) % 2 == 1) & (np.round(nB) % 2 == 0))
            )
            * s[:, 2]
        ) / np.sum(s[:, 2])
        gof = (1 - d[i, j] / theoret_max) * 100
        return psi, rho, ploidy, pz, pz_abb, podd, gof

    optima = []
    # ladder 1 (run_ascat.py:195-217)
    for (i, j, m) in minima:
        psi, rho, ploidy, pz, pz_abb, podd, gof = stats(i, j)
        if (
            not nonaberrant
            and min_ploidy < ploidy < max_ploidy
            and rho >= MINRHO
            and gof > MINGOF
            and pz > MINPERCZERO
        ):
            optima.append((m, i, j, ploidy, gof))
    # ladder 2 (:219-249)
    if not optima and min_ploidy < MAXPLOIDYSTRICT and max_ploidy > MINPLOIDYSTRICT:
        for (i, j, m) in minima:
            psi, rho, ploidy, pz, pz_abb, podd, gof = stats(i, j)
            if (
                MINPLOIDYSTRICT < ploidy < MAXPLOIDYSTRICT
                and rho >= MINRHO
                and gof > MINGOF
                and pz_abb > MINPERCZEROABB
            ):
                optima.append((m, i, j, ploidy, gof))
    # ladder 3 (:251-289)
    if not optima:
        for (i, j, m) in minima:
            psi, rho, ploidy, pz, pz_abb, podd, gof = stats(i, j)
            if (
                not nonaberrant
                and min_ploidy < ploidy < max_ploidy
                and rho >= MINRHO
                and gof > MINGOF
                and (pz_abb > MINPERCZEROABB or pz > MINPERCZERO or podd > MINPERCODDEVEN)
            ):
                optima.append((m, i, j, ploidy, gof))
    # ladder 4 (:291-327)
    if not optima and min_ploidy < MAXPLOIDYSTRICT and max_ploidy > MINPLOIDYSTRICT:
        for (i, j, m) in minima:
            psi, rho, ploidy, pz, pz_abb, podd, gof = stats(i, j)
            if MINPLOIDYSTRICT < ploidy < MAXPLOIDYSTRICT and rho >= MINRHO and gof > MINGOF:
                optima.append((m, i, j, ploidy, gof))

    if not optima:
        return None

    m_best, i_best, j_best, ploidy_best, gof_best = min(optima, key=lambda o: o[0])
    psi_opt = psi_values[i_best]
    rho_opt = min(rho_values[j_best], 1.0)

    # per-segment copy numbers over runs of r_ori (run_ascat.py:330-470)
    lengths, values = rle(r_ori)
    starts = np.cumsum(np.concatenate(([0], lengths)))[:-1]
    ends = np.cumsum(lengths) - 1
    seg = []
    for k in range(len(values)):
        logR = values[k]
        start, end = int(starts[k]), int(ends[k])
        sl = np.nonzero((het_indices > start) & (het_indices < end + 1))[0]
        if len(sl) == 0:
            sl = np.nonzero(
                (het_indices > start - 10000) & (het_indices < end + 1 + 10000)
            )[0]
        if len(sl) == 0:
            continue
        bafke = b[sl][0]
        scale = 2 ** (logR / gamma) * ((1 - rho_opt) * 2 + rho_opt * psi_opt)
        nAraw = (rho_opt - 1 - (bafke - 1) * scale) / rho_opt
        nBraw = (rho_opt - 1 + bafke * scale) / rho_opt
        if nAraw + nBraw < 0:
            nAraw = nBraw = 0.0
        elif nAraw < 0:
            nBraw += nAraw
            nAraw = 0.0
        elif nBraw < 0:
            nAraw += nBraw
            nBraw = 0.0
        limitround = 0.5
        if bafke == 0.5:
            if nAraw + nBraw > np.round(nAraw) + np.round(nBraw) + limitround:
                nA_, nB_ = np.round(nAraw) + 1, np.round(nBraw)
            elif nAraw + nBraw < np.round(nAraw) + np.round(nBraw) - limitround:
                nA_, nB_ = np.round(nAraw), np.round(nBraw) - 1
            else:
                nA_, nB_ = np.round(nAraw), np.round(nBraw)
        else:
            nA_, nB_ = np.round(nAraw), np.round(nBraw)
        seg.append([start, end, int(nA_), int(nB_)])
    seg = np.asarray(seg, dtype=np.int64)

    # merge equal-CN neighbors, 20 passes (run_ascat.py:411-426)
    for _ in range(20):
        new_seg = []
        skip = False
        for k in range(len(seg)):
            if skip:
                skip = False
                continue
            if (
                k != len(seg) - 1
                and seg[k, 2] == seg[k + 1, 2]
                and seg[k, 3] == seg[k + 1, 3]
            ):
                new_seg.append([seg[k, 0], seg[k + 1, 1], seg[k, 2], seg[k, 3]])
                skip = True
            else:
                new_seg.append(list(seg[k]))
        seg = np.asarray(new_seg, dtype=np.int64)

    n_major = np.zeros(len(r_ori))
    n_minor = np.zeros(len(r_ori))
    for (start, end, nA_, nB_) in seg:
        n_major[start : end + 1] = nA_
        n_minor[start : end + 1] = nB_

    # the reference's FINAL ploidy is the per-probe mean total copy number
    # (run_ascat.py:434-466: mean(n1all + n2all), whose het/hom branches sum
    # to nMajor+nMinor at every probe) — not the grid optimum's ploidy
    del ploidy_best
    return AscatResult(
        purity=float(rho_opt),
        ploidy=float(np.mean(n_major + n_minor)),
        psi=float(psi_opt),
        goodness_of_fit=float(gof_best),
        nonaberrant=bool(nonaberrant),
        segments=[tuple(row) for row in seg],
        n_major=n_major,
        n_minor=n_minor,
    )
