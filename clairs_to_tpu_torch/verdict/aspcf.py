# Port copy of clairs_to_tpu/verdict/aspcf.py.
"""ASPCF — allele-specific piecewise-constant fitting (ASCAT segmentation).

Math port of ClairS-TO src/verdict/aspcf.py (itself a Python rewrite of
ASCAT's R implementation): MAD-winsorization, exact PCF via Potts filtering,
the windowed dual-signal (logR + mirrored BAF) dynamic program ``fastAspcf``,
and the per-chromosome assembly that maps segmented het-probe values back to
all probes.
"""

import math

import numpy as np
from scipy.ndimage import median_filter


def median_filter_odd(x, k):
    """Running median, window 2k+1 clamped to an odd width <= n (aspcf.py:355-372)."""
    n = len(x)
    width = 2 * k + 1
    if width > n:
        if n == 0:
            width = 1
        elif n % 2 == 0:
            width = n - 1
        else:
            width = n
    return median_filter(x, size=width, mode="reflect")


def get_mad(x, k=25):
    x = np.asarray(x, dtype=np.float64)
    x = x[x != 0]
    if len(x) == 0:
        return np.nan
    run_median = median_filter_odd(x, k)
    dif = x - run_median
    return np.median(np.abs(dif - np.median(dif)))


def mad_wins(x, tau, k):
    """MAD winsorization (aspcf.py:332-353)."""
    x = np.asarray(x, dtype=np.float64)
    xhat = median_filter_odd(x, k)
    d = x - xhat
    mad = np.median(np.abs(d - np.median(d)))
    z = tau * mad
    return xhat + np.clip(d, -z, z)


def exact_pcf(y, kmin, gamma):
    """Exact PCF via Potts filtering (aspcf.py:253-330)."""
    y = np.asarray(y, dtype=np.float64)
    N = len(y)
    yhat = np.zeros(N)
    if N < 2 * kmin:
        yhat[:] = np.mean(y)
        return yhat
    init_sum = np.sum(y[:kmin])
    init_kvad = np.sum(y[:kmin] ** 2)
    init_ave = init_sum / kmin
    best_cost = np.zeros(N)
    best_cost[kmin - 1] = init_kvad - init_sum * init_ave
    best_split = np.zeros(N, dtype=int)
    best_aver = np.zeros(N)
    best_aver[kmin - 1] = init_ave
    Sum = np.zeros(N)
    Kvad = np.zeros(N)
    Aver = np.zeros(N)
    Cost = np.zeros(N)
    kp1 = kmin + 1
    for k in range(kp1, 2 * kmin):
        Sum[kp1 - 1 : k] += y[k - 1]
        Aver[kp1 - 1 : k] = Sum[kp1 - 1 : k] / np.arange(k - kmin, 0, -1)
        Kvad[kp1 - 1 : k] += y[k - 1] ** 2
        best_aver[k - 1] = (init_sum + Sum[kp1 - 1]) / k
        best_cost[k - 1] = (init_kvad + Kvad[kp1 - 1]) - k * best_aver[k - 1] ** 2
    for n in range(2 * kmin, N + 1):
        yn = y[n - 1]
        Sum[kp1 - 1 : n] += yn
        Aver[kp1 - 1 : n] = Sum[kp1 - 1 : n] / np.arange(n - kmin, 0, -1)
        Kvad[kp1 - 1 : n] += yn * yn
        nM = n - kmin + 1
        Cost[kp1 - 1 : nM] = (
            best_cost[kmin - 1 : n - kmin]
            + Kvad[kp1 - 1 : nM]
            - Sum[kp1 - 1 : nM] * Aver[kp1 - 1 : nM]
            + gamma
        )
        Pos = int(np.argmin(Cost[kp1 - 1 : nM])) + kmin
        cost = Cost[Pos - 1]
        aver = Aver[Pos - 1]
        tot_aver = (Sum[kp1 - 1] + init_sum) / n
        tot_cost = (Kvad[kp1 - 1] + init_kvad) - n * tot_aver**2
        if tot_cost < cost:
            Pos = 1
            cost = tot_cost
            aver = tot_aver
        best_cost[n - 1] = cost
        best_aver[n - 1] = aver
        best_split[n - 1] = Pos - 1
    n = N
    while n > 0:
        yhat[best_split[n - 1] : n] = best_aver[n - 1]
        n = best_split[n - 1]
    return yhat


def _aspcf_part(logr_part, allb_flip, a, b, d, sd1, sd2, N_total, kmin, gamma):
    # aspcf.py:126-235
    from_idx = max(0, a)
    usefrom = max(0, a + d)
    useto = min(N_total, b - d)
    y1 = np.asarray(logr_part, dtype=np.float64)
    y2 = np.asarray(allb_flip, dtype=np.float64)
    N = len(y1)
    if N < 2 * kmin:
        return [0]
    init_sum1, init_kvad1 = np.sum(y1[:kmin]), np.sum(y1[:kmin] ** 2)
    init_ave1 = init_sum1 / kmin
    init_sum2, init_kvad2 = np.sum(y2[:kmin]), np.sum(y2[:kmin] ** 2)
    init_ave2 = init_sum2 / kmin
    best_cost = np.zeros(N)
    best_cost[kmin - 1] = (init_kvad1 - init_sum1 * init_ave1) / sd1**2 + (
        init_kvad2 - init_sum2 * init_ave2
    ) / sd2**2
    best_split = np.zeros(N, dtype=int)
    best_aver1 = np.zeros(N)
    best_aver2 = np.zeros(N)
    best_aver1[kmin - 1] = init_ave1
    best_aver2[kmin - 1] = init_ave2
    Sum1 = np.zeros(N); Sum2 = np.zeros(N)
    Kvad1 = np.zeros(N); Kvad2 = np.zeros(N)
    Aver1 = np.zeros(N); Aver2 = np.zeros(N)
    Cost = np.zeros(N)
    kp1 = kmin + 1
    for k in range(kp1, 2 * kmin):
        Sum1[kp1 - 1 : k] += y1[k - 1]
        Aver1[kp1 - 1 : k] = Sum1[kp1 - 1 : k] / np.arange(k - kmin, 0, -1)
        Kvad1[kp1 - 1 : k] += y1[k - 1] ** 2
        Sum2[kp1 - 1 : k] += y2[k - 1]
        Aver2[kp1 - 1 : k] = Sum2[kp1 - 1 : k] / np.arange(k - kmin, 0, -1)
        Kvad2[kp1 - 1 : k] += y2[k - 1] ** 2
        best_aver1[k - 1] = (init_sum1 + Sum1[kp1 - 1]) / k
        best_aver2[k - 1] = (init_sum2 + Sum2[kp1 - 1]) / k
        cost1 = ((init_kvad1 + Kvad1[kp1 - 1]) - k * best_aver1[k - 1] ** 2) / sd1**2
        cost2 = ((init_kvad2 + Kvad2[kp1 - 1]) - k * best_aver2[k - 1] ** 2) / sd2**2
        best_cost[k - 1] = cost1 + cost2
    for n in range(2 * kmin, N + 1):
        nM = n - kmin + 1
        Sum1[kp1 - 1 : n] += y1[n - 1]
        Aver1[kp1 - 1 : n] = Sum1[kp1 - 1 : n] / np.arange(n - kmin, 0, -1)
        Kvad1[kp1 - 1 : n] += y1[n - 1] ** 2
        cost1 = (Kvad1[kp1 - 1 : nM] - Sum1[kp1 - 1 : nM] * Aver1[kp1 - 1 : nM]) / sd1**2
        Sum2[kp1 - 1 : n] += y2[n - 1]
        Aver2[kp1 - 1 : n] = Sum2[kp1 - 1 : n] / np.arange(n - kmin, 0, -1)
        Kvad2[kp1 - 1 : n] += y2[n - 1] ** 2
        cost2 = (Kvad2[kp1 - 1 : nM] - Sum2[kp1 - 1 : nM] * Aver2[kp1 - 1 : nM]) / sd2**2
        Cost[kp1 - 1 : nM] = best_cost[kmin - 1 : n - kmin] + cost1 + cost2
        Pos = int(np.argmin(Cost[kp1 - 1 : nM])) + kmin
        cost = Cost[Pos - 1] + gamma
        aver1, aver2 = Aver1[Pos - 1], Aver2[Pos - 1]
        tot_aver1 = (Sum1[kp1 - 1] + init_sum1) / n
        tot_cost1 = ((Kvad1[kp1 - 1] + init_kvad1) - n * tot_aver1**2) / sd1**2
        tot_aver2 = (Sum2[kp1 - 1] + init_sum2) / n
        tot_cost2 = ((Kvad2[kp1 - 1] + init_kvad2) - n * tot_aver2**2) / sd2**2
        if tot_cost1 + tot_cost2 < cost:
            Pos = 1
            cost = tot_cost1 + tot_cost2
            aver1, aver2 = tot_aver1, tot_aver2
        best_cost[n - 1] = cost
        best_aver1[n - 1] = aver1
        best_aver2[n - 1] = aver2
        best_split[n - 1] = Pos - 1
    n = N
    breakpts = [n]
    while n > 0:
        breakpts.append(best_split[n - 1])
        n = best_split[n - 1]
    breakpts = np.array(breakpts) + from_idx - 1
    return breakpts[(breakpts >= usefrom) & (breakpts <= useto)].tolist()


def fast_aspcf(logr, allb, kmin, gamma):
    """Windowed dual-signal segmentation (aspcf.py:49-123).

    Returns (yhat_logr, yhat_baf) piecewise-constant fits.
    """
    logr = np.asarray(logr, dtype=np.float64)
    allb = np.asarray(allb, dtype=np.float64)
    N = len(logr)
    w, d = 1000, 100
    startw, stopw = -d, w - d
    nseg = 0
    var2 = var3 = 0.0
    breakpts = [0]
    while True:
        part = slice(max(0, startw), min(stopw, N))
        logr_part = logr[part]
        allb_part = allb[part]
        allb_flip = allb_part.copy()
        allb_flip[allb_part > 0.5] = 1 - allb_part[allb_part > 0.5]
        sd1 = get_mad(logr_part)
        sd2 = get_mad(allb_flip)
        sd3 = get_mad(allb_part)
        if not (np.isnan(sd1) or np.isnan(sd2)) and sd1 != 0 and sd2 != 0:
            bp = _aspcf_part(logr_part, allb_flip, startw, stopw, d, sd1, sd2, N, kmin, gamma)
            bp = np.asarray(bp)
            last = breakpts[-1]
            breakpts.extend(bp[bp > last])
            var2 += sd2**2
            var3 += sd3**2
            nseg += 1
        if stopw < N + d:
            startw = min(stopw - 2 * d + 1, N - 2 * d)
            stopw = startw + w
        else:
            break
    breakpts = sorted(set(list(breakpts) + [N]))
    if nseg == 0:
        nseg = 1
    sd2 = math.sqrt(var2 / nseg)
    frst = np.asarray(breakpts[:-1]) + 1
    last = np.asarray(breakpts[1:])
    yhat1 = np.full(N, np.nan)
    yhat2 = np.full(N, np.nan)
    for i in range(len(frst)):
        sl = slice(frst[i] - 1, last[i])
        yhat1[sl] = np.mean(logr[sl])
        yi2 = allb[sl]
        mu = np.mean(np.abs(yi2 - 0.5)) if len(yi2) else 0.0
        if math.sqrt(sd2**2 + mu**2) < 2 * sd2:
            mu = 0.0
        yhat2[sl] = mu + 0.5
    return yhat1, yhat2


def rle_lengths(arr):
    arr = np.asarray(arr)
    n = len(arr)
    if n == 0:
        return np.array([], dtype=int)
    y = arr[1:] != arr[:-1]
    i = np.append(np.nonzero(y)[0], n - 1)
    return np.diff(np.append(-1, i))


def fill_na(x, zero_is_na=False):
    """Linear-interpolation NaN fill (aspcf.py:392-412)."""
    out = np.asarray(x, dtype=np.float64).copy()
    if zero_is_na:
        out[out == 0] = np.nan
    nan = np.isnan(out)
    if nan.any() and (~nan).any():
        idx = np.nonzero(~nan)[0]
        out[nan] = np.interp(np.nonzero(nan)[0], idx, out[idx])
    return out


def hom_stretches(hom, chrom_groups):
    """Germline homozygous stretches (aspcf.py:14-46).

    hom: (n,) bool over ALL loci; chrom_groups: list of global index arrays
    per chromosome (file order).  Returns [[chrom_rank, g_start, g_end]].
    The run-length threshold comes from the genome-wide hom fraction:
    ceil(log(0.001)/log(perc_hom)).
    """
    n_hom = int(hom.sum())
    perchom = n_hom / len(hom)
    if perchom == 0.0:
        homthres = 0
    elif perchom == 1.0:
        homthres = 1
    else:
        homthres = math.ceil(math.log(0.001, perchom))
    out = []
    for rank, grp in enumerate(chrom_groups):
        hs = hom[grp]
        run = []
        for probe, value in enumerate(hs):
            if value:
                run.append(probe)
            elif run and len(run) >= homthres:
                out.append([rank, int(grp[run[0]]), int(grp[run[-1]])])
                run = []
            else:
                run = []
        if len(hs) and hs[-1] and run and len(run) >= homthres:
            out.append([rank, int(grp[run[0]]), int(grp[run[-1]])])
    if not out:
        out = [[0, 0, 0]]
    return out


def aspcf_segment(logr, baf, hom, chrom_index, penalty=100):
    """Per-chromosome ASPCF assembly (aspcf.py:425-640).

    Args:
      logr, baf: (n,) over all loci; hom: (n,) bool; chrom_index: (n,) labels.
      penalty: segmentation penalty (reference default 100; run_clairs_to passes
        1000 for sparser data, cna_germline_tagging.py:137).
    Returns (logr_pcfed (n,), baf_pcfed (n_het,), het_mask).
    """
    logr = np.asarray(logr, dtype=np.float64)
    baf = np.asarray(baf, dtype=np.float64)
    hom = np.asarray(hom, dtype=bool)
    chrom_index = np.asarray(chrom_index)
    if (~hom).sum() == 0:
        return None, None, ~hom

    segmentlengths = [l for l in sorted({penalty, 70, 100, 140}) if l >= penalty]
    chrom_labels = list(dict.fromkeys(chrom_index.tolist()))  # input order
    chrom_groups = [np.nonzero(chrom_index == c)[0] for c in chrom_labels]
    ghs = hom_stretches(hom, chrom_groups)
    logr_pcfed = np.array([])
    baf_pcfed = np.array([])
    for seglen in segmentlengths:
        logr_pcfed = np.array([])
        baf_pcfed = np.array([])
        for rank, c in enumerate(chrom_labels):
            chrom = chrom_groups[rank]
            lr = logr[chrom]
            lrwins = mad_wins(lr, 2.5, 25)
            bafc = baf[chrom]
            homo = hom[chrom]
            sel_het = ~homo
            bafsel = bafc[sel_het]
            mirrored = mad_wins(np.where(bafsel > 0.5, bafsel, 1 - bafsel), 2.5, 25)
            bafselwins = np.where(bafsel > 0.5, mirrored, 1 - mirrored)
            het_idx = np.nonzero(sel_het)[0]
            logr_avg = None
            if len(het_idx) != 0:
                avg_idx = np.concatenate(
                    ([0], (het_idx[:-1] + het_idx[1:]) / 2, [len(lr)])
                )
                starts = np.ceil(avg_idx[:-1]).astype(int)
                ends = np.floor(avg_idx[1:]).astype(int)
                if len(het_idx) == 1:
                    starts = [0]
                    ends = [len(lr) - 1]
                logr_avg = np.array(
                    [np.nanmean(lrwins[starts[i] : ends[i] + 1]) for i in range(len(het_idx))]
                )
            if logr_avg is not None and len(logr_avg) > 0:
                if len(logr_avg) < 6:
                    logr_aspcf = np.full(len(logr_avg), np.mean(logr_avg))
                    baf_aspcf = np.full(len(logr_avg), np.mean(mirrored))
                else:
                    logr_aspcf, baf_aspcf = fast_aspcf(logr_avg, bafselwins, 6, seglen)
                # expand het-probe segments back to all probes; the reference's
                # if/elif/else drops the first inter-probe interval and pads
                # the tail instead (aspcf.py:530-566) — quirk kept verbatim
                logr_c = np.array([], dtype=float)
                for probe in range(len(logr_aspcf)):
                    if probe == 0:
                        logr_c = np.concatenate(
                            (logr_c, np.full(het_idx[0], logr_aspcf[0]))
                        )
                    elif probe == len(logr_aspcf) - 1:
                        logr_c = np.concatenate(
                            (logr_c, np.full(len(lr) - het_idx[probe], logr_aspcf[probe]))
                        )
                    else:
                        start = het_idx[probe]
                        end = het_idx[probe + 1]
                        interval = end - start
                        if logr_aspcf[probe] == logr_aspcf[probe + 1]:
                            logr_c = np.concatenate(
                                (logr_c, np.full(interval, logr_aspcf[probe]))
                            )
                        else:
                            dvec = np.empty(interval)
                            for bp in range(interval):
                                dis = np.sum(np.abs(lr[start : start + bp] - logr_aspcf[probe]))
                                dis += np.sum(
                                    np.abs(lr[start + bp + 1 : end] - logr_aspcf[probe + 1])
                                )
                                dvec[bp] = dis
                            bp_best = int(np.argmin(dvec))
                            logr_c = np.concatenate(
                                (
                                    logr_c,
                                    np.full(bp_best, logr_aspcf[probe]),
                                    np.full(interval - bp_best, logr_aspcf[probe + 1]),
                                )
                            )
                last_length = len(lr) - len(logr_c)
                if last_length > 0:
                    logr_c = np.concatenate(
                        (logr_c, np.full(last_length, logr_aspcf[-1]))
                    )
                logr_c = logr_c[: len(lr)]
                # re-level each run with the raw mean (aspcf.py:572-585)
                seg = rle_lengths(logr_c)
                logr_d = np.array([], dtype=float)
                startp = 0
                for length in seg:
                    endp = startp + length
                    logr_d = np.concatenate(
                        (logr_d, np.full(length, np.nanmean(lr[startp:endp])))
                    )
                    startp = endp
                logr_pcfed = np.concatenate((logr_pcfed, logr_d))
                baf_pcfed = np.concatenate((baf_pcfed, baf_aspcf))
            else:
                logr_pcfed = np.concatenate(
                    (logr_pcfed, np.full(len(lr), np.nanmean(lr)))
                )

            # germline-homozygous-stretch override (aspcf.py:583-607): re-PCF
            # the raw logR around each hom stretch at penalty/4 and substitute
            # where it departs from the assembled fit by >0.3 at >5 probes.
            # Indices are GLOBAL; chromosomes are processed in input order so
            # the concatenated array lines up with them.
            startchr = int(chrom[0])
            endchr = int(chrom[-1])
            for (hrank, hs, he) in ghs:
                if hrank != rank:
                    continue
                startpos2 = max(hs - 100, startchr)
                endpos2 = min(he + 100, endchr)
                startpos3 = max(hs - 5, startchr)
                endpos3 = min(he + 5, endchr)
                towins = logr[startpos2:endpos2 + 1]
                ok = ~np.isnan(towins)
                pcfed = np.full(len(towins), np.nan)
                if ok.sum():
                    pcfed[ok] = exact_pcf(
                        mad_wins(towins[ok], 2.5, 25), 6, int(seglen / 4))
                pcfed2 = pcfed[startpos3 - startpos2: endpos3 - startpos2 + 1]
                target = logr_pcfed[startpos3:endpos3 + 1]
                if len(pcfed2) != len(target):
                    pcfed2 = pcfed2[: len(target)]
                dif = np.abs(pcfed2 - target)
                if not np.any(np.isnan(dif)) and np.sum(dif > 0.3) > 5:
                    logr_pcfed[startpos3:endpos3 + 1] = np.where(
                        dif > 0.3, pcfed2, target)

        # genome-wide re-level over the GLOBAL raw logR (aspcf.py:608-633),
        # then stop refining once the fit is piecewise enough (< 800 levels)
        logr_pcfed = fill_na(logr_pcfed, zero_is_na=True)
        seg = rle_lengths(logr_pcfed)
        parts = []
        startp = 0
        prevlevel = 0.0
        for length in seg:
            endp = startp + length
            level = np.nanmean(logr[startp:endp])
            if np.isnan(level):
                level = prevlevel
            else:
                prevlevel = level
            parts.append(np.full(length, level))
            startp = endp
        logr_pcfed = np.concatenate(parts) if parts else logr_pcfed
        if len(np.unique(logr_pcfed)) < 800:
            break

    # file convention: the reference writes 1 - yhat2 (<= 0.5) as the
    # segmented BAF (aspcf.py:636-637); downstream ASCAT consumes that.
    return logr_pcfed, 1 - baf_pcfed, ~hom
