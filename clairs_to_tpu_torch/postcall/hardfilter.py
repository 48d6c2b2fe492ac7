# Port copy of clairs_to_tpu/postcall/hardfilter.py.
"""Hard post-calling filters on the entry table.

Port of ClairS-TO src/postfilter_variants.py (Illumina, no phasing):
for each PASS call, a ±100 bp window of the pileup yields four verdicts —

  ① pass_read_start_end  (>30% of alt reads start/end nearby -> fail;
     rows contribute their start/end reads only when marks >= 20% of the
     column, postfilter_variants.py:425-428; the larger of start/end set is
     used per row, :177)
  ② pass_co_exist        (variant cluster: >=3 co-segregating nearby
     variants among the alt reads, or inserted length/depth > 3, :296-345)
  ③ pass_strand_bias     (Fisher exact on alt/ref x fwd/rev, p<0.001,
     :347-356; exact pure-python Fisher :52-88)
  ④ pass_sequence_entropy (indels only: k=5-mer entropy of the 33 bp ref
     window < 0.9 -> fail, :90-141)

Failures turn the row LowQual (QUAL 0) plus tags ReadStartEnd /
VariantCluster / StrandBias / LowSeqEntropy; INFO gains SB=p (:484-520).

The same machinery, plus HP-phased verdicts, backs the long-read haplotype
filtering (postcall/haplotype.py).

The filter view matches the reference's mpileup invocation: --min-MQ 20
--min-BQ (platform), --excl-flags 2316 (:267-272).
"""

import math

import numpy as np

from clairs_to_tpu_torch import config as cfg

MIN_HOM_GERMLINE_AF = 0.75
EPS = 0.5
EPS_RSE = 0.2
SEQUENCE_ENTROPY_THRESHOLD = 0.9
FLANKING = 100

BASE2NUM = dict(zip("ACGTURYSWKMBDHVN-", (0, 1, 2, 3, 3, 0, 1, 1, 0, 2, 0, 1, 0, 0, 0, 0, 4)))


def _log_binom(n, k):
    return math.lgamma(n + 1) - math.lgamma(k + 1) - math.lgamma(n - k + 1)


_FISHER_MEMO = {}


def fisher_exact(table):
    """Two-sided Fisher exact test on a 2x2 table (memoized: strand
    tables repeat heavily across sites at a given depth profile).

    Same decision semantics as the reference's pure-Python test
    (postfilter_variants.py:52-88): sum P(X=x) over every table sharing the
    observed margins whose probability does not exceed the observed table's.
    Different formulation by design: the hypergeometric pmf is evaluated
    directly in log space (log-gamma) over its full support, instead of a
    multiplicative two-tail recurrence, with a scipy-style relative tie
    tolerance for the pmf comparison.

    Known divergence (deliberate): on symmetric-margin tables the opposite
    tail contains an exactly-tied mirror table; the reference's recurrence
    includes or excludes it depending on accumulated float round-off
    direction (measured: 238/341 included, 103/341 excluded on random
    symmetric tables), i.e. ~2x p-value noise irreproducible without copying
    its exact arithmetic.  This implementation always includes exact ties,
    matching scipy.stats.fisher_exact to <1e-12 relative error.
    """
    a, b, c, d = table[0][0], table[0][1], table[1][0], table[1][1]
    if a == b == c == d:
        return 1.0
    key = (a, b, c, d)
    hit = _FISHER_MEMO.get(key)
    if hit is not None:
        return hit
    m, n, k = a + b, c + d, a + c
    log_denom = _log_binom(m + n, k)
    log_obs = _log_binom(m, a) + _log_binom(n, k - a) - log_denom
    cutoff = log_obs + 1e-7  # include ties: lp <= log_obs * (1 + ~1e-7)
    p = 0.0
    for x in range(max(0, k - n), min(k, m) + 1):
        lp = _log_binom(m, x) + _log_binom(n, k - x) - log_denom
        if lp <= cutoff:
            p += math.exp(lp)
    p = min(p, 1.0)
    if len(_FISHER_MEMO) < 200_000:
        _FISHER_MEMO[key] = p
    return p


def fisher_exact_reference(table):
    """Bit-exact recurrence-parity two-sided Fisher test (opt-in).

    Reproduces the reference's arithmetic exactly
    (ClairS-TO src/postfilter_variants.py:52-88,
    src/haplotype_filtering.py:60-96): the observed-table probability from
    exact integer binomials (one correctly-rounded float division), then a
    multiplicative float recurrence walking each tail, accumulating tables
    with curP <= t.  On symmetric-margin tables the opposite tail's
    exactly-tied mirror is included or excluded purely by float round-off
    direction — that round-off is the point of this mode: selecting it
    (--exact_reference_fisher) makes the PASS set bitwise-identical to the
    reference pipeline's, where the default ``fisher_exact`` deliberately
    always includes exact ties (scipy semantics; see its docstring).
    """
    a, b, c, d = table[0][0], table[0][1], table[1][0], table[1][1]
    if a == b == c == d:
        return 1.0
    t = math.comb(a + b, a) * math.comb(c + d, c) / math.comb(a + b + c + d,
                                                              a + c)
    # each tail accumulates in its own partial sum before joining p — float
    # addition is non-associative, so the summation ORDER is part of parity
    left = 0.0
    cur = float(t)
    aa, bb, cc, dd = a, b, c, d
    while aa > 0 and dd > 0:
        cur *= aa * dd
        aa -= 1
        bb += 1
        cc += 1
        dd -= 1
        cur /= bb * cc
        if cur <= t:
            left += cur
    right = 0.0
    cur = float(t)
    aa, bb, cc, dd = a, b, c, d
    while bb > 0 and cc > 0:
        cur *= bb * cc
        aa += 1
        bb -= 1
        cc -= 1
        dd += 1
        cur /= aa * dd
        if cur <= t:
            right += cur
    return t + left + right


def calculate_sequence_entropy(sequence, entropy_window, kmer=5):
    """Shannon entropy of the k-mer multiset over the final
    ``entropy_window`` k-mer frames of ``sequence``.

    Direct histogram formulation of the quantity the reference computes
    with an incremental enter/leave recurrence (postfilter_variants.py:
    90-135): frames are the rolling 2-bit-packed k-mers ending at each
    base (implicitly left-padded with code-0 bases), the last
    ``entropy_window`` of which survive in the reference's final counter
    state; entropy is normalized by ``log(entropy_window)``.  Validated
    against the reference by tests/test_golden_filters.py.
    """
    W = entropy_window
    n = np.array([BASE2NUM.get(ch, 0) for ch in sequence], dtype=np.int64)
    if len(n) == 0:
        return 0.0
    padded = np.concatenate([np.zeros(kmer - 1, np.int64), n])
    weights = 4 ** np.arange(kmer - 1, -1, -1, dtype=np.int64)
    frames = np.lib.stride_tricks.sliding_window_view(padded, kmer) @ weights
    frames &= (1 << (2 * kmer)) - 1
    frames = frames[max(0, len(frames) - W):]
    counts = np.unique(frames, return_counts=True)[1]
    freq = counts / float(W)
    return float(-(freq * np.log(freq)).sum() / math.log(W))


class FilterVerdict:
    def __init__(self):
        self.pass_read_start_end = True
        self.pass_co_exist = True
        self.pass_strand_bias = True
        self.pass_sequence_entropy = True
        self.strand_bias_p = 1.0
        self.strand_table = None

    @property
    def pass_all(self):
        return (
            self.pass_read_start_end
            and self.pass_co_exist
            and self.pass_strand_bias
            and self.pass_sequence_entropy
        )


_INDEL_NONE, _INDEL_INS, _INDEL_DEL = 0, 1, 2
# base-identity of an uppercased entry: codes 0-7 fold to ACGT 0-3,
# 8 ('*') and 9 ('#') stay distinct; 10/11 (N fwd/rev) fold to the ref-token
# sentinel 10 (skip-family entries are excluded from the filter view anyway)
_BASE_ID = np.array([0, 1, 2, 3, 0, 1, 2, 3, 8, 9, 10, 10], np.int16)
_REF_TOK = np.full(256, 10, np.int16)
for _i, _ch in enumerate("ACGT"):
    _REF_TOK[ord(_ch)] = _i


class FilterIndex:
    """Per-chunk vectorized index backing the hard/haplotype filter verdicts.

    Replaces per-site Python loops over ±100 bp of per-entry strings with chunk-level precomputes on the
    columnar entry table, sized so that construction itself stays cheap on
    deep chunks (the table can hold 10⁷-10⁸ entries):

      * a stable counting-sort permutation (``orig`` + per-column offsets)
        giving O(1) access to any column's entries in original order — the
        only full-table sort;
      * heavy per-entry arrays (integer *tokens* encoding the uppercased
        mpileup entry string, read ids) only for the ~1-2 %% of entries that
        differ from the reference base — the only entries the
        variant-cluster verdict ever inspects;
      * per-column depth, inserted-length prefix sums, pure-ref-column
        flags, and (pos, token) count lookups;
      * the read-start/end "marked read" set, which the reference
        recomputes per site although it is site-independent
        (postfilter_variants.py:419-430, haplotype_filtering.py:358-373).
    """

    def __init__(self, pileup_engine, min_bq, min_mq, site_positions=None):
        """site_positions: optional iterable of 0-based verdict sites.  When
        given, the index only materializes columns within +-FLANKING of a
        site — every verdict reads nothing beyond that window, and at
        realistic site density (10-100 sites per Mb vs 10^6 columns) this
        cuts index size and build time by orders of magnitude.  Columns
        outside the mask read as empty (verdicts at unlisted positions
        would silently see no coverage; callers pass their full site set).
        """
        pe = pileup_engine
        if getattr(pe, "_win", None) is not None:
            # lazy fused-window engine: materialize exactly the verdict
            # windows (or everything, for callers without a site list)
            if site_positions is not None:
                pe.ensure_sites(site_positions, FLANKING)
            else:
                pe.ensure_all()
        a = pe._finalize()
        self.pe = pe
        self.a = a
        n = len(a["pos"])
        if n == 0:
            self._init_empty()
            return
        self.p0 = int(a["pos"].min())
        self.p1 = int(a["pos"].max()) + 1
        m = self.p1 - self.p0
        self.col_mask = None
        if site_positions is not None:
            sites = np.asarray(sorted(set(int(p) for p in site_positions)),
                               np.int64)
            self.col_mask = np.zeros(m, np.uint8)
            for p in sites:
                lo = max(int(p) - FLANKING, self.p0) - self.p0
                hi = min(int(p) + FLANKING + 1, self.p1) - self.p0
                if hi > lo:
                    self.col_mask[lo:hi] = 1

        # ref token per column
        ref_lo = self.p0 - pe.ref_start
        ref_arr = np.frombuffer(pe.ref_seq.encode("latin-1"), np.uint8)
        self.ref_tok = np.full(m, 10, np.int16)
        src_lo, src_hi = max(ref_lo, 0), min(ref_lo + m, len(ref_arr))
        if src_hi > src_lo:
            self.ref_tok[src_lo - ref_lo: src_hi - ref_lo] = \
                _REF_TOK[ref_arr[src_lo:src_hi]]

        from clairs_to_tpu_torch.bamio import native
        lib = native.get_lib()
        if lib is not None:
            self._init_native(lib, a, n, m, min_bq, min_mq, native)
        else:
            self._init_numpy(a, n, m, min_bq, min_mq)

        # ---- shared small post-processing (everything below is O(m) or
        # O(non-ref entries), both tiny next to the table) ----------------
        self.col_start = np.concatenate(
            [np.zeros(1, np.int64), np.cumsum(self.depth)])
        self.col_only_ref = (self.depth > 0) & (self._nonref_cnt == 0)
        self.cum_ins = np.concatenate([[0.0], np.cumsum(self.col_ins)])

        # insertion sequences: unique uppercased strings -> dense ids
        self._ins_id_of = {}
        nr_ik = self.nr_ik
        iseq_id = np.zeros(len(nr_ik), np.int64)
        iseq = pe._iseq
        for t in np.nonzero(nr_ik == _INDEL_INS)[0]:
            s = iseq[int(self.nr_entry[t])].upper()
            iseq_id[t] = self._ins_id_of.setdefault(s, len(self._ins_id_of) + 1)
        nr_base = self.nr_base.astype(np.int64)
        nr_ik64 = nr_ik.astype(np.int64)
        sub = np.where(nr_ik64 == _INDEL_INS, iseq_id,
                       np.where(nr_ik64 == _INDEL_DEL,
                                self.nr_ilen.astype(np.int64), 0))
        self.nr_token = nr_base + nr_ik64 * 16 + sub * 64
        self.nr_bare_del = (nr_ik64 == _INDEL_NONE) & (nr_base >= 8)
        self.T = int(self.nr_token.max()) + 11 if len(self.nr_token) else 11

        # full-column (pos, token) counts: every entry with a non-ref token
        # IS a non-ref entry, so non-ref counts equal full-column counts
        ckey = self.nr_pos * self.T + self.nr_token
        self.colkey, self.colkey_cnt = np.unique(ckey, return_counts=True)

        self._read_flag = np.zeros(self.n_reads, bool)

    def _init_native(self, lib, a, n, m, min_bq, min_mq, native):
        """Two fused C++ passes (bamio/native/pileup_native.cpp:
        entry_filter_stats / entry_filter_extract), each split across two
        worker threads (ctypes releases the GIL; the passes are
        memory-bandwidth bound).  The counting sort stays stable because
        thread 0 owns the lower entry-index range and its per-column
        offsets precede thread 1's."""
        import ctypes
        from concurrent.futures import ThreadPoolExecutor

        c = lambda x: np.ascontiguousarray(x)  # noqa: E731
        ptr = lambda x: x.ctypes.data_as(ctypes.c_void_p)  # noqa: E731
        pos = c(a["pos"]); code = c(a["code"]); bq = c(a["bq"])
        mq = c(a["mq"]); ikind = c(a["ikind"]); ilen = c(a["ilen"])
        read_id = c(a["read_id"]); eflags = c(a["eflags"])
        entry_args = (ptr(pos), ptr(code), ptr(bq), ptr(mq), ptr(ikind),
                      ptr(ilen), ptr(read_id), ptr(eflags))
        mask_ptr = (ptr(self.col_mask) if self.col_mask is not None
                    else ctypes.c_void_p(0))
        n_threads = 2 if n >= 4_000_000 else 1
        bounds = [(n * t // n_threads, n * (t + 1) // n_threads)
                  for t in range(n_threads)]

        def run_stats(rng_):
            j0, j1 = rng_
            cols = [np.empty(m, np.int64) for _ in range(5)]
            ns = ctypes.c_int64(0)
            nn = ctypes.c_int64(0)
            mr = ctypes.c_int64(0)
            lib.entry_filter_stats(
                j0, j1, *entry_args,
                self.p0, m, int(min_bq), int(min_mq), 2 * FLANKING,
                ptr(self.ref_tok), mask_ptr, *(ptr(x) for x in cols),
                ctypes.byref(ns), ctypes.byref(nn), ctypes.byref(mr),
            )
            return cols, int(ns.value), int(nn.value), int(mr.value)

        with ThreadPoolExecutor(n_threads) as ex:
            parts = list(ex.map(run_stats, bounds))
        depth = sum(p[0][0] for p in parts)
        nstarts = sum(p[0][1] for p in parts)
        nends = sum(p[0][2] for p in parts)
        nonref_cnt = sum(p[0][3] for p in parts)
        col_ins = sum(p[0][4] for p in parts)
        ns_total = sum(p[1] for p in parts)
        nn_total = sum(p[2] for p in parts)
        max_read = max(p[3] for p in parts)
        self.depth = depth
        self._nonref_cnt = nonref_cnt
        self.col_ins = col_ins.astype(np.float64)
        self.n_reads = max_read + 1 if max_read >= 0 else 1

        side_start = nstarts > nends
        marked_len = np.where(side_start, nstarts, nends)
        colcond = (marked_len >= depth * EPS_RSE) & (depth > 0)
        col_side = np.where(colcond,
                            np.where(side_start, 1, 2), 0).astype(np.int8)

        base_sort = np.concatenate(
            [np.zeros(1, np.int64), np.cumsum(depth)])[:-1]
        base_nr = np.concatenate(
            [np.zeros(1, np.int64), np.cumsum(nonref_cnt)])[:-1]
        self.orig = native.huge_empty(ns_total, np.int32)
        self.nr_entry = np.empty(nn_total, np.int32)
        self.nr_pos = np.empty(nn_total, np.int64)
        self.nr_read = np.empty(nn_total, np.int32)
        self.nr_base = np.empty(nn_total, np.int8)
        self.nr_ik = np.empty(nn_total, np.int8)
        self.nr_ilen = np.empty(nn_total, np.int32)

        # per-thread start offsets: thread t starts after threads <t's
        # per-column contributions
        sort_ofs_t, nr_ofs_t, rse_caps = [], [], []
        acc_d = np.zeros(m, np.int64)
        acc_n = np.zeros(m, np.int64)
        for (cols, _ns, _nn, _mr) in parts:
            sort_ofs_t.append(base_sort + acc_d)
            nr_ofs_t.append(base_nr + acc_n)
            cap = int(np.where(colcond,
                               np.where(side_start, cols[1], cols[2]),
                               0).sum())
            rse_caps.append(cap)
            acc_d += cols[0]
            acc_n += cols[3]

        def run_extract(t):
            j0, j1 = bounds[t]
            rse_pos = np.empty(rse_caps[t], np.int64)
            rse_read = np.empty(rse_caps[t], np.int32)
            n_rse = ctypes.c_int64(0)
            lib.entry_filter_extract(
                j0, j1, *entry_args,
                self.p0, m, int(min_bq), int(min_mq), ptr(self.ref_tok),
                mask_ptr, ptr(col_side), ptr(sort_ofs_t[t]),
                ptr(nr_ofs_t[t]),
                ptr(self.orig), ptr(self.nr_entry), ptr(self.nr_pos),
                ptr(self.nr_read), ptr(self.nr_base), ptr(self.nr_ik),
                ptr(self.nr_ilen),
                ptr(rse_pos), ptr(rse_read), ctypes.byref(n_rse),
            )
            return rse_pos[: n_rse.value], rse_read[: n_rse.value]

        with ThreadPoolExecutor(n_threads) as ex:
            outs = list(ex.map(run_extract, range(n_threads)))
        rse_pos = np.concatenate([o[0] for o in outs])
        rse_read = np.concatenate([o[1] for o in outs])
        ro = np.argsort(rse_pos, kind="stable")
        self.rse_pos = rse_pos[ro]
        self.rse_read = rse_read[ro].astype(np.int64)
        self.nr_read = self.nr_read.astype(np.int64)

    def _init_numpy(self, a, n, m, min_bq, min_mq):
        """Pure-numpy fallback with identical outputs (tests cross-validate
        the two paths via the golden filter suite)."""
        sel = (a["mq"] >= min_mq) & (a["bq"] >= min_bq) & (a["code"] < 10)
        if self.col_mask is not None:
            rel_all = a["pos"] - self.p0
            sel &= self.col_mask[rel_all].astype(bool)
        sel_idx = np.nonzero(sel)[0]
        pos_sel = a["pos"][sel_idx]
        rel = (pos_sel - self.p0).astype(np.int64)
        order = np.argsort(rel, kind="stable")
        self.orig = sel_idx[order].astype(np.int32)
        self.depth = np.bincount(rel, minlength=m).astype(np.int64)
        self.n_reads = int(a["read_id"][sel_idx].max()) + 1 if len(sel_idx) else 1

        code_sel = a["code"][sel_idx]
        ik_sel = a["ikind"][sel_idx]
        base_sel = _BASE_ID[code_sel]
        is_ref = (ik_sel == _INDEL_NONE) & (base_sel == self.ref_tok[rel])
        nr_local = np.nonzero(~is_ref)[0]
        nr_rel = rel[nr_local]
        nr_order = np.argsort(nr_rel, kind="stable")
        nr_local = nr_local[nr_order]
        self._nonref_cnt = np.bincount(nr_rel, minlength=m)
        nr_orig = sel_idx[nr_local]
        self.nr_entry = nr_orig.astype(np.int32)
        self.nr_pos = a["pos"][nr_orig].astype(np.int64)
        self.nr_read = a["read_id"][nr_orig].astype(np.int64)
        self.nr_base = base_sel[nr_local]
        self.nr_ik = ik_sel[nr_local]
        self.nr_ilen = a["ilen"][nr_orig]

        ins_m = (self.nr_ik == _INDEL_INS) & (self.nr_ilen > 2)
        self.col_ins = np.bincount(
            nr_rel[nr_order][ins_m],
            weights=np.minimum(self.nr_ilen[ins_m], 2 * FLANKING),
            minlength=m)

        st_rows = np.nonzero(((a["eflags"] & 1) > 0) & sel)[0]
        en_rows = np.nonzero(((a["eflags"] & 2) > 0) & sel)[0]
        rel_st = (a["pos"][st_rows] - self.p0).astype(np.int64)
        rel_en = (a["pos"][en_rows] - self.p0).astype(np.int64)
        nstarts = np.bincount(rel_st, minlength=m)
        nends = np.bincount(rel_en, minlength=m)
        side_start = nstarts > nends
        marked_len = np.where(side_start, nstarts, nends)
        colcond = (marked_len >= self.depth * EPS_RSE) & (self.depth > 0)
        mk = np.concatenate([
            st_rows[colcond[rel_st] & side_start[rel_st]],
            en_rows[colcond[rel_en] & ~side_start[rel_en]],
        ])
        rse_pos = a["pos"][mk]
        ro = np.argsort(rse_pos, kind="stable")
        self.rse_pos = rse_pos[ro].astype(np.int64)
        self.rse_read = a["read_id"][mk][ro].astype(np.int64)

    def _init_empty(self):
        self.col_mask = None
        self.p0 = self.p1 = 0
        self.orig = np.zeros(0, np.int32)
        self.depth = np.zeros(0, np.int64)
        self.col_start = np.zeros(1, np.int64)
        self.ref_tok = np.zeros(0, np.int16)
        self.nr_pos = np.zeros(0, np.int64)
        self.nr_read = np.zeros(0, np.int64)
        self.nr_token = np.zeros(0, np.int64)
        self.nr_bare_del = np.zeros(0, bool)
        self._ins_id_of = {}
        self.T = 11
        self.col_only_ref = np.zeros(0, bool)
        self.col_ins = np.zeros(0, np.float64)
        self.cum_ins = np.zeros(1, np.float64)
        self.colkey = np.zeros(0, np.int64)
        self.colkey_cnt = np.zeros(0, np.int64)
        self.rse_pos = np.zeros(0, np.int64)
        self.rse_read = np.zeros(0, np.int64)
        self.n_reads = 1
        self._read_flag = np.zeros(1, bool)

    # -- column access (original table rows, original entry order) --------
    def col_rows(self, p):
        if not (self.p0 <= p < self.p1):
            return self.orig[0:0]
        c = p - self.p0
        return self.orig[self.col_start[c]:self.col_start[c + 1]]

    def rev_at(self, rows):
        code = self.a["code"][rows]
        return ((code >= 4) & (code < 8)) | (code == 9)

    def col_token_count(self, p, tok):
        k = p * self.T + tok
        i = int(np.searchsorted(self.colkey, k))
        if i < len(self.colkey) and self.colkey[i] == k:
            return int(self.colkey_cnt[i])
        return 0

    def center_state(self, pos0):
        """Per-read center-column state with the reference's dict
        semantics (last entry of a read wins): (table_rows, read_ids).

        A read contributes at most ONE entry per column by construction
        (pileup.py add_read / the native decoders), so the per-read
        "last wins" dedup is the identity — returned in column order
        (every consumer is order-insensitive: masks, set ops, bincounts).
        Pinned by test_golden_filters/test_fused_decode."""
        rows = self.col_rows(pos0)
        return rows, self.a["read_id"][rows].astype(np.int64)

    def alt_rows_mask(self, rows, ref_base, alt_base):
        """Boolean mask over column rows: entry string equals this alt
        (postfilter_variants.py:281-294).  SNV: exact base, no indel
        suffix.  INS: base+iseq == alt.  DEL: deleted length matches."""
        a = self.a
        ik = a["ikind"][rows]
        is_del = len(ref_base) > 1 and len(alt_base) == 1
        if is_del:
            return (ik == _INDEL_DEL) & (a["ilen"][rows] + 1 == len(ref_base))
        is_snp = len(ref_base) == 1 and len(alt_base) == 1
        base = _BASE_ID[a["code"][rows]]
        if is_snp:
            i = "ACGT".find(alt_base)
            if i < 0:
                return np.zeros(len(rows), bool)
            return (ik == _INDEL_NONE) & (base == i)
        if len(ref_base) == 1 and len(alt_base) > 1:
            i = "ACGT".find(alt_base[0])
            if i < 0:
                return np.zeros(len(rows), bool)
            out = (ik == _INDEL_INS) & (base == i)
            want = alt_base[1:].upper()
            for k in np.nonzero(out)[0]:
                if self.pe._iseq[int(rows[k])].upper() != want:
                    out[k] = False
            return out
        return np.zeros(len(rows), bool)

    # -- site-level verdict kernels ---------------------------------------
    def rse_hits(self, win_lo, win_hi, alt_ids):
        """#distinct alt reads among the marked start/end reads in window."""
        s = int(np.searchsorted(self.rse_pos, win_lo, "left"))
        e = int(np.searchsorted(self.rse_pos, win_hi + 1, "left"))
        rr = self.rse_read[s:e]
        if len(rr) == 0 or len(alt_ids) == 0:
            return 0
        rf = self._read_flag
        rf[alt_ids] = True
        hits = np.unique(rr[rf[rr]])
        rf[alt_ids] = False
        return len(hits)

    def co_exist(self, pos0, win_lo, win_hi, alt_ids):
        """(match_count, ins_length) for the variant-cluster verdict
        (postfilter_variants.py:296-345 / haplotype_filtering.py:394-435)."""
        lo_c = min(max(win_lo - self.p0, 0), self.p1 - self.p0)
        hi_c = min(max(win_hi + 1 - self.p0, 0), self.p1 - self.p0)
        ins_length = float(self.cum_ins[hi_c] - self.cum_ins[lo_c])
        if self.p0 <= pos0 < self.p1:
            ins_length -= float(self.col_ins[pos0 - self.p0])
        A = len(alt_ids)
        if A == 0:
            return 0, ins_length
        s = int(np.searchsorted(self.nr_pos, win_lo, "left"))
        e = int(np.searchsorted(self.nr_pos, win_hi + 1, "left"))
        if s == e:
            return 0, ins_length
        rf = self._read_flag
        rf[alt_ids] = True
        m = (rf[self.nr_read[s:e]]
             & ~self.nr_bare_del[s:e]
             & (self.nr_pos[s:e] != pos0))
        rf[alt_ids] = False
        if not m.any():
            return 0, ins_length
        p_c = self.nr_pos[s:e][m]
        key = p_c * self.T + self.nr_token[s:e][m]
        j_c = np.nonzero(m)[0]
        order = np.argsort(key, kind="stable")
        key_s = key[order]
        uk, first_i, counts = np.unique(key_s, return_index=True,
                                        return_counts=True)
        first_j = j_c[order][first_i]       # earliest entry of each token
        cols = uk // self.T
        col_u, col_first = np.unique(cols, return_index=True)
        mx = np.maximum.reduceat(counts, col_first)
        cand = np.nonzero((mx > A * (1 - EPS)) & (mx < A * (1 + EPS))
                          & ~self.col_only_ref[col_u - self.p0])[0]
        match_count = 0
        bounds = np.append(col_first, len(uk))
        for gi in cand:
            a_, b_ = bounds[gi], bounds[gi + 1]
            cnts = counts[a_:b_]
            top = int(mx[gi])
            ties = np.nonzero(cnts == top)[0]
            # Counter.most_common breaks count ties by insertion order =
            # first occurrence among the column's alt entries
            ti = ties[np.argmin(first_j[a_:b_][ties])] if len(ties) > 1 else ties[0]
            top_tok = int(uk[a_:b_][ti] % self.T)
            if self.col_token_count(int(col_u[gi]), top_tok) >= top * (1 + EPS):
                continue
            match_count += 1
        return match_count, ins_length


class WindowFilterIndex(FilterIndex):
    """FilterIndex served from the fused decode's filter-view accumulation.

    The decode pass (bamio/native pileup_window_reduce) already emitted,
    under the filter view (mq>=20, bq>=0, skip-family excluded):

      * dense per-column depth / non-ref counts / inserted-length sums over
        the extended span [win.filt_start, win.filt_end),
      * the non-ref entry stream (rel, read, base, ikind, ilen, distinct-seq
        sub id), per-column subsequences in mpileup order,
      * every read start/end mark.

    So nothing here touches a full entry table: full-column entry rows are
    needed only at verdict CENTER and germline columns — which the calling
    pipeline already fetched at radius 0 (candidate columns) — and the rest
    assembles in O(non-ref + columns).  Cross-validated against FilterIndex
    by tests/test_fused_decode.py.
    """

    def __init__(self, pileup_engine, min_bq, min_mq, site_positions=None,
                 extra_columns=None):
        pe = pileup_engine
        win = pe._win
        assert win is not None and win.has_filter_data
        assert (min_bq, min_mq) == (win.filt_min_bq, win.filt_min_mq)
        self.pe = pe
        need = list(site_positions or [])
        if extra_columns:
            need += list(extra_columns)
        pe.ensure_sites(need, 0)
        a = pe._finalize()
        self.a = a

        self.p0 = int(win.filt_start)
        self.p1 = int(win.filt_end)
        m = self.p1 - self.p0
        self.col_mask = None

        # ref token per column (sites' ref bases; dense from pe.ref_seq)
        ref_lo = self.p0 - pe.ref_start
        ref_arr = np.frombuffer(pe.ref_seq.encode("latin-1"), np.uint8)
        self.ref_tok = np.full(m, 10, np.int16)
        src_lo, src_hi = max(ref_lo, 0), min(ref_lo + m, len(ref_arr))
        if src_hi > src_lo:
            self.ref_tok[src_lo - ref_lo: src_hi - ref_lo] = \
                _REF_TOK[ref_arr[src_lo:src_hi]]

        # -- full-column rows at fetched (site) columns only ---------------
        sel = ((a["mq"] >= min_mq) & (a["bq"] >= min_bq) & (a["code"] < 10))
        sel_idx = np.nonzero(sel)[0]
        rel = (a["pos"][sel_idx] - self.p0).astype(np.int64)
        inb = (rel >= 0) & (rel < m)
        sel_idx, rel = sel_idx[inb], rel[inb]
        order = np.argsort(rel, kind="stable")
        self.orig = sel_idx[order].astype(np.int32)
        tab_depth = np.bincount(rel, minlength=m).astype(np.int64)
        self.col_start = np.concatenate(
            [np.zeros(1, np.int64), np.cumsum(tab_depth)])

        # -- site-independent state, computed ONCE per window (and, in the
        # pipeline, on the decode-ahead worker: pipeline.build_chunk_views
        # triggers win.filter_assembly() off the verdict critical path) ----
        fa = win.filter_assembly()
        self.depth = fa["depth"]
        self._nonref_cnt = fa["nonref"]
        self.col_ins = fa["col_ins"]
        self.col_only_ref = fa["col_only_ref"]
        self.cum_ins = fa["cum_ins"]
        self.n_reads = max(int(win.n_reads), 1)
        self.nr_pos = fa["nr_rel"].astype(np.int64) + self.p0
        self.nr_read = fa["nr_read"]
        self.nr_token = fa["nr_token"]
        nr_ik = fa["nr_ik"].astype(np.int64)
        nr_base = fa["nr_base"].astype(np.int64)
        self.nr_bare_del = (nr_ik == _INDEL_NONE) & (nr_base >= 8)
        self.T = fa["T"]
        # C++ keys are rel-based; shift to the absolute-pos keying the
        # shared col_token_count/co_exist kernels use
        self.colkey = fa["ck_key"] + self.p0 * self.T
        self.colkey_cnt = fa["ck_cnt"]
        self.rse_pos = fa["rse_rel"] + self.p0
        self.rse_read = fa["rse_read"]
        self._read_flag = np.zeros(self.n_reads, bool)


def _make_filter_index(pe, min_bq, min_mq, site_positions, extra_columns=None):
    """WindowFilterIndex when the fused decode carries matching filter-view
    data; classic FilterIndex (site-window entry fetch) otherwise."""
    win = getattr(pe, "_win", None)
    if (win is not None and win.has_filter_data
            and (min_bq, min_mq) == (win.filt_min_bq, win.filt_min_mq)):
        return WindowFilterIndex(pe, min_bq, min_mq,
                                 site_positions=site_positions,
                                 extra_columns=extra_columns)
    if extra_columns and getattr(pe, "_win", None) is not None:
        pe.ensure_sites(extra_columns, 0)
    return FilterIndex(pe, min_bq, min_mq, site_positions=site_positions)


class HardFilterEngine:
    """Runs the no-phasing verdict set against a PileupEngine entry table."""

    def __init__(self, pileup_engine, min_bq=cfg.MIN_BQ, min_mq=cfg.MIN_MQ,
                 max_co_exist_read_num=2,
                 disable_read_start_end_filtering=False,
                 site_positions=None, fisher=None):
        """fisher: strand-bias test callable (default fisher_exact;
        fisher_exact_reference for --exact_reference_fisher parity).

        Defaults pin run_clairs_to's postfilter invocation:
        --min-BQ param.min_bq=0 and --min_alt_coverage 2
        (postfilter_variants.py:795-801; run_clairs_to passes neither).
        Verified by tests/test_golden_filters.py.

        site_positions: optional full set of verdict sites — restricts the
        index to their +-FLANKING windows (see FilterIndex)."""
        self.pe = pileup_engine
        self.min_bq = min_bq
        self.min_mq = min_mq
        self.max_co_exist = max_co_exist_read_num
        self.disable_rse = disable_read_start_end_filtering
        self.fisher = fisher or fisher_exact
        self.ix = _make_filter_index(pileup_engine, min_bq, min_mq,
                                     site_positions)

    def verdict_batch(self, sites):
        """Run verdicts for many sites: {pos0: FilterVerdict}.

        sites: iterable of (pos0, ref_base, alt_base).  SNV sites use the
        native batch kernel (postcall/verdict_native.cpp) when available
        under the default Fisher test — identical verdicts/p-values to
        ``verdict`` (tests/test_verdict_native.py); indels and the
        --exact_reference_fisher mode take the per-site Python path."""
        sites = list(sites)
        out = {}
        snv = [s for s in sites
               if len(s[1]) == 1 and len(s[2]) == 1 and s[2] in "ACGT"]
        rest = [s for s in sites
                if not (len(s[1]) == 1 and len(s[2]) == 1 and s[2] in "ACGT")]
        if self.fisher is fisher_exact and snv:
            from clairs_to_tpu_torch.postcall import verdict_native as vn

            if vn.available():
                batch = vn.NativeVerdictBatch(
                    self.ix, mode=0, max_co_exist=self.max_co_exist,
                    disable_rse=self.disable_rse)
                flags, pvals, tables = batch.run(
                    [s[0] for s in snv],
                    ["ACGT".find(s[2]) for s in snv],
                    [1.0] * len(snv))
                batch.close()
                # native bit layout: 2 rse, 3 co_exist, 7 strand (bits 0/1/
                # 4/5/6 are haplotype-mode verdicts, always pass in mode 0)
                for i, (p0, _rb, _ab) in enumerate(snv):
                    v = FilterVerdict()
                    f = int(flags[i])
                    v.pass_read_start_end = bool(f & (1 << 2))
                    v.pass_co_exist = bool(f & (1 << 3))
                    v.pass_strand_bias = bool(f & (1 << 7))
                    v.strand_bias_p = float(pvals[i])
                    t = tables[i]
                    v.strand_table = ((int(t[0]), int(t[1])),
                                      (int(t[2]), int(t[3])))
                    out[p0] = v
                snv = []
        for (p0, rb, ab) in snv + rest:
            out[p0] = self.verdict(p0, rb, ab)
        return out

    def verdict(self, pos0, ref_base, alt_base):
        """Run the four verdicts for a call at 0-based pos0."""
        ix = self.ix
        v = FilterVerdict()
        is_snp = len(ref_base) == 1 and len(alt_base) == 1

        win_lo = max(pos0 - FLANKING, 0)
        win_hi = pos0 + FLANKING

        rows, reads = ix.center_state(pos0)
        alt_mask = ix.alt_rows_mask(rows, ref_base, alt_base)
        alt_ids = reads[alt_mask]
        n_alt = len(alt_ids)

        # --- ① read start/end (postfilter:419-430; the >= comparison makes
        # a zero-alt site fail, matching the reference's 0 >= 0 behavior)
        if not self.disable_rse:
            if ix.rse_hits(win_lo, win_hi, alt_ids) >= 0.3 * n_alt:
                v.pass_read_start_end = False

        # --- ② co-exist / variant cluster --------------------------------
        match_count, ins_length = ix.co_exist(pos0, win_lo, win_hi, alt_ids)
        depth = max(len(reads), 1)
        if match_count >= self.max_co_exist or ins_length / depth > 3:
            v.pass_co_exist = False

        # --- ③ strand bias ------------------------------------------------
        rev = ix.rev_at(rows)
        a1 = int((rev & alt_mask).sum())
        a0 = n_alt - a1
        all1 = int(rev.sum())
        r0, r1 = len(reads) - all1 - a0, all1 - a1
        v.strand_table = ((a0, r0), (a1, r1))
        v.strand_bias_p = self.fisher([[a0, r0], [a1, r1]])
        if v.strand_bias_p < 0.001:
            v.pass_strand_bias = False

        # --- ④ sequence entropy (indels only) ----------------------------
        if not is_snp:
            lo = pos0 - cfg.FLANKING_BASE_NUM
            hi = pos0 + cfg.FLANKING_BASE_NUM + 1
            ref_seq = "".join(ix.pe._ref_base(p) for p in range(lo, hi))
            ent = calculate_sequence_entropy(ref_seq, cfg.NO_OF_POSITIONS)
            if ent < SEQUENCE_ENTROPY_THRESHOLD:
                v.pass_sequence_entropy = False

        return v


def apply_hard_filters(rows, verdicts):
    """Update VCF row dicts in place per update_filter_info (:484-520).

    rows: list of row dicts (CHROM/POS/...); verdicts: {(chrom,pos): FilterVerdict}.
    Returns number of rows filtered.
    """
    n_filtered = 0
    for row in rows:
        key = (row["CHROM"], row["POS"])
        v = verdicts.get(key)
        if v is None:
            continue
        filt = row["FILTER"]
        if not v.pass_all:
            row["QUAL"] = 0.0
            filt = "LowQual"
            n_filtered += 1
        if not v.pass_read_start_end:
            filt += ";ReadStartEnd"
        if not v.pass_co_exist:
            filt += ";VariantCluster"
        if not v.pass_strand_bias:
            filt += ";StrandBias"
        if not v.pass_sequence_entropy:
            filt += ";LowSeqEntropy"
        row["FILTER"] = filt
        row["INFO"] = row["INFO"] + ";SB={}".format(round(v.strand_bias_p, 5))
    return n_filtered
