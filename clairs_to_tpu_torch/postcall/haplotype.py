# Port copy of clairs_to_tpu/postcall/haplotype.py.
"""Long-read haplotype filtering — the 9-verdict hard-filter stage.

Port of ClairS-TO src/haplotype_filtering.py:344-706 operating on the
entry table (bamio/pileup.py) of a haplotagged BAM (HP tags) instead of
re-mpileuping per site:

  ① pass_bq   — mean alt-allele BQ > 20 (:631-658, ont_min_bq)
  ② pass_mq   — mean alt-allele MQ > 20
  ③ pass_read_start_end — >=30% of alt reads near read boundaries (:369-373)
  ④ pass_co_exist — variant cluster: >=3 co-segregating nearby variants among
     alt reads, or inserted length/depth > 3 (:394-435, 531-534)
  ⑤ pass_hetero — phased alt reads must share ancestry with flanking het
     germline alleles on the same haplotype (:437-468)
  ⑥ pass_homo — alt reads must carry flanking hom germline alleles (:470-529)
  ⑦ pass_hetero_both_side — low-AF alt present on both haplotypes (:375-387)
  ⑧ pass_strand_bias — Fisher p >= 0.001 (SNV) / 0.01 (indel), with the
     reference's operator-precedence quirk kept verbatim: the `or a0==0 or
     a1==0` binds to the whole conjunction (:548-552)
  ⑨ pass_sequence_entropy — indels: 33bp ref k-mer entropy >= 0.9 (:554-557)

Fail => LowQual + tags LowAltBQ/LowAltMQ/ReadStartEnd/VariantCluster/
NoAncestry/MultiHap/StrandBias/LowSeqEntropy; phaseable calls get INFO 'H';
INFO gains SB=p (update_filter_info, :742-796).
"""

from bisect import bisect_left, bisect_right

import numpy as np

from clairs_to_tpu_torch import config as cfg
from clairs_to_tpu_torch.postcall.hardfilter import (
    EPS,
    FLANKING,
    MIN_HOM_GERMLINE_AF,
    SEQUENCE_ENTROPY_THRESHOLD,
    FilterIndex,
    _BASE_ID,
    _make_filter_index,
    calculate_sequence_entropy,
    fisher_exact,
)

LOW_AF_SNV = 0.1
LOW_AF_INDEL = 0.3


class HaplotypeVerdict:
    FIELDS = (
        "pass_bq", "pass_mq", "pass_read_start_end", "pass_co_exist",
        "pass_hetero", "pass_homo", "pass_hetero_both_side",
        "pass_strand_bias", "pass_sequence_entropy",
    )

    def __init__(self):
        for f in self.FIELDS:
            setattr(self, f, True)
        self.phaseable = False
        self.strand_bias_p = 1.0
        self.strand_table = None

    @property
    def pass_all(self):
        return all(getattr(self, f) for f in self.FIELDS)


class HaplotypeFilterEngine:
    """Runs the 9 verdicts against a (haplotagged) entry table.

    Site-independent work lives in the shared FilterIndex (hardfilter.py);
    germline-column states (⑤⑥) are memoized per germline site since every
    candidate within ±100 bp revisits them."""

    def __init__(self, pileup_engine, min_bq=cfg.MIN_BQ, min_mq=cfg.MIN_MQ,
                 max_co_exist_read_num=2,
                 disable_read_start_end_filtering=False,
                 hetero_germline=None, homo_germline=None,
                 site_positions=None, fisher=None):
        """hetero/homo_germline: [(pos0, alt_base)] flanking germline calls
        from the pileup germline VCF (haplotype_filtering.py:901-939).

        Defaults pin run_clairs_to's own: the filter-stage mpileup runs
        at --min-BQ param.min_bq=0 (NOT the platform tensor min_bq) and
        --min_alt_coverage defaults to 2 (haplotype_filtering.py:1252);
        run_clairs_to passes neither, so these are production values.
        Verified by tests/test_golden_filters.py."""
        self.pe = pileup_engine
        self.min_bq = min_bq
        self.min_mq = min_mq
        self.max_co_exist = max_co_exist_read_num
        self.disable_rse = disable_read_start_end_filtering
        self.hetero_germline = sorted(hetero_germline or [])
        self.homo_germline = sorted(homo_germline or [])
        # position keys for per-site window slicing (the germline loops
        # were O(sites x germline) full scans — quadratic at real density)
        self._het_keys = [p for (p, _a) in self.hetero_germline]
        self._hom_keys = [p for (p, _a) in self.homo_germline]
        self.fisher = fisher or fisher_exact
        # germline columns (⑤⑥ states) need full-column entry rows too
        germ_cols = [p for (p, _a) in self.hetero_germline] + \
            [p for (p, _a) in self.homo_germline]
        self.ix = _make_filter_index(pileup_engine, min_bq, min_mq,
                                     site_positions, extra_columns=germ_cols)
        self._het_memo = {}
        self._hom_memo = {}

    def _het_col(self, gp, gab):
        """Memoized ⑤ state at het-germline site gp: (carrier read ids,
        read ids at column, hp of last entry per read).

        Carriers match over ALL entries of a read (haplotype_filtering.py:
        445-458 loops raw mpileup items); hp is dict last-wins."""
        key = (gp, gab)
        st = self._het_memo.get(key)
        if st is not None:
            return st
        ix = self.ix
        grb = ix.pe._ref_base(gp)
        rows = ix.col_rows(gp)
        carr_mask = self._germline_match_mask(rows, grb, gab, which="het")
        carriers = np.unique(ix.a["read_id"][rows][carr_mask])
        last_rows, reads_u = ix.center_state(gp)
        st = (carriers, reads_u, ix.a["hp"][last_rows])
        self._het_memo[key] = st
        return st

    def _hom_col(self, gp, gab):
        """Memoized ⑥ state at hom-germline site gp (dict last-wins for
        both the column view and homo_alt, :470-500)."""
        key = (gp, gab)
        st = self._hom_memo.get(key)
        if st is not None:
            return st
        ix = self.ix
        grb = ix.pe._ref_base(gp)
        last_rows, reads_u = ix.center_state(gp)
        homo_mask = self._germline_match_mask(last_rows, grb, gab, which="hom")
        hp_u = ix.a["hp"][last_rows]
        hcount = np.bincount(hp_u[homo_mask], minlength=3)[:3]
        acount = np.bincount(hp_u, minlength=3)[:3]
        st = (reads_u, reads_u[homo_mask], hcount, acount)
        self._hom_memo[key] = st
        return st

    def _germline_match_mask(self, rows, grb, gab, which):
        """Which entries carry the germline alt (:442-458 / :474-500).

        SNV: string equality (token match).  INS: the reference does a
        substring test of gab[:2] (het) / gab[1:2] (hom) inside the
        inserted sequence.  DEL: any deletion suffix."""
        ix = self.ix
        ik = ix.a["ikind"][rows]
        if len(grb) == 1 and len(gab) == 1:
            i = "ACGT".find(gab)
            if i < 0:
                return np.zeros(len(rows), bool)
            return (ik == 0) & (_BASE_ID[ix.a["code"][rows]] == i)
        if len(grb) == 1 and len(gab) > 1:
            needle = gab[:2] if which == "het" else gab[1:2]
            out = np.zeros(len(rows), bool)
            for k in np.nonzero(ik == 1)[0]:
                if needle in ix.pe._iseq[int(rows[k])].upper():
                    out[k] = True
            return out
        if len(grb) > 1 and len(gab) == 1:
            return ik == 2
        return np.zeros(len(rows), bool)

    def verdict_batch(self, sites):
        """Run verdicts for many sites: {pos0: HaplotypeVerdict}.

        sites: iterable of (pos0, ref_base, alt_base, af).  SNV sites go
        through the native batch kernel (postcall/verdict_native.cpp) when
        it is available and the default Fisher test is selected — same
        verdicts/p-values as ``verdict`` (cross-validated by
        tests/test_verdict_native.py); indel sites and the
        --exact_reference_fisher mode use the per-site Python path."""
        sites = list(sites)
        out = {}
        native_ok = self.fisher is fisher_exact
        snv = [(p, rb, ab, af) for (p, rb, ab, af) in sites
               if len(rb) == 1 and len(ab) == 1 and ab in "ACGT"]
        rest = [s for s in sites
                if not (len(s[1]) == 1 and len(s[2]) == 1 and s[2] in "ACGT")]
        if native_ok and snv:
            from clairs_to_tpu_torch.postcall import verdict_native as vn

            if vn.available() and all(
                len(ab) == 1 and ab in "ACGT"
                for (_p, ab) in self.hetero_germline + self.homo_germline
            ):
                batch = vn.NativeVerdictBatch(
                    self.ix, mode=1, max_co_exist=self.max_co_exist,
                    disable_rse=self.disable_rse,
                    hetero_germline=self.hetero_germline,
                    homo_germline=self.homo_germline,
                    ont_min_bq=cfg.ONT_MIN_BQ, min_mq_thresh=cfg.MIN_MQ)
                flags, pvals, tables = batch.run(
                    [s[0] for s in snv],
                    ["ACGT".find(s[2]) for s in snv],
                    [1.0 if s[3] is None else s[3] for s in snv])
                batch.close()
                for i, (p0, _rb, _ab, _af) in enumerate(snv):
                    v = HaplotypeVerdict()
                    f = int(flags[i])
                    for b, name in enumerate(HaplotypeVerdict.FIELDS):
                        setattr(v, name, bool(f & (1 << b)))
                    v.phaseable = bool(f & (1 << 9))
                    v.strand_bias_p = float(pvals[i])
                    t = tables[i]
                    v.strand_table = ((int(t[0]), int(t[1])),
                                      (int(t[2]), int(t[3])))
                    out[p0] = v
                snv = []
        for (p0, rb, ab, af) in snv + rest:
            out[p0] = self.verdict(p0, rb, ab, af=af)
        return out

    def verdict(self, pos0, ref_base, alt_base, af=None):
        ix = self.ix
        v = HaplotypeVerdict()
        is_snp = len(ref_base) == 1 and len(alt_base) == 1
        af = af if af is not None else 1.0

        win_lo = max(pos0 - FLANKING, 0)
        win_hi = pos0 + FLANKING

        rows, reads = ix.center_state(pos0)
        alt_mask = ix.alt_rows_mask(rows, ref_base, alt_base)
        alt_rows = rows[alt_mask]
        alt_ids = reads[alt_mask]
        n_alt = len(alt_ids)

        # ① / ② average alt BQ / MQ (haplotype_filtering.py:631-658)
        if n_alt:
            if ix.a["bq"][alt_rows].mean() <= cfg.ONT_MIN_BQ:
                v.pass_bq = False
            if ix.a["mq"][alt_rows].mean() <= cfg.MIN_MQ:
                v.pass_mq = False

        # ③ read start/end
        if not self.disable_rse and n_alt:
            if ix.rse_hits(win_lo, win_hi, alt_ids) >= 0.3 * n_alt:
                v.pass_read_start_end = False

        # haplotype memberships (hap 0 = unphased; dict last-wins)
        hp_center = ix.a["hp"][rows]
        alt_hp = hp_center[alt_mask]
        hp1 = int((alt_hp == 1).sum())
        hp2 = int((alt_hp == 2).sum())
        MAX, MIN = max(hp1, hp2), min(hp1, hp2)

        # ⑦ both-haplotype low-AF check (:375-387)
        low_af = LOW_AF_SNV if is_snp else LOW_AF_INDEL
        if af < low_af:
            if hp1 * hp2 > 0 and (MIN > self.max_co_exist or MAX / MIN <= 10):
                v.pass_hetero_both_side = False

        is_phasable = hp1 * hp2 == 0 or (
            MAX / MIN >= 5 and (hp1 > self.max_co_exist or hp2 > self.max_co_exist)
        )
        hap_index = 0 if not is_phasable else (1 if hp1 > hp2 else 2)

        # ④ co-exist / cluster
        match_count, ins_length = ix.co_exist(pos0, win_lo, win_hi, alt_ids)
        depth = max(len(reads), 1)
        if match_count >= self.max_co_exist or ins_length / depth > 3:
            v.pass_co_exist = False

        # ⑤ ancestral het-germline support (:437-468)
        if hap_index > 0:
            alt_on_hap = set(alt_ids[alt_hp == hap_index].tolist())
            ha = bisect_left(self._het_keys, win_lo)
            hb = bisect_right(self._het_keys, win_hi)
            for gp, gab in self.hetero_germline[ha:hb]:
                if gp == pos0:
                    continue
                carriers, reads_u, hp_u = self._het_col(gp, gab)
                if len(reads_u) == 0:
                    continue
                phased = set(reads_u[hp_u == hap_index].tolist()) & \
                    set(carriers.tolist())
                if len(phased) == 0 or len(phased) * 2 < float(len(carriers)):
                    continue
                if not (alt_on_hap & phased):
                    v.pass_hetero = False
                    break

        # ⑥ hom-germline carryover (:470-529)
        alt_set = set(alt_ids.tolist())
        oa = bisect_left(self._hom_keys, win_lo)
        ob = bisect_right(self._hom_keys, win_hi)
        for gp, gab in self.homo_germline[oa:ob]:
            # the reference drops the candidate site itself when building
            # the HAP_INFO germline strings (p_gl == pos, :1011)
            if gp == pos0:
                continue
            reads_u, homo_ids, hcount, acount = self._hom_col(gp, gab)
            if len(reads_u) == 0:
                continue
            tot = int(acount.sum())
            af_g = float(hcount.sum()) / tot if tot else 0.0

            def _phasable(all_list, hlist):
                if all_list[1] * all_list[2] == 0:
                    return False
                mx, mn = max(hlist[1], hlist[2]), min(hlist[1], hlist[2])
                if hlist[1] * hlist[2] > 0 and mx / mn <= 10:
                    return False
                return True

            if af_g < MIN_HOM_GERMLINE_AF or _phasable(
                [int(x) for x in acount], [int(x) for x in hcount]
            ):
                continue
            inter = set(reads_u.tolist()) & alt_set
            if len(inter) == 0:
                continue
            overlap = set(homo_ids.tolist()) & inter
            if len(overlap) == 0 or len(overlap) / len(inter) < EPS:
                v.pass_homo = False
                break

        # phaseability flag for INFO 'H' (:538-545)
        all1 = int((hp_center == 1).sum())
        all2 = int((hp_center == 2).sum())
        v.phaseable = (
            all1 * all2 > 0
            and hp1 * hp2 == 0
            and (hp1 > self.max_co_exist or hp2 > self.max_co_exist)
        )

        # ⑧ strand bias, with the reference's precedence quirk preserved
        rev = ix.rev_at(rows)
        a1 = int((rev & alt_mask).sum())
        a0 = n_alt - a1
        nrev = int(rev.sum())
        r0, r1 = len(reads) - nrev - a0, nrev - a1
        v.strand_table = ((a0, r0), (a1, r1))
        p_value = self.fisher([[a0, r0], [a1, r1]])
        v.strand_bias_p = p_value
        if is_snp and p_value < 0.001 or (a0 == 0 or a1 == 0):
            v.pass_strand_bias = False
        elif not is_snp and p_value < 0.01 or (a0 == 0 or a1 == 0):
            v.pass_strand_bias = False

        # ⑨ sequence entropy (indels)
        if not is_snp:
            lo = pos0 - cfg.FLANKING_BASE_NUM
            hi = pos0 + cfg.FLANKING_BASE_NUM + 1
            ref_seq = "".join(ix.pe._ref_base(p) for p in range(lo, hi))
            if calculate_sequence_entropy(ref_seq, cfg.NO_OF_POSITIONS) < SEQUENCE_ENTROPY_THRESHOLD:
                v.pass_sequence_entropy = False

        return v


def apply_haplotype_filters(rows, verdicts):
    """update_filter_info (:742-796): LowQual + per-verdict tags + H + SB."""
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
        if not v.pass_bq:
            filt += ";LowAltBQ"
        if not v.pass_mq:
            filt += ";LowAltMQ"
        if not v.pass_read_start_end:
            filt += ";ReadStartEnd"
        if not v.pass_co_exist:
            filt += ";VariantCluster"
        if not v.pass_hetero:
            filt += ";NoAncestry"
        if not v.pass_hetero_both_side:
            filt += ";MultiHap"
        if not v.pass_strand_bias:
            filt += ";StrandBias"
        if not v.pass_sequence_entropy:
            filt += ";LowSeqEntropy"
        row["FILTER"] = filt
        if v.phaseable:
            row["INFO"] = "H;" + row["INFO"] if row["INFO"] != "." else "H"
        row["INFO"] = row["INFO"] + ";SB={}".format(round(v.strand_bias_p, 5))
    return n_filtered
