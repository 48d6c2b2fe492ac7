"""A plain reference of a tumor-only Illumina ``run`` (``-p ilmn``) over
one simulated genome.  It builds on ``reference/genome.py``, whose pileup,
tensors, candidates, nets, posterior, call and cluster and strand logic it
takes as they are, and imports nothing of the program.

What differs from the ONT reference, from ClairS-TO's published
semantics (SURVEY.md §2.4, §2.6; ``run_clairs_to`` STEP 4 for ``ilmn``):

* one view: every entry at base quality >= 0, which the AFF and the NEG
  network both read; the low-base-quality channels below 10; indel
  candidates from 5% of the depth;
* no phaser and no haplotype filter.  Instead, chunk by chunk with the
  reads that each chunk fetches (its span +- 33 bases, in file order):
  - the realignment filter (``reference/realign.py``) on every SNV call
    still PASS whose QUAL is under 8: a call that fails it becomes
    ``LowQual;Realignment`` at QUAL 0 and skips the postfilter;
  - the postfilter on the SNV calls still PASS: ``ReadStartEnd`` (alt
    reads among the reads marked at a start or end column within 100
    bases, at least 30% of the alt reads; a site with no alt read fails,
    as 0 >= 0), ``VariantCluster`` (as the haplotype filter's), and
    ``StrandBias`` by the two-sided Fisher test alone (p < 0.001), its
    p-value in ``SB``.  A mark comes from the chunk's own reads over the
    columns of its filter view (its span +- 33 +- 128 bases);
* the final gates: QUAL 4 for SNVs and indels alike, with no gate by
  phased region (``postprocess_vcf`` gates by region only off Illumina),
  and AF 0.05.
"""

import numpy as np

from h100_bench.reference import genome as base
from h100_bench.reference import realign as ref_realign

ACGT = base.ACGT
ACGT_BYTES = np.frombuffer(b"ACGT", np.uint8)
FILT_MARGIN = 128             # the filter view runs this far past a chunk's fetch


class Rules(base.Rules):
    """The Illumina thresholds by name (ClairS-TO's ``ilmn`` defaults)."""

    min_bq = 0                 # one view: AFF reads every entry, as NEG does
    low_bq = 10
    indel_min_af = 0.05
    qual_pass = 4.0
    qual_phaseable = 4.0       # no gate by region on Illumina
    qual_unphaseable = 4.0
    realign_below = ref_realign.QUAL_BELOW
    realign_flank = ref_realign.FLANK
    realign_pad = ref_realign.REF_PAD


class Expected(base.Expected):
    """Every candidate's accepted outcomes, and what the realignment filter
    and the postfilter make of the SNV calls, chunk by chunk."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self._realigned, self._post, self._marks = {}, {}, {}

    def _fetched(self, c):
        lo, hi = self.chunks[c]
        R, pile = self.pile.rules, self.pile
        return max(lo - R.chunk_flank, 0), min(hi + R.chunk_flank, pile.L)

    # -- the realignment filter ---------------------------------------------
    def realigned(self, c, pos1, alt):
        """The realignment filter at 1-based ``pos1`` with the reads of
        chunk ``c``: ``reference/realign.py::site``'s answer, or None
        where no read lies over the site +- 100."""
        pile, R = self.pile, self.pile.rules
        p = pos1 - 1
        lo, hi = max(p - R.realign_flank, 0), p + R.realign_flank + 1
        f_lo, f_hi = self._fetched(c)
        over = pile.fetched(f_lo, f_hi) & pile.fetched(lo, hi)
        ranks = tuple(np.nonzero(over)[0].tolist())
        key = (p, alt, ranks)
        if key not in self._realigned:
            if not ranks:
                self._realigned[key] = None
            else:
                r_lo = max(lo - R.realign_pad, 0)
                window = pile.ref_str[r_lo:hi + R.realign_pad]
                reads = [self._read(rk) for rk in ranks]
                self._realigned[key] = ref_realign.site(window, r_lo, reads, p, alt)
        return self._realigned[key]

    def _read(self, rank):
        """(position, CIGAR, sequence) of the read of ``rank``."""
        g = self.pile.g
        r = int(g.order[rank])
        i = np.searchsorted(g.ind_reads, r)
        if i < len(g.ind_reads) and g.ind_reads[i] == r:
            ops = g.cig_op[g.cig_off[i]:g.cig_off[i + 1]].tolist()
            lens = g.cig_len[g.cig_off[i]:g.cig_off[i + 1]].tolist()
            cigar = "".join(f"{n}{'MID'[o]}" for o, n in zip(ops, lens))
            seq = g.ind_seq[i, :int(g.ind_len[i])]
        else:
            seq = g.seq[np.searchsorted(g.plain, r)]
            cigar = f"{len(seq)}M"
        return int(g.start[r]), cigar, ACGT_BYTES[seq].tobytes().decode()

    # -- the postfilter --------------------------------------------------------
    def postfilter(self, c, pos1, alt):
        """(failed tags, strand p) of the postfilter at 1-based ``pos1``
        with the reads of chunk ``c``."""
        key = (c, pos1, alt)
        if key in self._post:
            return self._post[key]
        pile, R = self.pile, self.pile.rules
        p, a = pos1 - 1, ACGT.index(alt)
        fetched = pile.fetched(*self._fetched(c))
        rank, base_, rev, _bq, kind, _il, _is = pile.column(p)
        alt_m = (kind == 0) & (base_ == a)
        alt_ids = rank[alt_m]
        n_alt = len(alt_ids)
        lo, hi = max(p - R.filter_flank, 0), p + R.filter_flank
        failed = set()
        mpos, mrk = self._chunk_marks(c, fetched)
        s, e = np.searchsorted(mpos, lo), np.searchsorted(mpos, hi, side="right")
        if len(np.intersect1d(mrk[s:e], alt_ids)) >= R.rse_alt_share * n_alt:
            failed.add("ReadStartEnd")
        if self._clusters(p, lo, hi, alt_ids, fetched, max(len(rank), 1)):
            failed.add("VariantCluster")
        a1 = int((alt_m & (rev != 0)).sum())
        a0 = n_alt - a1
        nrev = int((rev != 0).sum())
        pv = base.fisher_two_sided(a0, len(rank) - nrev - a0, a1, nrev - a1)
        if pv < R.strand_p:
            failed.add("StrandBias")
        self._post[key] = (failed, pv)
        return self._post[key]

    def _chunk_marks(self, c, fetched):
        """(positions, ranks) of the reads of chunk ``c`` marked at a
        start or end column of its filter view, sorted by position: a
        column where the chunk's reads that start (or end) there are the
        larger side and >= 20% of the chunk's reads over it."""
        if c in self._marks:
            return self._marks[c]
        pile, R = self.pile, self.pile.rules
        f_lo, f_hi = self._fetched(c)
        v_lo, v_hi = f_lo - FILT_MARGIN, f_hi + FILT_MARGIN
        ranks = np.nonzero(fetched)[0]
        first, last = pile.first[ranks], pile.last[ranks]
        n = v_hi - v_lo
        depth = np.zeros(n + 1, np.int64)
        np.add.at(depth, np.clip(first - v_lo, 0, n), 1)
        np.add.at(depth, np.clip(last + 1 - v_lo, 0, n), -1)
        depth = np.cumsum(depth)[:n]
        st_in = (first >= v_lo) & (first < v_hi)
        en_in = (last >= v_lo) & (last < v_hi)
        nst = np.bincount(first[st_in] - v_lo, minlength=n)
        nen = np.bincount(last[en_in] - v_lo, minlength=n)
        side = nst > nen
        cond = (np.where(side, nst, nen) >= depth * R.rse_share) & (depth > 0)
        ms = st_in.copy()
        ms[st_in] = cond[first[st_in] - v_lo] & side[first[st_in] - v_lo]
        me = en_in.copy()
        me[en_in] = cond[last[en_in] - v_lo] & ~side[last[en_in] - v_lo]
        pos = np.concatenate([first[ms], last[me]])
        rk = np.concatenate([ranks[ms], ranks[me]])
        o = np.argsort(pos, kind="stable")
        self._marks[c] = (pos[o], rk[o])
        return self._marks[c]

