"""A plain reference of a tumor-only ``run`` over one simulated genome,
rebuilt from the simulator's arrays (not from the BAM), in NumPy and
PyTorch.  Imports nothing of the program.

What it rebuilds, from ClairS-TO's published semantics (SURVEY.md §2.2,
§2.4, Appendix B) as the repository documents them:

* the pileup at each reference position: every read contributes one entry
  there, a base (strand by the read's), a deletion placeholder (quality of
  the next aligned base), or an anchor base that carries an insertion or
  deletion after it and counts only as that indel;
* the tensor views: 33 positions x 34 channels, ``A C G T I I1 D D1 *``
  forward, ``a c g t i i1 d d1 #`` reverse, 8 low-mapping-quality and 8
  low-base-quality (under 30 for ONT) strand-split base counts; indels
  counted as I/D and I1/D1 = the largest count of one inserted sequence or
  deletion length; each quality block's reference base stored as minus the
  block's sum.  The AFF view keeps entries of base quality >= the
  platform's min_bq (20 for ONT), the NEG view every entry;
* candidates: depth > 4 and a non-reference base of >= 3 reads and >= 5%
  of the depth (SNV), or one inserted sequence / deletion length of >= 3
  reads and >= 10% (indel), on the AFF view with anchors counted as their
  base too; the window must lie inside the contig's 33-base margins;
* the alt-info of each candidate (depth, alt counts in first-seen order,
  the reference count last), both networks (``reference/nets.py``), the
  float64 posterior and QUAL (``reference/posterior.py``), the call
  (argmax allele, best-supported alt, genotype, AF, AD, strand counts);
* the chunks of the run (ClairS-TO's arithmetic) and, in each, the reads
  that a chunk fetches (those overlapping its span widened by 33 bases);
* the internal phaser of each chunk: its anchors are the chunk's SNV calls
  of genotype 0/1 and AF >= 0.35 in position order; a greedy pass orients
  each anchor by the votes of the reads already seen there and adds the
  reads' votes; a read's haplotag is the sign of its votes (0 where none);
* the long-read hard filters of each SNV call: mean alt base quality > 20
  (``LowAltBQ``), mean alt mapping quality > 20 (``LowAltMQ``), alt reads
  near marked read starts or ends (``ReadStartEnd``), two or more columns
  within 100 bases where most alt reads share a non-reference entry that
  the column's other reads mostly lack, or inserted length over depth > 3
  (``VariantCluster``), alt reads on their haplotype missing the alleles
  of the phased carriers of the chunk's het calls nearby (``NoAncestry``),
  alt reads of a call under AF 0.1 on both haplotypes (``MultiHap``), alt
  reads missing a nearby hom call's allele (no tag), the two-sided Fisher
  strand test with its p-value in ``SB`` (``StrandBias``); the ``H`` flag
  (the column's reads on both haplotypes, the alt reads on one, more than
  2 of them); the panel of normals by (POS, REF, ALT); the final QUAL and
  AF gates.

The simulated reads are single-ended at mapping quality 60 and carry only
substitution errors beside the planted variants: the low-mapping-quality
channels stay empty, no mates overlap, and indel entries come from the
planted indels alone.

Which calls a chunk holds decides the phaser's anchors and the filters'
germline sets.  Where the reference accepts more than one call at a
candidate (below), the program's choice, once judged, stands for it: the
filters are rebuilt from the chunk's judged calls.

The networks' probabilities of the program may differ from the
reference's by rounding: a program probability within ``delta`` of the
reference's is sound.  So each candidate's posterior is an interval (the
float64 formula over every probability within ``delta``, bin edges
included), its QUAL an interval, and where two alleles' intervals overlap,
each of them is an accepted call.
"""

import math
import os

import numpy as np
import torch

from h100_bench.reference import nets
from h100_bench.reference import posterior as ref_post

FLANK, NCH = 16, 34
CH_BASE_F, CH_BASE_R = 0, 9
CH_I, CH_I1, CH_D, CH_D1, CH_STAR = 4, 5, 6, 7, 8
CH_HASH = 17
CH_LMQ_F, CH_LMQ_R, CH_LBQ_F, CH_LBQ_R = 18, 22, 26, 30
REF_BLOCKS = (CH_BASE_F, CH_BASE_R, CH_LMQ_F, CH_LMQ_R, CH_LBQ_F, CH_LBQ_R)
ACGT = "ACGT"
HAP_TAGS = ("LowAltBQ", "LowAltMQ", "ReadStartEnd", "VariantCluster", "NoAncestry",
            "MultiHap", "StrandBias", "LowSeqEntropy")
NO_TAG = "homo"              # a failure that writes LowQual and no tag
TOK_DEL_F, TOK_DEL_R = 8, 9  # deletion placeholders' tokens; an indel's from 16


class Rules:
    """The configuration's thresholds, by name (ClairS-TO's ONT defaults)."""

    min_bq = 20                # the AFF view's base quality (ONT)
    low_bq = 30                # the low-base-quality channels (ONT)
    max_indel = 60
    min_coverage = 4
    snv_min_af = 0.05
    indel_min_af = 0.1         # ONT
    support = 3
    qual_pass = 8.0            # final QUAL gate; phaseable / unphaseable
    qual_phaseable = 8.0
    qual_unphaseable = 12.0
    final_min_af = 0.05
    filter_flank = 100         # the hard filters' window
    rse_share = 0.2            # a marked read start/end column: >= 20% of depth
    rse_alt_share = 0.3
    strand_p = 0.001
    chunk_size = 5_000_000     # run's default
    chunk_flank = 33           # a chunk fetches the reads of its span +- 33
    anchor_af = 0.35           # the phaser's anchors: 0/1 SNV calls of AF >= 0.35
    max_co_exist = 2
    cluster_eps = 0.5
    max_ins = 200              # an insertion's length counted at most (2 x flank)
    multihap_af = 0.1
    hom_min_af = 0.75


# ------------------------------------------------------------ the pileup ---
class Pileup:
    """The entries of every read, as the reference's pileup sees them."""

    def __init__(self, g, device, rules=Rules):
        self.g, self.rules, self.device = g, rules, torch.device(device)
        self.L = len(g.genome)
        self.rl = g.seq.shape[1]
        self.ref = g.genome.astype(np.int64)
        self.ref_str = np.frombuffer(b"ACGT", np.uint8)[g.genome].tobytes().decode()
        self.rank = np.empty(len(g.start), np.int64)
        self.rank[g.order] = np.arange(len(g.start))
        self.sorted_start = g.start[g.order]
        self._indel_entries()
        self._ie_order = np.argsort(self.ie["pos"], kind="stable")
        self._ie_pos = self.ie["pos"][self._ie_order]
        # each read's first and last reference column, by rank
        self.first = g.start[g.order].copy()
        self.last = self.first + self.rl - 1
        for rk, (s, e) in self.ind_span.items():
            self.first[rk], self.last[rk] = s, e
        self._columns = {}
        self._nr = None

    def _indel_entries(self):
        """Columns of the reads with an indel: pos, base (4 = deletion
        placeholder), rev, bq, rank, kind (0 none, 1 ins, 2 del), length,
        inserted sequence, and each read's first and last column."""
        g = self.g
        cols = {k: [] for k in ("pos", "base", "rev", "bq", "rank", "kind", "ilen", "iseq")}
        self.ind_span = {}
        for i, r in enumerate(g.ind_reads.tolist()):
            ops = g.cig_op[g.cig_off[i]:g.cig_off[i + 1]].tolist()
            lens = g.cig_len[g.cig_off[i]:g.cig_off[i + 1]].tolist()
            seq, qual, n = g.ind_seq[i], g.ind_qual[i], int(g.ind_len[i])
            rev, rk = bool(g.rev[r]), int(self.rank[r])
            pos, q, last = int(g.start[r]), 0, -1
            for op, ln in zip(ops, lens):
                if op == 0:
                    for k in range(ln):
                        for key, val in (("pos", pos + k), ("base", int(seq[q + k])),
                                         ("rev", rev), ("bq", int(qual[q + k])), ("rank", rk),
                                         ("kind", 0), ("ilen", 0), ("iseq", "")):
                            cols[key].append(val)
                    last = len(cols["pos"]) - 1
                    pos += ln
                    q += ln
                elif op == 1:
                    if last >= 0 and cols["pos"][last] == pos - 1:
                        cols["kind"][last], cols["ilen"][last] = 1, ln
                        cols["iseq"][last] = "".join(ACGT[b] for b in seq[q:q + ln])
                    q += ln
                else:
                    if last >= 0 and cols["pos"][last] == pos - 1:
                        cols["kind"][last], cols["ilen"][last] = 2, ln
                    nbq = int(qual[q]) if q < n else int(qual[n - 1])
                    for k in range(ln):
                        for key, val in (("pos", pos + k), ("base", 4), ("rev", rev),
                                         ("bq", nbq), ("rank", rk), ("kind", 0), ("ilen", 0),
                                         ("iseq", "")):
                            cols[key].append(val)
                    last = len(cols["pos"]) - 1
                    pos += ln
            self.ind_span[rk] = (int(g.start[r]), pos - 1)
        self.ie = {k: np.asarray(v, object if k == "iseq" else np.int64) for k, v in cols.items()}

    # -- the tensor views -------------------------------------------------
    def channel_counts(self, min_bq):
        """(L, 34) raw counts (before the reference encoding) and (L,) depth
        of the view of base quality >= ``min_bq``."""
        dev, L, rl = self.device, self.L, self.rl
        acc = torch.zeros(L * NCH, dtype=torch.int64, device=dev)
        depth = torch.zeros(L, dtype=torch.int64, device=dev)
        g = self.g
        col = torch.arange(rl, device=dev)
        for a in range(0, len(g.plain), 8192):
            rows = g.plain[a:a + 8192]
            start = torch.from_numpy(g.start[rows]).to(dev)
            rev = torch.from_numpy(g.rev[rows]).to(dev)
            base = torch.from_numpy(g.seq[a:a + 8192]).to(dev).long()
            bq = torch.from_numpy(g.qual[a:a + 8192]).to(dev).long()
            pos = start[:, None] + col[None, :]
            keep = bq >= min_bq
            ch = base + torch.where(rev, CH_BASE_R, CH_BASE_F)[:, None]
            acc.index_put_(((pos * NCH + ch)[keep],), torch.ones((), dtype=torch.int64,
                                                                 device=dev), accumulate=True)
            depth.index_put_((pos[keep],), torch.ones((), dtype=torch.int64, device=dev),
                             accumulate=True)
            low = keep & (bq < self.rules.low_bq)
            ch = base + torch.where(rev, CH_LBQ_R, CH_LBQ_F)[:, None]
            acc.index_put_(((pos * NCH + ch)[low],), torch.ones((), dtype=torch.int64,
                                                                device=dev), accumulate=True)
        out = acc.reshape(L, NCH).cpu().numpy()
        depth = depth.cpu().numpy()
        ie = self.ie
        keep = ie["bq"] >= min_bq
        pure = keep & (ie["kind"] == 0)
        for j in np.nonzero(pure)[0]:
            p, b, rev = ie["pos"][j], ie["base"][j], ie["rev"][j]
            if b == 4:
                out[p, CH_HASH if rev else CH_STAR] += 1
            else:
                out[p, (CH_BASE_R if rev else CH_BASE_F) + b] += 1
                if ie["bq"][j] < self.rules.low_bq:
                    out[p, (CH_LBQ_R if rev else CH_LBQ_F) + b] += 1
            depth[p] += 1
        groups = {}
        for j in np.nonzero(keep & (ie["kind"] > 0))[0]:
            p, kind, ln, fwd = ie["pos"][j], ie["kind"][j], ie["ilen"][j], not ie["rev"][j]
            if (ln if kind == 1 else ln + 1) > self.rules.max_indel:
                continue
            depth[p] += 1
            if kind == 1:
                out[p, CH_I if fwd else CH_I + 9] += 1
                key = (p, fwd, 1, ie["iseq"][j])
            else:
                out[p, CH_D if fwd else CH_D + 9] += 1
                key = (p, fwd, 2, ln)
            groups[key] = groups.get(key, 0) + 1
        for (p, fwd, kind, _k), c in groups.items():
            ch = (CH_I1 if kind == 1 else CH_D1) + (0 if fwd else 9)
            out[p, ch] = max(out[p, ch], c)
        return out, depth

    def encode(self, counts):
        """The reference encoding: each block's reference base as minus the
        block's sum (a copy)."""
        out = counts.copy()
        rows = np.arange(len(out))
        for blk in REF_BLOCKS:
            out[rows, blk + self.ref] = -out[:, blk:blk + 4].sum(axis=1)
        return out

    # -- candidates ---------------------------------------------------------
    def candidates(self, aff, aff_depth):
        """(snv positions, indel positions), 0-based, sorted."""
        R, L = self.rules, self.L
        pure = aff[:, CH_BASE_F:CH_BASE_F + 4] + aff[:, CH_BASE_R:CH_BASE_R + 4]
        base = pure.copy()
        ie = self.ie
        anchors = (ie["bq"] >= R.min_bq) & (ie["kind"] > 0)
        np.add.at(base, (ie["pos"][anchors], ie["base"][anchors]), 1)
        depth = aff_depth.astype(np.float64)
        denom = np.maximum(depth, 1)
        not_ref = np.ones((L, 4), bool)
        not_ref[np.arange(L), self.ref] = False
        pass_snv = (not_ref & (base >= R.support) & (base / denom[:, None] >= R.snv_min_af)).any(1)
        has_alt = (not_ref & (pure > 0)).any(1)
        pass_depth = aff_depth > R.min_coverage
        inside = (np.arange(L) >= FLANK) & (np.arange(L) + FLANK + 1 <= L)
        snv = np.nonzero(pass_snv & has_alt & pass_depth & inside)[0]
        keys = {}
        for j in np.nonzero(anchors)[0]:
            p = ie["pos"][j]
            k = (p, "I" + ACGT[ie["base"][j]] + ie["iseq"][j] if ie["kind"][j] == 1
                 else "D" + "N" * ie["ilen"][j])
            keys[k] = keys.get(k, 0) + 1
        indel = sorted({p for (p, _k), c in keys.items()
                        if c >= R.support and c / max(aff_depth[p], 1) >= R.indel_min_af
                        and pass_depth[p] and inside[p]})
        return snv.tolist(), indel

    def column(self, p):
        """Entries at position p in file order: (rank, base, rev, bq, kind,
        ilen, iseq) arrays; base 4 is a deletion placeholder."""
        col = self._columns.get(p)
        if col is None:
            col = self._columns[p] = self._column(p)
        return col

    def _column(self, p):
        g = self.g
        a = np.searchsorted(self.sorted_start, p - self.rl + 1)
        z = np.searchsorted(self.sorted_start, p, side="right")
        reads = g.order[a:z]
        pl = np.nonzero(~np.isin(reads, g.ind_reads))[0]
        r = reads[pl]
        idx = np.searchsorted(g.plain, r)
        off = p - g.start[r]
        ok = off < self.rl
        rank = self.rank[r[ok]]
        base = g.seq[idx[ok], off[ok]].astype(np.int64)
        bq = g.qual[idx[ok], off[ok]].astype(np.int64)
        rev = g.rev[r[ok]]
        n = len(rank)
        cols = [rank, base, rev, bq, np.zeros(n, np.int64), np.zeros(n, np.int64),
                np.full(n, "", object)]
        m = self._ie_order[np.searchsorted(self._ie_pos, p):
                           np.searchsorted(self._ie_pos, p, side="right")]
        if len(m):
            ie = self.ie
            cols = [np.concatenate([c, ie[k][m]]) for c, k in
                    zip(cols, ("rank", "base", "rev", "bq", "kind", "ilen", "iseq"))]
        order = np.argsort(cols[0], kind="stable")
        return [c[order] for c in cols]

    def alt_info(self, p, min_bq):
        """(ordered alt dict, depth) of the alt-info at p: X<base>, I<anchor
        seq>, D<ref bases>, R<ref> last; keys in first-seen order."""
        rank, base, rev, bq, kind, ilen, iseq = self.column(p)
        keep = bq >= min_bq
        rb = self.ref[p]
        first, count, depth, ref_count = {}, {}, 0, 0
        for j in np.nonzero(keep)[0]:
            b, k = int(base[j]), int(kind[j])
            if k == 0:
                depth += 1
                if b == 4:
                    continue
                if b == rb:
                    ref_count += 1
                    continue
                key = "X" + ACGT[b]
            elif k == 1:
                if ilen[j] > self.rules.max_indel:
                    continue
                depth += 1
                key = "I" + ACGT[b] + iseq[j]
            else:
                if ilen[j] + 1 > self.rules.max_indel:
                    continue
                depth += 1
                key = "D" + self.ref_str[p:p + int(ilen[j]) + 1]
            first.setdefault(key, j)
            count[key] = count.get(key, 0) + 1
        alt = {k: count[k] for k in sorted(first, key=first.get)}
        if ref_count:
            alt["R" + ACGT[rb]] = ref_count
        return alt, depth

    def strand_table(self, p, alt_base):
        """(alt bqs, a0, r0, a1, r1) of the filter view at p (every entry)."""
        rank, base, rev, bq, kind, _ilen, _iseq = self.column(p)
        alt = (kind == 0) & (base == alt_base)
        a1 = int((alt & rev).sum())
        a0 = int(alt.sum()) - a1
        nrev = int(rev.sum())
        return bq[alt], a0, len(rank) - nrev - a0, a1, nrev - a1, rank[alt]

    def marked_reads(self):
        """Ranks and positions of the reads marked at a read-start or
        read-end column: a column where the reads that start (or end) there
        are the larger side and >= 20% of its depth."""
        L, first, last = self.L, self.first, self.last
        depth = np.zeros(L + self.rl + 8, np.int64)
        np.add.at(depth, first, 1)
        np.add.at(depth, last + 1, -1)
        depth = np.cumsum(depth)[:L]
        # a deleted base still has its placeholder entry: spans cover depth
        nst = np.bincount(first, minlength=L)[:L]
        nen = np.bincount(last, minlength=L)[:L]
        side = nst > nen
        mlen = np.where(side, nst, nen)
        cond = (mlen >= depth * self.rules.rse_share) & (depth > 0)
        ranks = np.arange(len(first))
        ms = cond[first] & side[first]
        me = cond[last] & ~side[last]
        pos = np.concatenate([first[ms], last[me]])
        rk = np.concatenate([ranks[ms], ranks[me]])
        o = np.argsort(pos, kind="stable")
        return pos[o], rk[o]

    def fetched(self, lo, hi):
        """By rank: the reads that overlap [lo, hi)."""
        return (self.first < hi) & (self.last + 1 > lo)

    def nonref(self):
        """Every entry that differs from the reference, sorted by (pos,
        rank): pos, rank, token (a base 0-3; a deletion placeholder 8 or 9
        by strand; an indel anchor from 16, one token for each anchor base
        and inserted sequence or deletion length) and the inserted length
        (0 but for insertions)."""
        if self._nr is not None:
            return self._nr
        g, rl = self.g, self.rl
        col = np.arange(rl)
        parts = []
        for a in range(0, len(g.plain), 16384):
            rows = g.plain[a:a + 16384]
            st = g.start[rows]
            seq = g.seq[a:a + 16384]
            i, j = np.nonzero(seq != self.g.genome[st[:, None] + col[None, :]])
            parts.append((st[i] + j, self.rank[rows[i]], seq[i, j].astype(np.int64),
                          np.zeros(len(i), np.int64)))
        ie = self.ie
        plain = ie["kind"] == 0
        sub = plain & (ie["base"] < 4)
        sub &= ie["base"] != self.ref[np.minimum(ie["pos"], self.L - 1)]
        hole = plain & (ie["base"] == 4)
        tok = np.where(hole, np.where(ie["rev"] != 0, TOK_DEL_R, TOK_DEL_F), ie["base"])
        ids = {}
        anchors = np.nonzero(ie["kind"] > 0)[0]
        for j in anchors.tolist():
            key = (int(ie["base"][j]), int(ie["kind"][j]),
                   ie["iseq"][j] if ie["kind"][j] == 1 else int(ie["ilen"][j]))
            tok[j] = ids.setdefault(key, 16 + len(ids))
        keep = sub | hole | (ie["kind"] > 0)
        parts.append((ie["pos"][keep], ie["rank"][keep], tok[keep],
                      np.where(ie["kind"][keep] == 1, ie["ilen"][keep], 0)))
        pos, rank, tok, ilen = (np.concatenate(c) for c in zip(*parts))
        o = np.lexsort((rank, pos))
        self._nr = (pos[o], rank[o], tok[o], ilen[o])
        return self._nr


# ---------------------------------------------------------- the posterior ---
def _points(x, delta, edges):
    """(N, A, P) values of x within delta: both ends, and each bin edge
    inside with the largest value below it."""
    lo = np.clip(x - delta, 0.0, 1.0)
    hi = np.clip(x + delta, 0.0, 1.0)
    inner = edges[None, :, 1:-1]                           # (1, A, 9)
    inside = (inner > lo[..., None]) & (inner <= hi[..., None])
    e = np.where(inside, inner, lo[..., None])
    below = np.where(inside, np.nextafter(inner, -np.inf), lo[..., None])
    return np.concatenate([lo[..., None], hi[..., None], e, below], axis=-1)


def posterior_bounds(p_aff, p_neg, lik, delta):
    """(lo, hi) of the float64 posterior of each allele over every AFF and
    NEG probability within ``delta`` of the given ones."""
    mats, aff_edges, neg_edges = lik
    P = _points(np.asarray(p_aff, np.float64), delta, aff_edges)
    U = _points(1.0 - np.asarray(p_neg, np.float64), delta, neg_edges)
    n, A, k = P.shape
    bi = np.clip(np.stack([np.digitize(P[:, a], aff_edges[a]) for a in range(A)], 1) - 1, 0, 9)
    bj = np.clip(np.stack([np.digitize(U[:, a], neg_edges[a]) for a in range(A)], 1) - 1, 0, 9)
    al = np.arange(A)[None, :, None, None]
    w = mats[al, bi[..., :, None], bj[..., None, :]] + ref_post.EPS
    p = P[..., :, None]
    q = 1.0 - U[..., None, :]
    num = p * (1 - q) * w
    post = num / (num + (1 - p) * q * (1 - w))
    return post.reshape(n, A, -1).min(-1), post.reshape(n, A, -1).max(-1)


def qual_of(p):
    p = np.asarray(p, np.float64)
    q = np.maximum(-10 * math.log10(math.e) * np.log(((1.0 - p) + 1e-10) / (p + 1e-10)) + 2.0,
                   0.0)
    return np.round(q, 4)


# ---------------------------------------------------------------- calling ---
def call_row(mode, p, ref_base, alt, depth, best, fwd, rev):
    """The VCF row of a candidate whose argmax allele is ``best`` (None
    where no row is written): REF, ALT, GT, DP, AF, AD and the strand
    counts.  ClairS-TO's call_variants with --qual 0, RefCalls hidden."""
    if mode == "snv":
        is_variant = ACGT[best] != ref_base
    else:
        is_variant = best >= 4
    if not is_variant or depth <= 0:
        return None
    support = [(k, c / float(depth)) for k, c in alt.items() if k[0] != "R" and c / depth > 0]
    if not support:
        return None
    ranked = sorted(support, key=lambda kv: kv[1], reverse=True)
    top = ranked[0][0]
    count = alt[top]
    ref, alt_s = ref_base, ref_base
    if top[0] == "X":
        alt_s = top[1]
        if mode == "snv" and ACGT[best] not in [k[1] for k, _ in ranked if k[0] == "X"]:
            return None
    elif top[0] == "I":
        alt_s = top[1:] if top[1] != "#" else ref_base + top[2:]
    elif top[0] == "D":
        ref = ref_base + top[2:]
    if ref == alt_s:
        return None
    if mode == "snv" and (len(ref) > 1 or len(alt_s) > 1):
        return None
    if mode == "indel" and len(ref) == 1 and len(alt_s) == 1:
        return None
    ref_num = alt.get("R" + ref_base, 0)
    af = min(count / depth, 1.0)
    return dict(POS=p + 1, REF=ref, ALT=alt_s, GT="0/1" if af < 1.0 else "1/1", DP=depth,
                AF="%.4f" % af, AFV=af, AD=f"{ref_num},{count}",
                STRANDS=tuple(int(x) for x in fwd) + tuple(int(x) for x in rev))


def fisher_two_sided(a, b, c, d):
    """Two-sided Fisher exact test: the probability of every table with the
    observed margins no more likely than the observed one (ties within a
    relative 1e-7 included)."""
    if a == b == c == d:
        return 1.0

    def lb(n, k):
        return math.lgamma(n + 1) - math.lgamma(k + 1) - math.lgamma(n - k + 1)

    m, n, k = a + b, c + d, a + c
    den = lb(m + n, k)
    obs = lb(m, a) + lb(n, k - a) - den
    total = 0.0
    for x in range(max(0, k - n), min(k, m) + 1):
        lp = lb(m, x) + lb(n, k - x) - den
        if lp <= obs + 1e-7:
            total += math.exp(lp)
    return min(total, 1.0)


class Expected:
    """Every candidate's accepted outcomes, and what the stages after the
    call must make of them."""

    def __init__(self, pile, cfg_model, model_dir, lik_paths, pon, delta, chunk_size=None):
        self.pile = pile
        self.delta = delta
        R = pile.rules
        # the run's chunks, by its arithmetic: n spans of ceil(L / n)
        size = chunk_size or R.chunk_size
        n = pile.L // size + (1 if pile.L % size else 0)
        self.per = pile.L // n + (1 if pile.L % n else 0)
        self.chunks = [(self.per * c, min(self.per * (c + 1), pile.L)) for c in range(n)]
        aff, aff_d = pile.channel_counts(R.min_bq)
        neg, neg_d = pile.channel_counts(0)
        self.snv, self.indel = pile.candidates(aff, aff_d)
        self.n_candidates = len(self.snv) + len(self.indel)
        aff_e, neg_e = pile.encode(aff), pile.encode(neg)
        self.outcomes = {}
        for mode, positions in (("snv", self.snv), ("indel", self.indel)):
            if not positions:
                self.outcomes[mode] = {}
                continue
            pos = np.asarray(positions, np.int64)
            rows = pos[:, None] + np.arange(-FLANK, FLANK + 1)[None, :]
            x_aff, x_neg = aff_e[rows], neg_e[rows]
            cov_aff, cov_neg = aff_d[pos].astype(np.float32), neg_d[pos].astype(np.float32)
            probs = _probs(mode, cfg_model[mode], model_dir, pile.device,
                           x_aff, x_neg, cov_aff, cov_neg)
            probs = np.round(probs.astype(np.float64), 8)
            lik = ref_post.load_likelihood(lik_paths[mode], len(cfg_model[mode]["cvt"]["alleles"]))
            fwd, rev = ref_post.strand_counts(x_aff[:, FLANK])
            self.outcomes[mode] = self._outcomes(mode, positions, probs, lik, fwd, rev)
        self.pon = pon
        self._filters, self._marked = {}, None

    def _outcomes(self, mode, positions, probs, lik, fwd, rev):
        lo, hi = posterior_bounds(probs[:, 0], probs[:, 1], lik, self.delta)
        out = {}
        for i, p in enumerate(positions):
            alt, depth = self.pile.alt_info(p, self.pile.rules.min_bq)
            best_lo = lo[i].max()
            accepted = {}
            for k in np.nonzero(hi[i] >= best_lo)[0].tolist():
                row = call_row(mode, p, ACGT[self.pile.ref[p]], alt, depth, k, fwd[i], rev[i])
                key = None if row is None else (row["REF"], row["ALT"])
                q = (float(qual_of(lo[i, k])), float(qual_of(hi[i, k])))
                if key in accepted:
                    q0 = accepted[key][1]
                    q = (min(q[0], q0[0]), max(q[1], q0[1]))
                accepted[key] = (row, q)
            out[p + 1] = accepted
        return out

    # -- the chunks, the phaser and the hard filters ----------------------
    def chunk_of(self, pos1):
        """The index of the chunk that holds 1-based ``pos1``."""
        return min((pos1 - 1) // self.per, len(self.chunks) - 1)

    def filters(self, c, calls):
        """{pos1: (failed, phaseable, strand p)} of chunk ``c``'s SNV calls:
        ``calls`` is every SNV call of the chunk as (pos1, ref, alt, GT, AF)
        in position order; ``failed`` the set of tags (``NO_TAG`` for the
        failure that writes none)."""
        key = (c, tuple(calls))
        if key in self._filters:
            return self._filters[key]
        pile, R = self.pile, self.pile.rules
        lo, hi = self.chunks[c]
        fetched = pile.fetched(max(lo - R.chunk_flank, 0), min(hi + R.chunk_flank, pile.L))
        het = [(p - 1, ACGT.index(alt)) for p, _r, alt, gt, _af in calls if gt == "0/1"]
        hom = [(p - 1, ACGT.index(alt)) for p, _r, alt, gt, _af in calls if gt == "1/1"]
        anchors = [(p - 1, ACGT.index(ref), ACGT.index(alt))
                   for p, ref, alt, gt, af in calls if gt == "0/1" and af >= R.anchor_af]
        hp = self._haplotags(anchors)
        out = {p: self._filter(p - 1, ACGT.index(alt), af, hp, het, hom, fetched)
               for p, _r, alt, _gt, af in calls}
        self._filters[key] = out
        return out

    def _haplotags(self, anchors):
        """By rank: each read's haplotag (1, 2, or 0 with no votes) from
        the greedy phaser over ``anchors`` (pos0, ref, alt) in order."""
        votes = np.zeros(len(self.pile.first), np.int64)
        for p, ref, alt in anchors:
            rank, base, _rev, _bq, kind, _il, _is = self.pile.column(p)
            m = (kind == 0) & ((base == ref) | (base == alt))
            rid, al = rank[m], (base[m] == alt).astype(np.int64)
            v = votes[rid]
            seen = v != 0
            score0 = int(np.where((al[seen] == 0) == (v[seen] > 0), 1, -1).sum())
            o = 0 if score0 >= 0 else 1
            votes[rid] += np.where(al == o, 1, -1)
        return np.where(votes > 0, 1, np.where(votes < 0, 2, 0))

    def _filter(self, p, alt, af, hp, het, hom, fetched):
        pile, R = self.pile, self.pile.rules
        if self._marked is None:
            self._marked = pile.marked_reads()
        rank, base, rev, bq, kind, _il, _is = pile.column(p)
        alt_m = (kind == 0) & (base == alt)
        alt_ids = rank[alt_m]
        n_alt = len(alt_ids)
        lo, hi = max(p - R.filter_flank, 0), p + R.filter_flank
        failed = set()
        if n_alt and bq[alt_m].mean() <= R.min_bq:
            failed.add("LowAltBQ")
        if n_alt:                  # every simulated read maps at quality 60
            mpos, mrk = self._marked
            s = np.searchsorted(mpos, lo)
            e = np.searchsorted(mpos, hi, side="right")
            if len(np.intersect1d(mrk[s:e], alt_ids)) >= R.rse_alt_share * n_alt:
                failed.add("ReadStartEnd")
        hp_c = hp[rank]
        hp1, hp2 = int((hp_c[alt_m] == 1).sum()), int((hp_c[alt_m] == 2).sum())
        big, small = max(hp1, hp2), min(hp1, hp2)
        if af < R.multihap_af and hp1 * hp2 > 0 and (
                small > R.max_co_exist or big / small <= 10):
            failed.add("MultiHap")
        phasable = hp1 * hp2 == 0 or (big / small >= 5 and big > R.max_co_exist)
        hap = 0 if not phasable else (1 if hp1 > hp2 else 2)
        if self._clusters(p, lo, hi, alt_ids, fetched, max(len(rank), 1)):
            failed.add("VariantCluster")
        if hap and self._no_ancestry(p, lo, hi, alt_ids[hp_c[alt_m] == hap], hap, hp, het):
            failed.add("NoAncestry")
        if self._hom_missing(p, lo, hi, alt_ids, hp, hom):
            failed.add(NO_TAG)
        all1, all2 = int((hp_c == 1).sum()), int((hp_c == 2).sum())
        phaseable = all1 * all2 > 0 and hp1 * hp2 == 0 and big > R.max_co_exist
        a1 = int((alt_m & (rev != 0)).sum())
        a0 = n_alt - a1
        nrev = int((rev != 0).sum())
        pv = fisher_two_sided(a0, len(rank) - nrev - a0, a1, nrev - a1)
        if pv < R.strand_p or a0 == 0 or a1 == 0:
            failed.add("StrandBias")
        return failed, phaseable, pv

    def _clusters(self, p, lo, hi, alt_ids, fetched, depth):
        """The variant-cluster verdict: columns in [lo, hi] but p where more
        than half the alt reads share a non-reference entry (a deletion
        placeholder aside) that the column's fetched reads carry less than
        1.5 times as often; or inserted length over depth > 3."""
        R = self.pile.rules
        pos, rank, tok, ilen = self.pile.nonref()
        s, e = np.searchsorted(pos, lo), np.searchsorted(pos, hi, side="right")
        pos, rank, tok, ilen = pos[s:e], rank[s:e], tok[s:e], ilen[s:e]
        f = fetched[rank]
        pos, rank, tok, ilen = pos[f], rank[f], tok[f], ilen[f]
        big = ilen > 2
        ins = float(np.minimum(ilen[big & (pos != p)], R.max_ins).sum())
        if ins / depth > 3:
            return True
        A = len(alt_ids)
        if not A:
            return False
        n_tok = int(tok.max()) + 1 if len(tok) else 1
        key = pos * n_tok + tok
        m = np.isin(rank, alt_ids) & (tok != TOK_DEL_F) & (tok != TOK_DEL_R) & (pos != p)
        keys, counts = np.unique(key[m], return_counts=True)
        every, every_n = np.unique(key, return_counts=True)
        matches = 0
        for col in np.unique(keys // n_tok).tolist():
            at = keys // n_tok == col
            top = int(counts[at].max())
            if not (A * (1 - R.cluster_eps) < top < A * (1 + R.cluster_eps)):
                continue
            k = keys[at][np.argmax(counts[at])]
            if every_n[np.searchsorted(every, k)] >= top * (1 + R.cluster_eps):
                continue
            matches += 1
        return matches >= R.max_co_exist

    def _no_ancestry(self, p, lo, hi, alt_on_hap, hap, hp, het):
        """Alt reads on their haplotype share no read with the phased
        carriers of a het call nearby, where those are at least half of
        its carriers."""
        on_hap = set(alt_on_hap.tolist())
        for gp, gab in het:
            if gp < lo or gp > hi or gp == p:
                continue
            rank, base, _rev, _bq, kind, _il, _is = self.pile.column(gp)
            if not len(rank):
                continue
            carriers = set(np.unique(rank[(kind == 0) & (base == gab)]).tolist())
            phased = set(rank[hp[rank] == hap].tolist()) & carriers
            if not phased or len(phased) * 2 < len(carriers):
                continue
            if not on_hap & phased:
                return True
        return False

    def _hom_missing(self, p, lo, hi, alt_ids, hp, hom):
        """Alt reads through an unphased hom call nearby (its allele in at
        least 75% of the column) mostly lack its allele."""
        R = self.pile.rules
        alt_set = set(alt_ids.tolist())
        for gp, gab in hom:
            if gp < lo or gp > hi or gp == p:
                continue
            rank, base, _rev, _bq, kind, _il, _is = self.pile.column(gp)
            if not len(rank):
                continue
            carry = (kind == 0) & (base == gab)
            hc = np.bincount(hp[rank[carry]], minlength=3)[:3]
            ac = np.bincount(hp[rank], minlength=3)[:3]
            if hc.sum() / ac.sum() < R.hom_min_af:
                continue
            if ac[1] * ac[2] and not (hc[1] * hc[2] and max(hc[1:]) / min(hc[1:]) <= 10):
                continue
            inter = set(rank.tolist()) & alt_set
            if not inter:
                continue
            overlap = set(rank[carry].tolist()) & inter
            if not overlap or len(overlap) / len(inter) < R.cluster_eps:
                return True
        return False


def _probs(mode, net_cfg, model_dir, device, x_aff, x_neg, cov_aff, cov_neg):
    """(N, 2, alleles) class-1 probabilities of both networks, float32."""
    sub = "" if mode == "snv" else "indel/"
    aff = nets.load_npz(os.path.join(model_dir, sub + "aff.npz"), device)
    neg = nets.load_npz(os.path.join(model_dir, sub + "neg.npz"), device)
    t = [torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(device)
         for a in (x_aff, x_neg, cov_aff, cov_neg)]
    return nets.class1_probs(aff, neg, net_cfg, *t).double().cpu().numpy()
