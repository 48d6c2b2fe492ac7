"""A plain reference of the short-read realignment filter, in Python and
NumPy.  Imports nothing of the program.

It follows ClairS-TO's ``src/realign_variants.py:59-180`` and
``src/realign_reads.py`` (SURVEY.md §2.6, rows L4 and L5 of its layer
map): for a PASS SNV call under QUAL 8, the reads over +-100 bases of the
site are assembled into consensus haplotypes, realigned, and counted again;
the call fails when its alt AF and its alt read count both fall.

* **The de Bruijn graph** over the reference window (the site +-120 bases)
  and the window's reads: k is the smallest odd k from 15 to 31 at which
  no k-mer of the reference window repeats (the published description
  leaves the range and the step open; odd k from 15 to 31 is the rule this
  reference takes, as the repository's library does); without one the
  reference window is the only haplotype.  Each (k+1)-mer of A, C, G and T
  is an edge between its two k-mers, of weight 2 in the reference and 1 a
  read; edges under 2 are pruned.  Haplotypes are the source-to-sink paths
  (source the window's first k-mer, sink its last), found depth first
  with the successors of a node pushed in the order A, C, G, T of their
  last base, so the last pushed is followed first; a path ends at the sink,
  is dropped once longer than the window plus 60 bases, and the search
  stops at 500 haplotypes or 200,000 expansions.  Without a path the
  reference window is the only haplotype.
* **Each read's haplotype**: the one that holds the most of the read's
  15-mers taken every 15 bases from its start (the first such haplotype
  in path order on a tie).  The read is aligned to it with affine
  Smith-Waterman (match 4, mismatch 6, gap open 8, extension 1), global in
  the read and free at the haplotype's ends; each haplotype is aligned to
  the reference window the same way.  Ties in the alignment: the rightmost
  best end on the haplotype; in the traceback a match before a gap in the
  read, before a gap in the haplotype; a gap run ends where opening it
  gives the score.  A read that is an exact copy of a stretch of its
  haplotype aligns there without a gap, at the rightmost such stretch.
* **Read to reference**: each read base goes through its haplotype base
  to the reference base that one aligns to; the new CIGAR starts at the
  first base that lands on the reference (soft-clipping those before),
  takes an insertion for read bases that land nowhere, a deletion for
  reference bases skipped, and soft-clips the trailing bases that land
  nowhere.  A read of which no base lands keeps its alignment.
* **The counts**: a read counts at the site where its alignment puts a
  base there (a deletion over the site counts nowhere), the alt where that
  base is the call's ALT; the call fails when both the depth and the new
  depth are above 0, the AF falls and the alt count falls, strictly.

Departures from the published description (each as the repository's
library has it, and as the JAX package it is held to has it):

* no base is masked by its quality in the graph (ClairS-TO passes the
  reads' low-quality positions to ``get_consensus``);
* a read's haplotype comes from a vote of non-overlapping 15-mers, where
  ClairS-TO's realigner indexes 32-mers with up to 2 mismatches before its
  Smith-Waterman fallback; the alignment to that haplotype is always
  Smith-Waterman here;
* the alignments are global in the read rather than local, so the read's
  ends are never clipped by the alignment itself.
"""

import re

import numpy as np

MATCH, MISMATCH, GAP_OPEN, GAP_EXT = 4, 6, 8, 1
MIN_EDGE_SUPPORT = 2
K_RANGE = range(15, 32, 2)
MAX_HAPLOTYPES = 500
MAX_EXPANSIONS = 200_000
MAX_EXTRA = 60              # a path may run this much past the window's length
VOTE_K = 15
FLANK = 100                 # the reads over the site +- 100
REF_PAD = 20                # the reference window: the reads' window +- 20
QUAL_BELOW = 8.0            # only calls under this QUAL are checked
_CIGAR = re.compile(r"(\d+)([MIDNSHP=X])")
_CODE = np.full(256, 4, np.uint8)
for _i, _c in enumerate(b"ACGT"):
    _CODE[_c] = _i


# ---------------------------------------------------------- the graph ---
def _repeats(s, k):
    if len(s) < k:
        return True
    seen = set()
    for i in range(len(s) - k + 1):
        w = s[i:i + k]
        if w in seen:
            return True
        seen.add(w)
    return False


def consensus(ref, reads):
    """The candidate haplotypes of the reference window ``ref`` and the
    read sequences ``reads``, in path order."""
    k = next((kk for kk in K_RANGE if not _repeats(ref, kk)), None)
    if k is None:
        return [ref]
    edges = {}

    def add(s, w):
        ok = np.frombuffer(s.encode(), np.uint8)
        ok = _CODE[ok] < 4
        bad = np.concatenate([[0], np.cumsum(~ok)])
        for i in range(len(s) - k):
            if bad[i + k + 1] - bad[i]:
                continue
            succ = edges.setdefault(s[i:i + k], {})
            nxt = s[i + 1:i + k + 1]
            succ[nxt] = succ.get(nxt, 0) + w

    add(ref, MIN_EDGE_SUPPORT)
    for r in reads:
        add(r, 1)
    graph = {n: sorted(x for x, w in succ.items() if w >= MIN_EDGE_SUPPORT)
             for n, succ in edges.items()}
    source, sink = ref[:k], ref[-k:]
    max_len = len(ref) + MAX_EXTRA
    haps, stack, expansions = [], [(source, source)], 0
    while stack and len(haps) < MAX_HAPLOTYPES and expansions < MAX_EXPANSIONS:
        expansions += 1
        node, path = stack.pop()
        if node == sink and len(path) >= k + 1:
            haps.append(path)
            continue
        if len(path) > max_len:
            continue
        for nxt in graph.get(node, ()):
            stack.append((nxt, path + nxt[-1]))
    return haps or [ref]


# ------------------------------------------------------ the alignment ---
def align(queries, target):
    """[(start on target, [(op, length), ...])] of each query aligned to
    ``target``: global in the query, free at the target's ends."""
    out = [None] * len(queries)
    by_len = {}
    for i, q in enumerate(queries):
        p = target.rfind(q) if q else -1
        if p >= 0:
            out[i] = (p, [("M", len(q))])
        else:
            by_len.setdefault(len(q), []).append(i)
    t = _CODE[np.frombuffer(target.encode(), np.uint8)]
    for n, idx in by_len.items():
        q = np.stack([_CODE[np.frombuffer(queries[i].encode(), np.uint8)] for i in idx])
        for i, res in zip(idx, _align_batch(q, t)):
            out[i] = res
    return out


def _align_batch(q, t):
    """The affine glocal alignment of each row of ``q`` (same length) to
    ``t``, row by row of the score matrix for all queries at once.  The
    scores fit int16: no real score lies below -(8 + |t| + 6 |q|), and
    ``LOW`` stands for minus infinity far under any of them."""
    nq, n = q.shape
    m = len(t)
    assert GAP_OPEN + m + MISMATCH * n < 8000
    low = np.int16(-30000)
    cols = np.arange(m + 1, dtype=np.int16)
    score = np.where(np.arange(5)[:, None] == t[None, :], MATCH, -MISMATCH).astype(np.int16)
    Hp = np.zeros((nq, m + 1), np.int16)
    Ep = np.full((nq, m + 1), low, np.int16)
    bp = np.zeros((n + 1, nq, m + 1), np.uint8)
    he = np.empty((nq, m + 1), np.int16)
    f = np.full((nq, m + 1), low, np.int16)
    ramp = (GAP_EXT * cols - GAP_OPEN).astype(np.int16)
    back = (GAP_EXT * cols[:-1]).astype(np.int16)
    for i in range(1, n + 1):
        e = np.maximum(Hp - GAP_OPEN, Ep - GAP_EXT)
        diag = Hp[:, :-1] + score[q[:, i - 1]]
        he[:, 0] = e[:, 0]
        np.maximum(diag, e[:, 1:], out=he[:, 1:])
        # the gap in the target, F[j] = max(H[j-1] - open, F[j-1] - ext),
        # as a running maximum: F[j] = max_k<j (he[k] - open - ext (j-1-k))
        run = np.maximum.accumulate(he + ramp, axis=1)
        np.subtract(run[:, :-1], back, out=f[:, 1:])
        h = np.maximum(he, f)
        h[:, 0] = e[:, 0]
        b = bp[i]
        b[:, 0] = 1
        b[:, 1:] = (h[:, 1:] != diag).view(np.uint8) + ((h[:, 1:] != diag)
                                                          & (h[:, 1:] != e[:, 1:])).view(np.uint8)
        b |= (e == Hp - GAP_OPEN).view(np.uint8) << 2
        b[:, 1:] |= (f[:, 1:] == h[:, :-1] - GAP_OPEN).view(np.uint8) << 3
        Hp, Ep = h, e
    best_j = m - np.argmax(Hp[:, ::-1], axis=1)
    return [_traceback(bp[:, r, :], n, int(best_j[r])) for r in range(nq)]


def _traceback(bp, i, j):
    ops = []
    state = "H"
    while i > 0:
        b = int(bp[i, j])
        if state == "H":
            mv = b & 3
            if mv == 0:
                ops.append("M")
                i -= 1
                j -= 1
            else:
                state = "E" if mv == 1 else "F"
        elif state == "E":
            ops.append("I")
            if b & 4:
                state = "H"
            i -= 1
        else:
            ops.append("D")
            if b & 8:
                state = "H"
            j -= 1
    runs = []
    for op in reversed(ops):
        if runs and runs[-1][0] == op:
            runs[-1][1] += 1
        else:
            runs.append([op, 1])
    return j, [(op, ln) for op, ln in runs]


def to_target(start, runs, n):
    """(n,) the target position of each query base, -1 where inserted."""
    out = np.full(n, -1, np.int64)
    qi, tj = 0, start
    for op, ln in runs:
        if op == "M":
            out[qi:qi + ln] = np.arange(tj, tj + ln)
            qi += ln
            tj += ln
        elif op == "I":
            qi += ln
        else:
            tj += ln
    return out


def compose(r2h, hap2ref, ref_start):
    """(new 0-based position, CIGAR) of a read from each base's haplotype
    position through the haplotype's reference positions; (-1, "") where
    no base lands on the reference."""
    ok = (r2h >= 0) & (r2h < len(hap2ref))
    r2r = np.where(ok, hap2ref[np.where(ok, r2h, 0)], -1)
    mapped = np.nonzero(r2r >= 0)[0]
    if not len(mapped):
        return -1, ""
    first, last, n = int(mapped[0]), int(mapped[-1]), len(r2r)
    runs = []

    def push(op, ln):
        if ln <= 0:
            return
        if runs and runs[-1][0] == op:
            runs[-1][1] += ln
        else:
            runs.append([op, ln])

    push("S", first)
    ins = np.diff(mapped) - 1
    gap = np.diff(r2r[mapped])
    if not ins.any() and (gap == 1).all():
        push("M", len(mapped))
    else:
        push("M", 1)
        for a, d in zip(ins.tolist(), gap.tolist()):
            push("I", a)
            if d > 1:
                push("D", d - 1)
            push("M", 1)
    push("S", n - 1 - last)
    return ref_start + int(r2r[first]), "".join(f"{ln}{op}" for op, ln in runs)


def realign(ref, ref_start, seqs, haps):
    """(new positions, CIGARs) of the reads ``seqs`` realigned through
    ``haps`` onto the reference window ``ref`` that starts at
    ``ref_start``; position -1 and CIGAR "" where a read keeps its own."""
    hap2ref = [to_target(s, runs, len(h)) for h, (s, runs) in zip(haps, align(haps, ref))]
    kmers = [{h[i:i + VOTE_K] for i in range(len(h) - VOTE_K + 1)} for h in haps]
    best = []
    for s in seqs:
        words = [s[i:i + VOTE_K] for i in range(0, len(s) - VOTE_K + 1, VOTE_K)]
        words = [w for w in words if not w.strip("ACGT")]
        votes = [sum(w in km for w in words) for km in kmers]
        best.append(int(np.argmax(votes)) if votes else -1)
    pos = np.full(len(seqs), -1, np.int64)
    cigars = [""] * len(seqs)
    for hi in sorted(set(best) - {-1}):
        idx = [i for i, b in enumerate(best) if b == hi]
        for i, (start, runs) in zip(idx, align([seqs[i] for i in idx], haps[hi])):
            pos[i], cigars[i] = compose(to_target(start, runs, len(seqs[i])), hap2ref[hi],
                                        ref_start)
    return pos, cigars


# ---------------------------------------------------------- the counts ---
def base_at(pos0, rpos, cigar, seq):
    """The read's base at ``pos0`` under its alignment, or None."""
    ref, q = rpos, 0
    for num, op in _CIGAR.findall(cigar):
        ln = int(num)
        if op in "M=X":
            if ref <= pos0 < ref + ln:
                return seq[q + pos0 - ref]
            ref += ln
            q += ln
        elif op in "IS":
            q += ln
        elif op in "DN":
            if ref <= pos0 < ref + ln:
                return None
            ref += ln
    return None


def counts(reads, pos0, alt):
    """(alt count, depth) of (position, CIGAR, sequence) reads at ``pos0``."""
    bases = [base_at(pos0, p, c, s) for p, c, s in reads]
    bases = [b for b in bases if b is not None]
    return sum(b.upper() == alt for b in bases), len(bases)


def fails(raw_alt, raw_depth, new_alt, new_depth):
    if raw_depth <= 0 or new_depth <= 0:
        return False
    return raw_alt / raw_depth > new_alt / new_depth and new_alt < raw_alt


def site(ref_window, ref_lo, reads, pos0, alt):
    """The filter at one call: ``reads`` are (position, CIGAR, sequence)
    of the reads over the site +- 100 in file order, ``ref_window`` the
    reference from ``ref_lo``.  Returns {fail, haplotypes, reads, before,
    after, positions, cigars}."""
    seqs = [s for _p, _c, s in reads]
    haps = consensus(ref_window, seqs)
    pos, cigars = realign(ref_window, ref_lo, seqs, haps)
    new = [(int(p), c, s) if p >= 0 and c else (rp, rc, s)
           for (rp, rc, s), p, c in zip(reads, pos, cigars)]
    before, after = counts(reads, pos0, alt), counts(new, pos0, alt)
    return dict(fail=fails(*before, *after), haplotypes=haps, reads=len(reads), before=before,
                after=after, positions=pos, cigars=cigars)
