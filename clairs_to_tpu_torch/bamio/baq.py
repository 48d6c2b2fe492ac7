# Port copy of clairs_to_tpu/bamio/baq.py.
"""BAQ — Base Alignment Quality (probabilistic realignment).

samtools mpileup applies BAQ by default (the reference does not pass
--no-BAQ, so its real-data base qualities are BAQ-capped); this module
implements the algorithm from Li H. (2011) "Improving SNP discovery by base
alignment quality": a glocal profile-HMM forward/backward over
(read, reference window); each base's quality is capped by the phred-scaled
posterior probability that it is aligned to its ref column.

The delete state is eliminated analytically: a M(k) -> D... -> M(k') chain
(k' >= k+2) carries weight gap_open * gap_ext^(k'-k-2) * (1-gap_ext), which
folds into the M->M recurrences as geometric prefix/suffix scans, leaving a
two-state (M, I) DP.

Status: EXPERIMENTAL, default-off (PipelineOptions.apply_baq): the HMM
follows the paper (gap open 1e-3, extend 0.1) but byte-equality with
htslib's implementation is unvalidated — no samtools binary exists in this
environment to diff against.  Property tests cover the calling-relevant
invariants: clean full-match reads keep their qualities; bases near an
unmodeled indel are downgraded.
"""

import numpy as np
from scipy.signal import lfilter

GAP_OPEN = 1e-3
GAP_EXT = 0.1

_LUT = np.full(256, 4, dtype=np.int8)
for _b, _c in ((b"A", 0), (b"C", 1), (b"G", 2), (b"T", 3)):
    _LUT[_b[0]] = _c


def _encode(seq: str):
    return _LUT[np.frombuffer(seq.encode(), dtype=np.uint8)]


def baq_glocal(ref: str, query: str, quals):
    """Phred posterior alignment quality per query base.

    Combine with the original as min(q, baq) (htslib convention)."""
    x = _encode(query)
    y = _encode(ref)
    l, rl = len(x), len(y)
    quals = np.asarray(quals, dtype=np.float64)
    if l == 0 or rl == 0:
        return quals.astype(np.int32)

    qe = 10.0 ** (-quals / 10.0)
    match = x[:, None] == y[None, :]
    ambig = (x[:, None] == 4) | (y[None, :] == 4)
    eM = np.where(
        ambig, 1.0 - qe[:, None], np.where(match, 1.0 - qe[:, None], qe[:, None] / 3.0)
    )

    s = 1.0 / (2.0 * l + 2.0)          # termination mass (Li 2011)
    mm = (1.0 - 2.0 * GAP_OPEN) * (1.0 - s)
    mi = md = GAP_OPEN * (1.0 - s)
    im = (1.0 - GAP_EXT) * (1.0 - s)
    ii = GAP_EXT * (1.0 - s)
    dm = 1.0 - GAP_EXT
    dd = GAP_EXT
    bM = (1.0 - GAP_OPEN) / rl
    bI = GAP_OPEN / rl

    # ---- forward (scaled) ----
    fM = np.zeros((l, rl))
    fI = np.zeros((l, rl))
    scale = np.ones(l)
    fM[0] = bM * eM[0]
    fI[0] = bI * 0.25
    scale[0] = fM[0].sum() + fI[0].sum()
    fM[0] /= scale[0]
    fI[0] /= scale[0]
    for i in range(1, l):
        pM, pI = fM[i - 1], fI[i - 1]
        # chain[k] = sum_{j<=k} pM[j] * md * dd^(k-j)  (IIR: c_k = dd*c_{k-1} + md*p_k)
        chain = lfilter([md], [1.0, -dd], pM)
        cur = np.zeros(rl)
        cur[1:] = pM[:-1] * mm + pI[:-1] * im
        cur[2:] += dm * chain[:-2]
        fM[i] = cur * eM[i]
        fI[i] = 0.25 * (pM * mi + pI * ii)
        scale[i] = fM[i].sum() + fI[i].sum()
        if scale[i] <= 0:
            scale[i] = 1.0
        fM[i] /= scale[i]
        fI[i] /= scale[i]

    # ---- backward (using the same scales) ----
    gM = np.zeros((l, rl))
    gI = np.zeros((l, rl))
    gM[l - 1] = 1.0
    gI[l - 1] = 1.0
    for i in range(l - 2, -1, -1):
        egM = eM[i + 1] * gM[i + 1]          # entering M(i+1, k) emits base i+1
        nI = 0.25 * gI[i + 1]
        # rchain[k] = sum_{k'>=k} dd^(k'-k) * egM[k']  (reversed IIR)
        rchain = lfilter([1.0], [1.0, -dd], egM[::-1])[::-1]
        gm = np.zeros(rl)
        gm[:-1] += mm * egM[1:]
        gm += mi * nI
        gm[:-2] += md * dm * rchain[2:]
        gi = np.zeros(rl)
        gi[:-1] += im * egM[1:]
        gi += ii * nI
        gM[i] = gm / scale[i + 1]
        gI[i] = gi / scale[i + 1]

    postM = fM * gM
    norm = postM.sum(axis=1) + (fI * gI).sum(axis=1)
    norm = np.maximum(norm, 1e-300)
    best = postM.max(axis=1) / norm
    baq = np.minimum(-10.0 * np.log10(np.maximum(1.0 - best, 1e-10)), 93.0)
    return baq.astype(np.int32)


def apply_baq(ref_window: str, query: str, quals):
    """min(original, BAQ) per base (sam_prob_realn capping convention)."""
    baq = baq_glocal(ref_window, query, quals)
    return np.minimum(np.asarray(quals, dtype=np.int32), baq)
