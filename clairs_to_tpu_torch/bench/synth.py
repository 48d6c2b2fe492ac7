# Port copy of clairs_to_tpu/bench/synth.py.
"""Direct pileup-tensor synthesis for network training.

The reference trains on millions of labeled tensors extracted from real BAMs
(unavailable here).  This generator samples (33, 34) tensors straight from
the tensor specification (create_tensor_pileup_calling.py channel layout +
negative ref encoding), with class-conditional center columns:

  class 0: reference site        (alt = sequencing error only)
  class 1: germline het          (alt AF ~ 0.5)
  class 2: germline hom          (alt AF ~ 1.0)
  class 3: somatic               (alt AF in [0.05, 0.45])  -> positive label

Flanking columns are reference sites with errors plus occasional germline
SNPs.  Because ref bases are redrawn per sample, networks trained on this
stream cannot memorize genome context and must learn the allele-frequency /
strand / error-pattern rule — which transfers to tensors derived from
simulated (or real) BAMs.
"""

import numpy as np

from clairs_to_tpu_torch import config as cfg

FLANK = cfg.FLANKING_BASE_NUM
WIN = cfg.NO_OF_POSITIONS
_CH = cfg.CHANNEL_INDEX


def _fill_column(t, col, ref_idx, depth, alt_idx=None, alt_count=0, rng=None,
                 error_rate=0.002):
    """Fill one position column with fwd/rev strand-split counts."""
    counts = np.zeros(4, np.int64)
    counts[ref_idx] = depth
    if alt_idx is not None and alt_count > 0:
        take = min(alt_count, depth)
        counts[ref_idx] -= take
        counts[alt_idx] += take
    # sequencing errors: move ~error_rate of bases to random other bases
    n_err = rng.binomial(depth, error_rate)
    for _ in range(n_err):
        src = rng.choice(np.nonzero(counts)[0]) if counts.sum() else ref_idx
        dst = rng.integers(0, 4)
        if counts[src] > 0 and dst != src:
            counts[src] -= 1
            counts[dst] += 1
    fwd = rng.binomial(counts, 0.5)
    rev = counts - fwd
    t[col, 0:4] = fwd
    t[col, 9:13] = rev


def _encode_ref(t, col, ref_idx):
    t[col, ref_idx] = -t[col, 0:4].sum()
    t[col, 9 + ref_idx] = -t[col, 9:13].sum()
    # LMQ/LBQ blocks are zero in this generator; their ref encoding is -0=0.


def _fill_column_buckets(
    t_aff, t_neg, col, ref_idx, depth, rng,
    alt_idx=None, alt_count=0, artifact_idx=None, artifact_count=0,
    error_rate=0.002, lowbq_rate=0.12, midbq_rate=0.15, lowmq_rate=0.03,
    dual=True, err_dst=None, strand_p=0.5, alt_bucket_skew=None,
):
    """Fill one column of both views with quality-bucketed counts.

    Buckets per base: low-MQ (mq<20 -> LMQ channels both views), then by BQ:
    hq (>=30), mid ([20,30)), low (<20).  View composition mirrors
    channel_counts (create_tensor:146-228 semantics):
      AFF (min_bq=20): main = hq+mid, LBQ = mid, low dropped entirely.
      NEG (min_bq=0):  main = hq+mid+low, LBQ = mid+low.
    Error rates rise with falling quality (x1 / x3 / x10); ``artifact``
    bases are alt-supporting reads that exist ONLY in the low-BQ bucket —
    the case the dual-view ensemble is designed to reject.
    """
    n_lowmq = rng.binomial(depth, lowmq_rate)
    d = depth - n_lowmq
    n_low = rng.binomial(d, lowbq_rate)
    n_mid = rng.binomial(d - n_low, midbq_rate)
    n_hq = d - n_low - n_mid

    def bucket_counts(nb, err_mult, alt_take):
        counts = np.zeros(4, np.int64)
        counts[ref_idx] = nb - alt_take
        if alt_idx is not None and alt_take:
            counts[alt_idx] += alt_take
        n_err = rng.binomial(max(nb, 0), min(error_rate * err_mult, 0.5))
        for _ in range(n_err):
            nz = np.nonzero(counts)[0]
            src = rng.choice(nz) if len(nz) else ref_idx
            if err_dst is not None and rng.random() < 0.8:
                dst = err_dst  # recurrent-error column (hotspot)
            else:
                dst = rng.integers(0, 4)
            if counts[src] > 0 and dst != src:
                counts[src] -= 1
                counts[dst] += 1
        return counts

    # distribute true alt reads across buckets (default proportional;
    # alt_bucket_skew biases alt support toward mid/low BQ — degraded-alt
    # robustness without copying the BAM simulator's decay mechanics)
    takes = np.zeros(3, np.int64)
    sizes = np.array([n_hq, n_mid, n_low], np.int64)
    if alt_count and sizes.sum() > 0:
        w = sizes.astype(np.float64)
        if alt_bucket_skew is not None:
            w = w * np.asarray(alt_bucket_skew, np.float64)
        if w.sum() <= 0:
            w = sizes.astype(np.float64)
        takes = rng.multinomial(min(alt_count, int(sizes.sum())), w / w.sum())
        takes = np.minimum(takes, sizes)
        # reassign overflow to buckets with room
        short = min(alt_count, int(sizes.sum())) - int(takes.sum())
        for b in range(3):
            if short <= 0:
                break
            room = int(sizes[b] - takes[b])
            add = min(room, short)
            takes[b] += add
            short -= add
    hq = bucket_counts(n_hq, 1.0, takes[0])
    mid = bucket_counts(n_mid, 3.0, takes[1])
    low = bucket_counts(n_low, 10.0, takes[2])
    if artifact_idx is not None and artifact_count:
        take = min(artifact_count, low[ref_idx])
        low[ref_idx] -= take
        low[artifact_idx] += take
    lowmq = bucket_counts(n_lowmq, 3.0, 0)

    def split(c, p=0.5):
        f = rng.binomial(c, p)
        return f, c - f

    def split_alt_aware(counts):
        """Ref bases split 50/50; the alt/err-dst base splits at strand_p."""
        if strand_p == 0.5:
            return split(counts)
        tgt = alt_idx if alt_idx is not None else err_dst
        f, r = split(counts)
        if tgt is not None and counts[tgt] > 0:
            f[tgt] = rng.binomial(counts[tgt], strand_p)
            r[tgt] = counts[tgt] - f[tgt]
        return f, r

    hq_f, hq_r = split_alt_aware(hq)
    mid_f, mid_r = split_alt_aware(mid)
    low_f, low_r = split_alt_aware(low)
    lmq_f, lmq_r = split(lowmq)

    t_aff[col, 0:4] = hq_f + mid_f
    t_aff[col, 9:13] = hq_r + mid_r
    t_aff[col, _CH["ALBQ"] : _CH["ALBQ"] + 4] = mid_f
    t_aff[col, _CH["aLBQ"] : _CH["aLBQ"] + 4] = mid_r
    t_aff[col, _CH["ALMQ"] : _CH["ALMQ"] + 4] = lmq_f
    t_aff[col, _CH["aLMQ"] : _CH["aLMQ"] + 4] = lmq_r
    if dual:
        t_neg[col, 0:4] = hq_f + mid_f + low_f
        t_neg[col, 9:13] = hq_r + mid_r + low_r
        t_neg[col, _CH["ALBQ"] : _CH["ALBQ"] + 4] = mid_f + low_f
        t_neg[col, _CH["aLBQ"] : _CH["aLBQ"] + 4] = mid_r + low_r
        t_neg[col, _CH["ALMQ"] : _CH["ALMQ"] + 4] = lmq_f
        t_neg[col, _CH["aLMQ"] : _CH["aLMQ"] + 4] = lmq_r


def _encode_ref_all(t, col, ref_idx):
    rows = (0, 9, _CH["ALMQ"], _CH["aLMQ"], _CH["ALBQ"], _CH["aLBQ"])
    for block in rows:
        s = t[col, block : block + 4].sum()
        t[col, block + ref_idx] = -s


def synthesize_dual_batch(
    rng,
    n,
    platform="ont",
    depth_range=(25, 95),
    somatic_af_range=(0.08, 0.35),
    flank_germline_rate=0.02,
    error_rate=0.002,
    class_probs=(0.33, 0.15, 0.05, 0.27, 0.10, 0.10),
    mode="snv",
    beta_subsample=True,
    lowbq_rate=0.12,
    midbq_rate=0.15,
    lowmq_rate=0.03,
    hotspot_rate=0.03,
):
    """Dual-view synthesis: (x_aff, x_neg, cov_aff, cov_neg, som).

    Classes: ref / germline-het / germline-hom / somatic / low-BQ artifact
    / structured noise.  The artifact class carries alt support only in
    sub-min_bq bases: visible to the NEG view, absent from the AFF view
    (the reference's dual-BQ asymmetry, run_clairs_to:1237 vs :1264) —
    label "not somatic".  For platforms with min_bq=0 (ilmn/hifi) the two
    views coincide and x_neg is x_aff.

    The STRUCTURED-NOISE class (5) and flanking error HOTSPOTS model the
    failure modes of real sequencers abstractly — recurrent same-base
    errors, strand-asymmetric support, BQ-degraded alt reads — WITHOUT
    copying the BAM simulator's concrete mechanics (homopolymer runs,
    positional quality decay), keeping evaluation on bamio/simulate.py
    eval_profile data decoupled from the training distribution.  True
    somatic alts also get mild strand imbalance and occasional BQ skew so
    the nets cannot treat any asymmetry as proof of noise.
    """
    fam = cfg.platform_family(platform)
    dual = cfg.MIN_BQ_DICT.get(fam, 0) > 0
    if len(class_probs) == 5:  # legacy callers: no structured-noise class
        class_probs = tuple(class_probs) + (0.0,)
    x_aff = np.zeros((n, WIN, cfg.PILEUP_CHANNEL_SIZE), np.float32)
    x_neg = x_aff if not dual else np.zeros_like(x_aff)
    cov_aff = np.zeros(n, np.float32)
    cov_neg = np.zeros(n, np.float32)
    som = np.full(n, -1, np.int32)
    classes = rng.choice(len(class_probs), size=n, p=class_probs)
    kw = dict(error_rate=error_rate, lowbq_rate=lowbq_rate,
              midbq_rate=midbq_rate, lowmq_rate=lowmq_rate, dual=dual)
    for i in range(n):
        ta = np.zeros((WIN, cfg.PILEUP_CHANNEL_SIZE), np.int64)
        tn = np.zeros_like(ta) if dual else ta
        if beta_subsample:
            depth = max(int(depth_range[1] * cfg.beta_subsample_fraction(rng)),
                        depth_range[0])
        else:
            depth = int(rng.integers(*depth_range))
        ref_indices = rng.integers(0, 4, size=WIN)
        for col in range(WIN):
            if col == FLANK:
                continue
            d = max(int(rng.normal(depth, depth * 0.06)), 4)
            if rng.random() < flank_germline_rate:
                alt = (ref_indices[col] + rng.integers(1, 4)) % 4
                ac = rng.binomial(d, 0.5)
                _fill_column_buckets(ta, tn, col, ref_indices[col], d, rng,
                                     alt_idx=alt, alt_count=ac, **kw)
            elif rng.random() < hotspot_rate:
                # recurrent-error column: errors concentrate on one base,
                # strand-asymmetric, elevated rate
                hkw = dict(kw)
                hkw["error_rate"] = error_rate * float(rng.uniform(4, 16))
                _fill_column_buckets(
                    ta, tn, col, ref_indices[col], d, rng,
                    err_dst=int((ref_indices[col] + rng.integers(1, 4)) % 4),
                    strand_p=float(rng.uniform(0.25, 0.75)), **hkw)
            else:
                _fill_column_buckets(ta, tn, col, ref_indices[col], d, rng, **kw)
            _encode_ref_all(ta, col, ref_indices[col])
            if dual:
                _encode_ref_all(tn, col, ref_indices[col])

        ref_idx = int(ref_indices[FLANK])
        klass = int(classes[i])
        alt_idx = (ref_idx + int(rng.integers(1, 4))) % 4
        indel_kind = None
        af, artifact_af = 0.0, 0.0
        center_kw = {}
        if klass == 1:
            af = float(np.clip(rng.normal(0.5, 0.03), 0.35, 0.65))
        elif klass == 2:
            af = float(np.clip(rng.normal(1.0, 0.01), 0.9, 1.0))
        elif klass == 3:
            af = float(rng.uniform(*somatic_af_range))
            if mode == "indel":
                indel_kind = ("snv", "ins", "del")[int(rng.integers(0, 3))]
            # mild, realistic asymmetries on TRUE somatic alts
            center_kw["strand_p"] = float(np.clip(rng.normal(0.5, 0.08),
                                                  0.3, 0.7))
            if rng.random() < 0.3:
                center_kw["alt_bucket_skew"] = (0.5, 1.0, 2.0)
        elif klass == 4:
            artifact_af = float(rng.uniform(0.05, 0.3))
        elif klass == 5:
            # structured noise: recurrent alt, strand-asymmetric, BQ-skewed
            af = float(rng.uniform(0.03, 0.15))
            center_kw["strand_p"] = float(
                rng.uniform(0.15, 0.85) if rng.random() < 0.5
                else rng.choice([0.05, 0.95]))
            center_kw["alt_bucket_skew"] = (0.3, 1.0, 3.0)
            center_kw["error_rate"] = error_rate * float(rng.uniform(2, 8))
        alt_count = rng.binomial(depth, af) if af > 0 else 0
        artifact_count = rng.binomial(depth, artifact_af) if artifact_af else 0

        if indel_kind in ("ins", "del"):
            _fill_column_buckets(ta, tn, FLANK, ref_idx, depth - alt_count,
                                 rng, **kw)
            fwd_cnt = rng.binomial(alt_count, 0.5)
            rev_cnt = alt_count - fwd_cnt
            chans = (("I", "i", "I1", "i1") if indel_kind == "ins"
                     else ("D", "d", "D1", "d1"))
            for t in ((ta, tn) if dual else (ta,)):
                t[FLANK, _CH[chans[0]]] += fwd_cnt
                t[FLANK, _CH[chans[1]]] += rev_cnt
                t[FLANK, _CH[chans[2]]] = fwd_cnt
                t[FLANK, _CH[chans[3]]] = rev_cnt
                if indel_kind == "del":
                    dlen = 2
                    for dcol in range(FLANK + 1, min(FLANK + 1 + dlen, WIN)):
                        t[dcol, _CH["*"]] += fwd_cnt
                        t[dcol, _CH["#"]] += rev_cnt
            if alt_count >= cfg.ALTERNATIVE_BASE_NUM:
                som[i] = 4 if indel_kind == "ins" else 5
        else:
            _fill_column_buckets(
                ta, tn, FLANK, ref_idx, depth, rng,
                alt_idx=alt_idx if af > 0 else None, alt_count=alt_count,
                artifact_idx=alt_idx if artifact_af else None,
                artifact_count=artifact_count, **{**kw, **center_kw})
            if klass == 3 and alt_count >= cfg.ALTERNATIVE_BASE_NUM:
                som[i] = alt_idx
        _encode_ref_all(ta, FLANK, ref_idx)
        if dual:
            _encode_ref_all(tn, FLANK, ref_idx)
        x_aff[i] = ta.astype(np.float32)
        if dual:
            x_neg[i] = tn.astype(np.float32)
        cov_aff[i] = depth
        cov_neg[i] = depth
    return x_aff, x_neg, cov_aff, cov_neg, som


def synthesize_batch(
    rng,
    n,
    depth_range=(20, 100),
    somatic_af_range=(0.05, 0.45),
    flank_germline_rate=0.02,
    error_rate=0.002,
    class_probs=(0.45, 0.2, 0.05, 0.3),
    mode="snv",
    beta_subsample=False,
):
    """Returns (x (n,33,34) float32, cov (n,), somatic_allele (n,) int32).

    mode='snv': classes ref / germline-het / germline-hom / somatic-SNV
    (label = alt base index 0-3).  mode='indel': the somatic class splits
    evenly into SNV (negative for the 6-allele nets), insertion (label 4,
    I/I1 channels) and deletion (label 5, D/D1 + '*' placeholder columns).

    beta_subsample=True draws per-sample depth as max_depth x Beta(2.08,5.08)
    instead of uniform in depth_range — the reference's training-time coverage
    subsampling distribution (shared/param.py:98-115 beta_acc_per).
    """
    x = np.zeros((n, WIN, cfg.PILEUP_CHANNEL_SIZE), np.float32)
    cov = np.zeros(n, np.float32)
    som = np.full(n, -1, np.int32)
    classes = rng.choice(4, size=n, p=class_probs)
    for i in range(n):
        t = np.zeros((WIN, cfg.PILEUP_CHANNEL_SIZE), np.int64)
        if beta_subsample:
            depth = max(int(depth_range[1] * cfg.beta_subsample_fraction(rng)),
                        depth_range[0])
        else:
            depth = int(rng.integers(*depth_range))
        ref_indices = rng.integers(0, 4, size=WIN)
        for col in range(WIN):
            if col == FLANK:
                continue
            d = max(int(rng.normal(depth, depth * 0.06)), 4)
            if rng.random() < flank_germline_rate:
                alt = (ref_indices[col] + rng.integers(1, 4)) % 4
                ac = rng.binomial(d, 0.5)
                _fill_column(t, col, ref_indices[col], d, alt, ac, rng, error_rate)
            else:
                _fill_column(t, col, ref_indices[col], d, rng=rng, error_rate=error_rate)
            _encode_ref(t, col, ref_indices[col])

        ref_idx = int(ref_indices[FLANK])
        klass = classes[i]
        alt_idx = (ref_idx + int(rng.integers(1, 4))) % 4
        indel_kind = None  # 'ins' | 'del' for mode='indel' somatic class
        if klass == 0:
            af = 0.0
        elif klass == 1:
            af = float(np.clip(rng.normal(0.5, 0.03), 0.35, 0.65))
        elif klass == 2:
            af = float(np.clip(rng.normal(1.0, 0.01), 0.9, 1.0))
        else:
            af = float(rng.uniform(*somatic_af_range))
            if mode == "indel":
                indel_kind = ("snv", "ins", "del")[int(rng.integers(0, 3))]
        alt_count = rng.binomial(depth, af) if af > 0 else 0

        if indel_kind in ("ins", "del"):
            # center column: ref bases minus indel carriers; indel channels
            _fill_column(t, FLANK, ref_idx, depth - alt_count, rng=rng,
                         error_rate=error_rate)
            fwd_cnt = rng.binomial(alt_count, 0.5)
            rev_cnt = alt_count - fwd_cnt
            if indel_kind == "ins":
                t[FLANK, _CH["I"]] += fwd_cnt
                t[FLANK, _CH["i"]] += rev_cnt
                t[FLANK, _CH["I1"]] = fwd_cnt
                t[FLANK, _CH["i1"]] = rev_cnt
            else:
                dlen = int(rng.integers(1, 4))
                t[FLANK, _CH["D"]] += fwd_cnt
                t[FLANK, _CH["d"]] += rev_cnt
                t[FLANK, _CH["D1"]] = fwd_cnt
                t[FLANK, _CH["d1"]] = rev_cnt
                for dcol in range(FLANK + 1, min(FLANK + 1 + dlen, WIN)):
                    t[dcol, _CH["*"]] += fwd_cnt
                    t[dcol, _CH["#"]] += rev_cnt
            _encode_ref(t, FLANK, ref_idx)
            if alt_count >= cfg.ALTERNATIVE_BASE_NUM:
                som[i] = 4 if indel_kind == "ins" else 5
        else:
            _fill_column(t, FLANK, ref_idx, depth, alt_idx if af > 0 else None,
                         alt_count, rng, error_rate)
            _encode_ref(t, FLANK, ref_idx)
            if klass == 3 and alt_count >= cfg.ALTERNATIVE_BASE_NUM:
                # mode='indel': SNV sites are negatives for the I/D alleles
                # but positives for their base allele (label semantics match
                # the 6-allele nets: som index = allele index)
                som[i] = alt_idx
        x[i] = t.astype(np.float32)
        cov[i] = depth
    return x, cov, som
