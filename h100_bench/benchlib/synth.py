"""Dual-view pileup tensors drawn from a seed, vectorised over rows, on
the device.

The benchmark's frozen copy of the port's ``bench/synth.py::
synthesize_dual_batch``: the same channel layout (34 channels of
create_tensor_pileup_calling.py, the reference base's count negated), the
same six classes (reference, germline het, germline hom, somatic, a low-BQ
artifact seen only by the NEG view, structured noise), the same depths
(95 x Beta(2.08, 5.08), at least 25), quality buckets (low MQ 3%, then low
BQ 12% and mid BQ 15% of the rest) and flanking germline sites and error
hotspots.  Where the original draws one read or one error at a time on the
host, this copy draws each count in one binomial over all rows and columns
at once with a ``torch.Generator`` on the device, so its numbers differ
from the original's for a seed while the distribution is the same;
sequencing errors always leave the reference base (the original picks a
random non-empty base, nearly always the reference).  The original takes
about 45 s for 8,192 rows on the host.

Counts come out as int32, as the port's decoder hands them to the engine,
and coverages as float32.
"""

import numpy as np
import torch

WIN, FLANK = 33, 16
CHANNELS = ("A", "C", "G", "T", "I", "I1", "D", "D1", "*",
            "a", "c", "g", "t", "i", "i1", "d", "d1", "#",
            "ALMQ", "CLMQ", "GLMQ", "TLMQ", "aLMQ", "cLMQ", "gLMQ", "tLMQ",
            "ALBQ", "CLBQ", "GLBQ", "TLBQ", "aLBQ", "cLBQ", "gLBQ", "tLBQ")
CH = {c: i for i, c in enumerate(CHANNELS)}
N_CH = len(CHANNELS)
CLASS_PROBS = (0.33, 0.15, 0.05, 0.27, 0.10, 0.10)
MIN_SUPPORT = 3   # alt reads for a somatic label (ALTERNATIVE_BASE_NUM)


class Draws:
    """Draws from one ``torch.Generator`` on one device."""

    def __init__(self, seed, device):
        self.device = torch.device(device)
        self.gen = torch.Generator(device=self.device).manual_seed(int(seed))

    def _t(self, v):
        return torch.as_tensor(v, dtype=torch.float32, device=self.device)

    def binom(self, n, p):
        n, p = torch.broadcast_tensors(self._t(n), self._t(p))
        return torch.binomial(n.contiguous(), p.contiguous(), generator=self.gen).long()

    def rand(self, *shape):
        return torch.rand(shape, generator=self.gen, device=self.device, dtype=torch.float64)

    def uniform(self, lo, hi, *shape):
        return lo + (hi - lo) * self.rand(*shape)

    def normal(self, mean, std):
        return torch.normal(mean.double(), std.double(), generator=self.gen)

    def integers(self, lo, hi, *shape):
        return torch.randint(lo, hi, shape, generator=self.gen, device=self.device)

    def beta(self, a, b, n):
        x = torch._standard_gamma(torch.full((n,), a, device=self.device, dtype=torch.float64),
                                  generator=self.gen)
        y = torch._standard_gamma(torch.full((n,), b, device=self.device, dtype=torch.float64),
                                  generator=self.gen)
        return x / (x + y)

    def choice(self, probs, n):
        return torch.multinomial(self._t(probs), n, replacement=True, generator=self.gen)


def _take(t, idx):
    return t.gather(-1, idx[..., None])[..., 0]


def _put(t, idx, v):
    t.scatter_(-1, idx[..., None], v[..., None])


def _add(t, idx, v):
    t.scatter_add_(-1, idx[..., None], v[..., None])


def _multinomial3(r, total, w):
    """Splits ``total`` (shape S) over three buckets with weights ``w``
    (shape S + (3,)) by two binomials."""
    wsum = w.sum(-1)
    p0 = torch.where(wsum > 0, w[..., 0] / wsum.clamp_min(1e-30), 0.0)
    a = r.binom(total, p0.clamp(0, 1))
    rest = total - a
    w12 = w[..., 1] + w[..., 2]
    p1 = torch.where(w12 > 0, w[..., 1] / w12.clamp_min(1e-30), 0.0)
    b = r.binom(rest, p1.clamp(0, 1))
    return torch.stack([a, b, rest - b], dim=-1)


def _bucket(r, size, ref, alt, take, err_rate, err_dst):
    """(S, 4) base counts of one quality bucket: ``size`` bases, ``take``
    of them the alt base, then errors moved off the reference base (80% to
    ``err_dst`` where it is >= 0, else to one of the other three)."""
    counts = torch.zeros(size.shape + (4,), dtype=torch.long, device=size.device)
    _put(counts, ref, size - take)
    has_alt = take > 0
    _add(counts, torch.where(has_alt, alt, ref), torch.where(has_alt, take, 0))
    n_ref = _take(counts, ref)
    n_err = torch.minimum(r.binom(size.clamp_min(0), err_rate.clamp_max(0.5)), n_ref)
    hot = torch.where(err_dst >= 0, r.binom(n_err, 0.8), 0)
    moved = r.binom(n_err - hot, 0.75)     # a uniform pick of the ref itself moves nothing
    spread = _multinomial3(r, moved, torch.ones(moved.shape + (3,), device=size.device))
    _put(counts, ref, n_ref - hot - moved)
    for j in range(3):
        _add(counts, (ref + 1 + j) % 4, spread[..., j])
    _add(counts, torch.where(err_dst >= 0, err_dst, ref), hot)
    return counts


def _split(r, counts, target, strand_p):
    """Forward-strand share of each count: one half, except the ``target``
    base (where >= 0) at ``strand_p``."""
    fwd = r.binom(counts, 0.5)
    has = target >= 0
    tgt = torch.where(has, target, 0)
    f_t = r.binom(_take(counts, tgt), strand_p)
    _put(fwd, tgt, torch.where(has, f_t, _take(fwd, tgt)))
    return fwd, counts - fwd


def dual_batch(seed, n, device="cpu", dual=True, mode="snv", depth_range=(25, 95),
               somatic_af_range=(0.08, 0.35), flank_germline_rate=0.02,
               hotspot_rate=0.03, error_rate=0.002, class_probs=CLASS_PROBS,
               lowbq_rate=0.12, midbq_rate=0.15, lowmq_rate=0.03):
    """(x_aff, x_neg, cov_aff, cov_neg, som) for ``n`` rows, tensors on
    ``device``.

    x_* are (n, 33, 34) int32; x_neg is x_aff itself when ``dual`` is
    False (platforms whose two views coincide).  ``som`` is the somatic
    allele index (0-3 a base, 4 an insertion, 5 a deletion) or -1."""
    r = Draws(seed, device)
    dev = r.device
    depth = torch.clamp_min((depth_range[1] * r.beta(2.08, 5.08, n)).long(), depth_range[0])
    ref = r.integers(0, 4, n, WIN)
    dcol = depth[:, None].double().expand(n, WIN)
    d = torch.clamp_min(r.normal(dcol, dcol * 0.06).long(), 4)
    d[:, FLANK] = depth
    klass = r.choice(class_probs, n)

    # flanking columns: germline sites and error hotspots
    germ = r.rand(n, WIN) < flank_germline_rate
    hot = ~germ & (r.rand(n, WIN) < hotspot_rate)
    germ[:, FLANK] = False
    hot[:, FLANK] = False
    alt = (ref + r.integers(1, 4, n, WIN)) % 4
    alt_count = torch.where(germ, r.binom(d, 0.5), 0)
    err = torch.where(hot, error_rate * r.uniform(4, 16, n, WIN), error_rate)
    err_dst = torch.where(hot, (ref + r.integers(1, 4, n, WIN)) % 4, -1)
    strand_p = torch.where(hot, r.uniform(0.25, 0.75, n, WIN), 0.5)
    skew = torch.ones((n, WIN, 3), dtype=torch.float64, device=dev)

    # the center column, by class
    c = FLANK
    half = torch.full((n,), 0.5, dtype=torch.float64, device=dev)
    af = torch.zeros(n, dtype=torch.float64, device=dev)
    af = torch.where(klass == 1, r.normal(half, torch.full_like(half, 0.03)).clamp(0.35, 0.65), af)
    af = torch.where(klass == 2, r.normal(2 * half, torch.full_like(half, 0.01)).clamp(0.9, 1.0),
                     af)
    af = torch.where(klass == 3, r.uniform(*somatic_af_range, n), af)
    af = torch.where(klass == 5, r.uniform(0.03, 0.15, n), af)
    artifact_af = torch.where(klass == 4, r.uniform(0.05, 0.3, n), 0.0)
    sp = torch.where(klass == 3, r.normal(half, torch.full_like(half, 0.08)).clamp(0.3, 0.7), half)
    extreme = torch.where(r.rand(n) < 0.5, 0.05, 0.95)
    sp = torch.where(klass == 5, torch.where(r.rand(n) < 0.5, r.uniform(0.15, 0.85, n), extreme),
                     sp)
    skew3 = (klass == 3) & (r.rand(n) < 0.3)
    skew[skew3, c] = torch.tensor([0.5, 1.0, 2.0], dtype=torch.float64, device=dev)
    skew[klass == 5, c] = torch.tensor([0.3, 1.0, 3.0], dtype=torch.float64, device=dev)
    err[:, c] = torch.where(klass == 5, error_rate * r.uniform(2, 8, n), error_rate)
    center_alt = alt[:, c]
    center_count = torch.where(af > 0, r.binom(depth, af), 0)
    artifact_count = torch.where(artifact_af > 0, r.binom(depth, artifact_af), 0)
    kinds = r.integers(0, 3, n)
    indel_kind = torch.where((klass == 3) & (mode == "indel"), kinds, 0)
    is_indel = indel_kind > 0
    # an indel's carriers leave the center's base counts: its column holds
    # depth - carriers reference reads and no alt base
    d[:, c] = torch.where(is_indel, depth - center_count, depth)
    alt_count[:, c] = torch.where(is_indel, 0, center_count)
    strand_p[:, c] = torch.where(is_indel, 0.5, sp)

    # quality buckets of every column
    n_lowmq = r.binom(d, lowmq_rate)
    dd = d - n_lowmq
    n_low = r.binom(dd, lowbq_rate)
    n_mid = r.binom(dd - n_low, midbq_rate)
    sizes = torch.stack([dd - n_low - n_mid, n_mid, n_low], dim=-1)
    a_tot = torch.minimum(alt_count, sizes.sum(-1))
    takes = torch.minimum(_multinomial3(r, a_tot, sizes * skew), sizes)
    short = a_tot - takes.sum(-1)
    for b in range(3):
        add = torch.minimum(sizes[..., b] - takes[..., b], short)
        takes[..., b] += add
        short = short - add
    alt_b = torch.where(alt_count > 0, alt, -1)
    no_alt = torch.full_like(ref, -1)
    hq = _bucket(r, sizes[..., 0], ref, alt_b, takes[..., 0], err, err_dst)
    mid = _bucket(r, sizes[..., 1], ref, alt_b, takes[..., 1], err * 3, err_dst)
    low = _bucket(r, sizes[..., 2], ref, alt_b, takes[..., 2], err * 10, err_dst)
    lowmq = _bucket(r, n_lowmq, ref, no_alt, torch.zeros_like(n_lowmq), err * 3, err_dst)
    # the artifact: alt reads only among the low-BQ bases of the center
    rows = torch.arange(n, device=dev)
    ref_c = ref[:, c]
    art = torch.minimum(artifact_count, low[rows, c, ref_c])
    low[rows, c, ref_c] -= art
    low[rows, c, center_alt] += art

    target = torch.where(alt_count > 0, alt, err_dst)
    hq_f, hq_r = _split(r, hq, target, strand_p)
    mid_f, mid_r = _split(r, mid, target, strand_p)
    low_f, low_r = _split(r, low, target, strand_p)
    lmq_f, lmq_r = _split(r, lowmq, no_alt, 0.5)

    def view(main_f, main_r, lbq_f, lbq_r):
        t = torch.zeros((n, WIN, N_CH), dtype=torch.int32, device=dev)
        t[..., 0:4], t[..., 9:13] = main_f.int(), main_r.int()
        t[..., CH["ALBQ"]:CH["ALBQ"] + 4] = lbq_f.int()
        t[..., CH["aLBQ"]:CH["aLBQ"] + 4] = lbq_r.int()
        t[..., CH["ALMQ"]:CH["ALMQ"] + 4] = lmq_f.int()
        t[..., CH["aLMQ"]:CH["aLMQ"] + 4] = lmq_r.int()
        return t

    views = [view(hq_f + mid_f, hq_r + mid_r, mid_f, mid_r)]
    if dual:
        views.append(view(hq_f + mid_f + low_f, hq_r + mid_r + low_r,
                          mid_f + low_f, mid_r + low_r))

    # indel carriers: I/i/I1/i1 or D/d/D1/d1 at the center, '*'/'#' on the
    # two deleted positions after it
    fwd = r.binom(center_count, 0.5).int()
    rev = center_count.int() - fwd
    ins, dele = rows[indel_kind == 1], rows[indel_kind == 2]
    for t in views:
        for sel, names in ((ins, ("I", "i", "I1", "i1")), (dele, ("D", "d", "D1", "d1"))):
            t[sel, c, CH[names[0]]] += fwd[sel]
            t[sel, c, CH[names[1]]] += rev[sel]
            t[sel, c, CH[names[2]]] = fwd[sel]
            t[sel, c, CH[names[3]]] = rev[sel]
        for dc in (c + 1, c + 2):
            t[dele, dc, CH["*"]] += fwd[dele]
            t[dele, dc, CH["#"]] += rev[dele]
        # the reference base of each block holds minus the block's sum
        for block in (0, 9, CH["ALMQ"], CH["aLMQ"], CH["ALBQ"], CH["aLBQ"]):
            blk = t[..., block:block + 4]
            _put(blk, ref, -blk.sum(-1, dtype=torch.int32))

    supported = (klass == 3) & (center_count >= MIN_SUPPORT)
    som = torch.full((n,), -1, dtype=torch.int32, device=dev)
    som = torch.where(supported & (indel_kind == 0), center_alt.int(), som)
    som = torch.where(supported & (indel_kind == 1), 4, som)
    som = torch.where(supported & (indel_kind == 2), 5, som).int()
    x_aff = views[0]
    x_neg = views[1] if dual else x_aff
    cov = depth.float()
    return x_aff, x_neg, cov, cov.clone(), som


def batch_seeds(seed, count):
    """``count`` 63-bit seeds drawn from ``seed``'s SeedSequence: batch i of
    a pool has its own, so a pool is the same whatever else is drawn."""
    states = np.random.SeedSequence(int(seed) % 2 ** 64).generate_state(2 * count, np.uint32)
    return [(int(states[2 * i]) << 31) ^ int(states[2 * i + 1]) for i in range(count)]


def draw_many(seed, kwargs_list, device):
    """``dual_batch(seed_i, device=device, **kw)`` for each kw in turn."""
    seeds = batch_seeds(seed, len(kwargs_list))
    return [dual_batch(s, device=device, **kw) for s, kw in zip(seeds, kwargs_list)]


def to_host(batch):
    """A batch as host NumPy arrays (x_neg stays x_aff where they are one)."""
    xa, xn, ca, cn, som = batch
    ha = xa.cpu().numpy()
    return (ha, ha if xn is xa else xn.cpu().numpy(), ca.cpu().numpy(), cn.cpu().numpy(),
            som.cpu().numpy())
