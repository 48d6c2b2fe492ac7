"""A simulated tumor-only genome: one contig, its variants and its reads,
drawn from a seed in bulk, written as ``ref.fa`` (+ ``.fai``), a sorted and
indexed ``tumor.bam`` and a panel-of-normals VCF.

The read model is the one the repository's simulator documents
(``bamio/simulate.py`` with ``bench/profiles.py``'s ``ont`` profile): a
random genome at 41% GC; non-overlapping variants at least ``min_gap``
apart and ``max(200, read_length)`` from the ends (somatic SNVs, somatic
insertions and deletions of 1-3 bases in turn, germline SNVs at AF 0.5 on
haplotype 0); reads of ``read_length`` reference bases at uniform starts,
each of haplotype 0 or 1, carrying a germline variant on haplotype 0 and a
somatic one on its own haplotype with probability min(2 AF, 1); base
quality ``base_qual`` decaying linearly by ``qual_decay`` to the read's
end; substitution errors at ``error_rate``, times ``strand_err_mult`` on
the reverse strand, ``hp_error_mult`` inside homopolymers of 3 or more and
``burst_err_mult`` inside a burst (one read in ``1 / burst_rate``: a
stretch of ``burst_len`` bases at quality at most ``burst_qual``).  The
draws are vectorised, so the random stream is this module's own: the same
seed gives the same genome, variants and reads.

The reads are kept as arrays for the plain reference: reads without an
indel as one (n, read_length) block of bases and qualities, reads with one
as explicit CIGARs.  Imports nothing of the program.
"""

import hashlib
import json
import os
import shutil
import struct
import zlib
from concurrent.futures import ThreadPoolExecutor

import numpy as np

BASES = np.frombuffer(b"ACGT", np.uint8)
KIND_SNV, KIND_INS, KIND_DEL = 0, 1, 2
OP_M, OP_I, OP_D = 0, 1, 2
NAME_LEN = 8                 # "r" + 7 digits
BGZF_BLOCK = 65280           # uncompressed bytes a BGZF block
_EOF = bytes.fromhex("1f8b08040000000000ff0600424302001b0003000000000000000000")
_NT16 = np.array([1, 2, 4, 8], np.uint8)      # A C G T in BAM's 4-bit code


class Genome:
    """The contig, its variants and its reads (arrays), with ``params``."""

    def __init__(self, **kw):
        self.__dict__.update(kw)


def _place_variants(rng, L, p):
    """(pos, kind, ref, alt, af, germline, som_hap) sorted by position."""
    margin = max(200, p["read_length"])
    gap = p["min_gap"]
    occ = np.zeros(L + 2 * gap, bool)
    n_som, n_ind, n_germ = p["n_snv"], p["n_indel"], p["genome_len"] // p["germline_every"]
    total = n_som + n_ind + n_germ
    out = np.empty(total, np.int64)
    k = 0
    while k < total:
        for q in rng.integers(margin, L - margin, size=4 * (total - k) + 16):
            q = int(q)
            if not occ[q + gap]:
                occ[q + 1:q + 2 * gap] = True    # no other within gap - 1 of q
                out[k] = q
                k += 1
                if k == total:
                    break
    kind = np.zeros(total, np.int8)
    kind[n_som:n_som + n_ind] = np.where(np.arange(n_ind) % 2 == 0, KIND_INS, KIND_DEL)
    germline = np.zeros(total, bool)
    germline[n_som + n_ind:] = True
    af = np.where(germline, 0.5, rng.choice(np.asarray(p["af_choices"], float), size=total))
    ilen = np.where(kind == KIND_SNV, 0, rng.integers(1, 4, size=total))
    shift = rng.integers(1, 4, size=total)          # SNV alt: ref + 1..3 (mod 4)
    ins_bases = rng.integers(0, 4, size=(total, 3))
    som_hap = rng.integers(0, 2, size=total)
    order = np.argsort(out, kind="stable")
    return dict(pos=out[order], kind=kind[order], ilen=ilen[order].astype(np.int64),
                af=af[order], germline=germline[order], shift=shift[order],
                ins_bases=ins_bases[order].astype(np.uint8), som_hap=som_hap[order])


def _homopolymer(seq2d):
    """Bases (rows of equal length) inside runs of 3 or more equal bases."""
    n, m = seq2d.shape
    flat = seq2d.reshape(-1)
    new = np.ones(flat.shape, bool)
    new[1:] = flat[1:] != flat[:-1]
    new[::m] = True
    run = np.cumsum(new) - 1
    return (np.bincount(run)[run] >= 3).reshape(n, m)


def _errors(rng, seq, qual, rev, lengths, p):
    """Applies burst qualities and substitution errors in place to rows of
    ``seq``/``qual`` whose first ``lengths[i]`` bases are the read."""
    n, m = seq.shape
    col = np.arange(m)[None, :]
    inside = col < lengths[:, None]
    err = np.full((n, m), p["error_rate"], np.float64)
    err[rev] *= p["strand_err_mult"]
    err[_homopolymer(seq) & inside] *= p["hp_error_mult"]
    burst = rng.random(n) < p["burst_rate"]
    blen = np.minimum(p["burst_len"], lengths)
    b0 = (rng.random(n) * (lengths - blen + 1)).astype(np.int64)
    in_burst = burst[:, None] & (col >= b0[:, None]) & (col < (b0 + blen)[:, None])
    err[in_burst] *= p["burst_err_mult"]
    qual[in_burst] = np.minimum(qual[in_burst], p["burst_qual"])
    hit = (rng.random((n, m), dtype=np.float32) < np.minimum(err, 0.5)) & inside
    seq[hit] = (seq[hit] + rng.integers(1, 4, size=int(hit.sum()), dtype=np.uint8)) % 4


def _decayed_qual(p, lengths, m):
    """Base quality by position: max(2, int(q - decay * i / length))."""
    i = np.arange(m)[None, :]
    q = np.floor(p["base_qual"] - p["qual_decay"] * i / lengths[:, None]).astype(np.int64)
    return np.maximum(q, 2).astype(np.uint8)


def simulate(seed, p):
    """The genome of ``seed`` under the parameters ``p`` (a cell's ``genome``)."""
    rng = np.random.default_rng([seed & 0xFFFFFFFF, seed >> 32, 20])
    L, rl = p["genome_len"], p["read_length"]
    gc = p["gc"]
    genome = rng.choice(4, size=L, p=[(1 - gc) / 2, gc / 2, gc / 2, (1 - gc) / 2]).astype(np.uint8)
    v = _place_variants(rng, L, p)
    vref = genome[v["pos"]]
    valt = ((vref.astype(np.int64) + v["shift"]) % 4).astype(np.uint8)

    R = int(L * p["coverage"] / rl)
    start = rng.integers(0, L - rl, size=R)
    hap = rng.integers(0, 2, size=R)
    rev = rng.random(R) < 0.5
    # (read, variant) pairs inside the read's reference span, and who carries
    lo = np.searchsorted(v["pos"], start)
    hi = np.searchsorted(v["pos"], start + rl)
    n_pairs = hi - lo
    pr = np.repeat(np.arange(R), n_pairs)
    pv = np.repeat(lo - np.cumsum(n_pairs) + n_pairs, n_pairs) + np.arange(n_pairs.sum())
    draw = rng.random(len(pr))
    take = np.where(v["germline"][pv], hap[pr] == 0,
                    (hap[pr] == v["som_hap"][pv]) & (draw < np.minimum(2 * v["af"][pv], 1.0)))
    pr, pv = pr[take], pv[take]
    has_indel = np.zeros(R, bool)
    has_indel[pr[v["kind"][pv] != KIND_SNV]] = True

    # reads without an indel: one block of rl aligned bases
    plain = np.nonzero(~has_indel)[0]
    pidx = np.full(R, -1, np.int64)
    pidx[plain] = np.arange(len(plain))
    seq = genome[start[plain, None] + np.arange(rl)[None, :]]
    snv = (~has_indel[pr]) & (v["kind"][pv] == KIND_SNV)
    seq[pidx[pr[snv]], v["pos"][pv[snv]] - start[pr[snv]]] = valt[pv[snv]]
    lengths = np.full(len(plain), rl, np.int64)
    qual = np.repeat(_decayed_qual(p, lengths[:1], rl), len(plain), axis=0)
    for a in range(0, len(plain), 8192):
        sl = slice(a, a + 8192)
        _errors(rng, seq[sl], qual[sl], rev[plain[sl]], lengths[sl], p)

    # reads with an indel: explicit CIGARs, built one by one
    ind_reads = np.nonzero(has_indel)[0]
    by_read = {}
    for r, vi in zip(pr[has_indel[pr]].tolist(), pv[has_indel[pr]].tolist()):
        by_read.setdefault(r, []).append(vi)
    ind_seqs, ind_ops, m_max = [], [], 0
    for r in ind_reads.tolist():
        s0, end = int(start[r]), int(start[r]) + rl
        parts, ops, q = [], [], s0
        for vi in sorted(by_read[r], key=lambda i: v["pos"][i]):
            vp, kind = int(v["pos"][vi]), int(v["kind"][vi])
            if vp < q:
                continue
            parts.append(genome[q:vp + 1].copy())
            ops.append((OP_M, vp + 1 - q))
            if kind == KIND_SNV:
                parts[-1][-1] = valt[vi]
                q = vp + 1
            elif kind == KIND_INS:
                k = int(v["ilen"][vi])
                parts.append(v["ins_bases"][vi, :k].copy())
                ops.append((OP_I, k))
                q = vp + 1
            else:
                k = int(v["ilen"][vi])
                ops.append((OP_D, k))
                q = vp + 1 + k
        if q < end:
            parts.append(genome[q:end].copy())
            ops.append((OP_M, end - q))
        merged = []
        for op, n in ops:
            if merged and merged[-1][0] == op:
                merged[-1] = (op, merged[-1][1] + n)
            else:
                merged.append((op, n))
        s = np.concatenate(parts)
        ind_seqs.append(s)
        ind_ops.append(merged)
        m_max = max(m_max, len(s))
    n_ind = len(ind_reads)
    iseq = np.full((n_ind, max(m_max, 1)), 4, np.uint8)      # 4: past the read's end
    ilens = np.array([len(s) for s in ind_seqs], np.int64)
    for i, s in enumerate(ind_seqs):
        iseq[i, :len(s)] = s
    iqual = _decayed_qual(p, np.maximum(ilens, 1), iseq.shape[1])
    if n_ind:
        _errors(rng, iseq, iqual, rev[ind_reads], ilens, p)
    iqual[np.arange(iseq.shape[1])[None, :] >= ilens[:, None]] = 0
    cig_off = np.concatenate([[0], np.cumsum([len(o) for o in ind_ops])]).astype(np.int64)
    cig_op = np.array([o for ops in ind_ops for o, _n in ops], np.int8)
    cig_len = np.array([n for ops in ind_ops for _o, n in ops], np.int64)

    # panel of normals: three quarters of the germline sites, from the seed
    germ = np.nonzero(v["germline"])[0]
    pon = germ[rng.random(len(germ)) < p["pon_keep"]]
    # file order: by start, then by draw
    order = np.lexsort((np.arange(R), start))
    return Genome(params=p, contig=p["contig"], genome=genome,
                  var_pos=v["pos"], var_kind=v["kind"], var_ilen=v["ilen"],
                  var_ref=vref, var_alt=valt, var_ins=v["ins_bases"], var_af=v["af"],
                  var_germline=v["germline"], pon=pon,
                  start=start, rev=rev, order=order,
                  plain=plain, seq=seq, qual=qual,
                  ind_reads=ind_reads, ind_seq=iseq, ind_qual=iqual, ind_len=ilens,
                  cig_off=cig_off, cig_op=cig_op, cig_len=cig_len)


def variant_strings(g, i):
    """(REF, ALT) of variant ``i`` as VCF strings."""
    p, kind, k = int(g.var_pos[i]), int(g.var_kind[i]), int(g.var_ilen[i])
    ref = BASES[g.genome[p:p + 1 + (k if kind == KIND_DEL else 0)]].tobytes().decode()
    if kind == KIND_SNV:
        return ref, chr(BASES[g.var_alt[i]])
    if kind == KIND_INS:
        return ref, ref + BASES[g.var_ins[i, :k]].tobytes().decode()
    return ref, ref[0]


# ---------------------------------------------------------------- writers ---
def _reg2bin(beg, end):
    end = end - 1
    out = np.zeros(len(beg), np.int64)
    done = np.zeros(len(beg), bool)
    for shift, off in ((14, 4681), (17, 585), (20, 73), (23, 9), (26, 1)):
        same = ~done & ((beg >> shift) == (end >> shift))
        out[same] = off + (beg[same] >> shift)
        done |= same
    return out


def _pack_seq(codes, length):
    """4-bit BAM sequence bytes of rows of base codes (length may be odd)."""
    nt = _NT16[codes]
    if nt.shape[1] % 2:
        nt = np.concatenate([nt, np.zeros((nt.shape[0], 1), np.uint8)], axis=1)
    packed = (nt[:, 0::2] << 4) | nt[:, 1::2]
    return packed[:, :(length + 1) // 2]


def _plain_records(g):
    """(n, bytes) records of the reads without an indel, all one size."""
    rl = g.seq.shape[1]
    n = len(g.plain)
    size = 4 + 32 + NAME_LEN + 1 + 4 + (rl + 1) // 2 + rl
    rec = np.zeros((n, size), np.uint8)
    start = g.start[g.plain]
    head = np.zeros(n, dtype=[("bs", "<i4"), ("ref", "<i4"), ("pos", "<i4"), ("lname", "u1"),
                              ("mapq", "u1"), ("bin", "<u2"), ("ncig", "<u2"), ("flag", "<u2"),
                              ("lseq", "<i4"), ("nref", "<i4"), ("npos", "<i4"), ("tlen", "<i4")])
    head["bs"], head["pos"], head["lname"], head["mapq"] = size - 4, start, NAME_LEN + 1, 60
    head["bin"] = _reg2bin(start, start + rl)
    head["ncig"], head["flag"], head["lseq"] = 1, np.where(g.rev[g.plain], 16, 0), rl
    head["nref"], head["npos"] = -1, -1
    rec[:, :36] = head.view(np.uint8).reshape(n, 36)
    rec[:, 36:36 + NAME_LEN] = _names(g.plain)
    o = 36 + NAME_LEN + 1
    rec[:, o:o + 4] = np.array([rl << 4 | OP_M], "<u4").view(np.uint8)
    o += 4
    rec[:, o:o + (rl + 1) // 2] = _pack_seq(g.seq, rl)
    rec[:, o + (rl + 1) // 2:] = g.qual
    return rec


def _names(ridx):
    digits = np.asarray(ridx, np.int64)[:, None] // 10 ** np.arange(NAME_LEN - 2, -1, -1) % 10
    return np.concatenate([np.full((len(ridx), 1), ord("r"), np.uint8),
                           (digits + ord("0")).astype(np.uint8)], axis=1)


def _indel_record(g, i):
    r = int(g.ind_reads[i])
    ops = g.cig_op[g.cig_off[i]:g.cig_off[i + 1]]
    lens = g.cig_len[g.cig_off[i]:g.cig_off[i + 1]]
    ref_len = int(lens[ops != OP_I].sum())
    n = int(g.ind_len[i])
    start = int(g.start[r])
    body = (struct.pack("<iiBBHHHiiii", 0, start, NAME_LEN + 1, 60,
                        int(_reg2bin(np.array([start]), np.array([start + ref_len]))[0]),
                        len(ops), 16 if g.rev[r] else 0, n, -1, -1, 0)
            + _names([r]).tobytes() + b"\0"
            + (lens.astype(np.int64) << 4 | ops).astype("<u4").tobytes()
            + _pack_seq(g.ind_seq[i:i + 1, :n], n).tobytes()
            + g.ind_qual[i, :n].tobytes())
    return struct.pack("<i", len(body)) + body, ref_len


def _bgzf(payload, level=1):
    comp = zlib.compressobj(level, zlib.DEFLATED, -15)
    cdata = comp.compress(payload) + comp.flush()
    return (b"\x1f\x8b\x08\x04\x00\x00\x00\x00\x00\xff\x06\x00BC\x02\x00"
            + struct.pack("<H", len(cdata) + 25) + cdata
            + struct.pack("<II", zlib.crc32(payload) & 0xFFFFFFFF, len(payload)))


def write_bam(g, path, threads=4):
    """``path`` (sorted BAM) and ``path + '.bai'``."""
    L = len(g.genome)
    name = g.contig.encode() + b"\0"
    text = b"@HD\tVN:1.6\tSO:coordinate\n@SQ\tSN:" + g.contig.encode() + b"\tLN:%d\n" % L
    header = (b"BAM\1" + struct.pack("<i", len(text)) + text + struct.pack("<ii", 1, len(name))
              + name + struct.pack("<i", L))
    plain = _plain_records(g)
    size = plain.shape[1]
    rl = g.seq.shape[1]
    R = len(g.start)
    rec_len = np.full(R, size, np.int64)
    ref_end = g.start + rl
    extra = {}
    for i in range(len(g.ind_reads)):
        b, ref_len = _indel_record(g, i)
        r = int(g.ind_reads[i])
        extra[r] = b
        rec_len[r] = len(b)
        ref_end[r] = g.start[r] + ref_len
    order = g.order
    offs = len(header) + np.concatenate([[0], np.cumsum(rec_len[order])])
    buf = np.empty(int(offs[-1]), np.uint8)
    buf[:len(header)] = np.frombuffer(header, np.uint8)
    is_plain = np.zeros(R, bool)
    is_plain[g.plain] = True
    pos_in_plain = np.full(R, -1, np.int64)
    pos_in_plain[g.plain] = np.arange(len(g.plain))
    # runs of reads without an indel lie back to back in the file
    cut = np.nonzero(~is_plain[order])[0]
    for a, z in zip(np.concatenate([[0], cut + 1]), np.concatenate([cut, [R]])):
        if z > a:
            buf[offs[a]:offs[z]] = plain[pos_in_plain[order[a:z]]].reshape(-1)
    for k in cut:
        b = extra[int(order[k])]
        buf[offs[k]:offs[k] + len(b)] = np.frombuffer(b, np.uint8)
    data = buf.tobytes()
    pieces = [data[i:i + BGZF_BLOCK] for i in range(0, len(data), BGZF_BLOCK)]
    with ThreadPoolExecutor(threads) as ex:
        blocks = list(ex.map(_bgzf, pieces))
    with open(path, "wb") as f:
        for b in blocks:
            f.write(b)
        f.write(_EOF)
    coff = np.concatenate([[0], np.cumsum([len(b) for b in blocks])]).astype(np.int64)
    upos = offs  # uncompressed offsets of each record start, and the end

    def voff(u):
        blk = np.minimum(u // BGZF_BLOCK, len(blocks))
        return (coff[blk] << 16) | (u - blk * BGZF_BLOCK)

    vs, ve = voff(upos[:-1]), voff(upos[1:])
    beg, end = g.start[order], ref_end[order]
    bins = _reg2bin(beg, end)
    _write_bai(path + ".bai", bins, vs, ve, beg, end)
    return path


def _write_bai(path, bins, vs, ve, beg, end):
    idx = np.argsort(bins, kind="stable")
    b_sorted = bins[idx]
    brk = np.ones(len(idx), bool)
    brk[1:] = (b_sorted[1:] != b_sorted[:-1]) | (idx[1:] != idx[:-1] + 1)
    starts = np.nonzero(brk)[0]
    ends = np.concatenate([starts[1:], [len(idx)]]) - 1
    chunk_bin = b_sorted[starts]
    chunk_beg, chunk_end = vs[idx[starts]], ve[idx[ends]]
    out = [b"BAI\1", struct.pack("<i", 1)]
    ub, first = np.unique(chunk_bin, return_index=True)
    out.append(struct.pack("<i", len(ub)))
    bounds = np.concatenate([first, [len(chunk_bin)]])
    for j, b in enumerate(ub):
        a, z = bounds[j], bounds[j + 1]
        out.append(struct.pack("<Ii", int(b), int(z - a)))
        out.append(np.stack([chunk_beg[a:z], chunk_end[a:z]], axis=1).astype("<u8").tobytes())
    n_win = int((end.max() - 1) >> 14) + 1 if len(end) else 0
    lin = np.full(n_win, np.iinfo(np.int64).max, np.int64)
    for w_of in (beg >> 14, (end - 1) >> 14):
        np.minimum.at(lin, w_of, vs)
    # a window no read overlaps takes the next one's offset
    for w in range(n_win - 2, -1, -1):
        if lin[w] == np.iinfo(np.int64).max:
            lin[w] = lin[w + 1]
    lin[lin == np.iinfo(np.int64).max] = 0
    out.append(struct.pack("<i", n_win))
    out.append(lin.astype("<u8").tobytes())
    with open(path, "wb") as f:
        f.write(b"".join(out))


def write_fasta(g, path, width=60):
    seq = BASES[g.genome].tobytes()
    with open(path, "wb") as f:
        head = b">" + g.contig.encode() + b"\n"
        f.write(head)
        for i in range(0, len(seq), width):
            f.write(seq[i:i + width] + b"\n")
    with open(path + ".fai", "w") as f:
        f.write(f"{g.contig}\t{len(seq)}\t{len(head)}\t{width}\t{width + 1}\n")
    return path


def write_pon(g, path):
    with open(path, "w") as f:
        f.write("##fileformat=VCFv4.2\n#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\n")
        for i in g.pon.tolist():
            ref, alt = variant_strings(g, i)
            f.write(f"{g.contig}\t{int(g.var_pos[i]) + 1}\t.\t{ref}\t{alt}\t.\t.\t.\n")
    return path


def load_or_make(seed, p, cache_dir):
    """(Genome, {fasta, bam, pon}) of ``seed``.  The arrays are drawn again
    in every process (the same seed gives the same arrays); the files are
    written once into ``cache_dir/<seed>.<key>`` and found there after,
    where the key is a digest of the parameters and of this module's
    source, so a genome of other parameters or another simulator is never
    served from the cache."""
    with open(__file__, "rb") as f:
        digest = hashlib.sha256(f.read() + json.dumps(p, sort_keys=True).encode())
    d = os.path.join(cache_dir, f"{seed}.{digest.hexdigest()[:16]}")
    files = {"fasta": os.path.join(d, "ref.fa"), "bam": os.path.join(d, "tumor.bam"),
             "pon": os.path.join(d, "pon.vcf")}
    g = simulate(seed, p)
    if not os.path.isdir(d):
        # written beside, then renamed into place: a process that finds the
        # directory finds it whole
        tmp = f"{d}.part{os.getpid()}"
        os.makedirs(tmp, exist_ok=True)
        write_fasta(g, os.path.join(tmp, "ref.fa"))
        write_bam(g, os.path.join(tmp, "tumor.bam"))
        write_pon(g, os.path.join(tmp, "pon.vcf"))
        try:
            os.rename(tmp, d)
        except OSError:       # another process put it there first
            shutil.rmtree(tmp, ignore_errors=True)
    return g, files
