# Port copy of clairs_to_tpu/bamio/bam_writer.py.
"""BAM/BGZF writing — used by the simulator, tests, and realignment output.

Produces spec-conformant BAM files (BGZF blocks + EOF marker) readable by any
htslib tool and by bamio.bam.BamFile.
"""

import struct
import zlib

import numpy as np

from clairs_to_tpu_torch.bamio.bam import BAM_MAGIC, CIGAR_OPS

_BGZF_EOF = bytes.fromhex(
    "1f8b08040000000000ff0600424302001b0003000000000000000000"
)

_NT16_INDEX = {c: i for i, c in enumerate("=ACMGRSVTWYHKDBN")}


def _bgzf_block(payload: bytes) -> bytes:
    comp = zlib.compressobj(6, zlib.DEFLATED, -15)
    cdata = comp.compress(payload) + comp.flush()
    bsize = len(cdata) + 25 + 1
    header = (
        b"\x1f\x8b\x08\x04\x00\x00\x00\x00\x00\xff"
        + struct.pack("<H", 6)
        + b"BC"
        + struct.pack("<H", 2)
        + struct.pack("<H", bsize - 1)
    )
    footer = struct.pack("<II", zlib.crc32(payload) & 0xFFFFFFFF, len(payload))
    return header + cdata + footer


def bgzf_compress(data: bytes, block_size: int = 60000) -> bytes:
    out = []
    for i in range(0, len(data), block_size):
        out.append(_bgzf_block(data[i : i + block_size]))
    out.append(_BGZF_EOF)
    return b"".join(out)


def encode_record(
    name: str,
    flag: int,
    ref_id: int,
    pos: int,
    mapq: int,
    cigar,               # list of (op_char, length)
    seq: str,
    qual,                # iterable of phred ints
    next_ref_id: int = -1,
    next_pos: int = -1,
    tlen: int = 0,
    tags: bytes = b"",
) -> bytes:
    l_seq = len(seq)
    cigar_u32 = b"".join(
        struct.pack("<I", (length << 4) | CIGAR_OPS.index(op)) for op, length in cigar
    )
    packed = bytearray((l_seq + 1) // 2)
    for i, base in enumerate(seq):
        code = _NT16_INDEX.get(base.upper(), 15)
        if i % 2 == 0:
            packed[i // 2] |= code << 4
        else:
            packed[i // 2] |= code
    qual_b = bytes(qual) if l_seq else b""
    # bin: legacy reg2bin, unused by our reader; compute per spec
    end = pos
    for op, length in cigar:
        if op in "MDN=X":
            end += length
    end = max(end, pos + 1)
    bin_ = _reg2bin(pos, end)
    body = (
        struct.pack(
            "<iiBBHHHiiii",
            ref_id,
            pos,
            len(name) + 1,
            mapq,
            bin_,
            len(cigar),
            flag,
            l_seq,
            next_ref_id,
            next_pos,
            tlen,
        )
        + name.encode()
        + b"\x00"
        + cigar_u32
        + bytes(packed)
        + qual_b
        + tags
    )
    return struct.pack("<i", len(body)) + body


def _reg2bin(beg, end):
    end -= 1
    if beg >> 14 == end >> 14:
        return ((1 << 15) - 1) // 7 + (beg >> 14)
    if beg >> 17 == end >> 17:
        return ((1 << 12) - 1) // 7 + (beg >> 17)
    if beg >> 20 == end >> 20:
        return ((1 << 9) - 1) // 7 + (beg >> 20)
    if beg >> 23 == end >> 23:
        return ((1 << 6) - 1) // 7 + (beg >> 23)
    if beg >> 26 == end >> 26:
        return ((1 << 3) - 1) // 7 + (beg >> 26)
    return 0


def write_bam(path, references, lengths, records, header_text=None,
              write_index=True):
    """Write a BAM file (+ .bai index by default).

    records: iterable of encoded record bytes (see encode_record) — must be
    coordinate-sorted by the caller for region access to work.
    """
    from clairs_to_tpu_torch.vcf.tabix import BgzfWriter

    if header_text is None:
        header_text = "@HD\tVN:1.6\tSO:coordinate\n" + "".join(
            f"@SQ\tSN:{r}\tLN:{l}\n" for r, l in zip(references, lengths)
        )
    htext = header_text.encode()
    head = bytearray()
    head += BAM_MAGIC
    head += struct.pack("<i", len(htext))
    head += htext
    head += struct.pack("<i", len(references))
    for r, l in zip(references, lengths):
        head += struct.pack("<i", len(r) + 1)
        head += r.encode() + b"\x00"
        head += struct.pack("<i", l)

    index_entries = []  # (ref_id, beg0, end0, voff_beg, voff_end)
    with open(path, "wb") as f:
        bw = BgzfWriter(f)
        bw.write(bytes(head))
        for rec in records:
            voff_beg = bw.tell_virtual
            bw.write(rec)
            voff_end = bw.tell_virtual
            if write_index:
                ref_id, pos = struct.unpack_from("<ii", rec, 4)
                n_cigar = struct.unpack_from("<H", rec, 16)[0]
                l_read_name = rec[12]
                span = 0
                for k in range(n_cigar):
                    c = struct.unpack_from("<I", rec, 36 + l_read_name + 4 * k)[0]
                    if CIGAR_OPS[c & 0xF] in "MDN=X":
                        span += c >> 4
                index_entries.append(
                    (ref_id, pos, pos + max(span, 1), voff_beg, voff_end)
                )
        bw.close()
    if write_index:
        write_bai(path + ".bai", len(references), index_entries)
    return path


def write_bai(bai_path, n_ref, entries):
    """Write a BAI index from (ref_id, beg0, end0, voff_beg, voff_end) rows."""
    from collections import defaultdict

    from clairs_to_tpu_torch.vcf.tabix import _reg2bin

    bins = defaultdict(lambda: defaultdict(list))
    linear = defaultdict(dict)
    for (rid, beg, end, u, v) in entries:
        if rid < 0:
            continue
        b = _reg2bin(beg, end)
        blist = bins[rid][b]
        if blist and blist[-1][1] == u:
            blist[-1] = (blist[-1][0], v)
        else:
            blist.append((u, v))
        for win in range(beg >> 14, ((end - 1) >> 14) + 1):
            if win not in linear[rid]:
                linear[rid][win] = u
    out = bytearray(b"BAI\x01")
    out += struct.pack("<i", n_ref)
    for rid in range(n_ref):
        rbins = bins.get(rid, {})
        out += struct.pack("<i", len(rbins))
        for b, chunks in sorted(rbins.items()):
            out += struct.pack("<Ii", b, len(chunks))
            for (u, v) in chunks:
                out += struct.pack("<QQ", u, v)
        lin = linear.get(rid, {})
        n_win = (max(lin) + 1) if lin else 0
        out += struct.pack("<i", n_win)
        prev = 0
        for w in range(n_win):
            if w in lin:
                prev = lin[w]
            out += struct.pack("<Q", prev)
    with open(bai_path, "wb") as f:
        f.write(bytes(out))
    return bai_path


def encode_tag_str(tag: str, value: str) -> bytes:
    return tag.encode() + b"Z" + value.encode() + b"\x00"


def encode_tag_int(tag: str, value: int) -> bytes:
    return tag.encode() + b"i" + struct.pack("<i", value)
