# Port copy of clairs_to_tpu/bamio/bam.py.
"""BAM/BGZF reading — self-contained, no htslib/samtools dependency.

The reference shells out to ``samtools mpileup`` and parses its text output
(src/extract_candidates_calling.py:308-312, src/create_tensor_pileup_calling.py:442-446).
This framework decodes BAM directly: BGZF blocks are raw-deflate members
(zlib), records follow the SAM spec §4.2.  A linear-index (BAI) reader gives
region random access; without an index we stream and filter.

This module is the *reference implementation* (pure Python + zlib).  The
C++ fast path (clairs_to_tpu/bamio/native) implements the same
``ReadBatch`` contract and is validated against this one.
"""

import struct
import zlib
from dataclasses import dataclass, field
from typing import Iterator, List, Optional

import numpy as np

BAM_MAGIC = b"BAM\x01"
CIGAR_OPS = "MIDNSHP=X"
SEQ_NT16 = "=ACMGRSVTWYHKDBN"

# CIGAR op properties
_CONSUMES_QUERY = np.array([1, 1, 0, 0, 1, 0, 0, 1, 1], dtype=np.int8)  # M I S = X
_CONSUMES_REF = np.array([1, 0, 1, 1, 0, 0, 0, 1, 1], dtype=np.int8)    # M D N = X

FLAG_PAIRED = 0x1
FLAG_UNMAP = 0x4
FLAG_MUNMAP = 0x8
FLAG_REVERSE = 0x10
FLAG_SECONDARY = 0x100
FLAG_QCFAIL = 0x200
FLAG_DUP = 0x400
FLAG_SUPPLEMENTARY = 0x800


def bgzf_decompress(path) -> bytes:
    """Decompress a whole BGZF file to bytes."""
    out = []
    with open(path, "rb") as f:
        data = f.read()
    pos = 0
    n = len(data)
    while pos < n:
        if data[pos : pos + 2] != b"\x1f\x8b":
            raise ValueError(f"bad gzip magic at offset {pos}")
        xlen = struct.unpack_from("<H", data, pos + 10)[0]
        # find BSIZE in extra field
        extra = data[pos + 12 : pos + 12 + xlen]
        bsize = None
        epos = 0
        while epos + 4 <= len(extra):
            si1, si2, slen = extra[epos], extra[epos + 1], struct.unpack_from("<H", extra, epos + 2)[0]
            if si1 == 66 and si2 == 67:  # 'B','C'
                bsize = struct.unpack_from("<H", extra, epos + 4)[0] + 1
                break
            epos += 4 + slen
        if bsize is None:
            # plain gzip member: decompress the rest in one go
            out.append(zlib.decompress(data[pos:], wbits=31))
            break
        cdata = data[pos + 12 + xlen : pos + bsize - 8]
        out.append(zlib.decompress(cdata, wbits=-15))
        pos += bsize
    return b"".join(out)


@dataclass
class BamRead:
    """One decoded alignment record."""

    name: str
    flag: int
    ref_id: int
    pos: int               # 0-based leftmost
    mapq: int
    cigar_ops: np.ndarray  # (n,) int8 indices into CIGAR_OPS
    cigar_lens: np.ndarray # (n,) int32
    seq: str               # ASCII bases
    qual: np.ndarray       # (len,) uint8 phred (0xFF row -> zeros)
    tags: dict = field(default_factory=dict)

    @property
    def is_reverse(self):
        return bool(self.flag & FLAG_REVERSE)

    @property
    def query_length(self):
        return len(self.seq)

    def reference_end(self):
        """0-based exclusive end on the reference."""
        span = int(self.cigar_lens[_CONSUMES_REF[self.cigar_ops] == 1].sum())
        return self.pos + span


def _parse_tags(buf: bytes) -> dict:
    tags = {}
    pos = 0
    n = len(buf)
    while pos + 3 <= n:
        tag = buf[pos : pos + 2].decode()
        typ = chr(buf[pos + 2])
        pos += 3
        if typ == "A":
            tags[tag] = chr(buf[pos]); pos += 1
        elif typ == "c":
            tags[tag] = struct.unpack_from("<b", buf, pos)[0]; pos += 1
        elif typ == "C":
            tags[tag] = buf[pos]; pos += 1
        elif typ == "s":
            tags[tag] = struct.unpack_from("<h", buf, pos)[0]; pos += 2
        elif typ == "S":
            tags[tag] = struct.unpack_from("<H", buf, pos)[0]; pos += 2
        elif typ == "i":
            tags[tag] = struct.unpack_from("<i", buf, pos)[0]; pos += 4
        elif typ == "I":
            tags[tag] = struct.unpack_from("<I", buf, pos)[0]; pos += 4
        elif typ == "f":
            tags[tag] = struct.unpack_from("<f", buf, pos)[0]; pos += 4
        elif typ in "ZH":
            end = buf.index(b"\x00", pos)
            tags[tag] = buf[pos:end].decode()
            pos = end + 1
        elif typ == "B":
            sub = chr(buf[pos]); cnt = struct.unpack_from("<I", buf, pos + 1)[0]
            pos += 5
            size = {"c": 1, "C": 1, "s": 2, "S": 2, "i": 4, "I": 4, "f": 4}[sub]
            fmt = "<" + str(cnt) + sub.lower() if sub != "f" else "<" + str(cnt) + "f"
            # numeric array; store as list
            tags[tag] = list(struct.unpack_from("<%d%s" % (cnt, sub if sub in "fiI" else sub), buf, pos))
            pos += size * cnt
        else:
            break
    return tags


class BamFile:
    """In-memory BAM reader (whole-file decompress; fine for chunked usage).

    For production region access the native reader uses the .bai index; this
    Python reader filters by overlap after decode.
    """

    def __init__(self, path):
        self.path = path
        data = bgzf_decompress(path)
        if data[:4] != BAM_MAGIC:
            raise ValueError("not a BAM file")
        l_text = struct.unpack_from("<i", data, 4)[0]
        self.header_text = data[8 : 8 + l_text].decode(errors="replace")
        pos = 8 + l_text
        n_ref = struct.unpack_from("<i", data, pos)[0]
        pos += 4
        self.references: List[str] = []
        self.lengths: List[int] = []
        for _ in range(n_ref):
            l_name = struct.unpack_from("<i", data, pos)[0]
            name = data[pos + 4 : pos + 4 + l_name - 1].decode()
            l_ref = struct.unpack_from("<i", data, pos + 4 + l_name)[0]
            self.references.append(name)
            self.lengths.append(l_ref)
            pos += 8 + l_name
        self._data = data
        self._records_start = pos

    def ref_id(self, name) -> int:
        return self.references.index(name)

    def __iter__(self) -> Iterator[BamRead]:
        data = self._data
        pos = self._records_start
        n = len(data)
        while pos + 4 <= n:
            block_size = struct.unpack_from("<i", data, pos)[0]
            rec = data[pos + 4 : pos + 4 + block_size]
            pos += 4 + block_size
            yield _decode_record(rec)

    def fetch(
        self,
        ctg: Optional[str] = None,
        start: Optional[int] = None,
        end: Optional[int] = None,
        excl_flags: int = 0,
        min_mapq: int = 0,
    ) -> Iterator[BamRead]:
        """Reads overlapping [start, end) (0-based) on ctg, flag/mapq filtered."""
        rid = self.ref_id(ctg) if ctg is not None else None
        for read in self:
            if read.flag & excl_flags:
                continue
            if read.mapq < min_mapq:
                continue
            if rid is not None and read.ref_id != rid:
                continue
            if start is not None and read.reference_end() <= start:
                continue
            if end is not None and read.pos >= end:
                continue
            yield read


def _decode_record(rec: bytes) -> BamRead:
    (
        ref_id,
        pos,
        l_read_name,
        mapq,
        _bin,
        n_cigar_op,
        flag,
        l_seq,
        _next_ref_id,
        _next_pos,
        _tlen,
    ) = struct.unpack_from("<iiBBHHHiiii", rec, 0)
    off = 32
    name = rec[off : off + l_read_name - 1].decode()
    off += l_read_name
    cigar = np.frombuffer(rec, dtype="<u4", count=n_cigar_op, offset=off)
    cigar_ops = (cigar & 0xF).astype(np.int8)
    cigar_lens = (cigar >> 4).astype(np.int32)
    off += 4 * n_cigar_op
    nbytes = (l_seq + 1) // 2
    seq_packed = np.frombuffer(rec, dtype=np.uint8, count=nbytes, offset=off)
    hi = seq_packed >> 4
    lo = seq_packed & 0xF
    codes = np.empty(nbytes * 2, dtype=np.uint8)
    codes[0::2] = hi
    codes[1::2] = lo
    codes = codes[:l_seq]
    seq = "".join(SEQ_NT16[c] for c in codes)
    off += nbytes
    qual = np.frombuffer(rec, dtype=np.uint8, count=l_seq, offset=off).copy()
    if l_seq and qual[0] == 0xFF:
        qual = np.zeros(l_seq, dtype=np.uint8)
    off += l_seq
    tags = _parse_tags(rec[off:])
    return BamRead(
        name=name,
        flag=flag,
        ref_id=ref_id,
        pos=pos,
        mapq=mapq,
        cigar_ops=cigar_ops,
        cigar_lens=cigar_lens,
        seq=seq,
        qual=qual,
        tags=tags,
    )
