# Port copy of clairs_to_tpu/vcf/tabix.py.
"""Tabix (.tbi) indexing and region queries for bgzipped VCFs.

Completes the reference's output contract (bgzip + tabix,
src/sort_vcf.py:44-50, src/postprocess_vcf.py:54-59) and the PoN tabix fast
path (src/nonsomatic_tagging.py:280-307) without the external tabix binary:

* ``BgzfWriter`` — BGZF writer that tracks virtual file offsets
  (coffset<<16 | uoffset) as required by the index;
* ``write_tabix_vcf`` — bgzip a VCF and build its .tbi (binning scheme of
  the SAM/tabix spec: 5-level R-tree bins + 16kb linear index);
* ``TabixReader`` — region queries over a .vcf.gz + .tbi pair.
"""

import gzip
import struct
import zlib
from collections import defaultdict

_BGZF_EOF = bytes.fromhex(
    "1f8b08040000000000ff0600424302001b0003000000000000000000"
)


class BgzfWriter:
    """BGZF writer exposing the virtual offset of the next byte."""

    def __init__(self, fileobj, block_size=0xF000):
        self._fp = fileobj
        self._buf = bytearray()
        self._coffset = 0
        self._block_size = block_size

    @property
    def tell_virtual(self):
        return (self._coffset << 16) | len(self._buf)

    def write(self, data: bytes):
        self._buf += data
        while len(self._buf) >= self._block_size:
            self._flush_block(self._buf[: self._block_size])
            self._buf = self._buf[self._block_size :]

    def _flush_block(self, payload):
        comp = zlib.compressobj(6, zlib.DEFLATED, -15)
        cdata = comp.compress(bytes(payload)) + comp.flush()
        bsize = len(cdata) + 26
        block = (
            b"\x1f\x8b\x08\x04\x00\x00\x00\x00\x00\xff"
            + struct.pack("<H", 6)
            + b"BC"
            + struct.pack("<H", 2)
            + struct.pack("<H", bsize - 1)
            + cdata
            + struct.pack("<II", zlib.crc32(bytes(payload)) & 0xFFFFFFFF, len(payload))
        )
        self._fp.write(block)
        self._coffset += len(block)

    def close(self):
        if self._buf:
            self._flush_block(self._buf)
            self._buf = bytearray()
        self._fp.write(_BGZF_EOF)


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


def _reg2bins(beg, end):
    bins = [0]
    end -= 1
    for shift, off in ((26, 1), (23, 9), (20, 73), (17, 585), (14, 4681)):
        bins.extend(range(off + (beg >> shift), off + (end >> shift) + 1))
    return bins


def write_tabix_vcf(vcf_path, out_path=None):
    """bgzip a plain VCF and write its .tbi; returns (gz_path, tbi_path)."""
    out_path = out_path or vcf_path + ".gz"
    names = []
    name_id = {}
    # per-contig: bins {bin: [(voff_beg, voff_end)]}, linear [voffs per 16kb]
    bins = defaultdict(lambda: defaultdict(list))
    linear = defaultdict(dict)

    with open(vcf_path, "rb") as src, open(out_path, "wb") as dst:
        bw = BgzfWriter(dst)
        for line in src:
            voff_beg = bw.tell_virtual
            bw.write(line)
            if line.startswith(b"#"):
                continue
            cols = line.split(b"\t", 4)
            ctg = cols[0].decode()
            pos1 = int(cols[1])
            ref_len = len(cols[3])
            beg0 = pos1 - 1
            end0 = beg0 + ref_len
            if ctg not in name_id:
                name_id[ctg] = len(names)
                names.append(ctg)
            rid = name_id[ctg]
            b = _reg2bin(beg0, end0)
            voff_end = bw.tell_virtual
            blist = bins[rid][b]
            if blist and blist[-1][1] == voff_beg:
                blist[-1] = (blist[-1][0], voff_end)
            else:
                blist.append((voff_beg, voff_end))
            for win in range(beg0 >> 14, ((end0 - 1) >> 14) + 1):
                if win not in linear[rid]:
                    linear[rid][win] = voff_beg
        bw.close()

    tbi_path = out_path + ".tbi"
    payload = bytearray()
    payload += b"TBI\x01"
    concat_names = b"".join(n.encode() + b"\x00" for n in names)
    # header after magic: n_ref, format=2 (VCF), col_seq=1, col_beg=2,
    # col_end=0 (VCF: END from the record), meta='#', skip=0, l_nm
    payload += struct.pack("<i", len(names))
    payload += struct.pack("<7i", 2, 1, 2, 0, ord("#"), 0, len(concat_names))
    payload += concat_names
    for rid in range(len(names)):
        rid_bins = bins.get(rid, {})
        payload += struct.pack("<i", len(rid_bins))
        for b, chunks in sorted(rid_bins.items()):
            payload += struct.pack("<Ii", b, len(chunks))
            for (u, v) in chunks:
                payload += struct.pack("<QQ", u, v)
        lin = linear.get(rid, {})
        n_win = (max(lin) + 1) if lin else 0
        payload += struct.pack("<i", n_win)
        prev = 0
        for w in range(n_win):
            if w in lin:
                prev = lin[w]
            payload += struct.pack("<Q", prev)
    with open(tbi_path, "wb") as f:
        gz = BgzfWriter(f)
        gz.write(bytes(payload))
        gz.close()
    return out_path, tbi_path


class TabixReader:
    """Region queries over (.vcf.gz, .tbi)."""

    def __init__(self, gz_path, tbi_path=None):
        self.gz_path = gz_path
        tbi_path = tbi_path or gz_path + ".tbi"
        data = gzip.open(tbi_path, "rb").read()
        if data[:4] != b"TBI\x01":
            raise ValueError("not a tabix index")
        off = 4
        (n_ref,) = struct.unpack_from("<i", data, off)
        off += 4
        fmt, col_seq, col_beg, col_end, meta, skip, l_nm = struct.unpack_from(
            "<7i", data, off
        )
        off += 28
        names_blob = data[off : off + l_nm]
        off += l_nm
        self.names = [n.decode() for n in names_blob.split(b"\x00") if n]
        self.name_id = {n: i for i, n in enumerate(self.names)}
        self.bins = []
        self.linear = []
        for _ in range(n_ref):
            (n_bin,) = struct.unpack_from("<i", data, off)
            off += 4
            bmap = {}
            for _ in range(n_bin):
                b, n_chunk = struct.unpack_from("<Ii", data, off)
                off += 8
                chunks = []
                for _ in range(n_chunk):
                    u, v = struct.unpack_from("<QQ", data, off)
                    off += 16
                    chunks.append((u, v))
                bmap[b] = chunks
            (n_intv,) = struct.unpack_from("<i", data, off)
            off += 4
            intv = list(struct.unpack_from(f"<{n_intv}Q", data, off))
            off += 8 * n_intv
            self.bins.append(bmap)
            self.linear.append(intv)
        self._raw = open(gz_path, "rb")

    def _read_from(self, voff):
        """Decompress from a virtual offset, yielding lines."""
        coffset = voff >> 16
        uoffset = voff & 0xFFFF
        self._raw.seek(coffset)
        rest = b""
        first = True
        while True:
            header = self._raw.read(12)
            if len(header) < 12 or header[:2] != b"\x1f\x8b":
                break
            xlen = struct.unpack("<H", header[10:12])[0]
            extra = self._raw.read(xlen)
            bsize = None
            e = 0
            while e + 4 <= len(extra):
                si1, si2 = extra[e], extra[e + 1]
                slen = struct.unpack_from("<H", extra, e + 2)[0]
                if si1 == 66 and si2 == 67:
                    bsize = struct.unpack_from("<H", extra, e + 4)[0] + 1
                e += 4 + slen
            cdata = self._raw.read(bsize - 12 - xlen - 8)
            self._raw.read(8)
            payload = zlib.decompress(cdata, wbits=-15)
            if first:
                payload = payload[uoffset:]
                first = False
            if not payload:
                break
            rest += payload
            *lines, rest = rest.split(b"\n")
            for line in lines:
                yield line
        if rest:
            yield rest

    def fetch(self, ctg, start0, end0):
        """Yield decoded VCF body lines overlapping [start0, end0)."""
        rid = self.name_id.get(ctg)
        if rid is None:
            return
        candidate_chunks = []
        lin = self.linear[rid]
        min_lin = lin[start0 >> 14] if (start0 >> 14) < len(lin) else None
        for b in _reg2bins(start0, end0):
            for (u, v) in self.bins[rid].get(b, []):
                if min_lin is not None and v <= min_lin:
                    continue
                candidate_chunks.append((u, v))
        if not candidate_chunks:
            return
        start_voff = min(u for u, _v in candidate_chunks)
        for line in self._read_from(start_voff):
            if not line or line.startswith(b"#"):
                continue
            cols = line.split(b"\t", 4)
            pos1 = int(cols[1])
            if cols[0].decode() != ctg:
                continue
            if pos1 - 1 >= end0:
                break
            ref_len = len(cols[3])
            if pos1 - 1 + ref_len > start0:
                yield line.decode()
