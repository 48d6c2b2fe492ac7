# Port copy of clairs_to_tpu/genome/fasta.py; fetch reads positionally, so threads may share a FastaFile.
"""FASTA access with .fai indexing.

Replaces the reference's ``samtools faidx`` subprocess
(ClairS-TO shared/utils.py:148-176) with an in-process indexed reader.
Supports writing a .fai for unindexed files (needed because samtools is not a
runtime dependency of this framework).
"""

import os


class FastaIndexEntry:
    __slots__ = ("name", "length", "offset", "line_bases", "line_width")

    def __init__(self, name, length, offset, line_bases, line_width):
        self.name = name
        self.length = length
        self.offset = offset
        self.line_bases = line_bases
        self.line_width = line_width


def build_fai(fasta_path, fai_path=None):
    """Create a samtools-compatible .fai index for a FASTA file."""
    fai_path = fai_path or fasta_path + ".fai"
    entries = []
    with open(fasta_path, "rb") as f:
        name = None
        length = 0
        offset = 0
        line_bases = 0
        line_width = 0
        first_line = True
        while True:
            line_start = f.tell()
            line = f.readline()
            if not line:
                break
            if line.startswith(b">"):
                if name is not None:
                    entries.append((name, length, offset, line_bases, line_width))
                name = line[1:].split()[0].decode()
                length = 0
                offset = f.tell()
                first_line = True
            else:
                stripped = line.rstrip(b"\r\n")
                if first_line:
                    line_bases = len(stripped)
                    line_width = len(line)
                    first_line = False
                length += len(stripped)
        if name is not None:
            entries.append((name, length, offset, line_bases, line_width))
    with open(fai_path, "w") as out:
        for name, length, offset, line_bases, line_width in entries:
            out.write(f"{name}\t{length}\t{offset}\t{line_bases}\t{line_width}\n")
    return fai_path


class FastaFile:
    """Random-access FASTA reader backed by a .fai index."""

    def __init__(self, path, build_index_if_missing=True):
        self.path = path
        fai_path = path + ".fai"
        if not os.path.exists(fai_path):
            if build_index_if_missing:
                build_fai(path, fai_path)
            else:
                raise FileNotFoundError(fai_path)
        self.index = {}
        self.contig_order = []
        with open(fai_path) as f:
            for row in f:
                cols = row.strip().split("\t")
                entry = FastaIndexEntry(
                    cols[0], int(cols[1]), int(cols[2]), int(cols[3]), int(cols[4])
                )
                self.index[entry.name] = entry
                self.contig_order.append(entry.name)
        self._fp = open(path, "rb")

    def close(self):
        self._fp.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def contig_length(self, name):
        return self.index[name].length

    def fetch(self, name, start=None, end=None):
        """Fetch [start, end) 0-based half-open; whole contig if unspecified."""
        entry = self.index[name]
        start = 0 if start is None else max(0, start)
        end = entry.length if end is None else min(end, entry.length)
        if start >= end:
            return ""
        first_line, first_col = divmod(start, entry.line_bases)
        file_start = entry.offset + first_line * entry.line_width + first_col
        # bytes to read: spans (end-start) bases plus interleaved newline bytes
        last_line = (end - 1) // entry.line_bases
        span = (end - start) + (last_line - first_line) * (entry.line_width - entry.line_bases)
        # positional reads: the decode workers of a run fetch through one
        # FastaFile at the same time, and a seek followed by a read on the
        # shared handle would let one thread read from another's offset
        parts, got = [], 0
        while got < span:
            part = os.pread(self._fp.fileno(), span - got, file_start + got)
            if not part:
                break
            parts.append(part)
            got += len(part)
        return b"".join(parts).replace(b"\n", b"").replace(b"\r", b"").decode()

    def fetch_1based(self, name, start_1, end_1):
        """Fetch [start_1, end_1] 1-based inclusive (samtools faidx region)."""
        return self.fetch(name, start_1 - 1, end_1)


def write_fasta(path, contigs):
    """Write {name: sequence} to a FASTA file (60 cols) and index it."""
    with open(path, "w") as f:
        for name, seq in contigs.items():
            f.write(f">{name}\n")
            for i in range(0, len(seq), 60):
                f.write(seq[i : i + 60] + "\n")
    build_fai(path)
    return path
