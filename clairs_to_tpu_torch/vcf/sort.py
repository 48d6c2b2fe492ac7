# Port copy of clairs_to_tpu/vcf/sort.py.
"""VCF merge/sort + bgzip.

Reference: src/sort_vcf.py:113-222 — concatenate per-chunk VCFs, order
contigs chr1..chrY (with and without 'chr' prefix) before others, sort rows
by position, write bgzip.  BGZF compression comes from bamio.bam_writer
(bgzip == BGZF); tabix indexing is handled by vcf.tabix.
"""

import gzip
import os

from clairs_to_tpu_torch.bamio.bam_writer import bgzf_compress

_MAJOR = [str(i) for i in range(1, 23)] + ["X", "Y"]
_CONTIG_RANK = {}
for i, c in enumerate(_MAJOR):
    _CONTIG_RANK["chr" + c] = i
    _CONTIG_RANK[c] = i


def contig_sort_key(ctg):
    return (_CONTIG_RANK.get(ctg, len(_MAJOR)), ctg)


def sort_rows(rows):
    """rows: list of (ctg, pos, line). Stable sort by contig rank then pos."""
    return sorted(rows, key=lambda r: (contig_sort_key(r[0]), r[1]))


def merge_vcf_files(inputs, output_path, header=None, compress=False):
    """Merge per-chunk VCFs into one sorted VCF (sort_vcf.py semantics).

    The first file's header is used unless ``header`` is given.  Returns the
    number of body rows written.
    """
    body = []
    chosen_header = header
    for path in inputs:
        if not os.path.exists(path):
            continue
        opener = gzip.open if path.endswith(".gz") else open
        with opener(path, "rt") as f:
            this_header = []
            for line in f:
                if line.startswith("#"):
                    this_header.append(line)
                    continue
                cols = line.split("\t", 2)
                if len(cols) < 3:
                    continue
                body.append((cols[0], int(cols[1]), line))
            if chosen_header is None and this_header:
                chosen_header = "".join(this_header)
    body = sort_rows(body)
    text = (chosen_header or "") + "".join(line for _, _, line in body)
    if compress or output_path.endswith(".gz"):
        with open(output_path, "wb") as f:
            f.write(bgzf_compress(text.encode()))
    else:
        with open(output_path, "w") as f:
            f.write(text)
    return len(body)
