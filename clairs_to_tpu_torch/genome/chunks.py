# Port copy of clairs_to_tpu/genome/chunks.py.
"""Contig → chunk planning.

Reference behavior: run_clairs_to:387-563 (contig intersection + CHUNK_LIST)
and the per-module chunk arithmetic in src/extract_candidates_calling.py:241-269.
Here the plan is an in-memory work queue (the GNU-parallel layer of the
reference becomes an in-process scheduler feeding the device mesh).
"""

from dataclasses import dataclass
from typing import List, Optional

MAJOR_CONTIGS = (
    [f"chr{i}" for i in list(range(1, 23)) + ["X", "Y"]]
    + [str(i) for i in list(range(1, 23)) + ["X", "Y"]]
)


@dataclass(frozen=True)
class Chunk:
    ctg_name: str
    chunk_id: int        # 0-based
    chunk_num: int
    ctg_start: int       # 0-based inclusive
    ctg_end: int         # 0-based exclusive

    @property
    def region(self):
        return f"{self.ctg_name}:{self.ctg_start}-{self.ctg_end}"


def chunk_contig(ctg_name: str, contig_length: int, chunk_size: int) -> List[Chunk]:
    """Split one contig into chunks, matching the reference's arithmetic:

    chunk_num = length // size + (1 if remainder else 0)   (run_clairs_to:553-561)
    per-chunk span recomputed as in extract_candidates_calling.py:258-269:
    chunk_size' = ceil-ish split, ctg_start = chunk_size' * chunk_id (1-based).
    """
    if contig_length <= 0:
        return []
    chunk_num = contig_length // chunk_size + (1 if contig_length % chunk_size else 0)
    per = contig_length // chunk_num + (1 if contig_length % chunk_num else 0)
    chunks = []
    for cid in range(chunk_num):
        start = per * cid
        end = min(start + per, contig_length)
        chunks.append(Chunk(ctg_name, cid, chunk_num, start, end))
    return chunks


def plan_chunks(
    fasta,
    ctg_names: Optional[List[str]] = None,
    chunk_size: int = 5_000_000,
    include_all_ctgs: bool = False,
    chunk_num: Optional[int] = None,
) -> List[Chunk]:
    """Build the full chunk work list from a FastaFile.

    By default restricts to the major human contigs (run_clairs_to:387-470);
    ``include_all_ctgs`` lifts that.  ``chunk_num`` forces that many chunks
    per contig instead of fixed-size chunks (run_clairs_to:557).
    """
    if ctg_names is None:
        ctg_names = [
            c
            for c in fasta.contig_order
            if include_all_ctgs or c in MAJOR_CONTIGS
        ]
        if not ctg_names:  # non-human reference (e.g. tests): take everything
            ctg_names = list(fasta.contig_order)
    plan = []
    for ctg in ctg_names:
        length = fasta.contig_length(ctg)
        size = chunk_size
        if chunk_num is not None and chunk_num > 0:
            size = max((length + chunk_num - 1) // chunk_num, 1)
        plan.extend(chunk_contig(ctg, length, size))
    return plan
