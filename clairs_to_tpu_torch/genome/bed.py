# Port copy of clairs_to_tpu/genome/bed.py.
"""BED interval sets.

Replaces the reference's vendored intervaltree/sortedcontainers stack
(ClairS-TO shared/interval_tree.py, shared/bed.py, shared/intervaltree/)
with a NumPy sorted-interval representation: intervals are merged once and
membership queries are a binary search — O(log n) per query, vectorizable over
whole position arrays, and ~7.6 kLoC lighter than the vendored tree.
"""

import gzip
from collections import defaultdict

import numpy as np


def _open(path):
    with open(path, "rb") as probe:
        magic = probe.read(2)
    if magic == b"\x1f\x8b":
        return gzip.open(path, "rt")
    return open(path, "r")


class IntervalSet:
    """Merged, sorted half-open intervals [start, end) for one contig."""

    __slots__ = ("starts", "ends")

    def __init__(self, starts, ends):
        starts = np.asarray(starts, dtype=np.int64)
        ends = np.asarray(ends, dtype=np.int64)
        order = np.argsort(starts, kind="stable")
        starts, ends = starts[order], ends[order]
        # merge overlapping/adjacent-overlapping intervals
        merged_starts, merged_ends = [], []
        for s, e in zip(starts, ends):
            if merged_ends and s <= merged_ends[-1]:
                merged_ends[-1] = max(merged_ends[-1], e)
            else:
                merged_starts.append(s)
                merged_ends.append(e)
        self.starts = np.asarray(merged_starts, dtype=np.int64)
        self.ends = np.asarray(merged_ends, dtype=np.int64)

    def __len__(self):
        return len(self.starts)

    def overlaps(self, start, end):
        """Does [start, end) overlap any interval? (interval_tree.py:80-88)."""
        i = np.searchsorted(self.starts, end, side="left")
        if i == 0:
            return False
        return bool(self.ends[i - 1] > start)

    def overlaps_array(self, starts, ends):
        """Vectorized overlap test for arrays of [start, end) queries."""
        starts = np.asarray(starts, dtype=np.int64)
        ends = np.asarray(ends, dtype=np.int64)
        idx = np.searchsorted(self.starts, ends, side="left")
        ok = idx > 0
        prev_end = np.where(ok, self.ends[np.maximum(idx - 1, 0)], 0)
        return ok & (prev_end > starts)

    def span(self):
        if len(self.starts) == 0:
            return (0, 0)
        return int(self.starts[0]), int(self.ends[-1])


class BedTree:
    """Per-contig interval sets loaded from a BED file.

    API mirrors shared/interval_tree.py's bed_tree_from/is_region_in usage:
    empty tree => every region passes (callers check len()==0 themselves).
    """

    def __init__(self):
        self.contigs = {}

    def __len__(self):
        return len(self.contigs)

    def __contains__(self, ctg):
        return ctg in self.contigs

    def is_region_in(self, ctg, start, end=None):
        """0-based [start, end) query; end defaults to start+1."""
        if ctg not in self.contigs:
            return False
        if end is None:
            end = start + 1
        return self.contigs[ctg].overlaps(start, end)

    def region_mask(self, ctg, starts, ends):
        if ctg not in self.contigs:
            return np.zeros(len(starts), dtype=bool)
        return self.contigs[ctg].overlaps_array(starts, ends)


def bed_tree_from(bed_file_path, contig_name=None, bed_ctg_start=None, bed_ctg_end=None, padding=0):
    """Load a BED file into a BedTree (shared/interval_tree.py:8-79 semantics).

    Optionally restrict to one contig and a [bed_ctg_start, bed_ctg_end] range,
    expanding each row by ``padding``.
    """
    tree = BedTree()
    if bed_file_path is None:
        return tree
    raw = defaultdict(lambda: ([], []))
    with _open(bed_file_path) as f:
        for row in f:
            if row.startswith(("#", "track", "browser")) or not row.strip():
                continue
            cols = row.rstrip().split("\t")
            if len(cols) < 3:
                cols = row.rstrip().split()
            ctg = cols[0]
            if contig_name is not None and ctg != contig_name:
                continue
            start, end = int(cols[1]) - padding, int(cols[2]) + padding
            if bed_ctg_start is not None and bed_ctg_end is not None:
                if end < bed_ctg_start or start > bed_ctg_end:
                    continue
            raw[ctg][0].append(start)
            raw[ctg][1].append(end)
    for ctg, (starts, ends) in raw.items():
        tree.contigs[ctg] = IntervalSet(starts, ends)
    return tree


def bed_tree_from_region(ctg_name, start, end):
    """BedTree covering one 0-based [start, end) region.

    The reference materialises ``--region`` as a one-row tmp/region.bed and
    substitutes it for --bed_fn (run_clairs_to:371-397); this builds the
    equivalent tree in memory.
    """
    tree = BedTree()
    tree.contigs[ctg_name] = IntervalSet([start], [end])
    return tree


def is_region_in(tree, contig_name, region_start=None, region_end=None):
    """Compatibility shim for shared/interval_tree.py:80-88."""
    if not isinstance(tree, BedTree):
        return False
    return tree.is_region_in(contig_name, region_start, region_end)
