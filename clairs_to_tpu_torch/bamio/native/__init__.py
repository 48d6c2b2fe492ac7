# Port copy of clairs_to_tpu/bamio/native/__init__.py.
"""ctypes binding for the native BAM -> entry-table decoder.

Builds the .so on first use if missing (g++ + zlib are baked into the
image); falls back cleanly when compilation is impossible so the pure-Python
path (bamio/bam.py + PileupEngine.add_read) keeps everything working.
"""

import ctypes
import os
import subprocess
import threading

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_SO = os.path.join(_DIR, "libpileup_native.so")
_SRC = os.path.join(_DIR, "pileup_native.cpp")

_lib = None
_load_error = None
_lock = threading.Lock()

# extended span margin for the filter-view dense stats: verdict windows
# reach at most FLANKING (100) bp past the chunk region edge
FILT_MARGIN = 128


def _build():
    # to a name of this process's own, then renamed: two ranks of one run may
    # build at the same time, and neither may load a half-written library
    tmp = f"{_SO}.{os.getpid()}.tmp"
    cmd = [
        "g++", "-O3", "-std=c++17", "-shared", "-fPIC",
        "-o", tmp, _SRC, "-lz",
    ]
    subprocess.run(cmd, check=True, capture_output=True)
    os.replace(tmp, _SO)


def get_lib():
    # decode workers reach this at the same time: one builds and loads, the
    # others wait for it
    with _lock:
        return _get_lib_locked()


def _get_lib_locked():
    global _lib, _load_error
    if _lib is not None or _load_error is not None:
        return _lib
    try:
        if not os.path.exists(_SO) or os.path.getmtime(_SO) < os.path.getmtime(_SRC):
            _build()
        lib = ctypes.CDLL(_SO)
        lib.pileup_load.restype = ctypes.c_void_p
        lib.pileup_load.argtypes = [
            ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ]
        lib.pileup_n_entries.restype = ctypes.c_int64
        lib.pileup_n_entries.argtypes = [ctypes.c_void_p]
        lib.pileup_n_reads.restype = ctypes.c_int64
        lib.pileup_n_reads.argtypes = [ctypes.c_void_p]
        lib.pileup_iseq_blob_len.restype = ctypes.c_int64
        lib.pileup_iseq_blob_len.argtypes = [ctypes.c_void_p]
        lib.pileup_export.restype = None
        lib.pileup_export.argtypes = [ctypes.c_void_p] + [ctypes.c_void_p] * 11
        lib.pileup_free.restype = None
        lib.pileup_free.argtypes = [ctypes.c_void_p]
        lib.pileup_open_stream.restype = ctypes.c_void_p
        lib.pileup_open_stream.argtypes = [ctypes.c_char_p]
        lib.pileup_close_stream.restype = None
        lib.pileup_close_stream.argtypes = [ctypes.c_void_p]
        lib.pileup_stream_window.restype = ctypes.c_void_p
        lib.pileup_stream_window.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ]
        lib.pileup_stream_window_begin.restype = ctypes.c_void_p
        lib.pileup_stream_window_begin.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_void_p,
        ]
        lib.pileup_stream_window_fill.restype = ctypes.c_int64
        lib.pileup_stream_window_fill.argtypes = [
            ctypes.c_void_p] + [ctypes.c_void_p] * 13
        lib.pileup_stream_window_abort.restype = None
        lib.pileup_stream_window_abort.argtypes = [ctypes.c_void_p]
        lib.entry_channel_counts.restype = None
        lib.entry_channel_counts.argtypes = [
            ctypes.c_int64] + [ctypes.c_void_p] * 9 + [
            ctypes.c_int, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_void_p,
        ]
        lib.entry_candidate_prefilter.restype = None
        lib.entry_candidate_prefilter.argtypes = [
            ctypes.c_int64] + [ctypes.c_void_p] * 5 + [
            ctypes.c_int, ctypes.c_int, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_int, ctypes.c_double, ctypes.c_double,
            ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ]
        lib.entry_group_count.restype = None
        lib.entry_group_count.argtypes = [
            ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_void_p,
        ]
        lib.entry_group_fill.restype = None
        lib.entry_group_fill.argtypes = [
            ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ]
        lib.entry_alt_aggregate.restype = ctypes.c_int64
        lib.entry_alt_aggregate.argtypes = [
            ctypes.c_int64] + [ctypes.c_void_p] * 8 + [
            ctypes.c_int64, ctypes.c_void_p,
            ctypes.c_int, ctypes.c_int,
            ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_void_p,
        ]
        lib.window_candidate_prefilter.restype = None
        lib.window_candidate_prefilter.argtypes = [
            ctypes.c_int64] + [ctypes.c_void_p] * 5 + [
            ctypes.c_int, ctypes.c_double, ctypes.c_double,
            ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ]
        lib.entry_candidate_gate.restype = None
        lib.entry_candidate_gate.argtypes = [
            ctypes.c_int64] + [ctypes.c_void_p] * 8 + [
            ctypes.c_int64, ctypes.c_void_p,
            ctypes.c_int, ctypes.c_int,
            ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int, ctypes.c_double, ctypes.c_double, ctypes.c_int,
            ctypes.c_int, ctypes.c_void_p,
        ]
        lib.entry_alt_info.restype = ctypes.c_int64
        lib.entry_alt_info.argtypes = [
            ctypes.c_int64] + [ctypes.c_void_p] * 8 + [
            ctypes.c_int64, ctypes.c_void_p,
            ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
        ]
        lib.entry_filter_stats.restype = None
        lib.entry_filter_stats.argtypes = (
            [ctypes.c_int64, ctypes.c_int64] + [ctypes.c_void_p] * 8
            + [ctypes.c_int64, ctypes.c_int64, ctypes.c_int16,
               ctypes.c_int16, ctypes.c_int32, ctypes.c_void_p]
            + [ctypes.c_void_p] * 9
        )
        lib.entry_filter_extract.restype = None
        lib.entry_filter_extract.argtypes = (
            [ctypes.c_int64, ctypes.c_int64] + [ctypes.c_void_p] * 8
            + [ctypes.c_int64, ctypes.c_int64, ctypes.c_int16,
               ctypes.c_int16, ctypes.c_void_p]
            + [ctypes.c_void_p] * 13
        )
        lib.ref_negate_channels.restype = None
        lib.ref_negate_channels.argtypes = [
            ctypes.c_int64, ctypes.c_int32, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_int32, ctypes.c_void_p,
        ]
        lib.pileup_window_reduce.restype = ctypes.c_void_p
        lib.pileup_window_reduce.argtypes = (
            [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64]
            + [ctypes.c_int] * 10
            + [ctypes.c_void_p] * 8
            + [ctypes.c_int64, ctypes.c_void_p, ctypes.c_int, ctypes.c_int]
            + [ctypes.c_void_p] * 4
        )
        lib.pileup_window_filter_assemble.restype = None
        lib.pileup_window_filter_assemble.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p]
        lib.pileup_window_filter_export_assembled.restype = None
        lib.pileup_window_filter_export_assembled.argtypes = \
            [ctypes.c_void_p] + [ctypes.c_void_p] * 8
        lib.pileup_window_filter_sizes.restype = None
        lib.pileup_window_filter_sizes.argtypes = [ctypes.c_void_p] + \
            [ctypes.c_void_p] * 3
        lib.pileup_window_filter_export.restype = None
        lib.pileup_window_filter_export.argtypes = [ctypes.c_void_p] + \
            [ctypes.c_void_p] * 10
        lib.pileup_window_filter_export_startend.restype = None
        lib.pileup_window_filter_export_startend.argtypes = \
            [ctypes.c_void_p] + [ctypes.c_void_p] * 4
        lib.pileup_window_entries_count.restype = None
        lib.pileup_window_entries_count.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_void_p,
        ]
        lib.pileup_window_entries_fill.restype = ctypes.c_int64
        lib.pileup_window_entries_fill.argtypes = (
            [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64]
            + [ctypes.c_void_p] * 13
        )
        lib.pileup_window_release.restype = None
        lib.pileup_window_release.argtypes = [ctypes.c_void_p]
        lib.pileup_window_reads_select.restype = ctypes.c_int64
        lib.pileup_window_reads_select.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int]
        lib.pileup_window_reads_sizes.restype = None
        lib.pileup_window_reads_sizes.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
        lib.pileup_window_reads_export.restype = None
        lib.pileup_window_reads_export.argtypes = \
            [ctypes.c_void_p] + [ctypes.c_void_p] * 7
        _lib = lib
    except Exception as e:  # pragma: no cover
        _load_error = e
    return _lib


def available() -> bool:
    return get_lib() is not None


def huge_empty(n, dtype):
    """np.empty whose first touch uses transparent hugepages.

    This VM faults 4 KB pages at ~250 MB/s while MADV_HUGEPAGE first-touch
    runs ~7x faster — decisive for the multi-GB entry-table arenas and
    filter-index buffers.  The anonymous mmap is owned by the returned
    array (numpy keeps the mmap object alive via .base; unmapped on GC)."""
    import mmap as _mmap

    dtype = np.dtype(dtype)
    size = int(n) * dtype.itemsize
    if size < (1 << 21):
        return np.empty(n, dtype)
    mm = _mmap.mmap(-1, size)
    try:
        mm.madvise(_mmap.MADV_HUGEPAGE)
    except (AttributeError, OSError, ValueError):
        pass
    return np.frombuffer(mm, dtype=dtype, count=int(n))


def group_entries_at(pos_arr, want_sorted):
    """Entry indices grouped by wanted position, preserving entry order.

    Returns {pos: int64 index array}; the single O(n) C++ pass replaces
    per-call full-table scans (alt_info_at / find_candidates exact stage).
    Falls back to numpy when the native lib is unavailable.
    """
    want = np.asarray(want_sorted, dtype=np.int64)
    n = len(pos_arr)
    if len(want) == 0 or n == 0:
        return {int(p): np.empty(0, np.int64) for p in want}
    lib = get_lib()
    pos_arr = np.ascontiguousarray(pos_arr, dtype=np.int64)
    if lib is not None:
        counts = np.empty(len(want), np.int64)
        ptr = lambda x: x.ctypes.data_as(ctypes.c_void_p)  # noqa: E731
        lib.entry_group_count(n, ptr(pos_arr), len(want), ptr(want), ptr(counts))
        offsets = np.zeros(len(want), np.int64)
        np.cumsum(counts[:-1], out=offsets[1:])
        out_idx = np.empty(int(counts.sum()), np.int64)
        lib.entry_group_fill(n, ptr(pos_arr), len(want), ptr(want),
                             ptr(offsets), ptr(out_idx))
        return {
            int(p): out_idx[offsets[k] : offsets[k] + counts[k]]
            for k, p in enumerate(want)
        }
    pp = np.searchsorted(want, pos_arr)
    hit = (pp < len(want)) & (want[np.minimum(pp, len(want) - 1)] == pos_arr)
    hit_idx = np.nonzero(hit)[0]
    order = np.argsort(pos_arr[hit_idx], kind="stable")
    hit_idx = hit_idx[order]
    groups = {int(p): [] for p in want}
    bounds = np.searchsorted(pos_arr[hit_idx], want)
    bounds = np.append(bounds, len(hit_idx))
    for k, p in enumerate(want):
        groups[int(p)] = hit_idx[bounds[k] : bounds[k + 1]]
    return groups


def alt_aggregate(arrays, iseq_off, iseq_blob, want_sorted, min_bq, min_mq,
                  ref_seq, ref_start):
    """Distinct entry keys + counts per wanted position (order preserved).

    Returns {pos: [(entry_string, count), ...]} with keys in first-encounter
    (mpileup column) order, or None when the native lib is unavailable —
    callers fall back to the per-entry Python loop.
    """
    lib = get_lib()
    if lib is None or iseq_off is None:
        return None
    want = np.ascontiguousarray(want_sorted, dtype=np.int64)
    npos = len(want)
    if npos == 0:
        return {}
    pos_arr = np.ascontiguousarray(arrays["pos"], np.int64)
    n = len(pos_arr)
    code = np.ascontiguousarray(arrays["code"], np.int8)
    bq = np.ascontiguousarray(arrays["bq"], np.int16)
    mq = np.ascontiguousarray(arrays["mq"], np.int16)
    ikind = np.ascontiguousarray(arrays["ikind"], np.int8)
    ilen = np.ascontiguousarray(arrays["ilen"], np.int32)
    iseq_off = np.ascontiguousarray(iseq_off, np.int64)
    blob = np.ascontiguousarray(iseq_blob, np.uint8)
    ref_bytes = ref_seq.encode("ascii", "replace")

    ptr = lambda x: x.ctypes.data_as(ctypes.c_void_p)  # noqa: E731
    keys_cap = npos * 12 + 64
    blob_cap = keys_cap * 8
    for _attempt in range(2):
        out_nkeys = np.empty(npos, np.int32)
        out_counts = np.empty(keys_cap, np.int32)
        out_key_len = np.empty(keys_cap, np.int32)
        key_blob = np.empty(blob_cap, np.uint8)
        needed_keys = ctypes.c_int64(0)
        needed_blob = ctypes.c_int64(0)
        rc = lib.entry_alt_aggregate(
            n, ptr(pos_arr), ptr(code), ptr(bq), ptr(mq), ptr(ikind),
            ptr(ilen), ptr(iseq_off), ptr(blob),
            npos, ptr(want), int(min_bq), int(min_mq),
            ref_bytes, len(ref_bytes), int(ref_start),
            ptr(out_nkeys), ptr(out_counts), ptr(out_key_len),
            ptr(key_blob), keys_cap, blob_cap,
            ctypes.byref(needed_keys), ctypes.byref(needed_blob),
        )
        if rc >= 0:
            break
        keys_cap = int(needed_keys.value) + 16
        blob_cap = int(needed_blob.value) + 16
    else:  # pragma: no cover - two attempts always suffice
        raise RuntimeError("entry_alt_aggregate capacity retry failed")

    total = int(rc)
    raw = key_blob.tobytes()
    out = {}
    ki = 0
    boff = 0
    for k in range(npos):
        nk = int(out_nkeys[k])
        items = []
        for _ in range(nk):
            ln = int(out_key_len[ki])
            items.append((raw[boff : boff + ln].decode("latin-1"),
                          int(out_counts[ki])))
            ki += 1
            boff += ln
        out[int(want[k])] = items
    assert ki == total
    return out


def _agg_inputs(arrays, iseq_off, iseq_blob):
    c = lambda a, d: np.ascontiguousarray(a, d)  # noqa: E731
    return (
        c(arrays["pos"], np.int64), c(arrays["code"], np.int8),
        c(arrays["bq"], np.int16), c(arrays["mq"], np.int16),
        c(arrays["ikind"], np.int8), c(arrays["ilen"], np.int32),
        c(iseq_off, np.int64), c(iseq_blob, np.uint8),
    )


def candidate_gate(arrays, iseq_off, iseq_blob, want_sorted, min_bq, min_mq,
                   ref_seq, ref_start, min_coverage, snv_min_af,
                   indel_min_af, support, select_indel):
    """Exact candidate gating per wanted position (C++ fast path).

    Returns uint8 flags per position (bit0 SNV candidate, bit1 indel
    candidate) — the decision bits of find_candidates' Python fold — or
    None when the native lib is unavailable."""
    lib = get_lib()
    if lib is None or iseq_off is None:
        return None
    want = np.ascontiguousarray(want_sorted, np.int64)
    if len(want) == 0:
        return np.zeros(0, np.uint8)
    pos_arr, code, bq, mq, ikind, ilen, iseq_off, blob = _agg_inputs(
        arrays, iseq_off, iseq_blob)
    ref_bytes = ref_seq.encode("ascii", "replace")
    out = np.zeros(len(want), np.uint8)
    ptr = lambda x: x.ctypes.data_as(ctypes.c_void_p)  # noqa: E731
    lib.entry_candidate_gate(
        len(pos_arr), ptr(pos_arr), ptr(code), ptr(bq), ptr(mq), ptr(ikind),
        ptr(ilen), ptr(iseq_off), ptr(blob),
        len(want), ptr(want), int(min_bq), int(min_mq),
        ref_bytes, len(ref_bytes), int(ref_start),
        int(min_coverage), float(snv_min_af), float(indel_min_af),
        int(support), 1 if select_indel else 0, ptr(out),
    )
    return out


def alt_info(arrays, iseq_off, iseq_blob, want_sorted, min_bq, min_mq,
             max_indel_len, ref_seq, ref_start):
    """alt_info strings per wanted position (C++ fast path).

    Returns {pos: (alt_info_string, depth)} byte-identical to
    pileup.PileupEngine.alt_info_at's fold, or None when the native lib is
    unavailable."""
    lib = get_lib()
    if lib is None or iseq_off is None:
        return None
    want = np.ascontiguousarray(want_sorted, np.int64)
    npos = len(want)
    if npos == 0:
        return {}
    pos_arr, code, bq, mq, ikind, ilen, iseq_off, blob = _agg_inputs(
        arrays, iseq_off, iseq_blob)
    ref_bytes = ref_seq.encode("ascii", "replace")
    ptr = lambda x: x.ctypes.data_as(ctypes.c_void_p)  # noqa: E731
    blob_cap = npos * 48 + 256
    for _attempt in range(2):
        out_depth = np.empty(npos, np.int32)
        out_len = np.empty(npos, np.int32)
        str_blob = np.empty(blob_cap, np.uint8)
        needed = ctypes.c_int64(0)
        rc = lib.entry_alt_info(
            len(pos_arr), ptr(pos_arr), ptr(code), ptr(bq), ptr(mq),
            ptr(ikind), ptr(ilen), ptr(iseq_off), ptr(blob),
            npos, ptr(want), int(min_bq), int(min_mq), int(max_indel_len),
            ref_bytes, len(ref_bytes), int(ref_start),
            ptr(out_depth), ptr(out_len), ptr(str_blob), blob_cap,
            ctypes.byref(needed),
        )
        if rc >= 0:
            break
        blob_cap = int(needed.value) + 16
    else:  # pragma: no cover - two attempts always suffice
        raise RuntimeError("entry_alt_info capacity retry failed")
    raw = str_blob.tobytes()
    out = {}
    boff = 0
    for k in range(npos):
        ln = int(out_len[k])
        out[int(want[k])] = (raw[boff:boff + ln].decode("latin-1"),
                             int(out_depth[k]))
        boff += ln
    return out


class LazyIseq:
    """Insertion-sequence accessor over the packed blob — avoids building
    millions of (mostly empty) Python strings at decode time."""

    __slots__ = ("_blob", "_off", "_len", "_kind")

    def __init__(self, blob, off, ilen, ikind):
        self._blob = blob
        self._off = off
        self._len = ilen
        self._kind = ikind

    def __len__(self):
        return len(self._off)

    def __getitem__(self, i):
        if self._kind[i] != 1 or self._off[i] < 0:
            return ""
        o = int(self._off[i])
        return self._blob[o : o + int(self._len[i])].tobytes().decode("latin-1")

    def __iter__(self):
        for i in range(len(self._off)):
            yield self[i]


class BamStreamReader:
    """Persistent sequential-window decoder over a coordinate-sorted BAM.

    Visits windows in non-decreasing (contig, start) order; each BAM record
    is BGZF-inflated and parsed exactly once, with reads spanning window
    boundaries replayed from an in-memory buffer.  Falls back to a fresh
    whole-file pass (pileup_load) when a window regresses.
    """

    def __init__(self, bam_path):
        self.bam_path = bam_path
        lib = get_lib()
        self._h = lib.pileup_open_stream(bam_path.encode()) if lib else None
        self._last = None
        self._pool = []   # recycled arenas (dicts of base arrays)
        self._flat_pool = []  # recycled flat int32 dense-count arenas

    # pooled arenas are capped by total bytes so deep-coverage windows
    # (5Mb @ 60x ~ 9.6GB/arena) cannot accumulate
    POOL_MAX_BYTES = 24 << 30

    def _pool_bytes(self):
        return sum(
            sum(a.nbytes for a in arena.values()) for arena in self._pool
        )

    def recycle(self, table):
        """Return a table's backing arrays for reuse by a later window.

        Only call once no views into the table remain (the pipeline calls
        this from evict_views).  Reuse avoids re-faulting ~2GB of fresh pages
        per window, which dominates decode cost on this host.
        """
        arena = table.get("_arena")
        if arena is None or len(self._pool) >= 4:
            return
        arena_bytes = sum(a.nbytes for a in arena.values())
        if self._pool_bytes() + arena_bytes <= self.POOL_MAX_BYTES:
            self._pool.append(arena)

    def _recycle_flat(self, arena):
        if self._h is None:
            return  # closed stream: let the arena free instead of pinning it
        if len(self._flat_pool) < 3:
            self._flat_pool.append(arena)

    def load_window_reduced(self, ctg, start, end, excl_flags=2316,
                            min_mapq=0, handle_overlaps=True, aff_min_bq=0,
                            low_mq_thresh=20, low_bq_thresh=10,
                            max_indel_length=60, with_phasing=False,
                            cand_min_mq=20, filter_view=None):
        """Fused decode+reduce for a window -> NativeWindow (or None).

        Requires non-decreasing window order like load_window; regressing
        windows and missing native lib return None (callers fall back to
        the entry-table path).  The dense int32 outputs live in one flat
        pooled hugepage arena — re-used across windows, so the multi-GB
        first-touch cost (the round-3 wall) is paid once per run."""
        lib = get_lib()
        if lib is None or self._h is None:
            return None
        key = (ctg, int(start))
        if (self._last is not None and self._last[0] == ctg
                and key[1] < self._last[1]):
            return None  # regressed window: stream cannot rewind
        L = int(end) - int(start)
        nchan = 34 + (16 if with_phasing else 0)
        dual = 1 if aff_min_bq > 0 else 0
        FL = L + 2 * FILT_MARGIN
        # dual worst-case + the 3 filter-view dense arrays so pooling is
        # uniform regardless of per-window options
        need = L * (2 * nchan + 9) + 3 * FL
        arena = None
        for k, cand in enumerate(self._flat_pool):
            if len(cand) >= need:
                arena = self._flat_pool.pop(k)
                break
        if arena is None:
            arena = huge_empty(int(need * 1.05) + 1024, np.int32)
        off = 0

        def take(n):
            nonlocal off
            v = arena[off : off + n]
            off += n
            return v

        views = dict(
            aff=take(L * nchan).reshape(L, nchan),
            aff_depth=take(L),
            neg=take(L * nchan).reshape(L, nchan) if dual else None,
            neg_depth=take(L) if dual else None,
            cand_base=take(L * 4).reshape(L, 4),
            cand_depth=take(L),
            cand_ins=take(L),
            cand_del=take(L),
        )
        ref_tok = None
        filt_min_bq = filt_min_mq = 0
        if filter_view is not None:
            ref_tok, filt_min_bq, filt_min_mq = filter_view
            ref_tok = np.ascontiguousarray(ref_tok, np.int16)
            assert len(ref_tok) == FL, (len(ref_tok), FL)
            views["filt_depth"] = take(FL)
            views["filt_nonref"] = take(FL)
            views["filt_colins"] = take(FL)
        p = lambda a: (a.ctypes.data_as(ctypes.c_void_p)  # noqa: E731
                       if a is not None else ctypes.c_void_p(0))
        n_reads = ctypes.c_int64(0)
        h = lib.pileup_window_reduce(
            self._h, ctg.encode(), int(start), int(end),
            int(excl_flags), int(min_mapq), 1 if handle_overlaps else 0,
            int(aff_min_bq), int(low_mq_thresh), int(low_bq_thresh),
            int(max_indel_length), 1 if with_phasing else 0,
            int(cand_min_mq), dual,
            p(views["aff"]), p(views["aff_depth"]),
            p(views["neg"]), p(views["neg_depth"]),
            p(views["cand_base"]), p(views["cand_depth"]),
            p(views["cand_ins"]), p(views["cand_del"]),
            FILT_MARGIN, p(ref_tok),
            int(filt_min_bq), int(filt_min_mq),
            p(views.get("filt_depth")), p(views.get("filt_nonref")),
            p(views.get("filt_colins")),
            ctypes.byref(n_reads),
        )
        self._last = key
        if not h:
            self._recycle_flat(arena)
            return None
        return NativeWindow(self, h, start, end, nchan, bool(dual), arena,
                            views, n_reads.value, aff_min_bq=aff_min_bq,
                            cand_min_mq=cand_min_mq, ref_tok=ref_tok,
                            filt_min_bq=filt_min_bq, filt_min_mq=filt_min_mq)

    def close(self):
        if self._h:
            get_lib().pileup_close_stream(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

    def load_window(self, ctg, start, end, excl_flags=2316, min_mapq=0,
                    handle_overlaps=True):
        lib = get_lib()
        if lib is None:
            return None
        key = (ctg, int(start))
        in_order = (
            self._h is not None
            and (self._last is None or
                 (self._last[0] == ctg and key[1] >= self._last[1]) or
                 self._last[0] != ctg)
        )
        regressed = (
            self._last is not None and self._last[0] == ctg and key[1] < self._last[1]
        )
        if self._h is None or regressed:
            return load_entry_table(
                self.bam_path, ctg, start, end, excl_flags, min_mapq, handle_overlaps
            )
        # two-phase direct fill: count sizes, then decode straight into the
        # numpy buffers (no intermediate C++ vectors, no export copy)
        n_c = ctypes.c_int64(0)
        bl_c = ctypes.c_int64(0)
        pw = lib.pileup_stream_window_begin(
            self._h, ctg.encode(), int(start), int(end),
            int(excl_flags), int(min_mapq), 1 if handle_overlaps else 0,
            ctypes.byref(n_c), ctypes.byref(bl_c),
        )
        self._last = key
        if not pw:
            return load_entry_table(
                self.bam_path, ctg, start, end, excl_flags, min_mapq, handle_overlaps
            )
        n, blob_cap = n_c.value, bl_c.value
        arena = None
        for k, cand in enumerate(self._pool):
            if len(cand["pos"]) >= n and len(cand["blob"]) >= blob_cap:
                arena = self._pool.pop(k)
                break
        if arena is None:
            cap = int(n * 1.15) + 1024
            bcap = int(blob_cap * 1.5) + 1024
            arena = dict(
                pos=huge_empty(cap, np.int64), code=huge_empty(cap, np.int8),
                bq=huge_empty(cap, np.int16), mq=huge_empty(cap, np.int16),
                hp=huge_empty(cap, np.int8), ikind=huge_empty(cap, np.int8),
                ilen=huge_empty(cap, np.int32),
                iseq_off=huge_empty(cap, np.int64),
                blob=huge_empty(bcap, np.uint8),
                read_id=huge_empty(cap, np.int32),
                eflags=huge_empty(cap, np.int8),
            )
        n_used = ctypes.c_int64(0)
        blob_used = ctypes.c_int64(0)
        p = lambda a: a.ctypes.data_as(ctypes.c_void_p)  # noqa: E731
        lib.pileup_stream_window_fill(
            pw, p(arena["pos"]), p(arena["code"]), p(arena["bq"]),
            p(arena["mq"]), p(arena["hp"]), p(arena["ikind"]),
            p(arena["ilen"]), p(arena["iseq_off"]), p(arena["blob"]),
            p(arena["read_id"]), p(arena["eflags"]),
            ctypes.byref(n_used), ctypes.byref(blob_used),
        )
        nu = n_used.value
        pos, code, bq, mq = (arena[k][:nu] for k in ("pos", "code", "bq", "mq"))
        hp, ikind, ilen = (arena[k][:nu] for k in ("hp", "ikind", "ilen"))
        iseq_off, read_id, eflags = (
            arena[k][:nu] for k in ("iseq_off", "read_id", "eflags")
        )
        blob = arena["blob"][: blob_used.value]
        return dict(
            pos=pos, code=code, bq=bq, mq=mq, hp=hp,
            ikind=ikind, ilen=ilen,
            iseq=LazyIseq(blob, iseq_off, ilen, ikind),
            read_id=read_id, eflags=eflags,
            iseq_off=iseq_off, iseq_blob=blob,
            _arena=arena,
        )


class NativeWindow:
    """Fused-reduce window: dense per-position views + lazy masked entries.

    Produced by ``BamStreamReader.load_window_reduced``: one decode pass of
    the window's reads accumulated the dual-BQ tensor channel counts and
    candidate stats directly (pileup_native.cpp::pileup_window_reduce),
    WITHOUT materializing the full entry table; the C++ handle retains the
    parsed records so ``entries_for_mask`` can materialize entry-table
    arrays for arbitrary site windows afterwards (same array layout and
    read numbering as the full-table decode).
    """

    def __init__(self, stream, handle, start, end, nchan, dual, arena,
                 views, n_reads, aff_min_bq=0, cand_min_mq=20, ref_tok=None,
                 filt_min_bq=0, filt_min_mq=20):
        self._stream = stream
        self._h = handle
        self.start = int(start)
        self.end = int(end)
        self.nchan = nchan
        self.dual = dual
        self.aff_min_bq = int(aff_min_bq)
        self.cand_min_mq = int(cand_min_mq)
        self.with_phasing = nchan > 34
        self._arena = arena        # flat pooled int32 buffer backing views
        self.aff_counts = views["aff"]
        self.aff_depth = views["aff_depth"]
        self.neg_counts = views["neg"] if dual else views["aff"]
        self.neg_depth = views["neg_depth"] if dual else views["aff_depth"]
        self.cand_base = views["cand_base"]
        self.cand_depth = views["cand_depth"]
        self.cand_ins = views["cand_ins"]
        self.cand_del = views["cand_del"]
        self.n_reads = int(n_reads)
        # filter-view accumulation (None when not requested); _ref_tok is
        # retained because the C++ handle keeps a pointer into it
        self._ref_tok = ref_tok
        self.filt_min_bq = filt_min_bq
        self.filt_min_mq = filt_min_mq
        self.filt_depth = views.get("filt_depth")
        self.filt_nonref = views.get("filt_nonref")
        self.filt_colins = views.get("filt_colins")
        self.filt_start = self.start - FILT_MARGIN
        self.filt_end = self.end + FILT_MARGIN

    def entries_for_mask(self, mask, mask_start):
        """Entry-table dict for the masked columns (uint8 mask array).

        Two-phase: exact-size count then direct fill into numpy arrays.
        Entries appear in read order (= mpileup column order per column);
        read_id is the read's stable window ordinal."""
        lib = get_lib()
        mask = np.ascontiguousarray(mask, np.uint8)
        n_c = ctypes.c_int64(0)
        bl_c = ctypes.c_int64(0)
        p = lambda a: a.ctypes.data_as(ctypes.c_void_p)  # noqa: E731
        lib.pileup_window_entries_count(
            self._h, p(mask), int(mask_start), len(mask),
            ctypes.byref(n_c), ctypes.byref(bl_c),
        )
        n, blob_len = n_c.value, bl_c.value
        pos = np.empty(n, np.int64)
        code = np.empty(n, np.int8)
        bq = np.empty(n, np.int16)
        mq = np.empty(n, np.int16)
        hp = np.empty(n, np.int8)
        ikind = np.empty(n, np.int8)
        ilen = np.empty(n, np.int32)
        iseq_off = np.empty(n, np.int64)
        blob = np.empty(blob_len, np.uint8)
        read_id = np.empty(n, np.int32)
        eflags = np.empty(n, np.int8)
        n_used = ctypes.c_int64(0)
        blob_used = ctypes.c_int64(0)
        lib.pileup_window_entries_fill(
            self._h, p(mask), int(mask_start), len(mask),
            p(pos), p(code), p(bq), p(mq), p(hp), p(ikind), p(ilen),
            p(iseq_off), p(blob), p(read_id), p(eflags),
            ctypes.byref(n_used), ctypes.byref(blob_used),
        )
        assert n_used.value == n and blob_used.value == blob_len
        return dict(
            pos=pos, code=code, bq=bq, mq=mq, hp=hp, ikind=ikind, ilen=ilen,
            iseq=LazyIseq(blob, iseq_off, ilen, ikind),
            read_id=read_id, eflags=eflags,
            iseq_off=iseq_off, iseq_blob=blob,
        )

    @property
    def has_filter_data(self):
        return self.filt_depth is not None and self._h is not None

    def filter_assembly(self):
        """Site-independent filter-index state, computed once per window.

        C++ column-sorts the non-ref stream and builds the (column, token)
        distinct-count table; the remaining numpy work (dense casts,
        cumulative sums, RSE mark selection) is also site-independent, so
        the whole assembly can run on the decode-ahead worker — the
        verdict stage then only builds the per-site column rows."""
        if getattr(self, "_fassembly", None) is not None:
            return self._fassembly
        lib = get_lib()
        span = self.filt_end - self.filt_start
        nkeys = ctypes.c_int64(0)
        lib.pileup_window_filter_assemble(self._h, int(span),
                                          ctypes.byref(nkeys))
        n_nr = ctypes.c_int64(0)
        n_st = ctypes.c_int64(0)
        n_en = ctypes.c_int64(0)
        lib.pileup_window_filter_sizes(
            self._h, ctypes.byref(n_nr), ctypes.byref(n_st),
            ctypes.byref(n_en))
        nn, nk = n_nr.value, nkeys.value
        nr_rel = np.empty(nn, np.int32)
        nr_read = np.empty(nn, np.int32)
        nr_token = np.empty(nn, np.int64)
        nr_ik = np.empty(nn, np.int8)
        nr_base = np.empty(nn, np.int8)
        ck_key = np.empty(nk, np.int64)
        ck_cnt = np.empty(nk, np.int64)
        T = ctypes.c_int64(0)
        p = lambda a: a.ctypes.data_as(ctypes.c_void_p)  # noqa: E731
        lib.pileup_window_filter_export_assembled(
            self._h, p(nr_rel), p(nr_read), p(nr_token), p(nr_ik),
            p(nr_base), p(ck_key), p(ck_cnt), ctypes.byref(T))
        # remaining site-independent numpy assembly.  Arrays stay in their
        # native int32 dtypes — the verdict kernels only index/compare with
        # them, and the round-4 .astype(int64) copies of the 4M-column
        # dense arrays cost ~1s/chunk on the decode worker for nothing.
        from clairs_to_tpu_torch.postcall.hardfilter import EPS_RSE

        st_rel, st_read, en_rel, en_read = self.startend_data()
        depth = self.filt_depth
        nonref = self.filt_nonref
        col_ins = self.filt_colins
        m = span
        nstarts = np.bincount(st_rel, minlength=m)
        nends = np.bincount(en_rel, minlength=m)
        side_start = nstarts > nends
        marked_len = np.where(side_start, nstarts, nends)
        colcond = (marked_len >= depth * EPS_RSE) & (depth > 0)
        st_keep = colcond[st_rel] & side_start[st_rel]
        en_keep = colcond[en_rel] & ~side_start[en_rel]
        rse_rel = np.concatenate([st_rel[st_keep], en_rel[en_keep]])
        rse_read = np.concatenate([st_read[st_keep], en_read[en_keep]])
        ro = np.argsort(rse_rel, kind="stable")
        cum_ins = np.empty(m + 1, np.float64)
        cum_ins[0] = 0.0
        np.cumsum(col_ins, dtype=np.float64, out=cum_ins[1:])
        self._fassembly = dict(
            nr_rel=nr_rel, nr_read=nr_read,
            nr_token=nr_token, nr_ik=nr_ik, nr_base=nr_base,
            ck_key=ck_key, ck_cnt=ck_cnt, T=int(T.value),
            depth=depth, nonref=nonref, col_ins=col_ins,
            col_only_ref=(depth > 0) & (nonref == 0),
            cum_ins=cum_ins,
            rse_rel=rse_rel[ro], rse_read=rse_read[ro],
        )
        return self._fassembly

    def startend_data(self):
        """Export only the read start/end mark streams (not the full
        non-ref stream — filter_assembly gets that via the assembled
        export and does not need a second copy)."""
        lib = get_lib()
        n_nr = ctypes.c_int64(0)
        n_st = ctypes.c_int64(0)
        n_en = ctypes.c_int64(0)
        lib.pileup_window_filter_sizes(
            self._h, ctypes.byref(n_nr), ctypes.byref(n_st),
            ctypes.byref(n_en))
        ns, ne = n_st.value, n_en.value
        st_rel = np.empty(ns, np.int32)
        st_read = np.empty(ns, np.int32)
        en_rel = np.empty(ne, np.int32)
        en_read = np.empty(ne, np.int32)
        p = lambda a: a.ctypes.data_as(ctypes.c_void_p)  # noqa: E731
        lib.pileup_window_filter_export_startend(
            self._h, p(st_rel), p(st_read), p(en_rel), p(en_read))
        return st_rel, st_read, en_rel, en_read

    def filter_data(self):
        """Export the filter-view streams accumulated during the decode.

        Returns dict(nr_rel, nr_read, nr_base, nr_ik, nr_ilen, nr_sub,
        st_rel, st_read, en_rel, en_read) — rel coordinates are relative
        to ``filt_start``; emission order (reads in stream order, so
        per-column subsequences are in mpileup column order)."""
        lib = get_lib()
        n_nr = ctypes.c_int64(0)
        n_st = ctypes.c_int64(0)
        n_en = ctypes.c_int64(0)
        lib.pileup_window_filter_sizes(
            self._h, ctypes.byref(n_nr), ctypes.byref(n_st),
            ctypes.byref(n_en))
        nn, ns, ne = n_nr.value, n_st.value, n_en.value
        out = dict(
            nr_rel=np.empty(nn, np.int32), nr_read=np.empty(nn, np.int32),
            nr_base=np.empty(nn, np.int8), nr_ik=np.empty(nn, np.int8),
            nr_ilen=np.empty(nn, np.int32), nr_sub=np.empty(nn, np.int64),
            st_rel=np.empty(ns, np.int32), st_read=np.empty(ns, np.int32),
            en_rel=np.empty(ne, np.int32), en_read=np.empty(ne, np.int32),
        )
        p = lambda a: a.ctypes.data_as(ctypes.c_void_p)  # noqa: E731
        lib.pileup_window_filter_export(
            self._h, p(out["nr_rel"]), p(out["nr_read"]), p(out["nr_base"]),
            p(out["nr_ik"]), p(out["nr_ilen"]), p(out["nr_sub"]),
            p(out["st_rel"]), p(out["st_read"]), p(out["en_rel"]),
            p(out["en_read"]))
        return out

    def reads_overlapping(self, lo, hi, min_mapq=0):
        """Window-retained reads overlapping [lo, hi): list of
        (pos, flag, mapq, cigar_string, seq_string).

        Zero extra BAM I/O — serves the short-read realignment filter's
        per-site window fetches from the records this window already
        parsed (excl_flags applied at select time)."""
        lib = get_lib()
        n = lib.pileup_window_reads_select(self._h, int(lo), int(hi),
                                           int(min_mapq))
        if n == 0:
            return []
        sb = ctypes.c_int64(0)
        cb = ctypes.c_int64(0)
        lib.pileup_window_reads_sizes(self._h, ctypes.byref(sb),
                                      ctypes.byref(cb))
        pos = np.empty(n, np.int64)
        flag = np.empty(n, np.int32)
        mapq = np.empty(n, np.int32)
        seq_off = np.empty(n + 1, np.int64)
        cig_off = np.empty(n + 1, np.int64)
        seq_blob = np.empty(sb.value, np.uint8)
        cig_blob = np.empty(cb.value, np.uint8)
        p = lambda a: a.ctypes.data_as(ctypes.c_void_p)  # noqa: E731
        lib.pileup_window_reads_export(
            self._h, p(pos), p(flag), p(mapq), p(seq_off), p(cig_off),
            p(seq_blob), p(cig_blob))
        seqs = seq_blob.tobytes().decode("latin-1")
        cigs = cig_blob.tobytes().decode("latin-1")
        return [
            (int(pos[i]), int(flag[i]), int(mapq[i]),
             cigs[cig_off[i]:cig_off[i + 1]], seqs[seq_off[i]:seq_off[i + 1]])
            for i in range(n)
        ]

    def close(self):
        """Release the C++ record retention and pool the dense arena."""
        if self._h is not None:
            get_lib().pileup_window_release(self._h)
            self._h = None
        if self._arena is not None and self._stream is not None:
            self._stream._recycle_flat(self._arena)
            self._arena = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


def load_entry_table(bam_path, ctg, start, end, excl_flags=2316, min_mapq=0,
                     handle_overlaps=True):
    """Decode reads into entry-table numpy arrays (native fast path).

    Returns dict(pos, code, bq, mq, hp, ikind, ilen, iseq list) matching the
    PileupEngine internal layout, or None if the native lib is unavailable.
    """
    lib = get_lib()
    if lib is None:
        return None
    h = lib.pileup_load(
        bam_path.encode(), ctg.encode() if ctg else None,
        int(start), int(end), int(excl_flags), int(min_mapq),
        1 if handle_overlaps else 0,
    )
    if not h:
        raise IOError(f"pileup_native failed to load {bam_path} {ctg}:{start}-{end}")
    return _export_table(lib, h)


def _export_table(lib, h):
    try:
        n = lib.pileup_n_entries(h)
        blob_len = lib.pileup_iseq_blob_len(h)
        pos = np.empty(n, np.int64)
        code = np.empty(n, np.int8)
        bq = np.empty(n, np.int16)
        mq = np.empty(n, np.int16)
        hp = np.empty(n, np.int8)
        ikind = np.empty(n, np.int8)
        ilen = np.empty(n, np.int32)
        iseq_off = np.empty(n, np.int64)
        blob = np.empty(blob_len, np.uint8)
        read_id = np.empty(n, np.int32)
        eflags = np.empty(n, np.int8)
        if n:
            lib.pileup_export(
                h,
                pos.ctypes.data_as(ctypes.c_void_p),
                code.ctypes.data_as(ctypes.c_void_p),
                bq.ctypes.data_as(ctypes.c_void_p),
                mq.ctypes.data_as(ctypes.c_void_p),
                hp.ctypes.data_as(ctypes.c_void_p),
                ikind.ctypes.data_as(ctypes.c_void_p),
                ilen.ctypes.data_as(ctypes.c_void_p),
                iseq_off.ctypes.data_as(ctypes.c_void_p),
                blob.ctypes.data_as(ctypes.c_void_p),
                read_id.ctypes.data_as(ctypes.c_void_p),
                eflags.ctypes.data_as(ctypes.c_void_p),
            )
        return dict(
            pos=pos, code=code, bq=bq, mq=mq, hp=hp,
            ikind=ikind, ilen=ilen,
            iseq=LazyIseq(blob, iseq_off, ilen, ikind),
            read_id=read_id, eflags=eflags,
            iseq_off=iseq_off, iseq_blob=blob,
        )
    finally:
        lib.pileup_free(h)
