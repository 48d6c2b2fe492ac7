# Port copy of clairs_to_tpu/bamio/pileup.py.
"""Single-pass pileup engine: decoded reads -> channel counts + candidates.

Replaces the reference's THREE ``samtools mpileup`` text passes per chunk
(candidates: src/extract_candidates_calling.py:308-312; AFF tensor and NEG
tensor: src/create_tensor_pileup_calling.py:442-446 with different --min-BQ)
with ONE decode of the reads into a typed **column-entry table**, from which
every view is a masked reduction.

The column-entry model mirrors the mpileup string exactly: each read
contributes at most one entry per reference position it covers —

    entry = (base | deletion placeholder) [+ indel suffix]

where the indel suffix attaches to the *anchor* (preceding aligned) entry.
Per-view semantics honored (all verified against the reference decoders):

  * candidate view (extract_candidates_calling.py:101-148): reads are
    mq-filtered at read level (--min-MQ 20); an entry with an indel suffix
    counts its anchor base in the ACGT dict AND the suffix in I/D;
    depth counts ACGT + placeholders once per entry.
  * tensor views (create_tensor_pileup_calling.py:146-228): all reads;
    entries with an indel suffix count ONLY as indel evidence (I/i/D/d +
    I1/i1/D1/d1 max-per-distinct-seq); pure bases with mq>=20 go to the main
    channels and depth, mq<20 to LMQ; bq<thresh (30 ont / 10 else) pure
    bases to LBQ regardless of mq; insertions with seq len > max_indel_length
    and deletions with 1+len > max_indel_length are skipped entirely
    (create_tensor:173-197); ref channels are overwritten with the negated
    block sums (create_tensor:223-228).
  * --reverse-del: placeholders are strand-aware ('*' fwd / '#' rev); a
    placeholder's BQ is the next aligned query base's quality (htslib qpos
    convention), so --min-BQ can drop deleted positions.
  * read-pair overlaps (htslib tweak_overlap_quality, default on in
    mpileup): agreeing bases keep mate1 (qual q1+q2 capped 200), mate2 -> 0;
    disagreeing keep the higher-qual mate at 0.8q, other -> 0.

Note on BAQ: the reference's mpileup invocations pass no -f/--fasta-ref
(extract_candidates_calling.py:298-309, create_tensor_pileup_calling.py:
442-443), and samtools cannot compute BAQ without a reference — so the
reference pipeline runs BAQ-less, exactly like this module's default
(base qualities used as stored).  ``--apply_baq`` (bamio/baq.py) remains
available as an experiment, not a parity requirement.

This module is the behavioral reference for the C++ fast path
(clairs_to_tpu/bamio/native), which emits the same arrays.
"""

from collections import defaultdict
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from clairs_to_tpu_torch import config as cfg
from clairs_to_tpu_torch.bamio.bam import FLAG_PAIRED

# entry base codes
CODE_ACGT_FWD = {b: i for i, b in enumerate("ACGT")}          # 0..3
CODE_ACGT_REV = {b: i + 4 for i, b in enumerate("ACGT")}      # 4..7
CODE_DEL_FWD = 8   # '*'
CODE_DEL_REV = 9   # '#'
CODE_SKIP = 10      # N/non-ACGT base, forward strand
CODE_SKIP_REV = 11  # N/non-ACGT base, reverse strand
# pure skip-family entries consume nothing in any view, but an indel suffix
# anchored on one still counts: the reference decoders key indel strand by
# the anchor char with 'N' in the FORWARD set and 'n' reverse
# (create_tensor_pileup_calling.py:182,199); alt_info/candidate keys keep
# the N anchor char.  Executed-oracle-verified by
# tests/test_reference_decoder_oracle.py.

INDEL_NONE, INDEL_INS, INDEL_DEL = 0, 1, 2

_CH = cfg.CHANNEL_INDEX
_BASE_CHARS = "ACGTacgt*#?"


def evc_base(b: str) -> str:
    """create_tensor_pileup_calling.py:82-92 — collapse unknown bases to A."""
    if b in "ACGT":
        return b
    if b in "acgt":
        return b.upper()
    return "A"


@dataclass
class CandidateInfo:
    pos: int              # 0-based
    depth: int
    alt_info: str         # reference alt_info grammar "<depth>-<k c ...>-"
    af: float
    pass_snv: bool
    pass_indel: bool
    alt_list: list        # [(entry_str_upper, count)] sorted desc, ref excluded
    # pileup_dict items sorted by count desc (ref INCLUDED) — the
    # reference's pileup_list, feeding the --alt_fn af_infos column
    # (extract_candidates_calling.py:351-355)
    pileup_list: list = None


class PileupEngine:
    """Accumulates column entries for one chunk; all views query the table."""

    def __init__(self, ref_seq: str, ref_start: int, platform: str = "ont",
                 max_indel_length: int = cfg.MAX_INDEL_LENGTH,
                 handle_overlaps: bool = True):
        self.ref_seq = ref_seq.upper()
        self.ref_start = ref_start          # 0-based position of ref_seq[0]
        self.platform = cfg.platform_family(platform)
        self.max_indel_length = max_indel_length
        self.handle_overlaps = handle_overlaps
        # column-entry table (parallel lists -> arrays at finalize)
        self._pos: List[int] = []
        self._code: List[int] = []
        self._bq: List[int] = []
        self._mq: List[int] = []
        self._hp: List[int] = []
        self._ikind: List[int] = []
        self._ilen: List[int] = []
        self._iseq: List[str] = []   # '' when no suffix; as-read case for ins
        self._read_id: List[int] = []
        self._eflags: List[int] = []  # bit1: read-start entry, bit2: read-end
        self._n_reads = 0
        self._pending_mates: Dict[str, Dict[int, int]] = {}
        self._arrays = None
        self._iseq_off = None    # int64 offsets into _iseq_blob (native path)
        self._iseq_blob = None   # uint8 array of insertion sequences
        # lazy fused-window mode (native.NativeWindow): entries fetched on
        # demand per site window instead of materializing the full table
        self._win = None
        self._cov_start = 0
        self._covered = None
        self._win_tables = []
        self._hp_per_read = None

    # ------------------------------------------------------------------
    @classmethod
    def from_native_window(cls, win, ref_seq, ref_start, platform="ont",
                           max_indel_length=cfg.MAX_INDEL_LENGTH):
        """Wrap a fused-reduce window (bamio.native.NativeWindow).

        The dense tensor/candidate views were already accumulated during
        the decode; entry-table arrays are fetched lazily per site window
        (``ensure_sites``) from the retained records, so the table only
        ever holds the ±window columns the consumers actually read —
        typically 100-1000x fewer entries than the full-chunk table that
        was the round-3 end-to-end wall."""
        eng = cls(ref_seq, ref_start, platform=platform,
                  max_indel_length=max_indel_length)
        eng._win = win
        margin = 4096  # filter windows may poke past the chunk region edge
        eng._cov_start = win.start - margin
        eng._covered = np.zeros(win.end + margin - eng._cov_start, np.uint8)
        eng._win_tables = []
        eng._set_empty_arrays()
        return eng

    def _set_empty_arrays(self):
        self._arrays = dict(
            pos=np.zeros(0, np.int64), code=np.zeros(0, np.int8),
            bq=np.zeros(0, np.int16), mq=np.zeros(0, np.int16),
            hp=np.zeros(0, np.int8), ikind=np.zeros(0, np.int8),
            ilen=np.zeros(0, np.int32), read_id=np.zeros(0, np.int32),
            eflags=np.zeros(0, np.int8),
        )
        self._iseq = []
        self._iseq_off = np.zeros(0, np.int64)
        self._iseq_blob = np.zeros(0, np.uint8)

    @property
    def n_reads(self):
        if self._win is not None:
            return self._win.n_reads
        a = self._finalize()
        return int(a["read_id"].max()) + 1 if len(a["read_id"]) else 0

    def ensure_sites(self, positions, radius=0):
        """Lazy mode: make sure entries at ``positions ± radius`` are in
        the table; no-op otherwise.  Each column is fetched exactly once
        (whole columns, read order preserved), so tables fetched across
        calls concatenate without breaking per-column entry order or read
        identity."""
        if self._win is None or len(positions) == 0:
            return
        pos = np.asarray(sorted(set(int(p) for p in positions)), np.int64)
        want = np.zeros_like(self._covered)
        lo = np.clip(pos - radius - self._cov_start, 0, len(want))
        hi = np.clip(pos + radius + 1 - self._cov_start, 0, len(want))
        for a, b in zip(lo, hi):
            if b > a:
                want[a:b] = 1
        new = want & ~self._covered
        if not new.any():
            return
        table = self._win.entries_for_mask(new, self._cov_start)
        self._covered |= want
        if len(table["pos"]):
            self._win_tables.append(table)
            self._arrays = None  # re-merge on next _finalize

    def ensure_all(self):
        """Lazy mode: fetch every remaining column (full-table parity)."""
        if self._win is None:
            return
        new = (1 - self._covered).astype(np.uint8)
        if not new.any():
            return
        table = self._win.entries_for_mask(new, self._cov_start)
        self._covered[:] = 1
        if len(table["pos"]):
            self._win_tables.append(table)
            self._arrays = None

    def _merge_win_tables(self):
        """Concatenate fetched site tables into the canonical array set."""
        ts = self._win_tables
        if len(ts) == 0:
            self._set_empty_arrays()
        elif len(ts) == 1:
            t = ts[0]
            self._arrays = {k: t[k] for k in (
                "pos", "code", "bq", "mq", "hp", "ikind", "ilen",
                "read_id", "eflags")}
            self._iseq_off = t["iseq_off"]
            self._iseq_blob = t["iseq_blob"]
        else:
            self._arrays = {
                k: np.concatenate([t[k] for t in ts])
                for k in ("pos", "code", "bq", "mq", "hp", "ikind", "ilen",
                          "read_id", "eflags")
            }
            offs = []
            shift = 0
            for t in ts:
                o = t["iseq_off"].copy()
                o[o >= 0] += shift
                offs.append(o)
                shift += len(t["iseq_blob"])
            self._iseq_off = np.concatenate(offs)
            self._iseq_blob = (
                np.concatenate([t["iseq_blob"] for t in ts])
                if shift else np.zeros(0, np.uint8)
            )
        from clairs_to_tpu_torch.bamio.native import LazyIseq

        self._iseq = LazyIseq(self._iseq_blob, self._iseq_off,
                              self._arrays["ilen"], self._arrays["ikind"])
        if self._hp_per_read is not None and len(self._arrays["pos"]):
            self._arrays["hp"] = self._hp_per_read[self._arrays["read_id"]]

    # ------------------------------------------------------------------
    @classmethod
    def from_entry_table(cls, table, ref_seq, ref_start, platform="ont",
                         max_indel_length=cfg.MAX_INDEL_LENGTH):
        """Wrap a pre-built entry table (native fast path, bamio.native).

        The native decoder already performed CIGAR expansion and overlap
        adjustment; all reductions below operate on the same arrays either
        way, so the two paths share semantics by construction.
        """
        eng = cls(ref_seq, ref_start, platform=platform,
                  max_indel_length=max_indel_length)
        eng._pos = table["pos"]
        eng._code = table["code"]
        eng._bq = table["bq"]
        eng._mq = table["mq"]
        eng._hp = table["hp"]
        eng._ikind = table["ikind"]
        eng._ilen = table["ilen"]
        eng._iseq = table["iseq"]
        eng._read_id = table.get("read_id", np.zeros(len(table["pos"]), np.int32))
        eng._eflags = table.get("eflags", np.zeros(len(table["pos"]), np.int8))
        eng._iseq_off = table.get("iseq_off")
        eng._iseq_blob = table.get("iseq_blob")
        eng._table = table   # kept for arena recycling (BamStreamReader)
        return eng

    # ------------------------------------------------------------------
    def add_read(self, read):
        rev = read.is_reverse
        hp = int(read.tags.get("HP", 0)) if read.tags else 0
        mq = int(read.mapq)
        seq = read.seq
        qual = read.qual
        ops = read.cigar_ops
        lens = read.cigar_lens
        ref_pos = read.pos
        qpos = 0
        first_idx = len(self._pos)
        last_entry_idx = -1  # index of entry at ref_pos-1 (anchor candidate)

        rid = self._n_reads
        self._n_reads += 1

        def push(pos, code, bq):
            self._pos.append(pos)
            self._code.append(code)
            self._bq.append(bq)
            self._mq.append(mq)
            self._hp.append(hp)
            self._ikind.append(INDEL_NONE)
            self._ilen.append(0)
            self._iseq.append("")
            self._read_id.append(rid)
            self._eflags.append(0)
            return len(self._pos) - 1

        for i in range(len(ops)):
            op = int(ops[i])
            ln = int(lens[i])
            if op in (0, 7, 8):  # M, =, X
                for k in range(ln):
                    b = seq[qpos + k].upper()
                    if b in "ACGT":
                        code = CODE_ACGT_REV[b] if rev else CODE_ACGT_FWD[b]
                    else:
                        code = CODE_SKIP_REV if rev else CODE_SKIP
                    last_entry_idx = push(ref_pos + k, code, int(qual[qpos + k]))
                ref_pos += ln
                qpos += ln
            elif op == 1:  # I — suffix on the anchor entry (last-wins like
                # the reference decoder's base_list[-1][1] overwrite)
                if last_entry_idx >= 0 and self._pos[last_entry_idx] == ref_pos - 1:
                    self._ikind[last_entry_idx] = INDEL_INS
                    self._ilen[last_entry_idx] = ln
                    s = seq[qpos : qpos + ln]
                    self._iseq[last_entry_idx] = s.lower() if rev else s.upper()
                qpos += ln
            elif op == 2:  # D — suffix on anchor + placeholders
                if last_entry_idx >= 0 and self._pos[last_entry_idx] == ref_pos - 1:
                    self._ikind[last_entry_idx] = INDEL_DEL
                    self._ilen[last_entry_idx] = ln
                    self._iseq[last_entry_idx] = ""
                nxt_bq = int(qual[qpos]) if qpos < len(qual) else (
                    int(qual[-1]) if len(qual) else 0
                )
                code = CODE_DEL_REV if rev else CODE_DEL_FWD
                for k in range(ln):
                    last_entry_idx = push(ref_pos + k, code, nxt_bq)
                ref_pos += ln
            elif op == 3:  # N
                ref_pos += ln
                last_entry_idx = -1
            elif op == 4:  # S
                qpos += ln
            # H/P consume nothing

        if len(self._pos) > first_idx:
            # mpileup-style read boundary marks: '^' on the first ref-consuming
            # entry, '$' on the last (postfilter_variants.py:155-177)
            self._eflags[first_idx] |= 1
            self._eflags[len(self._pos) - 1] |= 2

        if self.handle_overlaps and (read.flag & FLAG_PAIRED):
            self._overlap_adjust(read.name, first_idx)
        self._arrays = None

    def _overlap_adjust(self, name, first_idx):
        """htslib tweak_overlap_quality on same-name overlapping mates."""
        span = {
            self._pos[i]: i
            for i in range(first_idx, len(self._pos))
            if self._code[i] < 8
        }
        prev = self._pending_mates.pop(name, None)
        if prev is None:
            self._pending_mates[name] = span
            return
        for pos, i2 in span.items():
            i1 = prev.get(pos)
            if i1 is None:
                continue
            c1, c2 = self._code[i1] % 4, self._code[i2] % 4
            q1, q2 = self._bq[i1], self._bq[i2]
            if c1 == c2:
                self._bq[i1] = min(q1 + q2, 200)
                self._bq[i2] = 0
            elif q1 >= q2:
                self._bq[i1] = int(0.8 * q1)
                self._bq[i2] = 0
            else:
                self._bq[i2] = int(0.8 * q2)
                self._bq[i1] = 0

    # ------------------------------------------------------------------
    def _finalize(self):
        if self._win is not None:
            if self._arrays is None:
                self._merge_win_tables()
            return self._arrays
        if self._arrays is None:
            self._arrays = dict(
                pos=np.asarray(self._pos, dtype=np.int64),
                code=np.asarray(self._code, dtype=np.int8),
                bq=np.asarray(self._bq, dtype=np.int16),
                mq=np.asarray(self._mq, dtype=np.int16),
                hp=np.asarray(self._hp, dtype=np.int8),
                ikind=np.asarray(self._ikind, dtype=np.int8),
                ilen=np.asarray(self._ilen, dtype=np.int32),
                read_id=np.asarray(self._read_id, dtype=np.int32),
                eflags=np.asarray(self._eflags, dtype=np.int8),
            )
        return self._arrays

    def _ref_base(self, pos0: int) -> str:
        idx = pos0 - self.ref_start
        if 0 <= idx < len(self.ref_seq):
            return self.ref_seq[idx]
        return "N"

    def _indel_ok_tensor(self, ikind, ilen):
        """Tensor-view indel length gate (create_tensor:173-197)."""
        if ikind == INDEL_INS:
            return ilen <= self.max_indel_length
        return ilen + 1 <= self.max_indel_length

    # ------------------------------------------------------------------
    def _ensure_iseq_arrays(self):
        """Build the iseq blob/offset arrays (native reduction inputs)."""
        if self._iseq_blob is not None:
            return
        offs = np.full(len(self._iseq), -1, np.int64)
        parts = []
        total = 0
        for i, s in enumerate(self._iseq):
            if s:
                offs[i] = total
                b = s.encode("latin-1")
                parts.append(b)
                total += len(b)
        self._iseq_off = offs
        self._iseq_blob = np.frombuffer(b"".join(parts), dtype=np.uint8).copy() \
            if parts else np.zeros(0, np.uint8)

    def _native_lib(self):
        from clairs_to_tpu_torch.bamio import native

        return native.get_lib() if native.available() else None

    def channel_counts(self, min_bq: int, region_start: int, region_end: int,
                       with_phasing: bool = False):
        """Tensor-view counts: (L, 34[+16]) int32 + (L,) depth.

        Ref-channel negation is NOT applied here (see apply_reference_encoding)
        because candidate alt_info needs the raw counts first.  Dispatches to
        the single-pass C++ reduction when available; the numpy path below is
        the behavioral reference.
        """
        if self._win is not None:
            w = self._win
            if (with_phasing == w.with_phasing and region_start == w.start
                    and region_end == w.end
                    and min_bq in (w.aff_min_bq, 0)):
                # dense views were accumulated during the fused decode
                if min_bq == w.aff_min_bq:
                    return w.aff_counts, w.aff_depth
                return w.neg_counts, w.neg_depth
            # off-contract request (tools/tests): full-table fallback
            self.ensure_all()
        a = self._finalize()
        lib = self._native_lib()
        if lib is not None and len(a["pos"]):
            import ctypes

            self._ensure_iseq_arrays()
            L = region_end - region_start
            nchan = cfg.PILEUP_CHANNEL_SIZE + (16 if with_phasing else 0)
            out = np.zeros((L, nchan), dtype=np.int32)
            depth = np.zeros(L, dtype=np.int32)

            def ptr(arr):
                return arr.ctypes.data_as(ctypes.c_void_p)

            lib.entry_channel_counts(
                len(a["pos"]), ptr(a["pos"]), ptr(a["code"]), ptr(a["bq"]),
                ptr(a["mq"]), ptr(a["hp"]), ptr(a["ikind"]), ptr(a["ilen"]),
                ptr(self._iseq_off), ptr(self._iseq_blob),
                int(min_bq), int(region_start), int(region_end),
                int(cfg.LOW_MQ_THRESHOLD),
                int(cfg.LOW_BQ_THRESHOLD.get(self.platform, 10)),
                int(self.max_indel_length), 1 if with_phasing else 0,
                ptr(out), ptr(depth),
            )
            return out, depth
        return self._channel_counts_np(a, min_bq, region_start, region_end,
                                       with_phasing)

    def _channel_counts_np(self, a, min_bq, region_start, region_end,
                           with_phasing):
        L = region_end - region_start
        nchan = cfg.PILEUP_CHANNEL_SIZE + (16 if with_phasing else 0)
        out = np.zeros((L, nchan), dtype=np.int32)
        depth = np.zeros(L, dtype=np.int32)

        inb = (a["pos"] >= region_start) & (a["pos"] < region_end)
        sel = inb & (a["bq"] >= min_bq) & (
            (a["code"] < CODE_SKIP) | (a["ikind"] != INDEL_NONE))
        idx_all = np.nonzero(sel)[0]
        pos = a["pos"][idx_all] - region_start
        code = a["code"][idx_all]
        mq = a["mq"][idx_all]
        bq = a["bq"][idx_all]
        hp = a["hp"][idx_all]
        ikind = a["ikind"][idx_all]
        ilen = a["ilen"][idx_all]

        hi = mq >= cfg.LOW_MQ_THRESHOLD
        pure = ikind == INDEL_NONE

        # main channels: pure entries with mq>=20 (skip-family excluded)
        m = hi & pure & (code < CODE_SKIP)
        ch = np.where(
            code[m] < 4,
            code[m],
            np.where(code[m] < 8, code[m] + 5,
                     np.where(code[m] == CODE_DEL_FWD, _CH["*"], _CH["#"])),
        )
        flat = np.bincount(pos[m] * nchan + ch, minlength=L * nchan)
        out += flat.reshape(L, nchan).astype(np.int32)
        depth += np.bincount(pos[m], minlength=L).astype(np.int32)

        # LMQ channels: pure base entries with mq<20
        m = ~hi & pure & (code < 8)
        ch = np.where(code[m] < 4, code[m] + _CH["ALMQ"], code[m] - 4 + _CH["aLMQ"])
        out += np.bincount(pos[m] * nchan + ch, minlength=L * nchan).reshape(L, nchan).astype(np.int32)

        # LBQ channels: pure base entries with low bq (any mq)
        lbq_thresh = cfg.LOW_BQ_THRESHOLD.get(self.platform, 10)
        m = pure & (code < 8) & (bq < lbq_thresh)
        ch = np.where(code[m] < 4, code[m] + _CH["ALBQ"], code[m] - 4 + _CH["aLBQ"])
        out += np.bincount(pos[m] * nchan + ch, minlength=L * nchan).reshape(L, nchan).astype(np.int32)

        if with_phasing:
            base_off = nchan - 16
            for hval, off in ((1, 0), (2, 8)):
                # PURE base entries only: an indel-suffixed entry's joined
                # key fails the reference's 'ACGTacgt' membership test
                # (create_tensor:150-154); layout A..t HP1 then HP2 (:60-67)
                m = (hp == hval) & (code < 8) & pure
                ch = base_off + off + code[m] % 8
                np.add.at(out, (pos[m], ch), 1)

        # indel-suffix entries: mq>=20 only; counted solely as indel evidence
        ins_groups = defaultdict(int)
        del_groups = defaultdict(int)
        for j in np.nonzero(sel & (a["ikind"] != INDEL_NONE)
                            & (a["mq"] >= cfg.LOW_MQ_THRESHOLD))[0]:
            p = int(a["pos"][j]) - region_start
            kind, ln = int(a["ikind"][j]), int(a["ilen"][j])
            if not self._indel_ok_tensor(kind, ln):
                continue
            # strand by anchor char: 'ACGTN*' fwd else rev (create_tensor:182,199)
            c = int(a["code"][j])
            fwd = c < 4 or c == CODE_DEL_FWD or c == CODE_SKIP
            depth[p] += 1
            if kind == INDEL_INS:
                out[p, _CH["I" if fwd else "i"]] += 1
                ins_groups[(p, fwd, self._iseq[j].upper())] += 1
            else:
                out[p, _CH["D" if fwd else "d"]] += 1
                del_groups[(p, fwd, ln)] += 1
        for (p, fwd, _s), c in ins_groups.items():
            ch = _CH["I1" if fwd else "i1"]
            out[p, ch] = max(out[p, ch], c)
        for (p, fwd, _l), c in del_groups.items():
            ch = _CH["D1" if fwd else "d1"]
            out[p, ch] = max(out[p, ch], c)

        return out, depth

    def _ref_indices(self, region_start, L):
        """Vectorized evc_base ACGT indices for [region_start, region_start+L).

        Byte-LUT over the cached reference window: A/a->0 C/c->1 G/g->2
        T/t->3, anything else -> 0 ('A', create_tensor:82-92); positions
        outside the window behave like 'N' -> 0.
        """
        if getattr(self, "_ref_u8", None) is None:
            lut = np.zeros(256, np.int64)
            for i, b in enumerate("ACGT"):
                lut[ord(b)] = i
                lut[ord(b.lower())] = i
            self._ref_u8 = lut[
                np.frombuffer(self.ref_seq.encode("ascii"), np.uint8)
            ]
        cached = getattr(self, "_ref_idx_cache", None)
        if cached is not None and cached[0] == (region_start, L):
            return cached[1]   # AFF and NEG encodes share the same window
        start = region_start - self.ref_start
        out = np.zeros(L, np.int64)
        lo, hi = max(start, 0), min(start + L, len(self._ref_u8))
        if hi > lo:
            out[lo - start : hi - start] = self._ref_u8[lo:hi]
        self._ref_idx_cache = ((region_start, L), out)
        return out

    def apply_reference_encoding(self, counts, region_start):
        """Ref-channel negation, vectorized (create_tensor:223-228)."""
        L = counts.shape[0]
        ref_idx = self._ref_indices(region_start, L)
        blocks = np.array(
            (0, 9, _CH["ALMQ"], _CH["aLMQ"], _CH["ALBQ"], _CH["aLBQ"]),
            np.int32,
        )
        lib = self._native_lib()
        if (lib is not None and counts.dtype == np.int32
                and counts.flags.c_contiguous):
            import ctypes

            lib.ref_negate_channels(
                L, np.int32(counts.shape[1]),
                counts.ctypes.data_as(ctypes.c_void_p),
                ref_idx.ctypes.data_as(ctypes.c_void_p),
                np.int32(len(blocks)),
                blocks.ctypes.data_as(ctypes.c_void_p),
            )
            return counts
        rows = np.arange(L)
        for block in blocks:
            sums = counts[:, block : block + 4].sum(axis=1)
            counts[rows, block + ref_idx] = -sums
        return counts

    # ------------------------------------------------------------------
    def _alt_groups(self, want, min_bq, min_mq):
        """{pos: [(entry_string, count)]} in first-encounter order.

        The per-entry view filter (bq/mq/CODE_SKIP) and distinct-key
        aggregation run in one native pass (entry_alt_aggregate); the
        Python loop below is the behavioral reference and the fallback.
        """
        self.ensure_sites(want, 0)
        a = self._finalize()
        from clairs_to_tpu_torch.bamio import native

        if native.available() and len(want):
            self._ensure_iseq_arrays()
            groups = native.alt_aggregate(
                a, self._iseq_off, self._iseq_blob, want,
                min_bq, min_mq, self.ref_seq, self.ref_start,
            )
            if groups is not None:
                return groups
        per_pos_entries = native.group_entries_at(a["pos"], want)
        out = {}
        for p in want:
            counter = defaultdict(int)
            order = []
            for j in per_pos_entries.get(p, []):
                if self._bq[j] < min_bq or self._mq[j] < min_mq:
                    continue
                if self._code[j] >= CODE_SKIP and self._ikind[j] == INDEL_NONE:
                    continue
                key = self._entry_string(j)
                if key not in counter:
                    order.append(key)
                counter[key] += 1
            out[p] = [(key, counter[key]) for key in order]
        return out

    def alt_info_at(self, positions, min_bq: int):
        """Reference alt_info strings at candidate positions (tensor view).

        Grammar (create_tensor:158-209): "<depth>-<key cnt key cnt ...>-",
        keys X<base>, I<anchor><seq>, D<anchor+deleted ref>, R<ref>, insertion
        order = first-encounter order of entries (mpileup column order).
        """
        want = sorted(set(int(p) for p in positions))
        self.ensure_sites(want, 0)
        from clairs_to_tpu_torch.bamio import native

        if native.available() and len(want):
            # single C++ pass: aggregation + fold + string assembly
            # (byte-identical to the Python fold below, which remains the
            # behavioral reference — tests/test_native_altinfo.py)
            a = self._finalize()
            self._ensure_iseq_arrays()
            res = native.alt_info(
                a, self._iseq_off, self._iseq_blob, want,
                min_bq, cfg.LOW_MQ_THRESHOLD, self.max_indel_length,
                self.ref_seq, self.ref_start,
            )
            if res is not None:
                return res
        groups = self._alt_groups(want, min_bq, cfg.LOW_MQ_THRESHOLD)
        out = {}
        for p in want:
            depth = 0
            alt_dict = {}
            ref_count = 0
            rb = self._ref_base(p)
            for key, count in groups.get(p, []):
                if len(key) == 1:
                    if key.upper() in "ACGT":
                        depth += count
                        if key.upper() != rb:
                            alt_dict["X" + key.upper()] = (
                                alt_dict.get("X" + key.upper(), 0) + count
                            )
                        else:
                            ref_count += count
                    elif key in "#*":
                        depth += count
                elif key[1] == "+":
                    if len(key[2:]) > self.max_indel_length:
                        continue
                    depth += count
                    k = "I" + key[0].upper() + key[2:].upper()
                    alt_dict[k] = alt_dict.get(k, 0) + count
                elif key[1] == "-":
                    if len(key[1:]) > self.max_indel_length:
                        continue
                    depth += count
                    dl = len(key[2:])
                    info = "".join(
                        self._ref_base(p + t) for t in range(0, dl + 1)
                    )
                    k = "D" + info
                    alt_dict[k] = alt_dict.get(k, 0) + count
            if ref_count > 0:
                alt_dict["R" + rb] = ref_count
            alt_info = (
                str(depth)
                + "-"
                + " ".join(f"{k} {v}" for k, v in alt_dict.items())
                + "-"
            )
            out[p] = (alt_info, depth)
        return out

    def _entry_string(self, j):
        """The mpileup column entry string for entry j (case = strand)."""
        c = self._code[j]
        if c < 4:
            base = "ACGT"[c]
        elif c < 8:
            base = "acgt"[c - 4]
        elif c == CODE_DEL_FWD:
            base = "*"
        elif c == CODE_DEL_REV:
            base = "#"
        else:
            base = "N" if c == CODE_SKIP else "n"
        kind = self._ikind[j]
        if kind == INDEL_NONE:
            return base
        if kind == INDEL_INS:
            return base + "+" + self._iseq[j]
        # deletion suffix: mpileup shows the deleted ref seq, lowercase on rev
        rev = (4 <= c < 8) or c == CODE_DEL_REV or c == CODE_SKIP_REV
        dl = self._ilen[j]
        p = self._pos[j]
        seq = "".join(self._ref_base(p + 1 + t) for t in range(dl))
        return base + "-" + (seq.lower() if rev else seq)

    # ------------------------------------------------------------------
    def find_candidates(
        self,
        region_start: int,
        region_end: int,
        min_bq: Optional[int] = None,
        min_coverage: int = cfg.MIN_COVERAGE,
        snv_min_af: float = cfg.SNV_MIN_AF,
        indel_min_af: float = cfg.INDEL_MIN_AF,
        alternative_base_num: int = cfg.ALTERNATIVE_BASE_NUM,
        select_indel_candidates: bool = False,
        with_infos: bool = True,
    ):
        """Candidate gating (extract_candidates_calling.py:101-169).

        View: reads with mq>=20 (the reference's mpileup --min-MQ 20), bases
        with bq>=min_bq.  Returns (snv_positions, indel_positions,
        {pos: CandidateInfo}) with 0-based positions.
        """
        if min_bq is None:
            min_bq = cfg.MIN_BQ_DICT.get(self.platform, 0)
        # fused-window fast path: the candidate-view stats (depth, per-base,
        # ins/del totals at bq>=min_bq, mq>=20) were accumulated during the
        # decode — the prefilter needs no entry table at all
        use_win = (
            self._win is not None
            and min_bq == self._win.aff_min_bq
            and cfg.MIN_MQ == self._win.cand_min_mq
            and region_start >= self._win.start
            and region_end <= self._win.end
        )
        if self._win is not None and not use_win:
            self.ensure_all()
        a = self._finalize()
        if not use_win and len(a["pos"]) == 0:
            return [], [], {}

        # ---- vectorized superset prefilter -------------------------------
        # Exact per-position gating below is Python; at genome scale it must
        # only ever see positions that can possibly pass.  Necessary
        # conditions, all array ops: depth > min_coverage AND (some non-ref
        # base count >= max(support, af*depth) OR total ins/del count does).
        L = region_end - region_start
        ref_codes = np.full(L, -1, dtype=np.int8)
        lo = region_start - self.ref_start
        ref_slice = self.ref_seq[max(lo, 0) : lo + L]
        arr = np.frombuffer(ref_slice.encode(), dtype=np.uint8)
        pad = L - len(arr)
        if lo < 0 or pad > 0:
            full = np.full(L, ord("N"), dtype=np.uint8)
            off = max(-lo, 0)
            full[off : off + len(arr)] = arr
            arr = full
        for b, c in ((ord("A"), 0), (ord("C"), 1), (ord("G"), 2), (ord("T"), 3)):
            ref_codes[arr == b] = c

        support = alternative_base_num
        lib = self._native_lib()
        if use_win:
            w = self._win
            o0 = region_start - w.start
            base_counts = w.cand_base[o0 : o0 + L]
            depth_arr = w.cand_depth[o0 : o0 + L]
            ins_tot = w.cand_ins[o0 : o0 + L]
            del_tot = w.cand_del[o0 : o0 + L]
            if (lib is not None and base_counts.flags.c_contiguous
                    and depth_arr.flags.c_contiguous):
                import ctypes

                mask8 = np.zeros(L, np.uint8)
                ptr = lambda x: x.ctypes.data_as(ctypes.c_void_p)  # noqa: E731
                lib.window_candidate_prefilter(
                    L, ptr(base_counts), ptr(depth_arr), ptr(ins_tot),
                    ptr(del_tot), ptr(ref_codes), int(min_coverage),
                    float(snv_min_af), float(indel_min_af), int(support),
                    1 if select_indel_candidates else 0, ptr(mask8),
                )
                cand_mask = mask8 > 0
            else:
                denom = np.maximum(depth_arr, 1)
                alt_mask = np.zeros(L, dtype=bool)
                for c in range(4):
                    cnt = base_counts[:, c]
                    ok = (ref_codes != c) & (cnt >= support) & (cnt / denom >= snv_min_af)
                    alt_mask |= ok
                if select_indel_candidates:
                    for tot in (ins_tot, del_tot):
                        alt_mask |= (tot >= support) & (tot / denom >= indel_min_af)
                cand_mask = alt_mask & (depth_arr > min_coverage) & (ref_codes >= 0)
        elif lib is not None and len(a["pos"]):
            import ctypes

            mask8 = np.zeros(L, dtype=np.uint8)

            def ptr(x):
                return x.ctypes.data_as(ctypes.c_void_p)

            lib.entry_candidate_prefilter(
                len(a["pos"]), ptr(a["pos"]), ptr(a["code"]), ptr(a["bq"]),
                ptr(a["mq"]), ptr(a["ikind"]),
                int(min_bq), int(cfg.MIN_MQ), int(region_start), int(region_end),
                ptr(ref_codes), int(min_coverage), float(snv_min_af),
                float(indel_min_af), int(support),
                1 if select_indel_candidates else 0, ptr(mask8),
            )
            cand_mask = mask8 > 0
        else:
            sel = (
                (a["pos"] >= region_start)
                & (a["pos"] < region_end)
                & (a["mq"] >= cfg.MIN_MQ)
                & (a["bq"] >= min_bq)
                & ((a["code"] < CODE_SKIP) | (a["ikind"] != INDEL_NONE))
            )
            idx_all = np.nonzero(sel)[0]
            pos_rel = (a["pos"][idx_all] - region_start).astype(np.int64)
            code = a["code"][idx_all]
            ikind_arr = a["ikind"][idx_all]
            base_m = code < 8
            base_counts = np.bincount(
                pos_rel[base_m] * 4 + code[base_m] % 4, minlength=L * 4
            ).reshape(L, 4).astype(np.int32)
            # skip-family entries add no depth (their key has no ACGT/#/*)
            depth_arr = np.bincount(
                pos_rel[code < CODE_SKIP], minlength=L).astype(np.int32)
            ins_tot = np.bincount(
                pos_rel[ikind_arr == INDEL_INS], minlength=L
            ).astype(np.int32)
            del_tot = np.bincount(
                pos_rel[ikind_arr == INDEL_DEL], minlength=L
            ).astype(np.int32)
            denom = np.maximum(depth_arr, 1)
            alt_mask = np.zeros(L, dtype=bool)
            for c in range(4):
                cnt = base_counts[:, c]
                ok = (ref_codes != c) & (cnt >= support) & (cnt / denom >= snv_min_af)
                alt_mask |= ok
            if select_indel_candidates:
                for tot in (ins_tot, del_tot):
                    alt_mask |= (tot >= support) & (tot / denom >= indel_min_af)
            cand_mask = alt_mask & (depth_arr > min_coverage) & (ref_codes >= 0)
        prefilter = np.nonzero(cand_mask)[0] + region_start
        if len(prefilter) == 0:
            return [], [], {}

        # ---- exact gating at prefiltered positions ------------------------
        # one native pass aggregates distinct entry keys per prefiltered
        # position (view filters applied in C++); the threshold logic below
        # sees ~4 keys/position instead of ~depth entries/position
        pf = np.asarray(prefilter, dtype=np.int64)
        if not with_infos:
            # decision-bits-only C++ gate (same fold semantics as the loop
            # below, cross-validated by tests/test_native_altinfo.py); the
            # CandidateInfo bookkeeping is --alt_fn debug output and is
            # skipped on the hot path
            from clairs_to_tpu_torch.bamio import native as _native

            self.ensure_sites(pf, 0)
            a2 = self._finalize()
            self._ensure_iseq_arrays()
            flags = _native.candidate_gate(
                a2, self._iseq_off, self._iseq_blob, pf,
                min_bq, cfg.MIN_MQ, self.ref_seq, self.ref_start,
                min_coverage, snv_min_af, indel_min_af,
                alternative_base_num, select_indel_candidates,
            )
            if flags is not None:
                snv_pos = [int(p) for p in pf[(flags & 1) > 0]]
                indel_pos = [int(p) for p in pf[(flags & 2) > 0]]
                return snv_pos, indel_pos, {}
        groups = self._alt_groups(pf, min_bq, cfg.MIN_MQ)

        snv_pos, indel_pos = [], []
        infos = {}
        for p in sorted(groups):
            rb = self._ref_base(p)
            if rb not in "ACGT":
                continue
            pileup_dict = defaultdict(int)
            depth = 0
            for key, count in groups[p]:
                if key[0].upper() in "ACGT":
                    pileup_dict[key[0].upper()] += count
                    depth += count
                elif key[0] in "#*":
                    depth += count
                if len(key) > 1 and key[1] == "+":
                    ikey = (
                        "I" + key[0].upper() + key[2:].upper()
                        if select_indel_candidates
                        else "I"
                    )
                    pileup_dict[ikey] += count
                elif len(key) > 1 and key[1] == "-":
                    ikey = (
                        "D" + "N" * len(key[2:]) if select_indel_candidates else "D"
                    )
                    pileup_dict[ikey] += count
            denom = depth if depth > 0 else 1
            plist = sorted(pileup_dict.items(), key=lambda x: x[1], reverse=True)
            pass_snv = False
            pass_indel = False
            pass_depth = depth > min_coverage
            for item, count in plist:
                if item == rb:
                    continue
                elif item[0] in "ID":
                    if select_indel_candidates:
                        pass_indel = pass_indel or (
                            count / denom >= indel_min_af
                            and count >= alternative_base_num
                        )
                    continue
                pass_snv = pass_snv or (
                    count / denom >= snv_min_af and count >= alternative_base_num
                )
            if len(plist) > 1:
                af = plist[1][1] / denom
            else:
                af = 0.0
            if len(plist) >= 1 and plist[0][0] != rb:
                af = plist[0][1] / denom
            pass_af = (pass_snv or pass_indel) and pass_depth
            if not pass_af:
                continue
            # alt_list: per-entry uppercase counts, ref excluded
            alt_counter = defaultdict(int)
            for key, count in groups[p]:
                alt_counter[key.upper()] += count
            alt_list = sorted(alt_counter.items(), key=lambda x: x[1], reverse=True)
            alt_list = [(k, c) for k, c in alt_list if k != rb]
            info = CandidateInfo(
                pos=p, depth=depth, alt_info="", af=af,
                pass_snv=pass_snv, pass_indel=pass_indel, alt_list=alt_list,
                pileup_list=plist,
            )
            infos[p] = info
            if pass_snv:
                # extract_candidates:361-363: require an ACGT alt entry
                if any(len(k) == 1 and k in "ACGT" for k, _ in alt_list):
                    snv_pos.append(p)
            if select_indel_candidates and pass_indel:
                if any("+" in k or "-" in k for k, _ in alt_list):
                    indel_pos.append(p)
        return snv_pos, indel_pos, infos
