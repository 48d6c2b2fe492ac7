# Port copy of clairs_to_tpu/postcall/verdict_native.py.
"""ctypes binding for the native SNV verdict batch kernel.

Runs the per-site filter verdicts (hardfilter.HardFilterEngine /
haplotype.HaplotypeFilterEngine) as one C++ loop over the shared
FilterIndex arrays — bit-for-bit the same verdicts and Fisher p-values as
the Python per-site path (cross-validated by tests/test_verdict_native.py),
with far less per-site overhead.  SNV sites only; indels and the
--exact_reference_fisher parity mode stay on the Python path.
``verdict_native.cpp`` is built on first use into
``build/kernels/libverdict.so`` through ``ops/_native.py``.
"""

import ctypes
import os

import numpy as np

from clairs_to_tpu_torch.ops import _native

_P, _I64, _I, _D = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, ctypes.c_double

# -ffp-contract=off: the Fisher log-space accumulation must match CPython's
# per-op libm arithmetic (no FMA contraction)
LIB = _native.Library(
    os.path.join(os.path.dirname(os.path.abspath(__file__)), "verdict_native.cpp"),
    "libverdict.so", {
        "verdict_engine_create": (_P, [_P] * 8 + [_I64] * 2          # table+cols
                                  + [_P] * 4 + [_I64] * 2            # nr stream
                                  + [_P] * 2 + [_I64]                # colkey
                                  + [_P] * 3                         # ins/onlyref
                                  + [_P] * 2 + [_I64] * 2            # rse
                                  + [_P] * 2 + [_I64]                # het
                                  + [_P] * 2 + [_I64]                # hom
                                  + [_I] * 3 + [_D] * 2),
        "verdict_engine_free": (None, [_P]),
        "verdict_engine_run": (None, [_P, _I64] + [_P] * 6),
        "verdict_fisher_exact": (_D, [_I64] * 4),
    }, command=_native.host_command("-ffp-contract=off"))


def get_lib():
    """The loaded verdict library, or None when it does not build
    (``LIB.error`` says why): the Python per-site path runs then."""
    return LIB.load_or_none()


def available():
    return get_lib() is not None


_ACGT_IDX = {"A": 0, "C": 1, "G": 2, "T": 3}


def _ptr(a):
    return a.ctypes.data_as(ctypes.c_void_p)


class NativeVerdictBatch:
    """Holds a C++ verdict engine over a built FilterIndex.

    mode: 0 = hard (4-verdict ilmn postfilter), 1 = haplotype (9 verdicts).
    hetero/homo_germline: [(pos0, alt_base)] with 1-base SNV alts only —
    the caller guarantees this (the CLI germline sets are SNV by
    construction).
    """

    def __init__(self, ix, mode, max_co_exist, disable_rse,
                 hetero_germline=(), homo_germline=(),
                 ont_min_bq=20.0, min_mq_thresh=20.0):
        lib = get_lib()
        assert lib is not None
        a = ix.a
        # normalize dtypes once (cheap: nr/rse streams are ~1-2% of table)
        self._keep = k = {}
        k["code"] = np.ascontiguousarray(a["code"], np.int8)
        k["bq"] = np.ascontiguousarray(a["bq"], np.int16)
        k["mq"] = np.ascontiguousarray(a["mq"], np.int16)
        k["hp"] = np.ascontiguousarray(a["hp"], np.int8)
        k["ikind"] = np.ascontiguousarray(a["ikind"], np.int8)
        k["read_id"] = np.ascontiguousarray(a["read_id"], np.int32)
        k["orig"] = np.ascontiguousarray(ix.orig, np.int32)
        k["col_start"] = np.ascontiguousarray(ix.col_start, np.int64)
        k["nr_pos"] = np.ascontiguousarray(ix.nr_pos, np.int64)
        k["nr_read"] = np.ascontiguousarray(ix.nr_read, np.int32)
        k["nr_token"] = np.ascontiguousarray(ix.nr_token, np.int64)
        k["nr_bare_del"] = np.ascontiguousarray(ix.nr_bare_del, np.uint8)
        k["colkey"] = np.ascontiguousarray(ix.colkey, np.int64)
        k["colkey_cnt"] = np.ascontiguousarray(ix.colkey_cnt, np.int64)
        k["cum_ins"] = np.ascontiguousarray(ix.cum_ins, np.float64)
        k["col_ins"] = np.ascontiguousarray(ix.col_ins, np.float64)
        k["col_only_ref"] = np.ascontiguousarray(ix.col_only_ref, np.uint8)
        k["rse_pos"] = np.ascontiguousarray(ix.rse_pos, np.int64)
        k["rse_read"] = np.ascontiguousarray(ix.rse_read, np.int32)

        def _germ(pairs):
            pos = np.array([p for (p, _a) in pairs], np.int64)
            alt = np.array([_ACGT_IDX.get(ab, 0) for (_p, ab) in pairs],
                           np.int8)
            return pos, alt

        k["het_pos"], k["het_alt"] = _germ(hetero_germline)
        k["hom_pos"], k["hom_alt"] = _germ(homo_germline)

        self._h = lib.verdict_engine_create(
            _ptr(k["code"]), _ptr(k["bq"]), _ptr(k["mq"]), _ptr(k["hp"]),
            _ptr(k["ikind"]), _ptr(k["read_id"]),
            _ptr(k["orig"]), _ptr(k["col_start"]),
            int(ix.p0), int(ix.p1),
            _ptr(k["nr_pos"]), _ptr(k["nr_read"]), _ptr(k["nr_token"]),
            _ptr(k["nr_bare_del"]), len(k["nr_pos"]), int(ix.T),
            _ptr(k["colkey"]), _ptr(k["colkey_cnt"]), len(k["colkey"]),
            _ptr(k["cum_ins"]), _ptr(k["col_ins"]), _ptr(k["col_only_ref"]),
            _ptr(k["rse_pos"]), _ptr(k["rse_read"]), len(k["rse_pos"]),
            int(ix.n_reads),
            _ptr(k["het_pos"]), _ptr(k["het_alt"]), len(k["het_pos"]),
            _ptr(k["hom_pos"]), _ptr(k["hom_alt"]), len(k["hom_pos"]),
            int(max_co_exist), 1 if disable_rse else 0, int(mode),
            float(ont_min_bq), float(min_mq_thresh),
        )
        self._lib = lib

    def run(self, site_pos, site_alt_idx, site_af):
        """-> (flags int32[n], p float64[n], table int32[n,4]).

        flags bits (1 = pass): 0 bq, 1 mq, 2 read_start_end, 3 co_exist,
        4 hetero, 5 homo, 6 hetero_both_side, 7 strand_bias,
        8 sequence_entropy, 9 phaseable."""
        n = len(site_pos)
        pos = np.ascontiguousarray(site_pos, np.int64)
        alt = np.ascontiguousarray(site_alt_idx, np.int8)
        af = np.ascontiguousarray(site_af, np.float64)
        flags = np.empty(n, np.int32)
        p = np.empty(n, np.float64)
        table = np.empty((n, 4), np.int32)
        self._lib.verdict_engine_run(
            self._h, n, _ptr(pos), _ptr(alt), _ptr(af),
            _ptr(flags), _ptr(p), _ptr(table))
        return flags, p, table

    def close(self):
        if self._h is not None:
            self._lib.verdict_engine_free(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
