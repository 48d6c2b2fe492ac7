# Port copy of clairs_to_tpu/postcall/verdict_native.py.
"""ctypes binding for the native SNV verdict batch kernel.

Runs the per-site filter verdicts (hardfilter.HardFilterEngine /
haplotype.HaplotypeFilterEngine) as one C++ loop over the shared
FilterIndex arrays — bit-for-bit the same verdicts and Fisher p-values as
the Python per-site path (cross-validated by tests/test_verdict_native.py),
with far less per-site overhead.  SNV sites only; indels and the
--exact_reference_fisher parity mode stay on the Python path.
"""

import ctypes
import os
import subprocess
import threading

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_SO = os.path.join(_DIR, "libverdict_native.so")
_SRC = os.path.join(_DIR, "verdict_native.cpp")

_lib = None
_load_error = None
_lock = threading.Lock()


def _build():
    # -ffp-contract=off: the Fisher log-space accumulation must match
    # CPython's per-op libm arithmetic (no FMA contraction)
    # built under a temporary name and renamed: two processes may build at once
    tmp = f"{_SO}.{os.getpid()}.tmp"
    cmd = [
        "g++", "-O3", "-std=c++17", "-shared", "-fPIC",
        "-ffp-contract=off", "-o", tmp, _SRC,
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
        if not os.path.exists(_SO) or \
                os.path.getmtime(_SO) < os.path.getmtime(_SRC):
            _build()
        lib = ctypes.CDLL(_SO)
        lib.verdict_engine_create.restype = ctypes.c_void_p
        lib.verdict_engine_create.argtypes = (
            [ctypes.c_void_p] * 8 + [ctypes.c_int64] * 2          # table+cols
            + [ctypes.c_void_p] * 4 + [ctypes.c_int64] * 2        # nr stream
            + [ctypes.c_void_p] * 2 + [ctypes.c_int64]            # colkey
            + [ctypes.c_void_p] * 3                               # ins/onlyref
            + [ctypes.c_void_p] * 2 + [ctypes.c_int64] * 2        # rse
            + [ctypes.c_void_p] * 2 + [ctypes.c_int64]            # het
            + [ctypes.c_void_p] * 2 + [ctypes.c_int64]            # hom
            + [ctypes.c_int] * 3 + [ctypes.c_double] * 2
        )
        lib.verdict_engine_free.restype = None
        lib.verdict_engine_free.argtypes = [ctypes.c_void_p]
        lib.verdict_engine_run.restype = None
        lib.verdict_engine_run.argtypes = (
            [ctypes.c_void_p, ctypes.c_int64]
            + [ctypes.c_void_p] * 6
        )
        lib.verdict_fisher_exact.restype = ctypes.c_double
        lib.verdict_fisher_exact.argtypes = [ctypes.c_int64] * 4
        _lib = lib
    except Exception as e:     # pragma: no cover - build environment issues
        _load_error = e
        _lib = None
    return _lib


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
