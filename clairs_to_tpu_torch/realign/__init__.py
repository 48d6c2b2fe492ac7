# Port copy of clairs_to_tpu/realign/__init__.py.
"""ctypes binding for the native realignment library.

Replaces the reference's ctypes loading of its vendored realigner/dbg .so
files (src/realign_reads.py:56-83).
"""

import ctypes
import os
import subprocess

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_SO = os.path.join(_DIR, "librealign_native.so")
_SRC = os.path.join(_DIR, "realign_native.cpp")

_lib = None
_load_error = None


def get_lib():
    global _lib, _load_error
    if _lib is not None or _load_error is not None:
        return _lib
    try:
        if not os.path.exists(_SO) or os.path.getmtime(_SO) < os.path.getmtime(_SRC):
            # built under a temporary name and renamed: two processes may
            # build at once
            tmp = f"{_SO}.{os.getpid()}.tmp"
            subprocess.run(
                ["g++", "-O3", "-std=c++17", "-shared", "-fPIC", "-o", tmp, _SRC],
                check=True, capture_output=True,
            )
            os.replace(tmp, _SO)
        lib = ctypes.CDLL(_SO)
        lib.dbg_consensus.restype = ctypes.c_void_p
        lib.dbg_consensus.argtypes = [ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int]
        lib.realign_free.restype = None
        lib.realign_free.argtypes = [ctypes.c_void_p]
        lib.realign_reads.restype = ctypes.c_void_p
        lib.realign_reads.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, ctypes.c_char_p, ctypes.c_char_p,
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_int),
        ]
        _lib = lib
    except Exception as e:  # pragma: no cover
        _load_error = e
    return _lib


def available() -> bool:
    return get_lib() is not None


def get_consensus(ref_window: str, reads, min_bq: int = 15):
    """Candidate haplotypes via de Bruijn assembly (<=500)."""
    lib = get_lib()
    if lib is None:
        return [ref_window]
    ptr = lib.dbg_consensus(ref_window.encode(), "\n".join(reads).encode(), min_bq)
    try:
        return ctypes.string_at(ptr).decode().split("\n")
    finally:
        lib.realign_free(ptr)


def realign_reads(ref_window: str, ref_start0: int, seqs, haplotypes):
    """Realign reads to haplotypes; returns (positions (n,), cigars list).

    positions are new 0-based leftmost ref coordinates (-1 = could not
    realign, keep original alignment).
    """
    lib = get_lib()
    if lib is None:
        return np.full(len(seqs), -1, np.int64), [""] * len(seqs)
    out_pos = np.empty(len(seqs), np.int64)
    n_out = ctypes.c_int(0)
    ptr = lib.realign_reads(
        ref_window.encode(), int(ref_start0),
        "\n".join(seqs).encode(), "\n".join(haplotypes).encode(),
        out_pos.ctypes.data_as(ctypes.c_void_p), ctypes.byref(n_out),
    )
    try:
        cigars = ctypes.string_at(ptr).decode().split("\n")
    finally:
        lib.realign_free(ptr)
    return out_pos, cigars
