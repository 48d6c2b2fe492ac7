# Port copy of clairs_to_tpu/realign/__init__.py.
"""ctypes binding for the native realignment library.

Replaces the reference's ctypes loading of its vendored realigner/dbg .so
files (src/realign_reads.py:56-83).  ``realign_native.cpp`` is built on
first use into ``build/kernels/librealign.so`` through ``ops/_native.py``.
"""

import ctypes
import os

import numpy as np

from clairs_to_tpu_torch.ops import _native

LIB = _native.Library(
    os.path.join(os.path.dirname(os.path.abspath(__file__)), "realign_native.cpp"),
    "librealign.so", {
        "dbg_consensus": (ctypes.c_void_p, [ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int]),
        "realign_free": (None, [ctypes.c_void_p]),
        "realign_reads": (ctypes.c_void_p, [ctypes.c_char_p, ctypes.c_int64, ctypes.c_char_p,
                                            ctypes.c_char_p, ctypes.c_void_p,
                                            ctypes.POINTER(ctypes.c_int)]),
    }, command=_native.host_command())


def get_lib():
    """The loaded realignment library, or None when it does not build
    (``LIB.error`` says why): no read is realigned then."""
    return LIB.load_or_none()


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
