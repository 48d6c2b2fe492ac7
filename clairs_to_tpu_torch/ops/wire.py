"""The engine's int16 wire encoding in one pass: ``csrc/wire.cpp``.

``pack`` writes a batch's packed AFF tensor (counts plus the coverage row)
and its NEG-minus-AFF delta straight into the engine's host buffers, padded
to whole device batches, and says whether every value fits in int16.  It
reads int32 C-contiguous views (``takes``), the ones the decoder hands over;
the engine casts any other integral input to one first.

The routine is compiled by the host's C++ compiler (OpenMP, no
``-march=native``) into ``build/kernels/libwire.so`` at the repository
root on first use, again whenever its source is newer, and loaded with
ctypes (``ops/_native.py``).  A failed build raises; there is no fallback.
"""

import ctypes

import numpy as np
import torch

from clairs_to_tpu_torch.ops import _native

VIEW = (33, 34)

_P = ctypes.c_void_p

LIB = _native.Library("wire.cpp", "libwire.so",
                      {"wire_pack_int32": (ctypes.c_int, [_P] * 4 + [ctypes.c_int64] * 2
                                           + [_P] * 2 + [ctypes.c_int])},
                      command=_native.host_command("-fopenmp"))


def build():
    """Compile ``csrc/wire.cpp`` if the library is missing or older than it,
    and load it; returns the routine.  Raises with the compiler's output if
    the build fails."""
    return LIB.fn()


def takes(x):
    """Whether ``x`` is a view ``pack`` reads: (n, 33, 34) int32, C-contiguous."""
    return (isinstance(x, np.ndarray) and x.dtype == np.int32 and x.ndim == 3
            and x.shape[1:] == VIEW and x.flags.c_contiguous)


def pack(x_aff, x_neg, cov_aff, cov_neg, packed, delta):
    """Writes the wire encoding of ``x_aff``/``x_neg`` (n, 33, 34) int32 and
    the int16 coverages (n,) into ``packed`` (rows, 34, 34) and ``delta``
    (rows, 33, 34), int16 CPU tensors with rows >= n; rows from n on are
    zeroed.  ``x_neg`` and ``delta`` are None where the views are one.  One
    pass on ``torch.get_num_threads()`` threads.  Returns False when a count
    or a delta does not fit in int16 (the outputs are then unusable)."""
    n, rows = x_aff.shape[0], packed.shape[0]
    if not (takes(x_aff) and (x_neg is None or (takes(x_neg) and x_neg.shape == x_aff.shape))):
        raise ValueError("wire.pack takes int32 C-contiguous (n, 33, 34) views")
    if (x_neg is None) != (delta is None):
        raise ValueError("wire.pack: a NEG view needs a delta buffer, and only then")
    outs = [packed] + ([] if delta is None else [delta])
    shapes = [(rows, 34, 34), (rows, *VIEW)]
    for t, shape in zip(outs, shapes):
        if t.dtype != torch.int16 or t.device.type != "cpu" or not t.is_contiguous() \
                or tuple(t.shape) != shape:
            raise ValueError(f"wire.pack: outputs are contiguous int16 CPU tensors {shape}")
    if rows < n:
        raise ValueError(f"wire.pack: {rows} output rows for {n} input rows")
    ca = np.ascontiguousarray(cov_aff, np.int16)
    cn = np.ascontiguousarray(cov_neg, np.int16)
    if ca.shape != (n,) or cn.shape != (n,):
        raise ValueError(f"wire.pack: coverages must have shape ({n},)")
    fn = build()
    return bool(fn(x_aff.ctypes.data, None if x_neg is None else x_neg.ctypes.data,
                   ca.ctypes.data, cn.ctypes.data, n, rows, packed.data_ptr(),
                   None if delta is None else delta.data_ptr(), torch.get_num_threads()))
