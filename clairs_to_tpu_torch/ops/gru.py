"""The BiGRU recurrence: a hand-written CUDA kernel and its plain version.

Counterpart of clairs_to_tpu/ops/gru_pallas.py.  ``gru_direction`` runs one
GRU direction over T steps with the kernel in ``csrc/gru.cu`` for CUDA
tensors, and with ``gru_direction_plain`` (a loop over T, the counterpart
of clairs_to_tpu/models/bigru.py::_gru_direction) for CPU tensors.  On a
CUDA tensor it launches the kernel or raises; it never falls back.

The kernel is compiled by ``nvcc`` for sm_90a into ``build/kernels/`` at the
repository root on first use and loaded with ctypes.  It reads W_hh^T in the
chunked layout of ``pack_w_hh``, which the wrapper builds for each launch.
"""

import ctypes
import os
import shutil
import subprocess
import threading

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG, "csrc", "gru.cu")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "kernels")
_SO = os.path.join(BUILD_DIR, "libgru.so")
MAX_HIDDEN = 256   # csrc/gru.cu: the largest H its shared memory holds
KC, GROUP = 16, 64  # csrc/gru.cu: W rows per chunk, hidden units per column group

_lib = None
_lock = threading.Lock()


def _nvcc():
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the GRU kernel is built from csrc/gru.cu "
                       "with the CUDA toolkit (set CUDA_HOME)")


def build(verbose=False):
    """Compile (when the source is newer than the library) and load the kernel.

    Returns the compiler's diagnostics (``-Xptxas -v`` when ``verbose``) or
    "" when the library was already current."""
    global _lib
    with _lock:
        log = ""
        if not os.path.exists(_SO) or os.path.getmtime(_SO) < os.path.getmtime(SOURCE):
            os.makedirs(BUILD_DIR, exist_ok=True)
            tmp = f"{_SO}.{os.getpid()}.tmp"
            cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
                   "-O3", "-shared", "-Xcompiler", "-fPIC", "-o", tmp, SOURCE]
            if verbose:
                cmd[1:1] = ["-Xptxas", "-v"]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
            os.replace(tmp, _SO)
            log = proc.stdout + proc.stderr
        if _lib is None:
            lib = ctypes.CDLL(_SO)
            lib.gru_direction_f32.restype = ctypes.c_int
            lib.gru_direction_f32.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 \
                + [ctypes.c_void_p]
            _lib = lib
        return log


def gru_direction_plain(x_gates, w_hh_t, b_hh, reverse=False):
    """One GRU direction as a loop over T.

    x_gates: (T, B, 3H) input gates; w_hh_t: (H, 3H); b_hh: (3H,).
    Returns (T, B, H) float32; ``reverse`` runs t = T-1 .. 0.
    """
    T, B, _ = x_gates.shape
    H = w_hh_t.shape[0]
    h = x_gates.new_zeros((B, H))
    out = x_gates.new_empty((T, B, H))
    for t in (range(T - 1, -1, -1) if reverse else range(T)):
        hg = torch.matmul(h, w_hh_t) + b_hh
        xr, xz, xn = x_gates[t].split(H, dim=-1)
        hr, hz, hn = hg.split(H, dim=-1)
        r = torch.sigmoid(xr + hr)
        z = torch.sigmoid(xz + hz)
        n = torch.tanh(xn + r * hn)
        h = (1.0 - z) * n + z * h
        out[t] = h
    return out


def split_tf32(x):
    """x = hi + lo to within 2**-22 of x: hi is x rounded to TF32 (10 mantissa
    bits, ties away from zero, as csrc/gru.cu rounds h), lo the rest rounded
    to TF32.  float32 in, two float32 tensors out."""
    def tf32(v):
        return ((v.view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)
    hi = tf32(x)
    return hi, tf32(x - hi)


def pack_w_hh(w_hh_t):
    """W_hh^T (H, 3H) split into TF32 hi and lo, in csrc/gru.cu's layout.

    Rows are padded with zeros to HK = round_up(H, 32) and each gate's
    columns to whole groups of GROUP units.  The result is a sequence of
    chunks (group g, rows c*KC .. c*KC+KC-1), so one bulk copy fills a stage
    of the kernel's ring.  In a chunk, for hi and lo, for each warpgroup's 32
    columns of the group (r, z and n: wgmma's N of 96) and each k-step of 8
    rows, the 96 x 8 block is stored as wgmma's K-major core matrices of 8
    columns x 4 rows: shape (groups, HK/KC, 2, 2, KC/8, 3, 4, 2, 8, 4).  A
    gate's 32 columns are ordered so that wgmma column 8 jb + 2 t + e, which
    lands in thread t of a row, is hidden unit 8 t + 2 jb + e: each thread
    then holds 8 consecutive units and reads and writes them 16 bytes at a time.
    """
    H = w_hh_t.shape[0]
    n_groups, hk = -(-H // GROUP), -(-H // 32) * 32
    w = w_hh_t.new_zeros((hk, 3, n_groups * GROUP))
    w[:H, :, :H] = w_hh_t.view(H, 3, H)
    # row k = (c, kb, kh, k4); unit = (group, warpgroup, t, jb, e)
    parts = torch.stack(split_tf32(w)).view(2, hk // KC, KC // 8, 2, 4, 3, n_groups, 2, 4, 4, 2)
    parts = parts.permute(6, 1, 0, 7, 2, 5, 9, 3, 8, 10, 4)
    return parts.reshape(n_groups, hk // KC, 2, 2, KC // 8, 3, 4, 2, 8, 4)


def gru_direction(x_gates, w_hh_t, b_hh, reverse=False):
    """One GRU direction: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors.  Same arguments as ``gru_direction_plain``."""
    tensors = (x_gates, w_hh_t, b_hh)
    if all(t.device.type == "cpu" for t in tensors):
        return gru_direction_plain(x_gates, w_hh_t, b_hh, reverse)
    if not all(t.is_cuda and t.device == x_gates.device for t in tensors):
        raise ValueError("gru_direction: all tensors must be on one CUDA device")
    if any(t.dtype != torch.float32 for t in tensors):
        raise TypeError("gru_direction: float32 tensors only")
    if x_gates.dim() != 3 or w_hh_t.dim() != 2 or b_hh.dim() != 1:
        raise ValueError("gru_direction: shapes (T, B, 3H), (H, 3H), (3H,)")
    T, B, H3 = x_gates.shape
    H = w_hh_t.shape[0]
    if w_hh_t.shape[1] != H3 or H3 != 3 * H or b_hh.shape[0] != H3:
        raise ValueError(f"gru_direction: shapes {tuple(x_gates.shape)}, "
                         f"{tuple(w_hh_t.shape)}, {tuple(b_hh.shape)} do not agree")
    if not 1 <= H <= MAX_HIDDEN:
        raise ValueError(f"gru_direction: hidden {H} outside 1..{MAX_HIDDEN}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("gru_direction: tensors must be contiguous")
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError("gru_direction: the kernel has no backward pass; train through "
                           "gru_direction_plain (use_kernel=False)")
    if _lib is None:
        build()
    out = torch.empty((T, B, H), dtype=torch.float32, device=x_gates.device)
    w_packed = pack_w_hh(w_hh_t)
    # the C entry point sets the kernel's attribute and launches on the CUDA
    # runtime's current device: make that the tensors' device, which with
    # several engine replicas is not the thread's default
    with torch.cuda.device(x_gates.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _lib.gru_direction_f32(x_gates.data_ptr(), w_packed.data_ptr(), b_hh.data_ptr(),
                                     out.data_ptr(), T, B, H, int(reverse), stream)
    if err != 0:
        raise RuntimeError(f"gru_direction kernel launch failed: cudaError {err}")
    with _count_lock:   # a server launches from several threads
        gru_direction.launches += 1
    return out


gru_direction.launches = 0
_count_lock = threading.Lock()


def bigru_layer(x, p, hidden, use_kernel=True):
    """One bidirectional GRU layer: (B, T, in) -> (B, T, 2*hidden).

    Counterpart of gru_pallas.bigru_layer_pallas.  ``p`` maps "ih", "hh",
    "ih_reverse", "hh_reverse" to {"weight", "bias"} with torch.nn.GRU
    layouts.  The input-gate GEMM is a plain matmul; the recurrence runs
    through ``gru_direction`` (``use_kernel=False``: the plain version).
    """
    direction = gru_direction if use_kernel else gru_direction_plain
    xt = x.transpose(0, 1)   # (T, B, in)

    def run(ih, hh, reverse):
        gates = torch.matmul(xt, p[ih]["weight"].t()) + p[ih]["bias"]
        w_hh_t = p[hh]["weight"].t().contiguous()
        assert w_hh_t.shape[0] == hidden
        return direction(gates, w_hh_t, p[hh]["bias"].contiguous(), reverse=reverse)

    fwd = run("ih", "hh", False)
    bwd = run("ih_reverse", "hh_reverse", True)
    return torch.cat([fwd, bwd], dim=-1).transpose(0, 1)
