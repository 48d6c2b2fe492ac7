"""The BiGRU recurrence: hand-written CUDA kernels and their plain versions.

Counterpart of clairs_to_tpu/ops/gru_pallas.py.  ``gru_direction`` runs one
GRU direction over T steps with the kernel in ``csrc/gru.cu`` for CUDA
tensors, and with ``gru_direction_plain`` (a loop over T, the counterpart
of clairs_to_tpu/models/bigru.py::_gru_direction) for CPU tensors.  Asked
for a gradient it runs through ``GRUDirection``, whose backward is the
kernel in ``csrc/gru_bwd.cu`` (``gru_direction_backward``) for CUDA tensors
and the explicit loop ``gru_direction_backward_plain`` for CPU ones: the
JAX package trains through the same function with XLA's gradient of its
``lax.scan``.  On a CUDA tensor each wrapper launches its kernel or raises;
it never falls back.

The kernels are compiled by ``nvcc`` for sm_90a into ``build/kernels/`` at
the repository root on first use and loaded with ctypes (``ops/_native.py``).
The forward reads
W_hh^T in the chunked layout of ``pack_w_hh``, which the wrapper builds for
each launch; the backward reads W_hh^T as it is, and runs on a grid of
thread-block clusters that ``bwd_geometry`` sizes.
"""

import ctypes
import threading

import torch
from torch.autograd.function import once_differentiable

from clairs_to_tpu_torch.ops import _native

MAX_HIDDEN = 256   # csrc/gru.cu and csrc/gru_bwd.cu: the largest H they take
KC, GROUP = 16, 64  # csrc/gru.cu: W rows per chunk, hidden units per column group

_P, _I = ctypes.c_void_p, ctypes.c_int
# the forward and the backward; each library's first entry point is its launch
LIBS = {"gru": _native.Library("gru.cu", "libgru.so",
                               {"gru_direction_f32": (_I, [_P] * 4 + [_I] * 4 + [_P])}),
        "gru_bwd": _native.Library(
            "gru_bwd.cu", "libgru_bwd.so",
            {"gru_direction_backward_f32": (_I, [_P] * 7 + [_I] * 6 + [_P]),
             "gru_direction_backward_max_clusters": (_I, [_I] * 3 + [ctypes.POINTER(_I)])})}


def build(names=("gru", "gru_bwd"), verbose=False):
    """Compile (each library whose source is newer than it, one nvcc each,
    all at once) and load the kernels named: "gru" (the forward) and
    "gru_bwd" (the backward).

    Returns the compiler's diagnostics (``-Xptxas -v`` when ``verbose``),
    or "" when every library was already current.  Raises if one fails."""
    return _native.build(*(LIBS[name] for name in names), verbose=verbose)


def _entry(name, entry=None):
    """The loaded function ``entry`` of library ``name`` (its launch by
    default), built first if need be."""
    return LIBS[name].fn(entry)


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


# csrc/gru_bwd.cu's launch: clusters of CTAs, each CTA a slice of hidden
# columns (padded to a multiple of 4), each octet of threads a tile of 4
# batch rows x 4 columns
BWD_TILE = 4
BWD_MAX_THREADS = 256
BWD_SMEM_LIMIT = 232448   # dynamic shared memory a CTA may use on sm_90 (227 KiB)
BWD_MAX_ROWS = 64         # rows a cluster
BWD_MIN_ROWS = 16         # rows a cluster must be able to hold at the chosen size
BWD_CLUSTERS = (1, 2, 4, 8, 16)   # 16: the non-portable size, which sm_90 allows


def _cdiv(a, b):
    return -(-a // b)


def _bank_stride(n):
    """n rounded up to 4 mod 8 (csrc/gru_bwd.cu's ``bank_stride``)."""
    return n + (12 - n % 8) % 8


def bwd_cols(H, cluster):
    """Hidden columns a CTA owns, and the same padded to a whole tile."""
    cols = _cdiv(H, cluster)
    return cols, _cdiv(cols, BWD_TILE) * BWD_TILE


def bwd_smem_bytes(H, cluster, rows):
    """Shared memory of one CTA of the backward kernel, as csrc/gru_bwd.cu's
    ``Layout`` lays it out in float32: the CTA's columns of W_hh^T (H rows of
    3 padded column counts, the row padded to 4 mod 8 floats) and of W_hh
    (3H rows of the padded column count, padded to 4 mod 8), then h_prev
    (rows x (H rounded up to 8, + 4)) and two buffers of grad_hg (rows x (3H
    rounded up to 8, + 4))."""
    hcp = bwd_cols(H, cluster)[1]
    return 4 * (H * _bank_stride(3 * hcp) + 3 * H * _bank_stride(hcp)
                + rows * (_cdiv(H, 8) * 8 + 4) + 2 * rows * (_cdiv(3 * H, 8) * 8 + 4))


def bwd_threads(H, cluster, rows):
    """Threads of one CTA: 8 for each tile of 4 rows x 4 columns."""
    return rows * bwd_cols(H, cluster)[1] // 2


def bwd_max_rows(H, cluster):
    """The most rows a cluster of ``cluster`` CTAs can own at hidden size H
    (a multiple of 4, at most BWD_MAX_ROWS; 0 when not even 4 fit)."""
    for rows in range(BWD_MAX_ROWS, 0, -BWD_TILE):
        if (bwd_threads(H, cluster, rows) <= BWD_MAX_THREADS
                and bwd_smem_bytes(H, cluster, rows) <= BWD_SMEM_LIMIT):
            return rows
    return 0


def bwd_cluster(H):
    """The cluster size of the backward kernel at hidden size H: the least
    of BWD_CLUSTERS whose CTAs, W held resident, still have room for
    BWD_MIN_ROWS rows a cluster."""
    for cluster in BWD_CLUSTERS:
        if bwd_max_rows(H, cluster) >= BWD_MIN_ROWS:
            return cluster
    raise ValueError(f"gru_direction_backward: no cluster holds hidden {H}")


def bwd_geometry(H, B, active_clusters):
    """The backward kernel's grid for B rows at hidden size H on a card that
    runs ``active_clusters`` clusters at once (counted at the largest rows a
    cluster, so at least as many at fewer).

    The rows a cluster are the fewest (a multiple of 4) that cover B in as
    few waves of ``active_clusters`` clusters as the largest row count
    allows: B=256 at H=192 on 16 clusters is 16 rows a cluster, one wave.
    Cluster n owns rows [n rows, n rows + rows) and its CTA c the hidden
    columns [c cols, c cols + cols), both clipped to B and H.  Raises
    RuntimeError when the card runs no cluster of this shape."""
    cluster = bwd_cluster(H)
    max_rows = bwd_max_rows(H, cluster)
    if active_clusters < 1:
        raise RuntimeError(f"gru_direction_backward: the card cannot run a cluster of "
                           f"{cluster} CTAs with {bwd_smem_bytes(H, cluster, max_rows)} "
                           f"bytes of shared memory each (hidden {H})")
    waves = _cdiv(_cdiv(B, max_rows), active_clusters)
    rows = min(max_rows, _cdiv(_cdiv(B, waves * active_clusters), BWD_TILE) * BWD_TILE)
    clusters = _cdiv(B, rows)
    return dict(cluster=cluster, cols=bwd_cols(H, cluster)[0], rows=rows, clusters=clusters,
                ctas=clusters * cluster, threads=bwd_threads(H, cluster, rows),
                smem_bytes=bwd_smem_bytes(H, cluster, rows),
                waves=_cdiv(clusters, active_clusters), active_clusters=active_clusters)


_active = {}   # (H, device index) -> clusters of the backward kernel's shape the card runs at once


def bwd_launch_geometry(H, B, device):
    """``bwd_geometry`` on the CUDA ``device``, whose clusters at once the
    kernel's library reports (cudaOccupancyMaxActiveClusters), cached per
    (H, device).  The query is not made inside a CUDA graph's capture: an
    eager step fills the cache first (train.py's warm-up does)."""
    device = torch.device(device)
    key = (H, device.index if device.index is not None else torch.cuda.current_device())
    if key not in _active:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError(f"gru_direction_backward: no occupancy known for hidden {H} on "
                               f"device {key[1]}; run one step eagerly before capturing one")
        fn = _entry("gru_bwd", "gru_direction_backward_max_clusters")
        cluster = bwd_cluster(H)
        n = ctypes.c_int(0)
        with torch.cuda.device(key[1]):
            err = fn(H, cluster, bwd_max_rows(H, cluster), ctypes.byref(n))
        if err != 0:
            raise RuntimeError(f"gru_direction_backward: cluster of {cluster} CTAs at hidden "
                               f"{H} refused: cudaError {err}")
        _active[key] = n.value
    return bwd_geometry(H, B, _active[key])


def _check(name, tensors, shapes):
    """Raise unless ``tensors`` are contiguous float32 on one CUDA device with
    the (T, B, 3H) / (H, 3H) / (3H,) / (T, B, H) ``shapes`` given by
    "x", "w", "b", "h"; returns (T, B, H)."""
    if not all(t.is_cuda and t.device == tensors[0].device for t in tensors):
        raise ValueError(f"{name}: all tensors must be on one CUDA device")
    if any(t.dtype != torch.float32 for t in tensors):
        raise TypeError(f"{name}: float32 tensors only")
    x_gates, w_hh_t = tensors[0], tensors[1]
    if x_gates.dim() != 3 or w_hh_t.dim() != 2:
        raise ValueError(f"{name}: shapes (T, B, 3H), (H, 3H), (3H,)")
    T, B, H3 = x_gates.shape
    H = w_hh_t.shape[0]
    want = {"x": (T, B, 3 * H), "w": (H, 3 * H), "b": (3 * H,), "h": (T, B, H)}
    if any(tuple(t.shape) != want[k] for t, k in zip(tensors, shapes)):
        raise ValueError(f"{name}: shapes {[tuple(t.shape) for t in tensors]} do not agree")
    if not 1 <= H <= MAX_HIDDEN:
        raise ValueError(f"{name}: hidden {H} outside 1..{MAX_HIDDEN}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name}: tensors must be contiguous")
    return T, B, H


def _forward(x_gates, w_hh_t, b_hh, reverse):
    """The forward without autograd: the kernel for CUDA tensors, the plain
    version for CPU tensors."""
    tensors = (x_gates, w_hh_t, b_hh)
    if all(t.device.type == "cpu" for t in tensors):
        return gru_direction_plain(x_gates, w_hh_t, b_hh, reverse)
    T, B, H = _check("gru_direction", tensors, "xwb")
    fn = _entry("gru")
    out = torch.empty((T, B, H), dtype=torch.float32, device=x_gates.device)
    w_packed = pack_w_hh(w_hh_t)
    # the C entry point sets the kernel's attribute and launches on the CUDA
    # runtime's current device: make that the tensors' device, which with
    # several engine replicas is not the thread's default
    with torch.cuda.device(x_gates.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(x_gates.data_ptr(), w_packed.data_ptr(), b_hh.data_ptr(), out.data_ptr(),
                 T, B, H, int(reverse), stream)
    if err != 0:
        raise RuntimeError(f"gru_direction kernel launch failed: cudaError {err}")
    with _count_lock:   # a server launches from several threads
        gru_direction.launches += 1
    return out


def gru_direction(x_gates, w_hh_t, b_hh, reverse=False):
    """One GRU direction: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors.  Same arguments as ``gru_direction_plain``.
    When grad mode is on and an input requires grad it runs through
    ``GRUDirection``, whose backward is ``gru_direction_backward``.
    ``gru_direction.launches`` counts the kernel's launches as the host
    makes them: a launch captured in a CUDA graph counts once, at capture,
    and not at each replay."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x_gates, w_hh_t, b_hh)):
        return GRUDirection.apply(x_gates, w_hh_t, b_hh, reverse)
    return _forward(x_gates, w_hh_t, b_hh, reverse)


gru_direction.launches = 0
_count_lock = threading.Lock()


def _weight_grads(out, grad_hg, reverse):
    """(dW_hh^T, db_hh) from the forward's ``out`` and grad_hg (T, B, 3H):
    dW_hh^T = sum_t h_prev[t]^T grad_hg[t], where h_prev is out one step
    back in the direction's order and 0 at its first step (so that step
    adds nothing), and db_hh = sum grad_hg."""
    H, H3 = out.shape[-1], grad_hg.shape[-1]
    prev, grad = (out[1:], grad_hg[:-1]) if reverse else (out[:-1], grad_hg[1:])
    grad_w = torch.matmul(prev.reshape(-1, H).t(), grad.reshape(-1, H3))
    return grad_w, grad_hg.sum(dim=(0, 1))


@torch.no_grad()
def _bptt_plain(x_gates, w_hh_t, b_hh, out, grad_out, reverse):
    """The plain version of the backward kernel: (grad_x_gates, grad_hg)."""
    T, B, _ = x_gates.shape
    H = w_hh_t.shape[0]
    grad_x = torch.empty_like(x_gates)
    grad_hg = torch.empty_like(x_gates)
    zero = x_gates.new_zeros((B, H))
    dh = zero
    for t in (range(T) if reverse else range(T - 1, -1, -1)):
        tp = t + 1 if reverse else t - 1
        h_prev = out[tp] if 0 <= tp < T else zero
        hg = torch.matmul(h_prev, w_hh_t) + b_hh
        xr, xz, xn = x_gates[t].split(H, dim=-1)
        hr, hz, hn = hg.split(H, dim=-1)
        r = torch.sigmoid(xr + hr)
        z = torch.sigmoid(xz + hz)
        n = torch.tanh(xn + r * hn)
        dh = dh + grad_out[t]
        dpre_n = dh * (1.0 - z) * (1.0 - n * n)
        dpre_z = dh * (h_prev - n) * (z * (1.0 - z))
        dpre_r = dpre_n * hn * (r * (1.0 - r))
        grad_x[t] = torch.cat([dpre_r, dpre_z, dpre_n], dim=-1)
        grad_hg[t] = torch.cat([dpre_r, dpre_z, dpre_n * r], dim=-1)
        dh = dh * z + torch.matmul(grad_hg[t], w_hh_t.t())
    return grad_x, grad_hg


def gru_direction_backward_plain(x_gates, w_hh_t, b_hh, out, grad_out, reverse=False):
    """The gradients of ``gru_direction_plain`` by an explicit loop over T
    against the forward's order (back-propagation through time, no autograd).

    ``out`` is the forward's output and ``grad_out`` the gradient on it,
    both (T, B, H).  Returns (grad_x_gates (T, B, 3H), grad_w_hh_t (H, 3H),
    grad_b_hh (3H,)).  Each step rebuilds the gates from the h before it,
    then dh -> (dpre_r, dpre_z, dpre_n) -> dh of the step before."""
    grad_x, grad_hg = _bptt_plain(x_gates, w_hh_t, b_hh, out, grad_out, reverse)
    return (grad_x, *_weight_grads(out, grad_hg, reverse))


def gru_direction_backward_kernel(x_gates, w_hh_t, b_hh, out, grad_out, reverse=False):
    """The backward kernel alone: (grad_x_gates, grad_hg), each (T, B, 3H),
    where grad_hg is the gradient on h_prev . W_hh^T + b_hh; its plain
    version for CPU tensors.  ``gru_direction_backward`` turns grad_hg into
    the weight gradients."""
    tensors = (x_gates, w_hh_t, b_hh, out, grad_out)
    if all(t.device.type == "cpu" for t in tensors):
        return _bptt_plain(*tensors, reverse)
    T, B, H = _check("gru_direction_backward", tensors, "xwbhh")
    fn = _entry("gru_bwd")
    geo = bwd_launch_geometry(H, B, x_gates.device)
    grad_x = torch.empty_like(x_gates)
    grad_hg = torch.empty_like(x_gates)
    with torch.cuda.device(x_gates.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(x_gates.data_ptr(), w_hh_t.data_ptr(), b_hh.data_ptr(), out.data_ptr(),
                 grad_out.data_ptr(), grad_x.data_ptr(), grad_hg.data_ptr(),
                 T, B, H, int(reverse), geo["cluster"], geo["rows"], stream)
    if err != 0:
        raise RuntimeError(f"gru_direction_backward kernel launch failed: cudaError {err}")
    with _count_lock:
        gru_direction_backward.launches += 1
    return grad_x, grad_hg


def gru_direction_backward(x_gates, w_hh_t, b_hh, out, grad_out, reverse=False):
    """The gradients of ``gru_direction``: the CUDA kernel, then dW_hh^T and
    db_hh as one matmul and one sum, for CUDA tensors; the plain version for
    CPU tensors.  Same arguments and results as
    ``gru_direction_backward_plain``.  ``gru_direction_backward.launches``
    counts the backward kernel's launches as the host makes them: once at a
    CUDA graph's capture, not at each replay."""
    grad_x, grad_hg = gru_direction_backward_kernel(x_gates, w_hh_t, b_hh, out, grad_out,
                                                    reverse)
    return (grad_x, *_weight_grads(out, grad_hg, reverse))


gru_direction_backward.launches = 0


class GRUDirection(torch.autograd.Function):
    """``gru_direction`` with its gradient.  Forward: the forward kernel on
    CUDA tensors, ``gru_direction_plain`` on CPU ones; it keeps the inputs
    and the output.  Backward: ``gru_direction_backward`` (the backward
    kernel on CUDA tensors, ``gru_direction_backward_plain`` on CPU ones).
    A kernel that does not build or launch raises: there is no fallback."""

    @staticmethod
    def forward(ctx, x_gates, w_hh_t, b_hh, reverse):
        out = _forward(x_gates, w_hh_t, b_hh, reverse)
        ctx.save_for_backward(x_gates, w_hh_t, b_hh, out)
        ctx.reverse = reverse
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, grad_out):
        x_gates, w_hh_t, b_hh, out = ctx.saved_tensors
        grads = gru_direction_backward(x_gates, w_hh_t, b_hh, out, grad_out.contiguous(),
                                       ctx.reverse)
        return (*grads, None)


def bigru_layer(x, p, hidden, use_kernel=True):
    """One bidirectional GRU layer: (B, T, in) -> (B, T, 2*hidden).

    Counterpart of gru_pallas.bigru_layer_pallas.  ``p`` maps "ih", "hh",
    "ih_reverse", "hh_reverse" to {"weight", "bias"} with torch.nn.GRU
    layouts.  The input-gate GEMM is a plain matmul; the recurrence runs
    through ``gru_direction``, and its gradient through the backward kernel
    (``use_kernel=False``: the plain version, under autograd when training).
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
