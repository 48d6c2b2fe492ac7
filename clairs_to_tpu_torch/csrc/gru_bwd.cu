// Backward of one GRU direction over T steps, h0 = 0, for Hopper (sm_90a).
//
// The gradient of csrc/gru.cu's function.  The TPU kernel that one replaces,
// clairs_to_tpu/ops/gru_pallas.py::gru_direction_pallas, has no backward: the
// JAX package trains through clairs_to_tpu/models/bigru.py::_gru_direction,
// whose lax.scan XLA differentiates.  This kernel is that scan's backward.
//
// Forward, per step t (t = 0 .. T-1, or T-1 .. 0 when reverse), h_prev the
// h of the step before (0 at the first):
//   hg = h_prev . W_hh^T + b_hh
//   r = sigmoid(x_r + hg_r); z = sigmoid(x_z + hg_z); n = tanh(x_n + r * hg_n)
//   h = (1 - z) * n + z * h_prev
// Backward, one sweep against the forward's order, dh carried from the step
// after:
//   dh += grad_out[t]
//   dpre_n = dh (1 - z)(1 - n^2);  dpre_z = dh (h_prev - n) z (1 - z)
//   dpre_r = dpre_n hg_n r (1 - r)
//   grad_x_gates[t] = (dpre_r, dpre_z, dpre_n);  grad_hg[t] = (dpre_r, dpre_z, dpre_n r)
//   dh = dh z + grad_hg[t] . W_hh
// hg is rebuilt from the forward's h (h_prev . W_hh^T, the first of the two
// per-step products); the caller (ops/gru.py) forms dW_hh^T = sum_t
// h_prev^T . grad_hg[t] and db_hh = sum grad_hg with torch.matmul and
// torch.sum, as XLA does outside the scan.
//
// Bound on an H100 SXM (NVIDIA data sheet: 67 TFLOP/s fp32 outside the tensor
// cores, 3.35 TB/s HBM).  At T = 33, B = 800, H = 192 the two products are
// 2 x 2*T*B*3H*H = 11.7 GFLOP (0.174 ms in fp32), and x_gates, h and grad_out
// read once with grad_x_gates and grad_hg written once move 223 MB (0.067 ms):
// the kernel is bound by operations.  At H = 128, 5.2 GFLOP (0.077 ms) against
// 149 MB (0.044 ms).  The sweep is serial in T, so a launch also pays T steps
// of latency: the design keeps each step's critical path short and spreads a
// batch of 256 rows over the whole card.
//
// Design: W resident in a thread-block cluster, grad_hg exchanged through
// distributed shared memory.
//  * A cluster of C CTAs owns R batch rows for all T steps; CTA c of the
//    cluster owns the hidden columns J = [c HC, c HC + HC), HC = ceil(H / C)
//    (padded to HCP, a multiple of 4, with columns that are never stored).
//    It keeps in shared memory, loaded once, the 3 HC columns of W_hh^T that
//    rebuild hg[:, J] (all k) and the HC columns of W_hh that give
//    dh_prev[:, J] (all m): 2 * 3H * HC floats, 108 KiB at H = 192, C = 8
//    (120 KiB with the padding below).  W_hh[m][j] is W_hh^T[j][m], so both
//    come from W_hh^T.
//  * Eight adjacent threads (an octet, lane s = 0..7) share a tile of 4
//    rows x 4 columns.  In each product lane s takes every eighth k (m) for
//    the whole tile: per k, one word of h (grad_hg) per row and one float4
//    of W per gate feed 4 x 4 x 3 (4 x 4) FMAs, so each 128-byte wavefront
//    of shared memory feeds 3 (2) warp-wide FMAs.  Three shuffle rounds then
//    reduce the octet's partial sums and scatter them, so that lane s holds
//    row s / 2, columns 2 (s % 2) and 2 (s % 2) + 1 of the tile: dh, z and
//    the carry of those (row, j) stay in its registers from one step to the
//    next.  W rows are padded to 4 mod 8 floats, so the octet's eight k (m)
//    rows fall in 32 different banks.
//  * h_prev of the step comes from the forward's stored h, so no CTA needs
//    another's h: each CTA stages the full R x H rows of h_prev by cp.async
//    once the cluster barrier says every thread is done with the last ones;
//    the copy runs under the second product.  x_gates and grad_out of the
//    next step are loaded into registers at the same time.
//  * Only grad_hg crosses CTAs: each thread stores its (row, j) grad_hg at
//    (j, H + j, 2H + j) into every CTA of the cluster (st to distributed
//    shared memory, the R x 3H buffer of the step, two buffers), then the
//    cluster passes one barrier (barrier.cluster arrive.release /
//    wait.acquire; the stores of grad_x_gates and grad_hg to global memory
//    and the next step's loads go between the two) and every CTA runs
//    dh_prev[:, J] = grad_hg . W_hh[:, J] from its own copy.  Two buffers
//    make one cluster barrier a step enough: a CTA writes step s + 2 into a
//    buffer only after every CTA has arrived at step s + 1's barrier, which
//    each does after its step-s product.
//  * The wrapper (ops/gru.py::bwd_geometry) sizes the grid: C from H (the
//    least power of two that leaves room for 16 rows a cluster), R from B and
//    the number of clusters the card holds at once, so that B = 256 fills one
//    wave (13 clusters of 20 rows at H = 192 on an H100 80GB HBM3, which
//    runs 15 clusters of 8 such CTAs at once).  Larger B runs in waves.
//  * Full fp32 FMAs in a fixed order, no atomics: bitwise deterministic, and
//    within 1e-5 of the plain version without the forward's hi/lo split.
//  * Rows past B read zeros and are never stored: their dh stays 0.
//    Columns past H (the padding, and the last CTA's when C does not divide
//    H) are zero in W and never stored or sent.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int TR = 4, TC = 4;        // a tile: 4 rows x 4 columns, one octet of threads
constexpr int KS = 8;                // threads of an octet: each takes every eighth k (m)
constexpr int MAX_HIDDEN = 256;
constexpr int MAX_THREADS = 256;
constexpr int SMEM_LIMIT = 232448;   // dynamic shared memory a CTA may use on sm_90

__host__ __device__ constexpr int round_up(int x, int m) { return (x + m - 1) / m * m; }
// a row stride of 4 mod 8 floats: the rows k .. k + 7 start in 8 different
// 16-byte bank groups
__host__ __device__ constexpr int bank_stride(int n) { return n + (12 - n % 8) % 8; }

// Shared-memory layout of one CTA, in floats (ops/gru.py::bwd_smem_bytes
// mirrors it): W_hh^T columns [H][SK] (gate g's HCP columns at g HCP),
// W_hh columns [3H][SM], h_prev [R][HS], grad_hg [2][R][MS].  HS and MS are
// 4 mod 8, so the rows of two tiles in one warp read other banks.
struct Layout {
  int HCP, SK, SM, HS, MS, R;
  __host__ __device__ Layout(int H, int C, int rows)
      : HCP(round_up((H + C - 1) / C, TC)), SK(bank_stride(3 * HCP)), SM(bank_stride(HCP)),
        HS(round_up(H, 8) + 4), MS(round_up(3 * H, 8) + 4), R(rows) {}
  __host__ __device__ int floats(int H) const {
    return H * SK + 3 * H * SM + R * HS + 2 * R * MS;
  }
  __host__ __device__ int threads() const { return R / TR * (HCP / TC) * KS; }
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;" ::: "memory");
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release;" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire;" ::: "memory");
}

__device__ __forceinline__ float sigmoidf_(float x) {
  return 1.0f / (1.0f + expf(-x));
}

__device__ __forceinline__ float comp(const float4& v, int c) {
  return c == 0 ? v.x : c == 1 ? v.y : c == 2 ? v.z : v.w;
}

// One shuffle round of the octet's reduce-scatter: of the pairs (lo[i],
// hi[i]) this lane keeps lo when `up` is false (hi when true), sends the
// other to lane ^ `bit` (which keeps the other) and adds what it receives.
template <int N>
__device__ __forceinline__ void halve(const float (&lo)[N], const float (&hi)[N], bool up,
                                      int bit, unsigned mask, float (&out)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
    out[i] = (up ? hi[i] : lo[i]) + __shfl_xor_sync(mask, up ? lo[i] : hi[i], bit);
}

// a[r][c][g] holds this lane's partial sums of the tile's G values a (row,
// column); returns in out[e][g] the octet's sums of row s / 2, column
// 2 (s % 2) + e, s = this lane's place in the octet.  The three rounds split
// rows 0-1 / 2-3 (lanes 4 apart), then row 0 / 1 (2 apart), then columns
// 0-1 / 2-3 (1 apart).
template <int G>
__device__ __forceinline__ void octet_scatter(const float (&a)[TR][TC][G], int s, unsigned mask,
                                              float (&out)[2][G]) {
  float lo[2 * TC * G], hi[2 * TC * G], b[2 * TC * G];
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int c = 0; c < TC; ++c)
#pragma unroll
      for (int g = 0; g < G; ++g)
        lo[(r * TC + c) * G + g] = a[r][c][g], hi[(r * TC + c) * G + g] = a[r + 2][c][g];
  halve(lo, hi, s & 4, 4, mask, b);
  float lo2[TC * G], hi2[TC * G], b2[TC * G];
#pragma unroll
  for (int i = 0; i < TC * G; ++i) lo2[i] = b[i], hi2[i] = b[TC * G + i];
  halve(lo2, hi2, s & 2, 2, mask, b2);
  float lo3[2 * G], hi3[2 * G], b3[2 * G];
#pragma unroll
  for (int i = 0; i < 2 * G; ++i) lo3[i] = b2[i], hi3[i] = b2[2 * G + i];
  halve(lo3, hi3, s & 1, 1, mask, b3);
#pragma unroll
  for (int e = 0; e < 2; ++e)
#pragma unroll
    for (int g = 0; g < G; ++g) out[e][g] = b3[e * G + g];
}

// Stores a lane's two columns of the three gates at dst, dst + H, dst + 2H:
// one float2 each where both columns are inside and `pair` says 8 bytes
// line up, else a float each for the columns inside.
__device__ __forceinline__ void put3(float* dst, int H, const float (&a)[2], const float (&b)[2],
                                     const float (&c)[2], const bool (&own)[2], bool pair) {
  if (own[1] && pair) {
    *reinterpret_cast<float2*>(dst) = make_float2(a[0], a[1]);
    *reinterpret_cast<float2*>(dst + H) = make_float2(b[0], b[1]);
    *reinterpret_cast<float2*>(dst + 2 * H) = make_float2(c[0], c[1]);
    return;
  }
#pragma unroll
  for (int e = 0; e < 2; ++e)
    if (own[e]) dst[e] = a[e], dst[H + e] = b[e], dst[2 * H + e] = c[e];
}

__global__ void __launch_bounds__(MAX_THREADS)
gru_direction_backward_kernel(const float* __restrict__ xg,    // (T, B, 3H)
                              const float* __restrict__ wt,    // (H, 3H): W_hh^T
                              const float* __restrict__ bhh,   // (3H)
                              const float* __restrict__ h,     // (T, B, H): forward output
                              const float* __restrict__ gout,  // (T, B, H)
                              float* __restrict__ gx,          // (T, B, 3H)
                              float* __restrict__ ghg,         // (T, B, 3H)
                              int T, int B, int H, int reverse, int rows, bool vec) {
  cg::cluster_group cluster = cg::this_cluster();
  const int C = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const Layout L(H, C, rows);
  const int H3 = 3 * H, HC = (H + C - 1) / C, HCP = L.HCP, R = L.R;
  extern __shared__ __align__(16) float smem[];
  float* wts = smem;                 // [H][SK]: W_hh^T[k][g H + j0 + c] at g HCP + c
  float* ws = wts + H * L.SK;        // [3H][SM]: W_hh[m][j0 + c] = W_hh^T[j0 + c][m]
  float* hb = ws + H3 * L.SM;        // [R][HS]: h_prev rows
  float* gb = hb + R * L.HS;         // [2][R][MS]: grad_hg rows of the whole cluster

  // zeros everywhere first: the padding of W and rows past B (never
  // written) must read as 0 and not as whatever was left there
  for (int e = threadIdx.x; e < L.floats(H); e += blockDim.x) smem[e] = 0.0f;
  __syncthreads();

  const int j0 = rank * HC;
  const int ncols = max(0, min(HC, H - j0));   // columns of this CTA inside H
  const int s8 = threadIdx.x % KS;             // place in the octet
  const int tile = threadIdx.x / KS;
  const int tc = tile % (HCP / TC), tr = tile / (HCP / TC);   // the octet's tile
  const int row_l = tr * TR + s8 / 2;          // this lane's row in the cluster
  const int col_l = tc * TC + 2 * (s8 % 2);    // its first column in the CTA
  const int b = (blockIdx.x / C) * R + row_l;  // its batch row
  const int row0 = (blockIdx.x / C) * R;       // the cluster's first batch row
  const int nrows = min(R, B - row0);          // of them inside B
  bool own[2];                                 // (row, column e) inside B and H
#pragma unroll
  for (int e = 0; e < 2; ++e) own[e] = b < B && col_l + e < ncols;
  // both columns inside: one 8-byte access for the pair where H and HC are
  // even (then j0 + col_l and every row offset are even)
  const bool pair = H % 2 == 0 && HC % 2 == 0;
  const int warp0 = threadIdx.x & ~31;         // the last warp may be short
  const unsigned mask = blockDim.x - warp0 >= 32 ? 0xffffffffu
                                                 : (1u << (blockDim.x - warp0)) - 1u;

  // W, once for all T steps
  for (int e = threadIdx.x; e < H * 3 * ncols; e += blockDim.x) {
    const int c = e % ncols, kg = e / ncols;   // kg = 3 k + g
    cp_async4(wts + (kg / 3) * L.SK + (kg % 3) * HCP + c,
              wt + (size_t)(kg / 3) * H3 + (kg % 3) * H + j0 + c);
  }
  for (int e = threadIdx.x; e < ncols * H3; e += blockDim.x) {
    const int m = e % H3, c = e / H3;
    cp_async4(ws + m * L.SM + c, wt + (size_t)(j0 + c) * H3 + m);
  }
  cp_async_commit();

  // h_prev of sweep step s: rows of h[tp], or zeros at the direction's first
  // step, where h_prev is h0 = 0
  auto stage_h = [&](int s) {
    const int t = reverse ? s : T - 1 - s;
    const int tp = reverse ? t + 1 : t - 1;
    if (tp < 0 || tp >= T) {
      for (int e = threadIdx.x; e < nrows * H; e += blockDim.x) hb[(e / H) * L.HS + e % H] = 0.0f;
      return;
    }
    const float* src = h + ((size_t)tp * B + row0) * H;
    if (vec) {
      const int n4 = H / 4;
      for (int e = threadIdx.x; e < nrows * n4; e += blockDim.x)
        cp_async16(hb + (e / n4) * L.HS + 4 * (e % n4), src + (size_t)(e / n4) * H + 4 * (e % n4));
    } else {
      for (int e = threadIdx.x; e < nrows * H; e += blockDim.x)
        cp_async4(hb + (e / H) * L.HS + e % H, src + e);
    }
    cp_async_commit();
  };

  // this lane's (row, column j0 + col_l + e): inputs of the step, biases, carry
  float xr[2] = {0, 0}, xz[2] = {0, 0}, xn[2] = {0, 0}, go[2] = {0, 0};
  auto load_x = [&](int s) {
    const size_t row = (size_t)(reverse ? s : T - 1 - s) * B + b;
    const float* x = xg + row * H3 + j0 + col_l;
    const float* g = gout + row * H + j0 + col_l;
    if (own[1] && pair) {
      const float2 r2 = *reinterpret_cast<const float2*>(x);
      const float2 z2 = *reinterpret_cast<const float2*>(x + H);
      const float2 n2 = *reinterpret_cast<const float2*>(x + 2 * H);
      const float2 g2 = *reinterpret_cast<const float2*>(g);
      xr[0] = r2.x, xr[1] = r2.y, xz[0] = z2.x, xz[1] = z2.y;
      xn[0] = n2.x, xn[1] = n2.y, go[0] = g2.x, go[1] = g2.y;
      return;
    }
#pragma unroll
    for (int e = 0; e < 2; ++e)
      if (own[e]) xr[e] = x[e], xz[e] = x[H + e], xn[e] = x[2 * H + e], go[e] = g[e];
  };
  float br[2] = {0, 0}, bz[2] = {0, 0}, bn[2] = {0, 0};
  float carry[2] = {0, 0};  // dh . z + grad_hg . W_hh: the next step's dh less its grad_out
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    if (col_l + e < ncols) {
      const int j = j0 + col_l + e;
      br[e] = bhh[j], bz[e] = bhh[H + j], bn[e] = bhh[2 * H + j];
    }
  }

  stage_h(0);
  load_x(0);
  // every CTA of the cluster has started (and zeroed its buffers) before
  // any CTA writes into another's shared memory
  cluster.sync();

  for (int s = 0; s < T; ++s) {
    float* gcur = gb + (s & 1) * R * L.MS;
    cp_async_wait_all();
    __syncthreads();  // W (at s = 0) and h_prev of step s are in place for every thread

    // hg = h_prev . W_hh^T for the tile's 4 rows x 4 columns of each gate;
    // this lane's share is k = s8, s8 + 8, ...
    float acc[TR][TC][3];
#pragma unroll
    for (int r = 0; r < TR; ++r)
#pragma unroll
      for (int c = 0; c < TC; ++c) acc[r][c][0] = acc[r][c][1] = acc[r][c][2] = 0.0f;
    const float* hrow = hb + tr * TR * L.HS;
    const float* wcol = wts + tc * TC;
#pragma unroll 4
    for (int k = s8; k < H; k += KS) {
      float hv[TR];
#pragma unroll
      for (int r = 0; r < TR; ++r) hv[r] = hrow[r * L.HS + k];
#pragma unroll
      for (int g = 0; g < 3; ++g) {
        const float4 w4 = *reinterpret_cast<const float4*>(wcol + k * L.SK + g * HCP);
#pragma unroll
        for (int r = 0; r < TR; ++r)
#pragma unroll
          for (int c = 0; c < TC; ++c) acc[r][c][g] = fmaf(hv[r], comp(w4, c), acc[r][c][g]);
      }
    }
    float hg[2][3];
    octet_scatter(acc, s8, mask, hg);

    // the gates again, their gradients, and grad_hg sent to the cluster
    float dpr[2], dpz[2], dpn[2], dhn[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const float hp = own[e] ? hb[row_l * L.HS + j0 + col_l + e] : 0.0f;
      const float hn = hg[e][2] + bn[e];
      const float rr = sigmoidf_(xr[e] + (hg[e][0] + br[e]));
      const float zg = sigmoidf_(xz[e] + (hg[e][1] + bz[e]));
      const float ng = tanhf(xn[e] + rr * hn);
      const float dh = go[e] + carry[e];
      dpn[e] = dh * (1.0f - zg) * (1.0f - ng * ng);
      dpz[e] = dh * (hp - ng) * (zg * (1.0f - zg));
      dpr[e] = dpn[e] * hn * (rr * (1.0f - rr));
      dhn[e] = dpn[e] * rr;
      carry[e] = dh * zg;
    }
    for (int p = 0; p < C; ++p)
      put3(cluster.map_shared_rank(gcur, p) + row_l * L.MS + j0 + col_l, H, dpr, dpz, dhn,
           own, pair);
    cluster_arrive();
    const size_t o = ((size_t)(reverse ? s : T - 1 - s) * B + b) * H3 + j0 + col_l;
    put3(gx + o, H, dpr, dpz, dpn, own, pair);
    put3(ghg + o, H, dpr, dpz, dhn, own, pair);
    if (s + 1 < T) load_x(s + 1);
    cluster_wait();  // grad_hg of step s complete in every CTA's buffer
    // every thread of this CTA is done with h_prev: stage the next step's
    if (s + 1 < T) stage_h(s + 1);

    // dh_prev = dh z + grad_hg . W_hh for the tile; this lane's share is
    // m = s8, s8 + 8, ...
    float ac[TR][TC][1];
#pragma unroll
    for (int r = 0; r < TR; ++r)
#pragma unroll
      for (int c = 0; c < TC; ++c) ac[r][c][0] = 0.0f;
    const float* grow = gcur + tr * TR * L.MS;
#pragma unroll 4
    for (int m = s8; m < H3; m += KS) {
      float gv[TR];
#pragma unroll
      for (int r = 0; r < TR; ++r) gv[r] = grow[r * L.MS + m];
      const float4 w4 = *reinterpret_cast<const float4*>(ws + m * L.SM + tc * TC);
#pragma unroll
      for (int r = 0; r < TR; ++r)
#pragma unroll
        for (int c = 0; c < TC; ++c) ac[r][c][0] = fmaf(gv[r], comp(w4, c), ac[r][c][0]);
    }
    float dprev[2][1];
    octet_scatter(ac, s8, mask, dprev);
    carry[0] += dprev[0][0], carry[1] += dprev[1][0];
  }
  // no CTA touches another's shared memory after the last barrier, so each
  // may exit on its own
}

// The launch's shape, or cudaErrorInvalidValue: a cluster of 1 to 16 CTAs
// (a power of two), a whole number of 4-row tiles, at most MAX_THREADS
// threads and SMEM_LIMIT bytes.  Sets the kernel's attributes.
cudaError_t configure(int H, int cluster, int rows, cudaLaunchConfig_t* cfg,
                      cudaLaunchAttribute* attr) {
  if (H < 1 || H > MAX_HIDDEN || cluster < 1 || cluster > 16 || (cluster & (cluster - 1)) ||
      rows < TR || rows % TR)
    return cudaErrorInvalidValue;
  const Layout L(H, cluster, rows);
  const size_t smem = sizeof(float) * (size_t)L.floats(H);
  if (L.threads() > MAX_THREADS || smem > (size_t)SMEM_LIMIT) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(gru_direction_backward_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_LIMIT);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(gru_direction_backward_kernel,
                               cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return err;
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3(cluster);
  cfg->blockDim = dim3(L.threads());
  cfg->dynamicSmemBytes = smem;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = cluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  return cudaSuccess;
}

}  // namespace

// How many clusters of `cluster` CTAs, each with the shared memory and
// threads of `rows` rows a cluster at hidden size H, the current device runs
// at once: *out (0 when it cannot run one).  Returns a cudaError_t.
extern "C" int gru_direction_backward_max_clusters(int H, int cluster, int rows, int* out) {
  *out = 0;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err = configure(H, cluster, rows, &cfg, &attr);
  if (err == cudaSuccess) err = cudaOccupancyMaxActiveClusters(out, gru_direction_backward_kernel, &cfg);
  return static_cast<int>(err);
}

// C interface for ctypes.  w_hh_t is W_hh^T (H, 3H), contiguous; h is the
// forward's output.  Writes grad_x_gates and grad_hg (T, B, 3H).  The grid is
// ceil(B / rows) clusters of `cluster` CTAs (ops/gru.py::bwd_geometry).
// Launches on `stream` and returns a cudaError_t (0 on success); the caller
// has checked shapes, types and contiguity.
extern "C" int gru_direction_backward_f32(const void* x_gates, const void* w_hh_t,
                                          const void* b_hh, const void* h, const void* grad_out,
                                          void* grad_x_gates, void* grad_hg, int T, int B, int H,
                                          int reverse, int cluster, int rows, void* stream) {
  if (T == 0 || B == 0) return 0;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err = configure(H, cluster, rows, &cfg, &attr);
  if (err != cudaSuccess) return static_cast<int>(err);
  cfg.gridDim = dim3((B + rows - 1) / rows * cluster);
  cfg.stream = static_cast<cudaStream_t>(stream);
  const bool vec = H % 4 == 0 && reinterpret_cast<uintptr_t>(h) % 16 == 0;
  err = cudaLaunchKernelEx(&cfg, gru_direction_backward_kernel,
                           static_cast<const float*>(x_gates), static_cast<const float*>(w_hh_t),
                           static_cast<const float*>(b_hh), static_cast<const float*>(h),
                           static_cast<const float*>(grad_out), static_cast<float*>(grad_x_gates),
                           static_cast<float*>(grad_hg), T, B, H, reverse, rows, vec);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
