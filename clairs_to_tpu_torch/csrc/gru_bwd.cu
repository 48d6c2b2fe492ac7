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
// 149 MB (0.044 ms).
//
// Design: right and simple first, in the manner of the first forward kernel.
//  * One CTA owns ROWS = 8 batch rows for all T steps (B = 800 is 100 CTAs),
//    so the carried dh never leaves the CTA.  Thread j owns hidden column j:
//    it computes column j of the three gates for its 8 rows, so dh, z and
//    the carry of (row, j) stay in its registers from one step to the next.
//  * Full fp32 FMAs, no TF32, so the kernel meets the plain version at 1e-5
//    without the forward's hi/lo split.
//  * W_hh^T (for the rebuild of hg) and W_hh (for dh . W_hh) are read every
//    step, both from L2 through shared memory: chunks of KC rows of W_hh^T,
//    then of 3 KC rows of W_hh, stream through two buffers with cp.async, the
//    next chunk in flight while the CTA multiplies the current one.  Each
//    element of W that reaches shared memory feeds the CTA's 8 rows.
//  * h_prev and grad_hg of the step sit in shared memory, k-major, so the
//    inner loops read the 8 rows of one k as two float4 broadcasts.
//  * Rows past B read zeros and are never stored: their dh stays 0.
// Shared memory (bytes): 4 * (2 * KC * 3H + 4 * ROWS * H): 98,304 at H = 192,
// 131,072 at H = 256.  The tensor cores (3xTF32 wgmma as in csrc/gru.cu),
// W resident in a cluster's shared memory and more rows a CTA are left for
// later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int ROWS = 8;          // batch rows per CTA: two float4s of a k
constexpr int KC = 16;           // W_hh^T rows per chunk; a W_hh chunk is 3 * KC rows
constexpr int MAX_HIDDEN = 256;  // blockDim.x == round_up(H, 32)

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

// Every copy of this thread but the newest group has landed.
__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;" ::: "memory");
}

__device__ __forceinline__ float sigmoidf_(float x) {
  return 1.0f / (1.0f + expf(-x));
}

// Start the copy of chunk i of the sequence that every step reads: n_kc
// chunks of W_hh^T (KC rows of 3H floats), then n_kc chunks of W_hh (3 KC
// rows of H floats).  A chunk is a contiguous run of its matrix.  Commits
// one cp.async group (empty past the last chunk, so that waiting for all but
// the newest group always means the current chunk).
__device__ __forceinline__ void issue_chunk(float* dst, const float* wt, const float* w, int i,
                                            int total, int n_kc, int H, bool vec) {
  if (i < total) {
    const int q = i % (2 * n_kc);
    const int k0 = (q < n_kc ? q : q - n_kc) * KC;
    const int rows = min(KC, H - k0);  // of W_hh^T; 3 * rows of W_hh
    const float* src = q < n_kc ? wt + (size_t)k0 * 3 * H : w + (size_t)3 * k0 * H;
    const int n = rows * 3 * H;
    if (vec) {
      for (int e = threadIdx.x; e < n / 4; e += blockDim.x) cp_async16(dst + 4 * e, src + 4 * e);
    } else {
      for (int e = threadIdx.x; e < n; e += blockDim.x) cp_async4(dst + e, src + e);
    }
  }
  cp_async_commit();
}

__global__ void __launch_bounds__(MAX_HIDDEN)
gru_direction_backward_kernel(const float* __restrict__ xg,    // (T, B, 3H)
                              const float* __restrict__ wt,    // (H, 3H): W_hh^T
                              const float* __restrict__ w,     // (3H, H): W_hh
                              const float* __restrict__ bhh,   // (3H)
                              const float* __restrict__ h,     // (T, B, H): forward output
                              const float* __restrict__ gout,  // (T, B, H)
                              float* __restrict__ gx,          // (T, B, 3H)
                              float* __restrict__ ghg,         // (T, B, 3H)
                              int T, int B, int H, int reverse, bool vec) {
  extern __shared__ __align__(16) float smem[];
  const int H3 = 3 * H;
  const int chunk_floats = KC * H3;
  float* hp = smem + 2 * chunk_floats;  // h_prev, [k][row]
  float* gs = hp + ROWS * H;            // grad_hg, [m][row]
  const int n_kc = (H + KC - 1) / KC;
  const int total = 2 * n_kc * T;
  const int j = threadIdx.x;
  const bool active = j < H;
  const int b0 = blockIdx.x * ROWS;

  float br = 0.0f, bz = 0.0f, bn = 0.0f;
  if (active) br = bhh[j], bz = bhh[H + j], bn = bhh[2 * H + j];
  float carry[ROWS];  // dh . z + grad_hg . W_hh: the next step's dh less its grad_out
#pragma unroll
  for (int r = 0; r < ROWS; ++r) carry[r] = 0.0f;

  int i = 0;  // chunks consumed
  issue_chunk(smem, wt, w, 0, total, n_kc, H, vec);
  // Consume the next chunk: wait for it, start the one after into the other
  // buffer (whose last reader finished before the barrier that ended it),
  // run body on it, and leave it free once every thread is done.
  auto consume = [&](auto body) {
    issue_chunk(smem + ((i + 1) & 1) * chunk_floats, wt, w, i + 1, total, n_kc, H, vec);
    cp_async_wait_one();
    __syncthreads();
    if (active) body(smem + (i & 1) * chunk_floats);
    __syncthreads();
    ++i;
  };

  for (int s = 0; s < T; ++s) {
    const int t = reverse ? s : T - 1 - s;
    const int tp = reverse ? t + 1 : t - 1;  // h_prev is h[tp]
    const bool has_prev = tp >= 0 && tp < T;
    float xr[ROWS], xz[ROWS], xn[ROWS], go[ROWS], hv[ROWS];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      const int b = b0 + r;
      const bool ok = active && b < B;
      const size_t row = (size_t)t * B + b;
      xr[r] = ok ? xg[row * H3 + j] : 0.0f;
      xz[r] = ok ? xg[row * H3 + H + j] : 0.0f;
      xn[r] = ok ? xg[row * H3 + 2 * H + j] : 0.0f;
      go[r] = ok ? gout[row * H + j] : 0.0f;
      hv[r] = ok && has_prev ? h[((size_t)tp * B + b) * H + j] : 0.0f;
    }
    if (active) {
      float4* hp4 = reinterpret_cast<float4*>(hp + j * ROWS);
      hp4[0] = make_float4(hv[0], hv[1], hv[2], hv[3]);
      hp4[1] = make_float4(hv[4], hv[5], hv[6], hv[7]);
    }
    // hp is complete before the first chunk's barrier, which every thread
    // passes after writing it.

    // hg = h_prev . W_hh^T, column j of each gate, for the CTA's rows
    float ar[ROWS], az[ROWS], an[ROWS];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) ar[r] = az[r] = an[r] = 0.0f;
    for (int c = 0; c < n_kc; ++c) {
      consume([&](const float* chunk) {
        const int k0 = c * KC, kn = min(KC, H - k0);
#pragma unroll 4
        for (int kk = 0; kk < kn; ++kk) {
          const float* wk = chunk + kk * H3;
          const float wr = wk[j], wz = wk[H + j], wn = wk[2 * H + j];
          const float4* hk = reinterpret_cast<const float4*>(hp + (k0 + kk) * ROWS);
          const float4 p = hk[0], q = hk[1];
          const float hq[ROWS] = {p.x, p.y, p.z, p.w, q.x, q.y, q.z, q.w};
#pragma unroll
          for (int r = 0; r < ROWS; ++r) {
            ar[r] = fmaf(hq[r], wr, ar[r]);
            az[r] = fmaf(hq[r], wz, az[r]);
            an[r] = fmaf(hq[r], wn, an[r]);
          }
        }
      });
    }

    // the gates again, and their gradients
    if (active) {
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        const float hn = an[r] + bn;
        const float rg = sigmoidf_(xr[r] + (ar[r] + br));
        const float zg = sigmoidf_(xz[r] + (az[r] + bz));
        const float ng = tanhf(xn[r] + rg * hn);
        const float dh = go[r] + carry[r];
        const float dpn = dh * (1.0f - zg) * (1.0f - ng * ng);
        const float dpz = dh * (hv[r] - ng) * (zg * (1.0f - zg));
        const float dpr = dpn * hn * (rg * (1.0f - rg));
        const float dhn = dpn * rg;
        carry[r] = dh * zg;
        gs[j * ROWS + r] = dpr;
        gs[(H + j) * ROWS + r] = dpz;
        gs[(2 * H + j) * ROWS + r] = dhn;
        if (b0 + r < B) {
          const size_t o = ((size_t)t * B + b0 + r) * H3;
          gx[o + j] = dpr, gx[o + H + j] = dpz, gx[o + 2 * H + j] = dpn;
          ghg[o + j] = dpr, ghg[o + H + j] = dpz, ghg[o + 2 * H + j] = dhn;
        }
      }
    }
    // gs is complete before the next chunk's barrier

    // dh_prev = dh z + grad_hg . W_hh, column j
    for (int c = 0; c < n_kc; ++c) {
      consume([&](const float* chunk) {
        const int m0 = 3 * c * KC, mn = min(3 * KC, H3 - m0);
#pragma unroll 4
        for (int mm = 0; mm < mn; ++mm) {
          const float wv = chunk[mm * H + j];
          const float4* gm = reinterpret_cast<const float4*>(gs + (m0 + mm) * ROWS);
          const float4 p = gm[0], q = gm[1];
          const float gq[ROWS] = {p.x, p.y, p.z, p.w, q.x, q.y, q.z, q.w};
#pragma unroll
          for (int r = 0; r < ROWS; ++r) carry[r] = fmaf(gq[r], wv, carry[r]);
        }
      });
    }
    // the last chunk's closing barrier: every thread is done with hp and gs
    // before the next step writes them
  }
}

}  // namespace

// C interface for ctypes.  w_hh_t is W_hh^T (H, 3H) and w_hh is W_hh (3H, H),
// both contiguous; h is the forward's output.  Writes grad_x_gates and
// grad_hg (T, B, 3H).  Launches on `stream` and returns a cudaError_t (0 on
// success); the caller has checked shapes, types and contiguity.
extern "C" int gru_direction_backward_f32(const void* x_gates, const void* w_hh_t,
                                          const void* w_hh, const void* b_hh, const void* h,
                                          const void* grad_out, void* grad_x_gates,
                                          void* grad_hg, int T, int B, int H, int reverse,
                                          void* stream) {
  if (T == 0 || B == 0) return 0;
  if (H < 1 || H > MAX_HIDDEN) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = sizeof(float) * (2 * (size_t)KC * 3 * H + 4 * (size_t)ROWS * H);
  const bool vec = H % 4 == 0 && (reinterpret_cast<uintptr_t>(w_hh_t) |
                                  reinterpret_cast<uintptr_t>(w_hh)) % 16 == 0;
  cudaError_t err = cudaFuncSetAttribute(
      gru_direction_backward_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  gru_direction_backward_kernel<<<(B + ROWS - 1) / ROWS, (H + 31) / 32 * 32, smem,
                                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x_gates), static_cast<const float*>(w_hh_t),
      static_cast<const float*>(w_hh), static_cast<const float*>(b_hh),
      static_cast<const float*>(h), static_cast<const float*>(grad_out),
      static_cast<float*>(grad_x_gates), static_cast<float*>(grad_hg), T, B, H, reverse, vec);
  return static_cast<int>(cudaGetLastError());
}
