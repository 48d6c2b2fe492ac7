// One GRU direction over T steps, h0 = 0, for Hopper (sm_90a).
//
// Replaces the TPU kernel clairs_to_tpu/ops/gru_pallas.py::gru_direction_pallas
// (body _gru_scan_kernel).  Per step t:
//   hg = h . W_hh^T + b_hh
//   r = sigmoid(x_r + hg_r); z = sigmoid(x_z + hg_z); n = tanh(x_n + r * hg_n)
//   h = (1 - z) * n + z * h;  out[t] = h
// The gate order is r, z, n and the reset gate multiplies the *biased* hidden
// branch, as in torch.nn.GRU.
//
// Design.  On the TPU the grid ran in order and h sat in VMEM scratch across
// the time steps.  Here one CTA owns a tile of ROWS batch rows for the whole
// T loop, with h in shared memory, so nothing carries over between CTAs.
// Thread j (blockDim.x == H) owns hidden column j: each step it accumulates
// the tile's three gate pre-activations for column j in fp32 FMAs (3 * ROWS
// accumulators in registers), then applies the gate math and writes its h
// values to shared memory and to out.  h is stored k-major (h_s[k*ROWS + r])
// so the k loop reads the tile's ROWS values of h[:, k] as float4 broadcasts.
// W_hh^T is read from global memory through the read-only path: at H = 192 it
// is 432 KiB in fp32, more than a CTA's 227 KB of shared memory, and it stays
// resident in the 50 MB L2 across CTAs and steps.  Full fp32, no TF32, so the
// kernel matches the plain version at 1e-5.
//
// Bound on an H100 SXM (NVIDIA data sheet: 67 TFLOP/s fp32 without tensor
// cores, 3.35 TB/s HBM).  One direction at T = 33, B = 8192, H = 192 does
// 2*T*B*H*3H = 59.8 GFLOP of FMA (0.89 ms) and moves x_gates plus out,
// T*B*4H*4 B = 0.83 GB (0.25 ms): it is bound by operations.  At H = 128:
// 26.6 GFLOP (0.40 ms) against 0.55 GB (0.17 ms).  wgmma (3xTF32 or split
// bf16 for fp32 accuracy), TMA, clusters sharing W through distributed shared
// memory, and one launch for all four directions are left for later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int ROWS = 16;       // batch rows per CTA; a multiple of 4 (float4 reads)
constexpr int MAX_HIDDEN = 256;  // blockDim.x == H; 3*ROWS accumulators need the registers

__device__ __forceinline__ float sigmoidf_(float x) {
  return 1.0f / (1.0f + expf(-x));
}

__global__ void __launch_bounds__(MAX_HIDDEN)
gru_direction_kernel(const float* __restrict__ xg,    // (T, B, 3H)
                     const float* __restrict__ w,     // (H, 3H) = W_hh^T
                     const float* __restrict__ bhh,   // (3H)
                     float* __restrict__ out,         // (T, B, H)
                     int T, int B, int H, int reverse) {
  extern __shared__ float4 h_s4[];                    // (H, ROWS) as float4s
  float* h_s = reinterpret_cast<float*>(h_s4);
  const int j = threadIdx.x;
  const int H3 = 3 * H;
  const int b0 = blockIdx.x * ROWS;
  const int nrows = min(ROWS, B - b0);

  for (int i = j; i < ROWS * H; i += blockDim.x) h_s[i] = 0.0f;
  const float br = bhh[j], bz = bhh[H + j], bn = bhh[2 * H + j];
  float h_own[ROWS];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) h_own[r] = 0.0f;
  __syncthreads();

  for (int s = 0; s < T; ++s) {
    const int t = reverse ? T - 1 - s : s;
    float ar[ROWS], az[ROWS], an[ROWS];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) ar[r] = az[r] = an[r] = 0.0f;

    const float* wk = w + j;
    for (int k = 0; k < H; ++k, wk += H3) {
      const float wr = __ldg(wk), wz = __ldg(wk + H), wn = __ldg(wk + 2 * H);
      const float4* hk = h_s4 + k * (ROWS / 4);
#pragma unroll
      for (int q = 0; q < ROWS / 4; ++q) {
        const float4 hv = hk[q];
        const float hq[4] = {hv.x, hv.y, hv.z, hv.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = 4 * q + e;
          ar[r] = fmaf(hq[e], wr, ar[r]);
          az[r] = fmaf(hq[e], wz, az[r]);
          an[r] = fmaf(hq[e], wn, an[r]);
        }
      }
    }
    __syncthreads();  // every thread has read the old h before it is replaced

    const size_t row0 = (size_t)t * B + b0;
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      if (r < nrows) {
        const float* x = xg + (row0 + r) * H3;
        const float rg = sigmoidf_(x[j] + (ar[r] + br));
        const float zg = sigmoidf_(x[H + j] + (az[r] + bz));
        const float ng = tanhf(x[2 * H + j] + rg * (an[r] + bn));
        const float hn = (1.0f - zg) * ng + zg * h_own[r];
        h_own[r] = hn;
        h_s[j * ROWS + r] = hn;
        out[(row0 + r) * H + j] = hn;
      }
    }
    __syncthreads();  // the new h is complete before the next step reads it
  }
}

}  // namespace

// C interface for ctypes.  Launches on `stream` and returns cudaGetLastError()
// (0 on success); the caller has checked shapes, types and contiguity.
extern "C" int gru_direction_f32(const void* x_gates, const void* w_hh_t,
                                 const void* b_hh, void* out, int T, int B,
                                 int H, int reverse, void* stream) {
  if (T == 0 || B == 0) return 0;
  if (H < 1 || H > MAX_HIDDEN) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((B + ROWS - 1) / ROWS);
  const size_t smem = sizeof(float) * ROWS * H;
  gru_direction_kernel<<<grid, H, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x_gates), static_cast<const float*>(w_hh_t),
      static_cast<const float*>(b_hh), static_cast<float*>(out), T, B, H,
      reverse);
  return static_cast<int>(cudaGetLastError());
}
