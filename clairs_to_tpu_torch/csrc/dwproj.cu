// The CvT's depthwise projection on its one-row image, for Hopper (sm_90a):
// a 3-tap depthwise convolution and the BatchNorm's per-channel scale and
// shift, forward and backward.
//
// It replaces no TPU kernel: the JAX package leaves this convolution to XLA
// (clairs_to_tpu/models/cvt.py).  It was added because the library runs it
// as general depthwise-conv kernels (torch's conv_depthwise2d_* for
// contiguous inputs, cuDNN's grouped kernels for channels-last ones) with the
// BatchNorm as separate elementwise and sum kernels: some 3.5 to 4 ms of a
// 46 ms training step on an H100, for work whose bytes take 75 us.
//
// Every CvT tensor is an NCHW image one row high, and each projection's
// 3x3 kernel pads 1 in H, so only the kernel's middle row k[c][t] = w[c][0][1][t]
// meets data.  With stride s (1 for the queries, 2 for keys and values):
//   conv[b][c][j] = sum_{t<3} k[c][t] x[b][c][j s + t - 1]   (0 outside [0, W))
//   y[b][c][j]    = conv[b][c][j] scale[c] + shift[c]
// and, with g the gradient on y,
//   dx[b][c][i]  = scale[c] sum_{t, j: j s + t - 1 = i} k[c][t] g[b][c][j]
//   dk[c][t]     = scale[c] sum_{b,j} g[b][c][j] x[b][c][j s + t - 1]
//   dscale[c]    = sum_{b,j} g[b][c][j] conv[b][c][j]
//   dshift[c]    = sum_{b,j} g[b][c][j]
// The wrapper (ops/dwproj.py) computes scale and shift from the BatchNorm's
// leaves and lets autograd carry dscale and dshift back to them.
//
// Bound on an H100 SXM (3.35 TB/s HBM): a few FLOP a byte, so bytes.  The
// forward reads x once and writes y once; the backward reads x and g once
// and writes dx once, recomputing conv instead of storing it.  The flagship
// SNV CvT's 26 projections at B = 800 move 93 MB in the forward (28 us) and
// 145 MB in the backward (43 us) a training step; each launch moves 1 to 8 MB,
// so launch latency and the card's fill weigh as much as the bytes.
//
// Design.  Tensors may have any strides (the net's elementwise ops carry a
// channels-last layout through its first stage and a contiguous one after);
// the caller passes each tensor's (b, c, w) strides in elements.
//  * Forward: a block a batch row, a thread an output element of it in the
//    output's memory order (C x W_out elements, at most 2,176 here: one
//    pass of up to 1,024 threads), so the stores are coalesced and a
//    thread finds its (c, j) with one 32-bit division; the three taps come
//    through L1.
//  * Backward, pass 1: a block owns a tile of CT channels (CT = min(C, 32))
//    and a chunk of batch rows; thread (r, ci) walks rows r, r + RP, ... of
//    the chunk for channel ci, recomputes conv from the taps, writes dx and
//    keeps five running sums.  The block then reduces its RP partials per
//    channel in a fixed order and writes them to a (C, 5, chunks) scratch.
//  * Backward, pass 2: a block a channel adds its chunks' partials, each
//    thread a fixed stride of them and then a tree in shared memory.  No
//    atomics anywhere, so two runs give the same bits; the geometry depends
//    only on (B, C) (ops/dwproj.py::bwd_geometry).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TAPS = 3;
constexpr int SUMS = 5;          // sum g x_t for t = 0, 1, 2; sum g conv; sum g
constexpr int FWD_MAX_THREADS = 1024;
constexpr int FINISH_THREADS = 128;   // a power of 2

struct Strides {
  long long b, c, w;
};

__device__ __forceinline__ float tap(const float* __restrict__ x, const Strides& s, long long row,
                                     int w, int W) {
  return (w >= 0 && w < W) ? __ldg(x + row + w * s.w) : 0.0f;
}

__global__ void dwproj_forward_kernel(const float* __restrict__ x, const float* __restrict__ w9,
                                      const float* __restrict__ scale,
                                      const float* __restrict__ shift, float* __restrict__ y,
                                      int B, int C, int W, int Wo, int stride, Strides xs,
                                      Strides ys, int y_channels_last) {
  const int per_row = C * Wo;
  for (int b = blockIdx.x; b < B; b += gridDim.x) {
    for (int i = threadIdx.x; i < per_row; i += blockDim.x) {
      int c, j;
      if (y_channels_last) {
        j = i / C;
        c = i - j * C;
      } else {
        c = i / Wo;
        j = i - c * Wo;
      }
      const float* k = w9 + c * 9 + 3;
      const long long row = b * xs.b + c * xs.c;
      const int w0 = j * stride - 1;
      float conv = 0.0f;
#pragma unroll
      for (int t = 0; t < TAPS; ++t) conv = fmaf(__ldg(k + t), tap(x, xs, row, w0 + t, W), conv);
      y[b * ys.b + c * ys.c + j * ys.w] = conv * __ldg(scale + c) + __ldg(shift + c);
    }
  }
}

// pass 1: dx, and each block's partial sums per channel
__global__ void dwproj_backward_partial_kernel(
    const float* __restrict__ x, const float* __restrict__ g, const float* __restrict__ w9,
    const float* __restrict__ scale, float* __restrict__ dx, float* __restrict__ partial, int B,
    int C, int W, int Wo, int stride, Strides xs, Strides gs, Strides dxs, int ct,
    int rows_per_chunk) {
  extern __shared__ float red[];   // SUMS x blockDim.x
  const int ci = threadIdx.x % ct, r = threadIdx.x / ct, rp = blockDim.x / ct;
  const int c = blockIdx.x * ct + ci, chunk = blockIdx.y;
  float acc[SUMS] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  if (c < C) {
    float k[TAPS];
#pragma unroll
    for (int t = 0; t < TAPS; ++t) k[t] = __ldg(w9 + c * 9 + 3 + t);
    const float sc = __ldg(scale + c);
    const int b_end = min(B, (chunk + 1) * rows_per_chunk);
    for (int b = chunk * rows_per_chunk + r; b < b_end; b += rp) {
      const long long xrow = b * xs.b + c * xs.c, grow = b * gs.b + c * gs.c;
      for (int j = 0; j < Wo; ++j) {
        const float gv = __ldg(g + grow + j * gs.w);
        const int w0 = j * stride - 1;
        float conv = 0.0f;
#pragma unroll
        for (int t = 0; t < TAPS; ++t) {
          const float xv = tap(x, xs, xrow, w0 + t, W);
          conv = fmaf(k[t], xv, conv);
          acc[t] = fmaf(gv, xv, acc[t]);
        }
        acc[3] = fmaf(gv, conv, acc[3]);
        acc[4] += gv;
      }
      const long long drow = b * dxs.b + c * dxs.c;
      for (int i = 0; i < W; ++i) {
        float d = 0.0f;
#pragma unroll
        for (int t = 0; t < TAPS; ++t) {
          const int num = i + 1 - t;   // j stride = i + 1 - t
          if (num >= 0 && num % stride == 0 && num / stride < Wo)
            d = fmaf(k[t], __ldg(g + grow + (num / stride) * gs.w), d);
        }
        dx[drow + i * dxs.w] = d * sc;
      }
    }
  }
#pragma unroll
  for (int q = 0; q < SUMS; ++q) red[q * blockDim.x + threadIdx.x] = acc[q];
  __syncthreads();
  if (r == 0 && c < C) {
#pragma unroll
    for (int q = 0; q < SUMS; ++q) {
      float s = 0.0f;
      for (int rr = 0; rr < rp; ++rr) s += red[q * blockDim.x + rr * ct + ci];
      partial[((long long)c * SUMS + q) * gridDim.y + chunk] = s;
    }
  }
}

// pass 2: a block a channel; thread n takes chunks n, n + FINISH_THREADS, ...,
// then a tree in shared memory, both in a fixed order; dw whole, outer rows 0
__global__ void dwproj_backward_finish_kernel(const float* __restrict__ partial,
                                              const float* __restrict__ scale,
                                              float* __restrict__ dw9, float* __restrict__ dscale,
                                              float* __restrict__ dshift, int chunks) {
  __shared__ float red[SUMS][FINISH_THREADS];
  const int c = blockIdx.x, tid = threadIdx.x;
  float s[SUMS] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  for (int n = tid; n < chunks; n += FINISH_THREADS) {
#pragma unroll
    for (int q = 0; q < SUMS; ++q) s[q] += partial[((long long)c * SUMS + q) * chunks + n];
  }
#pragma unroll
  for (int q = 0; q < SUMS; ++q) red[q][tid] = s[q];
  __syncthreads();
  for (int half = FINISH_THREADS / 2; half > 0; half /= 2) {
    if (tid < half) {
#pragma unroll
      for (int q = 0; q < SUMS; ++q) red[q][tid] += red[q][tid + half];
    }
    __syncthreads();
  }
  if (tid < 9) dw9[c * 9 + tid] = (tid >= 3 && tid < 3 + TAPS) ? red[tid - 3][0] * scale[c] : 0.0f;
  if (tid == 0) {
    dscale[c] = red[3][0];
    dshift[c] = red[4][0];
  }
}

Strides strides(const long long* s) { return Strides{s[0], s[1], s[2]}; }

}  // namespace

// x (B, C, 1, W), y (B, C, 1, Wo) at the (b, c, w) strides given; w9 the
// contiguous (C, 1, 3, 3) weight; scale, shift (C,).
extern "C" int dwproj_forward_f32(const void* x, const void* w9, const void* scale,
                                  const void* shift, void* y, int B, int C, int W, int Wo,
                                  int stride, const long long* x_strides,
                                  const long long* y_strides, int y_channels_last,
                                  void* stream) {
  if ((long long)B * C * Wo == 0) return 0;
  const int per_row = (C * Wo + 31) / 32 * 32;
  dwproj_forward_kernel<<<B, per_row < FWD_MAX_THREADS ? per_row : FWD_MAX_THREADS, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(w9),
      static_cast<const float*>(scale), static_cast<const float*>(shift),
      static_cast<float*>(y), B, C, W, Wo, stride, strides(x_strides), strides(y_strides),
      y_channels_last);
  return static_cast<int>(cudaGetLastError());
}

// g (B, C, 1, Wo) and dx (B, C, 1, W) at the strides given; partial a
// (C, 5, chunks) float scratch; dw9 (C, 1, 3, 3), dscale and dshift (C,)
// contiguous.  Blocks of (C / ct) x chunks, ct * (threads / ct) threads.
extern "C" int dwproj_backward_f32(const void* x, const void* g, const void* w9,
                                   const void* scale, void* dx, void* partial, void* dw9,
                                   void* dscale, void* dshift, int B, int C, int W, int Wo,
                                   int stride, const long long* x_strides,
                                   const long long* g_strides, const long long* dx_strides,
                                   int ct, int threads, int chunks, int rows_per_chunk,
                                   void* stream) {
  if (C == 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B > 0) {
    const dim3 grid((C + ct - 1) / ct, chunks);
    dwproj_backward_partial_kernel<<<grid, threads, SUMS * threads * sizeof(float), st>>>(
        static_cast<const float*>(x), static_cast<const float*>(g),
        static_cast<const float*>(w9), static_cast<const float*>(scale),
        static_cast<float*>(dx), static_cast<float*>(partial), B, C, W, Wo, stride,
        strides(x_strides), strides(g_strides), strides(dx_strides), ct, rows_per_chunk);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  dwproj_backward_finish_kernel<<<C, FINISH_THREADS, 0, st>>>(
      static_cast<const float*>(partial), static_cast<const float*>(scale),
      static_cast<float*>(dw9), static_cast<float*>(dscale), static_cast<float*>(dshift),
      B > 0 ? chunks : 0);
  return static_cast<int>(cudaGetLastError());
}
