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
// Bound on an H100 SXM (NVIDIA data sheet: 495 TFLOP/s TF32 on the tensor
// cores, 3.35 TB/s HBM).  One direction at T = 33, B = 8192 moves x_gates,
// out, W and b once: 0.831 GB at H = 192 (0.248 ms) and 0.554 GB at H = 128
// (0.165 ms).  Its 2*T*B*H*3H FLOP of step product (59.8 and 26.6 GFLOP) take
// 0.121 and 0.054 ms at the TF32 rate, so the kernel is bound by bytes.  Done
// as 3xTF32 (below) the product is three times that work: 0.362 and 0.161 ms.
//
// Design.  One CTA owns 64 batch rows (B = 8192 is 128 CTAs, one wave on 132
// SMs) for all T steps, so nothing carries over between CTAs, as the TPU's
// in-order grid carried h in VMEM scratch.  Two consumer warpgroups and one
// producer warp.
//  * Step product on the tensor cores: wgmma m64n96k8 with TF32 operands, in
//    the 3xTF32 split.  Each operand x is hi + lo with hi = x rounded to TF32
//    and lo the rest; hi.hi + hi.lo + lo.hi, summed in fp32, keeps fp32-level
//    accuracy (the JAX engine runs precision=HIGHEST); one TF32 product alone
//    keeps about three decimal digits and misses the 1e-5 bar.  A (h) comes from
//    registers: each warp loads its 16 rows from shared memory and splits them
//    (three integer and float operations an element).  B (W) comes from
//    shared memory, split once by the wrapper (ops/gru.py::pack_w_hh).
//  * W_hh^T streamed through shared memory.  At H = 192 its hi and lo halves
//    are 864 KiB and do not fit in a CTA's 227 KB, so every step they flow
//    through a ring of up to 4 chunks of KC = 16 rows, each filled by one
//    cp.async.bulk (TMA, 1-D) completing on an mbarrier.  pack_w_hh lays W
//    out chunk by chunk in wgmma's no-swizzle K-major core matrices (8 rows of
//    16 bytes).  The producer warp keeps the ring full; each consumer warp
//    releases a stage with one arrive once its wgmmas on it have completed.
//    Every W element read from L2 feeds the CTA's 64 rows.
//  * Chunks come in groups of GROUP = 64 hidden columns: a chunk holds W
//    columns j, H + j and 2H + j for the group's j, so the r, z and n
//    pre-activations of a column are complete after the group's chunks and the
//    gate math runs on the accumulators in registers; no 3H-wide accumulator.
//    Warpgroup wg owns 32 columns of each group (N = 96: r, z, n), so a thread
//    holds r, z and n of the same (row, column): 48 fp32 accumulators.
//  * Two chunks in flight: while the wgmmas of one chunk run, the h of the
//    next is loaded and split into the A buffer that the chunk before has
//    released (A double-buffered in registers).
//  * h in shared memory, two buffers: step s reads one, the epilogue writes
//    the other, so one barrier among the consumer warps per step suffices.
//    Rows are HK + 4 floats apart, which spreads an A fragment's 32 reads over
//    32 banks.  The epilogue's x_gates are loaded into registers when a group
//    starts, so their latency hides behind its product; out[t] is written
//    straight to global memory.  pack_w_hh orders W's columns so that each
//    thread's accumulators cover 8 consecutive hidden units of a row: x_gates,
//    h and out move 16 bytes at a time (when H is a multiple of 4).  b_hh sits
//    in shared memory, each gate padded to HK.
//  * Padding is exact: H is padded to HK = round_up(H, 32) for the product and
//    to whole groups for the columns, with zero W, zero bias and zero x_gates,
//    so a padded unit keeps h = 0 at every step.  Rows past B read x_gates as 0
//    and are never stored.  Any H in 1..256 runs.
//
// Shared memory (bytes): 128 for the barriers + 2 * 64 * (HK + 4) * 4 for h
// + 3 * HK * 4 for b_hh + 24,576 for each stage of the ring, as many stages as
// fit up to 4: 201,088 at H = 192 (4 stages) and 210,048 at H = 256 (3), under
// the 232,448 a CTA may use.  Registers: 48 accumulators, 2 x 16 A
// fragment words, 48 x_gates values, within the 168 a thread gets in a block
// of 288; nvcc -Xptxas -v prints the count and spills (chip_smoke.py phase 1).  TMA multicast of W across a cluster, W resident
// in a cluster's shared memory, and the four directions of a NEG forward in
// fewer launches are left for later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int ROWS = 64;             // batch rows per CTA: wgmma's M
constexpr int CONSUMERS = 8;         // consumer warps: two warpgroups
constexpr int KC = 16;               // W rows per chunk
constexpr int KB = KC / 8;           // wgmma k-steps per chunk
constexpr int GROUP = 64;            // hidden columns per group: two warpgroups x 32
constexpr int NW = 96;               // wgmma N: r, z and n of a warpgroup's 32 columns
constexpr int TILE_FLOATS = NW * 8;  // B of one wgmma: 96 x 8
constexpr int CHUNK_FLOATS = 2 * 2 * KB * TILE_FLOATS;  // (hi, lo) x warpgroups x k-steps
constexpr uint32_t CHUNK_BYTES = CHUNK_FLOATS * sizeof(float);
constexpr int MAX_STAGES = 4;
constexpr int BARRIER_BYTES = 128;   // full[MAX_STAGES] and empty[MAX_STAGES]
constexpr int MAX_HIDDEN = 256;
constexpr size_t SMEM_LIMIT = 232448;
// wgmma B descriptor strides (no swizzle, K-major): core matrices of 8 rows x
// 16 bytes; the next one along K is 128 bytes on, along N 256 bytes on.
constexpr uint32_t LBO_BYTES = 128, SBO_BYTES = 256;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile(
      "{\n .reg .b64 state;\n mbarrier.arrive.shared::cta.b64 state, [%0];\n}\n" ::"r"(
          smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "{\n .reg .b64 state;\n mbarrier.arrive.expect_tx.shared::cta.b64 state, [%0], %1;\n}\n" ::
          "r"(smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// One TMA bulk copy global -> shared, completing `bytes` on `bar`.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::
          "r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// x = hi + lo: hi is x rounded to TF32 (ties away from zero, in integer
// operations, as pack_w_hh rounds W), lo the exact fp32 rest, whose bits below
// TF32 the tensor core ignores.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

__device__ __forceinline__ uint64_t b_desc(const float* tile) {
  return (uint64_t)((smem_u32(tile) >> 4) & 0x3FFF) | ((uint64_t)(LBO_BYTES >> 4) << 16) |
         ((uint64_t)(SBO_BYTES >> 4) << 32);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// Keeps the compiler from moving accumulator accesses across this point.
__device__ __forceinline__ void fence_acc(float (&d)[48]) {
#pragma unroll
  for (int i = 0; i < 48; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (64 x 96, fp32) += a (64 x 8, TF32, registers) . b (8 x 96, TF32, shared)
__device__ __forceinline__ void wgmma_m64n96k8(float (&d)[48], const uint32_t (&a)[4],
                                               uint64_t desc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %53, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47}, "
      "{%48, %49, %50, %51}, %52, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

// The gate functions with the fast exponential (ex2.approx, about 2 ulp);
// their absolute error stays near 1e-7, under the 1e-5 bar.
__device__ __forceinline__ float sigmoid_fast(float x) {
  return __fdividef(1.0f, 1.0f + __expf(-x));
}

__device__ __forceinline__ float tanh_fast(float x) {
  return 1.0f - __fdividef(2.0f, 1.0f + __expf(2.0f * x));
}

// A fragments of one chunk (KB k-steps) for a warp's 16 rows: the h values
// as loaded, and split into TF32 hi and lo.
struct RawA {
  float v[KB][4];
};

struct Frag {
  uint32_t hi[KB][4], lo[KB][4];
};

// hr: h at (the thread's first row, the chunk's first column + t4).
__device__ __forceinline__ void load_a(RawA& a, const float* hr, int HS) {
#pragma unroll
  for (int kb = 0; kb < KB; ++kb) {
    a.v[kb][0] = hr[8 * kb];
    a.v[kb][1] = hr[8 * HS + 8 * kb];
    a.v[kb][2] = hr[8 * kb + 4];
    a.v[kb][3] = hr[8 * HS + 8 * kb + 4];
  }
}

// Keeps f's registers allocated up to this point: a wgmma reads its A
// registers after it is issued, until a wgmma_wait says it is done.
__device__ __forceinline__ void fence_frag(Frag& f) {
#pragma unroll
  for (int kb = 0; kb < KB; ++kb)
#pragma unroll
    for (int k = 0; k < 4; ++k) asm volatile("" : "+r"(f.hi[kb][k]), "+r"(f.lo[kb][k])::"memory");
}

__device__ __forceinline__ void split_a(Frag& f, const RawA& a) {
#pragma unroll
  for (int kb = 0; kb < KB; ++kb)
#pragma unroll
    for (int k = 0; k < 4; ++k) split_tf32(a.v[kb][k], f.hi[kb][k], f.lo[kb][k]);
}

// d = p[0..7], zeros from column H on (p is column j0); two 16-byte loads when
// vec (H a multiple of 4, the arrays 16-byte aligned).
__device__ __forceinline__ void load8(float (&d)[8], const float* p, int j0, int H, bool vec) {
  if (vec) {
    const float4 z = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    const float4 a = j0 < H ? __ldg(reinterpret_cast<const float4*>(p)) : z;
    const float4 b = j0 + 4 < H ? __ldg(reinterpret_cast<const float4*>(p) + 1) : z;
    d[0] = a.x, d[1] = a.y, d[2] = a.z, d[3] = a.w;
    d[4] = b.x, d[5] = b.y, d[6] = b.z, d[7] = b.w;
  } else {
#pragma unroll
    for (int m = 0; m < 8; ++m) d[m] = j0 + m < H ? __ldg(p + m) : 0.0f;
  }
}

// p[0..7] = v, columns from H on left alone.
__device__ __forceinline__ void store8(float* p, const float (&v)[8], int j0, int H, bool vec) {
  if (vec) {
    if (j0 < H) reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
    if (j0 + 4 < H) reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
  } else {
#pragma unroll
    for (int m = 0; m < 8; ++m)
      if (j0 + m < H) p[m] = v[m];
  }
}

__global__ void __launch_bounds__(32 * (CONSUMERS + 1), 1)
gru_direction_kernel(const float* __restrict__ xg,   // (T, B, 3H)
                     const float* __restrict__ wp,   // pack_w_hh(W_hh^T)
                     const float* __restrict__ bhh,  // (3H)
                     float* __restrict__ out,        // (T, B, H)
                     int T, int B, int H, int reverse, int stages, bool vec) {
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + MAX_STAGES;
  float* ring = reinterpret_cast<float*>(smem + BARRIER_BYTES);
  const int HK = (H + 31) / 32 * 32;
  const int HS = HK + 4;  // h row stride in floats
  float* h_buf0 = ring + stages * CHUNK_FLOATS;
  float* h_buf1 = h_buf0 + ROWS * HS;
  float* bs = h_buf1 + ROWS * HS;  // b_hh, each gate padded to HK
  const int n_groups = (H + GROUP - 1) / GROUP;
  const int n_kc = HK / KC;  // even
  const int H3 = 3 * H;
  const int b0 = blockIdx.x * ROWS;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  for (int i = threadIdx.x; i < 2 * ROWS * HS; i += blockDim.x) h_buf0[i] = 0.0f;
  for (int k = threadIdx.x; k < 3 * HK; k += blockDim.x)
    bs[k] = k % HK < H ? bhh[k / HK * H + k % HK] : 0.0f;
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp == CONSUMERS) {
    // Producer: one thread streams W chunk by chunk, the same sequence of
    // per_step chunks every step.
    const uint32_t per_step = n_groups * n_kc, total = per_step * T;
    if (lane == 0) {
      for (uint32_t i = 0; i < total; ++i) {
        const uint32_t st = i % stages;
        if (i >= stages) mbar_wait(&empty[st], ((i / stages) - 1) & 1);
        mbar_arrive_expect_tx(&full[st], CHUNK_BYTES);
        bulk_load(ring + st * CHUNK_FLOATS, wp + (size_t)(i % per_step) * CHUNK_FLOATS,
                  CHUNK_BYTES, &full[st]);
      }
    }
    return;
  }

  // Consumers.  A thread's A fragment rows are row_a and row_a + 8; its
  // accumulators hold those rows at the 8 consecutive columns j0 .. j0 + 7 of
  // each gate, as pack_w_hh orders W's columns.
  const int wg = warp >> 2, wi = warp & 3;
  const int g8 = lane >> 2, t4 = lane & 3;
  const int row_a = 16 * wi + g8;
  uint32_t i = 0;  // chunks consumed
  for (int s = 0; s < T; ++s) {
    const int t = reverse ? T - 1 - s : s;
    const float* hc = (s & 1) ? h_buf1 : h_buf0;
    float* hn = (s & 1) ? h_buf0 : h_buf1;
    for (int g = 0; g < n_groups; ++g) {
      const int jbase = g * GROUP + 32 * wg;  // this warpgroup's 32 columns
      const bool active = jbase < H;          // uniform over the warpgroup
      const int j0 = jbase + 8 * t4;

      // x_gates of this thread's epilogue, [row half][gate][column]
      float xv[2][3][8];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int bg = b0 + row_a + 8 * half;
        const float* x = xg + ((size_t)t * B + bg) * H3 + j0;
#pragma unroll
        for (int q = 0; q < 3; ++q) load8(xv[half][q], x + q * H, active && bg < B ? j0 : H, H, vec);
      }

      float acc[48];
#pragma unroll
      for (int k = 0; k < 48; ++k) acc[k] = 0.0f;
      fence_acc(acc);
      const float* hr = hc + row_a * HS + t4;
      RawA ra;
      Frag fa0, fa1;
      if (active) {
        load_a(ra, hr, HS);
        split_a(fa0, ra);
      }
      // Chunk c runs on f; the next chunk's h is loaded while it runs and is
      // split into f_next once chunk c - 1, which read f_next, is done.
      auto chunk = [&](Frag& f, Frag& f_next, int c) {
        const uint32_t st = i % stages;
        mbar_wait(&full[st], (i / stages) & 1);
        if (active) {
          const float* stage = ring + st * CHUNK_FLOATS;
          wgmma_fence();
#pragma unroll
          for (int kb = 0; kb < KB; ++kb) {  // small terms first
            const uint64_t w_hi = b_desc(stage + ((0 * 2 + wg) * KB + kb) * TILE_FLOATS);
            const uint64_t w_lo = b_desc(stage + ((1 * 2 + wg) * KB + kb) * TILE_FLOATS);
            wgmma_m64n96k8(acc, f.lo[kb], w_hi);
            wgmma_m64n96k8(acc, f.hi[kb], w_lo);
            wgmma_m64n96k8(acc, f.hi[kb], w_hi);
          }
          wgmma_commit();
          wgmma_wait<1>();  // the previous chunk's wgmmas, which read f_next, are done
          fence_frag(f_next);
          if (c + 1 < n_kc) {
            load_a(ra, hr + (c + 1) * KC, HS);
            split_a(f_next, ra);
          }
        }
        if (c > 0) {
          __syncwarp();
          if (lane == 0) mbar_arrive(&empty[(i - 1) % stages]);
        }
        ++i;
      };
      for (int c = 0; c < n_kc; c += 2) {  // A fragments alternate between two buffers
        chunk(fa0, fa1, c);
        chunk(fa1, fa0, c + 1);
      }
      if (active) wgmma_wait<0>();
      fence_frag(fa0);
      fence_frag(fa1);
      fence_acc(acc);
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[(i - 1) % stages]);

      if (active) {
        const float* bias = bs + j0;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int row = row_a + 8 * half;
          const int bg = b0 + row;
          const float4* hp4 = reinterpret_cast<const float4*>(hc + row * HS + j0);
          const float4 p0 = hp4[0], p1 = hp4[1];
          const float h_old[8] = {p0.x, p0.y, p0.z, p0.w, p1.x, p1.y, p1.z, p1.w};
          float h_new[8];
#pragma unroll
          for (int m = 0; m < 8; ++m) {
            // column j0 + m of gate q is accumulator element 4 (4 q + m / 2) + 2 half + m % 2
            const int ci = 4 * (m >> 1) + 2 * half + (m & 1);
            const float rg = sigmoid_fast(xv[half][0][m] + (acc[ci] + bias[m]));
            const float zg = sigmoid_fast(xv[half][1][m] + (acc[16 + ci] + bias[HK + m]));
            const float ng = tanh_fast(xv[half][2][m] + rg * (acc[32 + ci] + bias[2 * HK + m]));
            h_new[m] = (1.0f - zg) * ng + zg * h_old[m];
          }
          float4* hn4 = reinterpret_cast<float4*>(hn + row * HS + j0);
          hn4[0] = make_float4(h_new[0], h_new[1], h_new[2], h_new[3]);
          hn4[1] = make_float4(h_new[4], h_new[5], h_new[6], h_new[7]);
          if (bg < B) store8(out + ((size_t)t * B + bg) * H + j0, h_new, j0, H, vec);
        }
      }
    }
    // The new h is complete, and the old one read, before the next step.
    asm volatile("bar.sync 1, %0;" ::"r"(32 * CONSUMERS) : "memory");
  }
}

}  // namespace

// C interface for ctypes.  w_packed is ops/gru.py::pack_w_hh(W_hh^T).
// Launches on `stream` and returns a cudaError_t (0 on success); the caller
// has checked shapes, types and contiguity.
extern "C" int gru_direction_f32(const void* x_gates, const void* w_packed, const void* b_hh,
                                 void* out, int T, int B, int H, int reverse, void* stream) {
  if (T == 0 || B == 0) return 0;
  if (H < 1 || H > MAX_HIDDEN) return static_cast<int>(cudaErrorInvalidValue);
  const int HK = (H + 31) / 32 * 32;
  const size_t fixed = BARRIER_BYTES + sizeof(float) * (2 * ROWS * (HK + 4) + 3 * HK);
  const int stages = (int)min((size_t)MAX_STAGES, (SMEM_LIMIT - fixed) / CHUNK_BYTES);
  if (stages < 2) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = fixed + stages * (size_t)CHUNK_BYTES;
  const bool vec = H % 4 == 0 && (reinterpret_cast<uintptr_t>(x_gates) |
                                  reinterpret_cast<uintptr_t>(out)) % 16 == 0;
  cudaError_t err = cudaFuncSetAttribute(
      gru_direction_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  gru_direction_kernel<<<(B + ROWS - 1) / ROWS, 32 * (CONSUMERS + 1), smem,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x_gates), static_cast<const float*>(w_packed),
      static_cast<const float*>(b_hh), static_cast<float*>(out), T, B, H, reverse, stages,
      vec);
  return static_cast<int>(cudaGetLastError());
}
