// The engine's int16 wire encoding of a batch in one pass over its rows.
//
// Input: the AFF and NEG count views, (n, 33, 34) int32 each, C-contiguous,
// and the two coverages already cast to int16 (n each).  Output, for rows
// 0 .. rows-1 (rows >= n, a whole number of the engine's device batches):
//   packed (rows, 34, 34) int16: rows 0-32 the AFF counts, row 33 column 0
//          the AFF coverage and column 1 the NEG coverage, the rest of row
//          33 zero;
//   delta  (rows, 33, 34) int16: NEG - AFF.
// Rows n .. rows-1, the padding of the last slice, are zero in both.  With no
// NEG view (the two views are one) only ``packed`` is written.
//
// Each row is read once and each output written once: about 110 MB for a
// batch of 8192 rows.  The rows are split across ``n_threads``
// OpenMP threads; each keeps the least and the greatest of the AFF counts,
// the NEG counts and the delta, and the call returns 1 when all fit in
// int16, 0 when one does not (the engine then sends the batch as float32).
// The delta is taken modulo 2^32: when both counts fit in int16 it is exact,
// and when one does not the call returns 0 whatever the delta reads.

#include <algorithm>
#include <cstdint>
#include <cstring>

namespace {

constexpr int64_t kView = 33 * 34;     // one view's counts a row
constexpr int64_t kPacked = 34 * 34;   // the packed row: the view and the coverage row

}  // namespace

extern "C" int wire_pack_int32(const int32_t* x_aff, const int32_t* x_neg,
                               const int16_t* cov_aff, const int16_t* cov_neg,
                               int64_t n, int64_t rows, int16_t* packed,
                               int16_t* delta, int n_threads) {
  // 0 lies in int16's range, so it is a safe start for the range check
  int32_t lo = 0, hi = 0;
#pragma omp parallel for num_threads(n_threads) schedule(static) \
    reduction(min : lo) reduction(max : hi)
  for (int64_t r = 0; r < rows; ++r) {
    int16_t* p = packed + r * kPacked;
    int16_t* d = x_neg ? delta + r * kView : nullptr;
    if (r >= n) {
      std::memset(p, 0, kPacked * sizeof(int16_t));
      if (d) std::memset(d, 0, kView * sizeof(int16_t));
      continue;
    }
    const int32_t* a = x_aff + r * kView;
    int32_t mn = 0, mx = 0;
    if (d) {
      const int32_t* b = x_neg + r * kView;
      for (int64_t i = 0; i < kView; ++i) {
        const int32_t av = a[i], bv = b[i];
        const int32_t dv = static_cast<int32_t>(static_cast<uint32_t>(bv) -
                                                static_cast<uint32_t>(av));
        p[i] = static_cast<int16_t>(av);
        d[i] = static_cast<int16_t>(dv);
        mn = std::min(mn, std::min(dv, std::min(av, bv)));
        mx = std::max(mx, std::max(dv, std::max(av, bv)));
      }
    } else {
      for (int64_t i = 0; i < kView; ++i) {
        const int32_t av = a[i];
        p[i] = static_cast<int16_t>(av);
        mn = std::min(mn, av);
        mx = std::max(mx, av);
      }
    }
    int16_t* cov = p + kView;
    std::memset(cov, 0, (kPacked - kView) * sizeof(int16_t));
    cov[0] = cov_aff[r];
    cov[1] = cov_neg[r];
    lo = std::min(lo, mn);
    hi = std::max(hi, mx);
  }
  return lo >= INT16_MIN && hi <= INT16_MAX;
}
