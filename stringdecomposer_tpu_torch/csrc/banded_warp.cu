// K4, the warp route: the banded NW final column a warp per pair, the band
// in registers. csrc/banded.cu keeps the block kernel (banded_kernel) as the
// wide route, for bands of more than kMaxR * 32 = 512 lanes (k >= 256).
//
//   K4  banded_warp_kernel replaces stringdecomposer_tpu/ops/banded_pallas.py::
//       _kernel (via banded_final_column_pallas): the final target column of
//       the banded NW DP, |i - j| <= k, in int32 cells, on plain codes or on
//       equality bitmasks. Twin: ops/align.dp_banded_lastrow_batch (as
//       ops/banded.banded_final_column); mirror: ops/banded.banded_warp.
//
// What bounds it on the H100: latency. A pair is a chain of t_len dependent
// target columns and a column is ~6 integer operations a band lane, so
// neither device-memory bytes nor ALU throughput is the limit: the time is
// the number of columns times the latency of one column step. The design
// shortens that step:
//   - One warp a pair, kWarps pairs a block. Lane l holds the R = ceil(Bw /
//     32) consecutive band lanes l*R .. l*R + R - 1 of the column in
//     registers (R a template parameter, 1..16). Band lane b at column j holds
//     row i = j + b - k: its diagonal neighbour (i - 1, j - 1) is band lane b
//     at column j - 1, the same register; its left neighbour (i, j - 1) is
//     band lane b + 1, the next register or, for a lane's last, the next
//     lane's first by one __shfl_down_sync.
//   - The up chain, D(i, j) = min(cand(i), D(i - 1, j) + 1), is a prefix min
//     of cand - b over the band: over the lane's R cells, then a 5-step
//     __shfl_up_sync min scan of the lane totals, then one fix-up pass. No
//     barrier and no shared memory.
//   - Nothing on the column's chain reads memory. Target codes are staged 32
//     columns at a time, one coalesced load a lane, broadcast by __shfl_sync
//     a column, the next 32 loaded ahead. A lane's query codes slide down one
//     row a column with its cells: the next cell's code from the register
//     beside it, the last cell's from the next lane by a shuffle; the row
//     that enters the band's top (lane 31's last cell) is staged as the
//     target codes are.
//   - The cell's recurrence, the boundary row (c = j while i == 0), BIG
//     outside rows [0, q_len] and past the band, the mask-mode test and
//     t_len outside [0, Lt] (every lane BIG) are banded.cu's band_cand, bit
//     for bit. The cells past the band's 2k + 1 lanes hold BIG, so the top
//     lane's left neighbour is BIG as there.

#include <cuda_runtime.h>
#include <limits.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kBig = 1 << 28;
constexpr int kWarps = 8;  // pairs a block
constexpr int kMaxR = 16;  // band lanes a lane: the route takes 2k + 1 <= 512

// The query code at index x (row x + 1) as band_cand reads it: outside
// [0, Lq) the padding code (mask mode 0, plain -1).
template <bool kMask>
__device__ __forceinline__ int qcode(const int* __restrict__ qp, int Lq, int x) {
  return (x >= 0 && x < Lq) ? __ldg(qp + x) : (kMask ? 0 : -1);
}

template <int R, bool kMask>
__global__ void __launch_bounds__(32 * kWarps)
    banded_warp_kernel(const int* __restrict__ q,      // [P, Lq] codes or bitmasks
                       const int* __restrict__ qlens,  // [P]
                       const int* __restrict__ t,      // [P, Lt] codes or symbol ids
                       const int* __restrict__ tlens,  // [P]
                       int* __restrict__ out,          // [P, 2k + 1]
                       int P, int Lq, int Lt, int k) {
  const int lane = threadIdx.x & 31;
  const int p = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (p >= P) return;  // the whole warp
  const int Bw = 2 * k + 1, b0 = lane * R;
  const int ql = qlens[p], tl = tlens[p];
  const int n = (tl < 0 || tl > Lt) ? -1 : tl;  // -1: never captured
  const int* qp = q + (long long)p * Lq;
  const int* tp = t + (long long)p * Lt;
  // column 0: D(i, 0) = i on rows [0, q_len] of the band; band lane b's code
  // at column 1 is query index b - k
  int D[R], code[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int b = b0 + r, i = b - k;
    D[r] = (b < Bw && i >= 0 && i <= ql) ? i : kBig;
    code[r] = qcode<kMask>(qp, Lq, b - k);
  }
  // target codes of columns 1..32 and 33..64 (t index j - 1 in slot
  // (j - 1) & 31); the rows entering the top after columns 1..64 (query
  // index e1 + j - 1, same slots)
  const int e1 = 32 * R - k;
  int tcur = lane < n ? __ldg(tp + lane) : -1;
  int tnxt = 32 + lane < n ? __ldg(tp + 32 + lane) : -1;
  int qcur = qcode<kMask>(qp, Lq, e1 + lane);
  int qnxt = qcode<kMask>(qp, Lq, e1 + 32 + lane);
  for (int j = 1; j <= n; ++j) {
    const int s = (j - 1) & 31;
    const int tc = __shfl_sync(kFull, tcur, s);
    const int qin = __shfl_sync(kFull, qcur, s);
    if (s == 31) {
      tcur = tnxt;
      tnxt = j + 32 + lane < n ? __ldg(tp + j + 32 + lane) : -1;
      qcur = qnxt;
      qnxt = qcode<kMask>(qp, Lq, e1 + j + 32 + lane);
    }
    // rows past lim are outside [0, q_len] or past the band's top lane
    const int lim = min(ql, j + k);
    int right = __shfl_down_sync(kFull, D[0], 1);
    if (lane == 31) right = kBig;
    int c[R];
    int run = INT_MAX;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int b = b0 + r, i = j + b - k;
      const int dl = r + 1 < R ? D[r + 1] : right;
      const int sub = kMask ? 1 - ((code[r] >> tc) & 1) : (code[r] != tc ? 1 : 0);
      int cc = min(dl + 1, D[r] + sub);
      if (i == 0) cc = j;  // the NW boundary row enters while j <= k
      if (i < 0 || i > lim) cc = kBig;
      c[r] = cc - b;
      run = min(run, c[r]);
    }
    // the exclusive prefix min of the lane totals (a lane below o keeps its own)
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) run = min(run, __shfl_up_sync(kFull, run, o));
    int excl = __shfl_up_sync(kFull, run, 1);
    if (lane == 0) excl = INT_MAX;
    // the codes slide down one row for column j + 1
    const int up = __shfl_down_sync(kFull, code[0], 1);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int b = b0 + r, i = j + b - k;
      excl = min(excl, c[r]);
      D[r] = (i >= 0 && i <= lim) ? excl + b : kBig;
      code[r] = r + 1 < R ? code[r + 1] : (lane == 31 ? qin : up);
    }
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int b = b0 + r;
    if (b < Bw) out[(long long)p * Bw + b] = n < 0 ? kBig : min(D[r], kBig);
  }
}

template <int R>
int warp_launch(const void* q, const void* qlens, const void* t, const void* tlens, void* out,
                int P, int Lq, int Lt, int k, int use_mask, cudaStream_t st) {
  const unsigned blocks = (unsigned)((P + kWarps - 1) / kWarps);
  auto kern = use_mask ? banded_warp_kernel<R, true> : banded_warp_kernel<R, false>;
  kern<<<blocks, 32 * kWarps, 0, st>>>((const int*)q, (const int*)qlens, (const int*)t,
                                       (const int*)tlens, (int*)out, P, Lq, Lt, k);
  return (int)cudaGetLastError();
}

}  // namespace

#define SD_R_CASES(CALL) \
  CALL(1) CALL(2) CALL(3) CALL(4) CALL(5) CALL(6) CALL(7) CALL(8) \
  CALL(9) CALL(10) CALL(11) CALL(12) CALL(13) CALL(14) CALL(15) CALL(16)

// K4's warp route: q [P, Lq] codes (use_mask: equality bitmasks), qlens [P],
// t [P, Lt] codes (symbol ids), tlens [P], all int32; out [P, 2k + 1] int32.
// 0 <= k <= 255 (R = ceil((2k + 1) / 32) <= 16 band lanes a lane).
extern "C" int sd_banded_warp(const void* q, const void* qlens, const void* t, const void* tlens,
                              void* out, int P, int Lq, int Lt, int k, int use_mask,
                              void* stream) {
  if (P <= 0) return 0;
  if (k < 0 || 2 * k + 1 > 32 * kMaxR) return (int)cudaErrorInvalidValue;
  const int R = (2 * k + 1 + 31) / 32;
  const cudaStream_t st = (cudaStream_t)stream;
#define SD_BANDED_CASE(RR) \
  case RR:                 \
    return warp_launch<RR>(q, qlens, t, tlens, out, P, Lq, Lt, k, use_mask, st);
  switch (R) {
    SD_R_CASES(SD_BANDED_CASE)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef SD_BANDED_CASE
}
