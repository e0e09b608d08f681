// K2: global (NW) edit distance plus the column count of edlib's co-optimal
// path, for a batch of (query, target) pairs.
//
// Replaces stringdecomposer_tpu/ops/identity_pallas.py::_nw_wavefront_kernel
// (reached through nw_identity_batch_pallas and nw_identity_packed_both).
// Same recurrence as stringdecomposer_tpu/ops/identity.py::nw_path_spec:
//   D(i, j) = min(D(i-1, j) + 1, D(i, j-1) + 1, D(i-1, j-1) + sub)
// and the path propagates its column count Ln with edlib's traceback
// preference up, then left, then diagonal:
//   Ln(i, j) = (up == D ? Ln(i-1, j) : left == D ? Ln(i, j-1) : Ln(i-1, j-1)) + 1
// matches = columns - D (a unit-cost path pays exactly one per non-match
// column). ops/identity.nw_lanes is the plain mirror of this schedule.
//
// What bounds it on the H100: a pair is ~170 x 175 cells at the golden shape,
// each a handful of dependent integer operations, and a call holds 10^4 to
// 10^5 pairs; there is nothing to load but the codes. So the bound is the
// SM's integer issue, provided the DP column never leaves the registers and
// enough warps run to hide each cell's latency chain. The design:
//   - One warp per pair. Lane l owns C contiguous query rows, l*C + 1 ..
//     l*C + C of the strip, with their (D, Ln) and their query codes in
//     registers. C is a template parameter, ceil(Lq / 32) for a call whose
//     queries are padded to Lq, at most kMaxC.
//   - A systolic sweep: at step s lane l computes column j = s - l + 1 of its
//     rows, top to bottom, with exactly the recurrence above. Its top row
//     takes up = (D, Ln)(l*C, j) and diag = (D, Ln)(l*C, j - 1) from lane
//     l-1's bottom row, which one __shfl_up_sync pair per step passes down;
//     the value received a step earlier is the next step's diag. Lane 0 takes
//     the boundary row (j, j). A lane outside 1 <= j <= tlen leaves its
//     registers as they are, so before its first column they hold column 0,
//     (i, i), which is what the lane below needs as its first diag. Every lane
//     takes part in every shuffle. A warp runs tlen + used - 1 steps, where
//     `used` lanes hold rows up to qlen; rows past qlen compute values that
//     never reach the result, since nothing flows upward.
//   - The result (qlen, tlen) sits in lane (qlen - 1) / C, register
//     (qlen - 1) % C, after the last step: an unrolled select picks the
//     register (a runtime index would put the column in local memory).
//   - Queries longer than 32 * kMaxC run in strips of 32 * kMaxC rows. Lane 31
//     writes each column's bottom row to a per-warp carry row, which lane 0 of
//     the next strip reads as its up and diag. Two carry rows alternate by
//     strip parity, so a strip never overwrites the row it reads. They live in
//     a device-memory scratch the wrapper allocates, one pair of rows per
//     pair (L1/L2-resident: a warp's lane 0 reads what its lane 31 wrote).
//   - Warps are independent (no block barrier); pairs sit sorted by length
//     in the finishing path, so the warps of a block end together.
// Two entries share the kernel: sd_nw_identity scores pair p as q row p
// against t row p, out [3, P] (D, matches, columns); sd_nw_identity_cross
// scores every q row against every t row, pair p = b * M + m (monomer
// fastest, so a block's warps share its codes in L1), out [Nb, M, 2]
// (D, columns). Values are int32, so any length is exact.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;  // warps (pairs) a block
constexpr int kMaxC = 16;  // rows a lane: a strip is 32 * kMaxC = 512 query rows
constexpr unsigned kFull = 0xffffffffu;

// (D, Ln) of one pair, returned to every lane of the warp.
template <int C>
__device__ __forceinline__ int2 nw_pair(const int* __restrict__ q, int qlen,
                                        const int* __restrict__ t, int tlen, int2* carry,
                                        int carry_stride, int lane) {
  if (qlen == 0) return make_int2(tlen, tlen);
  if (tlen == 0) return make_int2(qlen, qlen);
  constexpr int kRows = 32 * C;
  const int strips = (qlen + kRows - 1) / kRows;
  int D[C], L[C], qc[C];
  int base = 0;
  for (int k = 0; k < strips; ++k) {
    base = k * kRows;  // this strip holds rows base + 1 .. base + kRows
    const bool last = k == strips - 1;
    const int top = base + lane * C;  // the row above the lane's first
    const int2* prev = carry + ((k + 1) & 1) * carry_stride;  // strip k-1's bottom row
    int2* next = carry + (k & 1) * carry_stride;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int i = top + c + 1;
      D[c] = i;  // column 0
      L[c] = i;
      qc[c] = i <= qlen ? __ldg(q + i - 1) : -1;
    }
    const int used = last ? (qlen - base + C - 1) / C : 32;
    const int steps = tlen + used - 1;
    // up and diag of the lane's top row for step 0: lane 0 at column 1, the
    // other lanes at column <= 0, where the lane above still holds column 0
    int uD = top, uL = top, gD = top, gL = top;
    if (lane == 0) {
      gD = gL = base;  // column 0 of row `base`
      if (k == 0) {
        uD = uL = 1;
      } else {
        const int2 v = prev[1];
        uD = v.x;
        uL = v.y;
      }
    }
    int tc = lane == 0 ? __ldg(t) : 0;  // the code of column j, prefetched a step ahead
    for (int s = 0; s < steps; ++s) {
      const int j = s - lane + 1;
      const int jn = j + 1;
      const int tc_next = jn >= 1 && jn <= tlen ? __ldg(t + jn - 1) : 0;
      if (j >= 1 && j <= tlen) {
        int aD = uD, aL = uL, bD = gD, bL = gL;  // up and diag of row top + c + 1
#pragma unroll
        for (int c = 0; c < C; ++c) {
          const int lD = D[c], lL = L[c];  // left: column j - 1
          const int up = aD + 1, lf = lD + 1, dg = bD + (qc[c] != tc);
          const int nD = min(min(up, lf), dg);
          const int nL = (up == nD ? aL : (lf == nD ? lL : bL)) + 1;
          D[c] = nD;
          L[c] = nL;
          aD = nD;
          aL = nL;
          bD = lD;
          bL = lL;
        }
        if (!last && lane == 31) next[j] = make_int2(D[C - 1], L[C - 1]);
      }
      const int rD = __shfl_up_sync(kFull, D[C - 1], 1);
      const int rL = __shfl_up_sync(kFull, L[C - 1], 1);
      gD = uD;
      gL = uL;
      uD = rD;
      uL = rL;
      if (lane == 0) {  // the row above the strip at lane 0's next column
        if (k == 0) {
          uD = uL = jn;
        } else if (jn <= tlen) {
          const int2 v = prev[jn];
          uD = v.x;
          uL = v.y;
        }
      }
      tc = tc_next;
    }
    __syncwarp();  // the carry row is complete before the next strip reads it
  }
  const int r = (qlen - 1 - base) % C;
  int vD = D[0], vL = L[0];
#pragma unroll
  for (int c = 1; c < C; ++c) {
    if (r == c) {
      vD = D[c];
      vL = L[c];
    }
  }
  const int owner = (qlen - 1 - base) / C;
  return make_int2(__shfl_sync(kFull, vD, owner), __shfl_sync(kFull, vL, owner));
}

// cross == 0: pair p is q row p against t row p; out [3, P].
// cross != 0: pair p is q row p / M against t row p % M; out [P, 2].
template <int C>
__global__ void __launch_bounds__(32 * kWarps)
    nw_identity_kernel(const int* __restrict__ q, const int* __restrict__ q_lens,
                       const int* __restrict__ t, const int* __restrict__ t_lens,
                       int2* __restrict__ carry_g, int* __restrict__ out, int P, int M, int Lq,
                       int Lt, int cross) {
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long p = (long long)blockIdx.x * kWarps + w;
  if (p >= P) return;  // the whole warp
  const long long qi = cross ? p / M : p;
  const long long ti = cross ? p % M : p;
  const int qlen = min(max(q_lens[qi], 0), Lq);
  const int tlen = min(max(t_lens[ti], 0), Lt);
  const int stride = Lt + 1;
  int2* carry = carry_g ? carry_g + p * 2 * stride : nullptr;  // null: one strip
  const int2 r = nw_pair<C>(q + qi * Lq, qlen, t + ti * Lt, tlen, carry, stride, lane);
  if (lane == 0) {
    if (cross) {
      out[2 * p] = r.x;
      out[2 * p + 1] = r.y;
    } else {
      out[p] = r.x;
      out[P + p] = r.y - r.x;
      out[2LL * P + p] = r.y;
    }
  }
}

template <int C>
int launch_c(const void* q, const void* q_lens, const void* t, const void* t_lens, void* carry,
             void* out, int P, int M, int Lq, int Lt, int cross, void* stream) {
  if (Lq > 32 * C && carry == nullptr) return (int)cudaErrorInvalidValue;  // strips need rows
  nw_identity_kernel<C><<<(P + kWarps - 1) / kWarps, 32 * kWarps, 0, (cudaStream_t)stream>>>(
      (const int*)q, (const int*)q_lens, (const int*)t, (const int*)t_lens, (int2*)carry,
      (int*)out, P, M, Lq, Lt, cross);
  return (int)cudaGetLastError();
}

int launch(const void* q, const void* q_lens, const void* t, const void* t_lens, void* carry,
           void* out, int P, int M, int Lq, int Lt, int cross, void* stream) {
  if (P <= 0) return 0;
  const int c = Lq <= 32 ? 1 : (Lq > 32 * kMaxC ? kMaxC : (Lq + 31) / 32);
#define SD_NW_CASE(CC) \
  case CC:             \
    return launch_c<CC>(q, q_lens, t, t_lens, carry, out, P, M, Lq, Lt, cross, stream);
  switch (c) {
    SD_NW_CASE(1)
    SD_NW_CASE(2)
    SD_NW_CASE(3)
    SD_NW_CASE(4)
    SD_NW_CASE(5)
    SD_NW_CASE(6)
    SD_NW_CASE(7)
    SD_NW_CASE(8)
    SD_NW_CASE(9)
    SD_NW_CASE(10)
    SD_NW_CASE(11)
    SD_NW_CASE(12)
    SD_NW_CASE(13)
    SD_NW_CASE(14)
    SD_NW_CASE(15)
    SD_NW_CASE(16)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef SD_NW_CASE
}

}  // namespace

// q [P, Lq], t [P, Lt] int32 codes; out [3, P] int32 (D, matches, columns).
// carry: [P, 2, Lt + 1] int2 where Lq > 32 * kMaxC (the strip route), else
// null.
extern "C" int sd_nw_identity(const void* q, const void* q_lens, const void* t,
                              const void* t_lens, void* carry, void* out, int P, int Lq, int Lt,
                              void* stream) {
  return launch(q, q_lens, t, t_lens, carry, out, P, 1, Lq, Lt, 0, stream);
}

// q [Nb, Lq], t [M, Lt] int32 codes; out [Nb, M, 2] int32 (D, columns);
// carry as above, [Nb * M, 2, Lt + 1] int2.
extern "C" int sd_nw_identity_cross(const void* q, const void* q_lens, const void* t,
                                    const void* t_lens, void* carry, void* out, int Nb, int M,
                                    int Lq, int Lt, void* stream) {
  if ((long long)Nb * M > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  return launch(q, q_lens, t, t_lens, carry, out, Nb * M, M, Lq, Lt, 1, stream);
}
