// K2: global (NW) edit distance plus the column count of edlib's co-optimal
// path, for a batch of (query, target) pairs.
//
// Replaces stringdecomposer_tpu/ops/identity_pallas.py::_nw_wavefront_kernel
// (reached through nw_identity_batch_pallas and nw_identity_packed_both).
// Same recurrence as stringdecomposer_tpu/ops/identity.py::nw_path_spec:
//   D(i, j) = min(D(i-1, j) + 1, D(i, j-1) + 1, D(i-1, j-1) + sub)
// and the path propagates its column count with edlib's traceback preference
// up, then left, then diagonal. matches = columns - D (a unit-cost path pays
// exactly one per non-match column).
//
// What bounds it on the H100: every cell is a handful of integer operations
// on two int32 values, and each pair is an independent DP of ~171 x 171
// cells at the golden shape, with 10^4 to 10^5 pairs per call. One thread
// per pair keeps the recurrence sequential and exact at any length (no
// packed 13-bit fields, no length cap). The DP column of each pair (D and
// the column count, one int2 per query position) lives in device memory laid
// out [query position, pair], so a warp's 32 pairs touch 256 consecutive
// bytes per cell: the kernel is bound by that scratch traffic (16 bytes per
// cell, mostly served by L2), which a later version can move into registers
// and shared memory by tiling the query axis.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void nw_identity_kernel(const int* __restrict__ qT,      // [Lq, P]
                                   const int* __restrict__ q_lens,  // [P]
                                   const int* __restrict__ t,       // [P, Lt]
                                   const int* __restrict__ t_lens,  // [P]
                                   int2* __restrict__ col,          // [Lq, P]
                                   int* __restrict__ out,           // [3, P]
                                   int P, int Lq, int Lt) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= P) return;
  const int qlen = min(max(q_lens[p], 0), Lq);
  const int tlen = min(max(t_lens[p], 0), Lt);
  // column j = 0: D(i, 0) = i, columns(i, 0) = i
  for (int i = 1; i <= qlen; ++i) col[(long long)(i - 1) * P + p] = make_int2(i, i);
  int resD = qlen, resL = qlen;
  const int* tp = t + (long long)p * Lt;
  for (int j = 1; j <= tlen; ++j) {
    const int tch = tp[j - 1];
    int dD = j - 1, dL = j - 1;  // cell (i-1, j-1)
    int uD = j, uL = j;          // cell (i-1, j): row 0 is D = j
    for (int i = 1; i <= qlen; ++i) {
      const long long x = (long long)(i - 1) * P + p;
      const int2 left = col[x];  // cell (i, j-1)
      const int sub = qT[x] != tch;
      const int up = uD + 1;
      const int lf = left.x + 1;
      const int dg = dD + sub;
      const int D = min(min(up, lf), dg);
      const int Ln = (up == D ? uL : (lf == D ? left.y : dL)) + 1;
      col[x] = make_int2(D, Ln);
      dD = left.x;
      dL = left.y;
      uD = D;
      uL = Ln;
    }
    resD = uD;
    resL = uL;
  }
  out[p] = resD;
  out[P + p] = resL - resD;
  out[2 * (long long)P + p] = resL;
}

}  // namespace

extern "C" int sd_nw_identity(const void* qT, const void* q_lens, const void* t,
                              const void* t_lens, void* col, void* out, int P,
                              int Lq, int Lt, void* stream) {
  const int threads = 128;
  nw_identity_kernel<<<(P + threads - 1) / threads, threads, 0,
                       (cudaStream_t)stream>>>(
      (const int*)qT, (const int*)q_lens, (const int*)t, (const int*)t_lens,
      (int2*)col, (int*)out, P, Lq, Lt);
  return (int)cudaGetLastError();
}
