// K3: infix (HW-mode) edit distance of every monomer against every read
// window, the --ed_thr monomer pre-filter.
//
// Replaces stringdecomposer_tpu/ops/hw_filter.py::_hw_kernel (reached
// through hw_distance_batch_pallas). Same recurrence as the lax.scan twin
// hw_distance_batch in that file, over the monomer column i = 0..mono_len for
// each window char j = 1..window_len:
//   D[0][j] = 0,  D[i][0] = i
//   cand[i] = min(D[i][j-1] + 1, D[i-1][j-1] + (mono[i-1] != win[j-1]))
//   D[i][j] = i + prefix-min_i(cand - i)        (the folded "up" chain)
//   dist = min over 0 <= j <= window_len of D[mono_len][j]
// Equality is on codes, so N (4) matches N; window padding is never read
// (the loop stops at window_len) and rows past mono_len never reach it.
//
// What bounds it on the H100: integer ALU work, B * M * W * L cells (about
// 17 G cells for 64 windows x 5,500 x 264 monomers of ~185 bp), while the
// device-memory traffic is only the window chars, the monomers and the
// [B, M] output. The design keeps the work in registers: one warp per
// (window, monomer) pair, each lane holding a contiguous run of C cells of
// the column, so a window char costs C cells of serial work per lane, one
// shuffle for the diagonal and a 5-step shuffle scan for the up chain (the
// pattern of K1's deletion fold). A block holds one window and eight
// monomers and stages the window's chars in shared memory, tile by tile.
// Columns longer than 32 * 8 = 256 cells (monomers above 255 bp) are streamed
// through the registers 256 cells at a time from a per-pair device-memory
// scratch, carrying the diagonal and the running minimum across segments,
// so no length is refused.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kBig = 1 << 28;
constexpr int kWarps = 8;    // monomers (warps) per block
constexpr int kTile = 2048;  // window chars staged per shared-memory tile
constexpr int kSegCells = 32 * 8;

// One window char over one 32 * C-cell segment of the column, rows
// base + lane * C + c. `d` holds the segment's column j - 1 on entry and
// column j on exit. carry_old is D[base - 1][j - 1] and carry_min the
// prefix min of (cand - i) through row base - 1 (kBig for the first
// segment); both are updated for the next segment. `best` is the running
// distance, kept by the lane that holds row mlen.
template <int C>
__device__ __forceinline__ void segment_step(int (&d)[C], const int8_t (&mc)[C],
                                             int ch, int lane, int base,
                                             int mlen, int& carry_old,
                                             int& carry_min, int& best) {
  const int up = __shfl_up_sync(kFull, d[C - 1], 1);
  const int next_old = __shfl_sync(kFull, d[C - 1], 31);
  int prev = lane == 0 ? carry_old : up;  // D[i - 1][j - 1]
  int t[C];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int i = base + lane * C + c;
    const int diag = prev + (mc[c] == ch ? 0 : 1);
    prev = d[c];
    const int cand = i == 0 ? 0 : min(d[c] + 1, diag);
    t[c] = cand - i;
    if (c > 0) t[c] = min(t[c], t[c - 1]);
  }
  // exclusive prefix min of the lanes' totals, seeded with the carry
  int tot = t[C - 1];
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int u = __shfl_up_sync(kFull, tot, o);
    if (lane >= o) tot = min(tot, u);
  }
  int excl = __shfl_up_sync(kFull, tot, 1);
  if (lane == 0) excl = kBig;
  excl = min(excl, carry_min);
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int i = base + lane * C + c;
    d[c] = min(t[c], excl) + i;
    if (i == mlen) best = min(best, d[c]);
  }
  carry_min = min(__shfl_sync(kFull, tot, 31), carry_min);
  carry_old = next_old;
}

// The monomer code of column row i (row 0 is the boundary and matches no
// window char; rows past L match none either).
__device__ __forceinline__ int8_t row_code(const int8_t* q, int i, int L) {
  return (i >= 1 && i <= L) ? q[i - 1] : (int8_t)-1;
}

// kSeg = false: the whole column (L + 1 <= 32 * C cells) stays in registers.
// kSeg = true: C = 8 and the column lives in scratch rows of seg_cells ints
// per pair, each 256-cell segment stored lane-interleaved (coalesced).
template <int C, bool kSeg>
__global__ void __launch_bounds__(32 * kWarps)
hw_kernel(const int8_t* __restrict__ windows,  // [B, W]
          const int* __restrict__ wlens,       // [B]
          const int8_t* __restrict__ mono,     // [M, L]
          const int* __restrict__ mono_lens,   // [M]
          int* scratch,                        // [B * M, seg_cells] (kSeg)
          int* __restrict__ out,               // [B, M]
          int W, int M, int L, int seg_cells) {
  __shared__ int8_t tile[kTile];
  const int groups = (M + kWarps - 1) / kWarps;
  const int b = blockIdx.x / groups;
  const int lane = threadIdx.x & 31;
  const int m = (blockIdx.x % groups) * kWarps + (threadIdx.x >> 5);
  const bool live = m < M;
  const int wlen = min(max(wlens[b], 0), W);
  const int mlen = live ? min(max(mono_lens[m], 0), L) : 0;
  const int8_t* q = mono + (long long)(live ? m : 0) * L;
  const int8_t* win = windows + (long long)b * W;
  int best = mlen;  // j = 0: D[mlen][0] = mlen
  int d[C];
  int8_t mc[C];
  int* col = kSeg ? scratch + ((long long)b * M + (live ? m : 0)) * seg_cells : nullptr;
  const int nseg = kSeg ? (mlen + kSegCells) / kSegCells : 1;
  if (kSeg) {
    if (live)
      for (int s = 0; s < nseg; ++s)
#pragma unroll
        for (int c = 0; c < C; ++c)
          col[s * kSegCells + c * 32 + lane] = s * kSegCells + lane * C + c;
  } else {
#pragma unroll
    for (int c = 0; c < C; ++c) {
      d[c] = lane * C + c;
      mc[c] = row_code(q, lane * C + c, L);
    }
  }
  for (int j0 = 0; j0 < wlen; j0 += kTile) {
    const int n = min(kTile, wlen - j0);
    __syncthreads();  // the previous tile is consumed
    for (int x = threadIdx.x; x < n; x += blockDim.x) tile[x] = win[j0 + x];
    __syncthreads();
    if (!live) continue;
    for (int jj = 0; jj < n; ++jj) {
      const int ch = tile[jj];
      int carry_old = kBig, carry_min = kBig;
      if (!kSeg) {
        segment_step<C>(d, mc, ch, lane, 0, mlen, carry_old, carry_min, best);
        continue;
      }
      for (int s = 0; s < nseg; ++s) {
        const int base = s * kSegCells;
#pragma unroll
        for (int c = 0; c < C; ++c) {
          d[c] = col[base + c * 32 + lane];
          mc[c] = row_code(q, base + lane * C + c, L);
        }
        segment_step<C>(d, mc, ch, lane, base, mlen, carry_old, carry_min, best);
#pragma unroll
        for (int c = 0; c < C; ++c) col[base + c * 32 + lane] = d[c];
      }
    }
  }
  if (live) {
    // the lane holding row mlen kept the distance; the others hold mlen or more
    int r = best;
    for (int o = 16; o > 0; o >>= 1) r = min(r, __shfl_xor_sync(kFull, r, o));
    if (lane == 0) out[(long long)b * M + m] = r;
  }
}

template <int C, bool kSeg>
int launch(const void* windows, const void* wlens, const void* mono,
           const void* mono_lens, void* scratch, void* out, int B, int W,
           int M, int L, int seg_cells, cudaStream_t stream) {
  const long long blocks = (long long)B * ((M + kWarps - 1) / kWarps);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  hw_kernel<C, kSeg><<<(unsigned)blocks, 32 * kWarps, 0, stream>>>(
      (const int8_t*)windows, (const int*)wlens, (const int8_t*)mono,
      (const int*)mono_lens, (int*)scratch, (int*)out, W, M, L, seg_cells);
  return (int)cudaGetLastError();
}

}  // namespace

// seg_cells = 0: L + 1 <= 256 and no scratch. Otherwise scratch holds
// B * M rows of seg_cells (a multiple of 256, >= L + 1) ints.
extern "C" int sd_hw_distance(const void* windows, const void* wlens,
                              const void* mono, const void* mono_lens,
                              void* scratch, void* out, int B, int W, int M,
                              int L, int seg_cells, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (seg_cells > 0)
    return launch<8, true>(windows, wlens, mono, mono_lens, scratch, out, B, W,
                           M, L, seg_cells, s);
  const int cells = L + 1;
  if (cells <= 32)
    return launch<1, false>(windows, wlens, mono, mono_lens, scratch, out, B,
                            W, M, L, 0, s);
  if (cells <= 64)
    return launch<2, false>(windows, wlens, mono, mono_lens, scratch, out, B,
                            W, M, L, 0, s);
  if (cells <= 128)
    return launch<4, false>(windows, wlens, mono, mono_lens, scratch, out, B,
                            W, M, L, 0, s);
  return launch<8, false>(windows, wlens, mono, mono_lens, scratch, out, B, W,
                          M, L, 0, s);
}
