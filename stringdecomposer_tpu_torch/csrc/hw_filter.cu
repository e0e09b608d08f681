// K3: infix (HW-mode) edit distance of every monomer against every read
// window, the --ed_thr monomer pre-filter.
//
// Replaces stringdecomposer_tpu/ops/hw_filter.py::_hw_kernel (reached
// through hw_distance_batch_pallas). The function, as the lax.scan twin
// hw_distance_batch in that file computes it, over the monomer rows i =
// 0..mono_len and window columns j = 0..window_len:
//   D[0][j] = 0,  D[i][0] = i
//   D[i][j] = min(D[i-1][j-1] + (mono[i-1] != win[j-1]), D[i-1][j] + 1, D[i][j-1] + 1)
//   dist = min over 0 <= j <= window_len of D[mono_len][j]
// Codes 0-4 (A, C, G, T, N) match equal codes; a window code outside 0-4
// (READ_PAD) matches nothing. Monomer rows hold codes 0-4 (io/fasta.encode);
// any other code is compared as the twin compares it, on a slow path that
// builds the Peq word of such a window char from the monomer's bytes.
//
// What bounds it on the H100: integer operations. The value is unique (no
// tie rule), so the bit-parallel form of Myers / Hyyro computes the same
// integers with one step per 32-row word of the monomer column instead of
// one per cell. The data it reads (window chars, monomers) and writes ([B,
// M] ints) are a few MB; the work is B * M * W * ceil(L / 32) word steps.
// The design keeps the column in registers and gives the card enough
// independent columns to hide each one's chain:
//   - Thread route (padded L <= 512, hw_thread_kernel<R>): one thread per
//     (window, monomer, target segment), the column's R = ceil(L / 32) words
//     of VP and VN in registers. A word step is ~10 integer operations; the
//     add's carry ripples through the hardware carry flag (add.cc / addc),
//     the HP / HN up-shift through funnel shifts, with no shuffle or barrier
//     in a column. The monomer is right-aligned in the 32 R rows: rows
//     1..k (k = 32 R - mono_len) are wildcards that match every code, so they
//     stay 0 like row 0, and row mono_len of the monomer is bit 31 of word
//     R - 1, whose HP / HN bits move the score with no select. A block holds
//     one monomer: its Peq words (planes for codes 0-4 and one for every
//     other code, the wildcard rows set in all six) are built once in shared
//     memory at an odd stride, so the threads' different chars read
//     different banks. Threads read their window 16 chars at a time (one
//     16-byte load; segment starts aligned to 16). A block whose monomer
//     holds a code outside 0-4 runs its columns one at a time instead,
//     the Peq word of a window char outside 0-4 built from the monomer.
//   - Target segments. A window's columns are cut into segments of S (a
//     multiple of 16), one thread each, so that a batch of few pairs still
//     fills the card. A segment starts fresh (D(i, j0) = i) at j0 =
//     max(0, e_s - 2 mono_len) rounded down to 16 and takes its minimum over
//     every column it runs. That is exact: an optimal alignment ending at
//     column j costs at most mono_len, so it spans at most 2 mono_len
//     columns and starts at or after j0 when j is one of the segment's own
//     columns; a fresh sweep from j0 never finds less than the whole one,
//     since its alignments are alignments of the whole. The pair's result
//     is the minimum of its segments' (atomicMin on the output, which the
//     wrapper fills with BIG first; a min does not depend on the order).
//     ops/hw_filter_cuda.hw_segment_plan picks S from the card.
//   - Warp route (512 < L <= 16,384, hw_warp_kernel<R>): one warp per
//     (pair, segment), R = ceil(ceil(L / 32) / 32) words a lane, the column
//     step of K6's warp route (myers_warp.cuh: the carry across lanes by
//     two ballots and an add, the seam by one shuffle), the monomer from
//     row 1 up and the score read at bit mono_len - 1 of its word. Each lane
//     builds its Peq words from the monomer in registers; where the monomer
//     holds a code outside 0-4, a window char outside 0-4 gets its words
//     from the monomer's bytes.
//   - Wide route (L > 16,384, hw_wide_kernel): a block per pair, its
//     column cut into stages of kWideR words, one a thread, in registers.
//     The stages run as a pipeline: at step t stage s steps column t - s
//     on its words and hands the next stage its link (the add's carry out
//     and the HP / HN bits of its top row): up a lane by a shuffle, from
//     lane 31 to the next warp's lane 0 through shared memory, one barrier
//     a step (myers_wide.cuh, shared with K6's wide route in banded.cu).
//     Up to 512 stages (131,072 bp) run at once; a longer column runs in
//     bands of 512 stages one after the other, each band's top link a
//     column kept in device memory for the next band. The monomer is
//     right-aligned as in the thread route; the Peq planes of codes 0-4
//     come from a prologue in device memory, a window char outside 0-4 its
//     words from the monomer's bytes. No length is refused.
// The Pallas kernel's right-aligned lanes and 128-lane roll ladder are the
// cell DP on the TPU's vector unit and are not carried over.

#include <cuda_runtime.h>
#include <stdint.h>

#include "myers_warp.cuh"
#include "myers_wide.cuh"

namespace {

using sd_warp::kFull;
constexpr int kThreads = 64;  // thread route: threads a block, all of one monomer
constexpr int kPlanes = 6;    // Peq planes: codes 0..4, then every other code
constexpr int kNoCode = 256;  // a code that no int8 equals
constexpr int kWarps = 8;     // warp route: warps a block
using sd_wide::kWideMaxStages;  // wide route: stages a band (threads a block)
using sd_wide::kWideR;          // wide route: words a stage (thread); two uint4 loads

// The Peq plane of a window char read as an unsigned byte: codes 0..4 their
// own, every other code (READ_PAD, negative codes) plane 5.
__device__ __forceinline__ unsigned plane_of(unsigned byte) { return min(byte, 5u); }

// Mask of the bits below bit n of a word (n in 0..32).
__device__ __forceinline__ unsigned below(int n) {
  return n >= 32 ? kFull : (1u << max(n, 0)) - 1u;
}

// Whether window code c (an int8) is one of 0..4, which have Peq planes.
__device__ __forceinline__ bool own_code(int c) { return (unsigned)c < 5u; }

// The Peq word r for window code `code` of a monomer right-aligned in `rows`
// rows: bit b is row 32 r + b, a wildcard below row k = rows - mlen, else
// monomer index 32 r + b - k, set where that holds `code`.
__device__ __forceinline__ unsigned peq_word(const int8_t* q, int mlen, int rows, int code,
                                             int r) {
  const int k = rows - mlen;
  unsigned w = below(k - 32 * r);
  if (code != kNoCode) {
    for (int b = max(k - 32 * r, 0); b < 32; ++b)
      w |= (unsigned)(q[32 * r + b - k] == code) << b;
  }
  return w;
}

// The warp route's Peq word for window code `code` at monomer indices base
// .. base + 31 (the monomer from row 1 up, nothing past mlen).
__device__ __forceinline__ unsigned code_word(const int8_t* q, int mlen, int base, int code) {
  unsigned w = 0;
  for (int b = 0; b < 32 && base + b < mlen; ++b) w |= (unsigned)(q[base + b] == code) << b;
  return w;
}

// sum = a + b over R words (word 0 lowest), mod 2^(32 R): the carry ripples
// through the hardware carry flag.
template <int R>
__device__ __forceinline__ void add_words(unsigned (&s)[R], const unsigned (&a)[R],
                                          const unsigned (&b)[R]) {
  if constexpr (R == 1) {
    s[0] = a[0] + b[0];
  } else {
    asm volatile("add.cc.u32 %0, %1, %2;" : "=r"(s[0]) : "r"(a[0]), "r"(b[0]));
#pragma unroll
    for (int r = 1; r < R - 1; ++r)
      asm volatile("addc.cc.u32 %0, %1, %2;" : "=r"(s[r]) : "r"(a[r]), "r"(b[r]));
    asm volatile("addc.u32 %0, %1, %2;" : "=r"(s[R - 1]) : "r"(a[R - 1]), "r"(b[R - 1]));
  }
}

// One window column on a thread's R words, the whole column (row 0's
// horizontal delta 0: HW), given the column's Peq words pl[0..R-1]; the
// score moves by the HP / HN bits of bit 31 of word R - 1.
template <int R>
__device__ __forceinline__ void thread_column(unsigned (&vp)[R], unsigned (&vn)[R],
                                              const unsigned* pl, int& score, int& best) {
  unsigned x[R], t[R], sum[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    x[r] = pl[r] | vn[r];
    t[r] = x[r] & vp[r];
  }
  add_words<R>(sum, t, vp);
  unsigned hpp = 0, hnp = 0;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const unsigned d0 = (sum[r] ^ vp[r]) | x[r];
    const unsigned hp = vn[r] | ~(d0 | vp[r]);
    const unsigned hn = d0 & vp[r];
    const unsigned hpsh = __funnelshift_l(hpp, hp, 1), hnsh = __funnelshift_l(hnp, hn, 1);
    vp[r] = hnsh | ~(d0 | hpsh);
    vn[r] = d0 & hpsh;
    hpp = hp;
    hnp = hn;
  }
  score += (int)(hpp >> 31) - (int)(hnp >> 31);
  best = min(best, score);
}

// The columns of 16 chars packed in v (char i in byte i % 4 of word i / 4),
// the first n of them (n = 16: all, unpredicated).
template <int R, bool kAll>
__device__ __forceinline__ void thread_chunk(unsigned (&vp)[R], unsigned (&vn)[R],
                                             const unsigned* peq, uint4 v, int n, int& score,
                                             int& best) {
  constexpr int kStride = R | 1;
  const unsigned w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    if (kAll || i < n) {
      const unsigned p = plane_of((w[i >> 2] >> (8 * (i & 3))) & 0xffu);
      thread_column<R>(vp, vn, peq + p * kStride, score, best);
    }
  }
}

// Thread route: blockIdx.x is the monomer m; thread g = blockIdx.y *
// kThreads + threadIdx.x runs segment g % nseg of window g / nseg, output
// columns (chars) [s S, s S + S) of the window's first window_len.
template <int R>
__global__ void __launch_bounds__(kThreads)
    hw_thread_kernel(const int8_t* __restrict__ windows,  // [B, Wp], Wp % 16 == 0
                     const int* __restrict__ wlens,       // [B]
                     const int8_t* __restrict__ mono,     // [M, L]
                     const int* __restrict__ mono_lens,   // [M]
                     int* __restrict__ out,               // [B, M]
                     int B, int W, int Wp, int M, int L, int nseg, int S) {
  constexpr int kStride = R | 1;  // odd: the six planes' words in distinct banks
  __shared__ unsigned peq[kPlanes * kStride];
  const int m = blockIdx.x;
  const int mlen = min(max(mono_lens[m], 0), L);
  const int8_t* q = mono + (long long)m * L;
  for (int x = threadIdx.x; x < kPlanes * R; x += kThreads)
    peq[(x / R) * kStride + x % R] = peq_word(q, mlen, 32 * R, x / R < 5 ? x / R : kNoCode, x % R);
  int odd = 0;  // a monomer code outside 0..4
  for (int i = threadIdx.x; i < mlen; i += kThreads) odd |= !own_code(q[i]);
  const bool exotic = __syncthreads_or(odd);
  const int g = blockIdx.y * kThreads + threadIdx.x;
  if (g >= B * nseg) return;
  const int b = g / nseg, e_s = (g - b * nseg) * S;
  const int c_end = min(min(max(wlens[b], 0), W), e_s + S);
  int best = mlen;  // j = 0: D[mono_len][0] = mono_len
  if (e_s < c_end) {
    // column j0: D(i, j0) = i, the wildcard rows below k at 0
    const int k = 32 * R - mlen;
    unsigned vp[R], vn[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      vp[r] = ~below(k - 32 * r);
      vn[r] = 0u;
    }
    int score = mlen;
    const int8_t* row = windows + (long long)b * Wp;
    const int c0 = max(0, e_s - 2 * mlen) & ~15;
    if (exotic) {  // one column at a time, any code compared as it is
      for (int c = c0; c < c_end; ++c) {
        const int ch = row[c];
        unsigned pl[R];
#pragma unroll
        for (int r = 0; r < R; ++r)
          pl[r] = own_code(ch) ? peq[ch * kStride + r] : peq_word(q, mlen, 32 * R, ch, r);
        thread_column<R>(vp, vn, pl, score, best);
      }
    } else {
      for (int c = c0; c < c_end; c += 16) {
        const uint4 v = __ldg(reinterpret_cast<const uint4*>(row + c));
        if (c_end - c >= 16)
          thread_chunk<R, true>(vp, vn, peq, v, 16, score, best);
        else
          thread_chunk<R, false>(vp, vn, peq, v, c_end - c, score, best);
      }
    }
  }
  if (nseg == 1)
    out[(long long)b * M + m] = best;
  else
    atomicMin(out + (long long)b * M + m, best);
}

// Warp route: warp g (over M * B * nseg, monomer-major) runs segment s of
// window b against monomer m. Lane l owns words l*R .. l*R + R - 1; the
// monomer's row i is global bit i - 1, the score row mono_len bit
// mono_len - 1 (myers_warp.cuh semi_column).
template <int R>
__global__ void __launch_bounds__(32 * kWarps)
    hw_warp_kernel(const int8_t* __restrict__ windows,  // [B, Wp]
                   const int* __restrict__ wlens,       // [B]
                   const int8_t* __restrict__ mono,     // [M, L]
                   const int* __restrict__ mono_lens,   // [M]
                   int* __restrict__ out,               // [B, M]
                   int B, int W, int Wp, int M, int L, int nseg, int S) {
  const int lane = threadIdx.x & 31;
  const long long g = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  const long long per_m = (long long)B * nseg;
  if (g >= per_m * M) return;  // the whole warp
  const int m = (int)(g / per_m), bs = (int)(g % per_m);
  const int b = bs / nseg, e_s = (bs % nseg) * S;
  const int c_end = min(min(max(wlens[b], 0), W), e_s + S);
  const int mlen = min(max(mono_lens[m], 0), L);
  int best = mlen;
  if (e_s < c_end) {  // the whole warp
    const int8_t* q = mono + (long long)m * L;
    unsigned pq0[R], pq1[R], pq2[R], pq3[R], pq4[R], vp[R], vn[R];
    int odd = 0;  // a monomer code outside 0..4
#pragma unroll
    for (int r = 0; r < R; ++r) {
      unsigned w0 = 0, w1 = 0, w2 = 0, w3 = 0, w4 = 0;
      const int base = 32 * (lane * R + r);
      for (int bit = 0; bit < 32 && base + bit < mlen; ++bit) {
        const int c = q[base + bit];
        w0 |= (unsigned)(c == 0) << bit;
        w1 |= (unsigned)(c == 1) << bit;
        w2 |= (unsigned)(c == 2) << bit;
        w3 |= (unsigned)(c == 3) << bit;
        w4 |= (unsigned)(c == 4) << bit;
        odd |= !own_code(c);
      }
      pq0[r] = w0;
      pq1[r] = w1;
      pq2[r] = w2;
      pq3[r] = w3;
      pq4[r] = w4;
      vp[r] = kFull;  // column j0: all +1
      vn[r] = 0u;
    }
    const bool exotic = __any_sync(kFull, odd);
    // the score row's word, its owner and bit; without one the score stays 0
    const int hot_w = mlen > 0 ? (mlen - 1) >> 5 : -1;
    const int hot_lane = hot_w >= 0 ? hot_w / R : 0, hot_r = hot_w >= 0 ? hot_w % R : -1;
    const int hot_b = (mlen - 1) & 31;
    int score = mlen;
    const int8_t* row = windows + (long long)b * Wp;
    const int c0 = max(0, e_s - 2 * mlen);
    // the chars of columns c0 .. c0 + 63, char c in slot (c - c0) & 31
    int tcur = c0 + lane < c_end ? row[c0 + lane] : -1;
    int tnxt = c0 + 32 + lane < c_end ? row[c0 + 32 + lane] : -1;
    for (int c = c0; c < c_end; ++c) {
      const int i = c - c0;
      const int tc = __shfl_sync(kFull, tcur, i & 31);
      if ((i & 31) == 31) {
        tcur = tnxt;
        tnxt = c + 33 + lane < c_end ? row[c + 33 + lane] : -1;
      }
      unsigned eq[R];
      if (exotic && !own_code(tc)) {  // any code compared as it is
#pragma unroll
        for (int r = 0; r < R; ++r) eq[r] = code_word(q, mlen, 32 * (lane * R + r), tc);
      } else {
#pragma unroll
        for (int r = 0; r < R; ++r)
          eq[r] = tc == 0 ? pq0[r] : tc == 1 ? pq1[r] : tc == 2 ? pq2[r] : tc == 3 ? pq3[r]
                  : tc == 4 ? pq4[r] : 0u;
      }
      score += sd_warp::semi_column<R>(vp, vn, eq, lane, 0u, hot_lane, hot_r, hot_b);
      best = min(best, score);
    }
  }
  if (lane == 0) {
    if (nseg == 1)
      out[(long long)b * M + m] = best;
    else
      atomicMin(out + (long long)b * M + m, best);
  }
}

// The wide route's Peq planes of codes 0..4, [M, 5, NW] words: the thread
// route's layout (right-aligned in 32 NW rows, wildcards below) at NW words.
__global__ void hw_peq_kernel(const int8_t* __restrict__ mono, const int* __restrict__ mono_lens,
                              unsigned* __restrict__ peq, int M, int L, int NW) {
  const long long x = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (x >= (long long)M * 5 * NW) return;
  const int m = (int)(x / (5 * NW)), p = (int)(x / NW % 5), r = (int)(x % NW);
  const int mlen = min(max(mono_lens[m], 0), L);
  peq[x] = peq_word(mono + (long long)m * L, mlen, 32 * NW, p, r);
}

// Wide route: block `pair` (monomer-major, pair = m * B + b) runs the pair's
// column as `stages` threads of kWideR words each, NW = bands * stages *
// kWideR words right-aligned; thread s is stage s of every band.
__global__ void __launch_bounds__(kWideMaxStages)
    hw_wide_kernel(const int8_t* __restrict__ windows,  // [B, Wp]
                   const int* __restrict__ wlens,       // [B]
                   const int8_t* __restrict__ mono,     // [M, L]
                   const int* __restrict__ mono_lens,   // [M]
                   const unsigned* __restrict__ peq,    // [M, 5, NW]
                   uint8_t* __restrict__ top,           // [B * M, Wp] (bands > 1)
                   int* __restrict__ out,               // [B, M]
                   int B, int W, int Wp, int M, int L, int stages, int bands) {
  __shared__ unsigned hand[2][kWideMaxStages / 32];  // sd_wide::hand_up's slots
  const long long pair = blockIdx.x;
  const int m = (int)(pair / B), b = (int)(pair % B);
  const int s = threadIdx.x;
  const int mlen = min(max(mono_lens[m], 0), L);
  const int wl = min(max(wlens[b], 0), W);
  const int NW = bands * stages * kWideR, k = 32 * NW - mlen;
  const int8_t* row = windows + (long long)b * Wp;
  const int8_t* q = mono + (long long)m * L;
  const unsigned* planes = peq + (long long)m * 5 * NW;
  uint8_t* tops = bands > 1 ? top + pair * Wp : nullptr;
  int best = mlen;
  for (int band = 0; band < bands; ++band) {
    const int w0 = (band * stages + s) * kWideR;  // the stage's first word
    unsigned vp[kWideR], vn[kWideR];
#pragma unroll
    for (int r = 0; r < kWideR; ++r) {  // column 0: D(i, 0) = i, the wildcard rows at 0
      vp[r] = ~below(k - 32 * (w0 + r));
      vn[r] = 0u;
    }
    int score = mlen;
    best = mlen;  // the last band's top stage holds the score row
    unsigned in = 0u;  // the link from the stage below, for this step's column
    for (int t = 0; t < wl + stages - 1; ++t) {
      const int c = t - s;
      const bool act = c >= 0 && c < wl;
      unsigned link = s > 0 ? in : band > 0 && act ? tops[c] : 0u;
      if (act) {
        const int ch = row[c];
        unsigned pl[kWideR];
        if (own_code(ch)) {  // the stage's 8 words, 32-byte aligned
          const uint4* pv = reinterpret_cast<const uint4*>(planes + ch * NW + w0);
          const uint4 lo = __ldg(pv), hi = __ldg(pv + 1);
          pl[0] = lo.x, pl[1] = lo.y, pl[2] = lo.z, pl[3] = lo.w;
          pl[4] = hi.x, pl[5] = hi.y, pl[6] = hi.z, pl[7] = hi.w;
        } else {
#pragma unroll
          for (int r = 0; r < kWideR; ++r) pl[r] = peq_word(q, mlen, 32 * NW, ch, w0 + r);
        }
        score += sd_wide::stage_column(vp, vn, pl, link, kWideR - 1, 31);
        best = min(best, score);
        if (s == stages - 1 && band + 1 < bands) tops[c] = (uint8_t)link;
      }
      in = sd_wide::hand_up(link, hand, t);
    }
  }
  if (s == stages - 1) out[(long long)b * M + m] = best;
}

template <int R>
int thread_launch(const void* windows, const void* wlens, const void* mono,
                  const void* mono_lens, void* out, int B, int W, int Wp, int M, int L, int nseg,
                  int S, cudaStream_t st) {
  const long long y = ((long long)B * nseg + kThreads - 1) / kThreads;
  if (y > 65535) return (int)cudaErrorInvalidConfiguration;
  hw_thread_kernel<R><<<dim3((unsigned)M, (unsigned)y), kThreads, 0, st>>>(
      (const int8_t*)windows, (const int*)wlens, (const int8_t*)mono, (const int*)mono_lens,
      (int*)out, B, W, Wp, M, L, nseg, S);
  return (int)cudaGetLastError();
}

template <int R>
int warp_launch(const void* windows, const void* wlens, const void* mono, const void* mono_lens,
                void* out, int B, int W, int Wp, int M, int L, int nseg, int S,
                cudaStream_t st) {
  const long long blocks = ((long long)M * B * nseg + kWarps - 1) / kWarps;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  hw_warp_kernel<R><<<(unsigned)blocks, 32 * kWarps, 0, st>>>(
      (const int8_t*)windows, (const int*)wlens, (const int8_t*)mono, (const int*)mono_lens,
      (int*)out, B, W, Wp, M, L, nseg, S);
  return (int)cudaGetLastError();
}

template <int R>
int thread_occupancy(int* blocks) {
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, hw_thread_kernel<R>,
                                                             kThreads, 0);
}

template <int R>
int warp_occupancy(int* blocks) {
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, hw_warp_kernel<R>,
                                                             32 * kWarps, 0);
}

// Words a thread (route 0) or a lane (route 1) holds at monomers padded to L.
int route_words(int route, int L) {
  const int nw = L > 0 ? (L + 31) / 32 : 1;
  return route == 0 ? nw : (nw + 31) / 32;
}

}  // namespace

#define SD_R_CASES(CALL) \
  CALL(1) CALL(2) CALL(3) CALL(4) CALL(5) CALL(6) CALL(7) CALL(8) \
  CALL(9) CALL(10) CALL(11) CALL(12) CALL(13) CALL(14) CALL(15) CALL(16)

// K3. windows [B, Wp] int8 (Wp a multiple of 16 and the rows 16-byte
// aligned; W <= Wp columns are read), wlens [B], mono [M, L] int8,
// mono_lens [M] int32, out [B, M] int32. route 0 (thread, L <= 512) and 1
// (warp, L <= 16,384) take nseg segments of S columns a pair (S a multiple
// of 16, nseg * S >= W; nseg > 1 needs out filled with values >= every
// distance first). Route 2 (wide, any L) runs a block a pair: nseg is its
// bands and S its stages a band (ops/hw_filter.wide_shape), NW = bands *
// stages * kWideR words >= L / 32; it takes peq [M, 5, NW] words and, where
// bands > 1, top [B * M, Wp] bytes.
extern "C" int sd_hw_distance(int route, const void* windows, const void* wlens,
                              const void* mono, const void* mono_lens, void* peq, void* top,
                              void* out, int B, int W, int Wp, int M, int L, int nseg, int S,
                              void* stream) {
  if (B <= 0 || M <= 0) return 0;
  const cudaStream_t st = (cudaStream_t)stream;
  if (W < 0 || Wp < W || Wp % 16 || L < 0) return (int)cudaErrorInvalidValue;
  if (route == 2) {
    const int bands = nseg, stages = S;
    const long long NW = (long long)bands * stages * kWideR, P = (long long)B * M;
    if (bands < 1 || stages < 32 || stages > kWideMaxStages || stages % 32 || 32 * NW < L ||
        32 * NW > 0x7fffffffLL || P > 0x7fffffffLL || (bands > 1 && !top))
      return (int)cudaErrorInvalidValue;
    const long long words = M * 5 * NW;
    hw_peq_kernel<<<(unsigned)((words + 255) / 256), 256, 0, st>>>(
        (const int8_t*)mono, (const int*)mono_lens, (unsigned*)peq, M, L, (int)NW);
    int err = (int)cudaGetLastError();
    if (err) return err;
    hw_wide_kernel<<<(unsigned)P, stages, 0, st>>>(
        (const int8_t*)windows, (const int*)wlens, (const int8_t*)mono, (const int*)mono_lens,
        (const unsigned*)peq, (uint8_t*)top, (int*)out, B, W, Wp, M, L, stages, bands);
    return (int)cudaGetLastError();
  }
  if ((route != 0 && route != 1) || nseg < 1 || S < 16 || S % 16 || (long long)nseg * S < W)
    return (int)cudaErrorInvalidValue;
  const int R = route_words(route, L);
#define SD_THREAD_CASE(RR) \
  case RR:                 \
    return thread_launch<RR>(windows, wlens, mono, mono_lens, out, B, W, Wp, M, L, nseg, S, st);
#define SD_WARP_CASE(RR) \
  case RR:               \
    return warp_launch<RR>(windows, wlens, mono, mono_lens, out, B, W, Wp, M, L, nseg, S, st);
  if (route == 0) {
    switch (R) {
      SD_R_CASES(SD_THREAD_CASE)
      default:
        return (int)cudaErrorInvalidValue;
    }
  }
  switch (R) {
    SD_R_CASES(SD_WARP_CASE)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef SD_THREAD_CASE
#undef SD_WARP_CASE
}

// Blocks of route 0 (kThreads threads each) or route 1 (kWarps warps each)
// at monomers padded to L that one SM holds at once
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor at the kernel's registers).
extern "C" int sd_hw_occupancy(int route, int L, int* blocks) {
  const int R = route_words(route, L);
#define SD_OCC_CASE(RR)                                                      \
  case RR:                                                                   \
    return route == 0 ? thread_occupancy<RR>(blocks) : warp_occupancy<RR>(blocks);
  switch (R) {
    SD_R_CASES(SD_OCC_CASE)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef SD_OCC_CASE
}
