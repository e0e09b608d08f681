// K4, K5 and K6: the banded and semi-global sweeps of the general alignment
// API (stringdecomposer_tpu_torch/ops/align.py), their wide routes.
//
//   K4  banded_wide_kernel replaces stringdecomposer_tpu/ops/banded_pallas.py::
//       _kernel (via banded_final_column_pallas): the final target column of
//       the banded NW DP, |i - j| <= k, in int32 cells, on plain codes or on
//       equality bitmasks. Twin: ops/align.dp_banded_lastrow_batch; mirror:
//       ops/banded.banded_staged.
//   K5  myers_wide_kernel replaces banded_pallas.py::_myers_kernel (via
//       banded_final_column_myers): the same column by bit-parallel banded
//       Myers, 32 rows a word, with the NW boundary inside the band. It emits
//       the VP/VN planes and the anchor captured at j == t_len; the wrapper
//       rebuilds the column by a cumsum. Twin:
//       ops/banded.banded_final_column_myers; mirror: ops/banded.myers_staged.
//   K6  semi_wide_kernel replaces banded_pallas.py::_semi_kernel (via
//       semi_ends_myers): full-height Myers over every target column, the
//       end-row score D(q_len, j) of HW (free target prefix) or SHW. Twin:
//       ops/banded.semi_ends_myers; mirror: ops/banded.semi_staged.
// These are the wide routes: K4 past 512 band lanes (k >= 256; the warp
// route is csrc/banded_warp.cu), K5 and K6 past 512 words (the warp route
// is csrc/myers_warp.cu).
//
// What bounds them on the H100: the chain of columns. Each pair is a chain
// of t_len dependent target columns, and a column is only a few integer
// operations per row (K4) or per 32-row word (K5, K6), so device-memory
// bytes are no limit and the card's ALUs sit mostly idle: the time is the
// number of columns times one column step, its latency (K5, K6: one warp's
// serial stream a scheduler) or, for K4's thousands of rows a step, one
// SM's integer issue (~4 instructions a row). A column spread over a
// block-wide scan pays the scan and its barriers on every column, so all
// three run a block a pair (K6: a block a HW segment) whose threads are
// stages of a pipeline, each holding a few consecutive rows (K4) or words
// (K5, K6) of the column in registers with their query codes or Peq words,
// built once and never moved. At step t stage s steps column t - s on its
// own registers and hands the next stage its link, up a lane by a shuffle,
// from lane 31 to the next warp's lane 0 through a double-buffered shared
// slot, one barrier a step (sd_wide::hand_up in csrc/myers_wide.cuh, shared
// with K3's wide route). Rows are absolute, so a cell's dependencies come
// only from the stage itself (left, its own rows below) and from the stage
// below (the link: up, and the previous link: diagonal); in band
// coordinates a cell's left neighbour would sit in the stage above. Up to
// kWideMaxStages stages run at once (K4: ops/banded.WIDE4_STAGES, the
// fastest band measured); a taller pair runs in bands of stages, each
// band's top links kept by column in device memory for the next band (K4:
// the bands at once, a block each on a thread block cluster; K5, K6: one
// after the other).
// Nothing else of the band is kept in shared or device memory.
//   - K4: stages of kRows4 rows i, each cell held as G = D(i, j) - i - j, in
//     which a left or up step costs 0 and a diagonal one sub - 2: the up
//     chain is a running minimum from the link, one DPX three-way min a
//     row, and the NW boundary row stays G = 0. Cells past the band's top
//     keep kInfG, so a row entering the band reads exactly BIG from its
//     left; the chain restarts at the band's bottom (rows below it are
//     stale); only rows up to min(q_len, t_len + k) are held, and a band
//     runs only the columns where some of its rows lie in the band.
//   - K5: offset rows a = i + k (band lane b at column j is row j + b) in
//     stages of kWideR words, the column step K6's (sd_wide::stage_column)
//     with the band's masks, which in offset rows are fixed or monotone: the
//     add starts at cut = max(j, k + 1) with no carry and HP = +1, HN = 0
//     shifted into it (the NW boundary row a = k while j <= k, the band's
//     bottom a = j after); rows below cut keep their values (the virtual
//     rows' -1 ramp), rows above the top j + 2k keep VP = 1, VN = 0. Only
//     rows up to min(q_len + k, t_len + 2k) are held. The anchor (D at band
//     lane 0, row j) is stepped by the stage that holds row j and passed on
//     through shared memory when the bottom crosses into the next stage. At
//     t_len the stages write the rows [t_len, t_len + 2k] by funnel shifts.
//   - K6: stages of kWideR words over the whole query; only the stages up
//     to the end row's run. Under HW a long target is cut into segments
//     warm-started 2 q_len columns back, as the warp route's
//     (ops/banded_cuda.wide_segment_plan picks them).
// The Pallas kernels' right-aligned lanes, roll ladders, 128-lane tiles and
// column-tile grid exist for Mosaic and are not carried over.

#include <cuda/atomic>
#include <cuda_runtime.h>
#include <stdint.h>

#include "myers_wide.cuh"

namespace {

using sd_wide::kWideMaxStages;
using sd_wide::kWideR;

constexpr unsigned kFull = 0xffffffffu;
constexpr int kBig = 1 << 28;
constexpr int kRows4 = 32;       // K4: rows a stage (ops/banded.WIDE4_R)
constexpr int kInfG = 1 << 29;   // K4: G of a cell past the band or the rows (ops/banded.INF_G)
constexpr int kStageRows = 32 * kWideR;  // K5: rows a stage
constexpr int kClusterMax = 8;           // K4: blocks a pair (the portable cluster size)

// ---------------------------------------------------------------------------
// K4: the int32 band as a pipeline of stages in absolute rows
// ---------------------------------------------------------------------------

// G at column 0: rows [0, min(q_len, k)] hold D = i.
__device__ __forceinline__ int g0(int i, int k, int ql) { return (i <= k && i <= ql) ? 0 : kInfG; }

// The diagonal step's cost in G, sub - 2: plain codes match by equality,
// equality bitmasks by bit tc (band_cand's test, bit for bit).
template <bool kMask>
__device__ __forceinline__ int diag(int code, int tc) {
  return kMask ? -1 - ((code >> tc) & 1) : (code == tc ? -2 : -1);
}

// A band seam's progress word: the last column whose top link the band
// below has published (a release store after its links), read by the band
// above (an acquire load before it reads them).
using Progress = cuda::atomic_ref<int, cuda::thread_scope_device>;
constexpr int kPublish = 64;  // K4: columns between a seam's publications

// Block g runs the bands rank, rank + cs, ... of pair g / cs (rank = g %
// cs; the cs blocks of a pair are one thread block cluster, so they run at
// once). Thread s is stage s of each band: rows A + s * kRows4 .. + kRows4
// - 1 of band A / (stages * kRows4). At step u stage s steps column jb + u
// - s: cand = min(G(i, j - 1), G(i - 1, j - 1) + sub - 2) from its own
// registers (the first row's diagonal the previous link), then the running
// minimum from the link (the top row's G of the stage below at this
// column) through its rows. A band's top stage writes its links to the
// seam above and publishes them every kPublish columns; the band above's
// stage 0 waits for the columns it reads, so the bands run at once, each
// lagging the one below by its pipeline's depth. The band above reads
// only the columns where its first row's diagonal or up neighbour lies in
// the band, A - k - 1 .. A + k - 1 (A its first row), so a seam holds
// those 2k + 1 links: [P, seams, 2k + 1].
// Each lane of the output is written by the block of the band its row
// falls in (rows below 0 the first band's, past the last band's its).
template <bool kMask>
__global__ void __launch_bounds__(kWideMaxStages)
    banded_wide_kernel(const int* __restrict__ q,      // [P, Lq] codes or bitmasks
                       const int* __restrict__ qlens,  // [P]
                       const int* __restrict__ t,      // [P, Lt] codes or symbol ids
                       const int* __restrict__ tlens,  // [P]
                       int* __restrict__ tops,         // [P, seams, 2k + 1] (bands > 1) or null
                       int* __restrict__ prog,         // [P, seams] zeros (bands > 1) or null
                       int* __restrict__ out,          // [P, 2k + 1]
                       int Lq, int Lt, int k, int seams, int cs) {
  __shared__ unsigned hand[2][kWideMaxStages / 32];  // sd_wide::hand_up's slots
  const int p = blockIdx.x / cs, rank = blockIdx.x % cs, s = threadIdx.x, stages = blockDim.x;
  const int Bw = 2 * k + 1;
  int* op = out + (long long)p * Bw;
  const int ql = qlens[p], tl = tlens[p];
  const int n = (tl < 0 || tl > Lt) ? -1 : tl;  // -1: never captured, every lane BIG
  const int last = min(ql, n + k);               // the highest row a captured lane needs
  const int RB = stages * kRows4, nb = (n < 0 || last < 0) ? 0 : last / RB + 1;
  for (int b = s; b < Bw; b += stages) {  // this block's lanes BIG
    const int band = nb == 0 ? 0 : min(max(n + b - k, 0) / RB, nb - 1);
    if (band % cs == rank) op[b] = kBig;
  }
  if (nb == 0) return;
  __syncthreads();  // every lane BIG before the stages write theirs
  const int* qp = q + (long long)p * Lq;
  const int* tp = t + (long long)p * Lt;
  for (int band = rank; band < nb; band += cs) {
    const int A = band * RB;
    const int used = band < nb - 1 ? stages : (last - A) / kRows4 + 1;  // the stages this band runs
    const int a0 = A + s * kRows4;
    const bool live = s < used;
    // the columns where some of the band's rows lie in the band
    const int jb = max(1, A - k);
    const int ncols = max(0, min(n, A + used * kRows4 - 1 + k) - jb + 1);
    // the seams below and above: links by column from A - k - 1 (the
    // seam's first row less k + 1), and their progress
    const long long below = (long long)p * seams + band - 1;
    const int* tin = band > 0 ? tops + below * Bw : nullptr;
    int* tout = band < nb - 1 ? tops + (below + 1) * Bw : nullptr;
    const int tin0 = A - k - 1, tout0 = tin0 + RB;  // the seams' first columns
    const int lastin = min(n, A - 1 + k);  // the last column the seam below holds
    int avail = 0;                          // stage 0: its columns published so far
    // stage 0: the seam below's link at column c, once published; none past
    // its last column (the row below the band's is then under the band)
    auto seam = [&](int c) {
      if (c > lastin) return kInfG;
      while (avail < c) avail = Progress(prog[below]).load(cuda::memory_order_acquire);
      return __ldcg(tin + c - tin0);
    };
    int G[kRows4], code[kRows4];
#pragma unroll
    for (int r = 0; r < kRows4; ++r) {
      const int i = a0 + r;
      G[r] = g0(i, k, ql);
      code[r] = (live && i >= 1 && i <= Lq) ? __ldg(qp + i - 1) : (kMask ? 0 : -1);
    }
    // the previous link (the diagonal of the first row): the stage below's
    // top row at column jb - 1; a band's first columns are above its rows,
    // all kInfG but at jb = 1
    int prev = s > 0       ? g0(a0 - 1, k, ql)
               : band == 0 ? kInfG
               : jb > 1    ? seam(jb - 1)
                           : g0(A - 1, k, ql);
    // stage s steps column jb + c, c = step - s; its target code (and stage
    // 0's link from the band below) is fetched a step ahead
    int tnext = (s == 0 && ncols > 0) ? __ldg(tp + jb - 1) : 0;
    int lnext = (band > 0 && s == 0 && ncols > 0) ? seam(jb) : kInfG;
    unsigned in = 0u;  // the link from the stage below, for this step's column
    for (int step = 0; step < ncols + used - 1; ++step) {
      const int c = step - s, j = jb + c;
      const bool act = live && c >= 0 && c < ncols;
      const int tc = tnext;
      const int link = s > 0 ? (int)in : lnext;
      if (live && c + 1 >= 0 && c + 1 < ncols) {
        tnext = __ldg(tp + j);
        if (s == 0 && band > 0) lnext = seam(j + 1);
      }
      // the band's rows at column j; a warp with a stage at the band's
      // bottom takes the masked path, one at its top only the plain chain
      // and a restore, the others the plain chain (one path a warp)
      const int lo = j - k, hi = j + k;
      const bool inband = act && a0 + kRows4 - 1 >= lo && a0 <= hi;
      const bool bottom = __any_sync(kFull, inband && a0 <= lo);
      const bool topped = __any_sync(kFull, inband && a0 + kRows4 - 1 > hi);
      if (act) {
        if (inband) {
          // the link enters where the stage below's top row is in the band
          // (stage 0 of band 0 gets kInfG: row 0 is the boundary)
          int run = a0 - 1 >= lo ? link : kInfG, pv = prev;
          if (!bottom) {
#pragma unroll
            for (int r = 0; r < kRows4; ++r) {  // a three-way min (DPX) a row
              const int old = G[r];
              run = __vimin3_s32(run, old, pv + diag<kMask>(code[r], tc));
              pv = old;
              G[r] = run;
            }
            if (topped) {  // rows past the band's top keep kInfG
#pragma unroll
              for (int r = 0; r < kRows4; ++r)
                if (a0 + r > hi) G[r] = kInfG;
            }
          } else {  // the chain restarts at the band's bottom
#pragma unroll
            for (int r = 0; r < kRows4; ++r) {
              const int i = a0 + r, old = G[r];
              const int cand = __viaddmin_s32(pv, diag<kMask>(code[r], tc), old);
              pv = old;
              run = i > lo ? min(run, cand) : cand;
              if (i <= hi) G[r] = run;
            }
          }
        }
        prev = link;
        if (tout && s == stages - 1) {
          if (j >= tout0) tout[j - tout0] = G[kRows4 - 1];
          if (j % kPublish == 0 || c == ncols - 1)
            Progress(prog[below + 1]).store(j, cuda::memory_order_release);
        }
      }
      in = sd_wide::hand_up((unsigned)G[kRows4 - 1], hand, step);
    }
    // the captured lanes: the band's rows of [t_len - k, t_len + k]
    if (live) {
#pragma unroll
      for (int r = 0; r < kRows4; ++r) {
        const int i = a0 + r, b = i - n + k;
        if (b >= 0 && b < Bw && i <= ql)
          op[b] = (int)min((long long)G[r] + i + n, (long long)kBig);
      }
    }
    __syncthreads();  // every read of `hand` done before the next band writes it
  }
}

// ---------------------------------------------------------------------------
// K5: banded Myers as a pipeline of stages in offset rows
// ---------------------------------------------------------------------------

// K5's and K6's stages: the Peq words of thread s's kWideR words, stage
// s0 + s of a band (word w's bit b is query index 32 w + b + off; indices
// outside [0, qend) match nothing), built a warp's 256 words at once:
// lanes load 32 rows a word, one ballot a code, the owner keeps it. Only
// the warps with a live stage (s < used) load.
__device__ __forceinline__ void load_peq(const int* qp, int qend, int s0, int used, int off,
                                         unsigned (&pq0)[kWideR], unsigned (&pq1)[kWideR],
                                         unsigned (&pq2)[kWideR], unsigned (&pq3)[kWideR]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int r = 0; r < kWideR; ++r) pq0[r] = pq1[r] = pq2[r] = pq3[r] = 0u;
  if (32 * warp >= used) return;  // the whole warp
  const int wbase = (s0 + 32 * warp) * kWideR;
  for (int l = 0; l < 32; ++l) {
#pragma unroll
    for (int r = 0; r < kWideR; ++r) {
      const int x0 = 32 * (wbase + l * kWideR + r) + off;  // bit 0's query index
      if (x0 + 31 >= 0 && x0 < qend) {                    // the whole warp
        const int x = x0 + lane;
        const int code = (x >= 0 && x < qend) ? __ldg(qp + x) : -9;
        const unsigned m0 = __ballot_sync(kFull, code == 0), m1 = __ballot_sync(kFull, code == 1);
        const unsigned m2 = __ballot_sync(kFull, code == 2), m3 = __ballot_sync(kFull, code == 3);
        if (lane == l) {
          pq0[r] = m0;
          pq1[r] = m1;
          pq2[r] = m2;
          pq3[r] = m3;
        }
      }
    }
  }
}

// K5's and K6's band seam: a band's top links by column, a byte each
// (stage_column's link: the carry, HP and HN bits), written by the band's
// last stage and read by the next band's stage 0, which runs after it in
// the same block.
struct TopLinks {
  uint8_t* col;  // null: a pair of one band
  __device__ __forceinline__ void put(int c, unsigned link) const { col[c] = (uint8_t)link; }
  __device__ __forceinline__ unsigned get(int c) const { return col[c]; }
};

// The lowest n bits of a word (none for n <= 0, all for n >= 32).
__device__ __forceinline__ unsigned lowbits(int n) {
  return n >= 32 ? kFull : n <= 0 ? 0u : (1u << n) - 1u;
}

// x << n as PTX's shl computes it: 0 once n, read unsigned, reaches 32 (so
// also for n < 0). One instruction, no branch.
__device__ __forceinline__ unsigned shl(unsigned x, int n) {
  unsigned d;
  asm("shl.b32 %0, %1, %2;" : "=r"(d) : "r"(x), "r"(n));
  return d;
}

// One column of the stage's words with rows below bit lo (of the stage;
// none for lo <= 0) out of the add: no carry leaves them and, their D0
// being 0, they hand HP = +1, HN = 0 to the row above, as the band's bottom
// needs. Their own values become stale, which nothing reads again.
__device__ __forceinline__ int bottom_column(unsigned (&vp)[kWideR], unsigned (&vn)[kWideR],
                                             const unsigned (&eq)[kWideR], unsigned& link,
                                             int hot_r, int hot_b, int lo) {
  unsigned meq[kWideR];
#pragma unroll
  for (int r = 0; r < kWideR; ++r) {
    const unsigned keep = shl(kFull, max(lo - 32 * r, 0));
    vp[r] &= keep;
    vn[r] &= keep;
    meq[r] = eq[r] & keep;
  }
  return sd_wide::stage_column(vp, vn, meq, link, hot_r, hot_b);
}

// Block p runs pair p. Thread s is stage s of every band: the offset rows'
// words (band * stages + s) * kWideR .. + kWideR - 1 (word w holds rows
// 32 w .. 32 w + 31), with their Peq words (query index a - k - 1 at offset
// row a). The band's masks cost a stage almost nothing: the virtual rows a
// <= k are held as VP = VN = 0 (no Peq bit), which a column step leaves as
// they are and which hand HP = +1, HN = 0 and no carry to the row above, as
// the NW boundary needs (their -1 ramp is put back at the capture); the row
// entering the band's top is set to VP = 1, VN = 0 as it enters (the rows
// above it are stepped but read by nothing below); the rows below the
// band's bottom row j > k are masked out of the add (bottom_column, a mask
// that is empty but in the stage holding j: every stage takes the same
// path, with no branch and no vote on the step). The stage holding j also
// steps the anchor. The capture at t_len
// is each stage's words funnel-shifted by t_len & 31, the last word's upper
// part from the next stage (a shared slot) or, at a band's top, added by
// the next band's first stage.
__global__ void __launch_bounds__(kWideMaxStages)
    myers_wide_kernel(const int* __restrict__ q,      // [P, Lq] compact codes (0..3 match)
                      const int* __restrict__ qlens,  // [P]
                      const int* __restrict__ t,      // [P, Lt] compact codes
                      const int* __restrict__ tlens,  // [P]
                      uint8_t* __restrict__ tops,     // [P, Lt + 1] (bands > 1) or null
                      unsigned* __restrict__ cvp,     // [P, W] captured VP
                      unsigned* __restrict__ cvn,     // [P, W] captured VN
                      int* __restrict__ ca,           // [P] captured anchor
                      int Lq, int Lt, int k, int W) {
  __shared__ unsigned hand[2][kWideMaxStages / 32];  // sd_wide::hand_up's slots
  __shared__ unsigned seam[2][kWideMaxStages];       // each stage's first VP / VN word
  __shared__ int anchor;                             // D at band lane 0
  const int p = blockIdx.x, s = threadIdx.x, stages = blockDim.x;
  unsigned* wp = cvp + (long long)p * W;
  unsigned* wn = cvn + (long long)p * W;
  for (int w = s; w < W; w += stages) wp[w] = wn[w] = 0u;
  const int ql = qlens[p], tl = tlens[p];
  const int n = (tl < 0 || tl > Lt) ? -1 : tl;  // -1: never captured (zero planes, anchor k)
  if (s == 0) {
    ca[p] = k;  // the anchor while j <= k
    anchor = k;
  }
  // past q_len + k no captured lane is a row of the query: all BIG
  if (n < 0 || n > ql + k) return;
  __syncthreads();  // zeroed planes and the anchor before any stage writes
  const int hi_row = min(ql + k, n + 2 * k);  // the highest offset row any lane needs
  const int nst = (hi_row >> 5) / kWideR + 1, nb = (nst + stages - 1) / stages;
  const int qend = min(Lq, ql);  // query indices at or past it match nothing
  const int* qp = q + (long long)p * Lq;
  const int* tp = t + (long long)p * Lt;
  const TopLinks top{tops ? tops + (long long)p * (Lt + 1) : nullptr};
  const int mbase = n >> 5, sh = n & 31;            // captured word m: rows n + 32 m ..
  const unsigned topmask = lowbits(2 * k + 1 - 32 * (W - 1));  // the last word's lanes
  for (int band = 0; band < nb; ++band) {
    const int used = band < nb - 1 ? stages : nst - band * stages;
    const bool live = s < used;
    const int sw = (band * stages + s) * kWideR, R0 = 32 * sw;
    const int A = band * stages * kStageRows, aend = A + used * kStageRows - 1;
    // the columns where some of the band's rows lie in [cut, j + 2k]
    const int jb = max(1, A - 2 * k);
    const int ncols = aend >= k + 1 ? max(0, min(n, aend) - jb + 1) : 0;
    // column 0: VP = 1 above row 0 (a > k); the virtual rows held as 0
    unsigned pq0[kWideR], pq1[kWideR], pq2[kWideR], pq3[kWideR], vp[kWideR], vn[kWideR];
#pragma unroll
    for (int r = 0; r < kWideR; ++r) {
      vp[r] = ~lowbits(k + 1 - (R0 + 32 * r));
      vn[r] = 0u;
    }
    load_peq(qp, qend, band * stages, used, -k - 1, pq0, pq1, pq2, pq3);
    // stage s steps column jb + c, c = step - s; its target code (and stage
    // 0's link from the band below) is fetched a step ahead
    int tnext = (s == 0 && ncols > 0) ? __ldg(tp + jb - 1) : -1;
    unsigned lnext = (band > 0 && s == 0 && ncols > 0) ? top.get(jb) : 2u;
    unsigned in = 0u;  // the link from the stage below, for this step's column
    for (int step = 0; step < ncols + used - 1; ++step) {
      const int c = step - s, j = jb + c;
      const bool act = live && c >= 0 && c < ncols;
      const int tc = tnext, cut = max(j, k + 1), hi = j + 2 * k;
      // stage 0 of a later band: the band below's top link where its top
      // row is stepped, else none (no carry, HP = +1)
      unsigned link = s > 0 ? in : (band > 0 && A - 1 >= cut ? lnext : 2u);
      if (live && c + 1 >= 0 && c + 1 < ncols) {
        tnext = __ldg(tp + j);
        if (s == 0 && band > 0) lnext = top.get(j + 1);
      }
      const bool stepped = act && R0 + kStageRows - 1 >= cut && R0 <= hi;
      unsigned out = 2u;  // a stage wholly below cut hands on no carry, HP = +1
      if (act) {
        if (stepped) {
          // every stage takes the same path, no branch: the row entering the
          // top set to VP = 1, VN = 0 (no bit in a stage that does not hold
          // it), and the rows below the band's bottom row j > k kept out of
          // the add (none but in the stage that holds j)
          const int lo = j > k ? j - R0 : 0;
          unsigned eq[kWideR];
#pragma unroll
          for (int r = 0; r < kWideR; ++r) {
            eq[r] = tc == 0 ? pq0[r] : tc == 1 ? pq1[r] : tc == 2 ? pq2[r] : tc == 3 ? pq3[r] : 0u;
            const unsigned enter = shl(1u, hi - R0 - 32 * r);
            vp[r] |= enter;
            vn[r] &= ~enter;
          }
          // the anchor follows row j once j > k: its vertical delta at
          // column j - 1 (none when k = 0: the twin's lane 1 is past the
          // band) and its horizontal one at j
          const bool hold = j > k && j >= R0 && j < R0 + kStageRows;
          const int hot_r = hold ? (j - R0) >> 5 : -1, hot_b = (j - R0) & 31;
          int dv = 0;
          if (hold && k > 0) {
#pragma unroll
            for (int r = 0; r < kWideR; ++r)
              if (r == hot_r) dv = (int)((vp[r] >> hot_b) & 1u) - (int)((vn[r] >> hot_b) & 1u);
          }
          const int dh = bottom_column(vp, vn, eq, link, hot_r, hot_b, lo);
          if (hold) {
            const int a = anchor + dv + dh;
            anchor = a;
            if (j == n) ca[p] = a;
          }
          out = link;
        }
        if (top.col && s == stages - 1 && band < nb - 1) top.put(j, out);
      }
      in = sd_wide::hand_up(out, hand, step);
    }
    // the capture: word m = rows n + 32 m .. + 31, from this stage's word
    // mbase + m and the next word up
    __syncthreads();
    seam[0][s] = vp[0];
    seam[1][s] = vn[0];
    __syncthreads();
    if (live) {
#pragma unroll
      for (int r = 0; r < kWideR; ++r) {
        const int m = sw + r - mbase;
        if (m >= 0 && m < W) {
          const bool next = s + 1 < used;  // else a band's top (its next band adds it) or none
          const unsigned up_p = r + 1 < kWideR ? vp[r + 1] : next ? seam[0][s + 1] : 0u;
          const unsigned up_n = r + 1 < kWideR ? vn[r + 1] : next ? seam[1][s + 1] : 0u;
          const unsigned lanes = m == W - 1 ? topmask : kFull;
          // the virtual rows' -1 ramp, rows 1 .. k
          const int row = n + 32 * m;
          const unsigned ramp = lowbits(k + 1 - row) & ~lowbits(1 - row);
          wp[m] = __funnelshift_r(vp[r], up_p, sh) & lanes;
          wn[m] = (__funnelshift_r(vn[r], up_n, sh) | ramp) & lanes;
        }
      }
      // the upper part of the word below this band's first, which the band
      // below's top stage wrote without it
      const int m = sw - 1 - mbase;
      if (band > 0 && s == 0 && sh > 0 && m >= 0 && m < W) {
        const unsigned lanes = m == W - 1 ? topmask : kFull;
        wp[m] |= (vp[0] << (32 - sh)) & lanes;
        wn[m] |= (vn[0] << (32 - sh)) & lanes;
      }
    }
    __syncthreads();  // every read of `hand`, `seam` and the planes done before the next band
  }
}

// ---------------------------------------------------------------------------
// K6's wide route: full-height Myers as a pipeline of register stages
// ---------------------------------------------------------------------------

// Block g runs segment g % nseg of pair g / nseg: output columns [e_s, e_e),
// e_s = (g % nseg) * S, stepped from j0 = max(0, e_s - 2 q_len) on (exact
// under HW for the reason myers_warp.cu's semi_warp_kernel gives; SHW runs
// nseg = 1). Thread s is stage s of every band: the query's words
// (band * stages + s) * kWideR .. + kWideR - 1. Only the stages up to the
// end row's (bit q_len - 1) run: carries and up-shifts move up only, so no
// word above it reaches D(q_len, j).
__global__ void __launch_bounds__(kWideMaxStages)
    semi_wide_kernel(const int* __restrict__ q,      // [P, Lq] compact codes (0..3 match)
                     const int* __restrict__ qlens,  // [P]
                     const int* __restrict__ t,      // [P, Lt] compact codes
                     uint8_t* __restrict__ tops,     // [P * nseg, ncap] (bands > 1)
                     int* __restrict__ ends,         // [P, Lt]
                     int Lq, int Lt, int W, int stages, unsigned hp0, int nseg, int S,
                     int ncap) {
  __shared__ unsigned hand[2][kWideMaxStages / 32];  // sd_wide::hand_up's slots
  const int g = blockIdx.x, p = g / nseg, e_s = (g % nseg) * S;
  const int e_e = min(Lt, e_s + S);
  const int s = threadIdx.x;
  const int ql = qlens[p];
  int* ep = ends + (long long)p * Lt;
  const int hot_w = ql > 0 ? (ql - 1) >> 5 : -1;
  if (hot_w < 0 || hot_w >= W) {  // no end row among the words: the score stays q_len
    for (int c = e_s + s; c < e_e; c += blockDim.x) ep[c] = ql;
    return;
  }
  const int j0 = max(0, e_s - 2 * ql), ncols = e_e - j0;
  // the end row's stage, its band and its place in the band
  const int hs = hot_w / kWideR, hb = hs / stages, hsl = hs % stages;
  const int hot_r = hot_w % kWideR, hot_b = (ql - 1) & 31;
  const int qend = min(Lq, ql);  // rows at or past it match nothing
  const int* qp = q + (long long)p * Lq;
  const int* tp = t + (long long)p * Lt + j0;
  const TopLinks top{tops ? tops + (long long)g * ncap : nullptr};
  int score = ql;  // D(q_len, j0) = q_len
  for (int band = 0; band <= hb; ++band) {
    const int used = band < hb ? stages : hsl + 1;  // the stages this band runs
    const bool live = s < used, hot = band == hb && s == hsl;
    unsigned pq0[kWideR], pq1[kWideR], pq2[kWideR], pq3[kWideR], vp[kWideR], vn[kWideR];
#pragma unroll
    for (int r = 0; r < kWideR; ++r) {
      vp[r] = kFull;  // column j0: all +1
      vn[r] = 0u;
    }
    load_peq(qp, qend, band * stages, used, 0, pq0, pq1, pq2, pq3);
    // stage s steps column c = step - s; its target code (and stage 0's link
    // from the band below) is fetched a step ahead
    int tnext = (s == 0 && ncols > 0) ? __ldg(tp) : -1;
    unsigned lnext = (band > 0 && s == 0 && ncols > 0) ? top.get(0) : hp0 << 1;
    unsigned in = 0u;  // the link from the stage below, for this step's column
    for (int step = 0; step < ncols + used - 1; ++step) {
      const int c = step - s;
      const bool act = live && c >= 0 && c < ncols;
      const int tc = tnext;
      unsigned link = s > 0 ? in : lnext;
      if (live && c + 1 >= 0 && c + 1 < ncols) {
        tnext = __ldg(tp + c + 1);
        if (s == 0 && band > 0) lnext = top.get(c + 1);
      }
      if (act) {
        unsigned eq[kWideR];
#pragma unroll
        for (int r = 0; r < kWideR; ++r)
          eq[r] = tc == 0 ? pq0[r] : tc == 1 ? pq1[r] : tc == 2 ? pq2[r] : tc == 3 ? pq3[r] : 0u;
        const int d = sd_wide::stage_column(vp, vn, eq, link, hot ? hot_r : -1, hot_b);
        if (hot) {
          score += d;
          if (j0 + c >= e_s) ep[j0 + c] = score;
        }
        if (s == stages - 1 && band < hb) top.put(c, link);
      }
      in = sd_wide::hand_up(link, hand, step);
    }
    __syncthreads();  // every read of `hand` done before the next band writes it
  }
}

}  // namespace

// K4's wide route: q [P, Lq] codes (use_mask: equality bitmasks), qlens [P],
// t [P, Lt] codes (symbol ids), tlens [P], all int32; out [P, 2k + 1] int32.
// `stages` threads a block (a multiple of 32, at most kWideMaxStages) of
// kRows4 rows, cs blocks a pair (a cluster, at most kClusterMax; each runs
// every cs-th band). Where a pair's rows may pass one band (min(Lq, Lt +
// k) + 1 > stages * kRows4), tops is an int32 [P, seams, 2k + 1] scratch of
// the bands' top links and prog an int32 [P, seams] of zeros, seams at
// least the bands such a pair can take less one.
extern "C" int sd_banded_column(const void* q, const void* qlens, const void* t,
                                const void* tlens, void* tops, void* prog, void* out, int P,
                                int Lq, int Lt, int k, int use_mask, int stages, int seams,
                                int cs, void* stream) {
  if (P <= 0) return 0;
  // the most rows a pair can hold: 0 .. min(q_len, t_len + k)
  const long long rows = ((long long)Lt + k < Lq ? (long long)Lt + k : Lq) + 1;
  const long long RB = (long long)stages * kRows4;
  if (k < 0 || stages < 32 || stages > kWideMaxStages || stages % 32 || cs < 1 ||
      cs > kClusterMax || (long long)P * cs > 0x7fffffffLL ||
      (rows > RB && (!tops || !prog || seams < (rows + RB - 1) / RB - 1)))
    return (int)cudaErrorInvalidValue;
  auto kern = use_mask ? banded_wide_kernel<true> : banded_wide_kernel<false>;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;  // a pair's blocks run at once
  attr[0].val.clusterDim.x = cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(P * cs));
  cfg.blockDim = dim3(stages);
  cfg.stream = (cudaStream_t)stream;
  cfg.attrs = attr;
  cfg.numAttrs = cs > 1 ? 1 : 0;
  const cudaError_t err =
      cudaLaunchKernelEx(&cfg, kern, (const int*)q, (const int*)qlens, (const int*)t,
                         (const int*)tlens, (int*)tops, (int*)prog, (int*)out, Lq, Lt, k, seams,
                         cs);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// K5's wide route: q [P, Lq], t [P, Lt] int32 compact codes, qlens, tlens
// [P]; cvp, cvn [P, W] (W = ceil((2k + 1) / 32)) and ca [P] out. `stages`
// as K4's, of kWideR words; where a pair's words may pass one band
// (min(Lq + k, Lt + 2k) / 32 + 1 > stages * kWideR), tops is a byte [P, Lt
// + 1] scratch.
extern "C" int sd_banded_myers(const void* q, const void* qlens, const void* t,
                               const void* tlens, void* tops, void* cvp, void* cvn, void* ca,
                               int P, int Lq, int Lt, int k, int W, int stages, void* stream) {
  if (P <= 0) return 0;
  // the highest offset row a pair can hold: min(q_len + k, t_len + 2k)
  const long long hi = (long long)Lq + k < (long long)Lt + 2LL * k ? (long long)Lq + k
                                                                     : (long long)Lt + 2LL * k;
  if (k < 0 || W != (2 * k + 1 + 31) / 32 || stages < 32 || stages > kWideMaxStages ||
      stages % 32 || (!tops && hi / 32 + 1 > (long long)stages * kWideR))
    return (int)cudaErrorInvalidValue;
  myers_wide_kernel<<<P, stages, 0, (cudaStream_t)stream>>>(
      (const int*)q, (const int*)qlens, (const int*)t, (const int*)tlens, (uint8_t*)tops,
      (unsigned*)cvp, (unsigned*)cvn, (int*)ca, Lq, Lt, k, W);
  return (int)cudaGetLastError();
}

// K6's wide route: q [P, Lq], t [P, Lt] int32 compact codes, qlens [P];
// ends [P, Lt]. W = max(1, ceil(Lq / 32)) words in bands of `stages` stages
// (threads: a multiple of 32, at most kWideMaxStages) of kWideR words,
// bands * stages * kWideR >= W. nseg segments of S columns a pair (nseg * S
// >= Lt; nseg > 1 only under HW, hp0 = 0, and S a multiple of 32); where
// bands > 1, tops is a [P * nseg, ncap] byte scratch, ncap >= min(Lt, S +
// 64 W) (a segment's columns and its warm-up).
extern "C" int sd_semi_wide(const void* q, const void* qlens, const void* t, void* tops,
                            void* ends, int P, int Lq, int Lt, int W, int stages, int bands,
                            int hp0, int nseg, int S, int ncap, void* stream) {
  if (P <= 0 || Lt <= 0) return 0;
  const long long span = (long long)S + 64LL * W;  // a segment's columns and its warm-up
  if (W != (Lq > 32 ? (Lq + 31) / 32 : 1) || stages < 32 || stages > kWideMaxStages ||
      stages % 32 || bands < 1 || (long long)bands * stages * kWideR < W || nseg < 1 ||
      (long long)nseg * S < Lt || (nseg > 1 && (hp0 || S % 32 != 0)) ||
      (long long)P * nseg > 0x7fffffffLL ||
      (bands > 1 && (!tops || ncap < (span < Lt ? span : (long long)Lt))))
    return (int)cudaErrorInvalidValue;
  semi_wide_kernel<<<(unsigned)(P * nseg), stages, 0, (cudaStream_t)stream>>>(
      (const int*)q, (const int*)qlens, (const int*)t, (uint8_t*)tops, (int*)ends, Lq, Lt, W,
      stages, hp0 ? 1u : 0u, nseg, S, ncap);
  return (int)cudaGetLastError();
}

// Blocks of K6's wide kernel at `stages` threads that one SM holds at once
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor at its registers).
extern "C" int sd_semi_wide_occupancy(int stages, int* blocks) {
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, semi_wide_kernel, stages, 0);
}
