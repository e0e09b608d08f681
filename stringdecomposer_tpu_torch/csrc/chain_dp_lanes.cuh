// K1's shared route for monomer sets padded to L <= 512: the lanes body.
//
// Replaces stringdecomposer_tpu/ops/chain_dp_pallas.py::_dp_kernel, as the
// chunked body in chain_dp.cuh does, with the same recurrence, tie rules,
// inputs and outputs (end and spend [B, W, M] in the state type T):
//   cand = max(enter = chain(i-1) + mm + k*del, diag + mm, ins)
//   dp[k] = k*del + prefix-max_k(cand - k*del), the earliest k winning a tie,
//   sp[k] the payload of that k: ins (unguarded at k == 0), diag, enter.
// ops/chain_dp.sweep_lanes is its plain mirror, step for step.
//
// What bounds it on the H100: the read position is a strict sequential axis
// (the chain score at i is the max over every row's end cell at i-1), so the
// time is that of one position times W, and one position is a little work
// (M*L cells) spread over the warps of one block, on one SM. The chunked
// body walks a row in 32-cell chunks, each a dependent chain of ~21 warp
// shuffles (shift, a score scan, a pair scan, carries), with two barriers per
// position. This body cuts the chain and the instructions per cell, so that
// what is left is the rate at which one SM runs integer instructions (~14 a
// cell and ~70 a row, a position, for every warp of the window):
//   - Lane l owns the C = ceil(L / 32) cells l*C .. l*C + C - 1 of a row. It
//     computes each cell's candidate and payload in registers, then a
//     sequential pair prefix over its C cells. The diag neighbour of its
//     first cell is lane l-1's last: one shuffle for the score and one for
//     the pointer per row.
//   - One pair scan (5 steps) over the 32 lane totals, shifted to an
//     exclusive prefix; a cell keeps its in-lane prefix only where it is
//     strictly greater, so ties keep the earlier lanes. The payload is taken
//     from the candidate before the fold, as in the Pallas kernel: under a
//     full prefix max the scan carries the payload only of an earliest
//     argmax k', where the folded prefix equals cand(k') - k'*del, so this is
//     the pointer the chunked body derives after the fold.
//   - The row is kept folded, q[k] = dp[k] - k*del, so that no cell adds or
//     removes k*del: enter - k*del = chain + mm, diag - k*del = q[k-1] + mm -
//     del, ins - k*del = q[k] + ins, and only the end cell is unfolded when
//     it is emitted.
//   - The end scores are double-buffered by position parity in shared
//     memory: at position i every warp reads ends[(i-1) & 1] for the chain
//     max and writes ends[i & 1]; one barrier per position orders the next
//     read and the next overwrite.
//   - M <= 32 (kRegRows): each row's scores, pointers and monomer codes
//     (four to a register) stay in one warp's registers for all W
//     positions. At C <= 8 a warp holds one row, on up to 32 warps (1,024
//     threads, so at most 64 registers a thread: C = 8 takes 61). Above, a
//     row's 2C + ceil(C / 4) values do not fit 64 registers, so a warp
//     holds two rows, rows w and w + warps, on at most 16 warps (512
//     threads, up to 128 registers; lanes_reg_rows) and steps them one
//     after the other: the same row work a position as one warp a row,
//     with no shared-memory round trip.
//     More rows (kRowsDense, kRows): each row lives in shared
//     memory, L cells of it, and is loaded into registers for its update and
//     stored back; each warp keeps its rows' lengths in a register. The F =
//     L / C full lanes keep their cell c at c*F + lane, so that for each c a
//     warp touches consecutive elements (no bank conflicts), and the partial
//     lane F keeps its cells at F*C + c; where L == 32*C (kRowsDense) every
//     lane is full and the offsets c*32 are known at compile time. The shared
//     memory is chain_dp_smem_bytes(M, L, sizeof(T)), as for the chunked
//     body: the parity buffers take the place of its lengths array.
// Arithmetic is int32 in registers; T is used where values are stored (the
// multi-row column, end and spend), as in the chunked body. The folded
// scores fit T: the int16 range checks bound (W + L) * max|score| below
// 2^13, so |q| < 2^14.
// kVariant (chain_dp_variant.cuh) is one of A's ablations, each removing one
// cost centre of this body (instantiated only in chain_dp_ablate.cu, at
// <int, 6, kRegRows>): nochain takes a row's chain score from its own end
// cell at i-1 (one shuffle from the lane that owns it) and drops the chain
// max, the parity buffer's writes and the per-position barrier; ladder4 and
// ladder2 stop the pair scan over the 32 lane totals after 4 or 2 doubling
// steps; noemit writes end and spend only at the last position; noshift
// takes diag from the cell's own value and pointer at i-1 (q[c] + mm in the
// folded form) and drops the two shuffles of the upper-left neighbour.

#pragma once

#include <limits.h>

#include "chain_dp.cuh"
#include "chain_dp_variant.cuh"

namespace {

constexpr int kLanesMaxC = 16;  // 32 lanes x 16 cells: L <= 512

// One row at one read position, in place on the lane's registers: q and s
// hold the row's folded scores and pointers at i-1 on entry and at i on
// return; is_match(c) says whether cell c's monomer code equals the read's.
// The lane that owns the end cell n-1 calls emit(e, se) with the row's end
// score and pointer; the caller's emit stores them (this body: ends_i[m],
// end_i[m], spend_i[m]; the cluster body, chain_dp_cluster.cuh, also into
// every block of the cluster). kVariant: see the top of this file (the
// nochain variant ignores `chain`).
template <typename T, int C, int kVariant = kBase, class Match, class Emit>
__device__ __forceinline__ void lanes_row(int (&q)[C], int (&s)[C], Match is_match, int lane,
                                          int n, int i, int chain, int ins, int dele,
                                          int mismatch, int match, Emit emit) {
  constexpr int kNeg = StateNeg<T>::value;
  constexpr bool kShift = kVariant != kNoShift;
  if constexpr (kVariant == kNoChain) {  // the row's own end score at i-1, from its lane
    const int le = (n - 1) / C, ce = n - 1 - le * C;
    int qe = q[0];
#pragma unroll
    for (int c = 1; c < C; ++c)
      if (c == ce) qe = q[c];
    chain = __shfl_sync(kFull, qe, le) + (n - 1) * dele;
  }
  const int enter_y = chain + match, enter_n = chain + mismatch;  // enter - k*del
  // diag - k*del - q[k-1] (noshift: - q[k])
  const int diag_y = kShift ? match - dele : match, diag_n = kShift ? mismatch - dele : mismatch;
  // the diag neighbour of the lane's first cell: lane l-1's last cell at i-1
  int up_q = 0, up_s = 0;
  if constexpr (kShift) {
    up_q = __shfl_up_sync(kFull, q[C - 1], 1);
    up_s = __shfl_up_sync(kFull, s[C - 1], 1);
    if (lane == 0) up_s = 0;  // k == 0: diag is kNeg, its pointer 0
  }
  int run_t = 0, run_c = 0;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    if constexpr (!kShift) {  // noshift: the cell's own value and pointer at i-1
      up_q = q[c];
      up_s = s[c];
    }
    const bool first = c == 0 && lane == 0;  // k == 0
    const bool y = is_match(c);
    const int enter = y ? enter_y : enter_n;
    const int diag = first ? kNeg : up_q + (y ? diag_y : diag_n);
    const int ins_u = q[c] + ins;  // unguarded: the payload's ins check at k == 0
    const int t = max(enter, max(diag, first ? kNeg : ins_u));
    const int cs = t == ins_u ? s[c] : (t == diag ? up_s : i);
    up_q = q[c];
    up_s = s[c];
    if (c == 0 || t > run_t) {  // in-lane pair prefix: a later cell wins only when greater
      run_t = t;
      run_c = cs;
    }
    q[c] = run_t;
    s[c] = run_c;
  }
  // inclusive pair scan over the 32 lane totals (ladder4 / ladder2: cut after
  // 4 / 2 steps), then shifted to exclusive
  int tt = run_t, tc = run_c;
#pragma unroll
  for (int o = 1; o < variant_scan_end<kVariant>(); o <<= 1) {
    const int ut = __shfl_up_sync(kFull, tt, o);
    const int uc = __shfl_up_sync(kFull, tc, o);
    if (lane >= o && !(tt > ut)) {
      tt = ut;
      tc = uc;
    }
  }
  int et = __shfl_up_sync(kFull, tt, 1);
  const int ec = __shfl_up_sync(kFull, tc, 1);
  if (lane == 0) et = INT_MIN;  // no earlier lane: every cell keeps its own prefix
  const int le = (n - 1) / C, ce = n - 1 - le * C;  // the end cell's lane and cell
  int qe = 0, se = 0;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    if (!(q[c] > et)) {  // ties keep the earlier lanes
      q[c] = et;
      s[c] = ec;
    }
    if (c == 0 || c == ce) {
      qe = q[c];
      se = s[c];
    }
  }
  if (lane == le) emit(qe + (n - 1) * dele, se);
}

// The lanes body's emit: the end score into this block's parity buffer and
// the outputs, row m (nochain: no parity buffer; noemit: the outputs only
// where `out`, at the last position).
template <typename T, int kVariant = kBase>
struct LanesEmit {
  int* ends_i;
  T* end_i;
  T* spend_i;
  int m;
  bool out = true;
  __device__ __forceinline__ void operator()(int e, int se) const {
    if constexpr (kVariant != kNoChain) ends_i[m] = e;
    if (kVariant != kNoEmit || out) {
      end_i[m] = (T)e;
      spend_i[m] = (T)se;
    }
  }
};

// The kernel's three forms (see the top of this file).
enum LanesPath : int { kRegRows = 0, kRowsDense = 1, kRows = 2 };

// Rows a warp holds in registers in the kRegRows form: one up to C = 8, two
// above (see the top of this file).
template <int C>
__host__ __device__ constexpr int lanes_reg_rows() {
  return C <= 8 ? 1 : 2;
}

// Threads of one block: in the kRegRows form a warp for every
// lanes_reg_rows rows (up to 1024 or 512); for more rows 32 warps, or 16
// where a row in registers needs more than the 64 registers a thread of
// 1024 can have (C >= 7, and C = 6 with offsets computed at run time). The
// bound's 1 (one block an SM) keeps ptxas from spilling to fit two blocks
// an SM.
template <int C, int kPath>
constexpr int lanes_max_threads() {
  return kPath == kRegRows ? 1024 / lanes_reg_rows<C>()
                           : (C <= 5 || (C == 6 && kPath == kRowsDense) ? 1024 : 512);
}

template <typename T, int C, int kPath, int kVariant = kBase>
__global__ void __launch_bounds__(lanes_max_threads<C, kPath>(), 1)
chain_dp_lanes_kernel(const int8_t* __restrict__ windows,  // [B, W]
                      int W,
                      const int8_t* __restrict__ mono,  // [M, L] or [B, M, L]
                      long long mono_bstride,
                      const int* __restrict__ mono_lens,  // [M] or [B, M]
                      long long lens_bstride,
                      const T* __restrict__ dp0,  // [B, M, L] column i = 0
                      T* __restrict__ end,        // [B, W, M]
                      T* __restrict__ spend,      // [B, W, M]
                      int M, int L, int ins, int dele, int mismatch, int match) {
  constexpr int kNeg = StateNeg<T>::value;
  constexpr int kWords = (C + 3) / 4;
  constexpr bool kRegs = kPath == kRegRows;
  constexpr int kP = kRegs ? lanes_reg_rows<C>() : 1;  // rows a warp holds in registers
  extern __shared__ int smem[];
  int* ends = smem;  // [2][M] end-cell scores, by position parity
  // several rows a warp: [M][L] folded scores, pointers and codes, cell c of
  // this lane at x0 + c * dx in its row
  T* qs = reinterpret_cast<T*>(ends + 2 * M);
  T* ss = qs + M * L;
  int8_t* mcs = reinterpret_cast<int8_t*>(ss + M * L);

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const int b = blockIdx.x;
  const int k0 = lane * C;
  const int F = L / C;
  const int x0 = kPath == kRowsDense ? lane : (lane < F ? lane : F * C);
  const int dx = kPath == kRowsDense ? 32 : (lane < F ? F : 1);
  const int8_t* win = windows + (long long)b * W;
  const int8_t* mono_b = mono + b * mono_bstride;
  const int* lens_b = mono_lens + b * lens_bstride;
  const T* dp0_b = dp0 + (long long)b * M * L;
  T* end_i = end + (long long)b * W * M;  // advanced by M a position
  T* spend_i = spend + (long long)b * W * M;

  for (int m = threadIdx.x; m < M; m += blockDim.x) {
    const int n = min(max(lens_b[m], 0), L);
    const int e = n > 0 ? (int)dp0_b[(long long)m * L + n - 1] : kNeg;
    ends[m] = e;
    ends[M + m] = kNeg;  // rows of length 0 keep kNeg in both buffers
    if (kVariant != kNoEmit || W == 1) {
      end_i[m] = (T)e;
      spend_i[m] = 0;
    }
  }
  // kRegs: row p of this warp is m = warp + p * nwarps, its cells in q[p],
  // s[p] and codes[p] (cell c in byte c % 4 of word c / 4), its length in
  // n_reg[p] (0 past M); else q[0] and s[0] hold the row being stepped
  int q[kP][C], s[kP][C];
  unsigned codes[kP][kWords];
  int n_reg[kP];
  int n_own = 0;  // the shared-memory forms: the length of row warp + lane * nwarps
  const int chain_reads = lane < M ? (M - 1 - lane) / 32 + 1 : 0;  // ends this lane reads
  if constexpr (kRegs) {
#pragma unroll
    for (int p = 0; p < kP; ++p) {
      const int m = warp + p * nwarps;  // at kP == 1 the launch gives every row a warp
      n_reg[p] = kP == 1 || m < M ? min(max(lens_b[m], 0), L) : 0;
#pragma unroll
      for (int w = 0; w < kWords; ++w) codes[p][w] = 0xffffffffu;  // 0xff never equals a read code
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const int k = k0 + c;
        const bool valid = k < n_reg[p];
        q[p][c] = valid ? (int)dp0_b[(long long)m * L + k] - k * dele : kNeg;
        s[p][c] = 0;
        if (valid) {
          const unsigned code = (unsigned)(uint8_t)mono_b[(long long)m * L + k];
          codes[p][c / 4] =
              (codes[p][c / 4] & ~(0xffu << (8 * (c % 4)))) | (code << (8 * (c % 4)));
        }
      }
    }
  } else {
    const int mo = warp + lane * nwarps;
    if (mo < M) n_own = min(max(lens_b[mo], 0), L);
    for (int m = warp; m < M; m += nwarps) {  // each warp fills the rows it owns
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const int k = k0 + c;
        if (k < L) {
          const int x = m * L + x0 + c * dx;
          qs[x] = (T)((int)dp0_b[(long long)m * L + k] - k * dele);
          ss[x] = 0;
          mcs[x] = mono_b[(long long)m * L + k];
        }
      }
    }
  }
  __syncthreads();

  int rc_next = W > 1 ? win[1] : 0;
  for (int i = 1; i < W; ++i) {
    const int rc = rc_next;
    if (i + 1 < W) rc_next = win[i + 1];
    const int* prev = ends + ((i - 1) & 1) * M;
    int* cur = ends + (i & 1) * M;
    end_i += M;
    spend_i += M;
    const bool out = kVariant != kNoEmit || i == W - 1;  // end / spend written at i
    int chain = kNeg;
    if constexpr (kVariant != kNoChain) {
      if constexpr (kRegs) {
        if (lane < M) chain = prev[lane];
      } else {
#pragma unroll 1
        for (int r = 0; r < chain_reads; ++r) chain = max(chain, prev[lane + 32 * r]);
      }
      chain = warp_max(chain);
    }
    if constexpr (kRegs) {
#pragma unroll
      for (int p = 0; p < kP; ++p) {
        const int m = warp + p * nwarps;
        if (kP > 1 && m >= M) continue;
        if (n_reg[p] == 0) {
          if (lane == 0 && out) {
            end_i[m] = (T)kNeg;
            spend_i[m] = 0;
          }
          continue;
        }
        const unsigned rc4 = (unsigned)(rc & 0xff) * 0x01010101u;  // the read's code, 4 times
        lanes_row<T, C, kVariant>(q[p], s[p], [&](int c) {
                                    return ((codes[p][c / 4] ^ rc4) & (0xffu << (8 * (c % 4)))) ==
                                           0;
                                  },
                                  lane, n_reg[p], i, chain, ins, dele, mismatch, match,
                                  LanesEmit<T, kVariant>{cur, end_i, spend_i, m, out});
      }
    } else {
      int j = 0;
      for (int m = warp; m < M; m += nwarps, ++j) {
        const int n = j < 32 ? __shfl_sync(kFull, n_own, j & 31)
                             : min(max(lens_b[m], 0), L);
        if (n == 0) {
          if (lane == 0 && out) {
            end_i[m] = (T)kNeg;
            spend_i[m] = 0;
          }
          continue;
        }
        T* qr = qs + m * L + x0;
        T* sr = ss + m * L + x0;
        const int8_t* cr = mcs + m * L + x0;
        unsigned eq = 0;  // bit c: cell c's code equals the read's
#pragma unroll
        for (int c = 0; c < C; ++c) {
          const bool valid = k0 + c < n;
          q[0][c] = valid ? (int)qr[c * dx] : kNeg;
          s[0][c] = valid ? (int)sr[c * dx] : 0;
          if (valid && cr[c * dx] == rc) eq |= 1u << c;
        }
        lanes_row<T, C, kVariant>(q[0], s[0], [&](int c) { return (eq >> c) & 1u; }, lane, n, i,
                                  chain, ins, dele, mismatch, match,
                                  LanesEmit<T, kVariant>{cur, end_i, spend_i, m, out});
#pragma unroll
        for (int c = 0; c < C; ++c) {
          if (k0 + c < n) {
            qr[c * dx] = (T)q[0][c];
            sr[c * dx] = (T)s[0][c];
          }
        }
      }
    }
    // ends[i & 1] complete before the next chain max and overwrite
    if constexpr (kVariant != kNoChain) __syncthreads();
  }
}

// The launch of one instance: a block a window, M <= 32 rows in registers
// (kRegRows) or the rows in shared memory.
template <typename T, int C, int kPath, int kVariant = kBase>
int launch_lanes_k(const void* windows, const void* mono, long long mono_bstride,
                   const void* mono_lens, long long lens_bstride, const void* dp0, void* end,
                   void* spend, int B, int W, int M, int L, int ins, int dele, int mismatch,
                   int match, void* stream) {
  auto kernel = chain_dp_lanes_kernel<T, C, kPath, kVariant>;
  const long long smem = kPath == kRegRows ? 2LL * M * 4 : chain_dp_smem_bytes(M, L, sizeof(T));
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  constexpr int kP = lanes_reg_rows<C>();
  const int threads =
      kPath == kRegRows ? 32 * ((M + kP - 1) / kP) : lanes_max_threads<C, kPath>();
  kernel<<<B, threads, (size_t)smem, (cudaStream_t)stream>>>(
      (const int8_t*)windows, W, (const int8_t*)mono, mono_bstride, (const int*)mono_lens,
      lens_bstride, (const T*)dp0, (T*)end, (T*)spend, M, L, ins, dele, mismatch, match);
  return (int)cudaGetLastError();
}

template <typename T, int C>
int launch_lanes_c(const void* windows, const void* mono, long long mono_bstride,
                   const void* mono_lens, long long lens_bstride, const void* dp0, void* end,
                   void* spend, int B, int W, int M, int L, int ins, int dele, int mismatch,
                   int match, void* stream) {
  auto launch = M <= 32 ? launch_lanes_k<T, C, kRegRows>
                        : (L == 32 * C ? launch_lanes_k<T, C, kRowsDense>
                                       : launch_lanes_k<T, C, kRows>);
  return launch(windows, mono, mono_bstride, mono_lens, lens_bstride, dp0, end, spend, B, W, M,
                L, ins, dele, mismatch, match, stream);
}

template <typename T>
int launch_lanes(const void* windows, const void* mono, long long mono_bstride,
                 const void* mono_lens, long long lens_bstride, const void* dp0, void* end,
                 void* spend, int B, int W, int M, int L, int ins, int dele, int mismatch,
                 int match, void* stream) {
#define SD_LANES_CASE(CC)                                                                 \
  case CC:                                                                                \
    return launch_lanes_c<T, CC>(windows, mono, mono_bstride, mono_lens, lens_bstride, dp0, \
                                 end, spend, B, W, M, L, ins, dele, mismatch, match, stream);
  switch ((L + 31) / 32) {
    SD_LANES_CASE(1)
    SD_LANES_CASE(2)
    SD_LANES_CASE(3)
    SD_LANES_CASE(4)
    SD_LANES_CASE(5)
    SD_LANES_CASE(6)
    SD_LANES_CASE(7)
    SD_LANES_CASE(8)
    SD_LANES_CASE(9)
    SD_LANES_CASE(10)
    SD_LANES_CASE(11)
    SD_LANES_CASE(12)
    SD_LANES_CASE(13)
    SD_LANES_CASE(14)
    SD_LANES_CASE(15)
    SD_LANES_CASE(16)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef SD_LANES_CASE
}

}  // namespace
