// K1's bodies past L = 512: the tiled body (the shared route, a window on
// one block) and the tiled cluster body (the large route, a window's rows
// over a thread block cluster).
//
// Replaces stringdecomposer_tpu/ops/chain_dp_pallas.py::_dp_kernel (the
// pallas_call at :482, through chain_dp_forward_pallas), as the lanes,
// cluster and chunked bodies do, with the same recurrence, tie rules, inputs
// and outputs (end and spend [B, W, M] in the state type T):
//   cand = max(enter = chain(i-1) + mm + k*del, diag + mm, ins)
//   dp[k] = k*del + prefix-max_k(cand - k*del), the earliest k winning a tie,
//   sp[k] the payload of that k: ins (unguarded at k == 0), diag, enter.
// ops/chain_dp.sweep_tiled (and sweep_cluster with warps_per_row) is its
// plain mirror, step for step.
//
// What bounds it on the H100: the read position is a strict sequential axis,
// so a window costs W times one position, and one position is M*L cells on
// the SMs of one window. Past L = 512 the lanes body's rows no longer fit
// registers (C = ceil(L / 32) > 16 cells a lane), and the chunked body
// walked a row in 32-cell chunks, each a dependent chain of ~21 warp
// shuffles: 17 chunks at L = 528, 65 at the 2,056 bp DXZ1 HOR unit, 536 at a
// 17 kbp unit, with one or two warps a row. This body keeps the lanes body's
// row step and moves the cells to shared memory, so what is left is the rate
// at which an SM issues integer instructions (~22 a cell, loads and stores
// included), plus a fixed part a position (the chain max, one scan, the
// barriers, on the large route the exchange):
//   - Row layout: a row's L cells are padded to P = 32 * G * C: G warps a
//     row (ops/chain_dp_cuda.tiled_layout picks G and C), lane l of warp g
//     owning the C contiguous cells k = g*32C + l*C + c. Cell c of a lane sits at c*32 + l of its warp's
//     segment, so that a warp's loads and stores of one c touch 32
//     consecutive elements (no bank conflicts); the monomer codes sit four
//     to a word, word w of a lane at w*32 + l.
//   - The lane walks its cells in register tiles of kTile, in a runtime
//     loop: a tile's scores, pointers and code words are loaded together,
//     then each cell's candidate and payload are computed as in the lanes
//     body (lanes_row) and the sequential in-lane pair prefix carried from
//     tile to tile; the cells past the last whole tile go one at a time.
//     Then one 5-step pair scan over the 32 lane totals gives each lane the
//     exclusive prefix of its warp's earlier lanes.
//   - Long rows are split over G > 1 warps where a block has few rows (the
//     layout fills the SM's four schedulers, no more: the bodies are bound
//     by the integer issue of the SM, and every warp of a row adds its own
//     scan and carry to a position): each warp writes its total to shared memory, one
//     block barrier, then each warp takes the earliest argmax of the earlier
//     warps' totals (a max, a ballot and a shuffle) as its carry. The diag
//     neighbour of a warp's first cell (the previous warp's last cell at i-1)
//     comes from a small buffer each warp writes at the end of a position,
//     double-buffered by position parity like the end scores.
//   - Lazy fix-up: a cell keeps its in-lane prefix only where it is
//     strictly greater than the exclusive carry of the earlier lanes and
//     warps (ties keep the earlier cells). Instead of a second pass over the
//     cells, a position stores each cell's in-lane prefix and each lane's
//     carry; the next position applies the carry as it loads the cell (a
//     compare and two selects), and the end cell and a warp's last cell
//     apply it at once. One pass over the cells a position, 2 loads and 2
//     stores a cell plus a quarter load of codes.
//   - Rows are kept folded, q[k] = dp[k] - k*del, as in the lanes body.
//   - End scores: double-buffered by position parity, ends[2][M]. The shared
//     route writes its own block's and ends a position with __syncthreads;
//     the cluster body stores each end score into every block of the cluster
//     (st.shared::cluster, ClusterEmit) and ends a position with one cluster
//     barrier, as chain_dp_cluster.cuh argues.
//   - The grid route past 512 (kGrid, chain_dp_grid.cuh): a window's rows
//     over K clusters as the tiled cluster body holds them; or, in the
//     split form, a row too long for one block over S blocks of G warps:
//     each warp pushes its total into the later blocks of its row and takes
//     its carry after a cluster barrier, and a block's last cell at i - 1
//     is pushed into the next block as its first cell's diag neighbour.
// Arithmetic is int32 in registers; T is used where values are stored (the
// rows, end and spend). The folded scores fit T: the int16 range checks
// bound (W + L) * max|score| below 2^13, so |q| < 2^14; carries are int32.

#include <limits.h>

#include "chain_dp_cluster.cuh"

namespace {

constexpr int kTile = 8;          // cells a lane loads into registers at once
constexpr int kTiledWarps = 32;   // warps a block at most

// Threads of a block: a warp a row segment, at most kTiledWarps.
inline int tiled_threads(int R, int G) { return 32 * (R * G < kTiledWarps ? R * G : kTiledWarps); }

// Same formula as ops/chain_dp_cuda.tiled_smem_bytes: the parity buffers of
// all M rows; a carry (8 bytes) for every lane of the R * G segments, and
// where G > 1 a warp total and two boundary cells a segment; the R rows'
// scores and pointers (P = 32 G C cells) and code words (ceil(C / 4) a lane).
inline long long tiled_smem_bytes(int M, int R, int G, int C, int state_bytes) {
  const long long P = 32LL * G * C, S = (long long)R * G;
  return 8LL * M + S * (256 + (G > 1 ? 24 : 0)) +
         (long long)R * (2 * state_bytes * P + 128LL * G * ((C + 3) / 4));
}

// One cell, in place: q and s hold the cell's stored in-lane prefix of the
// last position on entry (its value at i-1 is that, or the lane's carry oc
// where that is not strictly greater) and its in-lane prefix at i on return.
// up_q, up_s: the previous cell at i-1 (k - 1), advanced to this one; first:
// the cell is k == 0. The steps are lanes_row's (chain_dp_lanes.cuh).
__device__ __forceinline__ void tiled_cell(int& q, int& s, bool y, bool first, int2 oc,
                                           int& up_q, int& up_s, int& run_t, int& run_c, int i,
                                           int enter_y, int enter_n, int diag_y, int diag_n,
                                           int ins, int neg) {
  const bool keep = q > oc.x;
  const int qo = keep ? q : oc.x, so = keep ? s : oc.y;  // the cell at i-1
  const int enter = y ? enter_y : enter_n;
  const int diag = first ? neg : up_q + (y ? diag_y : diag_n);
  const int ins_u = qo + ins;  // unguarded: the payload's ins check at k == 0
  const int t = max(enter, max(diag, first ? neg : ins_u));
  const int cs = t == ins_u ? so : (t == diag ? up_s : i);
  up_q = qo;
  up_s = so;
  if (t > run_t) {  // in-lane pair prefix: a later cell wins only when greater
    run_t = t;
    run_c = cs;
  }
  q = run_t;
  s = run_c;
}

// The lane's in-lane pass over its C cells of one segment: qr, sr and cr
// point at its cell 0 and code word 0 (cell c at [32 c], word w at [32 w]);
// returns its total (run_t, run_c) and leaves the in-lane prefixes stored.
template <typename T>
__device__ __forceinline__ void tiled_pass(T* qr, T* sr, const unsigned* cr, int C, int2 oc,
                                           int up_q, int up_s, bool first_lane, unsigned rc4,
                                           int i, int enter_y, int enter_n, int diag_y,
                                           int diag_n, int ins, int neg, int& run_t,
                                           int& run_c) {
  run_t = INT_MIN;  // below every candidate: the first cell always starts the prefix
  run_c = 0;
  int c0 = 0;
#pragma unroll 1
  for (; c0 + kTile <= C; c0 += kTile) {
    int q[kTile], s[kTile];
    unsigned x[kTile / 4];
#pragma unroll
    for (int j = 0; j < kTile; ++j) {
      q[j] = (int)qr[(c0 + j) * 32];
      s[j] = (int)sr[(c0 + j) * 32];
    }
#pragma unroll
    for (int w = 0; w < kTile / 4; ++w) x[w] = cr[(c0 / 4 + w) * 32] ^ rc4;
    const bool first = first_lane && c0 == 0;
#pragma unroll
    for (int j = 0; j < kTile; ++j) {
      const bool y = (x[j / 4] & (0xffu << (8 * (j % 4)))) == 0;
      tiled_cell(q[j], s[j], y, j == 0 && first, oc, up_q, up_s, run_t, run_c, i, enter_y,
                 enter_n, diag_y, diag_n, ins, neg);
    }
#pragma unroll
    for (int j = 0; j < kTile; ++j) {
      qr[(c0 + j) * 32] = (T)q[j];
      sr[(c0 + j) * 32] = (T)s[j];
    }
  }
#pragma unroll 1
  for (int c = c0; c < C; ++c) {  // the cells past the last whole tile
    int q = (int)qr[c * 32], s = (int)sr[c * 32];
    const unsigned x = cr[(c / 4) * 32] ^ rc4;
    const bool y = (x & (0xffu << (8 * (c % 4)))) == 0;
    tiled_cell(q, s, y, first_lane && c == 0, oc, up_q, up_s, run_t, run_c, i, enter_y, enter_n,
               diag_y, diag_n, ins, neg);
    qr[c * 32] = (T)q;
    sr[c * 32] = (T)s;
  }
}

// The grid route's (kGrid, chain_dp_grid.cuh): the parity buffers of the
// cluster's Me rows and the exchange's two ints; for each of the R * G
// segments a carry per lane, and where a row spans warps (G > 1 or S > 1)
// two boundary cells; the warp totals (S * G of the row's warps where it
// spans S > 1 blocks, else R * G where G > 1) and, split, the two boundary
// cells the previous block pushes; the rows, P = 32 G C cells each.
inline long long grid_tiled_smem_bytes(int Me, int R, int G, int C, int S, int state_bytes) {
  const long long P = 32LL * G * C, Sg = (long long)R * G;
  const long long NT = S > 1 ? (long long)S * G : (G > 1 ? Sg : 0);
  return 8LL * Me + 8 + 256 * Sg + 8 * NT + (G > 1 || S > 1 ? 16 * Sg : 0) + (S > 1 ? 16 : 0) +
         (long long)R * (2 * state_bytes * P + 128LL * G * ((C + 3) / 4));
}

__device__ __forceinline__ void cluster_store2(unsigned addr, int2 v) {
  asm volatile("st.shared::cluster.v2.u32 [%0], {%1, %2};" ::"r"(addr), "r"(v.x), "r"(v.y)
               : "memory");
}

// kCluster = false: the shared route, all M rows in one block (R = M).
// kCluster = true: block r of a cluster of cs owns rows r*R ..
// min(M, (r+1)*R) - 1, as in chain_dp_cluster.cuh.
// kGrid (with kCluster): the grid route, a window on K clusters. S = 1:
// block r of cluster kc owns rows (kc * cs + r) * R .. + R - 1. S > 1 (the
// split form, R = 1): the cluster holds cs / S rows, block r owns warps
// (r % S) * G .. + G - 1 of row kc * cs / S + r / S, cells from (r % S) * G
// * 32 C on.
template <typename T, bool kCluster, bool kGrid>
__global__ void __launch_bounds__(32 * kTiledWarps, 1)
chain_dp_tiled_kernel(const int8_t* __restrict__ windows,  // [B, W]
                      int W,
                      const int8_t* __restrict__ mono,  // [M, L] or [B, M, L]
                      long long mono_bstride,
                      const int* __restrict__ mono_lens,  // [M] or [B, M]
                      long long lens_bstride,
                      const T* __restrict__ dp0,  // [B, M, L] column i = 0
                      T* __restrict__ end,        // [B, W, M]
                      T* __restrict__ spend,      // [B, W, M]
                      int M, int L, int R, int G, int C, int ins, int dele, int mismatch,
                      int match, GridExchange gx_args, int SB) {
  constexpr int kNeg = StateNeg<T>::value;
  extern __shared__ int smem[];
  const int SC = 32 * C;     // cells of a warp's segment
  const int P = G * SC;      // a row's cells in this block, padded
  const int CW = (C + 3) / 4;  // code words a lane
  const int S = R * G;       // segments of the block: row r, warp g at r * G + g
  const bool split = kGrid && SB > 1;  // a row over SB blocks
  const bool segs = G > 1 || split;    // a row over several warps
  const int cs = kCluster ? cluster_blocks() : 1;
  const int rank = kCluster ? cluster_rank() : 0;
  const int cl = blockIdx.x / cs;  // the cluster's index in the launch
  const int b = kGrid ? cl / gx_args.K : cl;
  const int kc = kGrid ? cl - b * gx_args.K : 0;  // the cluster's index in its window
  const int Me = kGrid ? (split ? cs / SB : cs * R) : M;  // rows in the parity buffers
  const int seg = split ? rank % SB : 0;                  // the block's part of its row
  const int lm0 = split ? rank / SB : rank * R;  // this block's first row in the cluster
  const int m0 = kc * Me + lm0;                  // and in the window
  const int koff = seg * P;                      // its first cell
  const int NT = split ? SB * G : (G > 1 ? S : 0);
  int* ends = smem;          // [2][Me] the cluster's rows' end scores, by position parity
  int* gx = ends + 2 * Me;   // [2] the window's chain max (kGrid)
  int2* carry = reinterpret_cast<int2*>(gx + (kGrid ? 2 : 0));  // [S][32] each lane's carry
  int2* tot = carry + 32 * S;  // [NT] warp totals (split: the row's S * G warps)
  int2* bnd = tot + NT;        // [2][S] a segment's last cell, by parity (segs)
  int2* bnd_in = bnd + (segs ? 2 * S : 0);  // [2] the previous block's last cell (split)
  T* qs = reinterpret_cast<T*>(bnd_in + (split ? 2 : 0));  // [R][P] in-lane prefixes
  T* ss = qs + R * P;                                       // [R][P] their pointers
  unsigned* codes = reinterpret_cast<unsigned*>(ss + R * P);  // [S][CW][32] code words

  const int rows = min(R, M - m0);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const int8_t* win = windows + (long long)b * W;
  const int* lens_w = mono_lens + b * lens_bstride;  // all M rows of the window
  const int* lens_b = lens_w + m0;                   // this block's rows
  const int8_t* mono_b = mono + b * mono_bstride + (long long)m0 * L;
  const T* dp0_w = dp0 + (long long)b * M * L;
  const T* dp0_b = dp0_w + (long long)m0 * L;
  T* end_i = end + (long long)b * W * M + m0;  // advanced by M a position
  T* spend_i = spend + (long long)b * W * M + m0;

  for (int m = threadIdx.x; m < Me; m += blockDim.x) {
    const int gm = kc * Me + m;
    const int n = gm < M ? min(max(lens_w[gm], 0), L) : 0;
    ends[m] = n > 0 ? (int)dp0_w[(long long)gm * L + n - 1] : kNeg;
    ends[Me + m] = kNeg;  // rows of length 0 keep kNeg in both buffers
  }
  for (int r = threadIdx.x; r < rows && seg == 0; r += blockDim.x) {
    const int n = min(max(lens_b[r], 0), L);
    end_i[r] = n > 0 ? dp0_b[(long long)r * L + n - 1] : (T)kNeg;
    spend_i[r] = 0;
  }
  // column 0, folded; cell k = koff + g*SC + l*C + c of row r at r*P + g*SC
  // + c*32 + l, the padding past L at kNeg
  for (int x = threadIdx.x; x < rows * P; x += blockDim.x) {
    const int r = x / P, y = x - r * P;
    const int g = y / SC, z = y - g * SC;
    const int k = koff + g * SC + (z & 31) * C + (z >> 5);
    qs[x] = k < L ? (T)((int)dp0_b[(long long)r * L + k] - k * dele) : (T)kNeg;
    ss[x] = 0;
  }
  for (int x = threadIdx.x; x < rows * G * CW * 32; x += blockDim.x) {
    const int l = x & 31, w = (x >> 5) % CW, sg = (x >> 5) / CW;
    const int r = sg / G, g = sg - r * G;
    unsigned word = 0xffffffffu;  // 0xff past the row: never compared for a real cell
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = 4 * w + j, k = koff + g * SC + l * C + c;
      if (c < C && k < L)
        word = (word & ~(0xffu << (8 * j))) |
               ((unsigned)(uint8_t)mono_b[(long long)r * L + k] << (8 * j));
    }
    codes[x] = word;
  }
  for (int x = threadIdx.x; x < 32 * S; x += blockDim.x) carry[x] = make_int2(INT_MIN, 0);
  if (segs) {  // position 1 reads parity 0: each segment's last cell of column 0
    for (int sg = threadIdx.x; sg < S; sg += blockDim.x) {
      const int r = sg / G, k = koff + (sg - r * G + 1) * SC - 1;
      bnd[sg] = make_int2(r < rows && k < L ? (int)dp0_b[(long long)r * L + k] - k * dele : kNeg, 0);
    }
  }
  if (split && threadIdx.x == 0)  // the previous block's last cell of column 0
    bnd_in[0] = make_int2(seg > 0 ? (int)dp0_b[koff - 1] - (koff - 1) * dele : kNeg, 0);
  // G == 1: the lengths of the rows warp + lane * nwarps (at most 32 a warp
  // where every row holds more than 512 cells); segs: the warp's own row
  int n_own = 0;
  {
    const int r = segs ? warp / G : warp + lane * nwarps;
    if (r < rows) n_own = min(max(lens_b[r], 0), L);
  }
  const int chain_reads = lane < Me ? (Me - 1 - lane) / 32 + 1 : 0;  // ends this lane reads
  const unsigned ends_addr = kCluster ? (unsigned)__cvta_generic_to_shared(ends) + 4u * lm0 : 0u;
  // split: this block's shared addresses of tot and bnd_in, which mapa turns
  // into the same place in another block of the cluster
  const unsigned tot_addr = (unsigned)__cvta_generic_to_shared(tot);
  const unsigned bnd_in_addr = (unsigned)__cvta_generic_to_shared(bnd_in);
  if constexpr (kCluster)
    cluster_sync();  // every block started and filled before the first remote store
  else
    __syncthreads();

  int rc_next = W > 1 ? win[1] : 0;
  for (int i = 1; i < W; ++i) {
    const int rc = rc_next;
    if (i + 1 < W) rc_next = win[i + 1];
    const int* prev = ends + ((i - 1) & 1) * Me;
    int* cur = ends + (i & 1) * Me + lm0;
    const unsigned cur_addr = ends_addr + 4u * (i & 1) * Me;  // ends[i & 1][lm0] (cluster)
    const int2* bnd_prev = bnd + ((i - 1) & 1) * S;
    int2* bnd_cur = bnd + (i & 1) * S;
    end_i += M;
    spend_i += M;
    int chain = kNeg;
#pragma unroll 1
    for (int r = 0; r < chain_reads; ++r) chain = max(chain, prev[lane + 32 * r]);
    chain = warp_max(chain);
    if constexpr (kGrid) {
      if (gx_args.K > 1)
        chain = grid_chain(gx_args, chain, i, b, gridDim.x / (cs * gx_args.K), kc,
                           rank == 0 && threadIdx.x == 0, gx);
    }
    const int enter_y = chain + match, enter_n = chain + mismatch;  // enter - k*del
    const int diag_y = match - dele, diag_n = mismatch - dele;      // diag - k*del - q[k-1]
    const unsigned rc4 = (unsigned)(rc & 0xff) * 0x01010101u;       // the read's code, 4 times

    // Segment (r, g): the in-lane pass and the warp's scan; returns the
    // lane's total and its exclusive prefix over the warp's earlier lanes.
    auto scan = [&](int r, int g, int& run_t, int& run_c, int& et, int& ec) {
      const int sg = r * G + g;
      T* qr = qs + r * P + g * SC + lane;
      T* sr = ss + r * P + g * SC + lane;
      const unsigned* cr = codes + sg * CW * 32 + lane;
      const int2 oc = carry[sg * 32 + lane];
      // the diag neighbour of the lane's first cell: lane l-1's last cell at
      // i-1; of lane 0's, the previous warp's (bnd) or none (k == 0)
      int lq = (int)qr[(C - 1) * 32], ls = (int)sr[(C - 1) * 32];
      if (!(lq > oc.x)) {
        lq = oc.x;
        ls = oc.y;
      }
      int up_q = __shfl_up_sync(kFull, lq, 1);
      int up_s = __shfl_up_sync(kFull, ls, 1);
      if (lane == 0) {
        const int2 v = g > 0 ? bnd_prev[sg - 1]
                             : (seg > 0 ? bnd_in[(i - 1) & 1] : make_int2(kNeg, 0));
        up_q = v.x;
        up_s = v.y;
      }
      tiled_pass<T>(qr, sr, cr, C, oc, up_q, up_s, seg == 0 && g == 0 && lane == 0, rc4, i,
                    enter_y, enter_n, diag_y, diag_n, ins, kNeg, run_t, run_c);
      // inclusive pair scan over the 32 lane totals, then shifted to exclusive
      int tt = run_t, tc = run_c;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int ut = __shfl_up_sync(kFull, tt, o);
        const int uc = __shfl_up_sync(kFull, tc, o);
        if (lane >= o && !(tt > ut)) {
          tt = ut;
          tc = uc;
        }
      }
      et = __shfl_up_sync(kFull, tt, 1);
      ec = __shfl_up_sync(kFull, tc, 1);
      if (lane == 0) et = INT_MIN;  // no earlier lane in this warp
      if (split && lane == 31) {  // into the row's blocks from this one on
        const int gw = seg * G + g;
        for (int t = seg; t < SB; ++t)
          cluster_store2(cluster_addr(tot_addr + 8u * gw, rank - seg + t), make_int2(tt, tc));
      } else if (G > 1 && lane == 31) {
        tot[sg] = make_int2(tt, tc);
      }
    };
    // Segment (r, g) after the earlier warps' carry wc: the lanes' carries
    // for the next position, the end cell's emit and the segment's last cell.
    auto finish = [&](int r, int g, int n, int run_t, int run_c, int et, int ec, int2 wc) {
      const int sg = r * G + g;
      const int2 nc = et > wc.x ? make_int2(et, ec) : wc;  // the earlier lanes win ties
      carry[sg * 32 + lane] = nc;
      const int ke = n - 1, ge = ke / SC, le = (ke - ge * SC) / C;
      if (seg * G + g == ge && lane == le) {
        const int ce = ke - ge * SC - le * C;
        int qe = (int)qs[r * P + g * SC + ce * 32 + lane];
        int se = (int)ss[r * P + g * SC + ce * 32 + lane];
        if (!(qe > nc.x)) {
          qe = nc.x;
          se = nc.y;
        }
        const int e = qe + ke * dele;
        if constexpr (kCluster)
          ClusterEmit<T>{cur_addr + 4u * r, cs, end_i, spend_i, r}(e, se);
        else
          LanesEmit<T>{cur, end_i, spend_i, r}(e, se);
      }
      if (segs && lane == 31) {
        const int2 v = run_t > nc.x ? make_int2(run_t, run_c) : nc;
        if (g < G - 1)
          bnd_cur[sg] = v;
        else if (split && seg < SB - 1)  // into the next block of the row
          cluster_store2(cluster_addr(bnd_in_addr + 8u * (i & 1), rank + 1), v);
      }
    };

    if (!segs) {
      int j = 0;
      for (int r = warp; r < rows; r += nwarps, ++j) {
        const int n = j < 32 ? __shfl_sync(kFull, n_own, j & 31) : min(max(lens_b[r], 0), L);
        if (n == 0) {
          if (lane == 0) {
            end_i[r] = (T)kNeg;
            spend_i[r] = 0;
          }
          continue;
        }
        int run_t, run_c, et, ec;
        scan(r, 0, run_t, run_c, et, ec);
        finish(r, 0, n, run_t, run_c, et, ec, make_int2(INT_MIN, 0));
      }
    } else {
      // one segment a warp; a segment that starts past the row's end skips
      const int r = warp / G, g = warp - r * G;
      const int n = n_own;
      const bool live = r < rows && koff + g * SC < n;
      int run_t = 0, run_c = 0, et = 0, ec = 0;
      if (live) scan(r, g, run_t, run_c, et, ec);
      if (split)
        cluster_sync();  // the row's warp totals of this position, in every block
      else
        __syncthreads();  // the warp totals of this position
      if (live) {
        int2 wc = make_int2(INT_MIN, 0);
        // the earliest argmax of the row's warps 0 .. gw-1's totals, 32 at a
        // time, an earlier group winning ties
        const int gw = seg * G + g;
        const int2* tr = split ? tot : tot + r * G;
        for (int j0 = 0; j0 < gw; j0 += 32) {
          const int2 v = j0 + lane < gw ? tr[j0 + lane] : make_int2(INT_MIN, 0);
          const int mx = warp_max(v.x);
          const unsigned hit = __ballot_sync(kFull, j0 + lane < gw && v.x == mx);
          const int mc = __shfl_sync(kFull, v.y, __ffs(hit) - 1);
          if (mx > wc.x) wc = make_int2(mx, mc);
        }
        finish(r, g, n, run_t, run_c, et, ec, wc);
      } else if (r < rows && n == 0 && seg == 0 && g == 0 && lane == 0) {
        end_i[r] = (T)kNeg;
        spend_i[r] = 0;
      }
    }
    if constexpr (kCluster)
      cluster_sync();  // ends[i & 1] complete in every block before the next chain max
    else
      __syncthreads();  // ends[i & 1], the carries and bnd[i & 1] complete
  }
}

// The launch of one instance (kGrid: B windows of gx.K clusters each), or
// with `max_clusters` given, only cudaOccupancyMaxActiveClusters for it
// (nothing is launched; cluster only).
template <typename T, bool kCluster, bool kGrid>
int launch_tiled_t(int* max_clusters, int cs, int R, int G, int C, int SB, const void* windows,
                   const void* mono, long long mono_bstride, const void* mono_lens,
                   long long lens_bstride, const void* dp0, void* end, void* spend, int B, int W,
                   int M, int L, int ins, int dele, int mismatch, int match, GridExchange gx,
                   void* stream) {
  auto kernel = chain_dp_tiled_kernel<T, kCluster, kGrid>;
  const long long smem =
      kGrid ? grid_tiled_smem_bytes(SB > 1 ? cs / SB : cs * R, R, G, C, SB, sizeof(T))
            : tiled_smem_bytes(M, R, G, C, sizeof(T));
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  if (!kCluster) {
    kernel<<<B, tiled_threads(R, G), (size_t)smem, (cudaStream_t)stream>>>(
        (const int8_t*)windows, W, (const int8_t*)mono, mono_bstride, (const int*)mono_lens,
        lens_bstride, (const T*)dp0, (T*)end, (T*)spend, M, L, R, G, C, ins, dele, mismatch,
        match, gx, 1);
    return (int)cudaGetLastError();
  }
  if (cs > kClusterPortable) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return (int)err;
  }
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(B > 0 ? B : 1) * (kGrid ? gx.K : 1) * cs);
  cfg.blockDim = dim3(tiled_threads(R, G));
  cfg.dynamicSmemBytes = (size_t)smem;
  cfg.stream = (cudaStream_t)stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if (max_clusters != nullptr)
    return (int)cudaOccupancyMaxActiveClusters(max_clusters, (const void*)kernel, &cfg);
  err = cudaLaunchKernelEx(&cfg, kernel, (const int8_t*)windows, W, (const int8_t*)mono,
                           mono_bstride, (const int*)mono_lens, lens_bstride, (const T*)dp0,
                           (T*)end, (T*)spend, M, L, R, G, C, ins, dele, mismatch, match, gx, SB);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// The launch's shape as the wrapper's layout and plan give it (the kernel's
// own checks, so that a wrong shape is refused before launch rather than
// run): cs blocks of R rows, every block with at least one; G warps of 32
// lanes x C cells covering L with no warp past it, at most kTiledWarps a
// block where G > 1; within one block's shared memory.
bool tiled_shape_ok(int state_bytes, int cs, int R, int G, int C, int M, int L) {
  return (state_bytes == 4 || state_bytes == 2) && cs >= 1 && cs <= kClusterMax && R >= 1 &&
         (long long)(cs - 1) * R < M && M <= (long long)cs * R && L >= 1 && G >= 1 && C >= 1 &&
         32LL * G * C >= L && 32LL * (G - 1) * C < L && (G == 1 || R * G <= kTiledWarps) &&
         tiled_smem_bytes(M, R, G, C, state_bytes) <= kSmemLimit;
}

// The grid route's shape: K clusters of cs blocks; S = 1, R rows a block,
// every block with at least one; S > 1, R = 1, a row over S blocks of G
// warps, cs a multiple of S, every block with a row (K * cs / S = M) and
// its first cell below L (a warp wholly past L is never live); G warps of
// 32 lanes x C cells, within kTiledWarps and one block's shared memory.
bool grid_tiled_shape_ok(int state_bytes, int K, int cs, int R, int G, int C, int SB, int M,
                         int L) {
  const long long blocks = (long long)K * cs, cells = 32LL * G * C;
  const bool rows_ok = SB == 1 ? (blocks - 1) * R < M && M <= blocks * R
                               : R == 1 && cs % SB == 0 && (long long)K * (cs / SB) == M &&
                                     (SB - 1) * cells < L && SB * cells >= L;
  return (state_bytes == 4 || state_bytes == 2) && K >= 1 && cs >= 1 && cs <= kClusterMax &&
         R >= 1 && SB >= 1 && rows_ok && L >= 1 && G >= 1 && C >= 1 &&
         (SB > 1 || (cells >= L && 32LL * (G - 1) * C < L)) && (G == 1 || R * G <= kTiledWarps) &&
         grid_tiled_smem_bytes(SB > 1 ? cs / SB : cs * R, R, G, C, SB, state_bytes) <= kSmemLimit;
}

int dispatch(int* max_clusters, bool cluster, int state_bytes, int cs, int R, int G, int C,
             const void* windows, const void* mono, long long mono_bstride,
             const void* mono_lens, long long lens_bstride, const void* dp0, void* end,
             void* spend, int B, int W, int M, int L, int ins, int dele, int mismatch, int match,
             void* stream) {
  if (!tiled_shape_ok(state_bytes, cs, R, G, C, M, L) || (!cluster && (cs != 1 || R != M)))
    return (int)cudaErrorInvalidValue;
  const GridExchange none = {nullptr, nullptr, 1};
  auto launch = state_bytes == 4
                    ? (cluster ? launch_tiled_t<int, true, false> : launch_tiled_t<int, false, false>)
                    : (cluster ? launch_tiled_t<int16_t, true, false>
                               : launch_tiled_t<int16_t, false, false>);
  return launch(max_clusters, cs, R, G, C, 1, windows, mono, mono_bstride, mono_lens,
                lens_bstride, dp0, end, spend, B, W, M, L, ins, dele, mismatch, match, none,
                stream);
}

int dispatch_grid(int* max_clusters, int state_bytes, int K, int cs, int R, int G, int C, int SB,
                  const void* windows, const void* mono, long long mono_bstride,
                  const void* mono_lens, long long lens_bstride, const void* dp0, void* end,
                  void* spend, int B, int W, int M, int L, int ins, int dele, int mismatch,
                  int match, void* slots, void* fault, void* stream) {
  if (!grid_tiled_shape_ok(state_bytes, K, cs, R, G, C, SB, M, L))
    return (int)cudaErrorInvalidValue;
  const GridExchange gx = {(unsigned long long*)slots, (int*)fault, K};
  auto launch = state_bytes == 4 ? launch_tiled_t<int, true, true>
                                 : launch_tiled_t<int16_t, true, true>;
  return launch(max_clusters, cs, R, G, C, SB, windows, mono, mono_bstride, mono_lens,
                lens_bstride, dp0, end, spend, B, W, M, L, ins, dele, mismatch, match, gx, stream);
}

}  // namespace

// K1's tiled body, the shared route past L = 512: B windows, each on one
// block holding all M rows, G warps a row of C cells a lane
// (ops/chain_dp_cuda.tiled_layout). dp0 is only read. state_bytes is 4
// (int32) or 2 (int16): dp0, end and spend are of that type.
extern "C" int sd_chain_dp_tiled(int state_bytes, int G, int C, const void* windows,
                                 const void* mono, long long mono_bstride, const void* mono_lens,
                                 long long lens_bstride, const void* dp0, void* end, void* spend,
                                 int B, int W, int M, int L, int ins, int dele, int mismatch,
                                 int match, void* stream) {
  return dispatch(nullptr, false, state_bytes, 1, M, G, C, windows, mono, mono_bstride,
                  mono_lens, lens_bstride, dp0, end, spend, B, W, M, L, ins, dele, mismatch,
                  match, stream);
}

// K1's tiled cluster body, the large route past L = 512: B windows, each on
// a cluster of cs blocks of R rows, G warps a row of C cells a lane.
extern "C" int sd_chain_dp_cluster_tiled(int state_bytes, int cs, int R, int G, int C,
                                         const void* windows, const void* mono,
                                         long long mono_bstride, const void* mono_lens,
                                         long long lens_bstride, const void* dp0, void* end,
                                         void* spend, int B, int W, int M, int L, int ins,
                                         int dele, int mismatch, int match, void* stream) {
  return dispatch(nullptr, true, state_bytes, cs, R, G, C, windows, mono, mono_bstride,
                  mono_lens, lens_bstride, dp0, end, spend, B, W, M, L, ins, dele, mismatch,
                  match, stream);
}

// cudaOccupancyMaxActiveClusters of the launch sd_chain_dp_cluster_tiled
// would make for this shape, into *max_clusters; 0 means it cannot be
// scheduled.
extern "C" int sd_chain_dp_cluster_tiled_occupancy(int state_bytes, int cs, int R, int G, int C,
                                                   int B, int M, int L, int* max_clusters) {
  *max_clusters = 0;
  return dispatch(max_clusters, true, state_bytes, cs, R, G, C, nullptr, nullptr, 0, nullptr, 0,
                  nullptr, nullptr, nullptr, B, 1, M, L, 0, 0, 0, 0, nullptr);
}

// K1's grid route past L = 512 (chain_dp_grid.cuh): B windows, each on K
// clusters of cs blocks, R rows a block (S = 1) or a row over S blocks (R
// = 1, the split form), G warps a block's row of C cells a lane. slots: [2,
// B, K] int64, zeroed; fault: one int32, zeroed, set where a read of
// another cluster's slot ran out of time (the results are then void).
extern "C" int sd_chain_dp_grid_tiled(int state_bytes, int K, int cs, int R, int G, int C, int S,
                                      const void* windows, const void* mono,
                                      long long mono_bstride, const void* mono_lens,
                                      long long lens_bstride, const void* dp0, void* end,
                                      void* spend, int B, int W, int M, int L, int ins, int dele,
                                      int mismatch, int match, void* slots, void* fault,
                                      void* stream) {
  return dispatch_grid(nullptr, state_bytes, K, cs, R, G, C, S, windows, mono, mono_bstride,
                       mono_lens, lens_bstride, dp0, end, spend, B, W, M, L, ins, dele, mismatch,
                       match, slots, fault, stream);
}

// cudaOccupancyMaxActiveClusters of the launch sd_chain_dp_grid_tiled would
// make for this shape, into *max_clusters; 0 means it cannot be scheduled.
extern "C" int sd_chain_dp_grid_tiled_occupancy(int state_bytes, int K, int cs, int R, int G,
                                                int C, int S, int B, int M, int L,
                                                int* max_clusters) {
  *max_clusters = 0;
  return dispatch_grid(max_clusters, state_bytes, K, cs, R, G, C, S, nullptr, nullptr, 0, nullptr,
                       0, nullptr, nullptr, nullptr, B, 1, M, L, 0, 0, 0, 0, nullptr, nullptr,
                       nullptr);
}
