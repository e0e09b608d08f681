// K1's large route for monomer sets padded to L <= 512: the cluster body.
//
// Replaces stringdecomposer_tpu/ops/chain_dp_pallas.py::_dp_kernel (the
// pallas_call at :482, through chain_dp_forward_pallas), as the lanes and
// chunked bodies do, with the same recurrence, tie rules, inputs and outputs
// (end and spend [B, W, M] in the state type T). ops/chain_dp.sweep_cluster
// is its plain mirror, step for step.
//
// What bounds it on the H100: the read position is a strict sequential axis
// (the chain score at i is the max of all M end scores at i-1), so a window
// costs W times one position. A set too large for one block's shared memory
// (M > 133 at L = 192 in int32) kept its column in an L2 scratch worked by
// one block (the chunked large route, chain_dp.cuh): ~44 us a position at
// M = 264. Here a window's rows are spread over the cs blocks of a thread
// block cluster, each block on its own SM with its R = ceil(M / cs) rows on
// chip, as the lanes body keeps them. A position then costs one block's row
// work (R rows of lanes_row on one SM), the exchange of the M end scores and
// one cluster barrier; those, and the SMs a cluster takes from the batch's
// other windows, bound it. On one H100 the barrier with the stores costs
// ~0.8 us a position more than the lanes body's __syncthreads (a cluster of
// one block against the lanes body, k1_ab.py --sweep), about one row's
// work; ops/chain_dp_cuda.cluster_plan weighs it against the waves a
// launch takes.
//
// What the design does about that:
//   - Grid: B x cs blocks in clusters of cs, one cluster a window. Block r
//     of a cluster (its rank) owns rows r*R .. min(M, (r+1)*R) - 1, at least
//     one (ops/chain_dp_cuda.cluster_plan picks cs and R).
//   - Rows: lanes_row (chain_dp_lanes.cuh) unchanged, in the lanes body's
//     forms: R <= 32, the rows in registers, one a warp at C <= 8 and two
//     a warp above (kRegRows); more, the rows in shared memory,
//     lane-contiguous (kRowsDense, kRows).
//     The rows' setup and step are chain_dp_lanes_kernel's, over the
//     block's rows; the chain read (all M rows), the emit and the barrier
//     differ.
//   - Exchange: every block keeps all M end scores, double-buffered by
//     position parity (ends[2][M], int32). At position i the lane that owns
//     row m's end cell stores its end score into ends[i & 1][m] of every
//     block of the cluster (st.shared::cluster at mapa's address), and one
//     cluster barrier (arrive.release, wait.acquire) takes the place of the
//     lanes body's __syncthreads. At i+1 each warp reads all M from its own
//     block's shared memory and takes warp_max.
//   - One barrier a position is enough, across the cluster as in one block:
//     a store at i+1 goes into ends[(i+1) & 1] = ends[(i-1) & 1], which the
//     warps of every block read at i for their chain max; each of them
//     arrived at barrier i after that read, and the storing thread passed
//     barrier i before its store. The reads at i+1 of ends[i & 1] follow
//     barrier i, which every store of position i precedes (release, then
//     acquire).
//   - Start: each block fills both buffers of all M rows from dp0 itself
//     (rows of length 0 keep kNeg in both and are never stored), then a
//     cluster barrier before the loop: every block of the cluster has started
//     and filled its buffers before the first remote store.
//   - End: a block stores into another's shared memory only before its
//     barrier of that position, so after the loop's last barrier no block
//     can still write into one that exits; W = 1 has no loop and no remote
//     store.
//   - Outputs: each block writes end / spend of its own rows only.
// Arithmetic is int32 in registers; T is used only where values are stored
// (the shared-memory rows, end and spend), as in the lanes body, so the int16
// state needs no range check of its own.
// With kGrid the same kernel is the grid route's at L <= 512 (its design in
// chain_dp_grid.cuh): a window's rows over K clusters, the parity buffers
// holding the cluster's rows only, the chain max exchanged between the K
// clusters through global memory after the cluster's own.
// kVariant is one of A's ablations (chain_dp_variant.cuh; instantiated only
// in chain_dp_ablate.cu, at <int, 6, kRowsDense, false>): nochain takes a
// row's chain score from its own end cell (lanes_row) and drops the chain
// max, the remote stores of the end scores and the per-position cluster
// barrier (the start barrier stays); ladder4, ladder2, noemit and noshift
// are the lanes body's, through lanes_row and the emit.

#pragma once

#include "chain_dp_grid.cuh"

namespace {

constexpr int kClusterMax = 16;       // blocks a cluster (above 8: non-portable)
constexpr int kClusterPortable = 8;   // the largest cluster every sm_90 part schedules
constexpr long long kSmemLimit = 232448;  // opt-in shared memory of one block (sm_90)

__device__ __forceinline__ int cluster_rank() {
  unsigned r;
  asm("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return (int)r;
}

__device__ __forceinline__ int cluster_blocks() {
  unsigned r;
  asm("mov.u32 %0, %%cluster_nctarank;" : "=r"(r));
  return (int)r;
}

// The shared::cluster address, in block `rank`, of this block's shared
// address `addr`.
__device__ __forceinline__ unsigned cluster_addr(unsigned addr, int rank) {
  unsigned out;
  asm("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(out) : "r"(addr), "r"(rank));
  return out;
}

__device__ __forceinline__ void cluster_store(unsigned addr, int v) {
  asm volatile("st.shared::cluster.u32 [%0], %1;" ::"r"(addr), "r"(v) : "memory");
}

// Every thread of the cluster: the stores before it are seen by the reads
// after it in every block.
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release;\n\tbarrier.cluster.wait.acquire;" ::: "memory");
}

// The cluster body's emit: the end score into ends[i & 1][m] of every block
// of the cluster (`cur` is this block's shared address of it), the outputs
// of the block's row r (nochain: no stores into the blocks; noemit: the
// outputs only where `out`, at the last position).
template <typename T, int kVariant = kBase>
struct ClusterEmit {
  unsigned cur;
  int cs;
  T* end_i;
  T* spend_i;
  int r;
  bool out = true;
  __device__ __forceinline__ void operator()(int e, int se) const {
    if constexpr (kVariant != kNoChain)
      for (int k = 0; k < cs; ++k) cluster_store(cluster_addr(cur, k), e);
    if (kVariant != kNoEmit || out) {
      end_i[r] = (T)e;
      spend_i[r] = (T)se;
    }
  }
};

// Same formula as ops/chain_dp_cuda.cluster_shape: the parity buffers of all
// M rows, plus the block's R rows where they live in shared memory (R > 32).
inline long long cluster_smem_bytes(int M, int L, int R, int state_bytes) {
  return 2LL * M * 4 + (R > 32 ? (long long)R * L * (2 * state_bytes + 1) : 0);
}

// The grid route's (kGrid): the parity buffers of the cluster's Me = cs * R
// rows and the two ints of the exchange (chain_dp_grid.cuh), plus the rows.
inline long long grid_smem_bytes(int Me, int L, int R, int state_bytes) {
  return 2LL * Me * 4 + 8 + (R > 32 ? (long long)R * L * (2 * state_bytes + 1) : 0);
}

// kGrid = false: the cluster body, a window on one cluster (gx, K unused).
// kGrid = true: the grid route (chain_dp_grid.cuh), a window's rows over K
// clusters; block r of cluster kc owns rows (kc * cs + r) * R .. + R - 1.
template <typename T, int C, int kPath, bool kGrid, int kVariant = kBase>
__global__ void __launch_bounds__(lanes_max_threads<C, kPath>(), 1)
chain_dp_cluster_kernel(const int8_t* __restrict__ windows,  // [B, W]
                        int W,
                        const int8_t* __restrict__ mono,  // [M, L] or [B, M, L]
                        long long mono_bstride,
                        const int* __restrict__ mono_lens,  // [M] or [B, M]
                        long long lens_bstride,
                        const T* __restrict__ dp0,  // [B, M, L] column i = 0
                        T* __restrict__ end,        // [B, W, M]
                        T* __restrict__ spend,      // [B, W, M]
                        int M, int L, int R, int ins, int dele, int mismatch, int match,
                        GridExchange gx_args) {
  constexpr int kNeg = StateNeg<T>::value;
  constexpr int kWords = (C + 3) / 4;
  constexpr bool kRegs = kPath == kRegRows;
  constexpr int kP = kRegs ? lanes_reg_rows<C>() : 1;  // rows a warp holds in registers
  extern __shared__ int smem[];
  const int cs = cluster_blocks();
  const int rank = cluster_rank();
  const int cl = blockIdx.x / cs;  // the cluster's index in the launch
  const int b = kGrid ? cl / gx_args.K : cl;
  const int kc = kGrid ? cl - b * gx_args.K : 0;  // the cluster's index in its window
  const int Me = kGrid ? cs * R : M;  // rows in the parity buffers
  const int g0 = kc * Me;             // the cluster's first row
  int* ends = smem;  // [2][Me] the cluster's rows' end scores, by position parity
  int* gx = ends + 2 * Me;  // [2] the window's chain max (kGrid)
  // several rows a warp: this block's [R][L] folded scores, pointers and
  // codes, cell c of this lane at x0 + c * dx in its row
  T* qs = reinterpret_cast<T*>(gx + (kGrid ? 2 : 0));
  T* ss = qs + R * L;
  int8_t* mcs = reinterpret_cast<int8_t*>(ss + R * L);

  const int lm0 = rank * R;  // this block's first row in the cluster
  const int m0 = g0 + lm0;   // and in the window
  const int rows = min(R, M - m0);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const int k0 = lane * C;
  const int F = L / C;
  const int x0 = kPath == kRowsDense ? lane : (lane < F ? lane : F * C);
  const int dx = kPath == kRowsDense ? 32 : (lane < F ? F : 1);
  const int8_t* win = windows + (long long)b * W;
  const int* lens_w = mono_lens + b * lens_bstride;  // all M rows of the window
  const int* lens_b = lens_w + m0;                   // this block's rows
  const int8_t* mono_b = mono + b * mono_bstride + (long long)m0 * L;
  const T* dp0_w = dp0 + (long long)b * M * L;
  const T* dp0_b = dp0_w + (long long)m0 * L;
  T* end_i = end + (long long)b * W * M + m0;  // advanced by M a position
  T* spend_i = spend + (long long)b * W * M + m0;

  for (int m = threadIdx.x; m < Me; m += blockDim.x) {
    const int gm = g0 + m;
    const int n = gm < M ? min(max(lens_w[gm], 0), L) : 0;
    ends[m] = n > 0 ? (int)dp0_w[(long long)gm * L + n - 1] : kNeg;
    ends[Me + m] = kNeg;  // rows of length 0 keep kNeg in both buffers
  }
  for (int r = threadIdx.x; r < rows && (kVariant != kNoEmit || W == 1); r += blockDim.x) {
    const int n = min(max(lens_b[r], 0), L);
    end_i[r] = n > 0 ? dp0_b[(long long)r * L + n - 1] : (T)kNeg;
    spend_i[r] = 0;
  }
  // kRegs: the block's row p of this warp is r = warp + p * nwarps, its
  // cells in q[p], s[p] and codes[p] (cell c in byte c % 4 of word c / 4),
  // its length in n_reg[p] (0 past the block's rows); else q[0] and s[0]
  // hold the row being stepped
  int q[kP][C], s[kP][C];
  unsigned codes[kP][kWords];
  int n_reg[kP];
  int n_own = 0;  // the shared-memory forms: the length of row warp + lane * nwarps
  const int chain_reads = lane < Me ? (Me - 1 - lane) / 32 + 1 : 0;  // ends this lane reads
  if constexpr (kRegs) {
#pragma unroll
    for (int p = 0; p < kP; ++p) {
      const int r = warp + p * nwarps;
      n_reg[p] = r < rows ? min(max(lens_b[r], 0), L) : 0;
#pragma unroll
      for (int w = 0; w < kWords; ++w) codes[p][w] = 0xffffffffu;  // 0xff never equals a read code
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const int k = k0 + c;
        const bool valid = k < n_reg[p];
        q[p][c] = valid ? (int)dp0_b[(long long)r * L + k] - k * dele : kNeg;
        s[p][c] = 0;
        if (valid) {
          const unsigned code = (unsigned)(uint8_t)mono_b[(long long)r * L + k];
          codes[p][c / 4] =
              (codes[p][c / 4] & ~(0xffu << (8 * (c % 4)))) | (code << (8 * (c % 4)));
        }
      }
    }
  } else {
    const int ro = warp + lane * nwarps;
    if (ro < rows) n_own = min(max(lens_b[ro], 0), L);
    for (int r = warp; r < rows; r += nwarps) {  // each warp fills the rows it owns
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const int k = k0 + c;
        if (k < L) {
          const int x = r * L + x0 + c * dx;
          qs[x] = (T)((int)dp0_b[(long long)r * L + k] - k * dele);
          ss[x] = 0;
          mcs[x] = mono_b[(long long)r * L + k];
        }
      }
    }
  }
  const unsigned ends_addr = (unsigned)__cvta_generic_to_shared(ends) + 4u * lm0;
  cluster_sync();  // every block started and filled before the first remote store

  int rc_next = W > 1 ? win[1] : 0;
  for (int i = 1; i < W; ++i) {
    const int rc = rc_next;
    if (i + 1 < W) rc_next = win[i + 1];
    const int* prev = ends + ((i - 1) & 1) * Me;
    const unsigned cur = ends_addr + 4u * (i & 1) * Me;  // ends[i & 1][lm0]
    end_i += M;
    spend_i += M;
    const bool out = kVariant != kNoEmit || i == W - 1;  // end / spend written at i
    int chain = kNeg;
    if constexpr (kVariant != kNoChain) {
#pragma unroll 1
      for (int r = 0; r < chain_reads; ++r) chain = max(chain, prev[lane + 32 * r]);
      chain = warp_max(chain);
    }
    if constexpr (kGrid) {
      if (gx_args.K > 1)
        chain = grid_chain(gx_args, chain, i, b, gridDim.x / (cs * gx_args.K), kc,
                           rank == 0 && threadIdx.x == 0, gx);
    }
    if constexpr (kRegs) {
      const unsigned rc4 = (unsigned)(rc & 0xff) * 0x01010101u;  // the read's code, 4 times
#pragma unroll
      for (int p = 0; p < kP; ++p) {
        const int r = warp + p * nwarps;
        if (r >= rows) continue;
        if (n_reg[p] == 0) {
          if (lane == 0 && out) {
            end_i[r] = (T)kNeg;
            spend_i[r] = 0;
          }
          continue;
        }
        lanes_row<T, C, kVariant>(q[p], s[p], [&](int c) {
                                    return ((codes[p][c / 4] ^ rc4) & (0xffu << (8 * (c % 4)))) ==
                                           0;
                                  },
                                  lane, n_reg[p], i, chain, ins, dele, mismatch, match,
                                  ClusterEmit<T, kVariant>{cur + 4u * r, cs, end_i, spend_i, r,
                                                           out});
      }
    } else {
      int j = 0;
      for (int r = warp; r < rows; r += nwarps, ++j) {
        const int n = j < 32 ? __shfl_sync(kFull, n_own, j & 31)
                             : min(max(lens_b[r], 0), L);
        if (n == 0) {
          if (lane == 0 && out) {
            end_i[r] = (T)kNeg;
            spend_i[r] = 0;
          }
          continue;
        }
        T* qr = qs + r * L + x0;
        T* sr = ss + r * L + x0;
        const int8_t* cr = mcs + r * L + x0;
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
                                  ClusterEmit<T, kVariant>{cur + 4u * r, cs, end_i, spend_i, r,
                                                           out});
#pragma unroll
        for (int c = 0; c < C; ++c) {
          if (k0 + c < n) {
            qr[c * dx] = (T)q[0][c];
            sr[c * dx] = (T)s[0][c];
          }
        }
      }
    }
    // ends[i & 1] complete in every block before the next chain max
    if constexpr (kVariant != kNoChain) cluster_sync();
  }
}

// The launch of one instance (kGrid: B windows of gx.K clusters each), or
// with `max_clusters` given, only cudaOccupancyMaxActiveClusters for it
// (nothing is launched).
template <typename T, int C, int kPath, bool kGrid, int kVariant = kBase>
int launch_cluster_k(int* max_clusters, int cs, int R, const void* windows, const void* mono,
                     long long mono_bstride, const void* mono_lens, long long lens_bstride,
                     const void* dp0, void* end, void* spend, int B, int W, int M, int L,
                     int ins, int dele, int mismatch, int match, GridExchange gx, void* stream) {
  auto kernel = chain_dp_cluster_kernel<T, C, kPath, kGrid, kVariant>;
  const long long smem = kGrid ? grid_smem_bytes(cs * R, L, R, sizeof(T))
                               : cluster_smem_bytes(M, L, R, sizeof(T));
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
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
  constexpr int kP = lanes_reg_rows<C>();
  cfg.blockDim =
      dim3(kPath == kRegRows ? 32 * ((R + kP - 1) / kP) : lanes_max_threads<C, kPath>());
  cfg.dynamicSmemBytes = (size_t)smem;
  cfg.stream = (cudaStream_t)stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if (max_clusters != nullptr)
    return (int)cudaOccupancyMaxActiveClusters(max_clusters, (const void*)kernel, &cfg);
  err = cudaLaunchKernelEx(&cfg, kernel, (const int8_t*)windows, W, (const int8_t*)mono,
                           mono_bstride, (const int*)mono_lens, lens_bstride, (const T*)dp0,
                           (T*)end, (T*)spend, M, L, R, ins, dele, mismatch, match, gx);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <typename T, int C, bool kGrid>
int launch_cluster_c(int* max_clusters, int cs, int R, const void* windows, const void* mono,
                     long long mono_bstride, const void* mono_lens, long long lens_bstride,
                     const void* dp0, void* end, void* spend, int B, int W, int M, int L,
                     int ins, int dele, int mismatch, int match, GridExchange gx, void* stream) {
  auto launch = R <= 32 ? launch_cluster_k<T, C, kRegRows, kGrid>
                        : (L == 32 * C ? launch_cluster_k<T, C, kRowsDense, kGrid>
                                       : launch_cluster_k<T, C, kRows, kGrid>);
  return launch(max_clusters, cs, R, windows, mono, mono_bstride, mono_lens, lens_bstride, dp0,
                end, spend, B, W, M, L, ins, dele, mismatch, match, gx, stream);
}

// kGrid = false: the cluster body (chain_dp_cluster.cu); true: the grid
// route (chain_dp_grid.cu), each source instantiating its own.
template <typename T, bool kGrid>
int launch_cluster(int* max_clusters, int cs, int R, const void* windows, const void* mono,
                   long long mono_bstride, const void* mono_lens, long long lens_bstride,
                   const void* dp0, void* end, void* spend, int B, int W, int M, int L, int ins,
                   int dele, int mismatch, int match, GridExchange gx, void* stream) {
#define SD_CLUSTER_CASE(CC)                                                                  \
  case CC:                                                                                   \
    return launch_cluster_c<T, CC, kGrid>(max_clusters, cs, R, windows, mono, mono_bstride,  \
                                          mono_lens, lens_bstride, dp0, end, spend, B, W, M, \
                                          L, ins, dele, mismatch, match, gx, stream);
  switch ((L + 31) / 32) {
    SD_CLUSTER_CASE(1)
    SD_CLUSTER_CASE(2)
    SD_CLUSTER_CASE(3)
    SD_CLUSTER_CASE(4)
    SD_CLUSTER_CASE(5)
    SD_CLUSTER_CASE(6)
    SD_CLUSTER_CASE(7)
    SD_CLUSTER_CASE(8)
    SD_CLUSTER_CASE(9)
    SD_CLUSTER_CASE(10)
    SD_CLUSTER_CASE(11)
    SD_CLUSTER_CASE(12)
    SD_CLUSTER_CASE(13)
    SD_CLUSTER_CASE(14)
    SD_CLUSTER_CASE(15)
    SD_CLUSTER_CASE(16)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef SD_CLUSTER_CASE
}

}  // namespace
