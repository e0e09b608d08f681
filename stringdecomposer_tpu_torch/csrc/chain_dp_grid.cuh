// K1's grid routes: a window's rows over K thread block clusters, and a
// row's warps over the blocks of a cluster (the split form).
//
// Replaces stringdecomposer_tpu/ops/chain_dp_pallas.py::_dp_kernel (the
// pallas_call at :482, through chain_dp_forward_pallas) for the sets the
// cluster bodies cannot hold, which the chunked body (chain_dp.cuh) ran on
// one block a window: more rows than 16 blocks' shared memory holds (the
// column in an L2 scratch, ~270 us a position at 800 rows of 528 bp), or a
// row too long for one block's shared memory in the tiled form (~290 us a
// position at 25,800 bp). Same recurrence, tie rules, inputs and outputs.
// ops/chain_dp.sweep_grid is their plain mirror (blocks_per_row > 1: the
// split form), step for step. The kernels are the cluster bodies' with
// kGrid: chain_dp_cluster.cuh (L <= 512, entry chain_dp_grid.cu) and
// chain_dp_tiled.cu (past 512, and the split form).
//
// What bounds it on the H100: the read position is a strict sequential
// axis, and one cluster holds at most 16 blocks, the hardware's largest. So
// past 16 blocks a window's rows go to K clusters (the cluster body's and
// the tiled cluster body's row steps unchanged, R rows a block), and each
// position pays, on top of the cluster barrier, one exchange of the chain
// max between the K clusters through global memory (~1-2 us, an L2 round
// trip). A row too long for one block is split over S blocks of a cluster,
// its G warps a block as the tiled body splits a row over warps, at the
// price of a second cluster barrier a position.
//
// What the design does about that:
//   - Inside a cluster the end scores are exchanged through distributed
//     shared memory as in the cluster bodies, but each block keeps only its
//     own cluster's rows (ends[2][Me], Me = cs * R, or cs / S split rows),
//     not all M.
//   - Across clusters (K > 1): at position i one thread of each cluster
//     publishes the cluster's max end score of position i - 1 as one 64-bit
//     word (i, max) into slot [i & 1][window][cluster] with st.release.gpu;
//     warp 0 of every block reads the other K - 1 slots with ld.acquire.gpu
//     until their tags equal i, takes the max (an integer max: the order of
//     the reads cannot change it), and hands it to the block's warps through
//     shared memory and one block barrier. No atomic. Two slots by parity
//     suffice: a cluster publishes i + 1 only after it read every cluster's
//     i, and a cluster publishes i only after it finished position i - 1,
//     which read every cluster's i - 1.
//   - Co-residency: the K clusters of a window must run at once. The
//     wrapper launches at most cudaOccupancyMaxActiveClusters / K windows
//     at a time and refuses a plan whose K clusters cannot be resident
//     together. A read spins at most kGridSpinNs of the global timer; past
//     that it sets the launch's fault word, every later read of the launch
//     returns at once, and the wrapper raises. A wrong plan fails loudly and
//     never hangs.
//   - Split rows (S > 1, chain_dp_tiled.cu): the diag neighbour of a
//     block's first cell is the previous block's last cell at i - 1, which
//     that block pushes into this one's shared memory; the deletion fold's
//     carry into a warp is the earliest argmax of the row's earlier warps'
//     totals, which every warp pushes into the later blocks of its row
//     before a cluster barrier.
// Arithmetic is int32 in registers, as in the other bodies.

#pragma once

#include <limits.h>

#include "chain_dp_lanes.cuh"

namespace {

// The longest a read of another cluster's slot may spin (ns of %globaltimer)
constexpr unsigned long long kGridSpinNs = 4ull * 1000 * 1000 * 1000;

__device__ __forceinline__ void grid_publish(unsigned long long* p, unsigned long long v) {
  asm volatile("st.release.gpu.global.b64 [%0], %1;" ::"l"(p), "l"(v) : "memory");
}

__device__ __forceinline__ unsigned long long grid_read(const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.acquire.gpu.global.b64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// The value of slot p once its tag equals `tag`; INT_MIN where the launch's
// fault word is set, or is set here because the spin ran out.
__device__ __forceinline__ int grid_wait(const unsigned long long* p, unsigned tag,
                                         volatile int* fault) {
  unsigned long long w = grid_read(p);
  if ((unsigned)(w >> 32) == tag) return (int)(unsigned)w;
  const unsigned long long t0 = global_ns();
  for (;;) {
    if (*fault) return INT_MIN;
    w = grid_read(p);
    if ((unsigned)(w >> 32) == tag) return (int)(unsigned)w;
    if (global_ns() - t0 > kGridSpinNs) {
      *fault = 1;
      return INT_MIN;
    }
  }
}

// Where a window's K clusters exchange their chain max: slots [2][B][K]
// (tag, value) words, zeroed by the wrapper (tag 0 is never read: position
// i reads tag i >= 1); `fault`, set by a spin that ran out.
struct GridExchange {
  unsigned long long* slots;
  int* fault;
  int K;
};

// Every thread of the block, at position i: `cm` is the cluster's max end
// score at i - 1 (every warp holds it), kc the cluster's index in window b of
// the launch's B. Returns the max over the window's K clusters; `gx` is two
// ints of shared memory; one block barrier.
__device__ __forceinline__ int grid_chain(const GridExchange& g, int cm, int i, int b, int B,
                                          int kc, bool publisher, int* gx) {
  unsigned long long* row = g.slots + ((long long)(i & 1) * B + b) * g.K;
  if (publisher) grid_publish(row + kc, ((unsigned long long)(unsigned)i << 32) | (unsigned)cm);
  if (threadIdx.x < 32) {
    int v = cm;
    for (int k = threadIdx.x; k < g.K; k += 32)
      if (k != kc) v = max(v, grid_wait(row + k, (unsigned)i, g.fault));
    v = warp_max(v);
    if (threadIdx.x == 0) gx[i & 1] = v;
  }
  __syncthreads();
  return gx[i & 1];
}

}  // namespace
