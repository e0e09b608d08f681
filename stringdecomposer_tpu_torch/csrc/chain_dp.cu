// K1: chain DP over read windows against a monomer set (the kernel body is
// in chain_dp.cuh), the block walk, and P, the int16 probe.
//
// K1 replaces stringdecomposer_tpu/ops/chain_dp_pallas.py::_dp_kernel; the
// walk replaces the on-device stringdecomposer_tpu/ops/chain_dp.py::
// block_walk. This file instantiates the chunked kernel body for both
// routes and both state types: int32 (the default) and int16 (the explicit
// state_dtype="int16", which halves the emitted bytes and the shared
// route's column).
//
// P replaces the probe kernel `k` inside
// stringdecomposer_tpu/ops/chain_dp_pallas.py::int16_state_supported:
// o = max(roll(v, 1, axis=1), v) on an [8, 256] int16 tensor, the element at
// lane c taking lane c-1 mod cols. The wrapper runs it once per device before
// the first int16 K1 launch and compares it with its plain version. It moves
// 8 KB and does 2,048 maxima, so one launch is bound by launch latency.
//
// The shared route at L <= 512 runs the lanes body (chain_dp_lanes.cu), the
// large route there the cluster body (chain_dp_cluster.cu); sd_chain_dp
// keeps the chunked body for the sets no other body takes (the large route
// past the whole card's shared memory) and for force_body.

#include "chain_dp.cuh"

namespace {

// One thread per window: first (leftmost) argmax of the last end column,
// then one block per step back along the start pointers. Counts keep growing
// past max_blocks without writing past the array, so the caller can detect
// an overflow and recompute. T is K1's state type; the identity is computed
// in int32.
template <typename T>
__global__ void block_walk_kernel(const T* __restrict__ end,    // [B, W, M]
                                  const T* __restrict__ spend,  // [B, W, M]
                                  const int* __restrict__ wlens,  // [B]
                                  int* __restrict__ blocks,  // [B, max_blocks, 4]
                                  int* __restrict__ counts,  // [B]
                                  int B, int W, int M, int max_blocks) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const T* e = end + (long long)b * W * M;
  const T* s_ = spend + (long long)b * W * M;
  const int n = min(wlens[b], W);
  int cnt = 0;
  if (n > 0) {
    int i = n - 1;
    int j = 0;
    for (int q = 1; q < M; ++q)
      if (e[(long long)i * M + q] > e[(long long)i * M + j]) j = q;
    while (i >= 0) {
      const int s = s_[(long long)i * M + j];
      if (s < 0 || s > i) break;  // not a start pointer of this window
      const T* prev = e + (long long)max(s - 1, 0) * M;
      int best = prev[0], bj = 0;
      for (int q = 1; q < M; ++q)
        if (prev[q] > best) {
          best = prev[q];
          bj = q;
        }
      const int v = e[(long long)i * M + j];
      if (cnt < max_blocks) {
        int* r = blocks + ((long long)b * max_blocks + cnt) * 4;
        r[0] = j;
        r[1] = s;
        r[2] = i;
        r[3] = s > 0 ? v - best : v;
      }
      ++cnt;
      i = s - 1;
      j = bj;
    }
  }
  counts[b] = cnt;
}

__global__ void int16_probe_kernel(const int16_t* __restrict__ v, int16_t* __restrict__ o,
                                   int rows, int cols) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  if (x >= rows * cols) return;
  const int r = x / cols, c = x - r * cols;
  const int left = v[r * cols + (c == 0 ? cols - 1 : c - 1)];
  o[x] = (int16_t)max(left, (int)v[x]);
}

template <bool kLarge>
int launch_state(int state_bytes, const void* windows, const void* mono,
                 long long mono_bstride, const void* mono_lens, long long lens_bstride,
                 void* dp0, void* sp_scratch, void* end, void* spend, int B, int W, int M,
                 int L, int ins, int dele, int mismatch, int match, void* stream) {
  if (state_bytes == 4)
    return launch_chain_dp<kLarge, int>(windows, mono, mono_bstride, mono_lens, lens_bstride,
                                        dp0, sp_scratch, end, spend, B, W, M, L, ins, dele,
                                        mismatch, match, stream);
  if (state_bytes == 2)
    return launch_chain_dp<kLarge, int16_t>(windows, mono, mono_bstride, mono_lens, lens_bstride,
                                            dp0, sp_scratch, end, spend, B, W, M, L, ins, dele,
                                            mismatch, match, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// K1. large = 0: the shared route (dp0 is only read, sp_scratch unused).
// large = 1: the large route (dp0 is overwritten, it becomes the score
// column; sp_scratch holds B * M * L start pointers). state_bytes is 4
// (int32) or 2 (int16): dp0, sp_scratch, end and spend are of that type.
extern "C" int sd_chain_dp(int large, int state_bytes, const void* windows, const void* mono,
                           long long mono_bstride, const void* mono_lens,
                           long long lens_bstride, void* dp0, void* sp_scratch, void* end,
                           void* spend, int B, int W, int M, int L, int ins, int dele,
                           int mismatch, int match, void* stream) {
  if (large)
    return launch_state<true>(state_bytes, windows, mono, mono_bstride, mono_lens,
                              lens_bstride, dp0, sp_scratch, end, spend, B, W, M, L, ins,
                              dele, mismatch, match, stream);
  return launch_state<false>(state_bytes, windows, mono, mono_bstride, mono_lens,
                             lens_bstride, dp0, sp_scratch, end, spend, B, W, M, L, ins, dele,
                             mismatch, match, stream);
}

extern "C" int sd_block_walk(int state_bytes, const void* end, const void* spend,
                             const void* wlens, void* blocks, void* counts, int B, int W,
                             int M, int max_blocks, void* stream) {
  const int threads = 128;
  const int grid = (B + threads - 1) / threads;
  if (state_bytes == 4)
    block_walk_kernel<int><<<grid, threads, 0, (cudaStream_t)stream>>>(
        (const int*)end, (const int*)spend, (const int*)wlens, (int*)blocks, (int*)counts, B,
        W, M, max_blocks);
  else if (state_bytes == 2)
    block_walk_kernel<int16_t><<<grid, threads, 0, (cudaStream_t)stream>>>(
        (const int16_t*)end, (const int16_t*)spend, (const int*)wlens, (int*)blocks,
        (int*)counts, B, W, M, max_blocks);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

extern "C" int sd_int16_probe(const void* v, void* o, int rows, int cols, void* stream) {
  const int threads = 256;
  int16_probe_kernel<<<(rows * cols + threads - 1) / threads, threads, 0,
                       (cudaStream_t)stream>>>((const int16_t*)v, (int16_t*)o, rows, cols);
  return (int)cudaGetLastError();
}

extern "C" const char* sd_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
