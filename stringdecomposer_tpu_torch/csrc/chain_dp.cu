// K1: chain DP over read windows against a monomer set, plus the block walk.
//
// Replaces stringdecomposer_tpu/ops/chain_dp_pallas.py::_dp_kernel (reached
// through chain_dp_forward_pallas) and the on-device
// stringdecomposer_tpu/ops/chain_dp.py::block_walk. Same recurrence and tie
// rules as the lax.scan twin in stringdecomposer_tpu/ops/chain_dp.py:
//   cand = max(enter = chain(i-1) + mm + k*del, diag + mm, ins)
//   dp[k] = k*del + prefix-max_k(cand - k*del)
//   sp rides the prefix max as a payload; a tie keeps the EARLIEST k.
//   The payload of a cell is picked in the order ins, diag, enter, and the
//   ins check is unguarded at k == 0.
//
// What bounds it on the H100: the read position is a strict sequential axis
// (the chain score at i is the max over ALL monomers' end cells at i-1), so a
// window's whole [M, L] score column lives in one thread block with two
// barriers per read position. The work per position is small (M*L cells), so
// the kernel is bound by latency (barriers, warp shuffles, shared-memory
// round trips), not by device-memory bytes or operations. The design keeps
// the column (scores, start pointers, monomer codes) in shared memory, gives
// each warp whole monomer rows so that the prefix max along k is a warp
// shuffle scan carried across 32-cell chunks, and runs one window per
// block so that the windows of a batch fill the SMs. Shared memory bounds
// the monomer set: 9 bytes per cell plus 8 per monomer row must fit the
// 232,448-byte opt-in limit of one block (M * L <= ~25,000 cells, e.g.
// M = 128 at L = 192). The wrapper raises beyond it.

#include <cuda_runtime.h>
#include <stdint.h>

#define SD_NEG (-(1 << 30))

namespace {

constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ int warp_max(int v) {
  for (int o = 16; o > 0; o >>= 1) v = max(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

__global__ void __launch_bounds__(1024)
chain_dp_kernel(const int8_t* __restrict__ windows,  // [B, W]
                int W,
                const int8_t* __restrict__ mono,  // [M, L] or [B, M, L]
                long long mono_bstride,
                const int* __restrict__ mono_lens,  // [M] or [B, M]
                long long lens_bstride,
                const int* __restrict__ dp0,  // [B, M, L] column i = 0
                int* __restrict__ end,        // [B, W, M]
                int* __restrict__ spend,      // [B, W, M]
                int M, int L, int ins, int dele, int mismatch, int match) {
  extern __shared__ int smem[];
  const int ML = M * L;
  int* dp = smem;          // [M * L] scores of the current column
  int* sp = dp + ML;       // [M * L] block-start pointers
  int* ends = sp + ML;     // [M] end-cell scores of the current column
  int* lens = ends + M;    // [M]
  int8_t* mc = reinterpret_cast<int8_t*>(lens + M);  // [M * L] monomer codes

  const int b = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const int8_t* win = windows + (long long)b * W;
  const int8_t* mono_b = mono + b * mono_bstride;
  const int* lens_b = mono_lens + b * lens_bstride;
  const int* dp0_b = dp0 + (long long)b * ML;
  int* end_b = end + (long long)b * W * M;
  int* spend_b = spend + (long long)b * W * M;

  for (int x = threadIdx.x; x < ML; x += blockDim.x) {
    dp[x] = dp0_b[x];
    sp[x] = 0;
    mc[x] = mono_b[x];
  }
  for (int m = threadIdx.x; m < M; m += blockDim.x) {
    int n = lens_b[m];
    n = n < 0 ? 0 : (n > L ? L : n);
    lens[m] = n;
    const int e = n > 0 ? dp0_b[m * L + n - 1] : SD_NEG;
    ends[m] = e;
    end_b[m] = e;
    spend_b[m] = 0;
  }
  __syncthreads();

  for (int i = 1; i < W; ++i) {
    const int rc = win[i];
    int chain = SD_NEG;
    for (int m = lane; m < M; m += 32) chain = max(chain, ends[m]);
    chain = warp_max(chain);
    __syncthreads();  // every warp has read ends[] of column i-1
    int* end_i = end_b + (long long)i * M;
    int* spend_i = spend_b + (long long)i * M;
    for (int m = warp; m < M; m += nwarps) {
      const int n = lens[m];
      if (n == 0) {
        if (lane == 0) {
          ends[m] = SD_NEG;
          end_i[m] = SD_NEG;
          spend_i[m] = 0;
        }
        continue;
      }
      int* dpr = dp + m * L;
      int* spr = sp + m * L;
      const int8_t* mr = mc + m * L;
      int old_dp = SD_NEG, old_sp = 0;  // column i-1 at k-1 across chunks
      int run_t = 0, run_sp = 0;        // prefix of the earlier chunks
      for (int c0 = 0; c0 < n; c0 += 32) {
        const int k = c0 + lane;
        const bool valid = k < n;
        const int p = valid ? dpr[k] : SD_NEG;
        const int ps = valid ? spr[k] : 0;
        int up_p = __shfl_up_sync(kFull, p, 1);
        int up_ps = __shfl_up_sync(kFull, ps, 1);
        if (lane == 0) {
          up_p = old_dp;
          up_ps = old_sp;
        }
        old_dp = __shfl_sync(kFull, p, 31);
        old_sp = __shfl_sync(kFull, ps, 31);
        const int mmv = (valid && mr[k] == rc) ? match : mismatch;
        const int kdel = k * dele;
        const int enter = chain + mmv + kdel;
        const int diag = k == 0 ? SD_NEG : up_p + mmv;
        const int insr = k == 0 ? SD_NEG : p + ins;
        const int t = max(enter, max(diag, insr)) - kdel;
        // prefix max of t along k: the folded deletion chain
        int tv = t;
        for (int o = 1; o < 32; o <<= 1) {
          const int u = __shfl_up_sync(kFull, tv, o);
          if (lane >= o) tv = max(tv, u);
        }
        if (c0 > 0) tv = max(tv, run_t);
        const int dpn = tv + kdel;
        // payload as if this cell explains dpn: ins (unguarded), diag, enter
        const int cs = dpn == p + ins ? ps : (dpn == diag ? up_ps : i);
        // pair prefix max: the later element wins only when strictly greater
        int pt = t, pc = cs;
        for (int o = 1; o < 32; o <<= 1) {
          const int ut = __shfl_up_sync(kFull, pt, o);
          const int uc = __shfl_up_sync(kFull, pc, o);
          if (lane >= o && !(pt > ut)) {
            pt = ut;
            pc = uc;
          }
        }
        if (c0 > 0 && !(pt > run_t)) {
          pt = run_t;
          pc = run_sp;
        }
        run_t = __shfl_sync(kFull, pt, 31);
        run_sp = __shfl_sync(kFull, pc, 31);
        if (valid) {
          dpr[k] = dpn;
          spr[k] = pc;
        }
        if (k == n - 1) {
          ends[m] = dpn;
          end_i[m] = dpn;
          spend_i[m] = pc;
        }
      }
    }
    __syncthreads();  // column i complete before the next chain max
  }
}

// One thread per window: first (leftmost) argmax of the last end column,
// then one block per step back along the start pointers. Counts keep growing
// past max_blocks without writing past the array, so the caller can detect
// an overflow and recompute.
__global__ void block_walk_kernel(const int* __restrict__ end,    // [B, W, M]
                                  const int* __restrict__ spend,  // [B, W, M]
                                  const int* __restrict__ wlens,  // [B]
                                  int* __restrict__ blocks,  // [B, max_blocks, 4]
                                  int* __restrict__ counts,  // [B]
                                  int B, int W, int M, int max_blocks) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const int* e = end + (long long)b * W * M;
  const int* s_ = spend + (long long)b * W * M;
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
      const int* prev = e + (long long)max(s - 1, 0) * M;
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

// Same formula as ops/chain_dp_cuda.smem_bytes, which checks it before launch.
long long chain_dp_smem_bytes(int M, int L) {
  const long long ml = (long long)M * L;
  return (2 * ml + 2LL * M) * 4 + ml;
}

}  // namespace

extern "C" int sd_chain_dp(const void* windows, const void* mono,
                           long long mono_bstride, const void* mono_lens,
                           long long lens_bstride, const void* dp0, void* end,
                           void* spend, int B, int W, int M, int L, int ins,
                           int dele, int mismatch, int match, void* stream) {
  const long long smem = chain_dp_smem_bytes(M, L);
  cudaError_t err = cudaFuncSetAttribute(
      chain_dp_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int threads = 32 * (M < 32 ? M : 32);
  chain_dp_kernel<<<B, threads, (size_t)smem, (cudaStream_t)stream>>>(
      (const int8_t*)windows, W, (const int8_t*)mono, mono_bstride,
      (const int*)mono_lens, lens_bstride, (const int*)dp0, (int*)end,
      (int*)spend, M, L, ins, dele, mismatch, match);
  return (int)cudaGetLastError();
}

extern "C" int sd_block_walk(const void* end, const void* spend,
                             const void* wlens, void* blocks, void* counts,
                             int B, int W, int M, int max_blocks,
                             void* stream) {
  const int threads = 128;
  block_walk_kernel<<<(B + threads - 1) / threads, threads, 0,
                      (cudaStream_t)stream>>>(
      (const int*)end, (const int*)spend, (const int*)wlens, (int*)blocks,
      (int*)counts, B, W, M, max_blocks);
  return (int)cudaGetLastError();
}

extern "C" const char* sd_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
