// K1's kernel body: chain DP over read windows against a monomer set.
//
// Replaces stringdecomposer_tpu/ops/chain_dp_pallas.py::_dp_kernel (reached
// through chain_dp_forward_pallas). Same recurrence and tie rules as the
// lax.scan twin in stringdecomposer_tpu/ops/chain_dp.py:
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
// this route: 2 * sizeof(T) + 1 bytes per cell plus 8 per monomer row must
// fit the 232,448-byte opt-in limit of one block (int32 state: M <= 133 at
// L = 192; int16 state: M <= 240).
//
// Large monomer sets take the large route. At L <= 512 it runs the cluster
// body (chain_dp_cluster.cuh) wherever a cluster of up to 16 blocks holds the
// rows; above, or past that, it runs this kernel body, instantiated with the
// score and pointer columns in a per-window device-memory scratch (2 *
// sizeof(T) bytes per cell; the wrapper bounds one launch's scratch so that
// it stays in the 50 MB L2) and the monomer codes read from device memory.
// Only the M end scores and lengths stay in shared memory (8 bytes per row).
// Each warp owns the same rows at every position, so its scratch rows are
// private to it; the barriers order the shared end scores exactly as in the
// shared route.
//
// The state type T is the type of the stored score and pointer columns and
// of the emitted end / spend arrays: int (int32) or int16_t. Arithmetic is
// int32 in registers either way. In int16 mode the sentinel is -2^13, as in
// the JAX kernel (_neg); the wrapper refuses int16 unless
// (W + L) * max|score| + 2^13 + max|score| < 2^15, so no stored value wraps
// and a start pointer (a read position < W) stays exact, and unless
// (W + L) * max|score| < 2^13 - max|score|, so no real score reaches the
// sentinel (at k == 0 a lower enter score would be stored as -2^13).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;

template <typename T>
struct StateNeg;
template <>
struct StateNeg<int> {
  static constexpr int value = -(1 << 30);
};
template <>
struct StateNeg<int16_t> {
  static constexpr int value = -(1 << 13);
};

__device__ __forceinline__ int warp_max(int v) {
  for (int o = 16; o > 0; o >>= 1) v = max(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

// Same formulas as ops/chain_dp_cuda.smem_bytes and large_smem_bytes, which
// the wrapper checks before launch.
inline long long chain_dp_smem_bytes(int M, int L, int state_bytes) {
  const long long ml = (long long)M * L;
  return 2LL * M * 4 + 2 * ml * state_bytes + ml;
}

inline long long chain_dp_large_smem_bytes(int M) { return 2LL * M * 4; }

// kLarge = false: the shared route, the column in shared memory (dp0 is
// only read). kLarge = true: the large route, the scores updated in place in
// dp0 and the pointers in sp_scratch (both [B, M, L] in device memory).
template <bool kLarge, typename T>
__global__ void __launch_bounds__(1024)
chain_dp_kernel(const int8_t* __restrict__ windows,  // [B, W]
                int W,
                const int8_t* __restrict__ mono,  // [M, L] or [B, M, L]
                long long mono_bstride,
                const int* __restrict__ mono_lens,  // [M] or [B, M]
                long long lens_bstride,
                T* dp0,         // [B, M, L] column i = 0
                T* sp_scratch,  // [B, M, L] (large route only)
                T* __restrict__ end,    // [B, W, M]
                T* __restrict__ spend,  // [B, W, M]
                int M, int L, int ins, int dele, int mismatch, int match) {
  constexpr int kNeg = StateNeg<T>::value;
  extern __shared__ int smem[];
  const int ML = M * L;
  const int b = blockIdx.x;
  const int8_t* mono_b = mono + b * mono_bstride;
  T* dp0_b = dp0 + (long long)b * ML;
  int* ends = smem;      // [M] end-cell scores of the current column
  int* lens = ends + M;  // [M]
  T* dp;                 // [M * L] scores of the current column
  T* sp;                 // [M * L] block-start pointers
  const int8_t* mc;      // [M * L] monomer codes
  int8_t* mc_copy = nullptr;  // shared route: the codes copied to shared memory
  if (kLarge) {
    dp = dp0_b;
    sp = sp_scratch + (long long)b * ML;
    mc = mono_b;
  } else {
    dp = reinterpret_cast<T*>(lens + M);
    sp = dp + ML;
    mc_copy = reinterpret_cast<int8_t*>(sp + ML);
    mc = mc_copy;
  }

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const int8_t* win = windows + (long long)b * W;
  const int* lens_b = mono_lens + b * lens_bstride;
  T* end_b = end + (long long)b * W * M;
  T* spend_b = spend + (long long)b * W * M;

  for (int x = threadIdx.x; x < ML; x += blockDim.x) {
    if (!kLarge) {
      dp[x] = dp0_b[x];
      mc_copy[x] = mono_b[x];
    }
    sp[x] = 0;
  }
  for (int m = threadIdx.x; m < M; m += blockDim.x) {
    int n = lens_b[m];
    n = n < 0 ? 0 : (n > L ? L : n);
    lens[m] = n;
    const int e = n > 0 ? (int)dp0_b[m * L + n - 1] : kNeg;  // read before any update
    ends[m] = e;
    end_b[m] = (T)e;
    spend_b[m] = 0;
  }
  __syncthreads();

  for (int i = 1; i < W; ++i) {
    const int rc = win[i];
    int chain = kNeg;
    for (int m = lane; m < M; m += 32) chain = max(chain, ends[m]);
    chain = warp_max(chain);
    __syncthreads();  // every warp has read ends[] of column i-1
    T* end_i = end_b + (long long)i * M;
    T* spend_i = spend_b + (long long)i * M;
    for (int m = warp; m < M; m += nwarps) {
      const int n = lens[m];
      if (n == 0) {
        if (lane == 0) {
          ends[m] = kNeg;
          end_i[m] = (T)kNeg;
          spend_i[m] = 0;
        }
        continue;
      }
      T* dpr = dp + m * L;
      T* spr = sp + m * L;
      const int8_t* mr = mc + m * L;
      int old_dp = kNeg, old_sp = 0;  // column i-1 at k-1 across chunks
      int run_t = 0, run_sp = 0;      // prefix of the earlier chunks
      for (int c0 = 0; c0 < n; c0 += 32) {
        const int k = c0 + lane;
        const bool valid = k < n;
        const int p = valid ? (int)dpr[k] : kNeg;
        const int ps = valid ? (int)spr[k] : 0;
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
        const int diag = k == 0 ? kNeg : up_p + mmv;
        const int insr = k == 0 ? kNeg : p + ins;
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
          dpr[k] = (T)dpn;
          spr[k] = (T)pc;
        }
        if (k == n - 1) {
          ends[m] = dpn;
          end_i[m] = (T)dpn;
          spend_i[m] = (T)pc;
        }
      }
    }
    __syncthreads();  // column i complete before the next chain max
  }
}

template <bool kLarge, typename T>
int launch_chain_dp(const void* windows, const void* mono, long long mono_bstride,
                    const void* mono_lens, long long lens_bstride, void* dp0,
                    void* sp_scratch, void* end, void* spend, int B, int W, int M,
                    int L, int ins, int dele, int mismatch, int match, void* stream) {
  const long long smem =
      kLarge ? chain_dp_large_smem_bytes(M) : chain_dp_smem_bytes(M, L, sizeof(T));
  cudaError_t err = cudaFuncSetAttribute(chain_dp_kernel<kLarge, T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int threads = 32 * (M < 32 ? M : 32);
  chain_dp_kernel<kLarge, T><<<B, threads, (size_t)smem, (cudaStream_t)stream>>>(
      (const int8_t*)windows, W, (const int8_t*)mono, mono_bstride, (const int*)mono_lens,
      lens_bstride, (T*)dp0, (T*)sp_scratch, (T*)end, (T*)spend, M, L, ins, dele, mismatch,
      match);
  return (int)cudaGetLastError();
}

}  // namespace
