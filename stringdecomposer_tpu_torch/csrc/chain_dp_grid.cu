// K1's grid route at L <= 512 (chain_dp_grid.cuh): the cluster body's rows
// (chain_dp_cluster.cuh, kGrid) over K clusters a window. Its own source,
// so that nvcc builds its 96 instances beside the cluster body's.

#include "chain_dp_cluster.cuh"

namespace {

// The launch's shape as the wrapper's plan gives it (the kernel's own
// checks, so that a wrong plan is refused before launch rather than run): K
// clusters of cs blocks of R rows, every block with at least one, within
// one block's shared memory.
bool grid_shape_ok(int state_bytes, int K, int cs, int R, int M, int L) {
  const long long blocks = (long long)K * cs;
  return (state_bytes == 4 || state_bytes == 2) && K >= 1 && cs >= 1 && cs <= kClusterMax &&
         R >= 1 && (blocks - 1) * R < M && M <= blocks * R && L >= 1 &&
         L <= 32 * kLanesMaxC && grid_smem_bytes(cs * R, L, R, state_bytes) <= kSmemLimit;
}

int dispatch(int* max_clusters, int state_bytes, int K, int cs, int R, const void* windows,
             const void* mono, long long mono_bstride, const void* mono_lens,
             long long lens_bstride, const void* dp0, void* end, void* spend, int B, int W, int M,
             int L, int ins, int dele, int mismatch, int match, void* slots, void* fault,
             void* stream) {
  if (!grid_shape_ok(state_bytes, K, cs, R, M, L)) return (int)cudaErrorInvalidValue;
  const GridExchange gx = {(unsigned long long*)slots, (int*)fault, K};
  if (state_bytes == 4)
    return launch_cluster<int, true>(max_clusters, cs, R, windows, mono, mono_bstride, mono_lens,
                                     lens_bstride, dp0, end, spend, B, W, M, L, ins, dele,
                                     mismatch, match, gx, stream);
  return launch_cluster<int16_t, true>(max_clusters, cs, R, windows, mono, mono_bstride,
                                       mono_lens, lens_bstride, dp0, end, spend, B, W, M, L, ins,
                                       dele, mismatch, match, gx, stream);
}

}  // namespace

// K1's grid route at L <= 512: B windows, each on K clusters of cs blocks of
// R rows. slots: [2, B, K] int64, zeroed; fault: one int32, zeroed, set
// where a read of another cluster's slot ran out of time (the results are
// then void). dp0 is only read. state_bytes is 4 (int32) or 2 (int16).
extern "C" int sd_chain_dp_grid(int state_bytes, int K, int cs, int R, const void* windows,
                                const void* mono, long long mono_bstride, const void* mono_lens,
                                long long lens_bstride, const void* dp0, void* end, void* spend,
                                int B, int W, int M, int L, int ins, int dele, int mismatch,
                                int match, void* slots, void* fault, void* stream) {
  return dispatch(nullptr, state_bytes, K, cs, R, windows, mono, mono_bstride, mono_lens,
                  lens_bstride, dp0, end, spend, B, W, M, L, ins, dele, mismatch, match, slots,
                  fault, stream);
}

// cudaOccupancyMaxActiveClusters of the launch sd_chain_dp_grid would make
// for this shape, into *max_clusters; 0 means it cannot be scheduled.
extern "C" int sd_chain_dp_grid_occupancy(int state_bytes, int K, int cs, int R, int B, int M,
                                          int L, int* max_clusters) {
  *max_clusters = 0;
  return dispatch(max_clusters, state_bytes, K, cs, R, nullptr, nullptr, 0, nullptr, 0, nullptr,
                  nullptr, nullptr, B, 1, M, L, 0, 0, 0, 0, nullptr, nullptr, nullptr);
}
