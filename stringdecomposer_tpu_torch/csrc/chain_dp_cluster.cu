// K1's cluster body (chain_dp_cluster.cuh): the large route at L <= 512,
// a window's rows spread over a thread block cluster. Its own source, so
// that nvcc builds its 96 instances (int32 and int16 state, C = 1..16, three
// row forms) beside the other sources', not after them.

#include "chain_dp_cluster.cuh"

namespace {

// The launch's shape as the wrapper's plan gives it: cs blocks of R rows,
// every block with at least one (the kernel's own checks, so that a wrong
// plan is refused before launch rather than run).
bool cluster_shape_ok(int state_bytes, int cs, int R, int M, int L) {
  return (state_bytes == 4 || state_bytes == 2) && cs >= 1 && cs <= kClusterMax && R >= 1 &&
         (long long)(cs - 1) * R < M && M <= (long long)cs * R && L >= 1 &&
         L <= 32 * kLanesMaxC && cluster_smem_bytes(M, L, R, state_bytes) <= kSmemLimit;
}

int dispatch(int* max_clusters, int state_bytes, int cs, int R, const void* windows,
             const void* mono, long long mono_bstride, const void* mono_lens,
             long long lens_bstride, const void* dp0, void* end, void* spend, int B, int W, int M,
             int L, int ins, int dele, int mismatch, int match, void* stream) {
  if (!cluster_shape_ok(state_bytes, cs, R, M, L)) return (int)cudaErrorInvalidValue;
  const GridExchange none = {nullptr, nullptr, 1};
  if (state_bytes == 4)
    return launch_cluster<int, false>(max_clusters, cs, R, windows, mono, mono_bstride,
                                      mono_lens, lens_bstride, dp0, end, spend, B, W, M, L, ins,
                                      dele, mismatch, match, none, stream);
  return launch_cluster<int16_t, false>(max_clusters, cs, R, windows, mono, mono_bstride,
                                        mono_lens, lens_bstride, dp0, end, spend, B, W, M, L,
                                        ins, dele, mismatch, match, none, stream);
}

}  // namespace

// K1's cluster body: B windows, each on a cluster of cs blocks of R rows.
// dp0 is only read. state_bytes is 4 (int32) or 2 (int16): dp0, end and
// spend are of that type.
extern "C" int sd_chain_dp_cluster(int state_bytes, int cs, int R, const void* windows,
                                   const void* mono, long long mono_bstride,
                                   const void* mono_lens, long long lens_bstride,
                                   const void* dp0, void* end, void* spend, int B, int W, int M,
                                   int L, int ins, int dele, int mismatch, int match,
                                   void* stream) {
  return dispatch(nullptr, state_bytes, cs, R, windows, mono, mono_bstride, mono_lens,
                  lens_bstride, dp0, end, spend, B, W, M, L, ins, dele, mismatch, match, stream);
}

// cudaOccupancyMaxActiveClusters of the launch sd_chain_dp_cluster would
// make for this shape, into *max_clusters; 0 means it cannot be scheduled.
extern "C" int sd_chain_dp_cluster_occupancy(int state_bytes, int cs, int R, int B, int M, int L,
                                             int* max_clusters) {
  *max_clusters = 0;
  return dispatch(max_clusters, state_bytes, cs, R, nullptr, nullptr, 0, nullptr, 0, nullptr,
                  nullptr, nullptr, B, 1, M, L, 0, 0, 0, 0, nullptr);
}
