// A's variants: K1's lanes body (chain_dp_lanes.cuh) and cluster body
// (chain_dp_cluster.cuh) with one cost centre removed at compile time
// (entry csrc/chain_dp_ablate.cu, bench scripts/ablate_chain.py). Every
// production instantiation is kBase, and each variant's change is an
// `if constexpr` branch, so a kBase instance carries none of them.

#pragma once

namespace {

enum Variant : int {
  kBase = 0,     // K1 itself
  kNoChain = 1,  // a row's chain score is its own end cell at i-1: no chain max, no barrier
  kLadder4 = 2,  // the pair scan over the 32 lane totals stops after 4 doubling steps
  kLadder2 = 3,  // ... after 2
  kNoEmit = 4,   // end / spend reach device memory only at the last position
  kNoShift = 5,  // diag reads the cell's own value and pointer at i-1, not the upper-left
};

// The lane offset past the pair scan's last doubling step: 32 is all 5.
template <int kVariant>
__host__ __device__ constexpr int variant_scan_end() {
  return kVariant == kLadder4 ? 16 : (kVariant == kLadder2 ? 4 : 32);
}

}  // namespace
