// The work items shared by the streamed IDG gridder (idg_grid.cu) and
// degridder (idg_degrid.cu): a block takes a bounded slice of one run's
// records, not a whole run, so that one crowded uv tile (the SKA1-Low core
// puts ~10% of a snapshot into one) is spread over many blocks instead of
// holding the launch on one.  kernels/idg_aw_stream.py::run_items states
// the same rule in PyTorch.
//
// Item j of run r holds the records [starts[r] + j·L, min(starts[r] +
// (j + 1)·L, ends[r])).  A run of at most L records is one item; a longer
// one is split, and its items are counted.  Gridding is linear, so the
// items' patches add to the run's; a degridded record reads the run's
// image, which every item of the run computes alike.

#pragma once

#include <cuda_runtime.h>

namespace idg_plan {

// L ≥ kFloor·S: an item's extra sandwich (16·S³) is then at most 1/16 of
// its records' accumulation (8·S² each).
constexpr int kFloor = 32;
constexpr int kAlign = 32;              // the kernels' record chunk

// The item length: the larger of kFloor·S and half a resident block's
// share of the n records, rounded up to whole chunks, so that the longest
// item takes about half the time a block would spend at an even split.
inline int item_length(long long n, int resident, int S) {
  const long long share = (n + 2LL * resident - 1) / (2LL * resident);
  const long long l = (share + kAlign - 1) / kAlign * kAlign;
  const long long floor = static_cast<long long>(kFloor) * S;
  return static_cast<int>(l > floor ? l : floor);
}

// Items beyond one a run, at most: each split run of m > L records adds
// ⌈m/L⌉ − 1 < m/L, and L ≥ kFloor·S.  The scratch the wrappers allocate.
inline int extra_items(long long n, int S) {
  return static_cast<int>(n / (static_cast<long long>(kFloor) * S)) + 1;
}

// The items of a run of m records (0 for an empty entry); divides only
// for a run longer than L, so that a pass over a table of short runs
// costs no division.
__device__ __forceinline__ int item_count(int m, int L) {
  if (m <= L) return m > 0 ? 1 : 0;
  return (m - 1) / L + 1;
}

// Records [*s, *e) of item `piece` of the run [start, end).
__device__ __forceinline__ void item_slice(int start, int end, int piece,
                                           int L, int* s, int* e) {
  *s = start + piece * L;
  *e = min(*s + L, end);
}

}  // namespace idg_plan
