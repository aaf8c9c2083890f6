// The records and the tile sort shared by the bank w-projection scatter
// (wproj_grid.cu) and gather (wproj_degrid.cu): placement of a record in
// p's type, exactly as ops/coords.py::frac_coord computes it, and the
// helpers of a stable CUB radix sort of (tile key, record) pairs.

#pragma once

#include <cub/device/device_radix_sort.cuh>
#include <cuda_runtime.h>
#include <stdint.h>

namespace wproj {

constexpr int kTile = 32;                 // T; kernels/wproj.py TILE

__device__ __forceinline__ float mul_rn(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ double mul_rn(double a, double b) {
  return __dmul_rn(a, b);
}
__device__ __forceinline__ float add_rn(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ double add_rn(double a, double b) {
  return __dadd_rn(a, b);
}

// ops/coords.py::frac_coord in p's type, one rounding per operation as
// there: x = n//2 + p·n, cell = floor(x + 0.5/qpx), frac = round((x −
// cell)·qpx), half to even.
template <typename F>
__device__ __forceinline__ void frac_coord(F p, int n, int qpx, F half_q,
                                           int& cell, int& frac) {
  const F x = add_rn(mul_rn(p, F(n)), F(n / 2));
  const F c = floor(add_rn(x, half_q));
  cell = int(c);
  frac = int(rint(mul_rn(add_rn(x, -c), F(qpx))));
}

// A record (kernels/wproj.py::wproj_records): its placement (y0, x0), its
// flat bank plane, clamped to [0, nk − 1], and whether any of its gh × gw
// cells lies inside the H × W grid.
template <typename F>
__device__ __forceinline__ bool place(const F* __restrict__ p,
                                      const int* __restrict__ wbin,
                                      int64_t b, int qpx, F half_q, int nk,
                                      int gh, int gw, int H, int W, int& y0,
                                      int& x0, int& k) {
  int x, xf, y, yf;
  frac_coord(p[3 * b], W, qpx, half_q, x, xf);
  frac_coord(p[3 * b + 1], H, qpx, half_q, y, yf);
  y0 = y - gh / 2;
  x0 = x - gw / 2;
  k = min(max(wbin[b] * (qpx * qpx) + yf * qpx + xf, 0), nk - 1);
  return y0 > -gh && y0 < H && x0 > -gw && x0 < W;
}

inline int key_bits(int top) {  // bits that hold 0..top
  int b = 1;
  while ((top >> b) != 0) ++b;
  return b;
}

inline size_t align256(size_t x) { return (x + 255) & ~size_t(255); }

// Temporary storage of a stable radix sort of n (int key, int value) pairs
// over the key's low `bits` bits.
inline size_t sort_temp_bytes(int n, int bits) {
  size_t bytes = 0;
  cub::DeviceRadixSort::SortPairs(nullptr, bytes, static_cast<int*>(nullptr),
                                  static_cast<int*>(nullptr),
                                  static_cast<int*>(nullptr),
                                  static_cast<int*>(nullptr), n, 0, bits);
  return bytes;
}

}  // namespace wproj
