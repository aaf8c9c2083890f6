// Split-fp16 products on the tensor cores, shared by the streamed IDG
// gridder (idg_grid.cu) and degridder (idg_degrid.cu): each f32 operand x
// becomes two fp16 planes hi = fp16(x), lo = fp16(x − hi) (22 bits of x
// where |x| < 16, so the callers scale their operands by powers of two to
// below 16), and a real product is three mma.sync.m16n8k16 passes (hi·hi,
// hi·lo, lo·hi) with f32 sums; ldmatrix and cp.async move the planes.
// Included once per kernel source: the helpers have internal linkage.

#pragma once

#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr uint32_t kNeg2 = 0x80008000u;   // flips the signs of an fp16 pair

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// 4-byte asynchronous copy to shared memory; zero-fills when !valid.
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(smem_addr(dst)), "l"(src));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d = a·b, the accumulator input zero.
__device__ __forceinline__ void mma0(float (&d)[4], const uint32_t (&a)[4],
                                     const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%10, %11, %12, %13};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]),
        "f"(0.f), "f"(0.f), "f"(0.f), "f"(0.f));
}

// re/im[n0 + h] += scale·a·b[h] (h = 0, 1: two adjacent 16×8 tiles) over one
// 16-deep step of a complex product.  Planes are 0 re hi, 1 re lo, 2 im
// hi, 3 im lo; na holds −(im hi), −(im lo).  The six passes of each tile's
// re and im go into zeroed partials (four independent mma chains), which
// are then added in f32: the tensor cores' own f32 accumulation rounds
// with a bias that grows with the chain (1.4e-4 over a 25,000-record run,
// measured on the H100), an f32 add does not.
template <int NT>
__device__ __forceinline__ void cmma2(float (&re)[NT][4], float (&im)[NT][4],
                                      int n0, const uint32_t (&a)[4][4],
                                      const uint32_t (&na)[2][4],
                                      const uint32_t (&b)[2][4][2],
                                      float scale) {
  float pr[2][4], pi[2][4];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    mma0(pr[h], a[0], b[h][0]);
    mma0(pi[h], a[0], b[h][2]);
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    mma(pr[h], na[0], b[h][2]);
    mma(pi[h], a[2], b[h][0]);
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    mma(pr[h], a[0], b[h][1]);
    mma(pi[h], a[0], b[h][3]);
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    mma(pr[h], na[0], b[h][3]);
    mma(pi[h], a[2], b[h][1]);
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    mma(pr[h], a[1], b[h][0]);
    mma(pi[h], a[1], b[h][2]);
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    mma(pr[h], na[1], b[h][2]);
    mma(pi[h], a[3], b[h][0]);
  }
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      re[n0 + h][i] = fmaf(pr[h][i], scale, re[n0 + h][i]);
      im[n0 + h][i] = fmaf(pi[h][i], scale, im[n0 + h][i]);
    }
}

__device__ __forceinline__ void negate(uint32_t (&na)[2][4],
                                       const uint32_t (&a)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    na[0][i] = a[2][i] ^ kNeg2;
    na[1][i] = a[3][i] ^ kNeg2;
  }
}

// x0, x1 → fp16 pairs hi = fp16(x), lo = fp16(x − hi) at hi[0..1], lo[0..1].
__device__ __forceinline__ void store_split(__half* hi, __half* lo, float x0,
                                            float x1) {
  const __half2 h = __floats2half2_rn(x0, x1);
  const float2 hf = __half22float2(h);
  *reinterpret_cast<__half2*>(hi) = h;
  *reinterpret_cast<__half2*>(lo) = __floats2half2_rn(x0 - hf.x, x1 - hf.y);
}

// The exponent e of the warp's largest m ≥ 0, m < 2^e, floored at −120 (and
// −120 for m = 0), so that 2^(4 − e) scales the values below 16 and stays
// finite.
__device__ __forceinline__ int warp_max_exponent(float m) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
  int e;
  frexpf(m, &e);
  return m > 0.f ? max(e, -120) : -120;
}

}  // namespace
