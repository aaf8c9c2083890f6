// Streamed IDG(-AW) gridder for NVIDIA Hopper (sm_90a), on the tensor cores.
//
// Replaces four TPU kernels of ska_sdp_tpu/kernels/ (one operator):
//   #1 idg_aw_stream_pallas.py::_kernel (idg_aw_grid_from_records_stream);
//   #3 idg_aw_stream_pallas.py::idg_aw_grid_banded, whose bands exist to fit
//      the grid into VMEM: here one padded HBM grid takes every run;
//   #5 idg_aw_pallas.py::_kernel, the run-major variant (one grid step per
//      run, used by the reference's spectral cubes under
//      SKA_SDP_TPU_IDG_AW_KERNEL=run): its double-buffered block DMA,
//      lane-interleaved sandwich factors and aligned rolls are TPU plumbing
//      (parity: tests/test_torch_spectral.py, chip_smoke.py phase 23);
//   #7 idg_pallas.py::_kernel, the fixed-tile gridder: its runs are the
//      occupied subgrids of stride S/2, with unit screens and pair 0
//      (kernels/idg_tile.py::tile_runs builds the table; chip_smoke.py
//      phases 20-22).
// Records are sorted into runs sharing one antenna pair and one uv tile; per
// run r with records b in [starts[r], ends[r]) and subgrid size S,
//
//   ph_y[q,b] = 2π/S·c_q·dy_b − π·(c_q·θ/S)²·w_b        c_q = q − S/2
//   ph_x[r,b] = 2π/S·c_r·dx_b − π·(c_r·θ_x/S)²·w_b
//   a[q,r]    = Σ_b u[q,b]·e_x[r,b],  u = v_b·e^{i·ph_y},  e_x = e^{i·ph_x}
//   t         = a ∘ conj(A[ia1]·A[ia2])                  (pair screen)
//   patch     = F·t·Fᵀ      F[y,q] = e^{−2πi(y−S/2)(q−S/2)/S}/S · taper[q]
//   grid[y0 + y, x0 + x] += patch[y, x]
//
// into a complex64 padded grid [N + 2S, Nx + 2S]; the wrapper crops it.
// Any even S ≤ 128: S = 32, 64 and 128 have their own instances; every
// other S runs on the instance of side SP = 16·⌈S/16⌉, where the phase
// rows and columns q ≥ S are zero, the wrapper zero-pads F and the
// screens to SP, and only the S×S patch is added.
//
// What bounds it on the H100.  Per record the accumulation is a complex
// rank-1 update of the S×S subgrid (8·S² flop) and per run the sandwich is
// two complex S×S×S products: 0.52 ms at the main path's 1,046,528 records
// on the CUDA cores in f32 (67 TFLOP/s).  Here they run on the tensor
// cores (989 TFLOP/s fp16, of which mma.sync reaches about half), and
// what is left beside them is the phase factors, 2·S sincos per record
// (a range reduction on the CUDA cores and the SFU), the hi/lo splits and
// the run epilogues; at S = 32, with short runs, no one of these dominates.
//
// Design:
// * products on the tensor cores in three passes of split operands, as the
//   reference's split3 tier: each f32 operand x becomes planes hi = fp16(x),
//   lo = fp16(x − hi), and a real product is three mma.sync.m16n8k16
//   passes (hi·hi, hi·lo, lo·hi).  fp16 rather than the reference's bf16:
//   bf16 planes keep 16 bits (6e-6 on the grids, which the image gates
//   amplify tenfold to 1.2e-4, past their 1e-4), fp16 planes 22 bits (~3e-7,
//   tests/test_torch_idg_grid.py::TestSplitF16Numerics).  fp16 needs its
//   range: every operand is scaled by a power of two to below 16, exactly
//   undone in f32 (u per chunk of 32 records, t per run, F by 16·S).  A
//   complex product is two real ones over a stacked depth: re += u_re·e_re
//   + (−u_im)·e_im, im += u_re·e_im + u_im·e_re.  Each 16-deep step goes
//   into zeroed fragments that are then added in f32 (cmma2), because the
//   tensor cores' own accumulation rounds with a bias that grows with the
//   chain;
// * the accumulation a = u·e_xᵀ is a GEMM over chunks of 32 records: the
//   block evaluates u and e_x of a chunk (sincos_reduced, split_f16.cuh:
//   |ph| reaches ~110 rad, so the phase is first reduced to [−π, π]; a
//   quarter of sincosf's instructions) into hi/lo planes of a two-stage
//   shared-memory ring, laid out for ldmatrix (records contiguous, rows
//   padded to 40), while the products of the chunk before run from the
//   other stage: one barrier a chunk, and two or more resident blocks per
//   SM at S ≤ 64.  The records of the next chunk arrive by cp.async a step
//   ahead;
// * the S×S complex accumulator stays in the warps' mma fragments (a warp
//   owns 16 × 8·NT of it: 32 f32 registers a thread at S = 64; two warps
//   across where SP/16 is even, else one, so that NT stays even);
// * run epilogue: the pair screen (ids clamped to nant − 1, as the TPU
//   kernel does) in f32 on the fragments; t goes to shared memory as hi/lo
//   planes; B = F·t and patch = B·Fᵀ run on the tensor cores with F's hi/lo
//   planes (built once per (S, β, device) by the wrapper; copied into
//   shared memory at S ≤ 64, read through L1 above); the patch is
//   added with one float2 atomic per cell.  Neighbouring runs' patches
//   overlap, so the sum order on the grid is not fixed;
// * blocks take work items (idg_plan.cuh), longest first: a run of more
//   than L records is split into items of L, each gridded on its own
//   (its own accumulator, screen, sandwich and patch added by the same
//   atomics), so one crowded tile no longer holds the launch on one block
//   (the SKA1-Low core's longest run is ~25 times a block's even share).
//   The launch first sorts the run table by length class (run_order_kernel,
//   a one-block counting sort, 4 classes an octave; an argsort through
//   PyTorch cost 0.13 ms, a fifth of the gridder), the split runs' items
//   in a class above every other, and counts the items in that pass; then
//   as many blocks as the device holds at once take the items in that
//   order by an atomic counter, so the longest start first and a free
//   block takes the next.  Empty entries are left out of the order, and
//   a warp's step over empty entries ends at one vote (a table is mostly
//   empty entries: the prep's run bound, a fixed-tile table's empty
//   subgrids).
//
// C interface for ctypes: idg_grid_stream() launches on the given stream,
// does not synchronise, and returns cudaGetLastError().

#include <atomic>

#include "idg_plan.cuh"
#include "split_f16.cuh"

namespace {

constexpr int kChunk = 32;             // records per ring stage
static_assert(kChunk == 32, "a chunk's scale takes one record a lane");
constexpr int kLd = kChunk + 8;        // fp16 row pitch of a chunk plane
constexpr int kPlanes = 8;             // u_re, u_im, e_re, e_im; hi and lo
constexpr int kRecRows = 5;            // dy, dx, w, vis_re, vis_im
constexpr int kClasses = 128;          // run-length classes of the order
constexpr int kSplitClass = kClasses - 1;  // items of split runs, first
constexpr int kOrderThreads = 1024;
// The launch's int scratch: the counters, then the order of the items
// (run-table indices, at most n_runs + extra), then the pieces of the
// split runs' items, which the order puts first (at most 2·extra:
// ⌈m/L⌉ ≤ 2·m/L for m > L), then the split runs (fewer than extra).
enum Counter { kNext, kOutside, kEntries, kSplitRuns, kSplitItems,
               kCounters = 8 };

// Warp tile 16 × 8·NT of the SP×SP products (NT even: cmma2 takes tile
// pairs), and resident blocks per SM.
template <int SP>
struct Tile {
  static_assert(SP % 16 == 0 && SP >= 16 && SP <= 128,
                "SP is a multiple of 16 up to 128");
  static constexpr int NT = (SP / 16) % 2 == 0 ? SP / 16 : SP / 8;
  static constexpr int kMinBlocks = SP <= 32 ? 4 : SP <= 64 ? 2 : 1;
};

template <int SP>
struct Geo {
  static constexpr int NT = Tile<SP>::NT;
  static constexpr int WM = SP / 16, WN = SP / (8 * NT);
  static constexpr int kThreads = 32 * WM * WN;
  static constexpr int kQG = kThreads / 16;     // producer row groups
  static constexpr int kQPer = SP / kQG;        // rows per producer thread
  static constexpr int kLdT = SP + 8;           // pitch of the epilogue planes
  static constexpr size_t kStage = size_t(kPlanes) * SP * kLd;
  static constexpr size_t kRing = 2 * kStage;
  // the epilogue holds t (then B) as 4 planes [SP][kLdT], and F's 4 planes
  // beside them where the ring has room (SP ≤ 72); above, F is read
  // through L1
  static constexpr bool kFShared = size_t(8) * SP * kLdT <= kRing;
  static constexpr size_t kEpi = size_t(kFShared ? 8 : 4) * SP * kLdT;
  static constexpr size_t kRecBytes = 2 * kRecRows * kChunk * sizeof(float);
  static constexpr size_t kSmem =
      kRecBytes + (kRing > kEpi ? kRing : kEpi) * sizeof(__half);
};

__device__ __forceinline__ void atomic_add_c(float2* p, float2 v) {
#if (__CUDACC_VER_MAJOR__ > 12 || \
     (__CUDACC_VER_MAJOR__ == 12 && __CUDACC_VER_MINOR__ >= 1)) && \
    defined(__CUDA_ARCH__) && __CUDA_ARCH__ >= 900
  atomicAdd(p, v);
#else
  atomicAdd(&p->x, v.x);
  atomicAdd(&p->y, v.y);
#endif
}

// Length class of a run for the block order: 0 for an empty entry, else
// 4·⌊log2 n⌋ + the next two bits of n, + 1 (classes about 19% apart).
__device__ __forceinline__ int length_class(int n) {
  if (n <= 0) return 0;
  const int e = 31 - __clz(n);
  const int m = e >= 2 ? (n >> (e - 2)) & 3 : (n << (2 - e)) & 3;
  return 4 * e + m + 1;
}

// The item order: the run-table indices of the items, by descending length
// class (a counting sort in one block; the order inside a class is
// arbitrary), the split runs' items first (kSplitClass) with their pieces
// beside them; and the counters (kNext, kOutside zeroed; kEntries the
// items in the order; kSplitRuns, kSplitItems the split runs and their
// items).  Empty entries are left out, and a warp's step over entries that
// are all empty ends at one vote: a table is mostly empty entries (the
// prep's run bound; a fixed-tile table's empty subgrids).  The block reads
// kOrderUnroll entries a thread at once, so that their loads overlap, and
// takes one shared atomic per class present in a warp.  The first pass
// lists the split runs (a few a table, or none) in `split`, and a loop
// over that list places their items.
constexpr int kOrderUnroll = 4;

__global__ void __launch_bounds__(kOrderThreads)
run_order_kernel(const int* __restrict__ starts, const int* __restrict__ ends,
                 int n, int L, int* __restrict__ counters,
                 int* __restrict__ order, int* __restrict__ piece,
                 int* __restrict__ split) {
  __shared__ int slot[kClasses];
  __shared__ int n_split;
  const int lane = threadIdx.x & 31;
  // the lengths and classes of entries b + u·blockDim.x + threadIdx.x
  // (class −1 past n and for an empty entry)
  auto classes = [&](int b, int (&m)[kOrderUnroll],
                     int (&cls)[kOrderUnroll]) {
#pragma unroll
    for (int u = 0; u < kOrderUnroll; ++u) {
      const int i = b + u * kOrderThreads + threadIdx.x;
      m[u] = i < n ? ends[i] - starts[i] : 0;
      cls[u] = m[u] <= 0 ? -1 : m[u] > L ? kSplitClass : length_class(m[u]);
    }
  };
  for (int c = threadIdx.x; c < kClasses; c += blockDim.x) slot[c] = 0;
  if (threadIdx.x == 0) n_split = 0;
  __syncthreads();
  for (int b = 0; b < n; b += kOrderUnroll * kOrderThreads) {
    int m[kOrderUnroll], cls[kOrderUnroll];
    classes(b, m, cls);
#pragma unroll
    for (int u = 0; u < kOrderUnroll; ++u) {
      if (!__any_sync(0xffffffffu, cls[u] >= 0)) continue;
      const unsigned peers = __match_any_sync(0xffffffffu, cls[u]);
      if (cls[u] == kSplitClass) {
        split[atomicAdd(&n_split, 1)] = b + u * kOrderThreads + threadIdx.x;
        atomicAdd(&slot[kSplitClass], idg_plan::item_count(m[u], L));
      } else if (cls[u] >= 0 && lane == __ffs(peers) - 1) {
        atomicAdd(&slot[cls[u]], __popc(peers));
      }
    }
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    counters[kNext] = 0;
    counters[kOutside] = 0;
    counters[kSplitRuns] = n_split;
    counters[kSplitItems] = slot[kSplitClass];
    int acc = 0;
    for (int c = kClasses - 1; c >= 0; --c) {
      const int h = slot[c];
      slot[c] = acc;
      acc += h;
    }
    counters[kEntries] = acc;
  }
  __syncthreads();
  for (int x = threadIdx.x; x < n_split; x += blockDim.x) {
    const int i = split[x];
    const int k = idg_plan::item_count(ends[i] - starts[i], L);
    const int pos = atomicAdd(&slot[kSplitClass], k);
    for (int j = 0; j < k; ++j) {
      order[pos + j] = i;
      piece[pos + j] = j;
    }
  }
  for (int b = 0; b < n; b += kOrderUnroll * kOrderThreads) {
    int m[kOrderUnroll], cls[kOrderUnroll];
    classes(b, m, cls);
#pragma unroll
    for (int u = 0; u < kOrderUnroll; ++u) {
      if (!__any_sync(0xffffffffu, cls[u] >= 0)) continue;
      const unsigned peers = __match_any_sync(0xffffffffu, cls[u]);
      // a group of empty entries or split runs (placed above) skips the
      // shuffle whole
      if (cls[u] < 0 || cls[u] == kSplitClass) continue;
      const int leader = __ffs(peers) - 1;
      int pos = 0;
      if (lane == leader) pos = atomicAdd(&slot[cls[u]], __popc(peers));
      pos = __shfl_sync(peers, pos, leader) +
            __popc(peers & ((1u << lane) - 1u));
      order[pos] = b + u * kOrderThreads + threadIdx.x;
    }
  }
}

// S = SP, or with kPad the true subgrid s_true < SP: rows and columns q ≥
// s_true of the products are zero, and only the s_true² patch is added.
// Each block takes work items (of L records at most) in the item order by
// the counter counters[kNext] until the order runs out; counters[kOutside]
// becomes nonzero if an item was skipped because its patch would leave
// the grid.
template <int SP, bool kPad>
__global__ void __launch_bounds__(Geo<SP>::kThreads, Tile<SP>::kMinBlocks)
idg_grid_kernel(const float* __restrict__ recs, int64_t n_stride,
                const int* __restrict__ order, const int* __restrict__ piece,
                int L, int* __restrict__ counters,
                const int* __restrict__ starts, const int* __restrict__ ends,
                const int* __restrict__ y0s, const int* __restrict__ x0s,
                const int* __restrict__ ia1s, const int* __restrict__ ia2s,
                const float2* __restrict__ scr, int nant,
                const __half* __restrict__ Fp,
                float2* __restrict__ grid, int HP, int WP, int s_true,
                float two_pi_s, float theta_s, float theta_x_s) {
  using G = Geo<SP>;
  constexpr int NT = G::NT;
  constexpr int kPlane = SP * kLd;         // one chunk plane
  constexpr int kPlaneT = SP * G::kLdT;    // one epilogue plane
  const int S = kPad ? s_true : SP;

  extern __shared__ float4 smem_raw[];
  float* rec_s = reinterpret_cast<float*>(smem_raw);   // [2][5][kChunk]
  __half* smem = reinterpret_cast<__half*>(
      reinterpret_cast<char*>(smem_raw) + G::kRecBytes);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;                 // fragment row
  const int t4 = lane & 3;                 // fragment column pair
  const int row0 = (warp % G::WM) * 16;
  const int col0 = (warp / G::WM) * 8 * NT;
  const float pi_f = 3.14159265358979323846f;
  const uint32_t* F32 = reinterpret_cast<const uint32_t*>(Fp);
  __shared__ int next_s;
  const int n_items = counters[kEntries];
  const int n_split = counters[kSplitItems];   // first in the order

#pragma unroll 1
  for (;;) {
    __syncthreads();                         // every thread has read next_s
    if (tid == 0) next_s = atomicAdd(counters + kNext, 1);
    __syncthreads();
    if (next_s >= n_items) break;
    const int run = order[next_s];
    int start, end;
    idg_plan::item_slice(starts[run], ends[run],
                         next_s < n_split ? piece[next_s] : 0, L, &start,
                         &end);
    const int y0 = y0s[run];
    const int x0 = x0s[run];
    // an item whose patch would leave the padded grid adds nothing, and is
    // counted (kernels/idg_tile.py raises on it)
    if (y0 < 0 || x0 < 0 || y0 > HP - S || x0 > WP - S) {
      if (tid == 0) counters[kOutside] = 1;
      continue;
    }

    float re[NT][4], im[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) re[nt][i] = im[nt][i] = 0.f;

    // ---- records of a chunk, copied a step ahead (zeros past the run) ----
    auto load_records = [&](int c0, int s) {
      float* dst = rec_s + s * kRecRows * kChunk;
      for (int e = tid; e < kRecRows * kChunk; e += G::kThreads) {
        const int row = e / kChunk;
        const int b = e - row * kChunk;
        const bool in = c0 + b < end;
        cp_async4(dst + e, recs + row * n_stride + (in ? c0 + b : 0), in);
      }
    };

    // ---- producer: a chunk's u and e_x as hi/lo planes [S][kLd] ----------
    const int pb = 2 * (tid & 15);           // this thread's record pair
    const int qg = tid >> 4;
    auto produce = [&](const float* rs, __half* st) {
      // the chunk's scale 2^(3 − e), max |v| < 2^e: |u| < 16 in fp16
      const int e = warp_max_exponent(fmaxf(fabsf(rs[3 * kChunk + lane]),
                                            fabsf(rs[4 * kChunk + lane])));
      const float sc = ldexpf(1.f, 3 - e);
      float dy[2], dx[2], w[2], vr[2], vi[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {          // v = 0 past the run
        dy[i] = rs[pb + i];
        dx[i] = rs[kChunk + pb + i];
        w[i] = rs[2 * kChunk + pb + i];
        vr[i] = sc * rs[3 * kChunk + pb + i];
        vi[i] = sc * rs[4 * kChunk + pb + i];
      }
#pragma unroll
      for (int j = 0; j < G::kQPer; ++j) {
        const int q = qg + G::kQG * j;
        __half* p = st + q * kLd + pb;
        if (kPad && q >= S) {                // zero rows of u and e_x
          store_split(p, p + kPlane, 0.f, 0.f);
          store_split(p + 2 * kPlane, p + 3 * kPlane, 0.f, 0.f);
          store_split(p + 4 * kPlane, p + 5 * kPlane, 0.f, 0.f);
          store_split(p + 6 * kPlane, p + 7 * kPlane, 0.f, 0.f);
          continue;
        }
        const float cq = float(q - S / 2);
        const float ly = cq * theta_s;
        const float lx = cq * theta_x_s;
        float ur[2], ui[2], er[2], ei[2];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const float ph_y = two_pi_s * cq * dy[i] - pi_f * (ly * ly) * w[i];
          const float ph_x = two_pi_s * cq * dx[i] - pi_f * (lx * lx) * w[i];
          float sy, cy;
          sincos_reduced(ph_y, &sy, &cy);
          sincos_reduced(ph_x, &ei[i], &er[i]);
          ur[i] = cy * vr[i] - sy * vi[i];
          ui[i] = cy * vi[i] + sy * vr[i];
        }
        store_split(p, p + kPlane, ur[0], ur[1]);
        store_split(p + 2 * kPlane, p + 3 * kPlane, ui[0], ui[1]);
        store_split(p + 4 * kPlane, p + 5 * kPlane, er[0], er[1]);
        store_split(p + 6 * kPlane, p + 7 * kPlane, ei[0], ei[1]);
      }
      return ldexpf(1.f, e - 3);             // undoes the scale
    };

    // ---- consumer: acc += u·e_xᵀ over one chunk -------------------------
    auto consume = [&](const __half* st, float unscale) {
      const __half* E = st + 4 * kPlane;
#pragma unroll 1
      for (int ks = 0; ks < kChunk / 16; ++ks) {
        uint32_t a[4][4], na[2][4];
        const __half* pa =
            st + (row0 + (lane & 15)) * kLd + ks * 16 + (lane >> 4) * 8;
#pragma unroll
        for (int p = 0; p < 4; ++p) ldsm_x4(a[p], pa + p * kPlane);
        negate(na, a);
#pragma unroll
        for (int np = 0; np < NT / 2; ++np) {
          uint32_t b[2][4][2];
          const __half* pe =
              E + (col0 + np * 16 + (lane >> 4) * 8 + (lane & 7)) * kLd +
              ks * 16 + ((lane >> 3) & 1) * 8;
#pragma unroll
          for (int p = 0; p < 4; ++p) {
            uint32_t r[4];
            ldsm_x4(r, pe + p * kPlane);
            b[0][p][0] = r[0];
            b[0][p][1] = r[1];
            b[1][p][0] = r[2];
            b[1][p][1] = r[3];
          }
          cmma2(re, im, 2 * np, a, na, b, unscale);
        }
      }
    };

    // Step k fills ring stage k & 1 with chunk k and multiplies chunk k − 1
    // out of the other stage, one barrier a step; the records of chunk k + 1
    // arrive meanwhile.  (One call site of each keeps the code small: the
    // trig loop is unrolled, 16 inlined sincos, for 7% on the H100; the
    // 16-record steps are not, which holds the registers under the cap of
    // two blocks an SM.)
    const int n_chunks = (end - start + kChunk - 1) / kChunk;
    load_records(start, 0);
    cp_async_wait_all();
    __syncthreads();
    float unscale = 1.f;                     // of the chunk in the ring
#pragma unroll 1
    for (int k = 0; k <= n_chunks; ++k) {
      if (k + 1 < n_chunks) load_records(start + (k + 1) * kChunk, (k + 1) & 1);
      float next = unscale;
      if (k < n_chunks)
        next = produce(rec_s + (k & 1) * kRecRows * kChunk,
                       smem + (k & 1) * G::kStage);
      if (k > 0) consume(smem + ((k - 1) & 1) * G::kStage, unscale);
      unscale = next;
      cp_async_wait_all();
      __syncthreads();
    }

    // ---- item epilogue ---------------------------------------------------
    __half* T = smem;                 // t, then B: 4 planes [SP][kLdT]
    __half* Fs = smem + 4 * kPlaneT;  // F's 4 planes (kFShared)
    if constexpr (G::kFShared) {
      // F's planes into shared memory, 16 bytes a copy, while the screen runs
      constexpr int kRow16 = SP / 8;
      for (int e = tid; e < 4 * SP * kRow16; e += G::kThreads) {
        const int y = e / kRow16;            // plane-major rows
        const int c = e - y * kRow16;
        cp_async16(Fs + y * G::kLdT + c * 8, Fp + y * SP + c * 8);
      }
    }
    int e_t;                                 // max |t| < 2^e_t
    {
      // t = a ∘ conj(A1·A2) in f32 on the fragments, in place
      const int i1 = max(0, min(ia1s[run], nant - 1));
      const int i2 = max(0, min(ia2s[run], nant - 1));
      const float2* A1 = scr + size_t(i1) * SP * SP;
      const float2* A2 = scr + size_t(i2) * SP * SP;
      float m = 0.f;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int q = row0 + g + 8 * h;
          const int r = col0 + nt * 8 + 2 * t4;
          const float4 s1 = __ldg(reinterpret_cast<const float4*>(
              A1 + q * SP + r));
          const float4 s2 = __ldg(reinterpret_cast<const float4*>(
              A2 + q * SP + r));
          // conj(a1·a2) at (q, r) and (q, r + 1)
          const float pr[2] = {s1.x * s2.x - s1.y * s2.y,
                               s1.z * s2.z - s1.w * s2.w};
          const float pi[2] = {-(s1.x * s2.y + s1.y * s2.x),
                               -(s1.z * s2.w + s1.w * s2.z)};
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const float ar = re[nt][2 * h + c], ai = im[nt][2 * h + c];
            re[nt][2 * h + c] = ar * pr[c] - ai * pi[c];
            im[nt][2 * h + c] = ar * pi[c] + ai * pr[c];
            m = fmaxf(m, fmaxf(fabsf(re[nt][2 * h + c]),
                               fabsf(im[nt][2 * h + c])));
          }
        }
      // the item's scale 2^(4 − e_t), max |t| < 2^e_t: |t| < 16 in fp16
      __shared__ int e_warp[32];
      e_t = warp_max_exponent(m);
      if (lane == 0) e_warp[warp] = e_t;
      __syncthreads();
      for (int i = 0; i < G::kThreads / 32; ++i) e_t = max(e_t, e_warp[i]);
      const float sc = ldexpf(1.f, 4 - e_t);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          __half* p = T + (row0 + g + 8 * h) * G::kLdT + col0 + nt * 8 + 2 * t4;
          store_split(p, p + kPlaneT, sc * re[nt][2 * h],
                      sc * re[nt][2 * h + 1]);
          store_split(p + 2 * kPlaneT, p + 3 * kPlaneT, sc * im[nt][2 * h],
                      sc * im[nt][2 * h + 1]);
          re[nt][2 * h] = re[nt][2 * h + 1] = 0.f;
          im[nt][2 * h] = im[nt][2 * h + 1] = 0.f;
        }
    }
    cp_async_wait_all();
    __syncthreads();

    // F's A fragments (rows y, depth k) and B fragments (rows x, depth k)
    auto f_a = [&](uint32_t (&a)[4][4], int y0f, int k0) {
      if constexpr (G::kFShared) {
        const __half* pa =
            Fs + (y0f + (lane & 15)) * G::kLdT + k0 + (lane >> 4) * 8;
#pragma unroll
        for (int p = 0; p < 4; ++p) ldsm_x4(a[p], pa + p * kPlaneT);
      } else {
        const int y = y0f + g;
        const int kk = k0 + 2 * t4;
#pragma unroll
        for (int p = 0; p < 4; ++p) {
          const uint32_t* f = F32 + p * (SP * SP / 2);
          a[p][0] = __ldg(f + (y * SP + kk) / 2);
          a[p][1] = __ldg(f + ((y + 8) * SP + kk) / 2);
          a[p][2] = __ldg(f + (y * SP + kk + 8) / 2);
          a[p][3] = __ldg(f + ((y + 8) * SP + kk + 8) / 2);
        }
      }
    };
    auto f_b = [&](uint32_t (&b)[2][4][2], int x0f, int k0) {
      if constexpr (G::kFShared) {
        const __half* pb_ =
            Fs + (x0f + (lane >> 4) * 8 + (lane & 7)) * G::kLdT + k0 +
            ((lane >> 3) & 1) * 8;
#pragma unroll
        for (int p = 0; p < 4; ++p) {
          uint32_t r[4];
          ldsm_x4(r, pb_ + p * kPlaneT);
          b[0][p][0] = r[0];
          b[0][p][1] = r[1];
          b[1][p][0] = r[2];
          b[1][p][1] = r[3];
        }
      } else {
        const int kk = k0 + 2 * t4;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int x = x0f + h * 8 + g;
#pragma unroll
          for (int p = 0; p < 4; ++p) {
            const uint32_t* f = F32 + p * (SP * SP / 2);
            b[h][p][0] = __ldg(f + (x * SP + kk) / 2);
            b[h][p][1] = __ldg(f + (x * SP + kk + 8) / 2);
          }
        }
      }
    };

    // ---- B = F·t: A = F (rows y, depth q), B = t (depth q, columns r) ----
#pragma unroll 1
    for (int ks = 0; ks < SP / 16; ++ks) {
      uint32_t a[4][4], na[2][4];
      f_a(a, row0, ks * 16);
      negate(na, a);
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t b[2][4][2];
        const __half* pt =
            T + (ks * 16 + ((lane >> 3) & 1) * 8 + (lane & 7)) * G::kLdT +
            col0 + np * 16 + (lane >> 4) * 8;
#pragma unroll
        for (int p = 0; p < 4; ++p) {
          uint32_t r[4];
          ldsm_x4_t(r, pt + p * kPlaneT);
          b[0][p][0] = r[0];
          b[0][p][1] = r[1];
          b[1][p][0] = r[2];
          b[1][p][1] = r[3];
        }
        cmma2(re, im, 2 * np, a, na, b, 1.f);
      }
    }
    __syncthreads();                         // t consumed
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int y = row0 + g + 8 * h;
        const int r = col0 + nt * 8 + 2 * t4;
        __half* p = T + y * G::kLdT + r;
        store_split(p, p + kPlaneT, re[nt][2 * h],
                    re[nt][2 * h + 1]);
        store_split(p + 2 * kPlaneT, p + 3 * kPlaneT, im[nt][2 * h],
                    im[nt][2 * h + 1]);
        re[nt][2 * h] = re[nt][2 * h + 1] = 0.f;
        im[nt][2 * h] = im[nt][2 * h + 1] = 0.f;
      }
    __syncthreads();

    // ---- patch = B·Fᵀ: A = B (rows y, depth r), B = F (rows x, depth r) --
#pragma unroll 1
    for (int ks = 0; ks < SP / 16; ++ks) {
      uint32_t a[4][4], na[2][4];
      const __half* pa =
          T + (row0 + (lane & 15)) * G::kLdT + ks * 16 + (lane >> 4) * 8;
#pragma unroll
      for (int p = 0; p < 4; ++p) ldsm_x4(a[p], pa + p * kPlaneT);
      negate(na, a);
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t b[2][4][2];
        f_b(b, col0 + np * 16, ks * 16);
        cmma2(re, im, 2 * np, a, na, b, 1.f);
      }
    }

    // patch = that product / (256·S²·2^(4 − e_t)): F's planes hold 16·S·F
    const float ps = ldexpf(1.f, e_t - 12) / float(S * S);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int y = row0 + g + 8 * h;
        const int x = col0 + nt * 8 + 2 * t4;
        if (kPad && (y >= S || x >= S)) continue;   // x even: x + 1 < S too
        float2* p = grid + size_t(y0 + y) * WP + x0 + x;
        atomic_add_c(p, make_float2(ps * re[nt][2 * h], ps * im[nt][2 * h]));
        atomic_add_c(p + 1, make_float2(ps * re[nt][2 * h + 1],
                                        ps * im[nt][2 * h + 1]));
      }
  }
}

// The kernel's shared-memory attributes, set once per template instance and
// device (they are runtime API calls, and every gridding call passes here),
// and the blocks the device holds at once, which the launch does not
// exceed: blocks take runs by a counter, so more would only wait for a
// slot.  A failure is returned and tried again on the next call.
template <int SP, bool kPad>
cudaError_t set_attributes(int* resident) {
  constexpr int kMaxDevices = 64;
  static std::atomic<int> blocks[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices &&
      (*resident = blocks[dev].load(std::memory_order_acquire)) > 0)
    return cudaSuccess;
  err = cudaFuncSetAttribute(idg_grid_kernel<SP, kPad>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             int(Geo<SP>::kSmem));
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(idg_grid_kernel<SP, kPad>,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             int(cudaSharedmemCarveoutMaxShared));
  if (err != cudaSuccess) return err;
  int per_sm = 0, sms = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, idg_grid_kernel<SP, kPad>, Geo<SP>::kThreads, Geo<SP>::kSmem);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  *resident = per_sm * sms > 0 ? per_sm * sms : 1;
  if (dev < kMaxDevices)
    blocks[dev].store(*resident, std::memory_order_release);
  return cudaSuccess;
}

template <int SP, bool kPad>
cudaError_t launch(const float* recs, int64_t n_stride, int* scratch,
                   int extra, const int* starts, const int* ends,
                   const int* y0, const int* x0, const int* ia1,
                   const int* ia2, int n_runs, const float2* scr, int nant,
                   const __half* Fp, float2* grid, int HP, int WP, int S,
                   float two_pi_s, float theta_s, float theta_x_s,
                   cudaStream_t stream) {
  using G = Geo<SP>;
  if (extra < idg_plan::extra_items(n_stride, S)) return cudaErrorInvalidValue;
  int resident = 0;
  const cudaError_t err = set_attributes<SP, kPad>(&resident);
  if (err != cudaSuccess) return err;
  const int L = idg_plan::item_length(n_stride, resident, S);
  int* order = scratch + kCounters;
  int* piece = order + n_runs + extra;
  run_order_kernel<<<1, kOrderThreads, 0, stream>>>(
      starts, ends, n_runs, L, scratch, order, piece, piece + 2 * extra);
  const long long items = static_cast<long long>(n_runs) + extra;
  const int blocks = items < resident ? static_cast<int>(items) : resident;
  idg_grid_kernel<SP, kPad><<<blocks, G::kThreads, G::kSmem, stream>>>(
      recs, n_stride, order, piece, L, scratch, starts, ends, y0, x0, ia1,
      ia2, scr, nant, Fp, grid, HP, WP, S, two_pi_s, theta_s, theta_x_s);
  return cudaGetLastError();
}

}  // namespace

// scratch: kCounters + n_runs + 4·extra ints (the counters, the item order,
// the split runs' pieces and the split runs; extra ≥
// idg_plan::extra_items(n_stride, S),
// kernels/idg_aw_stream.py::extra_items); screens: [nant, SP, SP]
// complex64 and F_planes: [4, SP, SP] fp16, SP = padded_side(S)
// (kernels/idg_aw_stream.py), zero outside S × S; grid: the padded [HP, WP]
// = [N + 2S, Nx + 2S] complex64 grid.
extern "C" int idg_grid_stream(const void* recs, long long n_stride,
                               void* scratch, int extra, const void* starts,
                               const void* ends, const void* y0,
                               const void* x0, const void* ia1,
                               const void* ia2, int n_runs,
                               const void* screens, int nant,
                               const void* F_planes, void* grid, int HP,
                               int WP, int S, float two_pi_s, float theta_s,
                               float theta_x_s, void* stream) {
  if (n_runs <= 0) return int(cudaGetLastError());
  auto r = static_cast<const float*>(recs);
  auto sc_ = static_cast<int*>(scratch);
  auto st = static_cast<const int*>(starts);
  auto en = static_cast<const int*>(ends);
  auto yy = static_cast<const int*>(y0);
  auto xx = static_cast<const int*>(x0);
  auto a1 = static_cast<const int*>(ia1);
  auto a2 = static_cast<const int*>(ia2);
  auto sc = static_cast<const float2*>(screens);
  auto fp = static_cast<const __half*>(F_planes);
  auto g = static_cast<float2*>(grid);
  auto s = static_cast<cudaStream_t>(stream);
  return int(dispatch_subgrid(S, [&](auto sp, auto pad) {
    return launch<decltype(sp)::value, decltype(pad)::value>(
        r, n_stride, sc_, extra, st, en, yy, xx, a1, a2, n_runs, sc, nant,
        fp, g, HP, WP, S, two_pi_s, theta_s, theta_x_s, s);
  }));
}

// The blocks of subgrid S's instance that the device holds at once (the
// gridder's launch width, from which it sizes its items), or a negative
// CUDA error code.
extern "C" int idg_grid_resident(int S) {
  int resident = 0;
  const cudaError_t err = dispatch_subgrid(S, [&](auto sp, auto pad) {
    return set_attributes<decltype(sp)::value, decltype(pad)::value>(
        &resident);
  });
  return err == cudaSuccess ? resident : -int(err);
}

extern "C" const char* idg_grid_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
