// fp32 product on the CUDA cores of a Hopper card (sm_90a), split over the
// reduction so that the grid is one whole wave; shared by kernels 2 and 3.
//
//   out[i, j] = (accumulate ? out[i, j] : 0) + sum_k A[i, k] B[k, j]
//
// A is k-contiguous (row stride lda). B is n-contiguous (element (k, j) at
// k * ldb + j) or, with BT, k-contiguous (element (k, j) at j * ldb + k), the
// layout of a transposed window of a row-major sketch. A and B are float or
// bfloat16 each; bfloat16 travels as bfloat16 from device memory and is
// widened to fp32 on chip. Every product and sum is an fp32 FMA on the CUDA
// cores: no tensor cores, so fp32 inputs are never rounded.
//
// Mainloop. A block of 256 threads computes a BM x BN tile (BN = 256 or 128);
// thread (ty, tx) of a 16 x 16 grid owns an 8 x BN/16 micro-tile: rows
// ty*4 + {0..3} and 64 + ty*4 + {0..3}, columns tx*4 + 64 q + {0..3}. The
// reduction advances in BK = 16 deep k-slabs through a ring of STAGES = 4
// buffers in dynamic shared memory, with one wait and one __syncthreads per
// slab, three slabs in flight. In the ring both operands lie k-major, so
// each k step reads its fragments as float4 (2 of A, BN/64 of B) for
// 8 x BN/16 FMAs. A is k-contiguous in memory: each slab of it is fetched
// into registers three slabs ahead (16-byte loads, bf16 widened to fp32)
// and stored transposed once the current slab is multiplied; a k-contiguous
// B (BT) likewise, and an n-contiguous bf16 B as it lies. An n-contiguous
// fp32 B goes by 16-byte cp.async copies. The ring is fp32 throughout, so
// nothing is widened in the inner loop. Ragged edges are zero-filled;
// operands that are not 16-byte aligned take an instance that reads them
// element by element. Each accumulator sums its terms in ascending k, one
// FMA each.
//
// Launch plan (stream-K). The output tiles x k-slabs form `units` units of
// work, ordered tile by tile. Block b of the `nblocks` (= the card's resident
// slots, one whole wave) takes units [b U / P, (b + 1) U / P): a run of
// whole k-slabs that may cross tile boundaries. Each piece of a tile that a
// block computes lands in its own slot of `partial` (slot b + t for tile t),
// and the pieces of a tile are summed in block order, that is in ascending
// k, by the caller's epilogue (splitk_reduce_kernel, or the score stage of
// kernel 2). A block that holds a whole tile may store it directly
// (`direct`). The plan depends only on the shapes and nblocks, so two
// launches sum every entry in the same order: no atomics, the same bits.
// SplitPlan mirrors split_plan in ../panel_score.py.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

#include "cp_async.cuh"

namespace rt {
namespace sm90 {

constexpr int THREADS = 256;
constexpr int BM = 128;
constexpr int BK = 16;
constexpr int STAGES = 4;
constexpr int TM = 8;

// Four consecutive floats from shared memory.
__device__ __forceinline__ void ld4(const float* p, float* v) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  v[0] = t.x;
  v[1] = t.y;
  v[2] = t.z;
  v[3] = t.w;
}

// out = v, or out + v with `accumulate`. A bf16 out rounds v to bf16 first and
// then the sum, as the reference's kernel and `M.add_(P.to(M.dtype))` do.
__device__ __forceinline__ void store_out(float* o, float v, int accumulate) {
  *o = accumulate ? *o + v : v;
}
__device__ __forceinline__ void store_out(__nv_bfloat16* o, float v, int accumulate) {
  const __nv_bfloat16 r = __float2bfloat16_rn(v);
  *o = accumulate ? __float2bfloat16_rn(__bfloat162float(*o) + __bfloat162float(r)) : r;
}

struct SplitPlan {
  int ntn;          // column tiles
  long long slabs;  // BK-deep k-slabs per tile
  long long units;  // tiles * slabs
  int nblocks;
  __host__ __device__ long long begin(long long b) const { return b * units / nblocks; }
  // the block whose range holds unit u
  __host__ __device__ int block_of(long long u) const {
    return (int)(((u + 1) * nblocks - 1) / units);
  }
};

inline SplitPlan make_plan(int Mdim, int Ndim, int K, int bn, int nblocks) {
  SplitPlan p;
  p.ntn = (Ndim + bn - 1) / bn;
  p.slabs = (K + BK - 1) / BK;
  p.units = (long long)((Mdim + BM - 1) / BM) * p.ntn * p.slabs;
  p.nblocks = nblocks;
  return p;
}

// 16-byte copies need 16-byte aligned rows
template <typename T>
inline int aligned16(const T* p, long long ld) {
  const unsigned long long bits =
      reinterpret_cast<unsigned long long>(p) | (unsigned long long)(ld * sizeof(T));
  return bits % 16 == 0;
}

template <typename TB, int BN_, bool BT_>
struct Tile {
  static constexpr int BN = BN_;
  static constexpr int TN = BN_ / 16;  // B columns per thread
  static constexpr bool BT = BT_;
  // B goes by cp.async when it is fp32 and n-contiguous, through registers
  // otherwise (transposed with BT, widened when bf16)
  static constexpr bool B_ASYNC = !BT && std::is_same<TB, float>::value;
  // the ring, all fp32: A as [BK][BM + 4], B as [BK][BN + 4] with BT, else [BK][BN]
  static constexpr int PA = BM + 4;
  static constexpr int PB = BT ? BN + 4 : BN;
  static constexpr int A_STAGE = BK * PA;
  static constexpr int B_STAGE = BK * PB;
  static constexpr size_t A_BYTES = A_STAGE * sizeof(float);
  static constexpr size_t B_BYTES = B_STAGE * sizeof(float);
  static constexpr size_t SMEM = STAGES * (A_BYTES + B_BYTES);
};

// 16 bytes of an operand as raw bits: loaded whole, or the first `cnt`
// elements one by one (the rest zero). Nothing waits on a load until the
// bits are unpacked, after the slab in flight has been multiplied.
template <typename T>
__device__ __forceinline__ uint4 load_bits(const T* p, int cnt, bool whole) {
  if (whole) return __ldg(reinterpret_cast<const uint4*>(p));
  unsigned w[4] = {0u, 0u, 0u, 0u};
  if (sizeof(T) == 4) {
    const unsigned* q = reinterpret_cast<const unsigned*>(p);
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (e < cnt) w[e] = q[e];
  } else {
    const unsigned short* q = reinterpret_cast<const unsigned short*>(p);
#pragma unroll
    for (int e = 0; e < 8; ++e)
      if (e < cnt) w[e / 2] |= (unsigned)q[e] << (16 * (e % 2));
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// The 16 / sizeof(T) elements held in `b`, as fp32 (bf16 is the top half of one).
template <typename T>
__device__ __forceinline__ void unpack(const uint4& b, float* o) {
  const unsigned w[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    if (sizeof(T) == 4) {
      o[e] = __uint_as_float(w[e]);
    } else {
      o[2 * e] = __uint_as_float(w[e] << 16);
      o[2 * e + 1] = __uint_as_float(w[e] & 0xffff0000u);
    }
  }
}

// Rows [r0, r0 + ROWS) x k [k0, k0 + BK) of a k-contiguous operand X (row
// stride ld), fetched into registers (16-byte loads with VEC) and stored,
// widened to fp32 and transposed, into a ring buffer [BK][P]; rows >= nrows
// and k >= kend are zero. Four (fp32) or two (bf16) neighbouring threads
// read one row's slab, so the loads are whole 32-byte sectors.
template <typename T, int ROWS>
struct KStage {
  static constexpr int E = 16 / (int)sizeof(T);  // elements per load
  static constexpr int CPR = BK / E;             // loads per row
  static constexpr int N = ROWS * CPR / THREADS;  // loads per thread
  static_assert(ROWS * CPR % THREADS == 0, "whole loads per thread");
  uint4 raw[N];

  template <bool VEC>
  __device__ __forceinline__ void fetch(const T* __restrict__ X, long long ld, int r0, int nrows,
                                        int k0, int kend) {
#pragma unroll
    for (int n = 0; n < N; ++n) {
      const int c = threadIdx.x + n * THREADS;
      const int gr = r0 + c / CPR, gk = k0 + (c % CPR) * E;
      const int cnt = gr < nrows ? max(0, min(E, kend - gk)) : 0;
      raw[n] = load_bits(X + (long long)gr * ld + gk, cnt, VEC && cnt == E);
    }
  }
  template <int P>
  __device__ __forceinline__ void stash(float* s) const {
#pragma unroll
    for (int n = 0; n < N; ++n) {
      const int c = threadIdx.x + n * THREADS;
      float v[E];
      unpack<T>(raw[n], v);
      float* d = s + ((c % CPR) * E) * P + c / CPR;
#pragma unroll
      for (int e = 0; e < E; ++e) d[e * P] = v[e];
    }
  }
};

// k [k0, k0 + BK) x columns [c0, c0 + COLS) of an n-contiguous operand X,
// fetched into registers and stored, widened to fp32, as they lie into a
// ring buffer [BK][COLS]; k >= kend and columns >= ncols are zero.
template <typename T, int COLS>
struct NStage {
  static constexpr int E = 16 / (int)sizeof(T);
  static constexpr int CPR = COLS / E;
  static constexpr int N = BK * CPR / THREADS;
  static_assert(BK * CPR % THREADS == 0, "whole loads per thread");
  uint4 raw[N];

  template <bool VEC>
  __device__ __forceinline__ void fetch(const T* __restrict__ X, long long ld, int c0, int ncols,
                                        int k0, int kend) {
#pragma unroll
    for (int n = 0; n < N; ++n) {
      const int c = threadIdx.x + n * THREADS;
      const int gk = k0 + c / CPR, gn = c0 + (c % CPR) * E;
      const int cnt = gk < kend ? max(0, min(E, ncols - gn)) : 0;
      raw[n] = load_bits(X + (long long)gk * ld + gn, cnt, VEC && cnt == E);
    }
  }
  template <int P>
  __device__ __forceinline__ void stash(float* s) const {
#pragma unroll
    for (int n = 0; n < N; ++n) {
      const int c = threadIdx.x + n * THREADS;
      float v[E];
      unpack<T>(raw[n], v);
      float* d = s + (c / CPR) * P + (c % CPR) * E;
#pragma unroll
      for (int e = 0; e < E; e += 4)
        *reinterpret_cast<float4*>(d + e) = make_float4(v[e], v[e + 1], v[e + 2], v[e + 3]);
    }
  }
};

struct NoStage {};

// k [k0, k0 + BK) x columns [c0, c0 + COLS) of an n-contiguous fp32 operand X
// into ring buffer s ([BK][COLS]) by cp.async (VEC), or element by element;
// k >= kend and columns >= ncols are zero.
template <int COLS, bool VEC>
__device__ __forceinline__ void load_nrows(float* s, const float* X, long long ld, int c0,
                                           int ncols, int k0, int kend) {
  constexpr int CPR = COLS / 4;
  static_assert(BK * CPR % THREADS == 0, "whole copies per thread");
#pragma unroll
  for (int n_ = 0; n_ < BK * CPR / THREADS; ++n_) {
    const int c = threadIdx.x + n_ * THREADS;
    const int k = c / CPR, nc = (c % CPR) * 4;
    const int gk = k0 + k, gn = c0 + nc;
    float* dst = s + k * COLS + nc;
    const bool k_ok = gk < kend;
    if (VEC) {
      const int n = k_ok ? max(0, min(4, ncols - gn)) : 0;
      cp_async16(dst, n > 0 ? X + (long long)gk * ld + gn : X, n * (int)sizeof(float));
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        dst[e] = (k_ok && gn + e < ncols) ? X[(long long)gk * ld + gn + e] : 0.f;
    }
  }
}

// Tile row of a thread's accumulator row i, and tile column of its column j.
__device__ __forceinline__ int tile_row(int ty, int i) { return (i < 4 ? 0 : 64) + ty * 4 + i % 4; }
__device__ __forceinline__ int tile_col(int tx, int j) { return tx * 4 + 64 * (j / 4) + j % 4; }

// acc = A[i0 : i0 + BM, kb : kb + nslab BK] B[kb : ..., j0 : j0 + BN] for this
// thread's micro-tile, through the ring in `smem`. What goes through
// registers is fetched STAGES - 1 slabs ahead and stored once the current
// slab is multiplied; what goes by cp.async lands by itself. VEC: both
// operands are 16-byte aligned (rows and base).
template <class Cfg, bool VEC, typename TA, typename TB>
__device__ __forceinline__ void mainloop(float (&acc)[TM][Cfg::TN], unsigned char* smem,
                                         const TA* __restrict__ A, long long lda,
                                         const TB* __restrict__ B, long long ldb, int Mdim,
                                         int Ndim, int K, int i0, int j0, int kb, int nslab) {
  constexpr int TN = Cfg::TN;
  float* sA = reinterpret_cast<float*>(smem);
  float* sB = reinterpret_cast<float*>(smem + STAGES * Cfg::A_BYTES);
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  KStage<TA, BM> ra;
  typename std::conditional<
      Cfg::BT, KStage<TB, Cfg::BN>,
      typename std::conditional<Cfg::B_ASYNC, NoStage, NStage<TB, Cfg::BN>>::type>::type rb;
  auto fetch = [&](int slab) {
    const int k0 = kb + slab * BK;
    ra.template fetch<VEC>(A, lda, i0, Mdim, k0, K);
    if constexpr (Cfg::B_ASYNC)
      load_nrows<Cfg::BN, VEC>(sB + (slab % STAGES) * Cfg::B_STAGE, B, ldb, j0, Ndim, k0, K);
    else
      rb.template fetch<VEC>(B, ldb, j0, Ndim, k0, K);
  };
  auto stash = [&](int slab) {
    ra.template stash<Cfg::PA>(sA + (slab % STAGES) * Cfg::A_STAGE);
    if constexpr (!Cfg::B_ASYNC) rb.template stash<Cfg::PB>(sB + (slab % STAGES) * Cfg::B_STAGE);
  };

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nslab) {
      fetch(s);
      stash(s);
    }
    cp_async_commit();
  }
  for (int it = 0; it < nslab; ++it) {
    // groups committed so far: STAGES - 1 + it; slab `it` is group `it`
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // slab `it` visible to all; slab it - 1's buffer free
    const int nx = it + STAGES - 1;
    const bool more = nx < nslab;
    if (more) fetch(nx);
    cp_async_commit();

    const float* a_s = sA + (it % STAGES) * Cfg::A_STAGE + ty * 4;
    const float* b_s = sB + (it % STAGES) * Cfg::B_STAGE + tx * 4;
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[TM], b[TN];
      ld4(a_s + kk * Cfg::PA, a);
      ld4(a_s + kk * Cfg::PA + 64, a + 4);
#pragma unroll
      for (int q = 0; q < TN / 4; ++q) ld4(b_s + kk * Cfg::PB + 64 * q, b + 4 * q);
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    if (more) stash(nx);  // into slab it - 1's buffer, which every thread is done with
  }
  cp_async_wait<0>();  // only empty groups are left
}

// One block of the stream-K product (see the top of this file). With
// `direct`, a tile the block holds whole goes straight to `out` (through
// store_out); every other piece goes to its partial slot.
template <typename TA, typename TB, int BN, bool BT, typename TO, bool VEC>
__global__ void __launch_bounds__(THREADS, 1)
    splitk_gemm_kernel(const TA* __restrict__ A, long long lda, const TB* __restrict__ B,
                       long long ldb, int Mdim, int Ndim, int K, SplitPlan plan,
                       float* __restrict__ partial, TO* out, long long ldo, int accumulate,
                       int direct) {
  using Cfg = Tile<TB, BN, BT>;
  constexpr int TN = Cfg::TN;
  extern __shared__ __align__(16) unsigned char smem[];
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  long long u = plan.begin(blockIdx.x);
  const long long u1 = plan.begin(blockIdx.x + 1);
  while (u < u1) {
    const long long t = u / plan.slabs;
    const long long tile_end = (t + 1) * plan.slabs;
    const long long ue = u1 < tile_end ? u1 : tile_end;
    const int i0 = (int)(t / plan.ntn) * BM;
    const int j0 = (int)(t % plan.ntn) * BN;
    const int s0 = (int)(u - t * plan.slabs);
    float acc[TM][TN];
    mainloop<Cfg, VEC>(acc, smem, A, lda, B, ldb, Mdim, Ndim, K, i0, j0, s0 * BK, (int)(ue - u));
    if (direct && s0 == 0 && ue == tile_end) {
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const int gi = i0 + tile_row(ty, i);
        if (gi >= Mdim) continue;
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          const int gj = j0 + tile_col(tx, j);
          if (gj < Ndim) store_out(out + (long long)gi * ldo + gj, acc[i][j], accumulate);
        }
      }
    } else {
      float* p = partial + (blockIdx.x + t) * (long long)(BM * BN);
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        float* row = p + tile_row(ty, i) * BN + tx * 4;
#pragma unroll
        for (int q = 0; q < TN / 4; ++q)
          *reinterpret_cast<float4*>(row + 64 * q) =
              make_float4(acc[i][4 * q], acc[i][4 * q + 1], acc[i][4 * q + 2], acc[i][4 * q + 3]);
      }
    }
    u = ue;
    __syncthreads();  // every thread is done with the ring before it refills
  }
}

// Sum of the partial pieces of output entry (i, j), in block order.
template <int BN>
__device__ __forceinline__ float gather_pieces(const float* __restrict__ partial,
                                               const SplitPlan& plan, int i, int j,
                                               long long t) {
  const int blo = plan.block_of(t * plan.slabs);
  const int bhi = plan.block_of((t + 1) * plan.slabs - 1);
  const float* p = partial + (long long)(i % BM) * BN + j % BN;
  float v = 0.f;
  for (int b = blo; b <= bhi; ++b) v += p[(b + t) * (long long)(BM * BN)];
  return v;
}

// Epilogue of splitk_gemm_kernel: each output entry of a split tile is the
// sum of its pieces in block order, stored through store_out. Tiles that one
// block held whole were stored by it when `direct` is set.
template <int BN, typename TO>
__global__ void __launch_bounds__(THREADS)
    splitk_reduce_kernel(const float* __restrict__ partial, SplitPlan plan, int Mdim, int Ndim,
                         TO* out, long long ldo, int accumulate, int direct) {
  const long long e = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (e >= (long long)Mdim * Ndim) return;
  const int i = (int)(e / Ndim), j = (int)(e % Ndim);
  const long long t = (long long)(i / BM) * plan.ntn + j / BN;
  if (direct && plan.block_of(t * plan.slabs) == plan.block_of((t + 1) * plan.slabs - 1)) return;
  store_out(out + (long long)i * ldo + j, gather_pieces<BN>(partial, plan, i, j, t), accumulate);
}

// Resident blocks per SM of splitk_gemm_kernel<...> at its shared memory
// (the aligned instance; the other has the same shared memory and, past
// 128 registers, the same single block).
template <typename TA, typename TB, int BN, bool BT, typename TO>
int blocks_per_sm() {
  auto kern = splitk_gemm_kernel<TA, TB, BN, BT, TO, true>;
  const int smem = (int)Tile<TB, BN, BT>::SMEM;
  cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  int n = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kern, THREADS, smem);
  return n;
}

// Launch the stream-K product: the 16-byte instance when both operands
// are 16-byte aligned, the element-by-element one otherwise.
template <typename TA, typename TB, int BN, bool BT, typename TO>
void launch_splitk(const TA* A, long long lda, const TB* B, long long ldb, int Mdim, int Ndim,
                   int K, const SplitPlan& plan, float* partial, TO* out, long long ldo,
                   int accumulate, int direct, cudaStream_t st) {
  const int smem = (int)Tile<TB, BN, BT>::SMEM;
  auto kern = aligned16(A, lda) && aligned16(B, ldb)
                  ? splitk_gemm_kernel<TA, TB, BN, BT, TO, true>
                  : splitk_gemm_kernel<TA, TB, BN, BT, TO, false>;
  cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  kern<<<plan.nblocks, THREADS, smem, st>>>(A, lda, B, ldb, Mdim, Ndim, K, plan, partial, out, ldo,
                                             accumulate, direct);
}

// out (+)= A B through the stream-K plan of `nblocks` blocks, then the
// reduction of the split tiles (which `partial` holds meanwhile).
template <typename TA, typename TB, int BN, bool BT, typename TO>
void splitk_gemm(const TA* A, long long lda, const TB* B, long long ldb, int Mdim, int Ndim,
                 int K, int nblocks, float* partial, TO* out, long long ldo, int accumulate,
                 cudaStream_t st) {
  const SplitPlan plan = make_plan(Mdim, Ndim, K, BN, nblocks);
  launch_splitk<TA, TB, BN, BT, TO>(A, lda, B, ldb, Mdim, Ndim, K, plan, partial, out, ldo,
                                    accumulate, 1, st);
  const unsigned grid = (unsigned)(((long long)Mdim * Ndim + THREADS - 1) / THREADS);
  splitk_reduce_kernel<BN, TO><<<grid, THREADS, 0, st>>>(partial, plan, Mdim, Ndim, out, ldo,
                                                         accumulate, 1);
}

}  // namespace sm90
}  // namespace rt
