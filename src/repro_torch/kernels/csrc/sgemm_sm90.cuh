// fp32 product on the CUDA cores of a Hopper card (sm_90a), split over the
// reduction so that the grid is one whole wave; shared by kernels 2, 3 and 4.
//
//   out_z[i, j] = (accumulate ? out_z[i, j] : 0) + sum_k A_z[i, k] B_z[k, j]
//
// for each item z of a batch (X_z = X + z * x_bs; a batch stride of 0 shares
// an operand across the batch). A is k-contiguous (row stride lda). B is
// n-contiguous (element (k, j) at k * ldb + j) or, with BT, k-contiguous
// (element (k, j) at j * ldb + k), the layout of a transposed window of a
// row-major sketch. A and B are float or bfloat16 each; bfloat16 travels as
// bfloat16 from device memory and is widened to fp32 on chip. Every product
// and sum is an fp32 FMA on the CUDA cores: no tensor cores, so fp32 inputs
// are never rounded.
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
// Launch plan. The output tiles of every item, ordered item by item and tile
// by tile, are taken in two parts by `nblocks` blocks (the card's resident
// slots: one wave at a time). The first `whole` tiles (a whole number of
// waves; 0 unless the caller asks for them) go one per block per wave, tile
// t to block t % nblocks, each stored straight to `out`; only the BATCHED
// instances, kernel 4's, take a batch and whole tiles. The other tiles x
// their k-slabs form `units` units of work, split stream-K: block b takes
// units [b U / P, (b + 1) U / P), a run of whole k-slabs that may cross tile
// boundaries. Each piece of a split tile that a block computes lands in its
// own slot of `partial` (slot b + t for split tile t), and the pieces of a
// tile are summed in block order, that is in ascending k, by the caller's
// epilogue (splitk_reduce_kernel, or the score stage of kernel 2). A block
// that holds a split tile whole may store it directly (`direct`). The plan
// depends only on the shapes and nblocks, so two launches sum every entry in
// the same order: no atomics, the same bits. SplitPlan mirrors split_plan in
// ../panel_score.py.
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
constexpr int PANEL_BN = 256;  // the sketch products' tile width (kernels 2, 4)
constexpr int FOLD_BN = 128;   // kernel 3's M-fold tile width

// The tile geometry that sizes the host's buffers: kernels/panel_score.py
// keeps a copy for its launch plans and checks it against each library's
// before the first launch.
inline void tile_geometry(int* out) {
  out[0] = BM;
  out[1] = BK;
  out[2] = PANEL_BN;
  out[3] = FOLD_BN;
}

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
  int ntn;               // column tiles of an item
  long long tiles_item;  // tiles of an item
  long long slabs;       // BK-deep k-slabs per tile
  long long whole;       // tiles [0, whole): one per block per wave, stored directly
  long long split;       // the other tiles, split stream-K
  long long units;       // split * slabs
  int nblocks;
  __host__ __device__ long long begin(long long b) const { return b * units / nblocks; }
  // the block whose range holds unit u
  __host__ __device__ int block_of(long long u) const {
    return (int)(((u + 1) * nblocks - 1) / units);
  }
};

inline SplitPlan make_plan(int Mdim, int Ndim, int K, int bn, int nblocks, int batch = 1,
                           long long whole = 0) {
  SplitPlan p;
  p.ntn = (Ndim + bn - 1) / bn;
  p.tiles_item = (long long)((Mdim + BM - 1) / BM) * p.ntn;
  p.slabs = (K + BK - 1) / BK;
  p.whole = whole;
  p.split = batch * p.tiles_item - whole;
  p.units = p.split * p.slabs;
  p.nblocks = nblocks;
  return p;
}

// Element strides between the items of A, B and out (0: shared by all).
struct Batch {
  long long a = 0, b = 0, o = 0;
};

// Item, first row and first column of tile t; without BATCHED the plan has
// one item and no whole tiles, and tile t is split tile t.
template <bool BATCHED>
__device__ __forceinline__ void tile_at(const SplitPlan& p, long long t, int bn, long long& z,
                                        int& i0, int& j0) {
  z = 0;
  if constexpr (BATCHED) {
    z = t / p.tiles_item;
    t -= z * p.tiles_item;
  }
  i0 = (int)(t / p.ntn) * BM;
  j0 = (int)(t % p.ntn) * bn;
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

// acc into out[i0 : i0 + BM, j0 : j0 + BN] (through store_out), masked at the
// ragged edges.
template <int TN, typename TO>
__device__ __forceinline__ void store_tile(const float (&acc)[TM][TN], TO* out, long long ldo,
                                           int Mdim, int Ndim, int i0, int j0, int accumulate) {
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
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
}

// One block of the product (see the top of this file): its whole tiles, then
// its run of the split tiles' units. With `direct`, a split tile the block
// holds whole goes straight to `out`; every other piece goes to its partial
// slot. BATCHED instances take a batch and whole tiles; the others (kernels
// 2 and 3) one item, all split, without the index arithmetic.
template <typename TA, typename TB, int BN, bool BT, typename TO, bool VEC, bool BATCHED>
__global__ void __launch_bounds__(THREADS, 1)
    splitk_gemm_kernel(const TA* __restrict__ A, long long lda, const TB* __restrict__ B,
                       long long ldb, int Mdim, int Ndim, int K, SplitPlan plan,
                       float* __restrict__ partial, TO* out, long long ldo, int accumulate,
                       int direct, Batch bs) {
  using Cfg = Tile<TB, BN, BT>;
  constexpr int TN = Cfg::TN;
  extern __shared__ __align__(16) unsigned char smem[];
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  long long z;
  int i0, j0;
  if constexpr (BATCHED) {
    for (long long t = blockIdx.x; t < plan.whole; t += plan.nblocks) {
      tile_at<true>(plan, t, BN, z, i0, j0);
      float acc[TM][TN];
      mainloop<Cfg, VEC>(acc, smem, A + z * bs.a, lda, B + z * bs.b, ldb, Mdim, Ndim, K, i0, j0,
                         0, (int)plan.slabs);
      store_tile<TN>(acc, out + z * bs.o, ldo, Mdim, Ndim, i0, j0, accumulate);
      __syncthreads();  // every thread is done with the ring before it refills
    }
  }
  long long u = plan.begin(blockIdx.x);
  const long long u1 = plan.begin(blockIdx.x + 1);
  while (u < u1) {
    const long long t = u / plan.slabs;  // split tile t, tile whole + t of the plan
    const long long tile_end = (t + 1) * plan.slabs;
    const long long ue = u1 < tile_end ? u1 : tile_end;
    tile_at<BATCHED>(plan, BATCHED ? plan.whole + t : t, BN, z, i0, j0);
    const int s0 = (int)(u - t * plan.slabs);
    float acc[TM][TN];
    mainloop<Cfg, VEC>(acc, smem, A + z * bs.a, lda, B + z * bs.b, ldb, Mdim, Ndim, K, i0, j0,
                       s0 * BK, (int)(ue - u));
    if (direct && s0 == 0 && ue == tile_end) {
      store_tile<TN>(acc, out + z * bs.o, ldo, Mdim, Ndim, i0, j0, accumulate);
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

// Sum of the partial pieces of entry (i, j) of split tile t (tile-relative
// coordinates), in block order.
template <int BN>
__device__ __forceinline__ float gather_pieces(const float* __restrict__ partial,
                                               const SplitPlan& plan, int i, int j,
                                               long long t) {
  const int blo = plan.block_of(t * plan.slabs);
  const int bhi = plan.block_of((t + 1) * plan.slabs - 1);
  const float* p = partial + (long long)i * BN + j;
  float v = 0.f;
  for (int b = blo; b <= bhi; ++b) v += p[(b + t) * (long long)(BM * BN)];
  return v;
}

// Epilogue of splitk_gemm_kernel: each output entry of a split tile is the
// sum of its pieces in block order, stored through store_out. Tiles that one
// block held whole were stored by it when `direct` is set. One thread per
// entry of the output (one item), or with BATCHED per entry of a split tile.
template <int BN, typename TO, bool BATCHED>
__global__ void __launch_bounds__(THREADS)
    splitk_reduce_kernel(const float* __restrict__ partial, SplitPlan plan, int Mdim, int Ndim,
                         TO* out, long long ldo, long long o_bs, int accumulate, int direct) {
  const long long e = (long long)blockIdx.x * THREADS + threadIdx.x;
  long long t, z = 0;
  int gi, gj;
  if constexpr (BATCHED) {
    t = e / (BM * BN);
    if (t >= plan.split) return;
    int i0, j0;
    tile_at<true>(plan, plan.whole + t, BN, z, i0, j0);
    gi = i0 + (int)(e % (BM * BN)) / BN;
    gj = j0 + (int)(e % BN);
    if (gi >= Mdim || gj >= Ndim) return;
  } else {
    if (e >= (long long)Mdim * Ndim) return;
    gi = (int)(e / Ndim);
    gj = (int)(e % Ndim);
    t = (long long)(gi / BM) * plan.ntn + gj / BN;
  }
  if (direct && plan.block_of(t * plan.slabs) == plan.block_of((t + 1) * plan.slabs - 1)) return;
  store_out(out + z * o_bs + (long long)gi * ldo + gj,
            gather_pieces<BN>(partial, plan, gi % BM, gj % BN, t), accumulate);
}

// Resident blocks per SM of splitk_gemm_kernel<...> at its shared memory
// (the aligned instance; the other has the same shared memory and, past
// 128 registers, the same single block).
template <typename TA, typename TB, int BN, bool BT, typename TO, bool BATCHED = false>
int blocks_per_sm() {
  auto kern = splitk_gemm_kernel<TA, TB, BN, BT, TO, true, BATCHED>;
  const int smem = (int)Tile<TB, BN, BT>::SMEM;
  cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  int n = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kern, THREADS, smem);
  return n;
}

// Launch the product: the 16-byte instance when both operands (and their
// batch strides) are 16-byte aligned, the element-by-element one otherwise.
template <typename TA, typename TB, int BN, bool BT, typename TO, bool BATCHED = false>
void launch_splitk(const TA* A, long long lda, const TB* B, long long ldb, int Mdim, int Ndim,
                   int K, const SplitPlan& plan, float* partial, TO* out, long long ldo,
                   int accumulate, int direct, cudaStream_t st, const Batch& bs = Batch{}) {
  const int smem = (int)Tile<TB, BN, BT>::SMEM;
  const bool vec = aligned16(A, lda) && aligned16(B, ldb) && aligned16(A, bs.a) &&
                   aligned16(B, bs.b);
  auto kern = vec ? splitk_gemm_kernel<TA, TB, BN, BT, TO, true, BATCHED>
                  : splitk_gemm_kernel<TA, TB, BN, BT, TO, false, BATCHED>;
  cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  kern<<<plan.nblocks, THREADS, smem, st>>>(A, lda, B, ldb, Mdim, Ndim, K, plan, partial, out, ldo,
                                             accumulate, direct, bs);
}

// out (+)= A B through the plan of `nblocks` blocks, then the reduction of
// the split tiles (which `partial` holds meanwhile); BATCHED: over `batch`
// items, the first `whole` tiles taken whole.
template <typename TA, typename TB, int BN, bool BT, typename TO, bool BATCHED = false>
void splitk_gemm(const TA* A, long long lda, const TB* B, long long ldb, int Mdim, int Ndim,
                 int K, int nblocks, float* partial, TO* out, long long ldo, int accumulate,
                 cudaStream_t st, int batch = 1, long long whole = 0, const Batch& bs = Batch{}) {
  const SplitPlan plan = make_plan(Mdim, Ndim, K, BN, nblocks, batch, whole);
  launch_splitk<TA, TB, BN, BT, TO, BATCHED>(A, lda, B, ldb, Mdim, Ndim, K, plan, partial, out,
                                             ldo, accumulate, 1, st, bs);
  if (plan.split == 0) return;
  const long long entries = BATCHED ? plan.split * BM * BN : (long long)Mdim * Ndim;
  const unsigned grid = (unsigned)((entries + THREADS - 1) / THREADS);
  splitk_reduce_kernel<BN, TO, BATCHED><<<grid, THREADS, 0, st>>>(partial, plan, Mdim, Ndim, out,
                                                                  ldo, bs.o, accumulate, 1);
}

}  // namespace sm90
}  // namespace rt
