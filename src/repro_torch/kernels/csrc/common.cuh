// Shared device code of the port's hand-written Hopper kernels (sm_90a).
//
// Every sum here runs in a fixed order with fp32 FMAs on the CUDA cores: no
// float atomics, no tensor cores (so no TF32 rounding), so a launch gives the
// same bits on every run at the same shapes. bf16 inputs are widened to fp32
// as they are loaded; all accumulation is fp32.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace rt {

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

constexpr int BM = 128;
constexpr int BN = 128;
constexpr int BK = 8;
constexpr int GEMM_THREADS = 256;

// Tiled fp32 product on the CUDA cores, split over the reduction dimension.
//
//   out_z[i, j] = (accumulate ? out_z[i, j] : 0) + sum_{k in K_z} A[i, k] * B[k, j]
//
// with K_z = [z * kchunk, min(K, (z + 1) * kchunk)) for z = blockIdx.z, and
// out_z = out + z * o_zs. Element (i, k) of A is A[i * a_rs + k * a_cs]; B and
// out likewise, so transposed and windowed operands need no copy.
//
// A block computes a 128x128 tile; each of its 256 threads owns an 8x8
// micro-tile (rows ty*4 + {0..3} and 64 + ty*4 + {0..3}, columns likewise
// from tx), reads its fragments from shared memory as float4, and sums k in
// ascending order with one FMA per term (zero-filled past the ragged edges,
// which adds exact zeros). The next k-slab is fetched into registers while
// the current one is multiplied. Tile loads walk whichever dimension of an
// operand is contiguous; the +4 padding keeps those shared-memory stores
// free of bank conflicts and the float4 reads aligned.
//
// gemm_tile is the body of one block (output tile (blockIdx.y, blockIdx.x),
// reduction range [kb, ke) into the slab `o`); batched_gemm_kernel selects
// the batch item with blockIdx.z. Kernel 4 (twoside_sketch.cu) runs on it;
// kernels 2 and 3 run on sgemm_sm90.cuh.
template <typename TA, typename TB>
__device__ __forceinline__ void gemm_tile(
    const TA* __restrict__ A, long long a_rs, long long a_cs,
    const TB* __restrict__ B, long long b_rs, long long b_cs,
    float* o, long long o_rs, long long o_cs,
    int Mdim, int Ndim, int kb, int ke, int accumulate) {
  __shared__ __align__(16) float As[BK][BM + 4];
  __shared__ __align__(16) float Bs[BK][BN + 4];
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int i0 = blockIdx.y * BM;
  const int j0 = blockIdx.x * BN;
  const bool a_kfast = (a_cs == 1);
  const bool b_jfast = (b_cs == 1);

  // this thread's four loads of each tile: (row, k) of A and (k, col) of B
  int a_i[4], a_k[4], b_k[4], b_j[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int e = tid + r * GEMM_THREADS;  // 0..1023
    if (a_kfast) { a_i[r] = e / BK; a_k[r] = e % BK; } else { a_i[r] = e % BM; a_k[r] = e / BM; }
    if (b_jfast) { b_k[r] = e / BN; b_j[r] = e % BN; } else { b_k[r] = e % BK; b_j[r] = e / BK; }
  }
  float ra[4], rb[4];
  auto fetch = [&](int k0) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int gi = i0 + a_i[r], gk = k0 + a_k[r];
      ra[r] = (gi < Mdim && gk < ke) ? to_f(A[(long long)gi * a_rs + (long long)gk * a_cs]) : 0.f;
      const int gk2 = k0 + b_k[r], gj = j0 + b_j[r];
      rb[r] = (gk2 < ke && gj < Ndim) ? to_f(B[(long long)gk2 * b_rs + (long long)gj * b_cs]) : 0.f;
    }
  };
  auto stash = [&]() {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      As[a_k[r]][a_i[r]] = ra[r];
      Bs[b_k[r]][b_j[r]] = rb[r];
    }
  };

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  if (kb < ke) {
    fetch(kb);
    stash();
  }
  __syncthreads();
  for (int k0 = kb; k0 < ke; k0 += BK) {
    const bool more = k0 + BK < ke;
    if (more) fetch(k0 + BK);  // in flight while this slab is multiplied
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(&As[kk][ty * 4]);
      const float4 a1 = *reinterpret_cast<const float4*>(&As[kk][64 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Bs[kk][tx * 4]);
      const float4 b1 = *reinterpret_cast<const float4*>(&Bs[kk][64 + tx * 4]);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
    if (more) stash();
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int gi = i0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + i - 4);
    if (gi >= Mdim) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int gj = j0 + (j < 4 ? tx * 4 + j : 64 + tx * 4 + j - 4);
      if (gj >= Ndim) continue;
      const long long idx = (long long)gi * o_rs + (long long)gj * o_cs;
      o[idx] = accumulate ? o[idx] + acc[i][j] : acc[i][j];
    }
  }
}

// The tiled product over a batch, one item per blockIdx.z, whole reduction
// in each block: out_z = A_z * B_z with X_z = X + z * x_bs (a batch stride
// of 0 shares an operand across the batch).
template <typename TA, typename TB>
__global__ void __launch_bounds__(GEMM_THREADS, 2) batched_gemm_kernel(
    const TA* __restrict__ A, long long a_rs, long long a_cs, long long a_bs,
    const TB* __restrict__ B, long long b_rs, long long b_cs, long long b_bs,
    float* out, long long o_rs, long long o_cs, long long o_bs,
    int Mdim, int Ndim, int K) {
  const long long z = blockIdx.z;
  gemm_tile<TA, TB>(A + z * a_bs, a_rs, a_cs, B + z * b_bs, b_rs, b_cs, out + z * o_bs,
                    o_rs, o_cs, Mdim, Ndim, 0, K, 0);
}

}  // namespace rt
