// Two-sided sketch M = S_C A S_R^T on Hopper (sm_90a), batched.
//
// Replaces: src/repro/kernels/twoside_sketch.py::twoside_sketch_kernel
// (Pallas TPU; batched CUR vmaps it over a stack of matrices). For each item
// b of a batch A (B x m x n) sharing S_C (s_c x m) and S_R^T (n x s_r):
//   M_b = (S_C A_b) S_R^T          (fp32 out, fp32 accumulate)
// with fp32 or bf16 inputs (bf16 widened to fp32 as it is loaded).
//
// Bound on this card: operations. At batched CUR's full width (B = 32,
// m = n = 4096, s_c = s_r = 960) the two products are
// B (2 s_c m n + 2 s_c n s_r) = 32 (32.2 + 7.5) GFLOP = 1.27 TFLOP, 19.0 ms
// at the non-tensor fp32 rate (67 TFLOP/s, H100 SXM at 700 W), against
// 2.2 GB of input (0.69 ms at 3.35 TB/s).
//
// Design: the TPU grid (s_c/bsc, s_r/bsr, m/bm, n/bn) recomputes the tile
// t = S_C[i] A_blk for every s_r tile j, which at s_r = 960 would multiply
// the dominant term by 7.5. Here S_C A_b is computed once: two launches in a
// fixed order, the batch on blockIdx.z,
//   1. T_b = S_C A_b   into fp32 scratch (B x s_c x n; 503 MB at full width),
//   2. M_b = T_b S_R^T,
// each the tiled fp32 product of common.cuh with the whole reduction inside
// one block. No split-K and no atomics: every output entry is one block's
// sum in ascending k order, so two launches give the same bits. Ragged m, n,
// s_c, s_r are masked in the tile loads and stores (no padded copy of A), and
// operand strides are arguments (S_R^T is a transposed view of S_R). T stays
// fp32 between the stages; the TPU kernel rounds it to the input dtype.

#include "common.cuh"

template <typename T>
void launch_twoside(const T* sc, long long sc_rs, long long sc_cs, const T* a,
                    long long a_bs, long long a_rs, long long a_cs, const T* srt,
                    long long srt_rs, long long srt_cs, float* t, float* out,
                    int batch, int s_c, int m, int n, int s_r, cudaStream_t st) {
  const long long t_bs = (long long)s_c * n;
  dim3 grid1((n + rt::BN - 1) / rt::BN, (s_c + rt::BM - 1) / rt::BM, batch);
  rt::batched_gemm_kernel<T, T><<<grid1, rt::GEMM_THREADS, 0, st>>>(
      sc, sc_rs, sc_cs, 0, a, a_rs, a_cs, a_bs, t, n, 1, t_bs, s_c, n, m);
  dim3 grid2((s_r + rt::BN - 1) / rt::BN, (s_c + rt::BM - 1) / rt::BM, batch);
  rt::batched_gemm_kernel<float, T><<<grid2, rt::GEMM_THREADS, 0, st>>>(
      t, n, 1, t_bs, srt, srt_rs, srt_cs, 0, out, s_r, 1, (long long)s_c * s_r, s_c, s_r, n);
}

extern "C" int twoside_sketch_launch(int dtype, const void* sc, long long sc_rs,
                                     long long sc_cs, const void* a, long long a_bs,
                                     long long a_rs, long long a_cs, const void* srt,
                                     long long srt_rs, long long srt_cs, void* t,
                                     void* out, int batch, int s_c, int m, int n,
                                     int s_r, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0) {
    launch_twoside<float>((const float*)sc, sc_rs, sc_cs, (const float*)a, a_bs, a_rs,
                          a_cs, (const float*)srt, srt_rs, srt_cs, (float*)t, (float*)out,
                          batch, s_c, m, n, s_r, st);
  } else {
    launch_twoside<__nv_bfloat16>(
        (const __nv_bfloat16*)sc, sc_rs, sc_cs, (const __nv_bfloat16*)a, a_bs, a_rs, a_cs,
        (const __nv_bfloat16*)srt, srt_rs, srt_cs, (float*)t, (float*)out, batch, s_c, m,
        n, s_r, st);
  }
  return (int)cudaGetLastError();
}
