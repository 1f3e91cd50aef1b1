// Two-sided sketch M = S_C A S_R^T on Hopper (sm_90a), batched.
//
// Replaces: src/repro/kernels/twoside_sketch.py::twoside_sketch_kernel
// (Pallas TPU; batched CUR vmaps it over a stack of matrices). For each item
// b of a batch A (B x m x n) sharing S_C (s_c x m) and S_R^T (n x s_r):
//   M_b = (S_C A_b) S_R^T          (fp32 out, fp32 accumulate)
// with fp32 or bf16 inputs (bf16 widened to fp32 on chip).
//
// Bound on this card: operations. At batched CUR's full width (B = 32,
// m = n = 4096, s_c = s_r = 960) the two products are
// B (2 s_c m n + 2 s_c n s_r) = 32 (32.2 + 7.5) GFLOP = 1.27 TFLOP, 19.0 ms
// at the non-tensor fp32 rate (67 TFLOP/s, H100 SXM at 700 W), against
// 2.2 GB of input (0.69 ms at 3.35 TB/s).
//
// Design: the TPU grid (s_c/bsc, s_r/bsr, m/bm, n/bn) recomputes the tile
// t = S_C[i] A_blk for every s_r tile j, which at s_r = 960 would multiply
// the dominant term by 7.5. Here S_C A_b is computed once: two products in a
// fixed order on the fp32 mainloop of sgemm_sm90.cuh (4-stage ring of 16-deep
// k-slabs, 128 x 256 tiles), the batch a grid axis of each launch plan,
//   1. T_b = S_C A_b   into fp32 scratch (B x s_c x n; 503 MB at full width),
//   2. M_b = T_b S_R^T,
// both with an n-contiguous B (fp32 by cp.async): the wrapper hands over
// S_R^T with contiguous rows (a copy of a transposed view, 15.7 MB at full
// width: the k-contiguous 256-wide fp32 instance would spill).
// Each plan (kernels/twoside_sketch.py) takes whole tiles for every full
// wave of the resident blocks and splits only the last, partial wave
// stream-K, so `partial` holds a few tiles per block, not one per tile. The
// plan is a pure function of the shapes and the card and the pieces of a
// split tile are summed in block order: two launches give the same bits.
// T stays fp32 between the products; the TPU kernel rounds it to the input
// dtype. The scratch costs ~1 GB of traffic at full width (~0.3 ms), small
// beside the products.

#include "sgemm_sm90.cuh"

namespace {

using bf16 = __nv_bfloat16;
using rt::sm90::PANEL_BN;  // both products' tile width

template <typename T>
void launch(const T* sc, long long lds, const T* a, long long lda, long long a_bs, const T* srt,
            long long ld_srt, float* t, float* partial, float* out, int batch, int s_c, int m,
            int n, int s_r, int nblocks1, long long whole1, int nblocks2, long long whole2,
            cudaStream_t st) {
  using rt::sm90::Batch;
  const long long t_bs = (long long)s_c * n;
  rt::sm90::splitk_gemm<T, T, PANEL_BN, false, float, true>(
      sc, lds, a, lda, s_c, n, m, nblocks1, partial, t, n, 0, st, batch, whole1,
      Batch{0, a_bs, t_bs});
  rt::sm90::splitk_gemm<float, T, PANEL_BN, false, float, true>(
      t, n, srt, ld_srt, s_c, s_r, n, nblocks2, partial, out, s_r, 0, st, batch, whole2,
      Batch{t_bs, 0, (long long)s_c * s_r});
}

}  // namespace

// dtype codes: 0 float32, 1 bfloat16 (all three operands). Each function
// returns a cudaError_t.

// Resident blocks per SM of product `stage` (0: T = S_C A_b, 1: T S_R^T).
extern "C" int twoside_sketch_blocks_per_sm(int stage, int dtype, int* out) {
  using namespace rt::sm90;
  if ((stage != 0 && stage != 1) || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    *out = blocks_per_sm<float, float, PANEL_BN, false, float, true>();
  else if (stage == 0)
    *out = blocks_per_sm<bf16, bf16, PANEL_BN, false, float, true>();
  else
    *out = blocks_per_sm<float, bf16, PANEL_BN, false, float, true>();
  return (int)cudaGetLastError();
}

// BM, BK, PANEL_BN and FOLD_BN (see tile_geometry in sgemm_sm90.cuh).
extern "C" int twoside_sketch_geometry(int* out) {
  rt::sm90::tile_geometry(out);
  return 0;
}

// S_C, each item of A (at a + z a_bs) and S_R^T have contiguous rows (row
// strides lds, lda, ld_srt). t: B s_c n floats of scratch; partial: the
// larger of the two plans' partial slots, BM x PANEL_BN floats each; out:
// B x s_c x s_r fp32.
extern "C" int twoside_sketch_launch(int dtype, const void* sc, long long lds, const void* a,
                                     long long lda, long long a_bs, const void* srt,
                                     long long ld_srt, void* t, void* partial, void* out,
                                     int batch, int s_c, int m, int n, int s_r, int nblocks1,
                                     long long whole1, int nblocks2, long long whole2,
                                     void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
#define RT_TWOSIDE(T)                                                                          \
  launch<T>((const T*)sc, lds, (const T*)a, lda, a_bs, (const T*)srt, ld_srt, (float*)t,       \
            (float*)partial, (float*)out, batch, s_c, m, n, s_r, nblocks1, whole1, nblocks2,  \
            whole2, st)
  if (dtype == 0)
    RT_TWOSIDE(float);
  else if (dtype == 1)
    RT_TWOSIDE(bf16);
  else
    return (int)cudaErrorInvalidValue;
#undef RT_TWOSIDE
  return (int)cudaGetLastError();
}
