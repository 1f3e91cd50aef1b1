// Panel scoring for adaptive streaming CUR on Hopper (sm_90a).
//
// Replaces: src/repro/kernels/panel_score.py::panel_score_kernel (Pallas TPU).
// Computes, for one L-column panel A_L (m x L) and a dense column sketch S_C
// (s_c x m):
//   sc_a = S_C A_L,  energy_j = |sc_a[:, j]|^2,
//   resid2_j = max(energy_j - |Q^T sc_a[:, j]|^2, 0)
// all in fp32. S_C and A_L are fp32 and fp32, bf16 and bf16, or an fp32
// sketch with a bf16 panel (a bf16 Gaussian stream, whose sketch the
// reference draws in fp32).
//
// Bound on this card: operations. At the main path's shapes (s_c = 1920,
// m = 32768, L = 256) the product is 2 s_c m L = 32.2 GFLOP in fp32, 0.48 ms
// at the non-tensor fp32 rate (67 TFLOP/s on an H100 SXM at 700 W); the bytes
// it must move, S_C's 251.7 MB and A_L's 33.5 MB read once, take 0.085 ms at
// 3.35 TB/s.
//
// Design (panel_stages.cuh, sgemm_sm90.cuh): the TPU grid (L/bl, m/bm) runs
// the m-reduction serially and would give 2 blocks at L = 256 on a card with
// 132 SMs. Here the product is a stream-K split of the 15 tiles x 2048
// k-slabs over exactly one wave of blocks (one per SM), each block a ring of
// k-major slabs feeding 8 x 16 register micro-tiles; the score stage sums
// each entry's pieces in block order, 120 blocks of 128 rows x 8 columns,
// then adds their shares of the scores. Deterministic run to run; ragged
// edges are masked in the kernels.

#include "panel_stages.cuh"

namespace {

using bf16 = __nv_bfloat16;

template <typename TS, typename TA>
void launch(const void* sc, long long lds, const void* a, long long lda, const void* q,
            long long ldq, int c, void* partial, int nblocks, void* scratch, void* sc_a,
            void* resid2, void* energy, int s_c, int m, int L, cudaStream_t st) {
  rt::sm90::launch_panel_score<TS, TA>((const TS*)sc, lds, (const TA*)a, lda, (const float*)q,
                                       ldq, c, (float*)partial, nblocks, (float*)scratch,
                                       (float*)sc_a, (float*)resid2, (float*)energy, s_c, m, L,
                                       st);
}

}  // namespace

// dtype codes: 0 float32, 1 bfloat16. Returns a cudaError_t; combinations
// outside (0, 0), (1, 1), (0, 1) give cudaErrorInvalidValue.
extern "C" int panel_score_blocks_per_sm(int sc_dtype, int a_dtype, int* out) {
  using namespace rt::sm90;
  if (sc_dtype == 0 && a_dtype == 0)
    *out = blocks_per_sm<float, float, PANEL_BN, false, float>();
  else if (sc_dtype == 1 && a_dtype == 1)
    *out = blocks_per_sm<bf16, bf16, PANEL_BN, false, float>();
  else if (sc_dtype == 0 && a_dtype == 1)
    *out = blocks_per_sm<float, bf16, PANEL_BN, false, float>();
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// BM, BK, PANEL_BN and FOLD_BN (see tile_geometry in panel_stages.cuh).
extern "C" int panel_score_geometry(int* out) {
  rt::sm90::tile_geometry(out);
  return 0;
}

extern "C" int panel_score_launch(int sc_dtype, int a_dtype, const void* sc, long long lds,
                                  const void* a, long long lda, const void* q, long long ldq,
                                  int c, void* partial, int nblocks, void* scratch, void* sc_a,
                                  void* resid2, void* energy, int s_c, int m, int L,
                                  void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
#define RT_SCORE(TS, TA)                                                                   \
  launch<TS, TA>(sc, lds, a, lda, q, ldq, c, partial, nblocks, scratch, sc_a, resid2, energy, \
                 s_c, m, L, st)
  if (sc_dtype == 0 && a_dtype == 0)
    RT_SCORE(float, float);
  else if (sc_dtype == 1 && a_dtype == 1)
    RT_SCORE(bf16, bf16);
  else if (sc_dtype == 0 && a_dtype == 1)
    RT_SCORE(float, bf16);
  else
    return (int)cudaErrorInvalidValue;
#undef RT_SCORE
  return (int)cudaGetLastError();
}
