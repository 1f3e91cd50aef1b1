// Panel scoring for adaptive streaming CUR on Hopper (sm_90a).
//
// Replaces: src/repro/kernels/panel_score.py::panel_score_kernel (Pallas TPU).
// Computes, for one L-column panel A_L (m x L) and a dense column sketch S_C
// (s_c x m):
//   sc_a = S_C A_L,  energy_j = |sc_a[:, j]|^2,
//   resid2_j = max(energy_j - |Q^T sc_a[:, j]|^2, 0)
// all in fp32, with bf16 or fp32 inputs.
//
// Bound on this card: operations. At the main path's shapes (s_c = 1920,
// m = 32768, L = 256) the product is 2 s_c m L = 32.2 GFLOP in fp32 against
// 33.5 MB of input, far above the fp32 ridge point, so the floor is the
// non-tensor fp32 rate (67 TFLOP/s on an H100 SXM at 700 W): about 0.48 ms.
//
// Design: the TPU grid (L/bl, m/bm) runs the m-reduction serially and would
// give only 2 blocks at L = 256 on a card with 132 SMs. Here the m-reduction
// is split across blocks (blockIdx.z) into per-split partials of sc_a; a
// second launch, one block per panel column, sums the splits in a fixed
// order and computes the energies and residuals from the column held in
// shared memory. Both stages are plain tiled fp32 FMA code (no wgmma/TMA
// yet), deterministic run to run. Ragged edges are masked in the kernels.

#include "common.cuh"

extern "C" int panel_score_launch(int dtype, const void* sc, long long lds,
                                  const void* a, long long lda, const void* q,
                                  long long ldq, int c, void* partial, int nsplit,
                                  int kchunk, void* sc_a, void* resid2, void* energy,
                                  int s_c, int m, int L, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0) {
    rt::launch_panel_score<float>((const float*)sc, lds, (const float*)a, lda,
                                  (const float*)q, ldq, c, (float*)partial, nsplit,
                                  kchunk, (float*)sc_a, (float*)resid2,
                                  (float*)energy, s_c, m, L, st);
  } else {
    rt::launch_panel_score<__nv_bfloat16>(
        (const __nv_bfloat16*)sc, lds, (const __nv_bfloat16*)a, lda,
        (const float*)q, ldq, c, (float*)partial, nsplit, kchunk, (float*)sc_a,
        (float*)resid2, (float*)energy, s_c, m, L, st);
  }
  return (int)cudaGetLastError();
}
