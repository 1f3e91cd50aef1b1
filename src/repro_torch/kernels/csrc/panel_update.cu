// Panel update of admission-only adaptive CUR on Hopper (sm_90a).
//
// Replaces: src/repro/kernels/panel_update.py::panel_update_kernel (Pallas
// TPU megakernel). For one panel A_L (m x L) it computes the panel_score
// triple (sc_a, resid2, energy), resolves the admission
//   thresh = min_gain * max(run_mean, sum(energy) / true_cols)
//   eligible_j = resid2_j > thresh      (strict)
//   rank_j = #{i eligible : resid2_i > resid2_j or (resid2_i = resid2_j, i < j)}
//   slot_j = n_filled + rank_j  if eligible_j and rank_j < min(free, panel_cap)
//            c_total            otherwise
// and updates in place M += sc_a * srt and C[:, slot_j] = A_L[:, j] for the
// admitted columns. Operand dtypes: sketch S_C and srt with the panel
// fp32/fp32, bf16/bf16, or an fp32 sketch with a bf16 panel (a bf16 Gaussian
// stream); C and M fp32 or bf16 with any of them. A bf16 M takes each fold as
// the reference's kernel does: the fp32 product rounded to bf16, then the
// bf16 sum.
//
// Bound on this card: operations. At the main path's shapes (s_c = s_r = 1920,
// m = 32768, L = 256) the sketch product is 32.2 GFLOP and the M fold
// 1.9 GFLOP in fp32, about 0.51 ms at the non-tensor fp32 rate (67 TFLOP/s,
// H100 SXM at 700 W); the bytes (S_C's 251.7 MB and A_L's 33.5 MB read, M's
// 14.7 MB read and written, the admitted columns of C written) take about
// 0.095 ms at 3.35 TB/s.
//
// Design: a fixed sequence of launches on the caller's stream.
//   1-3. the panel_score stages (panel_stages.cuh): the stream-K sketch
//        product over one wave of blocks, then the scores in two launches;
//   4.   one block resolves the threshold, the O(L^2) pairwise rank and the
//        slots (L <= 1024 fits one block; the rank formula is exactly the
//        stable top_k + cumsum selection of the reference);
//   5.   a copy kernel writes the at most panel_cap admitted columns straight
//        into C (the TPU's one-hot matmul scatter is not needed on a GPU);
//   6-7. the fold M += sc_a srt on the same mainloop (sgemm_sm90.cuh), srt
//        read in place as a transposed window (strides (1, n)); tiles that
//        one block holds whole are stored by it, the split ones by a
//        reduction in block order.
// sc_a makes one trip through device memory between stages 2 and 6, which
// the TPU kernel avoided; at 2 MB per panel it is small beside S_C.

#include "panel_stages.cuh"

namespace {

using bf16 = __nv_bfloat16;
using rt::sm90::FOLD_BN;

__global__ void admit_kernel(const float* __restrict__ resid2,
                             const float* __restrict__ energy,
                             const float* __restrict__ scal_f,
                             const int* __restrict__ scal_i, int L, int c_total,
                             int panel_cap, int* __restrict__ slots) {
  extern __shared__ float r[];  // L
  __shared__ float thresh_s;
  for (int i = threadIdx.x; i < L; i += blockDim.x) r[i] = resid2[i];
  if (threadIdx.x == 0) {
    float total = 0.f;
    for (int i = 0; i < L; ++i) total += energy[i];
    const float panel_mean = total / scal_f[2];
    thresh_s = scal_f[0] * fmaxf(scal_f[1], panel_mean);
  }
  __syncthreads();
  const float th = thresh_s;
  const int limit = min(scal_i[1], panel_cap);
  for (int j = threadIdx.x; j < L; j += blockDim.x) {
    const float rj = r[j];
    int rank = 0;
    for (int i = 0; i < L; ++i) {
      const float ri = r[i];
      rank += (ri > th) && (ri > rj || (ri == rj && i < j));
    }
    slots[j] = (rj > th && rank < limit) ? scal_i[0] + rank : c_total;
  }
}

template <typename TA, typename TC>
__global__ void copy_cols_kernel(const TA* __restrict__ a, long long lda,
                                 const int* __restrict__ slots, int L,
                                 TC* __restrict__ C, long long ldc, int c_total, int m) {
  extern __shared__ int sl[];  // L
  for (int i = threadIdx.x; i < L; i += blockDim.x) sl[i] = slots[i];
  __syncthreads();
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= m) return;
  for (int j = 0; j < L; ++j) {
    const int s = sl[j];
    if (s < c_total) C[(long long)row * ldc + s] = static_cast<TC>(a[(long long)row * lda + j]);
  }
}

// TS: S_C and srt; TA: the panel; TC: C and M; BT: srt k-contiguous.
template <typename TS, typename TA, typename TC, bool BT>
void launch_update(const void* sc, long long lds, const void* a, long long lda, const void* srt,
                   long long ld_srt, const void* q, long long ldq, int c, void* C, long long ldc,
                   int c_total, void* M, long long ldm, const void* scal_f, const void* scal_i,
                   int panel_cap, void* partial, int nblocks, int nblocks_fold, void* scratch,
                   void* sc_a, void* resid2, void* energy, void* slots, int s_c, int m, int L,
                   int s_r, cudaStream_t st) {
  rt::sm90::launch_panel_score<TS, TA>((const TS*)sc, lds, (const TA*)a, lda, (const float*)q,
                                       ldq, c, (float*)partial, nblocks, (float*)scratch,
                                       (float*)sc_a, (float*)resid2, (float*)energy, s_c, m, L,
                                       st);
  admit_kernel<<<1, 256, L * sizeof(float), st>>>((const float*)resid2, (const float*)energy,
                                                  (const float*)scal_f, (const int*)scal_i, L,
                                                  c_total, panel_cap, (int*)slots);
  copy_cols_kernel<TA, TC><<<(m + 255) / 256, 256, L * sizeof(int), st>>>(
      (const TA*)a, lda, (const int*)slots, L, (TC*)C, ldc, c_total, m);
  rt::sm90::splitk_gemm<float, TS, FOLD_BN, BT, TC>((const float*)sc_a, L, (const TS*)srt, ld_srt,
                                                    s_c, s_r, L, nblocks_fold, (float*)partial,
                                                    (TC*)M, ldm, 1, st);
}

template <typename TS, typename TA, typename TC>
int dispatch_layout(int srt_kmajor, const void* sc, long long lds, const void* a, long long lda,
                    const void* srt, long long ld_srt, const void* q, long long ldq, int c,
                    void* C, long long ldc, int c_total, void* M, long long ldm,
                    const void* scal_f, const void* scal_i, int panel_cap, void* partial,
                    int nblocks, int nblocks_fold, void* scratch, void* sc_a, void* resid2,
                    void* energy, void* slots, int s_c, int m, int L, int s_r, cudaStream_t st) {
  if (srt_kmajor)
    launch_update<TS, TA, TC, true>(sc, lds, a, lda, srt, ld_srt, q, ldq, c, C, ldc, c_total, M,
                                    ldm, scal_f, scal_i, panel_cap, partial, nblocks,
                                    nblocks_fold, scratch, sc_a, resid2, energy, slots, s_c, m, L,
                                    s_r, st);
  else
    launch_update<TS, TA, TC, false>(sc, lds, a, lda, srt, ld_srt, q, ldq, c, C, ldc, c_total, M,
                                     ldm, scal_f, scal_i, panel_cap, partial, nblocks,
                                     nblocks_fold, scratch, sc_a, resid2, energy, slots, s_c, m,
                                     L, s_r, st);
  return (int)cudaGetLastError();
}

template <typename TS, typename TC>
int fold_blocks(int srt_kmajor) {
  using namespace rt::sm90;
  return srt_kmajor ? blocks_per_sm<float, TS, FOLD_BN, true, TC>()
                    : blocks_per_sm<float, TS, FOLD_BN, false, TC>();
}

template <typename TS, typename TA>
int dispatch_acc(int cm_dtype, int srt_kmajor, const void* sc, long long lds, const void* a,
                 long long lda, const void* srt, long long ld_srt, const void* q, long long ldq,
                 int c, void* C, long long ldc, int c_total, void* M, long long ldm,
                 const void* scal_f, const void* scal_i, int panel_cap, void* partial,
                 int nblocks, int nblocks_fold, void* scratch, void* sc_a, void* resid2,
                 void* energy, void* slots, int s_c, int m, int L, int s_r, cudaStream_t st) {
#define RT_UPDATE(TC)                                                                          \
  dispatch_layout<TS, TA, TC>(srt_kmajor, sc, lds, a, lda, srt, ld_srt, q, ldq, c, C, ldc,    \
                              c_total, M, ldm, scal_f, scal_i, panel_cap, partial, nblocks,   \
                              nblocks_fold, scratch, sc_a, resid2, energy, slots, s_c, m, L,  \
                              s_r, st)
  if (cm_dtype == 0) return RT_UPDATE(float);
  if (cm_dtype == 1) return RT_UPDATE(bf16);
#undef RT_UPDATE
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype codes: 0 float32, 1 bfloat16; srt has the sketch's dtype. Accepted
// (sketch, panel): (0, 0), (1, 1), (0, 1), each with C and M 0 or 1;
// anything else gives cudaErrorInvalidValue. `stage` 0 asks for the sketch
// product's resident blocks per SM, 1 for the fold's.
extern "C" int panel_update_blocks_per_sm(int stage, int sc_dtype, int a_dtype, int cm_dtype,
                                          int srt_kmajor, int* out) {
  using namespace rt::sm90;
  const int pair = sc_dtype * 10 + a_dtype;
  if ((pair != 0 && pair != 11 && pair != 1) || (cm_dtype != 0 && cm_dtype != 1))
    return (int)cudaErrorInvalidValue;
  if (stage == 0) {
    if (pair == 0) *out = blocks_per_sm<float, float, PANEL_BN, false, float>();
    else if (pair == 11) *out = blocks_per_sm<bf16, bf16, PANEL_BN, false, float>();
    else *out = blocks_per_sm<float, bf16, PANEL_BN, false, float>();
  } else if (sc_dtype == 1) {
    *out = cm_dtype ? fold_blocks<bf16, bf16>(srt_kmajor) : fold_blocks<bf16, float>(srt_kmajor);
  } else {
    *out = cm_dtype ? fold_blocks<float, bf16>(srt_kmajor) : fold_blocks<float, float>(srt_kmajor);
  }
  return (int)cudaGetLastError();
}

// BM, BK, PANEL_BN and FOLD_BN (see tile_geometry in panel_stages.cuh).
extern "C" int panel_update_geometry(int* out) {
  rt::sm90::tile_geometry(out);
  return 0;
}

extern "C" int panel_update_launch(
    int sc_dtype, int a_dtype, int cm_dtype, int srt_kmajor, const void* sc, long long lds,
    const void* a, long long lda, const void* srt, long long ld_srt, const void* q,
    long long ldq, int c, void* C, long long ldc, int c_total, void* M, long long ldm,
    const void* scal_f, const void* scal_i, int panel_cap, void* partial, int nblocks,
    int nblocks_fold, void* scratch, void* sc_a, void* resid2, void* energy, void* slots,
    int s_c, int m, int L, int s_r, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int pair = sc_dtype * 10 + a_dtype;
#define RT_UPDATE(TS, TA)                                                                       \
  dispatch_acc<TS, TA>(cm_dtype, srt_kmajor, sc, lds, a, lda, srt, ld_srt, q, ldq, c, C, ldc,  \
                       c_total, M, ldm, scal_f, scal_i, panel_cap, partial, nblocks,           \
                       nblocks_fold, scratch, sc_a, resid2, energy, slots, s_c, m, L, s_r, st)
  if (pair == 0) return RT_UPDATE(float, float);
  if (pair == 11) return RT_UPDATE(bf16, bf16);
  if (pair == 1) return RT_UPDATE(float, bf16);
#undef RT_UPDATE
  return (int)cudaErrorInvalidValue;
}
