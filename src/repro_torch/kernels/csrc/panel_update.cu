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
// admitted columns.
//
// Bound on this card: operations. At the main path's shapes (s_c = s_r = 1920,
// m = 32768, L = 256) the sketch product is 32.2 GFLOP and the M fold
// 1.9 GFLOP in fp32, about 0.51 ms at the non-tensor fp32 rate (67 TFLOP/s,
// H100 SXM at 700 W); the bytes (A_L, S_C, M read and written) take ~0.07 ms.
//
// Design: a short fixed sequence of launches on the caller's stream.
//   1-2. the panel_score stages (split-K sketch product, then scores);
//   3.   one block resolves the threshold, the O(L^2) pairwise rank and the
//        slots (L <= 1024 fits one block; the rank formula is exactly the
//        stable top_k + cumsum selection of the reference);
//   4.   a copy kernel writes the at most panel_cap admitted columns straight
//        into C (the TPU's one-hot matmul scatter is not needed on a GPU);
//   5.   a tiled fp32 product folds sc_a * srt into M in place.
// sc_a makes one trip through device memory between stages 2 and 5, which
// the TPU kernel avoided; at 2 MB per panel it is small beside A_L.

#include "common.cuh"

namespace {

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

template <typename T>
__global__ void copy_cols_kernel(const T* __restrict__ a, long long lda,
                                 const int* __restrict__ slots, int L,
                                 float* __restrict__ C, long long ldc, int c_total,
                                 int m) {
  extern __shared__ int sl[];  // L
  for (int i = threadIdx.x; i < L; i += blockDim.x) sl[i] = slots[i];
  __syncthreads();
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= m) return;
  for (int j = 0; j < L; ++j) {
    const int s = sl[j];
    if (s < c_total) C[(long long)row * ldc + s] = rt::to_f(a[(long long)row * lda + j]);
  }
}

template <typename T>
void launch_update(const T* sc, long long lds, const T* a, long long lda,
                   const T* srt, long long srt_rs, long long srt_cs,
                   const float* q, long long ldq, int c, float* C, long long ldc,
                   int c_total, float* M, long long ldm, const float* scal_f,
                   const int* scal_i, int panel_cap, float* partial, int nsplit,
                   int kchunk, float* sc_a, float* resid2, float* energy,
                   int* slots, int s_c, int m, int L, int s_r, cudaStream_t st) {
  rt::launch_panel_score<T>(sc, lds, a, lda, q, ldq, c, partial, nsplit, kchunk,
                            sc_a, resid2, energy, s_c, m, L, st);
  admit_kernel<<<1, 256, L * sizeof(float), st>>>(resid2, energy, scal_f, scal_i, L,
                                                  c_total, panel_cap, slots);
  copy_cols_kernel<T><<<(m + 255) / 256, 256, L * sizeof(int), st>>>(
      a, lda, slots, L, C, ldc, c_total, m);
  dim3 grid((s_r + rt::BN - 1) / rt::BN, (s_c + rt::BM - 1) / rt::BM, 1);
  rt::gemm_kernel<float, T><<<grid, rt::GEMM_THREADS, 0, st>>>(
      sc_a, L, 1, srt, srt_rs, srt_cs, M, ldm, 1, 0, s_c, s_r, L, L, 1);
}

}  // namespace

extern "C" int panel_update_launch(
    int dtype, const void* sc, long long lds, const void* a, long long lda,
    const void* srt, long long srt_rs, long long srt_cs, const void* q,
    long long ldq, int c, void* C, long long ldc, int c_total, void* M,
    long long ldm, const void* scal_f, const void* scal_i, int panel_cap,
    void* partial, int nsplit, int kchunk, void* sc_a, void* resid2,
    void* energy, void* slots, int s_c, int m, int L, int s_r, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0) {
    launch_update<float>((const float*)sc, lds, (const float*)a, lda,
                         (const float*)srt, srt_rs, srt_cs, (const float*)q, ldq,
                         c, (float*)C, ldc, c_total, (float*)M, ldm,
                         (const float*)scal_f, (const int*)scal_i, panel_cap,
                         (float*)partial, nsplit, kchunk, (float*)sc_a,
                         (float*)resid2, (float*)energy, (int*)slots, s_c, m, L,
                         s_r, st);
  } else {
    launch_update<__nv_bfloat16>(
        (const __nv_bfloat16*)sc, lds, (const __nv_bfloat16*)a, lda,
        (const __nv_bfloat16*)srt, srt_rs, srt_cs, (const float*)q, ldq, c,
        (float*)C, ldc, c_total, (float*)M, ldm, (const float*)scal_f,
        (const int*)scal_i, panel_cap, (float*)partial, nsplit, kchunk,
        (float*)sc_a, (float*)resid2, (float*)energy, (int*)slots, s_c, m, L,
        s_r, st);
  }
  return (int)cudaGetLastError();
}
