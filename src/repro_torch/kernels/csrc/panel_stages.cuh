// The panel sketch and its scores, shared by kernels 2 and 3 (sm_90a):
//   sc_a = S_C A_L,  energy_j = |sc_a[:, j]|^2,
//   resid2_j = max(energy_j - |Q^T sc_a[:, j]|^2, 0)
// S_C (s_c x m) and A_L (m x L) are row-major, fp32 or bf16 each; Q (s_c x c)
// and every output are fp32.
//
// Three launches: the stream-K product of sgemm_sm90.cuh into its partial
// slots; score_tiles_kernel, one block per 128-row tile and 8 panel columns,
// which sums each entry's pieces in block order into sc_a and computes the
// tile's share of the energies and of Q^T sc_a (a small tiled product: each
// thread owns 4 basis columns and one of 8 row classes); score_finish_kernel,
// which adds the row tiles' shares in order. The pieces' loads of a block are
// independent, so the ~10-piece sums do not wait on each other, and Q is read
// once per 8 columns. Every sum runs in a fixed order, so two launches give
// the same bits.
#pragma once

#include "sgemm_sm90.cuh"

namespace rt {
namespace sm90 {

constexpr int PANEL_BN = 256;  // product tile width: a 256-column panel is one tile wide
constexpr int JT = 8;          // panel columns a score block takes (divides PANEL_BN)
constexpr int QCHUNK = 128;    // basis columns per pass (32 threads x 4)
constexpr int FOLD_BN = 128;   // kernel 3's M-fold tile width

// The tile geometry that sizes the host's buffers: kernels/panel_score.py
// keeps a copy for its launch plan and checks it against this one before
// the first launch.
inline void tile_geometry(int* out) {
  out[0] = BM;
  out[1] = BK;
  out[2] = PANEL_BN;
  out[3] = FOLD_BN;
}

// Floats of scratch the score stage needs: the row tiles' shares of Q^T sc_a
// ([row tile][c][L]) and of the energies ([row tile][L]).
inline size_t score_scratch(int s_c, int L, int c) {
  return (size_t)((s_c + BM - 1) / BM) * (c + 1) * L;
}

__global__ void __launch_bounds__(THREADS)
    score_tiles_kernel(const float* __restrict__ partial, SplitPlan plan,
                       const float* __restrict__ q, long long ldq, int c, int qvec,
                       float* __restrict__ sc_a, long long ld_sca, float* __restrict__ proj_part,
                       float* __restrict__ energy_part, int s_c, int L) {
  constexpr int RPT = BM * JT / THREADS;  // entries a thread sums
  constexpr int RSTEP = THREADS / JT;
  __shared__ __align__(16) float y[BM][JT];
  __shared__ float red[8][QCHUNK][JT];
  __shared__ float ered[THREADS];
  const int tid = threadIdx.x;
  const int ti = blockIdx.y, i0 = ti * BM, j0 = blockIdx.x * JT;

  // 1. rows tid/JT + RSTEP e of column j: the pieces summed in block order
  {
    const int cj = tid % JT, j = j0 + cj;
    float v[RPT];
#pragma unroll
    for (int e = 0; e < RPT; ++e) v[e] = 0.f;
    if (j < L) {
      const long long t = (long long)ti * plan.ntn + j / PANEL_BN;
      const int blo = plan.block_of(t * plan.slabs);
      const int bhi = plan.block_of((t + 1) * plan.slabs - 1);
      const float* p = partial + (long long)(tid / JT) * PANEL_BN + j % PANEL_BN;
      for (int b = blo; b <= bhi; ++b) {
        const float* pb = p + (b + t) * (long long)(BM * PANEL_BN);
#pragma unroll
        for (int e = 0; e < RPT; ++e) v[e] += pb[(long long)e * RSTEP * PANEL_BN];
      }
    }
    float en = 0.f;
#pragma unroll
    for (int e = 0; e < RPT; ++e) {
      const int r = tid / JT + e * RSTEP;
      const bool ok = j < L && i0 + r < s_c;
      const float val = ok ? v[e] : 0.f;
      if (ok) sc_a[(long long)(i0 + r) * ld_sca + j] = val;
      y[r][cj] = val;
      en = fmaf(val, val, en);
    }
    ered[tid] = en;
  }
  __syncthreads();
  for (int s = THREADS / 2; s >= JT; s >>= 1) {  // threads tid and tid + s share a column
    if (tid < s) ered[tid] += ered[tid + s];
    __syncthreads();
  }
  if (tid < JT && j0 + tid < L) energy_part[(long long)ti * L + j0 + tid] = ered[tid];

  // 2. this tile's share of Q^T y, QCHUNK basis columns at a time
  const int h = tid / 32;         // row class: rows h + 8 s
  const int k4 = (tid % 32) * 4;  // four basis columns of the chunk
  for (int k0 = 0; k0 < c; k0 += QCHUNK) {
    float pacc[4][JT];
#pragma unroll
    for (int e = 0; e < 4; ++e)
#pragma unroll
      for (int cj = 0; cj < JT; ++cj) pacc[e][cj] = 0.f;
    const int kq = k0 + k4;
    const bool whole = qvec && kq + 3 < c;
#pragma unroll 2
    for (int s = 0; s < BM / 8; ++s) {
      const int r = h + 8 * s;
      const float* qp = q + (long long)(i0 + r) * ldq + kq;
      float qv[4];
      if (i0 + r >= s_c) {
#pragma unroll
        for (int e = 0; e < 4; ++e) qv[e] = 0.f;
      } else if (whole) {
        const float4 t4 = __ldg(reinterpret_cast<const float4*>(qp));
        qv[0] = t4.x;
        qv[1] = t4.y;
        qv[2] = t4.z;
        qv[3] = t4.w;
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) qv[e] = kq + e < c ? qp[e] : 0.f;
      }
#pragma unroll
      for (int cj = 0; cj < JT; ++cj) {
        const float yv = y[r][cj];
#pragma unroll
        for (int e = 0; e < 4; ++e) pacc[e][cj] = fmaf(qv[e], yv, pacc[e][cj]);
      }
    }
#pragma unroll
    for (int e = 0; e < 4; ++e)
#pragma unroll
      for (int cj = 0; cj < JT; ++cj) red[h][k4 + e][cj] = pacc[e][cj];
    __syncthreads();
#pragma unroll
    for (int r = 0; r < QCHUNK * JT / THREADS; ++r) {
      const int p = tid + r * THREADS;  // = k * JT + column
      const int k = p / JT, cj = p % JT;
      if (k0 + k < c && j0 + cj < L) {
        float t = 0.f;
#pragma unroll
        for (int hh = 0; hh < 8; ++hh) t += red[hh][k][cj];
        proj_part[((long long)ti * c + k0 + k) * L + j0 + cj] = t;
      }
    }
    __syncthreads();
  }
}

__global__ void __launch_bounds__(THREADS)
    score_finish_kernel(const float* __restrict__ proj_part, const float* __restrict__ energy_part,
                        int n_ti, int c, float* __restrict__ resid2, float* __restrict__ energy,
                        int L) {
  __shared__ float red[THREADS];
  const int tid = threadIdx.x;
  const int j0 = blockIdx.x * JT, j = j0 + tid % JT;
  float sq = 0.f;
  if (j < L) {
    for (int k = tid / JT; k < c; k += THREADS / JT) {
      float t = 0.f;
#pragma unroll 4
      for (int ti = 0; ti < n_ti; ++ti) t += proj_part[((long long)ti * c + k) * L + j];
      sq = fmaf(t, t, sq);
    }
  }
  red[tid] = sq;
  __syncthreads();
  for (int s = THREADS / 2; s >= JT; s >>= 1) {
    if (tid < s) red[tid] += red[tid + s];
    __syncthreads();
  }
  if (tid < JT && j0 + tid < L) {
    float en = 0.f;
    for (int ti = 0; ti < n_ti; ++ti) en += energy_part[(long long)ti * L + j0 + tid];
    energy[j0 + tid] = en;
    resid2[j0 + tid] = fmaxf(en - red[tid], 0.f);
  }
}

// sc_a, resid2 and energy of one panel; `partial` holds the product's pieces,
// `scratch` score_scratch(s_c, L, c) floats.
template <typename TS, typename TA>
void launch_panel_score(const TS* sc, long long lds, const TA* a, long long lda, const float* q,
                        long long ldq, int c, float* partial, int nblocks, float* scratch,
                        float* sc_a, float* resid2, float* energy, int s_c, int m, int L,
                        cudaStream_t st) {
  const SplitPlan plan = make_plan(s_c, L, m, PANEL_BN, nblocks);
  launch_splitk<TS, TA, PANEL_BN, false, float>(sc, lds, a, lda, s_c, L, m, plan, partial,
                                                (float*)nullptr, 0, 0, 0, st);
  const int n_ti = (s_c + BM - 1) / BM;
  float* proj_part = scratch;
  float* energy_part = scratch + (size_t)n_ti * c * L;
  const dim3 grid((L + JT - 1) / JT, n_ti);
  score_tiles_kernel<<<grid, THREADS, 0, st>>>(partial, plan, q, ldq, c, aligned16(q, ldq), sc_a,
                                               L, proj_part, energy_part, s_c, L);
  score_finish_kernel<<<(L + JT - 1) / JT, THREADS, 0, st>>>(proj_part, energy_part, n_ti, c,
                                                             resid2, energy, L);
}

}  // namespace sm90
}  // namespace rt
