// CountSketch S A on Hopper (sm_90a).
//
// Replaces: src/repro/kernels/countsketch.py::countsketch_kernel (Pallas TPU,
// a signed one-hot slab multiplied on the MXU). Here it backs
// CountSketch.apply / apply_t / fold_t and OSNAP.apply on CUDA tensors.
//
//   out[b, j] = sum_{i : hashes[i] = b} signs[i] * A[i, j]      (fp32)
//
// Bound on this card: bytes. Each entry of A is read once and touched by one
// add; per 256-column panel at m = 32768, s = 1920 that is 33.5 MB in and
// 2 MB out, about 11 us at 3.35 TB/s. A one-hot product would spend s times
// the operations for nothing, so the kernel gathers instead.
//
// Summation contract, the same in every kernel here: each (bucket, column)
// sum adds its bucket's rows in ascending row order, the product and the add
// rounded separately (no contraction into an FMA), no atomics. So the sum of
// a column depends on that column alone, sketching a whole chunk or one
// panel at a time gives the same bits, and a transposed view gives the bits
// of its contiguous copy. The orders come from kernels/countsketch.py, built
// once per sketch (or per window grid of a streamed sketch) in plain torch.
//
// Three kernels:
//   gather_kernel - one thread per (bucket, column) output walks its
//     bucket's rows (`perm` grouped by bucket, offsets `start`). A warp spans
//     32 neighbouring outputs along whichever output dimension is contiguous:
//     32 columns of one bucket for S A on a row-major A (each row read is one
//     coalesced segment), or 32 buckets of one column for the transposed
//     output of apply_t.
//   the fold (gather_kernel with ACC) - the streaming engine's per-panel
//     M[:, b] += (X S_w^T)[:, b] straight into the row-major M, rounded as
//     `M.add_(fold.to(dtype))` rounds; buckets the window leaves empty are
//     skipped, so only the touched columns of M are read and written.
//   the batch axis (blockIdx.z) - gather, fold and view kernels take an
//     item count and per-item strides for the operand, the output (or M),
//     the signs and the bucket orders, so one launch applies a whole stack
//     of sketches: the KV compressor's head batch (one OSNAP per attention
//     head, N up to 16 layers x 8 requests x 8 kv-heads). The gather and
//     fold kernels also walk `parts` CountSketches per item and add their
//     sums in order (an OSNAP of p parts: ((S_1 a + S_2 a) + S_3 a) + ...,
//     the bits of the per-head sum of parts); the view kernel writes each
//     part's slab and the wrapper adds them. Bound: bytes, as above - each
//     head's panel (64 x 32 fp32 at the compressor's shapes) is read once
//     per part and its (s x 32) output written once.
//   view_kernel - S A for a column-major A (the transposed view A^T that
//     row selection sketches), read along A's contiguous dimension. A block
//     owns 32 output columns (a band of A^T's columns, contiguous in memory)
//     and a group of at most VIEW_GROUP buckets, and streams the band in
//     chunks of VIEW_CHUNK rows through shared memory, coalesced along the
//     rows, the next chunk in flight while one is summed. The chunk-major
//     order (`perm` grouped by chunk, then bucket; a (chunks x (s+1)) table of
//     bucket offsets per chunk) lists each chunk's rows bucket by bucket, so
//     a warp walks its buckets' rows of the chunk in ascending order into
//     per-(bucket, column) sums kept in shared memory.

#include "sgemm_sm90.cuh"

namespace {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }

// o += v as M.add_(v.to(fold dtype).to(M's dtype)) does: a bf16 fold dtype
// rounds v to bf16 first; a bf16 M rounds v, then the sum.
__device__ __forceinline__ void fold_into(float* o, float v, int round_bf16) {
  if (round_bf16) v = __bfloat162float(__float2bfloat16_rn(v));
  *o = __fadd_rn(*o, v);
}
__device__ __forceinline__ void fold_into(bf16* o, float v, int) {
  const bf16 r = __float2bfloat16_rn(v);
  *o = __float2bfloat16_rn(__fadd_rn(__bfloat162float(*o), __bfloat162float(r)));
}

// Where the sketches of a launch are: item n's part q is sketch k = n parts + q,
// its order at perm + k perm_ks and start + k start_ks, its signs (and, for
// the view kernel, hashes) at + k signs_ks. One sketch: all strides 0.
struct Stack {
  int parts;
  long long a_is, o_is, perm_ks, start_ks, signs_ks;
};
constexpr Stack ONE = {1, 0, 0, 0, 0, 0};

// STACK = false is the single-sketch kernel as it was before the stack
// existed (its loop compiles alone: a parts loop around it cost the main
// path's per-panel launches a third more time on the card).
template <typename T, typename TO, bool BUCKET_FAST, bool ACC, bool STACK>
__global__ void __launch_bounds__(256) gather_kernel(
    const int* __restrict__ perm, const int* __restrict__ start,
    const float* __restrict__ signs, const T* __restrict__ a, long long a_rs,
    long long a_cs, TO* __restrict__ out, long long o_rs, long long o_cs,
    int s, int ncols, int round_bf16, Stack st) {
  const int fast = blockIdx.x * 32 + threadIdx.x;
  const int slow = blockIdx.y * 8 + threadIdx.y;
  const int j = BUCKET_FAST ? slow : fast;
  const int b = BUCKET_FAST ? fast : slow;
  if (j >= ncols || b >= s) return;
  float total = 0.f;
  if constexpr (!STACK) {
    const int p0 = start[b], end = start[b + 1];
    if (ACC && p0 == end) return;  // an empty bucket adds nothing to M
    for (int p = p0; p < end; ++p) {
      const int r = perm[p];
      const float v = __fmul_rn(signs[r], to_f(a[(long long)r * a_rs + (long long)j * a_cs]));
      total = __fadd_rn(total, v);
    }
  } else {
    const long long item = blockIdx.z;
    const T* col = a + item * st.a_is + (long long)j * a_cs;
    bool touched = false;
    for (int q = 0; q < st.parts; ++q) {
      const long long k = item * st.parts + q;
      const int* pk = perm + k * st.perm_ks;
      const int* sk = start + k * st.start_ks;
      const float* gk = signs + k * st.signs_ks;
      const int p0 = sk[b], end = sk[b + 1];
      touched |= p0 != end;
      float acc = 0.f;
      for (int p = p0; p < end; ++p) {
        const int r = pk[p];
        acc = __fadd_rn(acc, __fmul_rn(gk[r], to_f(col[(long long)r * a_rs])));
      }
      total = q == 0 ? acc : __fadd_rn(total, acc);  // the parts in order
    }
    if (ACC && !touched) return;  // an empty bucket adds nothing to M
    out += item * st.o_is;
  }
  TO* o = out + (long long)b * o_rs + (long long)j * o_cs;
  if constexpr (ACC)
    fold_into(o, total, round_bf16);
  else
    *o = total;
}

template <typename T, typename TO, bool ACC, bool STACK = false>
int launch_gather(const void* perm, const void* start, const void* signs, const void* a,
                  long long a_rs, long long a_cs, void* out, long long o_rs, long long o_cs,
                  int s, int ncols, int round_bf16, int items, Stack stk, cudaStream_t st) {
  const bool bucket_fast = (o_rs == 1);  // output contiguous along buckets
  const int n_fast = bucket_fast ? s : ncols;
  const int n_slow = bucket_fast ? ncols : s;
  dim3 block(32, 8);
  dim3 grid((n_fast + 31) / 32, (n_slow + 7) / 8, items);
  auto kern = bucket_fast ? gather_kernel<T, TO, true, ACC, STACK>
                          : gather_kernel<T, TO, false, ACC, STACK>;
  kern<<<grid, block, 0, st>>>((const int*)perm, (const int*)start, (const float*)signs,
                               (const T*)a, a_rs, a_cs, (TO*)out, o_rs, o_cs, s, ncols,
                               round_bf16, stk);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// view_kernel
// ---------------------------------------------------------------------------

constexpr int VIEW_CHUNK = 256;    // rows per chunk: VIEW_CHUNK in ../countsketch.py
constexpr int VIEW_THREADS = 256;  // one chunk row per thread for the entry lists
constexpr int VIEW_BJ = 32;        // output columns per block, one per lane
constexpr int VIEW_GROUP = 512;    // most buckets a block sums
constexpr int TP = VIEW_BJ + 1;    // pitch of the tile and of the sums: no bank conflicts
static_assert(VIEW_THREADS == VIEW_CHUNK, "one entry of a chunk per thread");

// The rows [r0, r0 + VIEW_CHUNK) x columns [j0, j0 + VIEW_BJ) of a
// column-major A (element (i, j) at j lda + i), fetched into registers as
// 16-byte loads (E elements) and stored, widened to fp32, into the tile
// [VIEW_CHUNK][TP]. A warp's load covers 32 rows of 32 / LPC columns, each
// column a whole 128-byte (fp32) or 64-byte (bf16) segment; the stores of a
// warp then fall on 32 distinct banks.
template <typename T>
struct ViewTile {
  static constexpr int E = 16 / (int)sizeof(T);
  static constexpr int LPC = 32 / E;  // lanes per column of a warp's load
  static constexpr int CPW = 32 / LPC;  // columns per warp load
  static constexpr int CG = VIEW_BJ / CPW;  // column groups of the tile
  static constexpr int N = (VIEW_CHUNK / 32) * CG / (VIEW_THREADS / 32);  // loads per thread
  uint4 raw[N];

  __device__ __forceinline__ void coords(int n, int& ii, int& jj) const {
    const int ws = threadIdx.x / 32 + (VIEW_THREADS / 32) * n, lane = threadIdx.x % 32;
    ii = (ws / CG) * 32 + (lane % LPC) * E;
    jj = (ws % CG) * CPW + lane / LPC;
  }
  template <bool VEC>
  __device__ __forceinline__ void fetch(const T* __restrict__ a, long long lda, int m, int ncols,
                                        int r0, int j0) {
#pragma unroll
    for (int n = 0; n < N; ++n) {
      int ii, jj;
      coords(n, ii, jj);
      const int gi = r0 + ii, gj = j0 + jj;
      const int cnt = gj < ncols ? max(0, min(E, m - gi)) : 0;
      raw[n] = rt::sm90::load_bits(a + (long long)gj * lda + gi, cnt, VEC && cnt == E);
    }
  }
  __device__ __forceinline__ void stash(float* tile) const {
#pragma unroll
    for (int n = 0; n < N; ++n) {
      int ii, jj;
      coords(n, ii, jj);
      float v[E];
      rt::sm90::unpack<T>(raw[n], v);
#pragma unroll
      for (int e = 0; e < E; ++e) tile[(ii + e) * TP + jj] = v[e];
    }
  }
};

// Shared memory of a block that sums `group` buckets.
inline size_t view_smem(int group) {
  return (size_t)(VIEW_CHUNK * TP + group * TP) * sizeof(float) + 3 * VIEW_CHUNK * sizeof(int);
}

// out[b, j] for buckets b of group blockIdx.x and columns j of band
// blockIdx.y. `perm` lists each chunk's rows (chunk-relative) bucket by
// bucket, ascending within a bucket; tab[c][b] is the offset of bucket b's
// first row in chunk c's list (tab[c][s] the chunk's length).
template <typename T, bool VEC, bool STACK>
__global__ void __launch_bounds__(VIEW_THREADS) view_kernel(
    const int* __restrict__ perm, const int* __restrict__ tab, const int* __restrict__ hashes,
    const float* __restrict__ signs, const T* __restrict__ a, long long lda, int m, int ncols,
    float* __restrict__ out, long long o_rs, long long o_cs, int s, int group, Stack st) {
  if constexpr (STACK) {  // sketch k reads item k / parts of a, writes its own slab of out
    const long long k = blockIdx.z;
    perm += k * st.perm_ks;
    tab += k * st.start_ks;
    hashes += k * st.signs_ks;
    signs += k * st.signs_ks;
    a += (k / st.parts) * st.a_is;
    out += k * st.o_is;
  }
  extern __shared__ __align__(16) float vbuf[];
  float* tile = vbuf;                   // [VIEW_CHUNK][TP]
  float* sums = tile + VIEW_CHUNK * TP;  // [group][TP]
  int* loc = reinterpret_cast<int*>(sums + group * TP);  // the chunk's rows, bucket by bucket
  int* hrow = loc + VIEW_CHUNK;                          // bucket of each chunk row
  float* srow = reinterpret_cast<float*>(hrow + VIEW_CHUNK);  // sign of each chunk row
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int b0 = blockIdx.x * group, b1 = min(s, b0 + group);
  const int j0 = blockIdx.y * VIEW_BJ;
  // this warp's buckets [wb0, wb1): their rows are one run of the chunk's list
  const int per_warp = (b1 - b0 + VIEW_THREADS / 32 - 1) / (VIEW_THREADS / 32);
  const int wb0 = min(b1, b0 + warp * per_warp), wb1 = min(b1, wb0 + per_warp);
  for (int e = tid; e < (b1 - b0) * TP; e += VIEW_THREADS) sums[e] = 0.f;
  const int nchunks = (m + VIEW_CHUNK - 1) / VIEW_CHUNK;

  ViewTile<T> ld;
  int p_nx = 0, h_nx = 0, e0_nx, e1_nx;
  float s_nx = 0.f;
  auto fetch = [&](int c) {  // chunk c into registers
    const int r0 = c * VIEW_CHUNK;
    ld.template fetch<VEC>(a, lda, m, ncols, r0, j0);
    if (r0 + tid < m) {
      p_nx = perm[r0 + tid];
      h_nx = hashes[r0 + tid];
      s_nx = signs[r0 + tid];
    }
    e0_nx = tab[(long long)c * (s + 1) + wb0];
    e1_nx = tab[(long long)c * (s + 1) + wb1];
  };
  fetch(0);
  for (int c = 0; c < nchunks; ++c) {
    __syncthreads();  // every warp is done with the previous chunk
    ld.stash(tile);
    loc[tid] = p_nx;
    hrow[tid] = h_nx;
    srow[tid] = s_nx;
    const int e0 = e0_nx, e1 = e1_nx;
    __syncthreads();
    if (c + 1 < nchunks) fetch(c + 1);  // in flight while this chunk is summed
    int cur = -1;
    float acc = 0.f;
    for (int e = e0; e < e1; ++e) {
      const int r = loc[e];
      const int b = hrow[r];
      if (b != cur) {
        if (cur >= 0) sums[(cur - b0) * TP + lane] = acc;
        cur = b;
        acc = sums[(b - b0) * TP + lane];
      }
      acc = __fadd_rn(acc, __fmul_rn(srow[r], tile[r * TP + lane]));
    }
    if (cur >= 0) sums[(cur - b0) * TP + lane] = acc;
  }
  __syncthreads();
  // store: neighbouring threads on neighbouring addresses of `out`
  const int nb = b1 - b0;
  const bool bucket_fast = (o_rs == 1);
  for (int e = tid; e < nb * VIEW_BJ; e += VIEW_THREADS) {
    const int bi = bucket_fast ? e % nb : e / VIEW_BJ;
    const int jj = bucket_fast ? e / nb : e % VIEW_BJ;
    if (j0 + jj < ncols)
      out[(long long)(b0 + bi) * o_rs + (long long)(j0 + jj) * o_cs] = sums[bi * TP + jj];
  }
}

template <typename T, bool STACK = false>
int launch_view(const void* perm, const void* tab, const void* hashes, const void* signs,
                const void* a, long long lda, int m, int ncols, void* out, long long o_rs,
                long long o_cs, int s, int sketches, Stack stk, cudaStream_t st) {
  const int groups = (s + VIEW_GROUP - 1) / VIEW_GROUP;
  const int group = (s + groups - 1) / groups;
  const int smem = (int)view_smem(group);
  // 16-byte loads need every item's columns aligned, not only the first's
  const bool vec = rt::sm90::aligned16((const T*)a, lda) &&
                   (sketches <= stk.parts || rt::sm90::aligned16((const T*)a, stk.a_is));
  auto kern = vec ? view_kernel<T, true, STACK> : view_kernel<T, false, STACK>;
  cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  dim3 grid(groups, (ncols + VIEW_BJ - 1) / VIEW_BJ, sketches);
  kern<<<grid, VIEW_THREADS, smem, st>>>((const int*)perm, (const int*)tab, (const int*)hashes,
                                         (const float*)signs, (const T*)a, lda, m, ncols,
                                         (float*)out, o_rs, o_cs, s, group, stk);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype codes: 0 float32, 1 bfloat16. Each function returns a cudaError_t.

// out = S a, a with any strides (the gather kernel).
extern "C" int countsketch_launch(int dtype, const void* perm, const void* start,
                                  const void* signs, const void* a, long long a_rs,
                                  long long a_cs, void* out, long long o_rs,
                                  long long o_cs, int s, int ncols, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    return launch_gather<float, float, false>(perm, start, signs, a, a_rs, a_cs, out, o_rs, o_cs,
                                              s, ncols, 0, 1, ONE, st);
  if (dtype == 1)
    return launch_gather<bf16, float, false>(perm, start, signs, a, a_rs, a_cs, out, o_rs, o_cs,
                                             s, ncols, 0, 1, ONE, st);
  return (int)cudaErrorInvalidValue;
}

// M[j, b] += (S a)[b, j] for the row-major M (ldm its row stride): the fold,
// through the bucket-fast mapping; round_bf16: round each sum to bf16 first.
extern "C" int countsketch_fold_launch(int a_dtype, int m_dtype, int round_bf16,
                                       const void* perm, const void* start, const void* signs,
                                       const void* a, long long a_rs, long long a_cs, void* M,
                                       long long ldm, int s, int ncols, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
#define RT_FOLD(T, TO)                                                                        \
  return launch_gather<T, TO, true>(perm, start, signs, a, a_rs, a_cs, M, 1, ldm, s, ncols, \
                                    round_bf16, 1, ONE, st)
  if (a_dtype == 0 && m_dtype == 0) RT_FOLD(float, float);
  if (a_dtype == 0 && m_dtype == 1) RT_FOLD(float, bf16);
  if (a_dtype == 1 && m_dtype == 0) RT_FOLD(bf16, float);
  if (a_dtype == 1 && m_dtype == 1) RT_FOLD(bf16, bf16);
#undef RT_FOLD
  return (int)cudaErrorInvalidValue;
}

// out = S a for a column-major a (element (i, j) at j lda + i, m rows) with
// its chunk-major order; `chunk` must be VIEW_CHUNK.
extern "C" int countsketch_view_launch(int dtype, const void* perm, const void* tab,
                                       const void* hashes, const void* signs, const void* a,
                                       long long lda, int m, int ncols, void* out,
                                       long long o_rs, long long o_cs, int s, int chunk,
                                       void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (chunk != VIEW_CHUNK) return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return launch_view<float>(perm, tab, hashes, signs, a, lda, m, ncols, out, o_rs, o_cs, s, 1,
                              ONE, st);
  if (dtype == 1)
    return launch_view<bf16>(perm, tab, hashes, signs, a, lda, m, ncols, out, o_rs, o_cs, s, 1,
                             ONE, st);
  return (int)cudaErrorInvalidValue;
}

// The stacked launches: `items` items of `parts` sketches each (perm_ks,
// start_ks, signs_ks: strides between consecutive sketches). Grids carry the
// items on blockIdx.z, so at most 65535 of them (65535 sketches for the view).

// out[n] = sum over parts q of S_{n,q} a[n] (the gather kernel).
extern "C" int countsketch_batched_launch(int dtype, const void* perm, const void* start,
                                          const void* signs, const void* a, long long a_is,
                                          long long a_rs, long long a_cs, void* out,
                                          long long o_is, long long o_rs, long long o_cs, int s,
                                          int ncols, int items, int parts, long long perm_ks,
                                          long long start_ks, long long signs_ks, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const Stack stk = {parts, a_is, o_is, perm_ks, start_ks, signs_ks};
  if (items < 1 || items > 65535 || parts < 1) return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return launch_gather<float, float, false, true>(perm, start, signs, a, a_rs, a_cs, out, o_rs,
                                                    o_cs, s, ncols, 0, items, stk, st);
  if (dtype == 1)
    return launch_gather<bf16, float, false, true>(perm, start, signs, a, a_rs, a_cs, out, o_rs,
                                                   o_cs, s, ncols, 0, items, stk, st);
  return (int)cudaErrorInvalidValue;
}

// M[n][j, b] += (sum over parts of S_{n,q} a[n])[b, j] for row-major items of M.
extern "C" int countsketch_batched_fold_launch(int a_dtype, int m_dtype, const void* perm,
                                               const void* start, const void* signs,
                                               const void* a, long long a_is, long long a_rs,
                                               long long a_cs, void* M, long long m_is,
                                               long long ldm, int s, int ncols, int items,
                                               int parts, long long perm_ks, long long start_ks,
                                               long long signs_ks, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const Stack stk = {parts, a_is, m_is, perm_ks, start_ks, signs_ks};
  if (items < 1 || items > 65535 || parts < 1) return (int)cudaErrorInvalidValue;
#define RT_BFOLD(T, TO)                                                                       \
  return launch_gather<T, TO, true, true>(perm, start, signs, a, a_rs, a_cs, M, 1, ldm, s, ncols, \
                                          0, items, stk, st)
  if (a_dtype == 0 && m_dtype == 0) RT_BFOLD(float, float);
  if (a_dtype == 0 && m_dtype == 1) RT_BFOLD(float, bf16);
  if (a_dtype == 1 && m_dtype == 0) RT_BFOLD(bf16, float);
  if (a_dtype == 1 && m_dtype == 1) RT_BFOLD(bf16, bf16);
#undef RT_BFOLD
  return (int)cudaErrorInvalidValue;
}

// out[k] = S_k a[k / parts] for every sketch k < sketches of a stack of
// column-major items (element (i, j) of item n at n a_is + j lda + i).
extern "C" int countsketch_batched_view_launch(int dtype, const void* perm, const void* tab,
                                               const void* hashes, const void* signs,
                                               const void* a, long long a_is, long long lda,
                                               int m, int ncols, void* out, long long o_ks,
                                               long long o_rs, long long o_cs, int s, int chunk,
                                               int sketches, int parts, long long perm_ks,
                                               long long tab_ks, long long hs_ks,
                                               void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const Stack stk = {parts, a_is, o_ks, perm_ks, tab_ks, hs_ks};
  if (chunk != VIEW_CHUNK || sketches < 1 || sketches > 65535 || parts < 1)
    return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return launch_view<float, true>(perm, tab, hashes, signs, a, lda, m, ncols, out, o_rs, o_cs,
                                    s, sketches, stk, st);
  if (dtype == 1)
    return launch_view<bf16, true>(perm, tab, hashes, signs, a, lda, m, ncols, out, o_rs, o_cs,
                                   s, sketches, stk, st);
  return (int)cudaErrorInvalidValue;
}
