// CountSketch S A on Hopper (sm_90a).
//
// Replaces: src/repro/kernels/countsketch.py::countsketch_kernel (Pallas TPU,
// a signed one-hot slab multiplied on the MXU). Here it backs
// CountSketch.apply / apply_t and OSNAP.apply on CUDA tensors.
//
//   out[b, j] = sum_{i : hashes[i] = b} signs[i] * A[i, j]      (fp32)
//
// Bound on this card: bytes. Each entry of A is read once and touched by one
// add; per 256-column panel at m = 32768, s = 1920 that is 33.5 MB in and
// 2 MB out, about 11 us at 3.35 TB/s. A one-hot product would spend s times
// the operations for nothing, so the kernel gathers instead.
//
// Design: the rows of each bucket are listed in ascending row order by a
// stable sort done once per sketch (or window) in plain torch (`perm`,
// bucket offsets `start`). One thread owns one (bucket, column) output and
// walks its bucket's rows in that order: no atomics, and the sum of a column
// depends on that column alone, so sketching a whole chunk or one panel at a
// time gives the same bits. Strides are arguments, so A^T (apply_t) needs no
// copy. A warp spans 32 neighbouring outputs along whichever output
// dimension is contiguous: 32 columns of one bucket for S A (each row read is
// one coalesced segment), or 32 buckets of one column for the transposed
// output of apply_t (the per-panel M fold, whose window of 256 source rows
// leaves most of the 1920 buckets empty, so its cost is writing the output).
// The product and the add are rounded separately (no contraction into an
// FMA), matching a row-ordered segment sum bit for bit.

#include "common.cuh"

template <typename T, bool BUCKET_FAST>
__global__ void __launch_bounds__(256) countsketch_kernel(
    const int* __restrict__ perm, const int* __restrict__ start,
    const float* __restrict__ signs, const T* __restrict__ a, long long a_rs,
    long long a_cs, float* __restrict__ out, long long o_rs, long long o_cs,
    int s, int ncols) {
  const int fast = blockIdx.x * 32 + threadIdx.x;
  const int slow = blockIdx.y * 8 + threadIdx.y;
  const int j = BUCKET_FAST ? slow : fast;
  const int b = BUCKET_FAST ? fast : slow;
  if (j >= ncols || b >= s) return;
  float acc = 0.f;
  const int end = start[b + 1];
  for (int p = start[b]; p < end; ++p) {
    const int r = perm[p];
    const float v = __fmul_rn(signs[r], rt::to_f(a[(long long)r * a_rs + (long long)j * a_cs]));
    acc = __fadd_rn(acc, v);
  }
  out[(long long)b * o_rs + (long long)j * o_cs] = acc;
}

template <typename T, bool BUCKET_FAST>
void launch_t(const void* perm, const void* start, const void* signs, const void* a,
              long long a_rs, long long a_cs, void* out, long long o_rs, long long o_cs,
              int s, int ncols, cudaStream_t st) {
  const int n_fast = BUCKET_FAST ? s : ncols;
  const int n_slow = BUCKET_FAST ? ncols : s;
  dim3 block(32, 8);
  dim3 grid((n_fast + 31) / 32, (n_slow + 7) / 8);
  countsketch_kernel<T, BUCKET_FAST><<<grid, block, 0, st>>>(
      (const int*)perm, (const int*)start, (const float*)signs, (const T*)a, a_rs, a_cs,
      (float*)out, o_rs, o_cs, s, ncols);
}

extern "C" int countsketch_launch(int dtype, const void* perm, const void* start,
                                  const void* signs, const void* a, long long a_rs,
                                  long long a_cs, void* out, long long o_rs,
                                  long long o_cs, int s, int ncols, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const bool bucket_fast = (o_rs == 1);  // output contiguous along buckets
  if (dtype == 0) {
    (bucket_fast ? launch_t<float, true> : launch_t<float, false>)(
        perm, start, signs, a, a_rs, a_cs, out, o_rs, o_cs, s, ncols, st);
  } else {
    (bucket_fast ? launch_t<__nv_bfloat16, true> : launch_t<__nv_bfloat16, false>)(
        perm, start, signs, a, a_rs, a_cs, out, o_rs, o_cs, s, ncols, st);
  }
  return (int)cudaGetLastError();
}
