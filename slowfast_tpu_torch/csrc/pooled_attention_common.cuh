// Helpers shared by the pooled-attention kernels (pooled_attention.cu,
// pooled_attention_bwd.cu, pooled_attention_fused_bwd.cu): loads, stores and
// the rounding to the input type, tile copies into shared memory, the
// 4x4-per-thread tile product, the reductions over the 16 threads of a row
// and the backwards' do_n. Every kernel that includes it runs 16 x 16
// threads: tx = threadIdx.x & 15, ty = threadIdx.x >> 4.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

__device__ __forceinline__ float load_f(const float* p) { return *p; }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

// Round an fp32 value to the input type and back (identity for fp32).
__device__ __forceinline__ float round_as(float v, const float*) { return v; }
__device__ __forceinline__ float round_as(float v, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ void store_f(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// Copy rows [r0, r0 + rows) of a (N, nh, d) head slice into shared memory
// as fp32 with row stride `ld`, zero-filling rows >= n and columns >= d, with
// kThreads threads. (The block size is a template constant: striding by
// blockDim.x measured 30-40% slower on an H100.)
template <int kThreads, typename T>
__device__ __forceinline__ void load_tile(float* dst, const T* __restrict__ src,
                                          int r0, int rows, int n, int nh,
                                          int d, int ld) {
  for (int idx = threadIdx.x; idx < rows * ld; idx += kThreads) {
    const int r = idx / ld;
    const int c = idx - r * ld;
    float v = 0.f;
    if (r0 + r < n && c < d)
      v = load_f(src + (static_cast<int64_t>(r0 + r) * nh) * d + c);
    dst[idx] = v;
  }
}

// Replace the kRows x ld do tile by do_n = round(do / s) in shared memory,
// s_s holding s per row (the constant-shift backwards), with kThreads threads.
template <int kRows, int kThreads, typename T>
__device__ __forceinline__ void normalize_do(float* do_s, int ld, const float* s_s,
                                             const T* tag) {
  for (int idx = threadIdx.x; idx < kRows * ld; idx += kThreads)
    do_s[idx] = round_as(do_s[idx] / s_s[idx / ld], tag);
}

// out[i][j] = sum_c a[row i][c] * b[row j][c] for the thread's 4x4 tile:
// a rows ty + 16 i, b rows tx + 16 j (odd strides: no bank conflicts).
__device__ __forceinline__ void dot_tile(const float* a, int lda, const float* b,
                                         int ldb, int depth, int ty, int tx,
                                         float (&out)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) out[i][j] = 0.f;
  for (int c = 0; c < depth; ++c) {
    float x[4], y[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) x[i] = a[(ty + 16 * i) * lda + c];
#pragma unroll
    for (int j = 0; j < 4; ++j) y[j] = b[(tx + 16 * j) * ldb + c];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) out[i][j] = fmaf(x[i], y[j], out[i][j]);
  }
}

// Reduce over the 16 threads (tx) that share a row: lanes 0-15 and 16-31 of
// a warp are two rows.
__device__ __forceinline__ float row_sum16(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ float row_max16(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}
