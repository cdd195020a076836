// Shared by the pool backwards (max_pool3d_bwd.cu, avg_pool3d_bwd.cu): the
// accumulator types, conversions and the window arithmetic of one axis.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

// Sums are in fp32, float64 for float64; a gradient is rounded once.
template <typename T> struct Acc { typedef float type; };
template <> struct Acc<double> { typedef double type; };

__device__ __forceinline__ float to_acc(float x) { return x; }
__device__ __forceinline__ float to_acc(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ double to_acc(double x) { return x; }
__device__ __forceinline__ float from_acc(float v, float*) { return v; }
__device__ __forceinline__ __nv_bfloat16 from_acc(float v, __nv_bfloat16*) {
  return __float2bfloat16(v);
}
__device__ __forceinline__ double from_acc(double v, double*) { return v; }

// Along one axis of extent O, with kernel k, stride s and padding p,
// window o covers input position i when 0 <= o < O and o * s - p <= i <
// o * s - p + k. The candidates are o = first_window + j for j = 0 .. d - 1,
// d = (k - 1) / s + 1 (those before 0 or past O - 1 cover nothing).
__device__ __forceinline__ int first_window(int i, int s, int p, int d) {
  return (i + p) / s - (d - 1);
}

// The windows that cover i, a run [lo, hi] (empty when lo > hi).
__device__ __forceinline__ void covering(int i, int O, int k, int s, int p, int& lo, int& hi) {
  lo = i + p < k ? 0 : (i + p - k) / s + 1;
  hi = min(O - 1, (i + p) / s);
}

// Whether `ptr` and every stride (in elements) allow `bytes`-wide vector
// accesses at channel offsets that are multiples of bytes / elem_size.
__host__ inline bool vector_ok(const void* ptr, const long long* strides, int nstrides,
                               long long c, int elem_size, int bytes) {
  const long long v = bytes / elem_size;
  if (reinterpret_cast<uintptr_t>(ptr) % bytes != 0 || c % v != 0) return false;
  if (strides[nstrides - 1] != 1) return false;
  for (int a = 0; a < nstrides - 1; ++a)
    if (strides[a] % v != 0) return false;
  return true;
}
