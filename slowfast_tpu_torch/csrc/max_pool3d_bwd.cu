// Max-pool backward for Hopper (sm_90a): a deterministic gather over the
// saved argmax, on channels-last (N, T, H, W, C) gradients.
//
// Replaces slowfast_tpu/ops/video_conv.py:464 _max_pool_2d_argmax_bwd, the
// JAX package's custom VJP of its max pools (and XLA's select-and-scatter
// for the pools it leaves to reduce_window): every window's gradient goes
// to the input position that won the window, added in a fixed order of the
// windows. It takes the place of ATen's max_pool3d_with_indices_backward,
// whose CUDA version scatters with atomic adds, so that two backward passes
// of the same step add in different orders and torch's deterministic mode
// refuses it. Every max pool of the port comes here (models/common.py
// max_pool3d): the ResNet stem's (1,3,3)/(1,2,2) pool, the pathway pools,
// non-local's key/value pool and MViT's residual pools.
//
// One thread per element of the input gradient: a block per (n, t, h) row
// and per 256 of its (w, c) elements, c fastest, so a warp writes 32
// neighbouring channels and reads 32 neighbouring channels of the output
// gradient and indices, and the index arithmetic is 32-bit (offsets into
// the tensors 64-bit). Along each axis the windows that cover input
// position i are o = floor((i + p) / s) - (D - 1) + j for j = 0 ..
// D - 1, D = (k - 1) / s + 1, those with 0 <= o < O and o * s - p + k > i;
// the thread visits them in that order, t outermost, and adds grad_out
// where the saved index (t * H + h) * W + w, ATen's index within the
// (T, H, W) volume, is its own. No atomics: the same inputs give the same
// bits. Sums are in fp32 (float64 for float64), rounded once to the
// gradient's type. grad_out and the indices are read by strides, so the
// channels-last views that the forward hands out need no copy.
//
// Bound: bytes. The thread reads at most D_t * D_h * D_w taps of the
// output gradient and indices, all from L2 after the first touch; device
// memory must see grad_out (2 or 4 bytes), the int64 indices (8 bytes) of
// each output element once and grad_in written once. At the SlowFast 4x16
// slow stem pool of 16 clips in bf16 (16 x 4 x 112 x 112 x 64 in, 56 x 56
// out) that is 102.8 MB of grad_in and 128.5 MB of grad_out and indices,
// about 69 us at 3.35 TB/s.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define MP_THREADS 256

struct PoolParams {
  int n, t, h, w, c;           // input gradient (N, T, H, W, C), contiguous
  int o[3];                    // output extents (t, h, w)
  int64_t gs[5], is[5];        // strides of grad_out and indices, (N, T, H, W, C) order
  int k[3], s[3], p[3], d[3];  // kernel, stride, padding, windows per axis
};

template <typename T> struct Acc { typedef float type; };
template <> struct Acc<double> { typedef double type; };

__device__ __forceinline__ float to_acc(float x) { return x; }
__device__ __forceinline__ float to_acc(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ double to_acc(double x) { return x; }
__device__ __forceinline__ void store(float* out, float v) { *out = v; }
__device__ __forceinline__ void store(__nv_bfloat16* out, float v) { *out = __float2bfloat16(v); }
__device__ __forceinline__ void store(double* out, double v) { *out = v; }

// First window of axis a that may cover position i (the loop adds j).
__device__ __forceinline__ int first_window(int i, const PoolParams& p, int a) {
  return (i + p.p[a]) / p.s[a] - (p.d[a] - 1);
}

__device__ __forceinline__ bool covers(int o, int i, const PoolParams& p, int a) {
  return o >= 0 && o < p.o[a] && o * p.s[a] - p.p[a] + p.k[a] > i;
}

template <typename T>
__global__ void __launch_bounds__(MP_THREADS)
    max_pool3d_bwd_kernel(const T* __restrict__ grad_out, const int64_t* __restrict__ idx,
                          T* __restrict__ grad_in, const PoolParams p) {
  typedef typename Acc<T>::type acc_t;
  // blockIdx.x: one (n, t, h) row of the input gradient; blockIdx.y and the
  // thread: one (w, c) of it. The row's windows along t and h are the same
  // for the whole block.
  const int wc = blockIdx.y * MP_THREADS + threadIdx.x;
  if (wc >= p.w * p.c) return;
  const int c = wc % p.c;
  const int w = wc / p.c;
  int row = blockIdx.x;
  const int h = row % p.h;
  row /= p.h;
  const int t = row % p.t;
  const int n = row / p.t;
  const int64_t pos = (static_cast<int64_t>(t) * p.h + h) * p.w + w;
  const int64_t gbase = n * p.gs[0] + c * p.gs[4];
  const int64_t ibase = n * p.is[0] + c * p.is[4];
  acc_t acc = 0;
  const int t0 = first_window(t, p, 0), h0 = first_window(h, p, 1), w0 = first_window(w, p, 2);
  for (int jt = 0; jt < p.d[0]; ++jt) {
    const int ot = t0 + jt;
    if (!covers(ot, t, p, 0)) continue;
    for (int jh = 0; jh < p.d[1]; ++jh) {
      const int oh = h0 + jh;
      if (!covers(oh, h, p, 1)) continue;
      for (int jw = 0; jw < p.d[2]; ++jw) {
        const int ow = w0 + jw;
        if (!covers(ow, w, p, 2)) continue;
        if (idx[ibase + ot * p.is[1] + oh * p.is[2] + ow * p.is[3]] == pos)
          acc += to_acc(grad_out[gbase + ot * p.gs[1] + oh * p.gs[2] + ow * p.gs[3]]);
      }
    }
  }
  store(grad_in + (static_cast<int64_t>(blockIdx.x) * p.w * p.c + wc), acc);
}

// Backward on `stream`: grad_out (N, To, Ho, Wo, C) and idx (int64, the
// same shape) at the given element strides, grad_in (N, T, H, W, C)
// contiguous, written whole. dtype: 0 fp32, 1 bf16, 2 float64. kernel,
// stride, padding: 3 ints each, (t, h, w). Returns the CUDA error of the
// launch (0 on success).
extern "C" int sf_max_pool3d_bwd(const void* grad_out, const int64_t* idx, void* grad_in,
                                 long long n, long long t, long long h, long long w,
                                 long long c, long long ot, long long oh, long long ow,
                                 const long long* gstrides, const long long* istrides,
                                 const int* kernel, const int* stride, const int* padding,
                                 int dtype, void* stream) {
  if (n * t * h > 0x7fffffffLL || w * c > 0x7fffffffLL || ot * oh * ow > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  PoolParams p;
  p.n = static_cast<int>(n); p.t = static_cast<int>(t); p.h = static_cast<int>(h);
  p.w = static_cast<int>(w); p.c = static_cast<int>(c);
  p.o[0] = static_cast<int>(ot); p.o[1] = static_cast<int>(oh); p.o[2] = static_cast<int>(ow);
  for (int a = 0; a < 5; ++a) {
    p.gs[a] = gstrides[a];
    p.is[a] = istrides[a];
  }
  for (int a = 0; a < 3; ++a) {
    if (kernel[a] <= 0 || stride[a] <= 0 || padding[a] < 0 || 2 * padding[a] > kernel[a])
      return static_cast<int>(cudaErrorInvalidValue);
    p.k[a] = kernel[a]; p.s[a] = stride[a]; p.p[a] = padding[a];
    p.d[a] = (kernel[a] - 1) / stride[a] + 1;
  }
  const long long rows = n * t * h, chunks = (w * c + MP_THREADS - 1) / MP_THREADS;
  if (rows <= 0 || w * c <= 0) return 0;
  if (chunks > 65535) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(static_cast<unsigned>(rows), static_cast<unsigned>(chunks));
  if (dtype == 0)
    max_pool3d_bwd_kernel<float><<<grid, MP_THREADS, 0, s>>>(
        static_cast<const float*>(grad_out), idx, static_cast<float*>(grad_in), p);
  else if (dtype == 1)
    max_pool3d_bwd_kernel<__nv_bfloat16><<<grid, MP_THREADS, 0, s>>>(
        static_cast<const __nv_bfloat16*>(grad_out), idx, static_cast<__nv_bfloat16*>(grad_in),
        p);
  else if (dtype == 2)
    max_pool3d_bwd_kernel<double><<<grid, MP_THREADS, 0, s>>>(
        static_cast<const double*>(grad_out), idx, static_cast<double*>(grad_in), p);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
