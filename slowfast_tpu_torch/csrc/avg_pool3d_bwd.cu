// Average-pool backward for Hopper (sm_90a): a deterministic gather on
// channels-last (N, T, H, W, C) gradients, for pools without padding (the
// port pads with explicit zeros first, models/common.py avg_pool3d, so the
// window counts them as flax's avg_pool does).
//
// Replaces ATen's avg_pool3d_backward on the card, whose CUDA version adds
// with atomics, so that torch's deterministic mode refuses it; the JAX
// package's counterpart, slowfast_tpu/models/common.py:153 avg_pool3d
// (flax's nn.avg_pool), has a plain XLA VJP and no Pallas kernel. It exists
// so that a train step of every CNN head (ResNetBasicHead, X3DHead) and of
// MViT's MODE avg pools runs under torch.use_deterministic_algorithms(True)
// and gives the same bits twice.
//
// Each input-gradient element sums grad_out / (kT * kH * kW) over the
// windows that cover it, visited t, h, w ascending (along each axis one run
// of windows, pool_common.cuh covering), each term divided and then added
// in fp32 (float64 for float64): the order and rounding of ATen's CPU
// backward and of ops/avg_pool.py avg_pool3d_bwd_plain, so all three give
// the same bits. No atomics. One thread per input position and vector of channels: 4
// fp32 or 2 float64 in one 16-byte load of grad_out a window and one
// 16-byte store, when the channels are contiguous and aligned; one channel
// a thread otherwise. A block per (n, t, h) row and 256 of its (w, channel
// vector) pairs; grad_out is read by strides, grad_in written contiguous.
//
// Bound: bytes. grad_out read once and grad_in written once. The heads'
// pools in training cover the whole map with one window, so grad_out is a
// vector per clip and the bytes are grad_in's: at the SlowFast 4x16 head of
// 16 clips, (16, 4, 7, 7, 2048) and (16, 32, 7, 7, 256) in fp32, 51.4 MB,
// about 15 us at 3.35 TB/s. Overlapping windows (the test crop's 7 x 7 pool
// on an 8 x 8 map) re-read grad_out from L1 and L2.

#include "pool_common.cuh"

#define AP_THREADS 256
#define AP_POS 4  // input positions a thread

struct AvgParams {
  int n, t, h, w, c;    // input gradient (N, T, H, W, C), contiguous
  int o[3];             // output extents (t, h, w)
  int64_t gs[5];        // strides of grad_out, (N, T, H, W, C) order
  int k[3], s[3];       // kernel, stride
};

template <typename T, int V> struct Vec;
template <> struct Vec<float, 4> { typedef float4 type; };
template <> struct Vec<double, 2> { typedef double2 type; };

template <typename T, int V>
__device__ __forceinline__ void load_vec(const T* p, T (&v)[V]) {
  if constexpr (V == 1) {
    v[0] = *p;
  } else {
    const typename Vec<T, V>::type x = *reinterpret_cast<const typename Vec<T, V>::type*>(p);
    const T* e = reinterpret_cast<const T*>(&x);
#pragma unroll
    for (int i = 0; i < V; ++i) v[i] = e[i];
  }
}

template <typename T, int V>
__device__ __forceinline__ void store_vec(T* p, const T (&v)[V]) {
  if constexpr (V == 1) {
    *p = v[0];
  } else {
    typename Vec<T, V>::type x;
    T* e = reinterpret_cast<T*>(&x);
#pragma unroll
    for (int i = 0; i < V; ++i) e[i] = v[i];
    *reinterpret_cast<typename Vec<T, V>::type*>(p) = x;
  }
}

template <typename T, int V>
__global__ void __launch_bounds__(AP_THREADS)
    avg_pool3d_bwd_kernel(const T* __restrict__ grad_out, T* __restrict__ grad_in,
                          const AvgParams p) {
  typedef typename Acc<T>::type acc_t;
  // blockIdx.x: one (n, t, h) row, whose windows along t and h are the same
  // for the whole block; blockIdx.y and the thread: AP_POS neighbouring w
  // positions of it and one channel vector.
  const int groups = p.c / V;
  const int job = blockIdx.y * AP_THREADS + threadIdx.x;
  if (job >= (p.w + AP_POS - 1) / AP_POS * groups) return;
  const int c = (job % groups) * V;
  const int w0 = job / groups * AP_POS;
  int row = blockIdx.x;
  const int h = row % p.h;
  row /= p.h;
  const int t = row % p.t;
  const int n = row / p.t;
  const acc_t div = static_cast<acc_t>(p.k[0] * p.k[1] * p.k[2]);
  int t0, t1, h0, h1, lo[AP_POS], hi[AP_POS];
  covering(t, p.o[0], p.k[0], p.s[0], 0, t0, t1);
  covering(h, p.o[1], p.k[1], p.s[1], 0, h0, h1);
#pragma unroll
  for (int j = 0; j < AP_POS; ++j) {
    covering(w0 + j, p.o[2], p.k[2], p.s[2], 0, lo[j], hi[j]);
    if (w0 + j >= p.w) hi[j] = lo[j] - 1;
  }
  acc_t acc[AP_POS][V];
#pragma unroll
  for (int j = 0; j < AP_POS; ++j)
#pragma unroll
    for (int v = 0; v < V; ++v) acc[j][v] = 0;
  // Each position's windows (ot, oh, ow) in ascending order: ot and oh
  // outside, the position's run of ow inside.
  for (int ot = t0; ot <= t1; ++ot) {
    for (int oh = h0; oh <= h1; ++oh) {
      const T* g = grad_out + n * p.gs[0] + ot * p.gs[1] + oh * p.gs[2] + c * p.gs[4];
#pragma unroll
      for (int j = 0; j < AP_POS; ++j) {
        for (int ow = lo[j]; ow <= hi[j]; ++ow) {
          T x[V];
          load_vec<T, V>(g + ow * p.gs[3], x);
#pragma unroll
          for (int v = 0; v < V; ++v) acc[j][v] += to_acc(x[v]) / div;
        }
      }
    }
  }
  T* dst = grad_in + (static_cast<int64_t>(blockIdx.x) * p.w + w0) * p.c + c;
#pragma unroll
  for (int j = 0; j < AP_POS; ++j) {
    if (w0 + j >= p.w) break;
    T out[V];
#pragma unroll
    for (int v = 0; v < V; ++v) out[v] = from_acc(acc[j][v], static_cast<T*>(nullptr));
    store_vec<T, V>(dst + j * p.c, out);
  }
}

template <typename T, int V>
static void launch(const void* grad_out, void* grad_in, const AvgParams& p, cudaStream_t s) {
  const long long rows = static_cast<long long>(p.n) * p.t * p.h;
  const long long jobs = static_cast<long long>(p.w + AP_POS - 1) / AP_POS * (p.c / V);
  const dim3 grid(static_cast<unsigned>(rows),
                  static_cast<unsigned>((jobs + AP_THREADS - 1) / AP_THREADS));
  avg_pool3d_bwd_kernel<T, V><<<grid, AP_THREADS, 0, s>>>(static_cast<const T*>(grad_out),
                                                         static_cast<T*>(grad_in), p);
}

// Backward on `stream`: grad_out (N, To, Ho, Wo, C) at the given element
// strides, grad_in (N, T, H, W, C) contiguous, written whole; no padding
// (To = (T - kT) / sT + 1, and so on). dtype: 0 fp32, 1 float64. kernel,
// stride: 3 ints each, (t, h, w). Returns the CUDA error of the launch (0
// on success).
extern "C" int sf_avg_pool3d_bwd(const void* grad_out, void* grad_in, long long n, long long t,
                                 long long h, long long w, long long c, long long ot,
                                 long long oh, long long ow, const long long* gstrides,
                                 const int* kernel, const int* stride, int dtype,
                                 void* stream) {
  if (n * t * h > 0x7fffffffLL || w * c > 0x7fffffffLL || ot * oh * ow > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long in[3] = {t, h, w}, out[3] = {ot, oh, ow};
  AvgParams p;
  p.n = static_cast<int>(n); p.t = static_cast<int>(t); p.h = static_cast<int>(h);
  p.w = static_cast<int>(w); p.c = static_cast<int>(c);
  for (int a = 0; a < 5; ++a) p.gs[a] = gstrides[a];
  for (int a = 0; a < 3; ++a) {
    if (kernel[a] <= 0 || stride[a] <= 0 || in[a] < kernel[a] ||
        out[a] != (in[a] - kernel[a]) / stride[a] + 1)
      return static_cast<int>(cudaErrorInvalidValue);
    p.o[a] = static_cast<int>(out[a]);
    p.k[a] = kernel[a]; p.s[a] = stride[a];
  }
  if (n * t * h <= 0 || w * c <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    const bool vec = vector_ok(grad_out, gstrides, 5, c, 4, 16) &&
                     reinterpret_cast<uintptr_t>(grad_in) % 16 == 0;
    if ((w + AP_POS - 1) / AP_POS * (vec ? c / 4 : c) > 65535LL * AP_THREADS)
      return static_cast<int>(cudaErrorInvalidValue);
    if (vec) launch<float, 4>(grad_out, grad_in, p, s);
    else launch<float, 1>(grad_out, grad_in, p, s);
  } else if (dtype == 1) {
    const bool vec = vector_ok(grad_out, gstrides, 5, c, 8, 16) &&
                     reinterpret_cast<uintptr_t>(grad_in) % 16 == 0;
    if ((w + AP_POS - 1) / AP_POS * (vec ? c / 2 : c) > 65535LL * AP_THREADS)
      return static_cast<int>(cudaErrorInvalidValue);
    if (vec) launch<double, 2>(grad_out, grad_in, p, s);
    else launch<double, 1>(grad_out, grad_in, p, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
