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
// Along each axis the windows that may cover input position i are o =
// floor((i + p) / s) - (D - 1) + j for j = 0 .. D - 1, D = (k - 1) / s + 1
// (pool_common.cuh). Each input element adds grad_out of those windows
// whose saved index (t * H + h) * W + w, ATen's index within the (T, H, W)
// volume, is its own, visiting them t, h, w ascending, the sums in fp32
// (float64 for float64) rounded once: the order and rounding of
// ops/max_pool.py max_pool3d_bwd_plain, so the two give the same bits. No
// atomics.
//
// The design, as the JAX VJP thinks of it (each stride-residue class has a
// static list of candidate taps, so no per-tap window search):
// - A block owns a tile of the input gradient: one (n, t), th rows, tw
//   columns and cb channels (a divisor of C; all C where C is small).
// - It stages the output tile that covers it, grad_out and the indices, in
//   shared memory, so each output element is read from device memory once
//   a block: grad_out by 16-byte cp.async copies, the int64 indices by
//   16-byte loads narrowed to their low 32 bits (the host refuses volumes
//   past int32, so an index is its low word).
// - The halo, windows before 0 or past the last, is staged as a zero
//   gradient under the index -1, which matches no position, so edge and
//   interior positions take the same branch-free path. A candidate window
//   that does not cover the position is left in too: its argmax lies in
//   it, so its index never matches. Every candidate tap is a load, a
//   compare and a select: the loads issue together, before any compare.
// - A thread produces a vector of channels, 8 bf16, 4 fp32 or 2 float64,
//   as one 16-byte store, where C and the strides allow (the models' pools
//   do); otherwise one channel a thread, as for the edge cases' C of 5, 3
//   and 33.
// - The stem and MViT's residual pools, (1,3,3)/(1,2,2), take 1 x 2 x 2
//   candidate taps and the pathway and non-local pools (k = s) 1 x 1 x 1,
//   each a compiled instance with its loops unrolled; any other geometry
//   runs the same code with the loop bounds read at run time.
//
// Bound: bytes. Device memory must see grad_out (2 or 4 bytes) and the
// int64 indices (8 bytes) of each output element once and grad_in written
// once. At the SlowFast 4x16 slow stem pool of 16 clips in bf16 (16 x 4 x
// 112 x 112 x 64 in, 56 x 56 out) that is 102.8 MB of grad_in and 128.5 MB
// of grad_out and indices, about 69 us at 3.35 TB/s. The halo rows and
// columns that neighbouring tiles share are read again, from L2.

#include "pool_common.cuh"

#define MP_THREADS 256
#define MP_SMEM_BYTES (48 * 1024)
// Input positions a thread produces, which sets the tile's size.
#define MP_POS_PER_THREAD 8

struct PoolParams {
  int n, t, h, w, c;           // input gradient (N, T, H, W, C), contiguous
  int o[3];                    // output extents (t, h, w)
  int64_t gs[5], is[5];        // strides of grad_out and indices, (N, T, H, W, C) order
  int k[3], s[3], p[3], d[3];  // kernel, stride, padding, windows per axis
  int th, tw, cb;              // a block's tile: input rows, columns, channels
  int tiles_w, chunks;         // column tiles, channel chunks
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool fill) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(gmem),
               "r"(fill ? 16 : 0));
}

// Offset of channel v of group g at staged position spos in the index tile:
// with 8 channels a group the two halves of a group lie G groups apart, so a
// quarter warp's 16-byte reads touch 128 consecutive bytes.
template <int V>
__device__ __forceinline__ int idx_off(int spos, int cb, int groups, int g, int v) {
  if constexpr (V == 8) return spos * cb + ((v >> 2) * groups + g) * 4 + (v & 3);
  else return spos * cb + g * V + v;
}

// Bytes of a staged gradient tile of `elems` elements, rounded up to 16 so
// that the index tile after it is aligned for 16-byte reads.
template <typename T>
__host__ __device__ __forceinline__ size_t gsm_bytes(long long elems) {
  return (static_cast<size_t>(elems) * sizeof(T) + 15) / 16 * 16;
}

template <typename T, int V, int DT, int DH, int DW>
__global__ void __launch_bounds__(MP_THREADS)
    max_pool3d_bwd_kernel(const T* __restrict__ grad_out, const int64_t* __restrict__ idx,
                          T* __restrict__ grad_in, const PoolParams p) {
  typedef typename Acc<T>::type acc_t;
  extern __shared__ __align__(16) unsigned char smem[];
  const int dt = DT > 0 ? DT : p.d[0];
  const int dh = DH > 0 ? DH : p.d[1];
  const int dw = DW > 0 ? DW : p.d[2];
  const int groups = blockDim.x;  // channel groups of V in the chunk: cb / V
  const int g = threadIdx.x;
  const int tid = threadIdx.y * groups + g;
  const int nthreads = groups * blockDim.y;

  // The block's tile: blockIdx.x = (row tile, column tile, channel chunk),
  // the chunk fastest; blockIdx.y = t; blockIdx.z = n.
  int b = blockIdx.x;
  const int chunk = b % p.chunks;
  b /= p.chunks;
  const int w0 = (b % p.tiles_w) * p.tw;
  const int h0 = (b / p.tiles_w) * p.th;
  const int t = blockIdx.y, n = blockIdx.z;
  const int c0 = chunk * p.cb;
  const int h_end = min(h0 + p.th, p.h), w_end = min(w0 + p.tw, p.w);

  // The staged output tile: windows first_window(t) .. + dt - 1 along t,
  // and along h and w from the first candidate of the tile's first position
  // to the last window that can start at or before its last.
  const int ot0 = first_window(t, p.s[0], p.p[0], dt);
  const int oh0 = first_window(h0, p.s[1], p.p[1], dh);
  const int ow0 = first_window(w0, p.s[2], p.p[2], dw);
  const int lh = (h_end - 1 + p.p[1]) / p.s[1] - oh0 + 1;
  const int lw = (w_end - 1 + p.p[2]) / p.s[2] - ow0 + 1;
  const int staged = dt * lh * lw;
  T* gsm = reinterpret_cast<T*>(smem);
  int* ism = reinterpret_cast<int*>(smem + gsm_bytes<T>(staged * p.cb));

  for (int e = tid; e < staged * groups; e += nthreads) {
    const int gg = e % groups;
    const int spos = e / groups;
    const int ow = ow0 + spos % lw;
    const int oh = oh0 + (spos / lw) % lh;
    const int ot = ot0 + spos / (lw * lh);
    const bool in = ot >= 0 && ot < p.o[0] && oh >= 0 && oh < p.o[1] && ow >= 0 && ow < p.o[2];
    const int c = c0 + gg * V;
    const int64_t go =
        in ? n * p.gs[0] + ot * p.gs[1] + oh * p.gs[2] + ow * p.gs[3] + c * p.gs[4] : 0;
    const int64_t io =
        in ? n * p.is[0] + ot * p.is[1] + oh * p.is[2] + ow * p.is[3] + c * p.is[4] : 0;
    if constexpr (V > 1) {
      cp_async16(gsm + spos * p.cb + gg * V, grad_out + go, in);
      longlong2 x[V / 2];
#pragma unroll
      for (int q = 0; q < V / 2; ++q)
        x[q] = in ? __ldg(reinterpret_cast<const longlong2*>(idx + io) + q)
                  : make_longlong2(-1, -1);
#pragma unroll
      for (int q = 0; q < V / 2; ++q) {
        ism[idx_off<V>(spos, p.cb, groups, gg, 2 * q)] = static_cast<int>(x[q].x);
        ism[idx_off<V>(spos, p.cb, groups, gg, 2 * q + 1)] = static_cast<int>(x[q].y);
      }
    } else {
      gsm[spos * p.cb + gg] = in ? grad_out[go] : static_cast<T>(0.0f);
      ism[spos * p.cb + gg] = in ? static_cast<int>(idx[io]) : -1;
    }
  }
  if constexpr (V > 1) asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();

  const int c = c0 + g * V;
  for (int pos = threadIdx.y; pos < p.th * p.tw; pos += blockDim.y) {
    const int h = h0 + pos / p.tw, w = w0 + pos % p.tw;
    if (h >= h_end || w >= w_end) continue;
    const int me = (t * p.h + h) * p.w + w;
    const int sh = first_window(h, p.s[1], p.p[1], dh) - oh0;
    const int sw = first_window(w, p.s[2], p.p[2], dw) - ow0;
    acc_t acc[V];
#pragma unroll
    for (int v = 0; v < V; ++v) acc[v] = 0;
#pragma unroll
    for (int jt = 0; jt < dt; ++jt) {
#pragma unroll
      for (int jh = 0; jh < dh; ++jh) {
#pragma unroll
        for (int jw = 0; jw < dw; ++jw) {
          const int spos = (jt * lh + sh + jh) * lw + sw + jw;
          uint4 graw;
          const T* gv = reinterpret_cast<const T*>(&graw);
          int iv[V];
          if constexpr (V > 1) {
            graw = *reinterpret_cast<const uint4*>(gsm + spos * p.cb + g * V);
            if constexpr (V == 2) {
              const int2 x =
                  *reinterpret_cast<const int2*>(ism + idx_off<V>(spos, p.cb, groups, g, 0));
              iv[0] = x.x; iv[1] = x.y;
            } else {
#pragma unroll
              for (int q = 0; q < V; q += 4) {
                const int4 x = *reinterpret_cast<const int4*>(
                    ism + idx_off<V>(spos, p.cb, groups, g, q));
                iv[q] = x.x; iv[q + 1] = x.y; iv[q + 2] = x.z; iv[q + 3] = x.w;
              }
            }
          } else {
            reinterpret_cast<T*>(&graw)[0] = gsm[spos * p.cb + g];
            iv[0] = ism[spos * p.cb + g];
          }
#pragma unroll
          for (int v = 0; v < V; ++v) acc[v] += iv[v] == me ? to_acc(gv[v]) : acc_t(0);
        }
      }
    }
    uint4 oraw;
    T* out = reinterpret_cast<T*>(&oraw);
#pragma unroll
    for (int v = 0; v < V; ++v) out[v] = from_acc(acc[v], static_cast<T*>(nullptr));
    T* dst = grad_in + ((static_cast<int64_t>(n) * p.t + t) * p.h + h) * p.w * p.c +
             static_cast<int64_t>(w) * p.c + c;
    if constexpr (V > 1) *reinterpret_cast<uint4*>(dst) = oraw;
    else *dst = out[0];
  }
}

template <typename T, int V>
static int launch(const void* grad_out, const int64_t* idx, void* grad_in, PoolParams p,
                  cudaStream_t stream) {
  // Channels a block: the largest divisor of C that is a multiple of V and
  // at most 8 vectors (64 bf16, 32 fp32, 16 float64; 32 channels one at a
  // time), so a thread's group is one 16-byte vector and a warp spans whole
  // positions.
  const int cmax = V > 1 ? 8 * V : 32;
  int cb = V;
  for (int x = V; x <= cmax && x <= p.c; x += V)
    if (p.c % x == 0) cb = x;
  const int groups = cb / V, rows = MP_THREADS / groups;
  // MP_POS_PER_THREAD positions a thread; rows of at most 16 columns when
  // a position holds several groups, 32 when it holds one or two.
  p.tw = min(p.w, groups >= 4 ? 16 : 32);
  p.th = max(1, min(p.h, rows * MP_POS_PER_THREAD / p.tw));
  auto bytes = [&](int th, int tw) {
    const long long lh = (th - 1) / p.s[1] + 1 + p.d[1], lw = (tw - 1) / p.s[2] + 1 + p.d[2];
    const long long elems = static_cast<long long>(p.d[0]) * lh * lw * cb;
    return static_cast<long long>(gsm_bytes<T>(elems)) + elems * 4;
  };
  while (bytes(p.th, p.tw) > MP_SMEM_BYTES && p.th > 1) p.th = (p.th + 1) / 2;
  while (bytes(p.th, p.tw) > MP_SMEM_BYTES && p.tw > 1) p.tw = (p.tw + 1) / 2;
  if (bytes(p.th, p.tw) > MP_SMEM_BYTES) return static_cast<int>(cudaErrorInvalidValue);
  p.cb = cb;
  p.chunks = p.c / cb;
  p.tiles_w = (p.w + p.tw - 1) / p.tw;
  const long long blocks = static_cast<long long>((p.h + p.th - 1) / p.th) * p.tiles_w * p.chunks;
  if (blocks > 0x7fffffffLL || p.t > 65535 || p.n > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(blocks), p.t, p.n), block(groups, rows);
  const size_t smem = static_cast<size_t>(bytes(p.th, p.tw));
  const T* go = static_cast<const T*>(grad_out);
  T* gi = static_cast<T*>(grad_in);
  if (p.d[0] == 1 && p.d[1] == 2 && p.d[2] == 2)
    max_pool3d_bwd_kernel<T, V, 1, 2, 2><<<grid, block, smem, stream>>>(go, idx, gi, p);
  else if (p.d[0] == 1 && p.d[1] == 1 && p.d[2] == 1)
    max_pool3d_bwd_kernel<T, V, 1, 1, 1><<<grid, block, smem, stream>>>(go, idx, gi, p);
  else
    max_pool3d_bwd_kernel<T, V, 0, 0, 0><<<grid, block, smem, stream>>>(go, idx, gi, p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
static int dispatch(const void* grad_out, const int64_t* idx, void* grad_in, const PoolParams& p,
                    const long long* gstrides, const long long* istrides, cudaStream_t stream) {
  constexpr int V = 16 / sizeof(T);
  if (vector_ok(grad_out, gstrides, 5, p.c, sizeof(T), 16) &&
      vector_ok(idx, istrides, 5, p.c, 8, 16) && reinterpret_cast<uintptr_t>(grad_in) % 16 == 0)
    return launch<T, V>(grad_out, idx, grad_in, p, stream);
  return launch<T, 1>(grad_out, idx, grad_in, p, stream);
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
  if (t * h * w > 0x7fffffffLL || c > 0x7fffffffLL || ot * oh * ow > 0x7fffffffLL)
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
  if (n * t * h * w <= 0 || c <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch<float>(grad_out, idx, grad_in, p, gstrides, istrides, s);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(grad_out, idx, grad_in, p, gstrides, istrides, s);
  if (dtype == 2) return dispatch<double>(grad_out, idx, grad_in, p, gstrides, istrides, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
