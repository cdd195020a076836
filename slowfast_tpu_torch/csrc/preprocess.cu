// uint8 clip preprocessing for Hopper (sm_90a): normalize, optional
// horizontal flip and channel reverse, and the SlowFast pathway split, in one
// pass over the input.
//
// Replaces slowfast_tpu/ops/preprocess.py:_affine_u8_kernel (the Pallas
// kernel launched at preprocess.py:84), fused with the flip of
// preprocess.py:130-132 and the channel reverse and slow-pathway index of
// engine/steps.py:268-275.
//
// Bound: bytes. The function reads N = B*T*H*W*3 bytes once and writes
// 2N (bf16) or 4N (fp32) bytes of fast pathway plus 2N/alpha or 4N/alpha of
// slow pathway; it does 2 flops per output element. At B=8, T=32, 256x256,
// alpha=8, bf16 that is about 164 MB, roughly 49 us at an H100 SXM's
// 3.35 TB/s. The design therefore moves each byte once: each thread reads a
// 16-byte run of the input (one vector load where it is aligned and
// neither flipped nor channel-reversed), converts it, and writes it to the
// fast pathway and, when its frame is one of the slow pathway's, to the slow
// pathway too. A frame -> slow-slot table, passed by value, tells a thread
// whether its frame goes to the slow pathway.
//
// Rounding: out = round(round(float(u8) * scale) + bias), with no fused
// multiply-add, which is what the plain PyTorch version computes; the cast
// to bf16 rounds to nearest even.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define SF_MAX_T 256
#define SF_VEC 16

struct PreprocessParams {
  int64_t n;       // B*T*H*W*3 input bytes
  int64_t hwc;     // H*W*3, one frame
  int64_t wc;      // W*3, one image row
  int32_t w;       // image width
  int32_t t;       // frames per clip
  int32_t t_slow;  // slow-pathway frames per clip (0: no slow output)
  int32_t reverse; // 1: output channel c reads input channel 2-c
  int32_t aligned; // 1: input and outputs are 16-byte aligned
  float scale[3];  // per input channel: 1 / (255 * std)
  float bias[3];   // per input channel: -mean / std
  int32_t slot[SF_MAX_T];  // frame -> slow-pathway slot, or -1
};

__device__ __forceinline__ float affine(uint8_t v, float s, float b) {
  return __fadd_rn(__fmul_rn(static_cast<float>(v), s), b);
}

__device__ __forceinline__ void store16(float* dst, const float* v) {
  float4* d = reinterpret_cast<float4*>(dst);
#pragma unroll
  for (int k = 0; k < 4; ++k)
    d[k] = make_float4(v[4 * k], v[4 * k + 1], v[4 * k + 2], v[4 * k + 3]);
}

__device__ __forceinline__ void store16(__nv_bfloat16* dst, const float* v) {
  __nv_bfloat162 packed[8];
#pragma unroll
  for (int k = 0; k < 8; ++k)
    packed[k] = __halves2bfloat162(__float2bfloat16_rn(v[2 * k]),
                                   __float2bfloat16_rn(v[2 * k + 1]));
  const uint4* src = reinterpret_cast<const uint4*>(packed);
  uint4* d = reinterpret_cast<uint4*>(dst);
  d[0] = src[0];
  d[1] = src[1];
}

__device__ __forceinline__ void store1(float* dst, float v) { *dst = v; }

__device__ __forceinline__ void store1(__nv_bfloat16* dst, float v) {
  *dst = __float2bfloat16_rn(v);
}

template <typename OutT>
__global__ void preprocess_u8_kernel(const uint8_t* __restrict__ x,
                                     OutT* __restrict__ fast,
                                     OutT* __restrict__ slow,
                                     const uint8_t* __restrict__ flips,
                                     const PreprocessParams p) {
  const int64_t j0 =
      (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) * SF_VEC;
  if (j0 >= p.n) return;

  // The run [j0, j0 + 16) lies in one frame when the frame does not end
  // inside it; then it shares one clip, one flip flag and one slow slot.
  const int64_t f0 = j0 / p.hwc;  // global frame index b*T + t
  const int64_t b0 = f0 / p.t;
  const int t0 = static_cast<int>(f0 - b0 * p.t);
  const bool whole = j0 + SF_VEC <= p.n && (j0 + SF_VEC - 1) / p.hwc == f0;
  const bool flip0 = flips != nullptr && flips[b0] != 0;

  float v[SF_VEC];
  if (whole && p.aligned && !flip0 && !p.reverse) {
    const uint4 raw = *reinterpret_cast<const uint4*>(x + j0);
    const uint8_t* in = reinterpret_cast<const uint8_t*>(&raw);
    const int c0 = static_cast<int>(j0 % 3);
#pragma unroll
    for (int k = 0; k < SF_VEC; ++k) {
      const int c = (c0 + k) % 3;
      v[k] = affine(in[k], p.scale[c], p.bias[c]);
    }
  } else {
#pragma unroll
    for (int k = 0; k < SF_VEC; ++k) {
      const int64_t j = j0 + k;
      if (j >= p.n) break;
      const int64_t f = j / p.hwc;
      const int64_t r = j - f * p.hwc;      // offset inside the frame
      const int64_t rw = r % p.wc;          // offset inside the row
      const int64_t pix = rw / 3;
      const int c = static_cast<int>(rw - pix * 3);
      const bool flip = flips != nullptr && flips[f / p.t] != 0;
      const int64_t src_pix = flip ? (p.w - 1 - pix) : pix;
      const int src_c = p.reverse ? 2 - c : c;
      const int64_t src = f * p.hwc + (r - rw) + src_pix * 3 + src_c;
      v[k] = affine(x[src], p.scale[src_c], p.bias[src_c]);
    }
  }

  if (whole && p.aligned) {
    store16(fast + j0, v);
  } else {
    for (int k = 0; k < SF_VEC && j0 + k < p.n; ++k) store1(fast + j0 + k, v[k]);
  }

  if (p.t_slow == 0) return;
  if (whole) {
    const int slot = p.slot[t0];
    if (slot < 0) return;
    const int64_t d0 = (b0 * p.t_slow + slot) * p.hwc + (j0 - f0 * p.hwc);
    if (p.aligned && d0 % SF_VEC == 0) {
      store16(slow + d0, v);
    } else {
      for (int k = 0; k < SF_VEC; ++k) store1(slow + d0 + k, v[k]);
    }
    return;
  }
  for (int k = 0; k < SF_VEC; ++k) {
    const int64_t j = j0 + k;
    if (j >= p.n) break;
    const int64_t f = j / p.hwc;
    const int64_t b = f / p.t;
    const int slot = p.slot[f - b * p.t];
    if (slot < 0) continue;
    store1(slow + (b * p.t_slow + slot) * p.hwc + (j - f * p.hwc), v[k]);
  }
}

// Launches the kernel on `stream`. Pointers x, fast, slow and flips are
// device pointers (slow and flips may be null); slot_table (t entries),
// scale and bias (3 entries each) are host pointers. out_bf16 selects
// bf16 output, else fp32. Returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue for arguments the kernel does not take.
extern "C" int sf_preprocess_u8(const void* x, void* fast, void* slow,
                                const void* flips, const int32_t* slot_table,
                                long long b, long long t, long long h,
                                long long w, int t_slow, const float* scale,
                                const float* bias, int reverse, int out_bf16,
                                int aligned, void* stream) {
  if (t <= 0 || t > SF_MAX_T || b <= 0 || h <= 0 || w <= 0 || t_slow < 0 ||
      (t_slow > 0 && slow == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  PreprocessParams p;
  p.hwc = h * w * 3;
  p.wc = w * 3;
  p.n = b * t * p.hwc;
  p.w = static_cast<int32_t>(w);
  p.t = static_cast<int32_t>(t);
  p.t_slow = t_slow;
  p.reverse = reverse;
  p.aligned = aligned;
  for (int c = 0; c < 3; ++c) {
    p.scale[c] = scale[c];
    p.bias[c] = bias[c];
  }
  for (int i = 0; i < SF_MAX_T; ++i) p.slot[i] = i < t ? slot_table[i] : -1;

  const int threads = 256;
  const int64_t chunks = (p.n + SF_VEC - 1) / SF_VEC;
  const int64_t blocks = (chunks + threads - 1) / threads;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint8_t* xin = static_cast<const uint8_t*>(x);
  const uint8_t* fl = static_cast<const uint8_t*>(flips);
  if (out_bf16) {
    preprocess_u8_kernel<__nv_bfloat16><<<static_cast<unsigned>(blocks), threads, 0, s>>>(
        xin, static_cast<__nv_bfloat16*>(fast), static_cast<__nv_bfloat16*>(slow), fl, p);
  } else {
    preprocess_u8_kernel<float><<<static_cast<unsigned>(blocks), threads, 0, s>>>(
        xin, static_cast<float*>(fast), static_cast<float*>(slow), fl, p);
  }
  return static_cast<int>(cudaGetLastError());
}
