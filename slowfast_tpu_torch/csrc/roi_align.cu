// ROIAlign forward and backward for Hopper (sm_90a), on channels-last
// features.
//
// Replaces slowfast_tpu/ops/roi_align.py:106 roi_align (plain XLA in the JAX
// package: the separable matmul form at :175-200 and the gather form at
// :38-64 and :202-), which the RoI head of AVA detection calls once per
// pathway (slowfast_tpu/models/heads.py:148 ResNetRoIHead). The reference
// called detectron2's CUDA op.
//
// Semantics, exactly the JAX package's: ROI r = [b, x1, y1, x2, y2] is
// scaled by spatial_scale and shifted by -0.5 when aligned (its side at
// least 1 when not); each of its P x P bins averages a grid of
// grid_h x grid_w samples, grid = clip(ceil(bin), 1, max_samples) per axis
// (or sampling_ratio); a sample whose y lies outside [-1, H] or whose x lies
// outside [-1, W] gives zero, the others are clamped to the map and
// interpolated bilinearly with y1 = min(y0 + 1, H - 1). Features are read
// in bf16 or fp32 and every sum is taken in fp32; the output is fp32, as
// the JAX function casts the features to fp32 first.
//
// Forward: one block per (roi, bin) and per 256 channels, one thread per
// channel, so that the four taps of a sample are read as contiguous runs of
// channels (coalesced). The sample positions, taps and weights of the bin
// are the same for every channel: the block computes them once into shared
// memory.
//
// Backward: deterministic, with no floating-point atomics. One block per
// feature pixel (b, y, x) and per 256 channels gathers, in a fixed order,
// over the ROIs of batch b (rows b*M .. b*M+M-1 under the head's padded
// layout, else the per-batch lists `order`/`offsets`) and their bins:
// d f[b, y, x, c] = sum_r sum_ph sum_pw Ay[r, ph, y] Ax[r, pw, x] g[r, ph, pw, c],
// where Ay is the bin's summed bilinear (hat) weight of row y over its valid
// samples divided by grid_h (the gather form's VJP, separable because a
// sample is dropped when y or x is out of range), and likewise Ax. The sum
// is in fp32, rounded once to the features' type.
//
// Bound: bytes. At the AVA main path (R = 128 ROIs, P = 7, C = 2048 + 256,
// 14 x 14 maps of 16 clips in bf16) the forward reads 14.4 MB of features
// and writes 57.8 MB of fp32 bins, about 22 us at 3.35 TB/s; each output
// element costs 4 to 16 taps, far below the card's operation rate. The
// backward reads the 57.8 MB of bin gradients and writes 14.4 MB.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define RA_THREADS 256
#define RA_MAX_GRID 16  // samples per axis a bin may take
#define RA_MAX_P 32     // pooled resolution
#define RA_CHUNK 32     // ROIs whose weights the backward holds at once

struct RoiAlignParams {
  int64_t b, h, w, c, r;
  int p;
  float scale;
  int sampling_ratio;
  int aligned;
  int max_samples;
  int rois_per_batch;  // backward: > 0 for the padded layout
};

// One ROI's box in feature coordinates, bin size and sample grid, in the
// JAX function's order of fp32 operations, with a fused multiply-add where
// XLA's CPU compiler makes one of it (box * scale - offset, and
// start + bin * size in sample_pos) and none elsewhere, and the bin size as
// XLA computes a division by the constant P: a product with 1/P.
struct RoiGeom {
  int b;
  float y1, x1, bin_h, bin_w;
  int grid_h, grid_w;
};

__device__ __forceinline__ RoiGeom roi_geom(const float* roi, const RoiAlignParams& p) {
  RoiGeom g;
  g.b = static_cast<int>(roi[0]);
  const float offset = p.aligned ? 0.5f : 0.0f;
  const float x1 = __fmaf_rn(roi[1], p.scale, -offset);
  const float y1 = __fmaf_rn(roi[2], p.scale, -offset);
  const float x2 = __fmaf_rn(roi[3], p.scale, -offset);
  const float y2 = __fmaf_rn(roi[4], p.scale, -offset);
  float roi_w = __fsub_rn(x2, x1);
  float roi_h = __fsub_rn(y2, y1);
  if (!p.aligned) {
    roi_w = fmaxf(roi_w, 1.0f);
    roi_h = fmaxf(roi_h, 1.0f);
  }
  g.y1 = y1;
  g.x1 = x1;
  const float inv_p = __fdiv_rn(1.0f, static_cast<float>(p.p));  // XLA's constant
  g.bin_h = __fmul_rn(roi_h, inv_p);
  g.bin_w = __fmul_rn(roi_w, inv_p);
  if (p.sampling_ratio > 0) {
    g.grid_h = g.grid_w = p.sampling_ratio;
  } else {
    const float cap = static_cast<float>(p.max_samples);
    g.grid_h = static_cast<int>(fminf(fmaxf(ceilf(g.bin_h), 1.0f), cap));
    g.grid_w = static_cast<int>(fminf(fmaxf(ceilf(g.bin_w), 1.0f), cap));
  }
  return g;
}

// Sample s of bin `bin` along an axis: start + bin * size + (s + 0.5) * size / grid.
__device__ __forceinline__ float sample_pos(float start, int bin, float size, int s, int grid) {
  const float off = __fdiv_rn(__fmul_rn(static_cast<float>(s) + 0.5f, size),
                              static_cast<float>(grid));
  return __fadd_rn(__fmaf_rn(static_cast<float>(bin), size, start), off);
}

__device__ __forceinline__ float load(const float* f, int64_t i) { return f[i]; }

__device__ __forceinline__ float load(const __nv_bfloat16* f, int64_t i) {
  return __bfloat162float(f[i]);
}

__device__ __forceinline__ void store(float* f, int64_t i, float v) { f[i] = v; }

__device__ __forceinline__ void store(__nv_bfloat16* f, int64_t i, float v) {
  f[i] = __float2bfloat16_rn(v);
}

// Taps and weights of one sample along one axis of extent n: low and high
// index, their weights, and whether the sample lies in [-1, n].
struct Tap {
  int lo, hi;
  float w_lo, w_hi;
  int valid;
};

__device__ __forceinline__ Tap axis_tap(float pos, int n) {
  Tap t;
  t.valid = !(pos < -1.0f || pos > static_cast<float>(n));
  const float c = fminf(fmaxf(pos, 0.0f), static_cast<float>(n - 1));
  const float lo = floorf(c);
  const float hi = fminf(lo + 1.0f, static_cast<float>(n - 1));
  const float l = __fsub_rn(c, lo);
  t.lo = static_cast<int>(lo);
  t.hi = static_cast<int>(hi);
  t.w_hi = l;
  t.w_lo = __fsub_rn(1.0f, l);
  return t;
}

template <typename T>
__global__ void roi_align_fwd_kernel(const T* __restrict__ feats,
                                     const float* __restrict__ rois,
                                     float* __restrict__ out,
                                     const RoiAlignParams p) {
  __shared__ Tap ty[RA_MAX_GRID], tx[RA_MAX_GRID];
  const int bins = p.p * p.p;
  const int64_t r = blockIdx.x / bins;
  const int bin = static_cast<int>(blockIdx.x - r * bins);
  const int ph = bin / p.p, pw = bin - (bin / p.p) * p.p;
  const RoiGeom g = roi_geom(rois + r * 5, p);
  for (int i = threadIdx.x; i < g.grid_h + g.grid_w; i += blockDim.x) {
    if (i < g.grid_h)
      ty[i] = axis_tap(sample_pos(g.y1, ph, g.bin_h, i, g.grid_h), static_cast<int>(p.h));
    else
      tx[i - g.grid_h] = axis_tap(sample_pos(g.x1, pw, g.bin_w, i - g.grid_h, g.grid_w),
                                  static_cast<int>(p.w));
  }
  __syncthreads();
  const int64_t c = static_cast<int64_t>(blockIdx.y) * blockDim.x + threadIdx.x;
  if (c >= p.c) return;
  const T* f = feats + static_cast<int64_t>(g.b) * p.h * p.w * p.c + c;
  float acc = 0.0f;
  for (int sy = 0; sy < g.grid_h; ++sy) {
    const Tap a = ty[sy];
    if (!a.valid) continue;
    for (int sx = 0; sx < g.grid_w; ++sx) {
      const Tap e = tx[sx];
      if (!e.valid) continue;
      const float v00 = load(f, (a.lo * p.w + e.lo) * p.c);
      const float v01 = load(f, (a.lo * p.w + e.hi) * p.c);
      const float v10 = load(f, (a.hi * p.w + e.lo) * p.c);
      const float v11 = load(f, (a.hi * p.w + e.hi) * p.c);
      float v = __fmul_rn(v00, __fmul_rn(a.w_lo, e.w_lo));
      v = __fadd_rn(v, __fmul_rn(v01, __fmul_rn(a.w_lo, e.w_hi)));
      v = __fadd_rn(v, __fmul_rn(v10, __fmul_rn(a.w_hi, e.w_lo)));
      v = __fadd_rn(v, __fmul_rn(v11, __fmul_rn(a.w_hi, e.w_hi)));
      acc = __fadd_rn(acc, v);
    }
  }
  const float count = static_cast<float>(g.grid_h * g.grid_w);
  out[(r * bins + bin) * p.c + c] = __fdiv_rn(acc, count);
}

// Ay (axis 0) or Ax (axis 1) of one ROI's bin at feature row/column i: the
// summed hat weights max(0, 1 - |clamp(pos) - i|) of its valid samples,
// divided by the grid.
__device__ __forceinline__ float axis_weight(const RoiGeom& g, int axis, int bin, int i,
                                             int n) {
  const float start = axis == 0 ? g.y1 : g.x1;
  const float size = axis == 0 ? g.bin_h : g.bin_w;
  const int grid = axis == 0 ? g.grid_h : g.grid_w;
  float acc = 0.0f;
  for (int s = 0; s < grid; ++s) {
    const float pos = sample_pos(start, bin, size, s, grid);
    if (pos < -1.0f || pos > static_cast<float>(n)) continue;
    const float c = fminf(fmaxf(pos, 0.0f), static_cast<float>(n - 1));
    const float d = fabsf(__fsub_rn(c, static_cast<float>(i)));
    if (d < 1.0f) acc = __fadd_rn(acc, __fsub_rn(1.0f, d));
  }
  return __fdiv_rn(acc, static_cast<float>(grid));
}

template <typename T>
__global__ void roi_align_bwd_kernel(const float* __restrict__ grad_out,
                                     const float* __restrict__ rois,
                                     const int32_t* __restrict__ order,
                                     const int32_t* __restrict__ offsets,
                                     T* __restrict__ grad_feats,
                                     const RoiAlignParams p) {
  __shared__ float wts[RA_CHUNK][2 * RA_MAX_P];
  __shared__ int32_t rows[RA_CHUNK];
  const int64_t pix = blockIdx.x;  // (b * H + y) * W + x
  const int64_t b = pix / (p.h * p.w);
  const int y = static_cast<int>((pix / p.w) % p.h);
  const int x = static_cast<int>(pix % p.w);
  const int64_t c = static_cast<int64_t>(blockIdx.y) * blockDim.x + threadIdx.x;
  int64_t first, count;
  if (p.rois_per_batch > 0) {
    first = b * p.rois_per_batch;
    count = p.rois_per_batch;
  } else {
    first = offsets[b];
    count = offsets[b + 1] - offsets[b];
  }
  const int bins = p.p * p.p;
  float acc = 0.0f;
  for (int64_t k0 = 0; k0 < count; k0 += RA_CHUNK) {
    const int n = static_cast<int>(count - k0 < RA_CHUNK ? count - k0 : RA_CHUNK);
    __syncthreads();  // the previous chunk's weights are no longer read
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      const int64_t k = first + k0 + i;
      rows[i] = p.rois_per_batch > 0 ? static_cast<int32_t>(k) : order[k];
    }
    __syncthreads();
    for (int i = threadIdx.x; i < n * 2 * p.p; i += blockDim.x) {
      const int j = i / (2 * p.p), q = i - j * 2 * p.p;
      const RoiGeom g = roi_geom(rois + static_cast<int64_t>(rows[j]) * 5, p);
      wts[j][q] = q < p.p ? axis_weight(g, 0, q, y, static_cast<int>(p.h))
                          : axis_weight(g, 1, q - p.p, x, static_cast<int>(p.w));
    }
    __syncthreads();
    if (c >= p.c) continue;
    for (int j = 0; j < n; ++j) {
      const float* gr = grad_out + static_cast<int64_t>(rows[j]) * bins * p.c + c;
      for (int ph = 0; ph < p.p; ++ph) {
        const float wy = wts[j][ph];
        if (wy == 0.0f) continue;
        for (int pw = 0; pw < p.p; ++pw) {
          const float wx = wts[j][p.p + pw];
          if (wx == 0.0f) continue;
          acc = __fadd_rn(acc, __fmul_rn(__fmul_rn(wy, wx), gr[(ph * p.p + pw) * p.c]));
        }
      }
    }
  }
  if (c < p.c) store(grad_feats, pix * p.c + c, acc);
}

static int check_params(const RoiAlignParams& p) {
  if (p.b <= 0 || p.h <= 0 || p.w <= 0 || p.c <= 0 || p.r < 0 || p.p <= 0 ||
      p.p > RA_MAX_P || p.max_samples <= 0 || p.max_samples > RA_MAX_GRID ||
      p.sampling_ratio > RA_MAX_GRID)
    return static_cast<int>(cudaErrorInvalidValue);
  return 0;
}

static RoiAlignParams make_params(long long b, long long h, long long w, long long c,
                                  long long r, int pooled, float scale, int sampling_ratio,
                                  int aligned, int max_samples, int rois_per_batch) {
  RoiAlignParams p;
  p.b = b;
  p.h = h;
  p.w = w;
  p.c = c;
  p.r = r;
  p.p = pooled;
  p.scale = scale;
  p.sampling_ratio = sampling_ratio;
  p.aligned = aligned;
  p.max_samples = max_samples;
  p.rois_per_batch = rois_per_batch;
  return p;
}

static int threads_for(long long c) {
  const long long t = (c + 31) / 32 * 32;
  return static_cast<int>(t < RA_THREADS ? t : RA_THREADS);
}

// Forward on `stream`: feats (b, h, w, c) bf16 (feats_bf16 = 1) or fp32,
// rois (r, 5) fp32, out (r, pooled, pooled, c) fp32; all device pointers,
// contiguous. Returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue for arguments the kernel does not take.
extern "C" int sf_roi_align_fwd(const void* feats, const float* rois, float* out,
                                long long b, long long h, long long w, long long c,
                                long long r, int pooled, float scale, int sampling_ratio,
                                int aligned, int max_samples, int feats_bf16, void* stream) {
  const RoiAlignParams p = make_params(b, h, w, c, r, pooled, scale, sampling_ratio, aligned,
                                       max_samples, 0);
  if (int err = check_params(p)) return err;
  const int threads = threads_for(c);
  const long long blocks = r * pooled * pooled;
  const long long chunks = (c + threads - 1) / threads;
  if (blocks <= 0 || blocks > 0x7fffffffLL || chunks > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(blocks), static_cast<unsigned>(chunks));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (feats_bf16)
    roi_align_fwd_kernel<__nv_bfloat16><<<grid, threads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(feats), rois, out, p);
  else
    roi_align_fwd_kernel<float><<<grid, threads, 0, s>>>(static_cast<const float*>(feats),
                                                         rois, out, p);
  return static_cast<int>(cudaGetLastError());
}

// Backward on `stream`: grad_out (r, pooled, pooled, c) fp32, rois (r, 5)
// fp32, grad_feats (b, h, w, c) in the features' type, written whole. With
// rois_per_batch > 0 the ROIs of batch i are rows i*M .. i*M+M-1 and order
// and offsets may be null; else order (r int32) lists the ROIs batch by
// batch and offsets (b + 1 int32) delimits each batch's run of it.
extern "C" int sf_roi_align_bwd(const float* grad_out, const float* rois,
                                const int32_t* order, const int32_t* offsets,
                                void* grad_feats, long long b, long long h, long long w,
                                long long c, long long r, int pooled, float scale,
                                int sampling_ratio, int aligned, int max_samples,
                                int rois_per_batch, int feats_bf16, void* stream) {
  const RoiAlignParams p = make_params(b, h, w, c, r, pooled, scale, sampling_ratio, aligned,
                                       max_samples, rois_per_batch);
  if (int err = check_params(p)) return err;
  if (rois_per_batch < 0 || (rois_per_batch > 0 && b * rois_per_batch != r) ||
      (rois_per_batch == 0 && (order == nullptr || offsets == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  const int threads = threads_for(c);
  const long long blocks = b * h * w;
  const long long chunks = (c + threads - 1) / threads;
  if (blocks > 0x7fffffffLL || chunks > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(blocks), static_cast<unsigned>(chunks));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (feats_bf16)
    roi_align_bwd_kernel<__nv_bfloat16><<<grid, threads, 0, s>>>(
        grad_out, rois, order, offsets, static_cast<__nv_bfloat16*>(grad_feats), p);
  else
    roi_align_bwd_kernel<float><<<grid, threads, 0, s>>>(grad_out, rois, order, offsets,
                                                         static_cast<float*>(grad_feats), p);
  return static_cast<int>(cudaGetLastError());
}
