// MViT pooled-attention forwards for Hopper (sm_90a): softmax(q k^T) v for
// one (q tile, head, batch) per block, with the (Nq, Nk) matrix kept out of
// device memory.
//
// Replaces three Pallas kernels of slowfast_tpu/ops/pallas_attention.py:
//   * :375 _flash_fwd_kernel (flash_pooled_attention :502), the constant-shift
//     softmax that is also the numerics of models/attention.py:211
//     _attention_core: e = round(exp(min(l, 50) - 20)), s = max(sum e, 1e-30),
//     o = (e v) / s, with e rounded to the input type before both the sum and
//     the product;
//   * :237 _fused_fwd_kernel (fused_pooled_attention :530), the same softmax
//     that also writes the rounded e as (B, nh, Nq, Nk) in the input type for
//     its backward (pooled_attention_fused_bwd.cu): the saved-e mode. Each e
//     is stored from the register that feeds s and e v, so the output is
//     bit-equal to the flash mode's;
//   * :39 _fwd_kernel (pooled_attention :171), the exact softmax: m = max l,
//     p = exp(l - m), s = sum p in fp32 (unrounded), o = (round(p) v) / s;
//     fp32 only, as bf16 runs on the tensor cores (pooled_attention_exact.cu).
// q (B, Nq, nh, dq) and k (B, Nk, nh, dq) arrive pre-scaled and rel-pos
// augmented (dq = 96 + kt + kh + kw in MViTv2-S), v is (B, Nk, nh, dv); all
// bf16 or all fp32, contiguous. Both products accumulate in fp32. The TPU
// kernels' 128-lane padding is a TPU layout rule and is not carried over:
// this kernel takes the real dq, dv and Nk and masks the ragged edges.
//
// Bound: operations for the flash and exact modes. One call does
// 2 B nh Nq Nk (dq + dv) flops and B nh Nq Nk exponentials but moves only
// q, k, v and o once: MViTv2-S at B=8 in bf16 needs about 265 GFLOP per
// forward against some 0.2 GB, so at the H100's 989 TFLOP/s (bf16 tensor
// cores) and 3.35 TB/s the flops bind by two orders of magnitude. The
// saved-e mode also writes B nh Nq Nk elements of e: 2.4 GB in bf16 for the
// 16 blocks of a 16-clip train step (0.72 ms at 3.35 TB/s against 0.54 ms
// of flops), so it is bound by bytes.
//
// Design. The Pallas kernel holds the whole pooled K/V row in VMEM; on Hopper
// K alone can exceed shared memory (Nk = 1569, dq = 132: 414 KB in bf16), so
// a block keeps its 64-row q tile in shared memory and loops over K/V in
// 64-key chunks. The constant shift needs no row max, so s and o accumulate
// over the chunks in one pass. The exact softmax takes two passes over the
// chunks: the row max first, then p, s and o; that reproduces _fwd_kernel's
// rounding exactly, which an online-softmax rescale would not. Tiles are
// converted to fp32 in shared memory and both products run as fp32 FMA loops
// on a 16x16 thread grid, each thread owning a 4x4 logit tile and a
// 4 x (dv/16) output tile in registers. This is the simple first version: it
// runs on the CUDA cores, not the tensor cores, so it sits far from the
// flop bound; mma/wgmma tiles are later work. expf (not __expf) keeps the
// kernel within summation order of its plain PyTorch version.

#include <math.h>

#include "pooled_attention_common.cuh"

#define PA_BQ 64          // q rows per block
#define PA_BK 64          // keys per chunk
#define PA_THREADS 256    // 16 x 16 threads
#define PA_MAX_DQ 256
#define PA_MAX_DV 128
#define PA_P_STRIDE (PA_BK + 16)  // rows 16 banks apart: no conflicts

template <typename T, bool kExact, bool kSaveE, int kDvPT>
__global__ void __launch_bounds__(PA_THREADS, 2)
pooled_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, T* __restrict__ out,
                        T* __restrict__ e_out, int nq, int nk, int nh, int dq,
                        int dv) {
  static_assert(!(kExact && kSaveE), "the saved-e mode is the constant shift's");
  extern __shared__ float smem[];
  const int dqs = dq | 1;          // odd row stride: 16 key rows, 16 banks
  const int dvs = kDvPT * 16;      // v columns >= dv are zero
  float* q_s = smem;               // [PA_BQ][dqs]
  float* k_s = q_s + PA_BQ * dqs;  // [PA_BK][dqs]
  float* v_s = k_s + PA_BK * dqs;  // [PA_BK][dvs]
  float* p_s = v_s + PA_BK * dvs;  // [PA_BQ][PA_P_STRIDE]

  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const int q0 = blockIdx.x * PA_BQ;
  const int h = blockIdx.y;
  const int64_t b = blockIdx.z;
  const T* qb = q + (b * nq * nh + h) * dq;
  const T* kb = k + (b * nk * nh + h) * dq;
  const T* vb = v + (b * nk * nh + h) * dv;
  const T* tag = nullptr;  // selects round_as for T
  // Saved-e mode: e element (row q0 + r, key c) of this head at e0 + r nk + c.
  const int64_t e0 = ((b * nh + h) * nq + q0) * static_cast<int64_t>(nk);

  load_tile<PA_THREADS>(q_s, qb, q0, PA_BQ, nq, nh, dq, dqs);

  float m[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) m[i] = -INFINITY;
  if (kExact) {  // pass 1: the row max over every chunk
    for (int k0 = 0; k0 < nk; k0 += PA_BK) {
      __syncthreads();
      load_tile<PA_THREADS>(k_s, kb, k0, PA_BK, nk, nh, dq, dqs);
      __syncthreads();
      float l[4][4];
      dot_tile(q_s, dqs, k_s, dqs, dq, ty, tx, l);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (k0 + tx + 16 * j < nk) m[i] = fmaxf(m[i], l[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) m[i] = row_max16(m[i]);
  }

  float s[4] = {0.f, 0.f, 0.f, 0.f};
  float o[4][kDvPT];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < kDvPT; ++j) o[i][j] = 0.f;

  for (int k0 = 0; k0 < nk; k0 += PA_BK) {
    __syncthreads();  // the previous chunk's products are done
    load_tile<PA_THREADS>(k_s, kb, k0, PA_BK, nk, nh, dq, dqs);
    load_tile<PA_THREADS>(v_s, vb, k0, PA_BK, nk, nh, dv, dvs);
    __syncthreads();
    float l[4][4];
    dot_tile(q_s, dqs, k_s, dqs, dq, ty, tx, l);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float p = 0.f;
        const int key = k0 + tx + 16 * j;
        if (key < nk) {
          if (kExact) {
            const float e = expf(l[i][j] - m[i]);
            s[i] += e;  // the exact softmax sums the unrounded p
            p = round_as(e, tag);
          } else {
            p = round_as(expf(fminf(l[i][j], 50.f) - 20.f), tag);
            s[i] += p;  // the constant shift sums the rounded e
            if (kSaveE && q0 + ty + 16 * i < nq)
              store_f(e_out + e0 + static_cast<int64_t>(ty + 16 * i) * nk + key, p);
          }
        }
        p_s[(ty + 16 * i) * PA_P_STRIDE + tx + 16 * j] = p;
      }
    }
    __syncthreads();
    for (int kk = 0; kk < PA_BK; ++kk) {
      float p[4], w[kDvPT];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = p_s[(ty + 16 * i) * PA_P_STRIDE + kk];
#pragma unroll
      for (int j = 0; j < kDvPT; ++j) w[j] = v_s[kk * dvs + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < kDvPT; ++j) o[i][j] = fmaf(p[i], w[j], o[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float sum = row_sum16(s[i]);
    if (!kExact) sum = fmaxf(sum, 1e-30f);
    const int row = q0 + ty + 16 * i;
    if (row >= nq) continue;
    T* ob = out + ((b * nq + row) * nh + h) * dv;
#pragma unroll
    for (int j = 0; j < kDvPT; ++j) {
      const int col = tx + 16 * j;
      if (col < dv) store_f(ob + col, o[i][j] / sum);
    }
  }
}

static size_t smem_bytes(int dq, int dv_pt) {
  const size_t dqs = static_cast<size_t>(dq | 1);
  return sizeof(float) * ((PA_BQ + PA_BK) * dqs + PA_BK * dv_pt * 16 +
                          PA_BQ * PA_P_STRIDE);
}

template <typename T, bool kExact, bool kSaveE, int kDvPT>
static int launch(const void* q, const void* k, const void* v, void* out, void* e,
                  long long b, long long nq, long long nk, long long nh,
                  long long dq, long long dv, cudaStream_t stream) {
  auto kernel = pooled_attention_kernel<T, kExact, kSaveE, kDvPT>;
  const size_t smem = smem_bytes(static_cast<int>(dq), kDvPT);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>((nq + PA_BQ - 1) / PA_BQ),
                  static_cast<unsigned>(nh), static_cast<unsigned>(b));
  kernel<<<grid, PA_THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), static_cast<T*>(e), static_cast<int>(nq), static_cast<int>(nk),
      static_cast<int>(nh), static_cast<int>(dq), static_cast<int>(dv));
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool kExact, bool kSaveE>
static int dispatch_dv(const void* q, const void* k, const void* v, void* out, void* e,
                       long long b, long long nq, long long nk, long long nh,
                       long long dq, long long dv, cudaStream_t stream) {
  if (dv <= 96)
    return launch<T, kExact, kSaveE, 6>(q, k, v, out, e, b, nq, nk, nh, dq, dv, stream);
  return launch<T, kExact, kSaveE, 8>(q, k, v, out, e, b, nq, nk, nh, dq, dv, stream);
}

// Shapes the kernel does not take: dq > 256, dv > 128, grid limits, sizes
// whose element offsets pass 2^62.
static bool bad_shape(long long b, long long nq, long long nk, long long nh,
                      long long dq, long long dv) {
  return b <= 0 || nq <= 0 || nk <= 0 || nh <= 0 || dq <= 0 || dv <= 0 ||
         dq > PA_MAX_DQ || dv > PA_MAX_DV || b > 65535 || nh > 65535 ||
         (nq + PA_BQ - 1) / PA_BQ > 0x7fffffffLL || nk > 0x7fffffffLL ||
         b * nq * nh * (dq > dv ? dq : dv) > (1LL << 62) ||
         b * nh * nq > (1LL << 62) / nk;
}

// out = softmax(q k^T) v per (batch, head), on `stream`. exact != 0 selects
// the max-subtracted softmax of _fwd_kernel (fp32 only: in bf16 it runs on
// the tensor cores, pooled_attention_exact.cu), else the constant shift of
// _flash_fwd_kernel; is_bf16 != 0 selects bf16 tensors, else fp32. All
// pointers are device pointers to contiguous tensors. Returns
// cudaGetLastError() after the launch, or cudaErrorInvalidValue for shapes
// the kernel does not take (bad_shape) and for bf16 with exact.
extern "C" int sf_pooled_attention(const void* q, const void* k, const void* v,
                                   void* out, long long b, long long nq,
                                   long long nk, long long nh, long long dq,
                                   long long dv, int exact, int is_bf16,
                                   void* stream) {
  if (bad_shape(b, nq, nk, nh, dq, dv) || (is_bf16 && exact))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return dispatch_dv<__nv_bfloat16, false, false>(q, k, v, out, nullptr, b, nq, nk, nh, dq,
                                                    dv, s);
  return exact ? dispatch_dv<float, true, false>(q, k, v, out, nullptr, b, nq, nk, nh, dq,
                                                 dv, s)
               : dispatch_dv<float, false, false>(q, k, v, out, nullptr, b, nq, nk, nh, dq,
                                                  dv, s);
}

// The saved-e mode of _fused_fwd_kernel: the constant-shift out of
// sf_pooled_attention, and e, a contiguous (b, nh, nq, nk) tensor of the
// input type, holding round(exp(min(l, 50) - 20)). Returns as
// sf_pooled_attention does.
extern "C" int sf_pooled_attention_saved_e(const void* q, const void* k, const void* v,
                                           void* out, void* e, long long b, long long nq,
                                           long long nk, long long nh, long long dq,
                                           long long dv, int is_bf16, void* stream) {
  if (bad_shape(b, nq, nk, nh, dq, dv)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return dispatch_dv<__nv_bfloat16, false, true>(q, k, v, out, e, b, nq, nk, nh, dq, dv, s);
  return dispatch_dv<float, false, true>(q, k, v, out, e, b, nq, nk, nh, dq, dv, s);
}
