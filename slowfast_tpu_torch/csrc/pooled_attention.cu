// MViT pooled-attention forwards in fp32 for Hopper (sm_90a), on the CUDA
// cores: softmax(q k^T) v for one (q tile, head, batch) per block, with the
// (Nq, Nk) matrix kept out of device memory. The tensor cores have no
// full-fp32 product, so fp32 stays here, for parity with the CPU; bf16 runs
// on the tensor cores (pooled_attention_flash.cu, pooled_attention_exact.cu).
//
// Replaces, in fp32, three Pallas kernels of
// slowfast_tpu/ops/pallas_attention.py:
//   * :375 _flash_fwd_kernel (flash_pooled_attention :502), the constant-shift
//     softmax that is also the numerics of models/attention.py:211
//     _attention_core: e = exp(min(l, 50) - 20), s = max(sum e, 1e-30),
//     o = (e v) / s;
//   * :237 _fused_fwd_kernel (fused_pooled_attention :530), the same softmax
//     that also writes e as (B, nh, Nq, Nk) for its backward
//     (pooled_attention_fused_bwd.cu): the saved-e mode. Each e is stored
//     from the register that feeds s and e v, so the output is bit-equal to
//     the flash mode's;
//   * :39 _fwd_kernel (pooled_attention :171), the exact softmax: m = max l,
//     p = exp(l - m), s = sum p, o = (p v) / s.
// q (B, Nq, nh, dq) and k (B, Nk, nh, dq) arrive pre-scaled and rel-pos
// augmented (dq = 96 + kt + kh + kw in MViTv2-S), v is (B, Nk, nh, dv); all
// fp32, contiguous. The TPU kernels' 128-lane padding is a TPU layout rule
// and is not carried over: this kernel takes the real dq, dv and Nk and
// masks the ragged edges.
//
// Bound: operations for the flash and exact modes, 2 B nh Nq Nk (dq + dv)
// flops against q, k, v and o moved once, at the H100's 67 TFLOP/s of fp32
// outside the tensor cores; the saved-e mode also writes B nh Nq Nk
// elements of e. This kernel is the parity path, not a fast one.
//
// Design. The Pallas kernel holds the whole pooled K/V row in VMEM; on Hopper
// K alone can exceed shared memory (Nk = 1569, dq = 132: 828 KB in fp32), so
// a block keeps its 64-row q tile in shared memory and loops over K/V in
// 64-key chunks. The constant shift needs no row max, so s and o accumulate
// over the chunks in one pass. The exact softmax takes two passes over the
// chunks: the row max first, then p, s and o; that reproduces _fwd_kernel's
// summation, which an online-softmax rescale would not. Both products run as
// fp32 FMA loops on a 16x16 thread grid, each thread owning a 4x4 logit tile
// and a 4 x (dv/16) output tile in registers. expf (not __expf) keeps the
// kernel within summation order of its plain PyTorch version.

#include <math.h>

#include "pooled_attention_common.cuh"

#define PA_BQ 64          // q rows per block
#define PA_BK 64          // keys per chunk
#define PA_THREADS 256    // 16 x 16 threads
#define PA_MAX_DQ 256
#define PA_MAX_DV 128
#define PA_P_STRIDE (PA_BK + 16)  // rows 16 banks apart: no conflicts

template <bool kExact, bool kSaveE, int kDvPT>
__global__ void __launch_bounds__(PA_THREADS, 2)
pooled_attention_kernel(const float* __restrict__ q, const float* __restrict__ k,
                        const float* __restrict__ v, float* __restrict__ out,
                        float* __restrict__ e_out, int nq, int nk, int nh, int dq,
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
  const float* qb = q + (b * nq * nh + h) * dq;
  const float* kb = k + (b * nk * nh + h) * dq;
  const float* vb = v + (b * nk * nh + h) * dv;
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
          p = kExact ? expf(l[i][j] - m[i]) : expf(fminf(l[i][j], 50.f) - 20.f);
          s[i] += p;
          if (kSaveE && q0 + ty + 16 * i < nq)
            e_out[e0 + static_cast<int64_t>(ty + 16 * i) * nk + key] = p;
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
    float* ob = out + ((b * nq + row) * nh + h) * dv;
#pragma unroll
    for (int j = 0; j < kDvPT; ++j) {
      const int col = tx + 16 * j;
      if (col < dv) ob[col] = o[i][j] / sum;
    }
  }
}

static size_t smem_bytes(int dq, int dv_pt) {
  const size_t dqs = static_cast<size_t>(dq | 1);
  return sizeof(float) * ((PA_BQ + PA_BK) * dqs + PA_BK * dv_pt * 16 +
                          PA_BQ * PA_P_STRIDE);
}

template <bool kExact, bool kSaveE, int kDvPT>
static int launch(const void* q, const void* k, const void* v, void* out, void* e,
                  long long b, long long nq, long long nk, long long nh,
                  long long dq, long long dv, cudaStream_t stream) {
  auto kernel = pooled_attention_kernel<kExact, kSaveE, kDvPT>;
  const size_t smem = smem_bytes(static_cast<int>(dq), kDvPT);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>((nq + PA_BQ - 1) / PA_BQ),
                  static_cast<unsigned>(nh), static_cast<unsigned>(b));
  kernel<<<grid, PA_THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), static_cast<float*>(e),
      static_cast<int>(nq), static_cast<int>(nk),
      static_cast<int>(nh), static_cast<int>(dq), static_cast<int>(dv));
  return static_cast<int>(cudaGetLastError());
}

template <bool kExact, bool kSaveE>
static int dispatch_dv(const void* q, const void* k, const void* v, void* out, void* e,
                       long long b, long long nq, long long nk, long long nh,
                       long long dq, long long dv, cudaStream_t stream) {
  if (dv <= 96)
    return launch<kExact, kSaveE, 6>(q, k, v, out, e, b, nq, nk, nh, dq, dv, stream);
  return launch<kExact, kSaveE, 8>(q, k, v, out, e, b, nq, nk, nh, dq, dv, stream);
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

// out = softmax(q k^T) v per (batch, head) in fp32, on `stream`. exact != 0
// selects the max-subtracted softmax of _fwd_kernel, else the constant
// shift of _flash_fwd_kernel. is_bf16 must be 0: bf16 runs on the tensor
// cores (pooled_attention_flash.cu, pooled_attention_exact.cu). All pointers
// are device pointers to contiguous fp32 tensors. Returns cudaGetLastError()
// after the launch, or cudaErrorInvalidValue for shapes the kernel does not
// take (bad_shape) and for bf16.
extern "C" int sf_pooled_attention(const void* q, const void* k, const void* v,
                                   void* out, long long b, long long nq,
                                   long long nk, long long nh, long long dq,
                                   long long dv, int exact, int is_bf16,
                                   void* stream) {
  if (bad_shape(b, nq, nk, nh, dq, dv) || is_bf16)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return exact ? dispatch_dv<true, false>(q, k, v, out, nullptr, b, nq, nk, nh, dq, dv, s)
               : dispatch_dv<false, false>(q, k, v, out, nullptr, b, nq, nk, nh, dq, dv, s);
}

// The saved-e mode of _fused_fwd_kernel in fp32: the constant-shift out of
// sf_pooled_attention, and e, a contiguous (b, nh, nq, nk) fp32 tensor
// holding exp(min(l, 50) - 20). Returns as sf_pooled_attention does
// (cudaErrorInvalidValue for bf16, which pooled_attention_flash.cu takes).
extern "C" int sf_pooled_attention_saved_e(const void* q, const void* k, const void* v,
                                           void* out, void* e, long long b, long long nq,
                                           long long nk, long long nh, long long dq,
                                           long long dv, int is_bf16, void* stream) {
  if (bad_shape(b, nq, nk, nh, dq, dv) || is_bf16)
    return static_cast<int>(cudaErrorInvalidValue);
  return dispatch_dv<false, true>(q, k, v, out, e, b, nq, nk, nh, dq, dv,
                                  static_cast<cudaStream_t>(stream));
}
