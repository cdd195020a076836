// MViT pooled-attention backwards for Hopper (sm_90a): dq, dk and dv of
// softmax(q k^T) v per (batch, head), with the (Nq, Nk) matrices kept out of
// device memory.
//
// Replaces two Pallas kernels of slowfast_tpu/ops/pallas_attention.py:
//   * :392 _flash_bwd_kernel, the backward of the constant-shift core (the
//     port's default MViT core): ef = round(exp(min(l, 50) - 20)),
//     s = max(sum ef, 1e-30), do_n = round(do / s), dv = ef^T do_n,
//     dpn = do_n v^T, r = sum dpn * ef, dl = round(ef * (dpn - r / s)),
//     dq = dl k, dk = dl^T q. There is no derivative of the clamp: a clamped
//     logit gets ef * (dpn - r / s), as in the TPU kernel. The delta trick
//     r = rowsum(do * out) of the XLA core is not used: it rounds otherwise
//     in bf16.
//   * :58 _bwd_kernel, the backward of the exact core (TPU.PALLAS_ATTENTION):
//     m = max l, e = exp(l - m), s = sum e, p = e / s, dp = do v^T (fp32),
//     r = sum dp * p, dl = p * (dp - r), dq = round(dl) k,
//     dk = round(dl)^T q, dv = round(p)^T do.
// fp32 only: in bf16 both run on the tensor cores
// (pooled_attention_flash_bwd.cu, pooled_attention_exact_bwd.cu).
// "round" is a cast to the input type (identity in fp32). All products
// accumulate in fp32; dq, dk and dv are rounded to the input type once, at
// the end, as the TPU kernels' fp32 outputs are cast at their boundary.
// q (B, Nq, nh, dq), k (B, Nk, nh, dq), v (B, Nk, nh, dv) and do
// (B, Nq, nh, dv) are fp32 and contiguous; rows >= Nq and
// keys >= Nk are masked here (the port pads nothing).
//
// Bound: operations. One backward does 2 B nh Nq Nk (3 dq + 2 dv) flops
// (the logits once, dpn, dv, dq, dk) and moves q, k, v, do, dq, dk and dv
// once: MViTv2-S at 16 clips needs about 1.36 TFLOP against about 2 GB in
// fp32, so the flops bind (about 20 ms at the H100's 67 TFLOP/s of fp32
// outside the tensor cores).
//
// Design. Each row's gradient needs three row statistics in order: s (the
// sum of the rounded e), then r (which needs do_n, so s first), then dl.
// The TPU kernel holds the whole pooled K row in VMEM; on Hopper K alone
// can exceed shared memory (Nk = 1569, dq = 132: 414 KB in bf16), so the
// rows kernel loops over 64-key chunks once per statistic, recomputing the
// logits each time (the exact core adds a first pass for the row max). On
// the TPU dk and dv accumulate in one output block over the sequential
// grid; on Hopper blocks run in no order, so the work is split in two
// kernels, deterministic and without atomics:
//   A (rows): one block per 64-row q tile computes m, s, r, dl and dq
//     (dl kept in shared memory per chunk) and writes dq and the row
//     statistics (fp32 (B, nh, Nq) each);
//   B (keys): one block per 64-key chunk loops over every q tile,
//     recomputes the logits, dpn and dl from those statistics and
//     accumulates dk and dv in fp32 registers.
// Both kernels compute l and dpn with the same code, so A's and B's dl are
// bit-identical. Tiles are fp32 in shared memory and every product is an
// fp32 FMA loop on a 16x16 thread grid (each thread a 4x4 logit tile), on
// the CUDA cores: the simple first version, far from the tensor-core bound;
// mma/wgmma tiles are later work.

#include <math.h>

#include "pooled_attention_common.cuh"

#define PB_BQ 64          // q rows per tile
#define PB_BK 64          // keys per chunk
#define PB_THREADS 256    // 16 x 16 threads
#define PB_MAX_DQ 192
#define PB_MAX_DV 128
#define PB_P_STRIDE (PB_BK + 16)  // rows 16 banks apart: no conflicts

// The softmax weight of one logit: the rounded e of the constant shift, or
// the unrounded p = exp(l - m) / s of the exact core.
template <bool kExact, typename T>
__device__ __forceinline__ float weight(float l, float m, float s, const T* tag) {
  if (kExact) return expf(l - m) / s;
  return round_as(expf(fminf(l, 50.f) - 20.f), tag);
}

// Kernel A: per (q tile, head, batch) the row statistics and dq.
template <typename T, bool kExact, int kDqPT>
__global__ void __launch_bounds__(PB_THREADS, 1)
attention_bwd_rows_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v, const T* __restrict__ dout,
                          T* __restrict__ dq_out, float* __restrict__ m_out,
                          float* __restrict__ s_out, float* __restrict__ r_out,
                          int nq, int nk, int nh, int dq, int dv) {
  extern __shared__ float smem[];
  const int dqs = dq | 1;
  const int dvs = dv | 1;
  float* q_s = smem;                          // [PB_BQ][dqs]
  float* do_s = q_s + PB_BQ * dqs;            // [PB_BQ][dvs]
  float* k_s = do_s + PB_BQ * dvs;            // [PB_BK][dqs]
  float* v_s = k_s + PB_BK * dqs;             // [PB_BK][dvs]
  float* p_s = v_s + PB_BK * dvs;             // [PB_BQ][PB_P_STRIDE]
  float* s_s = p_s + PB_BQ * PB_P_STRIDE;     // [PB_BQ]

  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const int q0 = blockIdx.x * PB_BQ;
  const int h = blockIdx.y;
  const int64_t b = blockIdx.z;
  const T* qb = q + (b * nq * nh + h) * dq;
  const T* kb = k + (b * nk * nh + h) * dq;
  const T* vb = v + (b * nk * nh + h) * dv;
  const T* dob = dout + (b * nq * nh + h) * dv;
  const T* tag = nullptr;  // selects round_as for T

  load_tile<PB_THREADS>(q_s, qb, q0, PB_BQ, nq, nh, dq, dqs);
  load_tile<PB_THREADS>(do_s, dob, q0, PB_BQ, nq, nh, dv, dvs);
  bool row_ok[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) row_ok[i] = q0 + ty + 16 * i < nq;

  float m[4] = {0.f, 0.f, 0.f, 0.f};
  float l[4][4];
  if (kExact) {  // the row max
#pragma unroll
    for (int i = 0; i < 4; ++i) m[i] = -INFINITY;
    for (int k0 = 0; k0 < nk; k0 += PB_BK) {
      __syncthreads();
      load_tile<PB_THREADS>(k_s, kb, k0, PB_BK, nk, nh, dq, dqs);
      __syncthreads();
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

  // s: the constant shift sums the rounded e, the exact core the unrounded.
  float s[4] = {0.f, 0.f, 0.f, 0.f};
  for (int k0 = 0; k0 < nk; k0 += PB_BK) {
    __syncthreads();
    load_tile<PB_THREADS>(k_s, kb, k0, PB_BK, nk, nh, dq, dqs);
    __syncthreads();
    dot_tile(q_s, dqs, k_s, dqs, dq, ty, tx, l);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (k0 + tx + 16 * j < nk)
          s[i] += kExact ? expf(l[i][j] - m[i]) : weight<false>(l[i][j], 0.f, 0.f, tag);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    s[i] = row_sum16(s[i]);
    if (!kExact) s[i] = fmaxf(s[i], 1e-30f);
  }
  if (!kExact) {
    if (tx == 0) {
#pragma unroll
      for (int i = 0; i < 4; ++i) s_s[ty + 16 * i] = s[i];
    }
    __syncthreads();
    normalize_do<PB_BQ, PB_THREADS>(do_s, dvs, s_s, tag);
  }

  // r = sum dpn * ef (constant shift) or sum dp * p (exact).
  float r[4] = {0.f, 0.f, 0.f, 0.f};
  float dp[4][4];
  for (int k0 = 0; k0 < nk; k0 += PB_BK) {
    __syncthreads();
    load_tile<PB_THREADS>(k_s, kb, k0, PB_BK, nk, nh, dq, dqs);
    load_tile<PB_THREADS>(v_s, vb, k0, PB_BK, nk, nh, dv, dvs);
    __syncthreads();
    dot_tile(q_s, dqs, k_s, dqs, dq, ty, tx, l);
    dot_tile(do_s, dvs, v_s, dvs, dv, ty, tx, dp);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (k0 + tx + 16 * j < nk)
          r[i] += dp[i][j] * weight<kExact>(l[i][j], m[i], s[i], tag);
  }
  float rs[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    r[i] = row_sum16(r[i]);
    rs[i] = kExact ? r[i] : r[i] / s[i];
  }

  // dl, and dq = dl k over the chunks.
  float acc[4][kDqPT];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < kDqPT; ++j) acc[i][j] = 0.f;
  for (int k0 = 0; k0 < nk; k0 += PB_BK) {
    __syncthreads();  // the previous chunk's products are done
    load_tile<PB_THREADS>(k_s, kb, k0, PB_BK, nk, nh, dq, dqs);
    load_tile<PB_THREADS>(v_s, vb, k0, PB_BK, nk, nh, dv, dvs);
    __syncthreads();
    dot_tile(q_s, dqs, k_s, dqs, dq, ty, tx, l);
    dot_tile(do_s, dvs, v_s, dvs, dv, ty, tx, dp);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float d = 0.f;
        if (row_ok[i] && k0 + tx + 16 * j < nk)
          d = round_as(weight<kExact>(l[i][j], m[i], s[i], tag) * (dp[i][j] - rs[i]), tag);
        p_s[(ty + 16 * i) * PB_P_STRIDE + tx + 16 * j] = d;
      }
    }
    __syncthreads();
    for (int kk = 0; kk < PB_BK; ++kk) {
      float a[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = p_s[(ty + 16 * i) * PB_P_STRIDE + kk];
#pragma unroll
      for (int j = 0; j < kDqPT; ++j) {
        const float w = k_s[kk * dqs + tx + 16 * j];  // columns >= dq are dropped
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(a[i], w, acc[i][j]);
      }
    }
  }

  const int64_t stat0 = (b * nh + h) * nq;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (!row_ok[i]) continue;
    T* out = dq_out + ((b * nq + row) * nh + h) * dq;
#pragma unroll
    for (int j = 0; j < kDqPT; ++j) {
      const int col = tx + 16 * j;
      if (col < dq) store_f(out + col, acc[i][j]);
    }
    if (tx == 0) {
      m_out[stat0 + row] = m[i];
      s_out[stat0 + row] = s[i];
      r_out[stat0 + row] = r[i];
    }
  }
}

// Kernel B: per (key chunk, head, batch) dk and dv over every q tile.
template <typename T, bool kExact, int kDqPT, int kDvPT>
__global__ void __launch_bounds__(PB_THREADS, 1)
attention_bwd_keys_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v, const T* __restrict__ dout,
                          T* __restrict__ dk_out, T* __restrict__ dv_out,
                          const float* __restrict__ m_in, const float* __restrict__ s_in,
                          const float* __restrict__ r_in, int nq, int nk, int nh,
                          int dq, int dv) {
  extern __shared__ float smem[];
  const int dqs = dq | 1;
  const int dvs = dv | 1;
  float* k_s = smem;                          // [PB_BK][dqs]
  float* v_s = k_s + PB_BK * dqs;             // [PB_BK][dvs]
  float* q_s = v_s + PB_BK * dvs;             // [PB_BQ][dqs]
  float* do_s = q_s + PB_BQ * dqs;            // [PB_BQ][dvs]
  float* e_s = do_s + PB_BQ * dvs;            // [PB_BQ][PB_P_STRIDE]
  float* dl_s = e_s + PB_BQ * PB_P_STRIDE;    // [PB_BQ][PB_P_STRIDE]
  float* st_s = dl_s + PB_BQ * PB_P_STRIDE;   // [3][PB_BQ]: m, s, r

  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const int k0 = blockIdx.x * PB_BK;
  const int h = blockIdx.y;
  const int64_t b = blockIdx.z;
  const T* qb = q + (b * nq * nh + h) * dq;
  const T* kb = k + (b * nk * nh + h) * dq;
  const T* vb = v + (b * nk * nh + h) * dv;
  const T* dob = dout + (b * nq * nh + h) * dv;
  const int64_t stat0 = (b * nh + h) * nq;
  const T* tag = nullptr;

  load_tile<PB_THREADS>(k_s, kb, k0, PB_BK, nk, nh, dq, dqs);
  load_tile<PB_THREADS>(v_s, vb, k0, PB_BK, nk, nh, dv, dvs);
  bool key_ok[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) key_ok[j] = k0 + tx + 16 * j < nk;

  float acc_k[4][kDqPT], acc_v[4][kDvPT];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < kDqPT; ++j) acc_k[i][j] = 0.f;
#pragma unroll
    for (int j = 0; j < kDvPT; ++j) acc_v[i][j] = 0.f;
  }

  float l[4][4], dp[4][4];
  for (int q0 = 0; q0 < nq; q0 += PB_BQ) {
    __syncthreads();  // the previous tile's products are done
    load_tile<PB_THREADS>(q_s, qb, q0, PB_BQ, nq, nh, dq, dqs);
    load_tile<PB_THREADS>(do_s, dob, q0, PB_BQ, nq, nh, dv, dvs);
    for (int idx = threadIdx.x; idx < PB_BQ; idx += PB_THREADS) {
      const bool ok = q0 + idx < nq;
      st_s[idx] = ok ? m_in[stat0 + q0 + idx] : 0.f;
      st_s[PB_BQ + idx] = ok ? s_in[stat0 + q0 + idx] : 1.f;
      st_s[2 * PB_BQ + idx] = ok ? r_in[stat0 + q0 + idx] : 0.f;
    }
    __syncthreads();
    if (!kExact) {
      normalize_do<PB_BQ, PB_THREADS>(do_s, dvs, st_s + PB_BQ, tag);
      __syncthreads();
    }
    dot_tile(q_s, dqs, k_s, dqs, dq, ty, tx, l);
    dot_tile(do_s, dvs, v_s, dvs, dv, ty, tx, dp);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int rr = ty + 16 * i;
      const bool row_ok = q0 + rr < nq;
      const float mi = st_s[rr], si = st_s[PB_BQ + rr], ri = st_s[2 * PB_BQ + rr];
      const float rs = kExact ? ri : ri / si;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float e = 0.f, d = 0.f;
        if (row_ok && key_ok[j]) {
          const float w = weight<kExact>(l[i][j], mi, si, tag);
          e = kExact ? round_as(w, tag) : w;  // dv takes round(p) or the rounded e
          d = round_as(w * (dp[i][j] - rs), tag);
        }
        e_s[rr * PB_P_STRIDE + tx + 16 * j] = e;
        dl_s[rr * PB_P_STRIDE + tx + 16 * j] = d;
      }
    }
    __syncthreads();
    for (int qq = 0; qq < PB_BQ; ++qq) {
      float e[4], d[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        e[i] = e_s[qq * PB_P_STRIDE + ty + 16 * i];
        d[i] = dl_s[qq * PB_P_STRIDE + ty + 16 * i];
      }
#pragma unroll
      for (int j = 0; j < kDvPT; ++j) {
        const float w = do_s[qq * dvs + tx + 16 * j];  // columns >= dv are dropped
#pragma unroll
        for (int i = 0; i < 4; ++i) acc_v[i][j] = fmaf(e[i], w, acc_v[i][j]);
      }
#pragma unroll
      for (int j = 0; j < kDqPT; ++j) {
        const float w = q_s[qq * dqs + tx + 16 * j];  // columns >= dq are dropped
#pragma unroll
        for (int i = 0; i < 4; ++i) acc_k[i][j] = fmaf(d[i], w, acc_k[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int key = k0 + ty + 16 * i;
    if (key >= nk) continue;
    T* dkr = dk_out + ((b * nk + key) * nh + h) * dq;
    T* dvr = dv_out + ((b * nk + key) * nh + h) * dv;
#pragma unroll
    for (int j = 0; j < kDqPT; ++j) {
      const int col = tx + 16 * j;
      if (col < dq) store_f(dkr + col, acc_k[i][j]);
    }
#pragma unroll
    for (int j = 0; j < kDvPT; ++j) {
      const int col = tx + 16 * j;
      if (col < dv) store_f(dvr + col, acc_v[i][j]);
    }
  }
}

static size_t rows_smem(int dq, int dv) {
  const size_t dqs = dq | 1, dvs = dv | 1;
  return sizeof(float) * ((PB_BQ + PB_BK) * (dqs + dvs) + PB_BQ * PB_P_STRIDE + PB_BQ);
}

static size_t keys_smem(int dq, int dv) {
  const size_t dqs = dq | 1, dvs = dv | 1;
  return sizeof(float) *
         ((PB_BQ + PB_BK) * (dqs + dvs) + 2 * PB_BQ * PB_P_STRIDE + 3 * PB_BQ);
}

struct BwdArgs {
  const void *q, *k, *v, *dout;
  void *dq, *dk, *dv;
  float *m, *s, *r;
  long long b, nq, nk, nh, dqd, dvd;
  cudaStream_t stream;
};

template <typename T, bool kExact, int kDqPT, int kDvPT>
static int launch(const BwdArgs& a) {
  const int dq = static_cast<int>(a.dqd), dv = static_cast<int>(a.dvd);
  const int nq = static_cast<int>(a.nq), nk = static_cast<int>(a.nk);
  const int nh = static_cast<int>(a.nh);
  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  const T* dout = static_cast<const T*>(a.dout);

  auto rows = attention_bwd_rows_kernel<T, kExact, kDqPT>;
  const size_t smem_a = rows_smem(dq, dv);
  cudaError_t err = cudaFuncSetAttribute(
      rows, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem_a));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid_a(static_cast<unsigned>((a.nq + PB_BQ - 1) / PB_BQ),
                    static_cast<unsigned>(a.nh), static_cast<unsigned>(a.b));
  rows<<<grid_a, PB_THREADS, smem_a, a.stream>>>(q, k, v, dout, static_cast<T*>(a.dq),
                                                 a.m, a.s, a.r, nq, nk, nh, dq, dv);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  auto keys = attention_bwd_keys_kernel<T, kExact, kDqPT, kDvPT>;
  const size_t smem_b = keys_smem(dq, dv);
  err = cudaFuncSetAttribute(keys, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem_b));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid_b(static_cast<unsigned>((a.nk + PB_BK - 1) / PB_BK),
                    static_cast<unsigned>(a.nh), static_cast<unsigned>(a.b));
  keys<<<grid_b, PB_THREADS, smem_b, a.stream>>>(q, k, v, dout, static_cast<T*>(a.dk),
                                                 static_cast<T*>(a.dv), a.m, a.s, a.r,
                                                 nq, nk, nh, dq, dv);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool kExact>
static int dispatch(const BwdArgs& a) {
  if (a.dqd <= 144)
    return a.dvd <= 96 ? launch<T, kExact, 9, 6>(a) : launch<T, kExact, 9, 8>(a);
  return a.dvd <= 96 ? launch<T, kExact, 12, 6>(a) : launch<T, kExact, 12, 8>(a);
}

// dq, dk and dv of softmax(q k^T) v per (batch, head), fp32, on `stream`,
// given the output gradient dout. exact != 0 selects _bwd_kernel's exact
// softmax, else _flash_bwd_kernel's constant shift. stats is fp32 scratch of
// 3 * b * nh * nq floats. All pointers are device pointers to contiguous
// tensors. Returns cudaGetLastError() after the launches, or
// cudaErrorInvalidValue for shapes the kernels do not take (dq > 192,
// dv > 128, grid limits).
extern "C" int sf_pooled_attention_bwd(const void* q, const void* k, const void* v,
                                       const void* dout, void* dq, void* dk, void* dv,
                                       void* stats, long long b, long long nq,
                                       long long nk, long long nh, long long dqd,
                                       long long dvd, int exact, void* stream) {
  if (b <= 0 || nq <= 0 || nk <= 0 || nh <= 0 || dqd <= 0 || dvd <= 0 ||
      dqd > PB_MAX_DQ || dvd > PB_MAX_DV || b > 65535 || nh > 65535 ||
      nq > 0x7fffffffLL - PB_BQ || nk > 0x7fffffffLL - PB_BK ||
      b * (nq > nk ? nq : nk) * nh * (dqd > dvd ? dqd : dvd) > (1LL << 62))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long plane = b * nh * nq;
  float* st = static_cast<float*>(stats);
  const BwdArgs a{q, k, v, dout, dq, dk, dv, st, st + plane, st + 2 * plane,
                  b, nq, nk, nh, dqd, dvd, static_cast<cudaStream_t>(stream)};
  return exact ? dispatch<float, true>(a) : dispatch<float, false>(a);
}
