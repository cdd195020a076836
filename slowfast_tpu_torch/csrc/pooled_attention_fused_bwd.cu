// MViT pooled-attention backward from the saved e, for Hopper (sm_90a): dq,
// dk and dv of the constant-shift softmax(q k^T) v per (batch, head), reading
// the rounded e that the saved-e forward (pooled_attention.cu) wrote instead
// of recomputing the logits.
//
// Replaces the Pallas kernel :255 _fused_bwd_kernel of
// slowfast_tpu/ops/pallas_attention.py (the backward of
// fused_pooled_attention :530): ef = e (the forward's rounded
// round(exp(min(l, 50) - 20))), s = max(sum ef, 1e-30), do_n = round(do / s),
// dv = ef^T do_n, dpn = do_n v^T, r = sum dpn * ef,
// dl = round(ef * (dpn - r / s)), dq = dl k, dk = dl^T q. There is no
// derivative of the clamp, as in the TPU kernel. "round" is a cast to the
// input type (identity in fp32). All products accumulate in fp32; dq, dk and
// dv are rounded to the input type once, at the end. fp32 only: in bf16 it
// runs on the tensor cores (read mode of pooled_attention_flash_bwd.cu).
// q (B, Nq, nh, dq), k (B, Nk, nh, dq), v (B, Nk, nh, dv), do
// (B, Nq, nh, dv) and e (B, nh, Nq, Nk) are fp32 and contiguous; rows >= Nq and
// keys >= Nk are masked here. The TPU kernel's VMEM budget (_fused_block_q)
// and 128-lane head padding are TPU layout and are not carried over.
//
// Bound: operations. One backward does 2 B nh Nq Nk (2 dq + 2 dv) flops (dv,
// dpn, dq, dk; no logits) and moves q, k, v, do, dq, dk, dv once and e
// (B nh Nq Nk elements) once: MViTv2-S at 16 clips needs about 1,060 GFLOP
// (16 ms at the H100's 67 TFLOP/s of fp32 outside the tensor cores) against
// 4.8 GB of fp32 e plus about 2 GB of the rest (2.1 ms at 3.35 TB/s).
//
// Design: the split of pooled_attention_bwd.cu, with every logit replaced by
// a read of e, in the same thread-to-element map, so that s, r, dl and the
// products are summed in the order of the flash backward (and s in the
// order of the forward): given the same e, the gradients are bit-equal to
// the flash backward kernel's.
//   A (rows): one block per 64-row q tile reads its e rows three times: s,
//     then r (with dpn from a v chunk), then dl (dpn again) and dq = dl k
//     over the 64-key chunks; it writes dq and s and r (fp32 (B, nh, Nq)).
//   B (keys): one block per 64-key chunk loops over every q tile, rebuilds
//     dl from e, the stored s and r and a recomputed dpn, and accumulates dk
//     and dv in fp32 registers: deterministic, no atomics.
// Neither kernel recomputes a logit: A needs no q, B no k. Tiles are fp32 in
// shared memory and every product is an fp32 FMA loop on a 16x16 thread grid
// (each thread a 4x4 tile), on the CUDA cores: the simple first version, far
// from the tensor-core bound; mma/wgmma tiles are later work.

#include <math.h>

#include "pooled_attention_common.cuh"

#define PF_BQ 64          // q rows per tile
#define PF_BK 64          // keys per chunk
#define PF_THREADS 256    // 16 x 16 threads
#define PF_MAX_DQ 192
#define PF_MAX_DV 128
#define PF_P_STRIDE (PF_BK + 16)  // rows 16 banks apart: no conflicts

// Kernel A: per (q tile, head, batch) s, r and dq.
template <typename T, int kDqPT>
__global__ void __launch_bounds__(PF_THREADS, 1)
fused_bwd_rows_kernel(const T* __restrict__ k, const T* __restrict__ v,
                      const T* __restrict__ dout, const T* __restrict__ e,
                      T* __restrict__ dq_out, float* __restrict__ s_out,
                      float* __restrict__ r_out, int nq, int nk, int nh, int dq,
                      int dv) {
  extern __shared__ float smem[];
  const int dqs = dq | 1;
  const int dvs = dv | 1;
  float* do_s = smem;                       // [PF_BQ][dvs]
  float* k_s = do_s + PF_BQ * dvs;          // [PF_BK][dqs]
  float* v_s = k_s + PF_BK * dqs;           // [PF_BK][dvs]
  float* p_s = v_s + PF_BK * dvs;           // [PF_BQ][PF_P_STRIDE]
  float* s_s = p_s + PF_BQ * PF_P_STRIDE;   // [PF_BQ]

  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const int q0 = blockIdx.x * PF_BQ;
  const int h = blockIdx.y;
  const int64_t b = blockIdx.z;
  const T* kb = k + (b * nk * nh + h) * dq;
  const T* vb = v + (b * nk * nh + h) * dv;
  const T* dob = dout + (b * nq * nh + h) * dv;
  const int64_t stat0 = (b * nh + h) * nq;
  const T* tag = nullptr;  // selects round_as for T

  load_tile<PF_THREADS>(do_s, dob, q0, PF_BQ, nq, nh, dv, dvs);
  bool row_ok[4];
  const T* er[4];  // the thread's e rows; rows >= nq are never read
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    row_ok[i] = row < nq;
    er[i] = e + (stat0 + (row_ok[i] ? row : 0)) * static_cast<int64_t>(nk);
  }

  // s, summed in the forward's order: thread tx takes keys tx + 16 j of
  // each chunk, then the 16 threads of a row reduce.
  float s[4] = {0.f, 0.f, 0.f, 0.f};
  for (int k0 = 0; k0 < nk; k0 += PF_BK) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int key = k0 + tx + 16 * j;
        if (row_ok[i] && key < nk) s[i] += load_f(er[i] + key);
      }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) s[i] = fmaxf(row_sum16(s[i]), 1e-30f);
  if (tx == 0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) s_s[ty + 16 * i] = s[i];
  }
  __syncthreads();
  normalize_do<PF_BQ, PF_THREADS>(do_s, dvs, s_s, tag);

  // r = sum dpn * e.
  float r[4] = {0.f, 0.f, 0.f, 0.f};
  float dp[4][4];
  for (int k0 = 0; k0 < nk; k0 += PF_BK) {
    __syncthreads();
    load_tile<PF_THREADS>(v_s, vb, k0, PF_BK, nk, nh, dv, dvs);
    __syncthreads();
    dot_tile(do_s, dvs, v_s, dvs, dv, ty, tx, dp);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int key = k0 + tx + 16 * j;
        if (row_ok[i] && key < nk) r[i] += dp[i][j] * load_f(er[i] + key);
      }
  }
  float rs[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    r[i] = row_sum16(r[i]);
    rs[i] = r[i] / s[i];
  }

  // dl, and dq = dl k over the chunks.
  float acc[4][kDqPT];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < kDqPT; ++j) acc[i][j] = 0.f;
  for (int k0 = 0; k0 < nk; k0 += PF_BK) {
    __syncthreads();  // the previous chunk's products are done
    load_tile<PF_THREADS>(k_s, kb, k0, PF_BK, nk, nh, dq, dqs);
    load_tile<PF_THREADS>(v_s, vb, k0, PF_BK, nk, nh, dv, dvs);
    __syncthreads();
    dot_tile(do_s, dvs, v_s, dvs, dv, ty, tx, dp);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int key = k0 + tx + 16 * j;
        float d = 0.f;
        if (row_ok[i] && key < nk)
          d = round_as(load_f(er[i] + key) * (dp[i][j] - rs[i]), tag);
        p_s[(ty + 16 * i) * PF_P_STRIDE + tx + 16 * j] = d;
      }
    }
    __syncthreads();
    for (int kk = 0; kk < PF_BK; ++kk) {
      float a[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = p_s[(ty + 16 * i) * PF_P_STRIDE + kk];
#pragma unroll
      for (int j = 0; j < kDqPT; ++j) {
        const float w = k_s[kk * dqs + tx + 16 * j];  // columns >= dq are dropped
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(a[i], w, acc[i][j]);
      }
    }
  }

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
      s_out[stat0 + row] = s[i];
      r_out[stat0 + row] = r[i];
    }
  }
}

// Kernel B: per (key chunk, head, batch) dk and dv over every q tile.
template <typename T, int kDqPT, int kDvPT>
__global__ void __launch_bounds__(PF_THREADS, 1)
fused_bwd_keys_kernel(const T* __restrict__ q, const T* __restrict__ v,
                      const T* __restrict__ dout, const T* __restrict__ e,
                      T* __restrict__ dk_out, T* __restrict__ dv_out,
                      const float* __restrict__ s_in, const float* __restrict__ r_in,
                      int nq, int nk, int nh, int dq, int dv) {
  extern __shared__ float smem[];
  const int dqs = dq | 1;
  const int dvs = dv | 1;
  float* v_s = smem;                          // [PF_BK][dvs]
  float* q_s = v_s + PF_BK * dvs;             // [PF_BQ][dqs]
  float* do_s = q_s + PF_BQ * dqs;            // [PF_BQ][dvs]
  float* e_s = do_s + PF_BQ * dvs;            // [PF_BQ][PF_P_STRIDE]
  float* dl_s = e_s + PF_BQ * PF_P_STRIDE;    // [PF_BQ][PF_P_STRIDE]
  float* st_s = dl_s + PF_BQ * PF_P_STRIDE;   // [2][PF_BQ]: s, r

  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const int k0 = blockIdx.x * PF_BK;
  const int h = blockIdx.y;
  const int64_t b = blockIdx.z;
  const T* qb = q + (b * nq * nh + h) * dq;
  const T* vb = v + (b * nk * nh + h) * dv;
  const T* dob = dout + (b * nq * nh + h) * dv;
  const int64_t stat0 = (b * nh + h) * nq;
  const T* tag = nullptr;

  load_tile<PF_THREADS>(v_s, vb, k0, PF_BK, nk, nh, dv, dvs);
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

  float dp[4][4];
  for (int q0 = 0; q0 < nq; q0 += PF_BQ) {
    __syncthreads();  // the previous tile's products are done
    load_tile<PF_THREADS>(q_s, qb, q0, PF_BQ, nq, nh, dq, dqs);
    load_tile<PF_THREADS>(do_s, dob, q0, PF_BQ, nq, nh, dv, dvs);
    for (int idx = threadIdx.x; idx < PF_BQ; idx += PF_THREADS) {
      const bool ok = q0 + idx < nq;
      st_s[idx] = ok ? s_in[stat0 + q0 + idx] : 1.f;
      st_s[PF_BQ + idx] = ok ? r_in[stat0 + q0 + idx] : 0.f;
    }
    __syncthreads();
    normalize_do<PF_BQ, PF_THREADS>(do_s, dvs, st_s, tag);
    __syncthreads();
    dot_tile(do_s, dvs, v_s, dvs, dv, ty, tx, dp);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int rr = ty + 16 * i;
      const bool row_ok = q0 + rr < nq;
      const float rs = st_s[PF_BQ + rr] / st_s[rr];
      const T* er = e + (stat0 + (row_ok ? q0 + rr : 0)) * static_cast<int64_t>(nk) + k0;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float w = 0.f, d = 0.f;
        if (row_ok && key_ok[j]) {
          w = load_f(er + tx + 16 * j);
          d = round_as(w * (dp[i][j] - rs), tag);
        }
        e_s[rr * PF_P_STRIDE + tx + 16 * j] = w;
        dl_s[rr * PF_P_STRIDE + tx + 16 * j] = d;
      }
    }
    __syncthreads();
    for (int qq = 0; qq < PF_BQ; ++qq) {
      float w[4], d[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        w[i] = e_s[qq * PF_P_STRIDE + ty + 16 * i];
        d[i] = dl_s[qq * PF_P_STRIDE + ty + 16 * i];
      }
#pragma unroll
      for (int j = 0; j < kDvPT; ++j) {
        const float x = do_s[qq * dvs + tx + 16 * j];  // columns >= dv are dropped
#pragma unroll
        for (int i = 0; i < 4; ++i) acc_v[i][j] = fmaf(w[i], x, acc_v[i][j]);
      }
#pragma unroll
      for (int j = 0; j < kDqPT; ++j) {
        const float x = q_s[qq * dqs + tx + 16 * j];  // columns >= dq are dropped
#pragma unroll
        for (int i = 0; i < 4; ++i) acc_k[i][j] = fmaf(d[i], x, acc_k[i][j]);
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
  return sizeof(float) * (PF_BQ * dvs + PF_BK * (dqs + dvs) + PF_BQ * PF_P_STRIDE + PF_BQ);
}

static size_t keys_smem(int dq, int dv) {
  const size_t dqs = dq | 1, dvs = dv | 1;
  return sizeof(float) *
         (PF_BK * dvs + PF_BQ * (dqs + dvs) + 2 * PF_BQ * PF_P_STRIDE + 2 * PF_BQ);
}

struct FusedBwdArgs {
  const void *q, *k, *v, *dout, *e;
  void *dq, *dk, *dv;
  float *s, *r;
  long long b, nq, nk, nh, dqd, dvd;
  cudaStream_t stream;
};

template <typename T, int kDqPT, int kDvPT>
static int launch(const FusedBwdArgs& a) {
  const int dq = static_cast<int>(a.dqd), dv = static_cast<int>(a.dvd);
  const int nq = static_cast<int>(a.nq), nk = static_cast<int>(a.nk);
  const int nh = static_cast<int>(a.nh);
  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  const T* dout = static_cast<const T*>(a.dout);
  const T* e = static_cast<const T*>(a.e);

  auto rows = fused_bwd_rows_kernel<T, kDqPT>;
  const size_t smem_a = rows_smem(dq, dv);
  cudaError_t err = cudaFuncSetAttribute(
      rows, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem_a));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid_a(static_cast<unsigned>((a.nq + PF_BQ - 1) / PF_BQ),
                    static_cast<unsigned>(a.nh), static_cast<unsigned>(a.b));
  rows<<<grid_a, PF_THREADS, smem_a, a.stream>>>(k, v, dout, e, static_cast<T*>(a.dq),
                                                 a.s, a.r, nq, nk, nh, dq, dv);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  auto keys = fused_bwd_keys_kernel<T, kDqPT, kDvPT>;
  const size_t smem_b = keys_smem(dq, dv);
  err = cudaFuncSetAttribute(keys, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem_b));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid_b(static_cast<unsigned>((a.nk + PF_BK - 1) / PF_BK),
                    static_cast<unsigned>(a.nh), static_cast<unsigned>(a.b));
  keys<<<grid_b, PF_THREADS, smem_b, a.stream>>>(q, v, dout, e, static_cast<T*>(a.dk),
                                                 static_cast<T*>(a.dv), a.s, a.r, nq, nk,
                                                 nh, dq, dv);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
static int dispatch(const FusedBwdArgs& a) {
  if (a.dqd <= 144) return a.dvd <= 96 ? launch<T, 9, 6>(a) : launch<T, 9, 8>(a);
  return a.dvd <= 96 ? launch<T, 12, 6>(a) : launch<T, 12, 8>(a);
}

// dq, dk and dv of the constant-shift softmax(q k^T) v per (batch, head),
// fp32, on `stream`, given the output gradient dout and the forward's saved
// e (b, nh, nq, nk). stats is fp32 scratch of 2 * b * nh * nq floats. All pointers are device pointers to
// contiguous tensors. Returns cudaGetLastError() after the launches, or
// cudaErrorInvalidValue for shapes the kernels do not take (dq > 192,
// dv > 128, grid limits).
extern "C" int sf_pooled_attention_fused_bwd(const void* q, const void* k, const void* v,
                                             const void* dout, const void* e, void* dq,
                                             void* dk, void* dv, void* stats, long long b,
                                             long long nq, long long nk, long long nh,
                                             long long dqd, long long dvd, void* stream) {
  if (b <= 0 || nq <= 0 || nk <= 0 || nh <= 0 || dqd <= 0 || dvd <= 0 ||
      dqd > PF_MAX_DQ || dvd > PF_MAX_DV || b > 65535 || nh > 65535 ||
      nq > 0x7fffffffLL - PF_BQ || nk > 0x7fffffffLL - PF_BK ||
      b * (nq > nk ? nq : nk) * nh * (dqd > dvd ? dqd : dvd) > (1LL << 62) ||
      b * nh * nq > (1LL << 62) / nk)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long plane = b * nh * nq;
  float* st = static_cast<float*>(stats);
  const FusedBwdArgs a{q,  k,  v,  dout, e,   dq,  dk,  dv,  st, st + plane,
                       b, nq, nk, nh,   dqd, dvd, static_cast<cudaStream_t>(stream)};
  return dispatch<float>(a);
}
