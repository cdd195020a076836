// The bf16 exact pooled-attention forward for Hopper (sm_90a) on the tensor
// cores: out = softmax(q k^T) v per (batch, head) with the max-subtracted
// softmax, the (Nq, Nk) matrix kept out of device memory.
//
// Replaces slowfast_tpu/ops/pallas_attention.py:39 _fwd_kernel
// (pooled_attention :171, TPU.PALLAS_ATTENTION) for bf16: l = q k^T (keys
// >= Nk masked), m = max l, p = exp(l - m) in fp32, s = sum p from the
// unrounded p, o = (round(p) v) / s, every product bf16 x bf16 summed in
// fp32. The fp32 instance stays the FMA kernel of pooled_attention.cu (the
// tensor cores have no full-fp32 product). q (B, Nq, nh, dq) and k
// (B, Nk, nh, dq) arrive pre-scaled and rel-pos augmented, v is
// (B, Nk, nh, dv); all bf16 and contiguous. The real dq, dv, Nq and Nk are
// taken: depths are zero-padded to a multiple of 16 in shared memory only
// (dq 118 -> 128, 132 -> 144, 20 and 24 -> 32; dv 12 -> 16), keys >= Nk get
// no weight (their V rows are zero-filled), rows >= Nq are never stored.
//
// Bound: operations, 2 B nh Nq Nk (dq + dv); MViTv2-S at B = 8 needs 265
// GFLOP against some 0.2 GB of q, k, v and o, 0.27 ms at the H100's 989
// TFLOP/s of dense bf16. This design does 2 B nh Nq Nk (2 dqp + dvp)
// (q k^T twice, at padded depths), about 1.6x the bound's.
//
// Design. A block of two warpgroups (256 threads) owns two 64-row q tiles,
// one each, and streams 64-key chunks of K (and V), shared by both, through
// two shared-memory stages with cp.async (wgmma_common.cuh), the next chunk
// in flight while the current one is multiplied. Products
// (wgmma.mma_async, bf16 -> fp32):
//   l = q k^T   m64n64k16, q and the K chunk from shared memory (K-major);
//   o += p v    m64n16k16 per 16 columns of dv, round(p) from the fp32
//               accumulator straight into the A registers, V from shared
//               memory (MN-major, imm-trans-b).
// Two passes over the chunks, as _fwd_kernel's rounding needs the final m
// before any p is rounded: pass 1 the row max, pass 2 p, s and o. A single
// online-softmax pass would rescale o after rounding p against a running
// max, which is not _fwd_kernel's rounding; it is not used. exp is the
// SFU's __expf: relative error about |x| 2^-22, far inside the rounding to
// bf16 that follows.
//
// Resources (ptxas -v for sm_90a, printed by chip_smoke.py's build phase):
// 256 threads; 127-204 registers by dv (189 at MViTv2-S's dv 96), no
// spills; dynamic shared memory 2 * 64 * (4 dqp + 2 dvp) bytes (96 KB at
// dq 132, dv 96), so one block an SM.

#include "wgmma_common.cuh"

#define EX_MAX_DQ 256
#define EX_MAX_DV 128
#define EX_WGS 2  // warpgroups a block, each with its own 64 q rows
#define EX_THREADS (WG_THREADS * EX_WGS)
#define EX_BQ (WG_ROWS * EX_WGS)  // q rows a block

// kNtv: capacity in 16-column tiles of dv (o's accumulators); the kernel
// runs dvp / 16 of them.
template <int kNtv>
__global__ void __launch_bounds__(EX_THREADS)
exact_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, bf16* __restrict__ out, int nq, int nk, int nh,
                 int dq, int dv, int dqp, int dvp, int vec_qk, int vec_v) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int ntv = dvp >> 4;
  unsigned char* q_s = smem;                             // [EX_WGS] q tiles
  unsigned char* k_s = q_s + EX_WGS * tile_bytes(dqp);  // [2] K chunks
  unsigned char* v_s = k_s + 2 * tile_bytes(dqp);       // [2] V chunks

  const int wg = threadIdx.x / WG_THREADS;
  const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = blockIdx.x * EX_BQ;
  const int h = blockIdx.y;
  const int64_t b = blockIdx.z;
  const int64_t ldqk = static_cast<int64_t>(nh) * dq, ldv = static_cast<int64_t>(nh) * dv;
  const bf16* qb = q + (b * nq * nh + h) * dq;
  const bf16* kb = k + (b * nk * nh + h) * dq;
  const bf16* vb = v + (b * nk * nh + h) * dv;
  const int nc = (nk + WG_ROWS - 1) / WG_ROWS;
  const int steps = 2 * nc;  // pass 1 (K), then pass 2 (K and V)

  for (int w = 0; w < EX_WGS; ++w)
    load_tile<EX_THREADS>(q_s + w * tile_bytes(dqp), qb, ldqk, q0 + w * WG_ROWS, nq, dq, dqp,
                          vec_qk);
  load_tile<EX_THREADS>(k_s, kb, ldqk, 0, nk, dq, dqp, vec_qk);
  cp_async_commit();

  float m[2] = {-INFINITY, -INFINITY}, s[2] = {0.f, 0.f};
  float o[kNtv][8];
#pragma unroll
  for (int j = 0; j < kNtv; ++j)
#pragma unroll
    for (int i = 0; i < 8; ++i) o[j][i] = 0.f;
  const uint32_t q_addr = smem_addr(q_s + wg * tile_bytes(dqp));

  for (int step = 0; step < steps; ++step) {
    const int buf = step & 1;
    __syncthreads();  // every warp is done with the other stage
    if (step + 1 < steps) {
      const int nxt = step + 1;
      const int c0 = (nxt < nc ? nxt : nxt - nc) * WG_ROWS;
      load_tile<EX_THREADS>(k_s + (buf ^ 1) * tile_bytes(dqp), kb, ldqk, c0, nk, dq, dqp,
                            vec_qk);
      if (nxt >= nc)
        load_tile<EX_THREADS>(v_s + (buf ^ 1) * tile_bytes(dvp), vb, ldv, c0, nk, dv, dvp,
                              vec_v);
    }
    cp_async_commit();
    cp_async_wait<1>();  // this step's stage has landed
    fence_proxy_async();
    __syncthreads();

    const int k0 = (step < nc ? step : step - nc) * WG_ROWS;
    const uint32_t k_addr = smem_addr(k_s + buf * tile_bytes(dqp));
    float l[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) l[i] = 0.f;
    fence_regs(l);
    wgmma_fence();
    for (int kk = 0; kk < dqp / 16; ++kk)
      wgmma_ss_n64(l, desc_kmajor(q_addr + kk * 2 * WG_TILE_CG),
                   desc_kmajor(k_addr + kk * 2 * WG_TILE_CG));
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(l);

    if (step < nc) {  // pass 1: the row max
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int key = k0 + 8 * (i >> 2) + 2 * t + (i & 1);
        if (key < nk) m[(i >> 1) & 1] = fmaxf(m[(i >> 1) & 1], l[i]);
      }
      if (step == nc - 1) {
        m[0] = quad_max(m[0]);
        m[1] = quad_max(m[1]);
      }
      continue;
    }

    // pass 2: p = exp(l - m), s from the unrounded p, o += round(p) v
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int key = k0 + 8 * (i >> 2) + 2 * t + (i & 1);
      const int hh = (i >> 1) & 1;
      float p = 0.f;
      if (key < nk) {
        p = __expf(l[i] - m[hh]);
        s[hh] += p;
      }
      l[i] = p;
    }
    uint32_t pa[4][4];
    pack_a(l, pa);
    const uint32_t v_addr = smem_addr(v_s + buf * tile_bytes(dvp));
#pragma unroll
    for (int j = 0; j < kNtv; ++j) fence_regs(o[j]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int j = 0; j < kNtv; ++j)
        if (j < ntv)
          wgmma_rs_n16(o[j], pa[kk], desc_mnmajor(v_addr + kk * 256 + j * 2 * WG_TILE_CG));
    wgmma_commit();
    wgmma_wait_all();
#pragma unroll
    for (int j = 0; j < kNtv; ++j) fence_regs(o[j]);
  }

#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const float sum = quad_sum(s[hh]);
    const int row = q0 + wg * WG_ROWS + 16 * warp + g + 8 * hh;
    if (row >= nq) continue;
    bf16* ob = out + ((b * nq + row) * nh + h) * dv;
#pragma unroll
    for (int j = 0; j < kNtv; ++j)
#pragma unroll
      for (int jj = 0; jj < 2; ++jj)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int col = 16 * j + 8 * jj + 2 * t + c;
          if (col < dv) ob[col] = __float2bfloat16_rn(o[j][4 * jj + 2 * hh + c] / sum);
        }
  }
}

static size_t fwd_smem(int dqp, int dvp) {
  return static_cast<size_t>((EX_WGS + 2) * tile_bytes(dqp) + 2 * tile_bytes(dvp));
}

template <int kNtv>
static int launch(const void* q, const void* k, const void* v, void* out, long long b,
                  long long nq, long long nk, long long nh, long long dq, long long dv,
                  int dqp, int dvp, int vec_qk, int vec_v, cudaStream_t stream) {
  auto kernel = exact_fwd_kernel<kNtv>;
  const size_t smem = fwd_smem(dqp, dvp);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>((nq + EX_BQ - 1) / EX_BQ),
                  static_cast<unsigned>(nh), static_cast<unsigned>(b));
  kernel<<<grid, EX_THREADS, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(out), static_cast<int>(nq), static_cast<int>(nk), static_cast<int>(nh),
      static_cast<int>(dq), static_cast<int>(dv), dqp, dvp, vec_qk, vec_v);
  return static_cast<int>(cudaGetLastError());
}

// out = softmax(q k^T) v per (batch, head), bf16, on `stream`, with the
// exact softmax of _fwd_kernel. dqp and dvp are dq and dv padded to a
// multiple of 16 (the shared-memory depths). vec_qk and vec_v are the elements per
// asynchronous copy of q/k and of v (8, 4, 2 or 1), which every pointer,
// depth and row stride must be aligned to. All pointers are device pointers
// to contiguous bf16 tensors. Returns cudaGetLastError() after the launch,
// or cudaErrorInvalidValue for shapes the kernel does not take (dq > 256,
// dv > 128, grid limits, sizes whose offsets pass 2^62) or paddings and
// pieces that are not those.
extern "C" int sf_exact_attention_fwd(const void* q, const void* k, const void* v, void* out,
                                      long long b, long long nq, long long nk, long long nh,
                                      long long dq, long long dv, int dqp, int dvp,
                                      int vec_qk, int vec_v, void* stream) {
  if (b <= 0 || nq <= 0 || nk <= 0 || nh <= 0 || dq <= 0 || dv <= 0 || dq > EX_MAX_DQ ||
      dv > EX_MAX_DV || b > 65535 || nh > 65535 || nq > 0x7fffffffLL - WG_ROWS ||
      nk > 0x7fffffffLL - WG_ROWS ||
      b * (nq > nk ? nq : nk) * nh * (dq > dv ? dq : dv) > (1LL << 62) ||
      dqp != pad16(static_cast<int>(dq)) || dvp != pad16(static_cast<int>(dv)) ||
      !good_vec(vec_qk) || !good_vec(vec_v))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int ntv = dvp / 16;
  if (ntv <= 1) return launch<1>(q, k, v, out, b, nq, nk, nh, dq, dv, dqp, dvp, vec_qk, vec_v, s);
  if (ntv <= 4) return launch<4>(q, k, v, out, b, nq, nk, nh, dq, dv, dqp, dvp, vec_qk, vec_v, s);
  if (ntv <= 6) return launch<6>(q, k, v, out, b, nq, nk, nh, dq, dv, dqp, dvp, vec_qk, vec_v, s);
  return launch<8>(q, k, v, out, b, nq, nk, nh, dq, dv, dqp, dvp, vec_qk, vec_v, s);
}
