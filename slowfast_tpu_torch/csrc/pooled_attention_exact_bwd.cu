// The bf16 exact pooled-attention backward for Hopper (sm_90a) on the tensor
// cores: dq, dk and dv of softmax(q k^T) v per (batch, head), with the
// (Nq, Nk) matrices kept out of device memory.
//
// Replaces slowfast_tpu/ops/pallas_attention.py:58 _bwd_kernel (the
// backward of pooled_attention, TPU.PALLAS_ATTENTION) for bf16: with m and
// s as in the forward, p = exp(l - m) / s, dp = do v^T summed in fp32,
// r = sum dp p, dl = round(p (dp - r)), dq = dl k, dk = dl^T q and
// dv = round(p)^T do, dk and dv summed over every q row in fp32 and rounded
// once at the end ("round" is to bf16; every product is bf16 x bf16 summed
// in fp32). The fp32 instance stays the FMA kernel of
// pooled_attention_bwd.cu. q (B, Nq, nh, dq), k (B, Nk, nh, dq),
// v (B, Nk, nh, dv) and do (B, Nq, nh, dv) are bf16 and contiguous; depths
// are zero-padded to a multiple of 16 in shared memory only, keys >= Nk and
// rows >= Nq are masked here.
//
// Bound: operations, 2 B nh Nq Nk (3 dq + 2 dv) (the logits once, dp, dq,
// dk, dv): 1.36 TFLOP for the 16 blocks of a 16-clip MViTv2-S step, 1.38 ms
// at 989 TFLOP/s of dense bf16. This design does 2 B nh Nq Nk (3 dqp + 2 dvp)
// in the rows kernel (logits and dp twice, dq) and 2 B nh Nq Nk (2 dqp +
// 2 dvp) in the keys kernel: 5 dqp + 4 dvp in all, about 1.9x the bound's
// at MViTv2-S's widths, in exchange for no atomics and no (Nq, Nk) tensor.
//
// Design. The TPU kernel holds the whole pooled K row in VMEM and sums dk
// and dv over its sequential grid. On Hopper K can exceed shared memory
// (Nk = 1569, dq = 132: 414 KB) and blocks run in no order, so the work is
// split in three kernels, deterministic and without atomics:
//   rows  two warpgroups per block, one per 64-row q tile, stream 64-key
//         chunks twice: m, s and r online (the sums behind s and r = sum dp
//         p rescaled when the running max grows, within fp32 rounding of
//         the TPU kernel's sums with the final m), then dl and dq. Writes
//         dq and the fp32 row statistics m, s, r.
//   keys  one warpgroup per (64-key chunk, q slice) computes the
//         transposed products l^T = k q^T and dp^T = v do^T over the q
//         tiles of its slice, rebuilds p and dl from the statistics and
//         accumulates dk and dv in fp32 registers; it writes them as fp32
//         partials of its slice. The q range of each (b, h, key chunk) is
//         cut into slices so that the grid has 8 blocks per SM, four waves
//         at two resident blocks an SM, where the q tiles allow (block 0 of
//         MViTv2-S at 16 clips: 7 key chunks x 1 head x 16 clips = 112
//         blocks alone, 1120 in 10 slices); the last wave's idle share
//         then stays small.
//   sum   adds the slices in a fixed order and rounds once to bf16.
// Both K/V (rows kernel) and Q/dO (keys kernel) stream through two
// shared-memory stages with cp.async, the next one in flight during the
// products. Products (wgmma.mma_async, bf16 -> fp32):
//   l = q k^T, dp = do v^T, l^T = k q^T, dp^T = v do^T:  m64n64k16, both
//       operands from shared memory (K-major);
//   dq += dl k, dk += dl^T q, dv += round(p)^T do:  m64n16k16 per 16 output
//       columns, dl or round(p) from the fp32 accumulators straight into
//       the A registers, the B tile from shared memory (MN-major).
// The rows and keys kernels sum their logits in differently oriented
// fragments, so their dl need not be bit-identical; the kernel is held to
// the plain backward within 2e-2 of each gradient's max (chip_smoke.py).
// Two launches on the same inputs give bit-equal dq, dk and dv.
//
// Resources (ptxas -v for sm_90a, printed by chip_smoke.py's build phase):
// rows kernel 256 threads, 210-230 registers, no spills, dynamic shared
// memory 2 * 64 * 4 (dqp + dvp) bytes (120 KB at dq 132, dv 96): one block
// an SM; keys kernel 128 threads, 166-255 registers (255 at MViTv2-S's
// widths), spills by instance capacity (dq, dv): 4 bytes at (128, 96),
// MViTv2-S's dq 118, and at (128, 128), 24 at (144, 128), 52 at
// (192, 96), 308 at (192, 128), none elsewhere; 2 * 64 * 3 (dqp + dvp)
// bytes plus 1.5 KB of statistics: two blocks an SM. exp is the SFU's
// __expf, as in the forward.

#include "wgmma_common.cuh"

#define EB_MAX_DQ 192
#define EB_MAX_DV 128
#define EB_WGS 2  // warpgroups a rows-kernel block, one 64-row q tile each
#define EB_THREADS (WG_THREADS * EB_WGS)
#define EB_BQ (WG_ROWS * EB_WGS)  // q rows a rows-kernel block

// Rows kernel: per (q tile, head, batch) the row statistics and dq.
template <int kNtq>
__global__ void __launch_bounds__(EB_THREADS)
exact_bwd_rows_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, const bf16* __restrict__ dout,
                      bf16* __restrict__ dq_out, float* __restrict__ m_out,
                      float* __restrict__ s_out, float* __restrict__ r_out, int nq, int nk,
                      int nh, int dq, int dv, int dqp, int dvp, int vec_qk, int vec_v) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int ntq = dqp >> 4;
  unsigned char* q_s = smem;                              // [EB_WGS]
  unsigned char* do_s = q_s + EB_WGS * tile_bytes(dqp);  // [EB_WGS]
  unsigned char* k_s = do_s + EB_WGS * tile_bytes(dvp);  // [2]
  unsigned char* v_s = k_s + 2 * tile_bytes(dqp);        // [2]

  const int wg = threadIdx.x / WG_THREADS;
  const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = blockIdx.x * EB_BQ;
  const int h = blockIdx.y;
  const int64_t b = blockIdx.z;
  const int64_t ldqk = static_cast<int64_t>(nh) * dq, ldv = static_cast<int64_t>(nh) * dv;
  const bf16* kb = k + (b * nk * nh + h) * dq;
  const bf16* vb = v + (b * nk * nh + h) * dv;
  const int nc = (nk + WG_ROWS - 1) / WG_ROWS;
  const int steps = 2 * nc;  // m, s and r, then dl and dq

  for (int w = 0; w < EB_WGS; ++w) {
    load_tile<EB_THREADS>(q_s + w * tile_bytes(dqp), q + (b * nq * nh + h) * dq, ldqk,
                          q0 + w * WG_ROWS, nq, dq, dqp, vec_qk);
    load_tile<EB_THREADS>(do_s + w * tile_bytes(dvp), dout + (b * nq * nh + h) * dv, ldv,
                          q0 + w * WG_ROWS, nq, dv, dvp, vec_v);
  }
  load_tile<EB_THREADS>(k_s, kb, ldqk, 0, nk, dq, dqp, vec_qk);
  load_tile<EB_THREADS>(v_s, vb, ldv, 0, nk, dv, dvp, vec_v);
  cp_async_commit();

  float m[2] = {-INFINITY, -INFINITY}, s[2] = {0.f, 0.f}, r[2] = {0.f, 0.f};
  float inv_s[2] = {0.f, 0.f};
  float acc[kNtq][8];
#pragma unroll
  for (int j = 0; j < kNtq; ++j) zero(acc[j]);
  const uint32_t q_addr = smem_addr(q_s + wg * tile_bytes(dqp));
  const uint32_t do_addr = smem_addr(do_s + wg * tile_bytes(dvp));

  for (int step = 0; step < steps; ++step) {
    const int buf = step & 1;
    __syncthreads();
    if (step + 1 < steps) {
      const int c0 = ((step + 1) % nc) * WG_ROWS;
      load_tile<EB_THREADS>(k_s + (buf ^ 1) * tile_bytes(dqp), kb, ldqk, c0, nk, dq, dqp,
                            vec_qk);
      load_tile<EB_THREADS>(v_s + (buf ^ 1) * tile_bytes(dvp), vb, ldv, c0, nk, dv, dvp,
                            vec_v);
    }
    cp_async_commit();
    cp_async_wait<1>();
    fence_proxy_async();
    __syncthreads();

    const int k0 = (step % nc) * WG_ROWS;
    const uint32_t k_addr = smem_addr(k_s + buf * tile_bytes(dqp));
    float l[32], dp[32];
    zero(l);
    zero(dp);
    fence_regs(l);
    fence_regs(dp);
    wgmma_fence();
    issue_ss(l, q_addr, k_addr, dqp);
    issue_ss(dp, do_addr, smem_addr(v_s + buf * tile_bytes(dvp)), dvp);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(l);
    fence_regs(dp);

    if (step < nc) {  // pass 1: m, s and r online per thread, merged over the quad at the end
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        float cm = -INFINITY;
#pragma unroll
        for (int i = 0; i < 32; ++i)
          if (((i >> 1) & 1) == hh && k0 + 8 * (i >> 2) + 2 * t + (i & 1) < nk)
            cm = fmaxf(cm, l[i]);
        if (cm > m[hh]) {
          const float scale = __expf(m[hh] - cm);
          s[hh] *= scale;
          r[hh] *= scale;
          m[hh] = cm;
        }
#pragma unroll
        for (int i = 0; i < 32; ++i)
          if (((i >> 1) & 1) == hh && k0 + 8 * (i >> 2) + 2 * t + (i & 1) < nk) {
            const float e = __expf(l[i] - m[hh]);
            s[hh] += e;
            r[hh] += dp[i] * e;
          }
      }
      if (step == nc - 1) {
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const float mm = quad_max(m[hh]);
          const float scale = __expf(m[hh] - mm);
          s[hh] = quad_sum(s[hh] * scale);
          inv_s[hh] = 1.f / s[hh];
          r[hh] = quad_sum(r[hh] * scale) * inv_s[hh];
          m[hh] = mm;
        }
      }
      continue;
    }

    // pass 2: p = exp(l - m) / s and dl = round(p (dp - r)), in l's registers
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int hh = (i >> 1) & 1;
      const bool ok = k0 + 8 * (i >> 2) + 2 * t + (i & 1) < nk;
      l[i] = ok ? __expf(l[i] - m[hh]) * inv_s[hh] * (dp[i] - r[hh]) : 0.f;
    }
    uint32_t dla[4][4];
    pack_a(l, dla);
#pragma unroll
    for (int j = 0; j < kNtq; ++j) fence_regs(acc[j]);
    wgmma_fence();
    issue_rs(acc, dla, k_addr, ntq);
    wgmma_commit();
    wgmma_wait_all();
#pragma unroll
    for (int j = 0; j < kNtq; ++j) fence_regs(acc[j]);
  }

  const int64_t stat0 = (b * nh + h) * nq;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = q0 + wg * WG_ROWS + 16 * warp + g + 8 * hh;
    if (row >= nq) continue;
    bf16* out = dq_out + ((b * nq + row) * nh + h) * dq;
#pragma unroll
    for (int j = 0; j < kNtq; ++j)
#pragma unroll
      for (int jj = 0; jj < 2; ++jj)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int col = 16 * j + 8 * jj + 2 * t + c;
          if (col < dq) out[col] = __float2bfloat16_rn(acc[j][4 * jj + 2 * hh + c]);
        }
    if (t == 0) {
      m_out[stat0 + row] = m[hh];
      s_out[stat0 + row] = s[hh];
      r_out[stat0 + row] = r[hh];
    }
  }
}

// Keys kernel: per (key chunk, head, batch x slice) the fp32 partial dk and
// dv over the q tiles [slice * tiles_per_split, ...) of the slice.
template <int kNtq, int kNtv>
__global__ void __launch_bounds__(WG_THREADS)
exact_bwd_keys_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, const bf16* __restrict__ dout,
                      const float* __restrict__ m_in, const float* __restrict__ s_in,
                      const float* __restrict__ r_in, float* __restrict__ dk_part,
                      float* __restrict__ dv_part, int nq, int nk, int nh, int dq, int dv,
                      int dqp, int dvp, int vec_qk, int vec_v, int n_split,
                      int tiles_per_split) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int ntq = dqp >> 4, ntv = dvp >> 4;
  unsigned char* k_s = smem;
  unsigned char* v_s = k_s + tile_bytes(dqp);
  unsigned char* q_s = v_s + tile_bytes(dvp);        // [2]
  unsigned char* do_s = q_s + 2 * tile_bytes(dqp);   // [2]
  float* st_s = reinterpret_cast<float*>(do_s + 2 * tile_bytes(dvp));  // [2][3][64]

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int k0 = blockIdx.x * WG_ROWS;
  const int h = blockIdx.y;
  const int64_t b = blockIdx.z / n_split;
  const int split = blockIdx.z % n_split;
  const int64_t ldqk = static_cast<int64_t>(nh) * dq, ldv = static_cast<int64_t>(nh) * dv;
  const bf16* qb = q + (b * nq * nh + h) * dq;
  const bf16* dob = dout + (b * nq * nh + h) * dv;
  const int64_t stat0 = (b * nh + h) * nq;
  const int n_tiles = (nq + WG_ROWS - 1) / WG_ROWS;
  const int tile0 = split * tiles_per_split;
  const int tile1 = min(n_tiles, tile0 + tiles_per_split);

  auto load_q_tile = [&](int tile, int buf) {
    const int q0 = tile * WG_ROWS;
    load_tile<WG_THREADS>(q_s + buf * tile_bytes(dqp), qb, ldqk, q0, nq, dq, dqp, vec_qk);
    load_tile<WG_THREADS>(do_s + buf * tile_bytes(dvp), dob, ldv, q0, nq, dv, dvp, vec_v);
    float* st = st_s + buf * 3 * WG_ROWS;
    for (int idx = threadIdx.x; idx < 3 * WG_ROWS; idx += WG_THREADS) {
      const int which = idx / WG_ROWS;
      const float* src = (which == 0 ? m_in : which == 1 ? s_in : r_in) + stat0;
      load_row_stat(st + which * WG_ROWS, src, q0, nq, idx % WG_ROWS);
    }
  };

  load_tile<WG_THREADS>(k_s, k + (b * nk * nh + h) * dq, ldqk, k0, nk, dq, dqp, vec_qk);
  load_tile<WG_THREADS>(v_s, v + (b * nk * nh + h) * dv, ldv, k0, nk, dv, dvp, vec_v);
  if (tile0 < tile1) load_q_tile(tile0, 0);
  cp_async_commit();

  float dk_acc[kNtq][8], dv_acc[kNtv][8];
#pragma unroll
  for (int j = 0; j < kNtq; ++j) zero(dk_acc[j]);
#pragma unroll
  for (int j = 0; j < kNtv; ++j) zero(dv_acc[j]);
  const uint32_t k_addr = smem_addr(k_s), v_addr = smem_addr(v_s);
  bool key_ok[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) key_ok[hh] = k0 + 16 * warp + g + 8 * hh < nk;

  for (int tile = tile0; tile < tile1; ++tile) {
    const int buf = (tile - tile0) & 1;
    __syncthreads();
    if (tile + 1 < tile1) load_q_tile(tile + 1, buf ^ 1);
    cp_async_commit();
    cp_async_wait<1>();
    fence_proxy_async();
    __syncthreads();

    const uint32_t q_addr = smem_addr(q_s + buf * tile_bytes(dqp));
    const uint32_t do_addr = smem_addr(do_s + buf * tile_bytes(dvp));
    const float* st = st_s + buf * 3 * WG_ROWS;
    float lt[32], dpt[32];  // rows: keys; columns: q rows of the tile
    zero(lt);
    zero(dpt);
    fence_regs(lt);
    fence_regs(dpt);
    wgmma_fence();
    issue_ss(lt, k_addr, q_addr, dqp);
    issue_ss(dpt, v_addr, do_addr, dvp);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(lt);
    fence_regs(dpt);

    const int q0 = tile * WG_ROWS;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int col = 8 * (i >> 2) + 2 * t + (i & 1);
      float p = 0.f;
      if (key_ok[(i >> 1) & 1] && q0 + col < nq)
        p = __fdividef(__expf(lt[i] - st[col]), st[WG_ROWS + col]);
      lt[i] = p;
      dpt[i] = p * (dpt[i] - st[2 * WG_ROWS + col]);
    }
    uint32_t pa[4][4], dla[4][4];
    pack_a(lt, pa);
    pack_a(dpt, dla);
#pragma unroll
    for (int j = 0; j < kNtv; ++j) fence_regs(dv_acc[j]);
#pragma unroll
    for (int j = 0; j < kNtq; ++j) fence_regs(dk_acc[j]);
    wgmma_fence();
    issue_rs(dv_acc, pa, do_addr, ntv);
    issue_rs(dk_acc, dla, q_addr, ntq);
    wgmma_commit();
    wgmma_wait_all();
#pragma unroll
    for (int j = 0; j < kNtv; ++j) fence_regs(dv_acc[j]);
#pragma unroll
    for (int j = 0; j < kNtq; ++j) fence_regs(dk_acc[j]);
  }

  // Partial of this slice: dk_part[split] is (B, Nk, nh, dq), dv_part[split]
  // (B, Nk, nh, dv), both fp32.
  const int64_t nb = gridDim.z / n_split;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    if (!key_ok[hh]) continue;
    const int key = k0 + 16 * warp + g + 8 * hh;
    float* dkr = dk_part + (((split * nb + b) * nk + key) * nh + h) * dq;
    float* dvr = dv_part + (((split * nb + b) * nk + key) * nh + h) * dv;
#pragma unroll
    for (int jj = 0; jj < 2; ++jj)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
#pragma unroll
        for (int j = 0; j < kNtq; ++j) {
          const int col = 16 * j + 8 * jj + 2 * t + c;
          if (col < dq) dkr[col] = dk_acc[j][4 * jj + 2 * hh + c];
        }
#pragma unroll
        for (int j = 0; j < kNtv; ++j) {
          const int col = 16 * j + 8 * jj + 2 * t + c;
          if (col < dv) dvr[col] = dv_acc[j][4 * jj + 2 * hh + c];
        }
      }
  }
}

static size_t rows_smem(int dqp, int dvp) {
  return static_cast<size_t>((EB_WGS + 2) * (tile_bytes(dqp) + tile_bytes(dvp)));
}

static size_t keys_smem(int dqp, int dvp) {
  return static_cast<size_t>(3 * (tile_bytes(dqp) + tile_bytes(dvp)) +
                             2 * 3 * WG_ROWS * sizeof(float));
}

struct ExactBwdArgs {
  const void *q, *k, *v, *dout;
  void *dq, *dk, *dv;
  float *m, *s, *r, *dk_part, *dv_part;
  long long b, nq, nk, nh, dqd, dvd;
  int dqp, dvp, vec_qk, vec_v, n_split, tiles_per_split;
  cudaStream_t stream;
};

template <int kNtq>
static int launch_rows(const ExactBwdArgs& a) {
  auto kernel = exact_bwd_rows_kernel<kNtq>;
  const size_t smem = rows_smem(a.dqp, a.dvp);
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>((a.nq + EB_BQ - 1) / EB_BQ),
                  static_cast<unsigned>(a.nh), static_cast<unsigned>(a.b));
  kernel<<<grid, EB_THREADS, smem, a.stream>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
      static_cast<const bf16*>(a.v), static_cast<const bf16*>(a.dout), static_cast<bf16*>(a.dq),
      a.m, a.s, a.r, static_cast<int>(a.nq), static_cast<int>(a.nk), static_cast<int>(a.nh),
      static_cast<int>(a.dqd), static_cast<int>(a.dvd), a.dqp, a.dvp, a.vec_qk, a.vec_v);
  return static_cast<int>(cudaGetLastError());
}

template <int kNtq, int kNtv>
static int launch_keys(const ExactBwdArgs& a) {
  auto kernel = exact_bwd_keys_kernel<kNtq, kNtv>;
  const size_t smem = keys_smem(a.dqp, a.dvp);
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>((a.nk + WG_ROWS - 1) / WG_ROWS),
                  static_cast<unsigned>(a.nh), static_cast<unsigned>(a.b * a.n_split));
  kernel<<<grid, WG_THREADS, smem, a.stream>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
      static_cast<const bf16*>(a.v), static_cast<const bf16*>(a.dout), a.m, a.s, a.r,
      a.dk_part, a.dv_part, static_cast<int>(a.nq), static_cast<int>(a.nk),
      static_cast<int>(a.nh), static_cast<int>(a.dqd), static_cast<int>(a.dvd), a.dqp, a.dvp,
      a.vec_qk, a.vec_v, a.n_split, a.tiles_per_split);
  return static_cast<int>(cudaGetLastError());
}

template <int kNtq>
static int launch_keys_dv(const ExactBwdArgs& a) {
  const int ntv = a.dvp / 16;
  if (ntv <= 1) return launch_keys<kNtq, 1>(a);
  if (ntv <= 4) return launch_keys<kNtq, 4>(a);
  if (ntv <= 6) return launch_keys<kNtq, 6>(a);
  return launch_keys<kNtq, 8>(a);
}

template <int kNtq>
static int launch_all(const ExactBwdArgs& a) {
  int err = launch_rows<kNtq>(a);
  if (err != 0) return err;
  err = launch_keys_dv<kNtq>(a);
  if (err != 0) return err;
  err = sum_slices(a.dk_part, a.dk, a.b * a.nk * a.nh * a.dqd, a.n_split, a.stream);
  if (err != 0) return err;
  return sum_slices(a.dv_part, a.dv, a.b * a.nk * a.nh * a.dvd, a.n_split, a.stream);
}

// dq, dk and dv of softmax(q k^T) v per (batch, head), bf16, on `stream`,
// given the output gradient dout, with _bwd_kernel's exact softmax. dqp and
// dvp are dq and dv padded to a multiple of 16 (shared-memory depths). stats
// is fp32 scratch of 3 * b * nh * nq floats (m, s, r); dk_part and dv_part
// are fp32 scratch of n_split * b * nk * nh * dq and * dv floats; the keys
// kernel's slice j takes q tiles [j * tiles_per_split, (j + 1) *
// tiles_per_split). vec_qk (q, k) and vec_v (v, do) are the elements per
// asynchronous copy (8, 4, 2 or 1), which every pointer, depth and row
// stride must be aligned to. All pointers are device pointers to contiguous
// tensors. Returns cudaGetLastError() after the launches, or
// cudaErrorInvalidValue for shapes the kernels do not take (dq > 192,
// dv > 128, grid limits, a q split that misses a tile) or paddings and
// pieces that are not those.
extern "C" int sf_exact_attention_bwd(const void* q, const void* k, const void* v,
                                      const void* dout, void* dq, void* dk, void* dv,
                                      void* stats, void* dk_part, void* dv_part, long long b,
                                      long long nq, long long nk, long long nh, long long dqd,
                                      long long dvd, int dqp, int dvp, int vec_qk, int vec_v,
                                      int n_split, int tiles_per_split, void* stream) {
  const long long n_tiles = (nq + WG_ROWS - 1) / WG_ROWS;
  if (b <= 0 || nq <= 0 || nk <= 0 || nh <= 0 || dqd <= 0 || dvd <= 0 || dqd > EB_MAX_DQ ||
      dvd > EB_MAX_DV || nh > 65535 || b * n_split > 65535 || n_split <= 0 ||
      tiles_per_split <= 0 || static_cast<long long>(n_split) * tiles_per_split < n_tiles ||
      static_cast<long long>(n_split - 1) * tiles_per_split >= n_tiles ||
      nq > 0x7fffffffLL - WG_ROWS || nk > 0x7fffffffLL - WG_ROWS ||
      n_split * b * (nq > nk ? nq : nk) * nh * (dqd > dvd ? dqd : dvd) > (1LL << 62) ||
      dqp != pad16(static_cast<int>(dqd)) || dvp != pad16(static_cast<int>(dvd)) ||
      !good_vec(vec_qk) || !good_vec(vec_v))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long plane = b * nh * nq;
  float* st = static_cast<float*>(stats);
  const ExactBwdArgs a{q, k, v, dout, dq, dk, dv, st, st + plane, st + 2 * plane,
                       static_cast<float*>(dk_part), static_cast<float*>(dv_part),
                       b, nq, nk, nh, dqd, dvd, dqp, dvp, vec_qk, vec_v, n_split,
                       tiles_per_split,
                       static_cast<cudaStream_t>(stream)};
  const int ntq = dqp / 16;
  if (ntq <= 2) return launch_all<2>(a);
  if (ntq <= 8) return launch_all<8>(a);
  if (ntq <= 9) return launch_all<9>(a);
  return launch_all<12>(a);
}
