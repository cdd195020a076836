// The bf16 constant-shift pooled-attention backwards for Hopper (sm_90a) on
// the tensor cores: dq, dk and dv of the clamped constant-shift softmax
// (q k^T) v per (batch, head), with the (Nq, Nk) matrices kept out of device
// memory, in two modes of one template:
//   recompute  replaces slowfast_tpu/ops/pallas_attention.py:392
//              _flash_bwd_kernel (the backward of flash_pooled_attention,
//              the port's default MViT core): e = round(exp(min(l, 50) - 20))
//              from l = q k^T;
//   read       replaces :255 _fused_bwd_kernel (the backward of
//              fused_pooled_attention): e read from the (B, nh, Nq, Nk)
//              tensor that the saved-e forward wrote.
// Both then compute, as the TPU kernels do: s = max(sum e, 1e-30) from the
// rounded e, do_n = round(do / s), dv = e^T do_n, dpn = do_n v^T,
// r = sum dpn e (not the delta trick), dl = round(e (dpn - r / s)),
// dq = dl k, dk = dl^T q, with no derivative of the clamp; dk and dv are
// summed over every q row in fp32 and rounded once ("round" is to bf16;
// every product is bf16 x bf16 summed in fp32). Rows whose every exp
// underflows get a zero dq; subnormal bf16 e stay what they are (expf and
// the rounding keep them, the tensor cores take them). The fp32 instances
// stay the FMA kernels of pooled_attention_bwd.cu and
// pooled_attention_fused_bwd.cu. q (B, Nq, nh, dq), k (B, Nk, nh, dq),
// v (B, Nk, nh, dv), do (B, Nq, nh, dv) and e are bf16 and contiguous;
// depths are zero-padded to a multiple of 16 in shared memory only, keys
// >= Nk and rows >= Nq are masked here.
//
// Bound. recompute: operations, 2 B nh Nq Nk (3 dq + 2 dv) (the logits
// once, dpn, dq, dk, dv): 1.36 TFLOP for the 16 blocks of a 16-clip
// MViTv2-S step, 1.38 ms at 989 TFLOP/s of dense bf16. read: bytes, e
// (2 B nh Nq Nk bytes, 2.4 GB a step) read once besides q, k, v, do and the
// gradients: 1.35 ms at 3.35 TB/s. This design does 2 B nh Nq Nk
// (4 dqp + 2 dvp) in the rows kernel (the logits three times, dpn twice,
// dq) and 2 B nh Nq Nk (2 dqp + 2 dvp) in the keys kernel when it
// recomputes, about 2x the bound's operations at MViTv2-S's widths; when it
// reads, it reads e four times (three row passes and the keys kernel), a
// floor of 2.9 ms, in exchange for no atomics and no (Nq, Nk) scratch.
//
// Design: the split of pooled_attention_exact_bwd.cu, in three kernels,
// deterministic and without atomics:
//   rows  two warpgroups a block, one per 64-row q tile, stream 64-key
//         chunks three times, the order of _flash_bwd_kernel: pass 1
//         s = sum of the rounded e; then do_n = round(do / s), written once
//         over the do tile in shared memory (and to a bf16 do_n scratch);
//         pass 2 dpn = do_n v^T and r; pass 3 dpn again, dl into wgmma's A
//         registers and dq += dl k. The online merge of the exact backward
//         does not carry over: do_n is rounded with the final s, so r
//         cannot be rescaled as it goes. Writes dq and r / s (fp32), the
//         value that both kernels subtract.
//   keys  one warpgroup per (64-key chunk, q slice of keys_split) computes
//         the transposed products e^T (from l^T = k q^T or the e tensor)
//         and dpn^T = v do_n^T over the q tiles of its slice, rebuilds dl
//         from r / s, accumulates dv += e^T do_n and dk += dl^T q in fp32
//         registers and writes them as fp32 partials of its slice.
//   sum   adds the slices in a fixed order and rounds once to bf16.
// K/V (rows kernel) and Q/do_n (keys kernel) stream through two
// shared-memory stages with cp.async (wgmma_common.cuh). The e tensor's rows
// are Nk elements long, and Nk is odd in every MViTv2-S block, so a row
// starts only 2-byte aligned: each 64-key row segment is staged through
// shared memory as the 16-byte-aligned 72-element window that holds it
// (cp.async, 16-byte pieces, zero-filled past Nk and Nq), read at the row's
// offset into the window in the accumulator's layout (transposed in the
// keys kernel). Products (wgmma.mma_async, bf16 -> fp32): l, dpn, l^T and
// dpn^T m64n64k16 with both operands from shared memory (K-major); dq, dk
// and dv m64n16k16 per 16 output columns, e or dl from the fp32 registers
// straight into the A registers, the B tile MN-major. The two kernels sum
// their logits in differently oriented fragments, so in the recompute mode
// their e need not be bit-identical; the kernels are held to the plain
// backwards within 2e-2 of each gradient's max (chip_smoke.py). Two
// launches on the same inputs give bit-equal dq, dk and dv. exp is the
// accurate expf, as in the forward (pooled_attention_flash.cu), so a
// recomputed e rounds as the forward's did.
//
// Resources: ptxas -v for sm_90a, printed by chip_smoke.py's build phase.
// Dynamic shared memory, rows kernel 2 * 64 * 4 (dqp + dvp) bytes
// (recompute) or 2 * 64 * (2 dqp + 4 dvp) + 36 KB (read), one block an SM
// at MViTv2-S's widths; keys kernel 3 * 64 * 2 (dqp + dvp) bytes
// (recompute) or 64 * 2 (2 dqp + 3 dvp) + 18 KB (read), two blocks an SM.

#include "wgmma_common.cuh"

#define FB_MAX_DQ 192
#define FB_MAX_DV 128
#define FB_WGS 2  // warpgroups a rows-kernel block, one 64-row q tile each
#define FB_THREADS (WG_THREADS * FB_WGS)
#define FB_BQ (WG_ROWS * FB_WGS)  // q rows a rows-kernel block

// e = round(exp(min(l, 50) - 20)), as the bf16 value in fp32.
__device__ __forceinline__ float flash_e(float l) {
  return __bfloat162float(__float2bfloat16_rn(expf(fminf(l, 50.f) - 20.f)));
}

// Keys [k0, k0 + 64) of e rows [r0, r0 + 64) of one (batch, head) plane
// (row0: the plane's first row in e, rows >= nq zero-filled) into `tile`:
// row r holds the 72 elements from key k0 - e_shift(row0 + r0 + r, nk) on,
// keys >= nk zero-filled. Consecutive threads take consecutive pieces of
// a row.
template <int kThreads>
__device__ __forceinline__ void load_e_tile(unsigned char* tile, const bf16* e, int64_t row0,
                                            int r0, int nq, int nk, int k0) {
  const uint32_t base = smem_addr(tile);
  for (int idx = threadIdx.x; idx < WG_ROWS * E_WIN_PIECES; idx += kThreads) {
    const int r = idx / E_WIN_PIECES, p = idx % E_WIN_PIECES;
    int valid = 0;
    const bf16* src = e;
    if (r0 + r < nq) {
      const int64_t row = row0 + r0 + r;
      const int key0 = k0 - e_shift(row, nk) + 8 * p;  // may be < 0: the previous row's tail
      valid = min(max(nk - key0, 0), 8);
      if (valid > 0) src = e + row * nk + key0;
    }
    copy_piece<8>(tile, base, (r * E_WIN_PIECES + p) * 16, src, valid);
  }
}

// Rows kernel: per (q tile, head, batch) dq, do_n and r / s.
template <bool kRead, int kNtq>
__global__ void __launch_bounds__(FB_THREADS)
flash_bwd_rows_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, const bf16* __restrict__ dout,
                      const bf16* __restrict__ e, bf16* __restrict__ dq_out,
                      bf16* __restrict__ don_out, float* __restrict__ rs_out, int nq, int nk,
                      int nh, int dq, int dv, int dqp, int dvp, int vec_qk, int vec_v) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int ntq = dqp >> 4;
  unsigned char* do_s = smem;                             // [FB_WGS] do, then do_n
  unsigned char* k_s = do_s + FB_WGS * tile_bytes(dvp);  // [2]
  unsigned char* v_s = k_s + 2 * tile_bytes(dqp);        // [2]
  unsigned char* x_s = v_s + 2 * tile_bytes(dvp);        // read: [2][FB_WGS] e; else [FB_WGS] q
  float* s_sh = reinterpret_cast<float*>(
      x_s + (kRead ? 2 * FB_WGS * E_WIN_TILE : FB_WGS * tile_bytes(dqp)));  // [FB_WGS][64]

  const int wg = threadIdx.x / WG_THREADS, wt = threadIdx.x % WG_THREADS;
  const int warp = wt >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = blockIdx.x * FB_BQ;
  const int h = blockIdx.y;
  const int64_t b = blockIdx.z;
  const int64_t ldqk = static_cast<int64_t>(nh) * dq, ldv = static_cast<int64_t>(nh) * dv;
  const bf16* kb = k + (b * nk * nh + h) * dq;
  const bf16* vb = v + (b * nk * nh + h) * dv;
  const int64_t row0 = (b * nh + h) * nq;  // this plane's first row of e and of r / s
  const int nc = (nk + WG_ROWS - 1) / WG_ROWS;
  const int steps = 3 * nc;  // s, then r, then dl and dq

  // The tiles of step `st` (pass st / nc, key chunk st % nc) into stage `buf`.
  auto load_step = [&](int st, int buf) {
    const int pass = st / nc, c0 = (st % nc) * WG_ROWS;
    if (kRead) {
      for (int w = 0; w < FB_WGS; ++w)
        load_e_tile<FB_THREADS>(x_s + (buf * FB_WGS + w) * E_WIN_TILE, e, row0,
                                q0 + w * WG_ROWS, nq, nk, c0);
    }
    if (!kRead || pass == 2)
      load_tile<FB_THREADS>(k_s + buf * tile_bytes(dqp), kb, ldqk, c0, nk, dq, dqp, vec_qk);
    if (pass >= 1)
      load_tile<FB_THREADS>(v_s + buf * tile_bytes(dvp), vb, ldv, c0, nk, dv, dvp, vec_v);
  };

  for (int w = 0; w < FB_WGS; ++w) {
    if (!kRead)
      load_tile<FB_THREADS>(x_s + w * tile_bytes(dqp), q + (b * nq * nh + h) * dq, ldqk,
                            q0 + w * WG_ROWS, nq, dq, dqp, vec_qk);
    load_tile<FB_THREADS>(do_s + w * tile_bytes(dvp), dout + (b * nq * nh + h) * dv, ldv,
                          q0 + w * WG_ROWS, nq, dv, dvp, vec_v);
  }
  load_step(0, 0);
  cp_async_commit();

  float s[2] = {0.f, 0.f}, r[2] = {0.f, 0.f}, rs[2] = {0.f, 0.f};
  int shift[2];  // offsets of this thread's two rows in their staged e windows
#pragma unroll
  for (int hh = 0; hh < 2; ++hh)
    shift[hh] = e_shift(row0 + q0 + wg * WG_ROWS + 16 * warp + g + 8 * hh, nk);
  float acc[kNtq][8];
#pragma unroll
  for (int j = 0; j < kNtq; ++j) zero(acc[j]);
  const uint32_t q_addr = smem_addr(x_s + wg * tile_bytes(dqp));  // recompute only
  const uint32_t do_addr = smem_addr(do_s + wg * tile_bytes(dvp));

  for (int step = 0; step < steps; ++step) {
    const int buf = step & 1;
    const int pass = step / nc;
    const int k0 = (step % nc) * WG_ROWS;
    __syncthreads();
    if (step + 1 < steps) load_step(step + 1, buf ^ 1);
    cp_async_commit();
    cp_async_wait<1>();
    fence_proxy_async();
    __syncthreads();

    if (step == nc) {  // do_n = round(do / s) over this warpgroup's do tile, once
      unsigned char* dtile = do_s + wg * tile_bytes(dvp);
      bf16* donb = don_out + (b * nq * nh + h) * dv;
      for (int idx = wt; idx < WG_ROWS * (dvp >> 3); idx += WG_THREADS) {
        const int rr = idx & (WG_ROWS - 1), cg = idx >> 6;
        uint4* piece = reinterpret_cast<uint4*>(dtile + (cg * WG_ROWS + rr) * 16);
        uint4 val = *piece;
        bf16* el = reinterpret_cast<bf16*>(&val);
        const float sr = s_sh[wg * WG_ROWS + rr];
#pragma unroll
        for (int c = 0; c < 8; ++c) el[c] = __float2bfloat16_rn(__bfloat162float(el[c]) / sr);
        *piece = val;
        const int row = q0 + wg * WG_ROWS + rr;
        if (row < nq) {
          bf16* dst = donb + row * ldv + cg * 8;
          if (vec_v == 8 && cg * 8 + 8 <= dv) {
            *reinterpret_cast<uint4*>(dst) = val;
          } else {
            for (int c = 0; c < 8 && cg * 8 + c < dv; ++c) dst[c] = el[c];
          }
        }
      }
      fence_proxy_async();
      __syncthreads();
    }

    float x[32], dp[32];  // e, then dl; dpn
    if (kRead) {
      const bf16* et = reinterpret_cast<const bf16*>(x_s + (buf * FB_WGS + wg) * E_WIN_TILE);
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int hh = (i >> 1) & 1;
        x[i] = __bfloat162float(et[(16 * warp + g + 8 * hh) * E_WIN_LD + 8 * (i >> 2) + 2 * t +
                                   (i & 1) + shift[hh]]);
      }
    }
    if (!kRead || pass >= 1) {
      const uint32_t k_addr = smem_addr(k_s + buf * tile_bytes(dqp));
      if (!kRead) {
        zero(x);
        fence_regs(x);
      }
      zero(dp);
      fence_regs(dp);
      wgmma_fence();
      if (!kRead) issue_ss(x, q_addr, k_addr, dqp);
      if (pass >= 1) issue_ss(dp, do_addr, smem_addr(v_s + buf * tile_bytes(dvp)), dvp);
      wgmma_commit();
      wgmma_wait_all();
      if (!kRead) fence_regs(x);
      fence_regs(dp);
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const bool ok = k0 + 8 * (i >> 2) + 2 * t + (i & 1) < nk;
      x[i] = ok ? (kRead ? x[i] : flash_e(x[i])) : 0.f;
    }

    if (pass == 0) {  // s, per thread, summed over the quad at the end
#pragma unroll
      for (int i = 0; i < 32; ++i) s[(i >> 1) & 1] += x[i];
      if (step == nc - 1) {
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          s[hh] = fmaxf(quad_sum(s[hh]), 1e-30f);
          if (t == 0) s_sh[wg * WG_ROWS + 16 * warp + g + 8 * hh] = s[hh];
        }
      }
      continue;
    }
    if (pass == 1) {  // r = sum dpn e
#pragma unroll
      for (int i = 0; i < 32; ++i) r[(i >> 1) & 1] += dp[i] * x[i];
      if (step == 2 * nc - 1) {
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) rs[hh] = quad_sum(r[hh]) / s[hh];
      }
      continue;
    }

    // pass 3: dl = round(e (dpn - r / s)) into the A registers, dq += dl k
#pragma unroll
    for (int i = 0; i < 32; ++i) x[i] *= dp[i] - rs[(i >> 1) & 1];
    uint32_t dla[4][4];
    pack_a(x, dla);
#pragma unroll
    for (int j = 0; j < kNtq; ++j) fence_regs(acc[j]);
    wgmma_fence();
    issue_rs(acc, dla, smem_addr(k_s + buf * tile_bytes(dqp)), ntq);
    wgmma_commit();
    wgmma_wait_all();
#pragma unroll
    for (int j = 0; j < kNtq; ++j) fence_regs(acc[j]);
  }

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
    if (t == 0) rs_out[row0 + row] = rs[hh];
  }
}

// Keys kernel: per (key chunk, head, batch x slice) the fp32 partial dk and
// dv over the q tiles [slice * tiles_per_split, ...) of the slice.
template <bool kRead, int kNtq, int kNtv>
__global__ void __launch_bounds__(WG_THREADS)
flash_bwd_keys_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, const bf16* __restrict__ don,
                      const bf16* __restrict__ e, const float* __restrict__ rs_in,
                      float* __restrict__ dk_part, float* __restrict__ dv_part, int nq, int nk,
                      int nh, int dq, int dv, int dqp, int dvp, int vec_qk, int vec_v,
                      int n_split, int tiles_per_split) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int ntq = dqp >> 4, ntv = dvp >> 4;
  unsigned char* v_s = smem;
  unsigned char* q_s = v_s + tile_bytes(dvp);          // [2]
  unsigned char* don_s = q_s + 2 * tile_bytes(dqp);    // [2]
  unsigned char* x_s = don_s + 2 * tile_bytes(dvp);    // read: [2] e tiles; else the K tile
  float* st_s = reinterpret_cast<float*>(
      x_s + (kRead ? 2 * E_WIN_TILE : tile_bytes(dqp)));  // [2][64] r / s

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int k0 = blockIdx.x * WG_ROWS;
  const int h = blockIdx.y;
  const int64_t b = blockIdx.z / n_split;
  const int split = blockIdx.z % n_split;
  const int64_t ldqk = static_cast<int64_t>(nh) * dq, ldv = static_cast<int64_t>(nh) * dv;
  const bf16* qb = q + (b * nq * nh + h) * dq;
  const bf16* donb = don + (b * nq * nh + h) * dv;
  const int64_t row0 = (b * nh + h) * nq;
  const int n_tiles = (nq + WG_ROWS - 1) / WG_ROWS;
  const int tile0 = split * tiles_per_split;
  const int tile1 = min(n_tiles, tile0 + tiles_per_split);

  auto load_q_tile = [&](int tile, int buf) {
    const int q0 = tile * WG_ROWS;
    load_tile<WG_THREADS>(q_s + buf * tile_bytes(dqp), qb, ldqk, q0, nq, dq, dqp, vec_qk);
    load_tile<WG_THREADS>(don_s + buf * tile_bytes(dvp), donb, ldv, q0, nq, dv, dvp, vec_v);
    if (kRead) load_e_tile<WG_THREADS>(x_s + buf * E_WIN_TILE, e, row0, q0, nq, nk, k0);
    if (threadIdx.x < WG_ROWS)
      load_row_stat(st_s + buf * WG_ROWS, rs_in + row0, q0, nq, threadIdx.x);
  };

  if (!kRead)
    load_tile<WG_THREADS>(x_s, k + (b * nk * nh + h) * dq, ldqk, k0, nk, dq, dqp, vec_qk);
  load_tile<WG_THREADS>(v_s, v + (b * nk * nh + h) * dv, ldv, k0, nk, dv, dvp, vec_v);
  if (tile0 < tile1) load_q_tile(tile0, 0);
  cp_async_commit();

  float dk_acc[kNtq][8], dv_acc[kNtv][8];
#pragma unroll
  for (int j = 0; j < kNtq; ++j) zero(dk_acc[j]);
#pragma unroll
  for (int j = 0; j < kNtv; ++j) zero(dv_acc[j]);
  const uint32_t v_addr = smem_addr(v_s);
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

    const int q0 = tile * WG_ROWS;
    const uint32_t q_addr = smem_addr(q_s + buf * tile_bytes(dqp));
    const uint32_t don_addr = smem_addr(don_s + buf * tile_bytes(dvp));
    const float* st = st_s + buf * WG_ROWS;
    float et[32], dpt[32];  // rows: keys; columns: q rows of the tile
    if (kRead) {
      const bf16* etile = reinterpret_cast<const bf16*>(x_s + buf * E_WIN_TILE);
      const uint32_t shift0 = static_cast<uint32_t>(row0 + q0) * static_cast<uint32_t>(nk);
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int col = 8 * (i >> 2) + 2 * t + (i & 1);
        const int shift = static_cast<int>((shift0 + col * static_cast<uint32_t>(nk)) & 7u);
        et[i] = __bfloat162float(
            etile[col * E_WIN_LD + 16 * warp + g + 8 * ((i >> 1) & 1) + shift]);
      }
    } else {
      zero(et);
      fence_regs(et);
    }
    zero(dpt);
    fence_regs(dpt);
    wgmma_fence();
    if (!kRead) issue_ss(et, smem_addr(x_s), q_addr, dqp);
    issue_ss(dpt, v_addr, don_addr, dvp);
    wgmma_commit();
    wgmma_wait_all();
    if (!kRead) fence_regs(et);
    fence_regs(dpt);

#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int col = 8 * (i >> 2) + 2 * t + (i & 1);
      float ev = 0.f;
      if (key_ok[(i >> 1) & 1] && q0 + col < nq) ev = kRead ? et[i] : flash_e(et[i]);
      et[i] = ev;
      dpt[i] = ev * (dpt[i] - st[col]);
    }
    uint32_t ea[4][4], dla[4][4];
    pack_a(et, ea);
    pack_a(dpt, dla);
#pragma unroll
    for (int j = 0; j < kNtv; ++j) fence_regs(dv_acc[j]);
#pragma unroll
    for (int j = 0; j < kNtq; ++j) fence_regs(dk_acc[j]);
    wgmma_fence();
    issue_rs(dv_acc, ea, don_addr, ntv);
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

static size_t rows_smem(bool read, int dqp, int dvp) {
  const int x = read ? 2 * FB_WGS * E_WIN_TILE : FB_WGS * tile_bytes(dqp);
  return static_cast<size_t>(FB_WGS * tile_bytes(dvp) + 2 * (tile_bytes(dqp) + tile_bytes(dvp)) +
                             x + FB_WGS * WG_ROWS * sizeof(float));
}

static size_t keys_smem(bool read, int dqp, int dvp) {
  const int x = read ? 2 * E_WIN_TILE : tile_bytes(dqp);
  return static_cast<size_t>(3 * tile_bytes(dvp) + 2 * tile_bytes(dqp) + x +
                             2 * WG_ROWS * sizeof(float));
}

struct FlashBwdArgs {
  const void *q, *k, *v, *dout, *e;
  void *dq, *dk, *dv, *don;
  float *rs, *dk_part, *dv_part;
  long long b, nq, nk, nh, dqd, dvd;
  int dqp, dvp, vec_qk, vec_v, n_split, tiles_per_split;
  cudaStream_t stream;
};

template <bool kRead, int kNtq>
static int launch_rows(const FlashBwdArgs& a) {
  auto kernel = flash_bwd_rows_kernel<kRead, kNtq>;
  const size_t smem = rows_smem(kRead, a.dqp, a.dvp);
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>((a.nq + FB_BQ - 1) / FB_BQ),
                  static_cast<unsigned>(a.nh), static_cast<unsigned>(a.b));
  kernel<<<grid, FB_THREADS, smem, a.stream>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
      static_cast<const bf16*>(a.v), static_cast<const bf16*>(a.dout),
      static_cast<const bf16*>(a.e), static_cast<bf16*>(a.dq), static_cast<bf16*>(a.don),
      a.rs, static_cast<int>(a.nq), static_cast<int>(a.nk), static_cast<int>(a.nh),
      static_cast<int>(a.dqd), static_cast<int>(a.dvd), a.dqp, a.dvp, a.vec_qk, a.vec_v);
  return static_cast<int>(cudaGetLastError());
}

template <bool kRead, int kNtq, int kNtv>
static int launch_keys(const FlashBwdArgs& a) {
  auto kernel = flash_bwd_keys_kernel<kRead, kNtq, kNtv>;
  const size_t smem = keys_smem(kRead, a.dqp, a.dvp);
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>((a.nk + WG_ROWS - 1) / WG_ROWS),
                  static_cast<unsigned>(a.nh), static_cast<unsigned>(a.b * a.n_split));
  kernel<<<grid, WG_THREADS, smem, a.stream>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
      static_cast<const bf16*>(a.v), static_cast<const bf16*>(a.don),
      static_cast<const bf16*>(a.e), a.rs, a.dk_part, a.dv_part, static_cast<int>(a.nq),
      static_cast<int>(a.nk), static_cast<int>(a.nh), static_cast<int>(a.dqd),
      static_cast<int>(a.dvd), a.dqp, a.dvp, a.vec_qk, a.vec_v, a.n_split, a.tiles_per_split);
  return static_cast<int>(cudaGetLastError());
}

template <bool kRead, int kNtq>
static int launch_all(const FlashBwdArgs& a) {
  int err = launch_rows<kRead, kNtq>(a);
  if (err != 0) return err;
  const int ntv = a.dvp / 16;
  if (ntv <= 1) err = launch_keys<kRead, kNtq, 1>(a);
  else if (ntv <= 4) err = launch_keys<kRead, kNtq, 4>(a);
  else if (ntv <= 6) err = launch_keys<kRead, kNtq, 6>(a);
  else err = launch_keys<kRead, kNtq, 8>(a);
  if (err != 0) return err;
  err = sum_slices(a.dk_part, a.dk, a.b * a.nk * a.nh * a.dqd, a.n_split, a.stream);
  if (err != 0) return err;
  return sum_slices(a.dv_part, a.dv, a.b * a.nk * a.nh * a.dvd, a.n_split, a.stream);
}

template <bool kRead>
static int flash_bwd(const FlashBwdArgs& a) {
  const long long n_tiles = (a.nq + WG_ROWS - 1) / WG_ROWS;
  if (a.b <= 0 || a.nq <= 0 || a.nk <= 0 || a.nh <= 0 || a.dqd <= 0 || a.dvd <= 0 ||
      a.dqd > FB_MAX_DQ || a.dvd > FB_MAX_DV || a.nh > 65535 || a.b * a.n_split > 65535 ||
      a.n_split <= 0 || a.tiles_per_split <= 0 ||
      static_cast<long long>(a.n_split) * a.tiles_per_split < n_tiles ||
      static_cast<long long>(a.n_split - 1) * a.tiles_per_split >= n_tiles ||
      a.nq > 0x7fffffffLL - WG_ROWS || a.nk > 0x7fffffffLL - WG_ROWS ||
      a.n_split * a.b * (a.nq > a.nk ? a.nq : a.nk) * a.nh * (a.dqd > a.dvd ? a.dqd : a.dvd) >
          (1LL << 62) ||
      a.b * a.nh * a.nq * a.nk > (1LL << 62) ||
      a.dqp != pad16(static_cast<int>(a.dqd)) || a.dvp != pad16(static_cast<int>(a.dvd)) ||
      !good_vec(a.vec_qk) || !good_vec(a.vec_v) ||
      (kRead && reinterpret_cast<uintptr_t>(a.e) % 16 != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  const int ntq = a.dqp / 16;
  if (ntq <= 2) return launch_all<kRead, 2>(a);
  if (ntq <= 8) return launch_all<kRead, 8>(a);
  if (ntq <= 9) return launch_all<kRead, 9>(a);
  return launch_all<kRead, 12>(a);
}

// dq, dk and dv of the constant-shift softmax(q k^T) v per (batch, head),
// bf16, on `stream`, given the output gradient dout, with
// _flash_bwd_kernel's numerics; e is recomputed from q and k. dqp and dvp
// are dq and dv padded to a multiple of 16 (shared-memory depths). rs is
// fp32 scratch of b * nh * nq floats (r / s), don bf16 scratch shaped as
// dout (do_n); dk_part and dv_part are fp32 scratch of n_split * b * nk *
// nh * dq and * dv floats; the keys kernel's slice j takes q tiles
// [j * tiles_per_split, (j + 1) * tiles_per_split). vec_qk (q, k) and vec_v
// (v, dout, don) are the elements per asynchronous copy (8, 4, 2 or 1),
// which every pointer, depth and row stride must be aligned to. All
// pointers are device pointers to contiguous tensors. Returns
// cudaGetLastError() after the launches, or cudaErrorInvalidValue for
// shapes the kernels do not take (dq > 192, dv > 128, grid limits, a q
// split that misses a tile) or paddings and pieces that are not those.
extern "C" int sf_flash_attention_bwd_tc(const void* q, const void* k, const void* v,
                                         const void* dout, void* dq, void* dk, void* dv,
                                         void* rs, void* don, void* dk_part, void* dv_part,
                                         long long b, long long nq, long long nk, long long nh,
                                         long long dqd, long long dvd, int dqp, int dvp,
                                         int vec_qk, int vec_v, int n_split,
                                         int tiles_per_split, void* stream) {
  const FlashBwdArgs a{q, k, v, dout, nullptr, dq, dk, dv, don,
                       static_cast<float*>(rs), static_cast<float*>(dk_part),
                       static_cast<float*>(dv_part), b, nq, nk, nh, dqd, dvd, dqp, dvp,
                       vec_qk, vec_v, n_split, tiles_per_split,
                       static_cast<cudaStream_t>(stream)};
  return flash_bwd<false>(a);
}

// The same with _fused_bwd_kernel's e read from `e`, (b, nh, nq, nk) bf16
// as the saved-e forward wrote it, 16-byte aligned.
extern "C" int sf_fused_attention_bwd_tc(const void* q, const void* k, const void* v,
                                         const void* dout, const void* e, void* dq, void* dk,
                                         void* dv, void* rs, void* don, void* dk_part,
                                         void* dv_part, long long b, long long nq, long long nk,
                                         long long nh, long long dqd, long long dvd, int dqp,
                                         int dvp, int vec_qk, int vec_v, int n_split,
                                         int tiles_per_split, void* stream) {
  const FlashBwdArgs a{q, k, v, dout, e, dq, dk, dv, don,
                       static_cast<float*>(rs), static_cast<float*>(dk_part),
                       static_cast<float*>(dv_part), b, nq, nk, nh, dqd, dvd, dqp, dvp,
                       vec_qk, vec_v, n_split, tiles_per_split,
                       static_cast<cudaStream_t>(stream)};
  return flash_bwd<true>(a);
}
