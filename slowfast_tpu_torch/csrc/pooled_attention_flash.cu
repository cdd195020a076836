// The bf16 constant-shift pooled-attention forward for Hopper (sm_90a) on
// the tensor cores: out = (e v) / s per (batch, head), with the (Nq, Nk)
// matrix kept out of device memory, in two modes of one template:
//   flash    replaces slowfast_tpu/ops/pallas_attention.py:375
//            _flash_fwd_kernel (flash_pooled_attention, the port's default
//            MViT core);
//   saved-e  replaces :237 _fused_fwd_kernel (fused_pooled_attention): the
//            same output, bit-equal to the flash mode's, and e written as
//            (B, nh, Nq, Nk) bf16 for the backward that reads it
//            (pooled_attention_flash_bwd.cu).
// Both compute, as the TPU kernels do: l = q k^T, e = round(exp(min(l, 50)
// - 20)) (the accurate expf, as the backward's flash_e, so its recomputed e
// rounds alike), s = max(sum e, 1e-30) from the rounded e,
// o = (e v) / s; every product bf16 x bf16 summed in fp32. Rows whose every
// exp underflows give s = 1e-30 and a zero output; subnormal e stay what
// they are. The fp32 instances stay the FMA kernel of pooled_attention.cu
// (the tensor cores have no full-fp32 product). q (B, Nq, nh, dq) and k
// (B, Nk, nh, dq) arrive pre-scaled and rel-pos augmented, v is
// (B, Nk, nh, dv); all bf16 and contiguous. The real dq, dv, Nq and Nk are
// taken: depths are zero-padded in shared memory (and in the packed k and
// v scratch), rows >= Nq are never stored. Keys >= Nk get e = 0 by their
// index: their K rows are zero-filled, and a zero logit would give
// e = exp(-20), not 0 (the exact kernel's max does not arise here).
//
// Bound. flash: operations, 2 B nh Nq Nk (dq + dv), 265 GFLOP for one
// MViTv2-S forward at B = 8 against some 0.2 GB of q, k, v and o: 0.27 ms
// at the H100's 989 TFLOP/s of dense bf16. saved-e: bytes, as it also
// writes e, 2 B nh Nq Nk bytes (2.4 GB for the 16 blocks of a 16-clip
// step, 0.72 ms at 3.35 TB/s, against 0.54 ms of operations).
//
// Design. One warpgroup (128 threads) a block owns a 64-row q tile and
// visits the 64-key chunks of K and V once (the constant shift needs no
// row max, so no second pass as in pooled_attention_exact.cu); two blocks
// or three share an SM, so one block's exponentials run beside another's
// products. Products (wgmma.mma_async, bf16 -> fp32):
//   l = q k^T  m64n64k16 per k16 step, q and the K chunk from shared memory
//              (K-major): the fragment and k-step order of the rows kernel
//              of pooled_attention_flash_bwd.cu, so the backward's
//              recomputed e comes from identical sums;
//   o += e v   one m64nNk16 per k16 step of the chunk, N = dv padded to 16,
//              64, 96 or 128, the rounded e from the fp32 accumulator
//              straight into the A registers.
// Step c issues chunk c's q k^T and then chunk c - 1's e v, waits for the
// first only (wgmma.wait_group 1), and computes chunk c's e while the
// tensor cores run the second. What development builds of this plan showed
// on an H100 SXM, and what the design does about it:
//   * The key mask as a branch around each exp serialized the 32
//     exponentials of a thread: every exp is now taken and the masked ones
//     are zeroed by a select, and the rounding to bf16 is done on the bits
//     (flash_e_bits).
//   * K's rows are 4-byte aligned (236 bytes at dq 118), so cp.async copied
//     them in 4-byte pieces, eight rows a warp instruction, and issuing the
//     copies took much of each chunk: k and v are packed once a call into
//     tile order (pack_tiles_kernel, one launch for both), so each chunk is
//     one contiguous block copied in 16-byte pieces. q, read once a block,
//     is copied straight: packing it too cost more than it saved.
//   * ptxas serializes wgmma groups it cannot follow: the q k^T step count
//     is a template constant, so it can (no C7514 warning in the build log).
//   * Two warpgroups under one __syncthreads a chunk ran in lockstep; one
//     warpgroup a block, two or three blocks an SM, overlap better.
// The work is 2 B nh Nq Nk (dqp + N): 1.15x the bound's operations at
// MViTv2-S's widths (dq 118 -> 128 and 132 -> 144, dv 96). K and V stream
// through two-stage cp.async rings, K one chunk ahead, V loaded a step
// before its product, under one __syncthreads a step.
// Saved-e mode: e's rows are Nk elements long and Nk is odd in every
// MViTv2-S block, so a row starts only 2-byte aligned (no TMA store, and
// 2-byte stores straight from the fragment would touch 8 rows an
// instruction). Each chunk's rounded tile is staged in shared memory, each
// row at its offset in the 16-byte-aligned 72-element window that holds it
// (the mirror of the backward's read), and written as whole 16-byte pieces,
// coalesced along the rows; only the keys of the two partial pieces at a
// row's ends are written one element a thread. Each e is stored from the
// register that feeds s and e v.
//
// Resources (ptxas -v for sm_90a, printed by chip_smoke.py's build phase):
// 128 threads; dynamic shared memory 128 (3 Dq + 2 N) bytes, Dq the padded
// q k^T depth, plus 9 KB in the saved-e mode (78 KB at dq 132, dv 96).
// Template instances: dq padded to 32, 128, 144, 192 or 256 (the depth of
// the q and K tiles, zero past dq; the q k^T step count is then a constant)
// by N.

#include "wgmma_common.cuh"

#define FF_MAX_DQ 256
#define FF_MAX_DV 128
#define FF_STAGES 2  // K and V chunks in shared memory

// ---------------------------------------------------------------------------
// Packing. k and v are copied once a call into tile order: for each (batch,
// head), 64-row tiles of depth dp (zero past the keys and the depth), each
// laid out as wgmma_common.cuh's shared-memory tile. A chunk is then one
// contiguous block of 128 dp bytes, which every q tile's block copies to
// shared memory in 16-byte pieces with no index arithmetic: k's rows are
// only 4-byte aligned (236 bytes at dq 118), and copying them straight took
// 4-byte pieces, eight rows a warp instruction. q, read once a block, is
// copied straight (load_tile).

// Elements of one packed tile of depth dp.
__host__ __device__ __forceinline__ int64_t tile_elems(int dp) { return WG_ROWS * dp; }

struct PackJob {
  const bf16* src;  // (B, n, nh, d)
  bf16* dst;        // (B, nh, ceil(n / 64), 64 dp) in tile order
  int d, dp, vec;   // vec: elements a load, the widest that the base, d and row stride allow
};

// One block a (tile, batch x head, job): the tile from rows [64 tile,
// 64 tile + 64), one 16-byte piece a thread at a time.
__global__ void __launch_bounds__(256)
pack_tiles_kernel(PackJob k, PackJob v, int n, int nh) {
  const PackJob& job = blockIdx.z == 0 ? k : v;
  const int tile = blockIdx.x, ntiles = gridDim.x, d = job.d, dp = job.dp, vec = job.vec;
  const int64_t bh = blockIdx.y, b = bh / nh, h = bh % nh;
  const int64_t ld = static_cast<int64_t>(nh) * d;
  const bf16* head = job.src + (b * n * nh + h) * d;
  uint4* out = reinterpret_cast<uint4*>(job.dst + (bh * ntiles + tile) * tile_elems(dp));
  for (int p = threadIdx.x; p < WG_ROWS * (dp >> 3); p += blockDim.x) {
    const int r = p & (WG_ROWS - 1), cg = p >> 6;  // piece p: row r, columns 8 cg ..
    const int row = tile * WG_ROWS + r;
    uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
    for (int c = 0; c < 8; ++c) {  // vec divides d: a load is all in or all out
      const int col = 8 * cg + c;
      if (c % vec != 0 || row >= n || col >= d) continue;
      const bf16* from = head + row * ld + col;
      if (vec == 8) {
        const uint4 x = *reinterpret_cast<const uint4*>(from);
        w[0] = x.x, w[1] = x.y, w[2] = x.z, w[3] = x.w;
      } else if (vec == 4) {
        const uint2 x = *reinterpret_cast<const uint2*>(from);
        w[c / 2] = x.x, w[c / 2 + 1] = x.y;
      } else if (vec == 2) {
        w[c / 2] = *reinterpret_cast<const uint32_t*>(from);
      } else {
        w[c / 2] |= static_cast<uint32_t>(__bfloat16_as_ushort(*from)) << (16 * (c & 1));
      }
    }
    out[cg * WG_ROWS + r] = make_uint4(w[0], w[1], w[2], w[3]);
  }
}

static int pack_kv(const PackJob& k, const PackJob& v, long long b, long long nk, long long nh,
                   cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned>((nk + WG_ROWS - 1) / WG_ROWS),
                  static_cast<unsigned>(b * nh), 2);
  pack_tiles_kernel<<<grid, 256, 0, stream>>>(k, v, static_cast<int>(nk), static_cast<int>(nh));
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// The forward.

// A packed tile of depth kDp at src into the shared tile at dst: kDp / 16
// cp.async of 16 bytes a thread, consecutive threads on consecutive pieces.
template <int kDp>
__device__ __forceinline__ void load_packed(unsigned char* dst, const bf16* src) {
  const uint32_t base = smem_addr(dst) + 16 * threadIdx.x;
  const unsigned char* from = reinterpret_cast<const unsigned char*>(src) + 16 * threadIdx.x;
#pragma unroll
  for (int j = 0; j < kDp / 16; ++j)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(base + 16 * WG_THREADS * j),
                 "l"(from + 16 * WG_THREADS * j) : "memory");
}

// d (64 x 64) = a b^T over kNtq k16 steps, both tiles K-major: issue_ss
// with its step count known to the compiler, so ptxas can follow the
// wgmma groups that stay in flight.
template <int kNtq>
__device__ __forceinline__ void issue_logits(float (&d)[32], uint32_t a_addr, uint32_t b_addr) {
#pragma unroll
  for (int kk = 0; kk < kNtq; ++kk)
    wgmma_ss_n64(d, desc_kmajor(a_addr + kk * 2 * WG_TILE_CG),
                 desc_kmajor(b_addr + kk * 2 * WG_TILE_CG));
}

// o (64 x 16 kNtv) += e (64 x 64, A fragments) v (the V chunk at v_addr).
template <int kNtv>
__device__ __forceinline__ void issue_ev(float (&o)[kNtv * 8], const uint32_t (&ea)[4][4],
                                         uint32_t v_addr) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) wgmma_rs_wide<kNtv>(o, ea[kk], desc_mnmajor(v_addr + kk * 256));
}

// The backward's flash_e (pooled_attention_flash_bwd.cu) without a
// conversion instruction: the rounding to bf16 (to nearest, ties to even)
// done on the bits, which gives __float2bfloat16_rn's value for every
// finite or infinite input (exp never gives NaN here: fminf drops one).
__device__ __forceinline__ float flash_e_bits(float l) {
  const uint32_t u = __float_as_uint(expf(fminf(l, 50.f) - 20.f));
  return __uint_as_float((u + 0x7fffu + ((u >> 16) & 1u)) & 0xffff0000u);
}

// The A fragments of e, whose values are bf16 already: their high halves.
__device__ __forceinline__ void pack_rounded(const float (&x)[32], uint32_t (&a)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      a[kk][i] = __byte_perm(__float_as_uint(x[8 * kk + 2 * i]),
                             __float_as_uint(x[8 * kk + 2 * i + 1]), 0x7632);
}

// kNtq, kNtv: the depths of q k^T and of e v in 16-column tiles (dq padded
// to 32, 128, 144, 192 or 256; dv to 16, 64, 96 or 128), those of the q
// tile and of the packed K and V tiles.
template <bool kSaveE, int kNtq, int kNtv>
__global__ void __launch_bounds__(WG_THREADS)
flash_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ kp,
                 const bf16* __restrict__ vp, bf16* __restrict__ out, bf16* __restrict__ e,
                 int nq, int nk, int nh, int dq, int dv, int vec_qk) {
  constexpr int kQp = 16 * kNtq, kVp = 16 * kNtv;
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* q_s = smem;                               // the q tile
  unsigned char* k_s = q_s + tile_bytes(kQp);              // [FF_STAGES] K chunks
  unsigned char* v_s = k_s + FF_STAGES * tile_bytes(kQp);  // [FF_STAGES] V chunks
  bf16* e_s = reinterpret_cast<bf16*>(v_s + FF_STAGES * tile_bytes(kVp));  // saved-e window

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = blockIdx.x * WG_ROWS;
  const int h = blockIdx.y;
  const int64_t b = blockIdx.z;
  const int64_t bh = b * nh + h;
  const int nc = (nk + WG_ROWS - 1) / WG_ROWS;
  const bf16* kb = kp + bh * nc * tile_elems(kQp);  // this head's packed K and V chunks
  const bf16* vb = vp + bh * nc * tile_elems(kVp);
  const int64_t row0 = bh * nq;  // this plane's first row of e
  auto k_tile = [&](int c) { return k_s + (c % FF_STAGES) * tile_bytes(kQp); };
  auto v_tile = [&](int c) { return v_s + (c % FF_STAGES) * tile_bytes(kVp); };

  load_tile<WG_THREADS>(q_s, q + (b * nq * nh + h) * dq, static_cast<int64_t>(nh) * dq, q0, nq,
                        dq, kQp, vec_qk);
  load_packed<kQp>(k_tile(0), kb);
  cp_async_commit();

  const uint32_t q_addr = smem_addr(q_s);
  int shift[2];  // saved-e: offsets of this thread's two rows in their windows
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) shift[hh] = e_shift(row0 + q0 + 16 * warp + g + 8 * hh, nk);
  float l[32], o[kNtv * 8], s[2] = {0.f, 0.f};
  uint32_t ea[4][4] = {};  // the previous chunk's e as A fragments
  zero(o);

  // Saved-e: in a whole chunk (64 keys) each row's window holds 7 or 8
  // whole pieces and, unless the row starts 16-byte aligned, 8 keys in its
  // two partial pieces. This thread's share, the same in every chunk:
  // offsets from key 0 of the block's first row of e, and the positions in
  // the staged window.
  constexpr int kPieceTasks = (WG_ROWS * E_WIN_PIECES + WG_THREADS - 1) / WG_THREADS;
  constexpr int kEdgeTasks = WG_ROWS * 8 / WG_THREADS;
  bf16* eb = kSaveE ? e + (row0 + q0) * nk : nullptr;
  int piece_off[kPieceTasks], piece_win[kPieceTasks], edge_off[kEdgeTasks], edge_win[kEdgeTasks];
  uint32_t piece_mask = 0, edge_mask = 0;
  if (kSaveE) {
#pragma unroll
    for (int j = 0; j < kPieceTasks; ++j) {
      const int idx = threadIdx.x + WG_THREADS * j;
      const int r = idx / E_WIN_PIECES, p = idx % E_WIN_PIECES;
      const int sh = e_shift(row0 + q0 + r, nk);
      piece_off[j] = r * nk - sh + 8 * p;
      piece_win[j] = r * E_WIN_LD + 8 * p;
      if (idx < WG_ROWS * E_WIN_PIECES && q0 + r < nq && 8 * p >= sh && 8 * p + 8 <= sh + WG_ROWS)
        piece_mask |= 1u << j;
    }
#pragma unroll
    for (int j = 0; j < kEdgeTasks; ++j) {
      const int idx = threadIdx.x + WG_THREADS * j;
      const int r = idx >> 3;
      const int sh = e_shift(row0 + q0 + r, nk);
      const int w = sh + (idx & 7) + (sh + (idx & 7) >= 8 ? WG_ROWS - 8 : 0);
      edge_off[j] = r * nk - sh + w;
      edge_win[j] = r * E_WIN_LD + w;
      if (q0 + r < nq && sh > 0) edge_mask |= 1u << j;
    }
  }

  // Step c: the logits of chunk c (c < nc) and the e v product of chunk c - 1.
  for (int c = 0;; ++c) {
    // K_c and V_{c-1} have landed; chunk c - 1's logits and chunk c - 2's
    // e v are done, so their stages take K_{c+1} and V_c.
    cp_async_wait<0>();
    fence_proxy_async();
    __syncthreads();
    if (c + 1 < nc) load_packed<kQp>(k_tile(c + 1), kb + (c + 1) * tile_elems(kQp));
    if (c < nc) load_packed<kVp>(v_tile(c), vb + c * tile_elems(kVp));
    cp_async_commit();
    if (c == nc) {
      wgmma_fence();
      issue_ev<kNtv>(o, ea, smem_addr(v_tile(c - 1)));
      wgmma_commit();
      break;
    }
    zero(l);
    fence_regs(l);
    wgmma_fence();
    issue_logits<kNtq>(l, q_addr, smem_addr(k_tile(c)));
    wgmma_commit();
    if (c > 0) {  // e v of chunk c - 1 runs while chunk c's e is computed
      issue_ev<kNtv>(o, ea, smem_addr(v_tile(c - 1)));
      wgmma_commit();
      wgmma_wait<1>();
    } else {
      wgmma_wait<0>();
    }
    fence_regs(l);

    // Every exp is taken and keys >= nk are zeroed after, by index: a
    // select, not a branch, so the 32 exponentials of a thread interleave.
    const int k0 = c * WG_ROWS;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const float ev = flash_e_bits(l[i]);
      l[i] = k0 + 8 * (i >> 2) + 2 * t + (i & 1) < nk ? ev : 0.f;
      s[(i >> 1) & 1] += l[i];
    }

    if (kSaveE) {
      // Stage the tile, each row at its offset in its window; then write
      // the window's whole 16-byte pieces, and the keys of its partial
      // pieces (the first, holding the previous keys' tail, and the last)
      // one element a thread. The next chunk's __syncthreads guards the
      // window.
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int hh = (i >> 1) & 1;
        e_s[(16 * warp + g + 8 * hh) * E_WIN_LD + 8 * (i >> 2) + 2 * t + (i & 1) + shift[hh]] =
            __ushort_as_bfloat16(static_cast<unsigned short>(__float_as_uint(l[i]) >> 16));
      }
      __syncthreads();
      if (k0 + WG_ROWS <= nk) {  // a whole chunk: the stores worked out before the loop
#pragma unroll
        for (int j = 0; j < kPieceTasks; ++j)
          if (piece_mask >> j & 1)
            *reinterpret_cast<uint4*>(eb + piece_off[j] + k0) =
                *reinterpret_cast<const uint4*>(e_s + piece_win[j]);
#pragma unroll
        for (int j = 0; j < kEdgeTasks; ++j)
          if (edge_mask >> j & 1) eb[edge_off[j] + k0] = e_s[edge_win[j]];
      } else {  // the last chunk, len < 64 keys
        const int len = nk - k0;
        for (int idx = threadIdx.x; idx < WG_ROWS * E_WIN_PIECES; idx += WG_THREADS) {
          const int r = idx / E_WIN_PIECES, p = idx % E_WIN_PIECES;
          const int sh = e_shift(row0 + q0 + r, nk);
          if (q0 + r < nq && 8 * p >= sh && 8 * p + 8 <= sh + len)
            *reinterpret_cast<uint4*>(eb + r * nk + k0 - sh + 8 * p) =
                *reinterpret_cast<const uint4*>(e_s + r * E_WIN_LD + 8 * p);
        }
        for (int idx = threadIdx.x; idx < WG_ROWS * 16; idx += WG_THREADS) {
          const int r = idx >> 4, j = idx & 15;
          const int sh = e_shift(row0 + q0 + r, nk);
          const int last = (sh + len - 1) >> 3;  // the piece holding the chunk's last key
          const int w = j < 8 ? j : 8 * last + j - 8;  // position in the window
          const bool partial = j < 8 ? sh > 0 || len < 8 : last > 0 && (sh + len) % 8 != 0;
          if (q0 + r < nq && partial && w >= sh && w < sh + len)
            eb[r * nk + k0 - sh + w] = e_s[r * E_WIN_LD + w];
        }
      }
    }

    wgmma_wait<0>();
    fence_regs(o);
    fence_regs(ea);  // live, and unmoved, until the e v that reads them is done
    pack_rounded(l, ea);
  }
  wgmma_wait<0>();
  fence_regs(o);

#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const float sum = fmaxf(quad_sum(s[hh]), 1e-30f);
    const int row = q0 + 16 * warp + g + 8 * hh;
    if (row >= nq) continue;
    bf16* ob = out + ((b * nq + row) * nh + h) * dv;
#pragma unroll
    for (int j = 0; j < 2 * kNtv; ++j)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int col = 8 * j + 2 * t + c;
        if (col < dv) ob[col] = __float2bfloat16_rn(o[4 * j + 2 * hh + c] / sum);
      }
  }
}

static size_t fwd_smem(bool save_e, int qp, int vp) {
  return static_cast<size_t>((1 + FF_STAGES) * tile_bytes(qp) + FF_STAGES * tile_bytes(vp) +
                             (save_e ? E_WIN_TILE : 0));
}

struct FlashFwdArgs {
  const void *q, *k, *v;
  void *out, *e, *kp, *vp;
  long long b, nq, nk, nh, dq, dv;
  int dqp, dvp, vec_qk, vec_v;
  cudaStream_t stream;
};

template <bool kSaveE, int kNtq, int kNtv>
static int launch(const FlashFwdArgs& a) {
  const PackJob k{static_cast<const bf16*>(a.k), static_cast<bf16*>(a.kp),
                  static_cast<int>(a.dq), 16 * kNtq, a.vec_qk};
  const PackJob v{static_cast<const bf16*>(a.v), static_cast<bf16*>(a.vp),
                  static_cast<int>(a.dv), 16 * kNtv, a.vec_v};
  int err = pack_kv(k, v, a.b, a.nk, a.nh, a.stream);
  if (err != 0) return err;
  auto kernel = flash_fwd_kernel<kSaveE, kNtq, kNtv>;
  const size_t smem = fwd_smem(kSaveE, 16 * kNtq, 16 * kNtv);
  cudaError_t cerr = allow_smem(kernel, smem);
  if (cerr != cudaSuccess) return static_cast<int>(cerr);
  const dim3 grid(static_cast<unsigned>((a.nq + WG_ROWS - 1) / WG_ROWS),
                  static_cast<unsigned>(a.nh), static_cast<unsigned>(a.b));
  kernel<<<grid, WG_THREADS, smem, a.stream>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.kp),
      static_cast<const bf16*>(a.vp), static_cast<bf16*>(a.out), static_cast<bf16*>(a.e),
      static_cast<int>(a.nq), static_cast<int>(a.nk), static_cast<int>(a.nh),
      static_cast<int>(a.dq), static_cast<int>(a.dv), a.vec_qk);
  return static_cast<int>(cudaGetLastError());
}

template <bool kSaveE, int kNtq>
static int dispatch_dv(const FlashFwdArgs& a) {
  const int ntv = a.dvp / 16;
  if (ntv <= 1) return launch<kSaveE, kNtq, 1>(a);
  if (ntv <= 4) return launch<kSaveE, kNtq, 4>(a);
  if (ntv <= 6) return launch<kSaveE, kNtq, 6>(a);
  return launch<kSaveE, kNtq, 8>(a);
}

template <bool kSaveE>
static int flash_fwd(const FlashFwdArgs& a) {
  if (a.b <= 0 || a.nq <= 0 || a.nk <= 0 || a.nh <= 0 || a.dq <= 0 || a.dv <= 0 ||
      a.dq > FF_MAX_DQ || a.dv > FF_MAX_DV || a.b > 65535 || a.nh > 65535 ||
      a.b * a.nh > 65535 || a.nq > 0x7fffffffLL - WG_ROWS || a.nk > 0x7fffffffLL - WG_ROWS ||
      a.b * a.nh * (a.nq + a.nk + WG_ROWS) * FF_MAX_DQ > (1LL << 62) ||
      (kSaveE && (a.nk >= (1LL << 24) || a.b * a.nh * a.nq > (1LL << 62) / a.nk ||
                  reinterpret_cast<uintptr_t>(a.e) % 16 != 0)) ||
      reinterpret_cast<uintptr_t>(a.kp) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(a.vp) % 16 != 0 ||
      a.dqp != pad16(static_cast<int>(a.dq)) || a.dvp != pad16(static_cast<int>(a.dv)) ||
      !good_vec(a.vec_qk) || !good_vec(a.vec_v))
    return static_cast<int>(cudaErrorInvalidValue);
  const int ntq = a.dqp / 16;
  if (ntq <= 2) return dispatch_dv<kSaveE, 2>(a);
  if (ntq <= 8) return dispatch_dv<kSaveE, 8>(a);
  if (ntq <= 9) return dispatch_dv<kSaveE, 9>(a);
  if (ntq <= 12) return dispatch_dv<kSaveE, 12>(a);
  return dispatch_dv<kSaveE, 16>(a);
}

// out = (e v) / max(sum e, 1e-30) per (batch, head), bf16, on `stream`,
// with _flash_fwd_kernel's constant shift. dqp and dvp are dq and dv padded
// to a multiple of 16. vec_qk and vec_v are the elements per load of q/k
// and of v (8, 4, 2 or 1), which every pointer, depth and row stride must
// be aligned to. kp and vp are bf16 scratch, 16-byte aligned, for k and v
// packed into tiles: b nh ceil(nk / 64) 64 D elements each, D the packed
// depth (dq padded to 32, 128, 144, 192 or 256 for kp; dv padded to 16,
// 64, 96 or 128 for vp). All pointers are
// device pointers to contiguous bf16 tensors. Returns cudaGetLastError()
// after the launches, or cudaErrorInvalidValue for shapes the kernel does
// not take (dq > 256, dv > 128, grid limits, sizes whose offsets pass
// 2^62, in the saved-e mode nk >= 2^24) or paddings, pieces and alignments
// that are not those.
extern "C" int sf_flash_attention_fwd(const void* q, const void* k, const void* v, void* out,
                                      void* kp, void* vp, long long b, long long nq,
                                      long long nk, long long nh, long long dq, long long dv,
                                      int dqp, int dvp, int vec_qk, int vec_v, void* stream) {
  const FlashFwdArgs a{q, k, v, out, nullptr, kp, vp, b, nq, nk, nh, dq, dv,
                       dqp, dvp, vec_qk, vec_v, static_cast<cudaStream_t>(stream)};
  return flash_fwd<false>(a);
}

// The saved-e mode of _fused_fwd_kernel: the output of
// sf_flash_attention_fwd, bit-equal, and e, a contiguous (b, nh, nq, nk)
// bf16 tensor with a 16-byte-aligned base, every element written with
// round(exp(min(l, 50) - 20)). Returns as sf_flash_attention_fwd does.
extern "C" int sf_flash_attention_fwd_saved_e(const void* q, const void* k, const void* v,
                                              void* out, void* e, void* kp, void* vp,
                                              long long b, long long nq, long long nk,
                                              long long nh, long long dq, long long dv, int dqp,
                                              int dvp, int vec_qk, int vec_v, void* stream) {
  const FlashFwdArgs a{q, k, v, out, e, kp, vp, b, nq, nk, nh, dq, dv,
                       dqp, dvp, vec_qk, vec_v, static_cast<cudaStream_t>(stream)};
  return flash_fwd<true>(a);
}
