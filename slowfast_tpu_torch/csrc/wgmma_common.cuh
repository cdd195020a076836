// Hopper (sm_90a) building blocks of the tensor-core pooled-attention
// kernels (pooled_attention_exact.cu, pooled_attention_exact_bwd.cu,
// pooled_attention_flash.cu, pooled_attention_flash_bwd.cu): the
// shared-memory tile layout, asynchronous tile copies, wgmma descriptors,
// the wgmma shapes the kernels use, the staged window of the saved e and
// the backwards' ordered sum of fp32 partials. Each warpgroup (128 threads) of
// a block multiplies its own 64-row tiles.
//
// Tile layout. A tile holds 64 rows (q rows or keys) of a (N, nh, d) head
// slice, bf16, with its depth d zero-padded to dp (a multiple of 16). It is
// stored as wgmma's no-swizzle ("interleave") canonical layout: 8 x 8 core
// matrices of 8 rows x 16 bytes, each 128 contiguous bytes; core matrix
// (row group rg, column group cg) starts at (cg * 64 + rg * 8) * 16 bytes,
// so element (r, c) lies at ((c / 8) * 64 + r) * 16 + (c % 8) * 2. One tile
// then serves both as a K-major operand (depth is the reduction: q k^T,
// do v^T) and as an MN-major one (rows are the reduction: p v, dl k,
// dl^T q, p^T do), since a core matrix is the same 8 x 8 block in both;
// a 128-byte swizzle would tie the tile to one of the two. Core matrices
// are read whole by the tensor cores, so reads have no bank conflicts.
//
// Descriptors (PTX ISA, "Matrix Descriptor Format"; interleave layout):
//   K-major  (rows = M or N, depth = K): LBO = 1024 B (next 8 depth
//            columns), SBO = 128 B (next 8 rows); a k16 step adds 2048 B.
//   MN-major (rows = K, depth = N):      LBO = 128 B (next 8 rows),
//            SBO = 1024 B (next 8 depth columns); a k16 step adds 256 B,
//            an n16 tile 2048 B.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

#define WG_ROWS 64       // rows of a tile, and of a warpgroup's wgmma
#define WG_THREADS 128   // one warpgroup
#define WG_TILE_CG 1024  // bytes between column groups of a tile (64 rows x 16 B)

__host__ __device__ __forceinline__ int pad16(int d) { return (d + 15) & ~15; }

// Bytes of one 64-row tile of padded depth dp.
__host__ __device__ __forceinline__ int tile_bytes(int dp) { return WG_ROWS * dp * 2; }

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---------------------------------------------------------------------------
// Asynchronous copies (cp.async, sm_80+). The global rows of a head slice
// are nh * d * 2 bytes apart and start d * 2 bytes after the previous head:
// 236 and 472 bytes at MViTv2-S's dq = 118, so TMA (16-byte strides) does
// not apply. Each piece is kVec elements (16, 8 or 4 bytes), the widest
// that the pointers, d and the row stride allow (chosen by the wrapper);
// 2-byte alignment falls back to plain loads and stores. The src-size
// operand zero-fills rows >= n and columns >= d in the same instruction.

template <int kVec>
__device__ __forceinline__ void copy_piece(unsigned char* tile, uint32_t base, uint32_t off,
                                           const bf16* src, int valid) {
  const uint32_t dst = base + off;
  if (kVec == 8) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
                 "r"(valid * 2) : "memory");
  } else if (kVec == 4) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(dst), "l"(src),
                 "r"(valid * 2) : "memory");
  } else if (kVec == 2) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
                 "r"(valid * 2) : "memory");
  } else {
    *reinterpret_cast<bf16*>(tile + off) = valid ? *src : __float2bfloat16_rn(0.f);
  }
}

// Rows [r0, r0 + 64) of a head slice whose row i starts at src + i * ld,
// into `tile`, depth padded to dp, by the block's kThreads threads.
// Consecutive threads fill one 16-byte core-matrix row, then the next rows
// of the same column group: the shared-memory side of each 8-thread phase
// is 128 contiguous bytes.
template <int kThreads, int kVec>
__device__ __forceinline__ void load_tile_v(unsigned char* tile, const bf16* src, int64_t ld,
                                            int r0, int n, int d, int dp) {
  constexpr int kPer = 8 / kVec;  // pieces per 16-byte core-matrix row
  const uint32_t base = smem_addr(tile);
  const int items = WG_ROWS * (dp >> 3) * kPer;
  for (int idx = threadIdx.x; idx < items; idx += kThreads) {
    const int sub = idx % kPer;
    const int t = idx / kPer;
    const int r = t & (WG_ROWS - 1);
    const int cg = t >> 6;
    const int c = cg * 8 + sub * kVec;
    const int row = r0 + r;
    int valid = 0;
    const bf16* p = src;
    if (row < n && c < d) {
      valid = d - c < kVec ? d - c : kVec;
      p = src + static_cast<int64_t>(row) * ld + c;
    }
    copy_piece<kVec>(tile, base, (cg * WG_ROWS + r) * 16 + sub * kVec * 2, p, valid);
  }
}

template <int kThreads>
__device__ __forceinline__ void load_tile(unsigned char* tile, const bf16* src, int64_t ld,
                                          int r0, int n, int d, int dp, int vec) {
  switch (vec) {
    case 8: load_tile_v<kThreads, 8>(tile, src, ld, r0, n, d, dp); break;
    case 4: load_tile_v<kThreads, 4>(tile, src, ld, r0, n, d, dp); break;
    case 2: load_tile_v<kThreads, 2>(tile, src, ld, r0, n, d, dp); break;
    default: load_tile_v<kThreads, 1>(tile, src, ld, r0, n, d, dp); break;
  }
}

// 64 fp32 values src[i0 .. i0 + 64) into dst, zero past n (4-byte pieces).
__device__ __forceinline__ void load_row_stat(float* dst, const float* src, int i0, int n,
                                              int idx) {
  const bool ok = i0 + idx < n;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst + idx)),
               "l"(ok ? src + i0 + idx : src), "r"(ok ? 4 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// Make this thread's shared-memory writes visible to wgmma (async proxy).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// ---------------------------------------------------------------------------
// wgmma.

__device__ __forceinline__ uint64_t desc_of(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) | (static_cast<uint64_t>(sbo >> 4) << 32);
}
// Operand descriptors of a tile at shared address `addr` (see the top).
__device__ __forceinline__ uint64_t desc_kmajor(uint32_t addr) {
  return desc_of(addr, WG_TILE_CG, 128);
}
__device__ __forceinline__ uint64_t desc_mnmajor(uint32_t addr) {
  return desc_of(addr, 128, WG_TILE_CG);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Wait until at most kPending of this warpgroup's committed wgmma groups
// are still running (the newest ones).
template <int kPending>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(kPending) : "memory");
}

// Keep the compiler from moving accesses of wgmma registers across the
// fence, commit and wait above (CUTLASS's warpgroup_fence_operand).
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
// The same for A fragments held in registers: keeps them live, and
// unmoved, until a wgmma that reads them is known to have finished.
template <int M, int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[M][N]) {
#pragma unroll
  for (int i = 0; i < M; ++i)
#pragma unroll
    for (int j = 0; j < N; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

// d (64 x 64, fp32) += a (64 x 16, shared, K-major) * b (16 x 64, shared,
// K-major): both operands from descriptors.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

// d (64 x 16, fp32) += a (64 x 16, bf16 registers) * b (16 x 16, shared,
// MN-major: imm-trans-b 1).
__device__ __forceinline__ void wgmma_rs_n16(float (&d)[8], const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x 16 kN, fp32) += a (64 x 16, bf16 registers) * b (16 x 16 kN,
// shared, MN-major) in one instruction, for kN = 1, 4, 6 and 8 (n16 to
// n128). d is the m64nN accumulator: element 8 j + i is element i of the
// j-th 16-column tile of wgmma_rs_n16's layout.
template <int kN>
__device__ __forceinline__ void wgmma_rs_wide(float (&d)[kN * 8], const uint32_t (&a)[4],
                                              uint64_t db);

template <>
__device__ __forceinline__ void wgmma_rs_wide<1>(float (&d)[8], const uint32_t (&a)[4],
                                                 uint64_t db) {
  wgmma_rs_n16(d, a, db);
}

template <>
__device__ __forceinline__ void wgmma_rs_wide<4>(float (&d)[32], const uint32_t (&a)[4],
                                                   uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs_wide<6>(float (&d)[48], const uint32_t (&a)[4],
                                                   uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, "
      "%35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47}, "
      "{%48, %49, %50, %51}, %52, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs_wide<8>(float (&d)[64], const uint32_t (&a)[4],
                                                   uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, "
      "%35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, "
      "%52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// Accumulator layout of m64nN (PTX ISA, "wgmma register fragment D"): warp
// w of the warpgroup holds rows 16 w + g and 16 w + g + 8 (g = lane / 4);
// element 4 j + 2 h + c is row 16 w + g + 8 h, column 8 j + 2 (lane % 4) + c.
// The A fragment of a k16 step in registers is the same map: for columns
// 16 kk .. 16 kk + 15 its four registers are elements (8 kk + 0, 1),
// (8 kk + 2, 3), (8 kk + 4, 5), (8 kk + 6, 7), each pair packed low first.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The A fragments of a 64 x 64 accumulator rounded to bf16: four k16 steps.
__device__ __forceinline__ void pack_a(const float (&x)[32], uint32_t (&a)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i) a[kk][i] = pack_bf16(x[8 * kk + 2 * i], x[8 * kk + 2 * i + 1]);
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// A 64 x 64 tile of the saved e staged in shared memory: each row's 64 keys
// in the 16-byte-aligned window of 72 elements that holds them (e's rows
// are Nk elements long, and Nk is odd in every MViTv2-S block).
#define E_WIN_LD 72                          // elements of a staged row
#define E_WIN_PIECES (E_WIN_LD / 8)          // 16-byte pieces of a staged row
#define E_WIN_TILE (WG_ROWS * E_WIN_LD * 2)  // bytes of a staged tile

// Offset of key k0 of row `row` of a (rows, nk) bf16 tensor (the saved e)
// in the 16-byte-aligned window that holds keys [k0, k0 + 64): the row's
// start modulo 16 bytes (the base is 16-byte aligned, k0 a multiple of 64).
__device__ __forceinline__ int e_shift(int64_t row, int nk) {
  return static_cast<int>((static_cast<uint32_t>(row) * static_cast<uint32_t>(nk)) & 7u);
}

template <int N>
__device__ __forceinline__ void zero(float (&x)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) x[i] = 0.f;
}

// d (64 x 64) += a b^T over depth dp, both tiles K-major (a logit or a dp
// product).
__device__ __forceinline__ void issue_ss(float (&d)[32], uint32_t a_addr, uint32_t b_addr,
                                         int dp) {
  for (int kk = 0; kk < dp / 16; ++kk)
    wgmma_ss_n64(d, desc_kmajor(a_addr + kk * 2 * WG_TILE_CG),
                 desc_kmajor(b_addr + kk * 2 * WG_TILE_CG));
}

// acc (64 x 16 kN) += a (64 x 64, registers) b (64 x n, tile at b_addr,
// MN-major), for the first n16 of the kN 16-column tiles.
template <int kN>
__device__ __forceinline__ void issue_rs(float (&acc)[kN][8], const uint32_t (&a)[4][4],
                                         uint32_t b_addr, int n16) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int j = 0; j < kN; ++j)
      if (j < n16) wgmma_rs_n16(acc[j], a[kk], desc_mnmajor(b_addr + kk * 256 + j * 2 * WG_TILE_CG));
}

// ---------------------------------------------------------------------------
// Host side.

// out[i] = round(sum over the n_split slices of part[slice * n + i]), the
// slices added in order: the backwards' dk and dv from the keys kernels'
// fp32 partials, deterministic and without atomics.
__global__ void sum_slices_kernel(const float* __restrict__ part, bf16* __restrict__ out,
                                  int64_t n, int n_split) {
  for (int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x; i < n;
       i += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    float acc = 0.f;
    for (int sl = 0; sl < n_split; ++sl) acc += part[sl * n + i];
    out[i] = __float2bfloat16_rn(acc);
  }
}

static int sum_slices(const float* part, void* out, long long n, int n_split,
                      cudaStream_t stream) {
  const long long blocks = (n + 255) / 256;
  sum_slices_kernel<<<static_cast<unsigned>(blocks < 4096 ? blocks : 4096), 256, 0, stream>>>(
      part, static_cast<bf16*>(out), n, n_split);
  return static_cast<int>(cudaGetLastError());
}

template <typename Kernel>
static cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

static bool good_vec(int vec) { return vec == 1 || vec == 2 || vec == 4 || vec == 8; }
