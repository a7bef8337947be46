// Hopper (sm_90a) building blocks shared by the port's tensor-core kernels
// (flash_attention.cu: K1, K2, K3; paged_attention.cu: the K4 prefill).
// Each .cu is its own library, so everything here is inline device code in
// an anonymous namespace; ops/_build.py hashes this header with every source,
// so an edit here rebuilds both.
//
// namespace tc: 16-byte cp.async (zero-filled past the end) and its groups,
// bf16 packing, and the mma.sync / wgmma accumulator fragment. The C
// fragment of m16n8 (and of each 16-row slice of wgmma's m64nN) puts lane
// 4·g + c on rows g and g + 8, columns 2c and 2c + 1, so the four lanes of a
// quad share a row and a row's max and sum take two shuffles; the A fragment
// of a k16 step is the C fragment of two neighbouring 8-column groups cast
// pairwise to bf16 (a_frag).
//
// namespace wg: Hopper's warpgroup MMA, wgmma.mma_async. The four warps of a
// warpgroup (128 threads) issue one product of a 64-row tile together,
// m64nNk16, bf16 operands, f32 accumulators in registers. The B operand (and
// A, in the SS form) is read by the tensor cores straight from shared memory
// through a 64-bit matrix descriptor, once for all 64 rows: no ldmatrix and
// no operand registers. Three forms:
//   (a) SS, A and B K-major in shared memory (S = Q·Kᵀ, dP = dO·Vᵀ);
//   (b) RS, A from registers — the f32 accumulator of (a) cast pairwise to
//       bf16 in the accumulator's own layout, which is the A layout — and B
//       MN-major (the transpose bit): P·V and dS·K, the V or K tile read as
//       it is stored, [keys][D];
//   (c) wgmma.fence before a product whose registers other instructions
//       wrote, commit, and wait; a product is waited on before its
//       accumulator is read.
//
// Tiles are bf16 in shared memory with the 128-byte swizzle: a tile of R
// rows × D is max(1, D/64) panels of R rows × 128 bytes (64 columns), and
// the 16-byte chunk j of row r sits at chunk (j % 8) ^ (r % 8) of its row
// in panel j / 8. The same bytes are a K-major operand (rows = M or N,
// columns = the k depth; a k step of 16 moves the start 32 bytes along the
// row, the 8-row groups 1024 bytes apart) and an MN-major one (rows = the k
// depth, 64 columns = N; a k step moves 16 rows), so one tile can be read
// both ways through two descriptors. At D = 32 the panel is half full: the
// SS products read only its first 64 bytes, and the RS product computes 64
// columns of which the upper 32 (from unwritten chunks) are never stored.
// Loads are 16-byte cp.async, zero-filled past the end, and each thread
// fences its copies into the async proxy (which wgmma reads through) before
// the barrier that publishes them.
//
// Accumulator layout of m64nN (f32): warp w of the warpgroup holds rows
// 16w..16w+15, and in it the C layout above for every 8-column group j.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {
namespace tc {

using bf16 = __nv_bfloat16;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; zeros when !valid (src is then
// not read, but stays a valid address).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The A fragment of k-step kk (16 columns) from C fragments of 8 columns.
template <int N>
__device__ __forceinline__ void a_frag(uint32_t (&a)[4],
                                       const float (&c)[N][4], int kk) {
  a[0] = pack_bf16(c[2 * kk][0], c[2 * kk][1]);
  a[1] = pack_bf16(c[2 * kk][2], c[2 * kk][3]);
  a[2] = pack_bf16(c[2 * kk + 1][0], c[2 * kk + 1][1]);
  a[3] = pack_bf16(c[2 * kk + 1][2], c[2 * kk + 1][3]);
}

// A warp's 16 rows × D of f32 (C fragments, already final) as bf16 into its
// rows of a shared tile, then 16-byte stores to rows [row0, row0 + 16) of a
// contiguous [B, L, H, D] output; rows at or past L are not written.
template <int D>
__device__ __forceinline__ void store_rows_tc(bf16* stage,
                                              const float (&acc)[D / 8][4],
                                              bf16* __restrict__ out, int b,
                                              int h, int H, int L, int row0,
                                              int lane) {
  constexpr int S = D + 8;
  const int g = lane >> 2, c = lane & 3;
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    *reinterpret_cast<uint32_t*>(stage + g * S + n * 8 + 2 * c) =
        pack_bf16(acc[n][0], acc[n][1]);
    *reinterpret_cast<uint32_t*>(stage + (g + 8) * S + n * 8 + 2 * c) =
        pack_bf16(acc[n][2], acc[n][3]);
  }
  __syncwarp();
  constexpr int CPR = D / 8;                   // 16 * CPR is a multiple of 32
#pragma unroll
  for (int i0 = 0; i0 < 16 * CPR; i0 += 32) {
    const int i = i0 + lane;
    const int r = i / CPR, cc = (i % CPR) * 8;
    const int row = row0 + r;
    if (row < L)
      *reinterpret_cast<uint4*>(out + (((long long)b * L + row) * H + h) * D +
                                cc) =
          *reinterpret_cast<const uint4*>(stage + r * S + cc);
  }
}

}  // namespace tc

namespace wg {

using tc::bf16;

template <int D>
constexpr int panels() {
  return D < 64 ? 1 : D / 64;
}
template <int R, int D>
constexpr int tile_bytes() {
  return panels<D>() * R * 128;
}

// The swizzle ties a tile's layout to address bits 4-9: tiles start on
// 1024-byte boundaries (the block asks for 1 KB more than its tiles).
__device__ __forceinline__ uint8_t* align1024(void* p) {
  uint8_t* b = static_cast<uint8_t*>(p);
  return b + ((1024 - (tc::smem_u32(b) & 1023)) & 1023);
}

// Shared byte offset of 16-byte chunk j of row r in a swizzled tile of R rows.
template <int R>
__device__ __forceinline__ int sw_offset(int r, int j) {
  return (j >> 3) * R * 128 + r * 128 + (((j & 7) ^ (r & 7)) << 4);
}

// Rows [r0, r0 + R) of one head, D bf16 each, into a swizzled tile by the
// NT threads of the block; rows at or past n are zero-filled.
template <int R, int D, int NT>
__device__ __forceinline__ void load_sw(uint8_t* dst, const bf16* src,
                                        long long row_stride, int r0, int n) {
  constexpr int CPR = D / 8;                   // 16-byte chunks a row
  static_assert(R * CPR % NT == 0, "tile not a whole number of loads");
#pragma unroll
  for (int i = 0; i < R * CPR / NT; ++i) {
    const int idx = threadIdx.x + i * NT;
    const int r = idx / CPR, j = idx % CPR;
    const bool ok = r0 + r < n;
    tc::cp_async16(dst + sw_offset<R>(r, j),
                   src + (ok ? (long long)(r0 + r) * row_stride : 0) + j * 8,
                   ok);
  }
}

// Matrix descriptor of a swizzled operand starting at shared address `a`:
// start >> 4, leading offset, 1024 B between 8-row groups (the stride
// offset), layout 1 = 128-byte swizzle. The leading offset is not read for
// a K-major operand of this swizzle; for an MN-major one it is the step
// between 64-column panels, and each MN-major product here reads one panel,
// so it too is set to 1024 B.
__device__ __forceinline__ uint64_t desc(uint32_t a) {
  return (uint64_t)((a & 0x3FFFF) >> 4) | (64ull << 16) | (64ull << 32) |
         (1ull << 62);
}
// Byte offset of k step kk (16 columns) in a K-major tile of R rows.
template <int R>
__device__ __forceinline__ constexpr uint32_t kmajor_step(int kk) {
  return (uint32_t)((kk >> 2) * R * 128 + (kk & 3) * 32);
}
// Byte offset of k step kk (16 rows) of panel p in an MN-major tile of R rows.
template <int R>
__device__ __forceinline__ constexpr uint32_t mnmajor_step(int kk, int p) {
  return (uint32_t)(p * R * 128 + kk * 16 * 128);
}

__device__ __forceinline__ void fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Until at most N of this warpgroup's committed groups are in flight.
template <int N>
__device__ __forceinline__ void wait_group() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// 2^x by the exp2 unit alone: a result below 2^-126 flushes to 0 (exp2f
// adds instructions around the unit to keep it as a denormal, ~25 % more
// issue slots on the softmax, and such a p is 0 to the f32 sums anyway).
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}
// This thread's cp.async writes, visible to the async proxy.
__device__ __forceinline__ void proxy_fence() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// Registers a product in flight reads or writes: kept where they are until
// after the wait (the compiler sees the asm as done when it is issued).
template <int N>
__device__ __forceinline__ void hold(float (&d)[N][4]) {
#pragma unroll
  for (int j = 0; j < N; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+f"(d[j][e])::"memory");
}
template <int N>
__device__ __forceinline__ void hold(uint32_t (&a)[N][4]) {
#pragma unroll
  for (int j = 0; j < N; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(a[j][e])::"memory");
}

#define WG_D8(j)                                                           \
  "+f"(d[j][0]), "+f"(d[j][1]), "+f"(d[j][2]), "+f"(d[j][3]),              \
      "+f"(d[j + 1][0]), "+f"(d[j + 1][1]), "+f"(d[j + 1][2]),             \
      "+f"(d[j + 1][3])
#define WG_D32 WG_D8(0), WG_D8(2), WG_D8(4), WG_D8(6)
#define WG_R32                                                             \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31}"

// (a) d (+)= A·Bᵀ over one k step, A [64][16] and B [64][16] K-major in
// shared memory; `acc` 0 overwrites d.
__device__ __forceinline__ void mma_ss(float (&d)[8][4], uint64_t a,
                                       uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WG_R32
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : WG_D32
      : "l"(a), "l"(b), "r"(acc));
}
// (b) d += A·B over one k step, A [64][16] in registers, B [16][64]
// MN-major in shared memory.
__device__ __forceinline__ void mma_rs(float (&d)[8][4],
                                       const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WG_R32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : WG_D32
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

#undef WG_D8
#undef WG_D32
#undef WG_R32

// blockIdx.x read anew: a volatile read is not merged with the first one,
// so the value needs no register across the sweep.
__device__ __forceinline__ int block_x() {
  int x;
  asm volatile("mov.u32 %0, %%ctaid.x;\n" : "=r"(x));
  return x;
}

// The grid is (batch·head, q tile) and a block's q tile counts down from
// the last: the scheduler hands blocks out in x-fastest order, so every
// head's heaviest causal tile starts before any lighter one, and the
// light ones fill in at the end.
__device__ __forceinline__ int q_tile_start(int bm) {
  return (gridDim.y - 1 - blockIdx.y) * bm;
}

// Columns [64p, 64p + 64) of an accumulator of whole panels.
template <int N>
__device__ __forceinline__ float (&panel(float (&acc)[N][4], int p))[8][4] {
  return *reinterpret_cast<float(*)[8][4]>(&acc[p * 8]);
}

// The first D columns of an accumulator of whole panels, for the store.
template <int D, int N>
__device__ __forceinline__ const float (&cols(const float (&acc)[N][4]))[D / 8][4] {
  static_assert(D / 8 <= N, "accumulator narrower than D");
  return *reinterpret_cast<const float(*)[D / 8][4]>(&acc[0]);
}

}  // namespace wg
}  // namespace
