// Flash attention forward and backward, for NVIDIA Hopper (sm_90a).
//
// Replaces the three Pallas TPU kernels of ray_tpu/ops/flash_attention.py:
//   * K1 — _flash_kernel via _flash_forward: O and the row log-sum-exp
//     lse = m + log(max(l, 1e-30)) of the scaled scores;
//   * K2 — _dq_kernel: dq = ds·K with p recomputed from (q, k, lse) and
//     ds = p * (dO·Vᵀ - delta) * scale;
//   * K3 — _dkv_kernel: dv = pᵀ·dO, dk = dsᵀ·Q.
// delta = rowsum(dO * O) is computed by torch before K2/K3, as the JAX package
// leaves it to XLA. The mask is the JAX kernels' top-left row >= col, also
// when Lq != Lk, and masked scores contribute exactly 0.
//
// Operands are read in place in their [B, L, H, D] layout (any strides with a
// unit stride on D; the wrapper passes the b, l and h strides), so no folding
// copy to [B*H, L, D] is made. O, dq, dk and dv are written contiguous in the
// dtype of q, k and v; lse and delta are [B, H, L] f32. bf16 and f32 inputs;
// head_dim 32, 64 or 128.
//
// What bounds it on this card: at the training shape (B=16, L=1024, H=12,
// D=64, bf16, causal) K1 does 4·D flops per attended (query, key) pair —
// ~26 GFLOP — on ~100 MB of operands, ~260 flops a byte: on the tensor cores
// (989 TFLOP/s bf16) it would be ~0.03 ms, near the ridge; K2 (6·D a pair)
// and K3 (8·D a pair) are further on the compute side. So all three are
// compute-bound, and what matters is the arithmetic rate — and, for the
// softmax and the recomputed P, the exp2 unit (16 a clock an SM), which
// the tensor-core products have to overlap.
//
// Which kernel runs is chosen by the operand dtype alone, in `launch`:
//   * bf16 K1 and K2 run on Hopper's warpgroup MMA, wgmma
//     (flash_fwd_wgmma_kernel, flash_dq_wgmma_kernel, the last section);
//   * bf16 K3 runs on the tensor cores through the warp-level mma.sync
//     (flash_dkv_mma_kernel);
//   * f32 K1-K3 run on the CUDA cores (flash_fwd_kernel, flash_dq_kernel,
//     flash_dkv_kernel). The tensor cores take f32 only as TF32 (about
//     three decimal digits), which would break the 1e-4 that holds the f32
//     kernels to the plain versions.
//
// The CUDA-core kernels keep every intermediate out of device memory (no L×L
// matrix; each operand tile is read from device memory once per block) and
// feed the f32 FMA pipe as well as a simple kernel can: 64×64 tiles in
// shared memory as f32 rows padded to D+4 floats, 256 threads each owning a
// 4×4 block of the score tile, reading operands with 16-byte shared loads
// that hit no bank twice, 2 loads per 16 FMAs. They are bounded by the f32
// FMA rate (67 TFLOP/s peak), about 15× above the bf16 bound; all their
// arithmetic is f32.
//
// Design of the CUDA-core kernels (the tensor-core ones have their own note
// below): a block of 256 threads owns one (batch·head, 64-row tile); the loop
// over the other operand's tiles takes the place of the TPU's sequential
// grid axis and stops at the diagonal when causal. K1 keeps (m, l, acc) in
// registers, with the 16 threads of a row reducing by shuffles within their
// half-warp. K2 owns a q tile and loops over kv tiles; K3 owns a kv tile and
// loops over q tiles. Each output element is summed by one thread in a fixed
// order and written once: no atomics, so the gradients are bit-for-bit
// repeatable from run to run (in both designs). A length that is not a
// multiple of the tile is masked inside the kernel (rows past the end are
// loaded as zeros, their scores masked, their outputs not written).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "hopper_mma.cuh"

namespace {

constexpr int kTile = 64;          // rows of a q tile and of a kv tile
constexpr int kThreads = 256;      // 16 × 16 threads, each a 4×4 score block
constexpr int kPT = kTile + 4;     // padded row of a transposed score tile
constexpr float kNegInf = -1e30f;  // the JAX kernels' mask value
constexpr unsigned kFull = 0xffffffffu;

struct Strides {                   // elements between consecutive b, l, h
  long long b, l, h;
};

// 16 bytes of T unpacked to f32.
template <typename T>
struct Vec;
template <>
struct Vec<float> {
  static constexpr int N = 4;
  __device__ __forceinline__ static void unpack(const uint4& u, float* out) {
    out[0] = __uint_as_float(u.x);
    out[1] = __uint_as_float(u.y);
    out[2] = __uint_as_float(u.z);
    out[3] = __uint_as_float(u.w);
  }
};

__device__ __forceinline__ void store(float* p, float x) { *p = x; }

// Output columns of thread tx: groups of CW consecutive columns,
// col(g, e) = g * 16 * CW + tx * CW + e, so the 16 threads of a row read one
// contiguous stretch of a shared row per group.
template <int D>
struct Cols {
  static constexpr int CW = D >= 64 ? 4 : 2;
  static constexpr int NG = D / (16 * CW);
  static constexpr int N = CW * NG;  // columns per thread
  __device__ __forceinline__ static int col(int g, int tx, int e) {
    return g * 16 * CW + tx * CW + e;
  }
};

// Rows [r0, r0 + kTile) of one head, from device memory into a shared tile
// [kTile][D + 4] of f32; rows at or past n are zeros. All 16-byte loads of
// a thread are issued before any is stored.
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* __restrict__ src,
                                          long long row_stride, int r0, int n) {
  constexpr int VN = Vec<T>::N;
  constexpr int VPR = D / VN;                       // 16-byte loads a row
  constexpr int LOADS = kTile * VPR / kThreads;     // exact for D in {32,64,128}
  uint4 buf[LOADS];
#pragma unroll
  for (int i = 0; i < LOADS; ++i) {
    const int idx = threadIdx.x + i * kThreads;
    const int r = idx / VPR;
    const int c = (idx - r * VPR) * VN;
    buf[i] = make_uint4(0, 0, 0, 0);
    if (r0 + r < n)
      buf[i] = __ldg(reinterpret_cast<const uint4*>(
          src + (long long)(r0 + r) * row_stride + c));
  }
#pragma unroll
  for (int i = 0; i < LOADS; ++i) {
    const int idx = threadIdx.x + i * kThreads;
    const int r = idx / VPR;
    const int c = (idx - r * VPR) * VN;
    float f[VN];
    Vec<T>::unpack(buf[i], f);
    float* d = dst + r * (D + 4) + c;
#pragma unroll
    for (int e = 0; e < VN; e += 4)
      *reinterpret_cast<float4*>(d + e) =
          make_float4(f[e], f[e + 1], f[e + 2], f[e + 3]);
  }
}

// s[i][j] = sum_c A[ty*4 + i][c] * B[tx + 16*j][c] over shared tiles
// [kTile][D + 4]. A's reads are broadcast within a half-warp; B's rows are
// D + 4 = 4 (mod 32) floats apart, so 8 lanes' 16-byte reads cover all 32
// banks once.
template <int D>
__device__ __forceinline__ void tile_dot(const float* A, const float* B,
                                         int ty, int tx, float (&s)[4][4]) {
  constexpr int P = D + 4;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
  for (int c = 0; c < D; c += 4) {
    float4 a[4], b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      a[i] = *reinterpret_cast<const float4*>(A + (ty * 4 + i) * P + c);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      b[j] = *reinterpret_cast<const float4*>(B + (tx + 16 * j) * P + c);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float x = s[i][j];
        x = fmaf(a[i].x, b[j].x, x);
        x = fmaf(a[i].y, b[j].y, x);
        x = fmaf(a[i].z, b[j].z, x);
        x = fmaf(a[i].w, b[j].w, x);
        s[i][j] = x;
      }
  }
}

// acc[i][n] += sum_r W[r][ty*4 + i] * X[r][col(n)], W a transposed score
// tile [kTile][kPT] and X an operand tile [kTile][D + 4].
template <int D>
__device__ __forceinline__ void tile_acc(const float* W, const float* X,
                                         int ty, int tx,
                                         float (&acc)[4][Cols<D>::N]) {
  using C = Cols<D>;
  constexpr int P = D + 4;
#pragma unroll 4
  for (int r = 0; r < kTile; ++r) {
    const float4 w = *reinterpret_cast<const float4*>(W + r * kPT + ty * 4);
    const float wr[4] = {w.x, w.y, w.z, w.w};
    float x[C::N];
#pragma unroll
    for (int g = 0; g < C::NG; ++g) {
      const float* src = X + r * P + C::col(g, tx, 0);
      if constexpr (C::CW == 4) {
        const float4 u = *reinterpret_cast<const float4*>(src);
        x[g * 4] = u.x, x[g * 4 + 1] = u.y, x[g * 4 + 2] = u.z,
        x[g * 4 + 3] = u.w;
      } else {
        const float2 u = *reinterpret_cast<const float2*>(src);
        x[g * 2] = u.x, x[g * 2 + 1] = u.y;
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int n = 0; n < C::N; ++n) acc[i][n] = fmaf(wr[i], x[n], acc[i][n]);
  }
}

// Writes a thread's 4×4 score block transposed: W[tx + 16*j][ty*4 + i].
__device__ __forceinline__ void store_transposed(float* W, int ty, int tx,
                                                 const float (&s)[4][4]) {
#pragma unroll
  for (int j = 0; j < 4; ++j)
    *reinterpret_cast<float4*>(W + (tx + 16 * j) * kPT + ty * 4) =
        make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
}

// Writes rows ty*4 + i of a thread's columns into a contiguous [B, L, H, D]
// output at row offset `row0` of head (b, h).
template <typename T, int D>
__device__ __forceinline__ void store_rows(T* __restrict__ out, int b, int h,
                                           int H, int L, int row0, int ty,
                                           int tx,
                                           const float (&acc)[4][Cols<D>::N]) {
  using C = Cols<D>;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = row0 + ty * 4 + i;
    if (row >= L) continue;
    T* p = out + (((long long)b * L + row) * H + h) * D;
#pragma unroll
    for (int g = 0; g < C::NG; ++g)
#pragma unroll
      for (int e = 0; e < C::CW; ++e)
        store(p + C::col(g, tx, e), acc[i][g * C::CW + e]);
  }
}

__device__ __forceinline__ float half_warp_max(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(kFull, x, o));
  return x;
}
__device__ __forceinline__ float half_warp_sum(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
}

// Number of kv tiles a q tile starting at q0 needs.
__device__ __forceinline__ int kv_tiles(int q0, int Lq, int Lk, int causal) {
  int end = Lk;
  if (causal) end = min(Lk, min(q0 + kTile, Lq));
  return (end + kTile - 1) / kTile;
}

// ---- K1 ---------------------------------------------------------------------
template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    T* __restrict__ o, float* __restrict__ lse, Strides sq, Strides sk,
    Strides sv, int H, int Lq, int Lk, float scale, int causal) {
  constexpr int P = D + 4;
  constexpr int N = Cols<D>::N;
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);  // [kTile][P]
  float* ks = qs + kTile * P;                   // [kTile][P]
  float* vs = ks + kTile * P;                   // [kTile][P]
  float* pt = vs + kTile * P;                   // [kTile keys][kPT rows]

  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  // The heaviest (last) causal tiles first: they start while light ones fill.
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kTile;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const T* kb = k + b * sk.b + h * sk.h;
  const T* vb = v + b * sv.b + h * sv.h;
  load_tile<T, D>(qs, q + b * sq.b + h * sq.h, sq.l, q0, Lq);

  float m[4], l[4], acc[4][N];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int n = 0; n < N; ++n) acc[i][n] = 0.f;
  }
  const int tiles = kv_tiles(q0, Lq, Lk, causal);
  for (int t = 0; t < tiles; ++t) {
    const int k0 = t * kTile;
    __syncthreads();                 // the previous tile is fully read
    load_tile<T, D>(ks, kb, sk.l, k0, Lk);
    load_tile<T, D>(vs, vb, sv.l, k0, Lk);
    __syncthreads();
    float s[4][4];
    tile_dot<D>(qs, ks, ty, tx, s);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty * 4 + i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + tx + 16 * j;
        const bool ok = col < Lk && (!causal || row >= col);
        s[i][j] = ok ? s[i][j] * scale : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], half_warp_max(mx));
      const float alpha = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = s[i][j] == kNegInf ? 0.f : expf(s[i][j] - m_new);
        rs += s[i][j];
      }
      l[i] = alpha * l[i] + half_warp_sum(rs);
      m[i] = m_new;
#pragma unroll
      for (int n = 0; n < N; ++n) acc[i][n] *= alpha;
    }
    store_transposed(pt, ty, tx, s);
    __syncthreads();
    tile_acc<D>(pt, vs, ty, tx, acc);
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float denom = fmaxf(l[i], 1e-30f);
    const int row = q0 + ty * 4 + i;
    if (tx == 0 && row < Lq) lse[(long long)bh * Lq + row] = m[i] + logf(denom);
#pragma unroll
    for (int n = 0; n < N; ++n) acc[i][n] /= denom;  // divided, as in JAX
  }
  store_rows<T, D>(o, b, h, H, Lq, q0, ty, tx, acc);
}

// ---- K2 ---------------------------------------------------------------------
template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_dq_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ g, const float* __restrict__ lse,
    const float* __restrict__ delta, T* __restrict__ dq, Strides sq,
    Strides sk, Strides sv, Strides sg, int H, int Lq, int Lk, float scale,
    int causal) {
  constexpr int P = D + 4;
  constexpr int N = Cols<D>::N;
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);  // [kTile][P]
  float* gs = qs + kTile * P;                   // dO, [kTile][P]
  float* ks = gs + kTile * P;                   // [kTile][P]
  float* vs = ks + kTile * P;                   // [kTile][P]
  float* dst = vs + kTile * P;                  // ds, [kTile keys][kPT rows]

  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kTile;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const T* kb = k + b * sk.b + h * sk.h;
  const T* vb = v + b * sv.b + h * sv.h;
  load_tile<T, D>(qs, q + b * sq.b + h * sq.h, sq.l, q0, Lq);
  load_tile<T, D>(gs, g + b * sg.b + h * sg.h, sg.l, q0, Lq);
  float lse_r[4], delta_r[4], acc[4][N];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    lse_r[i] = row < Lq ? lse[(long long)bh * Lq + row] : 0.f;
    delta_r[i] = row < Lq ? delta[(long long)bh * Lq + row] : 0.f;
#pragma unroll
    for (int n = 0; n < N; ++n) acc[i][n] = 0.f;
  }

  const int tiles = kv_tiles(q0, Lq, Lk, causal);
  for (int t = 0; t < tiles; ++t) {
    const int k0 = t * kTile;
    __syncthreads();
    load_tile<T, D>(ks, kb, sk.l, k0, Lk);
    load_tile<T, D>(vs, vb, sv.l, k0, Lk);
    __syncthreads();
    float s[4][4], dp[4][4];
    tile_dot<D>(qs, ks, ty, tx, s);
    tile_dot<D>(gs, vs, ty, tx, dp);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + tx + 16 * j;
        const bool ok = row < Lq && col < Lk && (!causal || row >= col);
        const float p = ok ? expf(s[i][j] * scale - lse_r[i]) : 0.f;
        s[i][j] = p * (dp[i][j] - delta_r[i]) * scale;
      }
    }
    store_transposed(dst, ty, tx, s);
    __syncthreads();
    tile_acc<D>(dst, ks, ty, tx, acc);
  }
  store_rows<T, D>(dq, b, h, H, Lq, q0, ty, tx, acc);
}

// ---- K3 ---------------------------------------------------------------------
template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_dkv_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ g, const float* __restrict__ lse,
    const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv,
    Strides sq, Strides sk, Strides sv, Strides sg, int H, int Lq, int Lk,
    float scale, int causal) {
  constexpr int P = D + 4;
  constexpr int N = Cols<D>::N;
  extern __shared__ float4 smem4[];
  float* ks = reinterpret_cast<float*>(smem4);  // [kTile][P], resident
  float* vs = ks + kTile * P;                   // [kTile][P], resident
  float* qs = vs + kTile * P;                   // [kTile][P]
  float* gs = qs + kTile * P;                   // dO, [kTile][P]
  float* p2 = gs + kTile * P;                   // p,  [kTile q][kPT keys]
  float* ds2 = p2 + kTile * kPT;                // ds, [kTile q][kPT keys]

  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int k0 = blockIdx.x * kTile;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const T* qb = q + b * sq.b + h * sq.h;
  const T* gb = g + b * sg.b + h * sg.h;
  const float* lse_b = lse + (long long)bh * Lq;
  const float* delta_b = delta + (long long)bh * Lq;
  load_tile<T, D>(ks, k + b * sk.b + h * sk.h, sk.l, k0, Lk);
  load_tile<T, D>(vs, v + b * sv.b + h * sv.h, sv.l, k0, Lk);
  float dk_acc[4][N], dv_acc[4][N];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int n = 0; n < N; ++n) dk_acc[i][n] = dv_acc[i][n] = 0.f;

  // Causal: q rows before k0 see none of this kv tile.
  const int first = causal ? k0 / kTile : 0;
  const int tiles = (Lq + kTile - 1) / kTile;
  for (int t = first; t < tiles; ++t) {
    const int q0 = t * kTile;
    __syncthreads();
    load_tile<T, D>(qs, qb, sq.l, q0, Lq);
    load_tile<T, D>(gs, gb, sg.l, q0, Lq);
    float lse_c[4], delta_c[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = q0 + tx + 16 * j;
      lse_c[j] = col < Lq ? lse_b[col] : 0.f;
      delta_c[j] = col < Lq ? delta_b[col] : 0.f;
    }
    __syncthreads();
    // Transposed scores: s[i][j] for key k0 + ty*4 + i and query q0 + tx + 16j.
    float s[4][4], dp[4][4];
    tile_dot<D>(ks, qs, ty, tx, s);
    tile_dot<D>(vs, gs, ty, tx, dp);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int key = k0 + ty * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int row = q0 + tx + 16 * j;
        const bool ok = row < Lq && key < Lk && (!causal || row >= key);
        const float p = ok ? expf(s[i][j] * scale - lse_c[j]) : 0.f;
        s[i][j] = p;
        dp[i][j] = p * (dp[i][j] - delta_c[j]) * scale;
      }
    }
    store_transposed(p2, ty, tx, s);
    store_transposed(ds2, ty, tx, dp);
    __syncthreads();
    tile_acc<D>(p2, gs, ty, tx, dv_acc);
    tile_acc<D>(ds2, qs, ty, tx, dk_acc);
  }
  store_rows<T, D>(dk, b, h, H, Lk, k0, ty, tx, dk_acc);
  store_rows<T, D>(dv, b, h, H, Lk, k0, ty, tx, dv_acc);
}

// ---- bf16 on the tensor cores through mma.sync (K3) ---------------------------
//
// The products run as mma.sync.m16n8k16 (bf16 operands, f32 accumulators):
// Hopper's tensor cores through the warp-level instruction, at roughly two
// thirds of what wgmma reaches. Operand tiles stay bf16 in shared memory,
// rows padded by 16 bytes (D + 8 elements) so that the 8 row addresses of an
// ldmatrix fall in 8 different 16-byte bank groups. They arrive by 16-byte
// cp.async (the zero-fill form for rows past the end) in a ring of two
// stages: the copy of tile t+1 is issued before the products of tile t, and
// a stage is refilled only after the barrier that ends the tile that read
// it. Scores never leave registers: the f32 accumulator fragment of
// m16n8k16, cast pairwise to bf16, is the A fragment of the next product,
// so Pᵀ and dSᵀ are the A operands of Pᵀ·dO and dSᵀ·Q straight from the
// registers that computed them. Rounding P and dS to bf16 before those
// products is the one numerical difference from the f32 plain versions
// (SDPA does the same); the scores, the softmax statistics and all sums are
// f32. The fragment layouts and cp.async helpers are in hopper_mma.cuh.

namespace tc {

constexpr int kDkvThreads = 128;               // K3: 4 warps, 16 keys each

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

// Four 8×8 b16 matrices from shared memory; lane l gives the address of row
// (l & 7) of matrix l >> 3. `_t` transposes each matrix.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// d += a·b over one 16×8×16 step.
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// blockIdx.y read anew: a volatile read is not merged with the first one,
// so (b, h) need no registers across the sweep.
__device__ __forceinline__ int block_y() {
  int y;
  asm volatile("mov.u32 %0, %%ctaid.y;\n" : "=r"(y));
  return y;
}

// Address of lane's row for the A fragment (16 rows × 16 columns at (r0,
// c0)) of a row-major tile with row stride S, and for two B fragments (n
// tiles n0 and n0 + 8, k columns c0..c0+15) of a tile stored [n][k].
template <int S>
__device__ __forceinline__ const bf16* a_addr(const bf16* t, int r0, int c0,
                                              int lane) {
  return t + (r0 + (lane & 15)) * S + c0 + (lane >> 4) * 8;
}
template <int S>
__device__ __forceinline__ const bf16* b_addr(const bf16* t, int n0, int c0,
                                              int lane) {
  return t + (n0 + (lane & 7) + (lane >> 4) * 8) * S + c0 +
         ((lane >> 3) & 1) * 8;
}
// Two B fragments (n tiles n0, n0 + 8; k rows r0..r0+15) of a tile stored
// [k][n], read transposed: the same addresses as an A fragment.
template <int S>
__device__ __forceinline__ const bf16* bt_addr(const bf16* t, int r0, int n0,
                                               int lane) {
  return a_addr<S>(t, r0, n0, lane);
}

// Rows [r0, r0 + R) of one head, D bf16 each, into a tile [R][D + 8] by the
// NT threads of the block; rows at or past n are zero-filled.
template <int R, int D, int NT>
__device__ __forceinline__ void load_async(bf16* dst, const bf16* src,
                                           long long row_stride, int r0,
                                           int n) {
  constexpr int CPR = D / 8;                   // 16-byte chunks a row
  static_assert(R * CPR % NT == 0, "tile not a whole number of loads");
#pragma unroll
  for (int i = 0; i < R * CPR / NT; ++i) {
    const int idx = threadIdx.x + i * NT;
    const int r = idx / CPR, c = (idx % CPR) * 8;
    const bool ok = r0 + r < n;
    cp_async16(dst + r * (D + 8) + c,
               src + (ok ? (long long)(r0 + r) * row_stride : 0) + c, ok);
  }
}

// ---- K3, bf16 ----------------------------------------------------------------
// Replaces _dkv_kernel (ray_tpu/ops/flash_attention.py:200) for bf16. A
// block of 4 warps owns 64 keys of one (batch, head), 16 a warp; K and V stay
// in shared memory for the whole sweep. The block walks the q tiles (BQ rows)
// from the diagonal; Q, dO and their lse and delta rows come through the
// two-stage ring. Per q tile and warp, with the keys as the M rows:
//   Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ (both operands K-major in shared memory),
//   Pᵀ = exp(scale·Sᵀ − lse), dSᵀ = Pᵀ·(dPᵀ − delta)·scale,
//   dV += Pᵀ·dO and dK += dSᵀ·Q, with Pᵀ and dSᵀ cast to bf16 in registers
//   as the A operands and dO, Q read by ldmatrix.trans as B.
// dK and dV are f32 accumulators in registers for the whole sweep, written
// once by the warp that summed them: no atomics, the same bits every run.
// BQ is 32 at D = 128 so that dK, dV (128 f32 a thread) and the two score
// tiles stay in registers.
template <int D>
__global__ void __launch_bounds__(kDkvThreads) flash_dkv_mma_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const bf16* __restrict__ g,
    const float* __restrict__ lse, const float* __restrict__ delta,
    bf16* __restrict__ dk, bf16* __restrict__ dv, Strides sq, Strides sk,
    Strides sv, Strides sg, int H, int Lq, int Lk, float scale, int causal) {
  constexpr int S = D + 8, BN = 64, BQ = D == 128 ? 32 : 64, NT = kDkvThreads;
  static_assert(BN == NT / 32 * 16, "16 keys a warp");
  extern __shared__ float4 smem4[];
  bf16* ks = reinterpret_cast<bf16*>(smem4);   // [BN][S], resident
  bf16* vs = ks + BN * S;                      // [BN][S], resident
  bf16* qs = vs + BN * S;                      // [2][BQ][S]
  bf16* gs = qs + 2 * BQ * S;                  // dO, [2][BQ][S]
  float* ls = reinterpret_cast<float*>(gs + 2 * BQ * S);  // lse, [2][BQ]
  float* dls = ls + 2 * BQ;                    // delta, [2][BQ]

  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int k0 = blockIdx.x * BN;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gq = lane >> 2, c = lane & 3;
  const int wkey = k0 + warp * 16;             // this warp's first key
  const bf16* qb = q + b * sq.b + h * sq.h;
  const bf16* gb = g + b * sg.b + h * sg.h;
  const float* lse_b = lse + (long long)bh * Lq;
  const float* delta_b = delta + (long long)bh * Lq;

  // One q tile's Q, dO, lse and delta into stage st.
  auto load_q_tile = [&](int t, int st) {
    const int q0 = t * BQ;
    load_async<BQ, D, NT>(qs + st * BQ * S, qb, sq.l, q0, Lq);
    load_async<BQ, D, NT>(gs + st * BQ * S, gb, sg.l, q0, Lq);
    const int i = threadIdx.x;
    if (i < 2 * BQ) {
      const int r = i % BQ;
      const bool ok = q0 + r < Lq;
      const float* src = (i < BQ ? lse_b : delta_b) + (ok ? q0 + r : 0);
      cp_async4((i < BQ ? ls : dls) + st * BQ + r, src, ok);
    }
  };

  // Causal: q rows before k0 see none of these keys.
  const int first = causal ? k0 / BQ : 0;
  const int tiles = (Lq + BQ - 1) / BQ;
  load_async<BN, D, NT>(ks, k + b * sk.b + h * sk.h, sk.l, k0, Lk);
  load_async<BN, D, NT>(vs, v + b * sv.b + h * sv.h, sv.l, k0, Lk);
  if (first < tiles) load_q_tile(first, 0);
  cp_async_commit();

  const float sl2 = scale * kLog2e;
  float dk_acc[D / 8][4], dv_acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[n][e] = dv_acc[n][e] = 0.f;

  for (int t = first; t < tiles; ++t) {
    const int st = (t - first) & 1;
    if (t + 1 < tiles) {
      load_q_tile(t + 1, st ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int q0 = t * BQ;
    const bf16* qt = qs + st * BQ * S;
    const bf16* gt = gs + st * BQ * S;
    const float* lt = ls + st * BQ;
    const float* dlt = dls + st * BQ;
    const bool skip = (causal && q0 + BQ - 1 < wkey) || wkey >= Lk;
    if (!skip) {
      float s[BQ / 8][4], dp[BQ / 8][4];
#pragma unroll
      for (int j = 0; j < BQ / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        uint32_t ka[4], va[4];
        ldsm_x4(ka, a_addr<S>(ks, warp * 16, kk * 16, lane));
        ldsm_x4(va, a_addr<S>(vs, warp * 16, kk * 16, lane));
#pragma unroll
        for (int j = 0; j < BQ / 8; j += 2) {
          uint32_t qf[4], gf[4];
          ldsm_x4(qf, b_addr<S>(qt, j * 8, kk * 16, lane));
          ldsm_x4(gf, b_addr<S>(gt, j * 8, kk * 16, lane));
          mma(s[j], ka, qf[0], qf[1]);
          mma(s[j + 1], ka, qf[2], qf[3]);
          mma(dp[j], va, gf[0], gf[1]);
          mma(dp[j + 1], va, gf[2], gf[3]);
        }
      }
      const bool masked =
          (causal && q0 < wkey + 15) || q0 + BQ > Lq || wkey + 16 > Lk;
#pragma unroll
      for (int j = 0; j < BQ / 8; ++j) {
        const float2 l2 = *reinterpret_cast<const float2*>(lt + j * 8 + 2 * c);
        const float2 d2 =
            *reinterpret_cast<const float2*>(dlt + j * 8 + 2 * c);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float lse_r = (e & 1) ? l2.y : l2.x;
          const float delta_r = (e & 1) ? d2.y : d2.x;
          bool ok = true;
          if (masked) {
            const int row = q0 + j * 8 + 2 * c + (e & 1);
            const int key = wkey + gq + (e >> 1) * 8;
            ok = row < Lq && key < Lk && (!causal || row >= key);
          }
          const float p = ok ? exp2f(fmaf(s[j][e], sl2, -lse_r * kLog2e))
                             : 0.f;
          s[j][e] = p;
          dp[j][e] = p * (dp[j][e] - delta_r) * scale;
        }
      }
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk) {
        uint32_t pa[4], da[4];
        a_frag(pa, s, kk);
        a_frag(da, dp, kk);
#pragma unroll
        for (int n = 0; n < D / 8; n += 2) {
          uint32_t gf[4], qf[4];
          ldsm_x4_t(gf, bt_addr<S>(gt, kk * 16, n * 8, lane));
          ldsm_x4_t(qf, bt_addr<S>(qt, kk * 16, n * 8, lane));
          mma(dv_acc[n], pa, gf[0], gf[1]);
          mma(dv_acc[n + 1], pa, gf[2], gf[3]);
          mma(dk_acc[n], da, qf[0], qf[1]);
          mma(dk_acc[n + 1], da, qf[2], qf[3]);
        }
      }
    }
    __syncthreads();                           // stage st may be refilled
  }
  // With no q tile to sweep, K and V may still be in flight.
  cp_async_wait<0>();
  __syncthreads();
  // The warp's own K and V rows are free: only it read them.
  const int bh_ = block_y(), b_ = bh_ / H, h_ = bh_ % H;
  store_rows_tc<D>(ks + warp * 16 * S, dk_acc, dk, b_, h_, H, Lk, wkey, lane);
  store_rows_tc<D>(vs + warp * 16 * S, dv_acc, dv, b_, h_, H, Lk, wkey, lane);
}

template <int D>
constexpr size_t dkv_smem() {
  constexpr int BQ = D == 128 ? 32 : 64;
  return (size_t)(2 * 64 + 4 * BQ) * (D + 8) * sizeof(bf16) +
         (size_t)4 * BQ * sizeof(float);
}

}  // namespace tc

// ---- bf16 on Hopper's warpgroup MMA (K1, K2) ----------------------------------
//
// wgmma (hopper_mma.cuh, namespace wg) reads the B operand, and A in the SS
// form, straight from swizzled shared memory through a matrix descriptor,
// once for all 64 rows: no ldmatrix and no operand registers, which is what
// holds an mma.sync design back (there a warp's 16 rows issue ~36
// ldmatrix.x4 per 64 products, as many shared-memory cycles as tensor-core
// cycles). K1 and K2 use its SS form for S = Q·Kᵀ and dP = dO·Vᵀ and its RS
// form for P·V and dS·K; K2 reads one K tile both K-major and MN-major.

namespace wg {

// ---- K1, bf16 ----------------------------------------------------------------
// Replaces _flash_kernel (ray_tpu/ops/flash_attention.py:39) for bf16.
// Bounded by the tensor cores and the exp2 unit together: at D = 64 a
// 64×64 score tile costs 2·2·64·64·64 flops of products and 64·64 exp2,
// the same number of clocks of an SM at their peak rates (4096 flops and
// 16 exp2 a clock), so the kernel is as fast as it overlaps the two. A
// block of two warpgroups owns 128 query rows of one (batch, head), 64 a
// warpgroup, two blocks an SM at D ≤ 64; Q stays in shared memory for the
// sweep, and 64-key tiles of K and of V stream through two-stage cp.async
// rings of their own, each tile shared by both warpgroups. Each warpgroup
// software-pipelines its sweep as FlashAttention-3 does: at tile j it
// issues S_j = Q·K_jᵀ (form a) and, behind it, O += P_{j-1}·V_{j-1} (form
// b, P from registers, V read as stored), waits for S_j alone, and runs
// the online softmax of S_j (log2 units, scale·log2e folded into one
// FFMA, exp2 on the unit alone) while the tensor cores still work on
// P_{j-1}·V_{j-1}; only then does it wait for that product and rescale O.
// The copy of K_{j+1} and V_j is in flight under tile j. Causal: the sweep
// stops at the diagonal, each warpgroup at its own, and only tiles that
// cross it or the end of K are masked — to kNegInf, so a masked p is
// exactly 0 and a row with nothing visible yields no NaN. lse goes out in
// natural-log units, as K2 and K3 read it; O is divided by l, as in JAX.
template <int D>
struct Fwd {
  static constexpr int WG = 2, NT = 128 * WG, BM = 64 * WG, BN = 64;
  static constexpr int MIN_BLOCKS = D == 128 ? 1 : 2;
  static constexpr int NP = panels<D>();
  static constexpr int QB = tile_bytes<BM, D>();
  static constexpr int KB = tile_bytes<BN, D>();
  static constexpr size_t smem = 1024 + QB + 4 * KB;
};

template <int D>
__global__ void __launch_bounds__(Fwd<D>::NT, Fwd<D>::MIN_BLOCKS)
    flash_fwd_wgmma_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, bf16* __restrict__ o, float* __restrict__ lse,
    Strides sq, Strides sk, Strides sv, int H, int Lq, int Lk, float scale,
    int causal) {
  using C = Fwd<D>;
  constexpr int BN = C::BN, NP = C::NP, BM = C::BM, NT = C::NT;
  extern __shared__ float4 smem4[];
  uint8_t* qs = align1024(smem4);              // [BM rows]
  uint8_t* ks = qs + C::QB;                    // [2 stages][BN rows]
  uint8_t* vs = ks + 2 * C::KB;                // [2 stages][BN rows]

  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int q0 = q_tile_start(BM);
  const int wgi = threadIdx.x >> 7;
  const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int g = lane >> 2, c = lane & 3;
  const int wg_row = q0 + wgi * 64;            // this warpgroup's first row
  const int wrow = wg_row + warp * 16;         // this warp's first row
  const bf16* kb = k + b * sk.b + h * sk.h;
  const bf16* vb = v + b * sv.b + h * sv.h;
  const int end = causal ? min(Lk, min(q0 + BM, Lq)) : Lk;
  const int tiles = (end + BN - 1) / BN;
  // The tiles this warpgroup's rows see: causal, an earlier warpgroup stops
  // one tile before the next one; rows all past Lq see none.
  const int mine =
      wg_row >= Lq ? 0
      : causal ? (min(Lk, min(wg_row + 64, Lq)) + BN - 1) / BN : tiles;

  // cp.async group 0 holds Q and K_0; group j ≥ 1 holds K_j (if any) and
  // V_{j-1}, in stages j & 1 and (j - 1) & 1.
  auto load_group = [&](int j) {
    if (j < tiles)
      load_sw<BN, D, NT>(ks + (j & 1) * C::KB, kb, sk.l, j * BN, Lk);
    load_sw<BN, D, NT>(vs + ((j - 1) & 1) * C::KB, vb, sv.l, (j - 1) * BN,
                       Lk);
    tc::cp_async_commit();
  };
  load_sw<BM, D, NT>(qs, q + b * sq.b + h * sq.h, sq.l, q0, Lq);
  load_sw<BN, D, NT>(ks, kb, sk.l, 0, Lk);
  tc::cp_async_commit();
  load_group(1);

  const uint32_t q_addr = tc::smem_u32(qs) + wgi * 64 * 128;
  const float sl2 = scale * tc::kLog2e;
  float acc[NP * 8][4];
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};  // l: this lane's part
  float alpha[2];
#pragma unroll
  for (int n = 0; n < NP * 8; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  // S_j = Q·K_jᵀ, issued as one commit group.
  auto issue_s = [&](float (&s)[BN / 8][4], int j) {
    const uint32_t kt = tc::smem_u32(ks + (j & 1) * C::KB);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      mma_ss(s, desc(q_addr + kmajor_step<BM>(kk)),
             desc(kt + kmajor_step<BN>(kk)), kk > 0);
    commit();
  };
  // O += P·V_j, P in registers, issued as one commit group.
  auto issue_pv = [&](const uint32_t (&pa)[BN / 16][4], int j) {
    const uint32_t vt = tc::smem_u32(vs + (j & 1) * C::KB);
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk)
#pragma unroll
      for (int p = 0; p < NP; ++p)
        mma_rs(panel(acc, p), pa[kk], desc(vt + mnmajor_step<BN>(kk, p)));
    commit();
  };
  // The online softmax of S_j into (m, l): P_j packed to bf16 A fragments,
  // and in alpha the factor O takes before P_j·V_j. The max is taken on
  // the raw scores and m kept in log2 units, so a p costs one FFMA into
  // exp2; a masked score is kNegInf and its p exactly 0, also in a row with
  // nothing visible yet (where the FFMA alone would give exp2(0)).
  auto softmax = [&](float (&s)[BN / 8][4], int j,
                     uint32_t (&pa)[BN / 16][4]) {
    const int k0 = j * BN;
    const bool masked = (causal && k0 + BN - 1 > wrow) || k0 + BN > Lk;
    if (masked) {
#pragma unroll
      for (int jj = 0; jj < BN / 8; ++jj)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = k0 + jj * 8 + 2 * c + (e & 1);
          const int row = wrow + g + (e >> 1) * 8;
          if (col >= Lk || (causal && col > row)) s[jj][e] = kNegInf;
        }
    }
    float mx[2] = {kNegInf, kNegInf}, nm[2];
#pragma unroll
    for (int jj = 0; jj < BN / 8; ++jj)
#pragma unroll
      for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], s[jj][e]);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(kFull, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(kFull, mx[i], 2));
      const float m_new = fmaxf(m[i], mx[i] * sl2);
      alpha[i] = exp2_ftz(m[i] - m_new);
      m[i] = m_new;
      nm[i] = -m_new;
      l[i] *= alpha[i];
    }
#pragma unroll
    for (int jj = 0; jj < BN / 8; ++jj)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float p = exp2_ftz(fmaf(s[jj][e], sl2, nm[e >> 1]));
        if (masked && s[jj][e] == kNegInf) p = 0.f;
        s[jj][e] = p;
        l[e >> 1] += p;
      }
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) tc::a_frag(pa[kk], s, kk);
  };

  // The barriers and copies are the block's; the products and the softmax
  // are each warpgroup's, over its own `mine` tiles.
  float s[BN / 8][4];
  uint32_t pa[BN / 16][4];                     // P of the tile whose P·V is next
  tc::cp_async_wait<1>();                      // group 0: Q and K_0
  proxy_fence();
  __syncthreads();
  if (mine > 0) {
    fence();
    issue_s(s, 0);
    wait_group<0>();
    hold(s);
    softmax(s, 0, pa);                         // O is 0: alpha needs no use
  }
  for (int j = 1; j < tiles; ++j) {
    tc::cp_async_wait<0>();                    // group j: K_j and V_{j-1}
    proxy_fence();
    // Every product of tile j-1 is done in every warp: the stages of K_{j-1}
    // and V_{j-2} may be refilled.
    __syncthreads();
    load_group(j + 1);
    if (j < mine) {
      fence();
      issue_s(s, j);
      issue_pv(pa, j - 1);
      wait_group<1>();
      hold(s);                                 // S_j is here; P·V runs on
      uint32_t pn[BN / 16][4];
      softmax(s, j, pn);
      wait_group<0>();
      hold(acc);
      hold(pa);
#pragma unroll
      for (int n = 0; n < NP * 8; ++n) {
        acc[n][0] *= alpha[0], acc[n][1] *= alpha[0];
        acc[n][2] *= alpha[1], acc[n][3] *= alpha[1];
      }
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk)
#pragma unroll
        for (int e = 0; e < 4; ++e) pa[kk][e] = pn[kk][e];
    } else if (j == mine) {                    // this warpgroup's last P·V
      fence();
      issue_pv(pa, j - 1);
      wait_group<0>();
      hold(acc);
      hold(pa);
    }
  }
  tc::cp_async_wait<0>();                      // the last group: V_{tiles-1}
  proxy_fence();
  __syncthreads();
  if (mine == tiles) {
    fence();
    issue_pv(pa, tiles - 1);
    wait_group<0>();
    hold(acc);
    hold(pa);
  }
  __syncthreads();                             // the rings are read no more

  const int bh_ = block_x();
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(kFull, l[i], 1);
    l[i] += __shfl_xor_sync(kFull, l[i], 2);
    const float denom = fmaxf(l[i], 1e-30f);
    const int row = wrow + g + i * 8;
    if (c == 0 && row < Lq)
      lse[(long long)bh_ * Lq + row] = m[i] * tc::kLn2 + logf(denom);
#pragma unroll
    for (int n = 0; n < NP * 8; ++n) {           // divided, as in JAX
      acc[n][2 * i] /= denom;
      acc[n][2 * i + 1] /= denom;
    }
  }
  // Each warp stages its 16 rows in its own part of the rings.
  bf16* stage = reinterpret_cast<bf16*>(ks) + (threadIdx.x >> 5) * 16 * (D + 8);
  tc::store_rows_tc<D>(stage, cols<D>(acc), o, bh_ / H, bh_ % H, H, Lq, wrow,
                       lane);
}

// ---- K2, bf16 ----------------------------------------------------------------
// Replaces _dq_kernel (ray_tpu/ops/flash_attention.py:146) for bf16.
// Bounded by the tensor cores (three products of 2·64·64·D flops per 64×64
// tile and warpgroup) and the exp2 unit (64·64 recomputed p). A block of two
// warpgroups owns 128 query rows of one (batch, head), 64 a warpgroup; Q and
// dO stay in shared memory for the sweep, each accumulator row's lse (in
// log2 units) and delta in registers, and 64-key tiles of K and V stream
// through a two-stage cp.async ring. Per tile and warpgroup:
//   S = Q·Kᵀ and dP = dO·Vᵀ (form a, both 64 × 64 f32, one commit group),
//   P = exp2(S·scale·log2e − lse·log2e), dS = P·(dP − delta)·scale on the
//   accumulator fragments (masked only on tiles that cross the diagonal or
//   the end of K),
//   dQ += dS·K (form b), dS cast to bf16 in registers, the K tile read
//   MN-major from the same bytes that S read K-major.
// dQ is an f32 accumulator in registers for the whole sweep, written once
// through the store staging: no atomics, the same bits every run. K2 stays
// a kernel of its own: folding dQ into K3 would need f32 atomics from every
// key block.
template <int D>
struct Dq {
  static constexpr int WG = 2, NT = 128 * WG, BM = 64 * WG;
  static constexpr int BN = 64;
  static constexpr int MIN_BLOCKS = D == 128 ? 1 : 2;
  static constexpr int NP = panels<D>();
  static constexpr int QB = tile_bytes<BM, D>();
  static constexpr int KB = tile_bytes<BN, D>();
  static constexpr size_t smem = 1024 + 2 * QB + 4 * KB;
};

template <int D>
__global__ void __launch_bounds__(Dq<D>::NT, Dq<D>::MIN_BLOCKS)
    flash_dq_wgmma_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const bf16* __restrict__ g,
    const float* __restrict__ lse, const float* __restrict__ delta,
    bf16* __restrict__ dq, Strides sq, Strides sk, Strides sv, Strides sg,
    int H, int Lq, int Lk, float scale, int causal) {
  using C = Dq<D>;
  constexpr int BN = C::BN, NP = C::NP, BM = C::BM, NT = C::NT;
  extern __shared__ float4 smem4[];
  uint8_t* qs = align1024(smem4);              // [BM rows]
  uint8_t* gs = qs + C::QB;                    // dO, [BM rows]
  uint8_t* ks = gs + C::QB;                    // [2 stages][BN rows]
  uint8_t* vs = ks + 2 * C::KB;                // [2 stages][BN rows]

  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int q0 = q_tile_start(BM);
  const int wgi = threadIdx.x >> 7;
  const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int gq = lane >> 2, c = lane & 3;
  const int wg_row = q0 + wgi * 64;
  const int wrow = wg_row + warp * 16;
  const bf16* kb = k + b * sk.b + h * sk.h;
  const bf16* vb = v + b * sv.b + h * sv.h;
  const int end = causal ? min(Lk, min(q0 + BM, Lq)) : Lk;
  const int tiles = (end + BN - 1) / BN;

  load_sw<BM, D, NT>(qs, q + b * sq.b + h * sq.h, sq.l, q0, Lq);
  load_sw<BM, D, NT>(gs, g + b * sg.b + h * sg.h, sg.l, q0, Lq);
  load_sw<BN, D, NT>(ks, kb, sk.l, 0, Lk);
  load_sw<BN, D, NT>(vs, vb, sv.l, 0, Lk);
  tc::cp_async_commit();

  // Rows gq and gq + 8: -lse in log2 units and -delta·scale, so that
  // p = exp2(fma(s, scale·log2e, nl)) and dS = p · fma(dp, scale, nd).
  float nl[2], nd[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = wrow + gq + i * 8;
    nl[i] = row < Lq ? -lse[(long long)bh * Lq + row] * tc::kLog2e : 0.f;
    nd[i] = row < Lq ? -delta[(long long)bh * Lq + row] * scale : 0.f;
  }
  const uint32_t q_addr = tc::smem_u32(qs) + wgi * 64 * 128;
  const uint32_t g_addr = tc::smem_u32(gs) + wgi * 64 * 128;
  const float sl2 = scale * tc::kLog2e;
  float acc[NP * 8][4];
#pragma unroll
  for (int n = 0; n < NP * 8; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  for (int t = 0; t < tiles; ++t) {
    if (t + 1 < tiles) {
      const int st = (t + 1) & 1;
      load_sw<BN, D, NT>(ks + st * C::KB, kb, sk.l, (t + 1) * BN, Lk);
      load_sw<BN, D, NT>(vs + st * C::KB, vb, sv.l, (t + 1) * BN, Lk);
      tc::cp_async_commit();
      tc::cp_async_wait<1>();                  // tile t (and Q, dO) have landed
    } else {
      tc::cp_async_wait<0>();
    }
    proxy_fence();
    __syncthreads();
    const int k0 = t * BN;
    const uint32_t kt = tc::smem_u32(ks + (t & 1) * C::KB);
    const uint32_t vt = tc::smem_u32(vs + (t & 1) * C::KB);
    const bool skip = (causal && k0 > wg_row + 63) || wg_row >= Lq;
    if (!skip) {
      float s[BN / 8][4], dp[BN / 8][4];
      fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        mma_ss(s, desc(q_addr + kmajor_step<BM>(kk)),
               desc(kt + kmajor_step<BN>(kk)), kk > 0);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        mma_ss(dp, desc(g_addr + kmajor_step<BM>(kk)),
               desc(vt + kmajor_step<BN>(kk)), kk > 0);
      commit();
      wait_group<0>();
      hold(s);
      hold(dp);
      const bool masked = (causal && k0 + BN - 1 > wrow) || k0 + BN > Lk;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          bool ok = true;
          if (masked) {
            const int col = k0 + j * 8 + 2 * c + (e & 1);
            const int row = wrow + gq + (e >> 1) * 8;
            ok = col < Lk && (!causal || col <= row);
          }
          const float p = ok ? exp2_ftz(fmaf(s[j][e], sl2, nl[e >> 1])) : 0.f;
          s[j][e] = p * fmaf(dp[j][e], scale, nd[e >> 1]);
        }
      uint32_t da[BN / 16][4];
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk) tc::a_frag(da[kk], s, kk);
      fence();
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk)
#pragma unroll
        for (int p = 0; p < NP; ++p)
          mma_rs(panel(acc, p), da[kk], desc(kt + mnmajor_step<BN>(kk, p)));
      commit();
      wait_group<0>();
      hold(acc);
      hold(da);
    }
    __syncthreads();                           // stage t & 1 may be refilled
  }

  const int bh_ = block_x();
  bf16* stage = reinterpret_cast<bf16*>(ks) + (threadIdx.x >> 5) * 16 * (D + 8);
  tc::store_rows_tc<D>(stage, cols<D>(acc), dq, bh_ / H, bh_ % H, H, Lq, wrow,
                       lane);
}

}  // namespace wg

// ---- launch -----------------------------------------------------------------
template <int D>
constexpr size_t smem_bytes(int tiles, int score_tiles) {
  return ((size_t)tiles * kTile * (D + 4) + (size_t)score_tiles * kTile * kPT) *
         sizeof(float);
}

template <typename K>
int prepare(K kernel, size_t smem) {
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

struct Args {
  const void *q, *k, *v, *g, *lse, *delta;
  void *o, *lse_out, *dq, *dk, *dv;
  Strides sq, sk, sv, sg;
  int B, H, Lq, Lk;
  float scale;
  int causal;
  cudaStream_t stream;
};

// bf16 K1 and K2 on wgmma, K3 on mma.sync.
template <int D>
int launch_tc(int which, const Args& a) {
  using tc::bf16;
  if (which == 0) {
    const size_t smem = wg::Fwd<D>::smem;
    auto kern = wg::flash_fwd_wgmma_kernel<D>;
    if (int rc = prepare(kern, smem)) return rc;
    using C = wg::Fwd<D>;
    kern<<<dim3(a.B * a.H, (a.Lq + C::BM - 1) / C::BM), C::NT, smem,
           a.stream>>>(
        static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
        static_cast<const bf16*>(a.v), static_cast<bf16*>(a.o),
        static_cast<float*>(a.lse_out), a.sq, a.sk, a.sv, a.H, a.Lq, a.Lk,
        a.scale, a.causal);
  } else if (which == 1) {
    const size_t smem = wg::Dq<D>::smem;
    auto kern = wg::flash_dq_wgmma_kernel<D>;
    if (int rc = prepare(kern, smem)) return rc;
    using C = wg::Dq<D>;
    kern<<<dim3(a.B * a.H, (a.Lq + C::BM - 1) / C::BM), C::NT, smem,
           a.stream>>>(
        static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
        static_cast<const bf16*>(a.v), static_cast<const bf16*>(a.g),
        static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
        static_cast<bf16*>(a.dq), a.sq, a.sk, a.sv, a.sg, a.H, a.Lq, a.Lk,
        a.scale, a.causal);
  } else {
    const size_t smem = tc::dkv_smem<D>();
    auto kern = tc::flash_dkv_mma_kernel<D>;
    if (int rc = prepare(kern, smem)) return rc;
    kern<<<dim3((a.Lk + 63) / 64, a.B * a.H), tc::kDkvThreads, smem,
           a.stream>>>(
        static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
        static_cast<const bf16*>(a.v), static_cast<const bf16*>(a.g),
        static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
        static_cast<bf16*>(a.dk), static_cast<bf16*>(a.dv), a.sq, a.sk, a.sv,
        a.sg, a.H, a.Lq, a.Lk, a.scale, a.causal);
  }
  return 0;
}

// One CUDA-core kernel: W = 0 (K1), 1 (K2) or 2 (K3).
template <typename T, int D, int W>
int launch_cuda_cores(const Args& a) {
  const dim3 block(kThreads);
  const int q_tiles = (a.Lq + kTile - 1) / kTile;
  const int k_tiles = (a.Lk + kTile - 1) / kTile;
  if constexpr (W == 0) {
    const size_t smem = smem_bytes<D>(3, 1);
    auto kern = flash_fwd_kernel<T, D>;
    if (int rc = prepare(kern, smem)) return rc;
    kern<<<dim3(q_tiles, a.B * a.H), block, smem, a.stream>>>(
        static_cast<const T*>(a.q), static_cast<const T*>(a.k),
        static_cast<const T*>(a.v), static_cast<T*>(a.o),
        static_cast<float*>(a.lse_out), a.sq, a.sk, a.sv, a.H, a.Lq, a.Lk,
        a.scale, a.causal);
  } else if constexpr (W == 1) {
    const size_t smem = smem_bytes<D>(4, 1);
    auto kern = flash_dq_kernel<T, D>;
    if (int rc = prepare(kern, smem)) return rc;
    kern<<<dim3(q_tiles, a.B * a.H), block, smem, a.stream>>>(
        static_cast<const T*>(a.q), static_cast<const T*>(a.k),
        static_cast<const T*>(a.v), static_cast<const T*>(a.g),
        static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
        static_cast<T*>(a.dq), a.sq, a.sk, a.sv, a.sg, a.H, a.Lq, a.Lk,
        a.scale, a.causal);
  } else {
    const size_t smem = smem_bytes<D>(4, 2);
    auto kern = flash_dkv_kernel<T, D>;
    if (int rc = prepare(kern, smem)) return rc;
    kern<<<dim3(k_tiles, a.B * a.H), block, smem, a.stream>>>(
        static_cast<const T*>(a.q), static_cast<const T*>(a.k),
        static_cast<const T*>(a.v), static_cast<const T*>(a.g),
        static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
        static_cast<T*>(a.dk), static_cast<T*>(a.dv), a.sq, a.sk, a.sv, a.sg,
        a.H, a.Lq, a.Lk, a.scale, a.causal);
  }
  return 0;
}

// The dtype alone picks the kernel: bf16 on the tensor cores, f32 on the
// CUDA cores (whose bf16 instantiations are never built).
template <typename T, int D>
int launch(int which, const Args& a) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    return launch_tc<D>(which, a);
  } else {
    if (which == 0) return launch_cuda_cores<T, D, 0>(a);
    if (which == 1) return launch_cuda_cores<T, D, 1>(a);
    return launch_cuda_cores<T, D, 2>(a);
  }
}

template <typename T>
int launch_d(int which, int D, const Args& a) {
  switch (D) {
    case 32:
      return launch<T, 32>(which, a);
    case 64:
      return launch<T, 64>(which, a);
    case 128:
      return launch<T, 128>(which, a);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

int run(int which, Args& a, const long long* strides, int n_strided, int D,
        int dtype) {
  if (a.B <= 0 || a.H <= 0 || a.Lq <= 0 || a.Lk <= 0 ||
      (long long)a.B * a.H > 65535)
    return (int)cudaErrorInvalidValue;
  Strides* dst[4] = {&a.sq, &a.sk, &a.sv, &a.sg};
  for (int i = 0; i < n_strided; ++i)
    *dst[i] = Strides{strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  int rc;
  if (dtype == 0)
    rc = launch_d<float>(which, D, a);
  else if (dtype == 1)
    rc = launch_d<__nv_bfloat16>(which, D, a);
  else
    rc = (int)cudaErrorInvalidValue;
  if (rc != 0) return rc;
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C interface, loaded with ctypes. dtype: 0 = float32, 1 = bfloat16.
// `strides` holds (b, l, h) element strides of q, k, v (and g for the
// backward), in that order; D has unit stride and every operand is 16-byte
// aligned with strides a whole number of 16-byte loads (the wrapper checks).
// Each returns cudaGetLastError() after its launch (0 = cudaSuccess); the
// Python wrapper raises on anything else.
extern "C" int ray_tpu_torch_flash_forward(
    const void* q, const void* k, const void* v, void* o, void* lse,
    const long long* strides, int B, int H, int Lq, int Lk, int D,
    float scale, int causal, int dtype, void* stream) {
  Args a{};
  a.q = q, a.k = k, a.v = v, a.o = o, a.lse_out = lse;
  a.B = B, a.H = H, a.Lq = Lq, a.Lk = Lk, a.scale = scale, a.causal = causal;
  a.stream = static_cast<cudaStream_t>(stream);
  return run(0, a, strides, 3, D, dtype);
}

extern "C" int ray_tpu_torch_flash_dq(
    const void* q, const void* k, const void* v, const void* g,
    const void* lse, const void* delta, void* dq, const long long* strides,
    int B, int H, int Lq, int Lk, int D, float scale, int causal, int dtype,
    void* stream) {
  Args a{};
  a.q = q, a.k = k, a.v = v, a.g = g, a.lse = lse, a.delta = delta, a.dq = dq;
  a.B = B, a.H = H, a.Lq = Lq, a.Lk = Lk, a.scale = scale, a.causal = causal;
  a.stream = static_cast<cudaStream_t>(stream);
  return run(1, a, strides, 4, D, dtype);
}

extern "C" int ray_tpu_torch_flash_dkv(
    const void* q, const void* k, const void* v, const void* g,
    const void* lse, const void* delta, void* dk, void* dv,
    const long long* strides, int B, int H, int Lq, int Lk, int D,
    float scale, int causal, int dtype, void* stream) {
  Args a{};
  a.q = q, a.k = k, a.v = v, a.g = g, a.lse = lse, a.delta = delta;
  a.dk = dk, a.dv = dv;
  a.B = B, a.H = H, a.Lq = Lq, a.Lk = Lk, a.scale = scale, a.causal = causal;
  a.stream = static_cast<cudaStream_t>(stream);
  return run(2, a, strides, 4, D, dtype);
}
