// Flash attention forward and backward, for NVIDIA Hopper (sm_90a).
//
// Replaces the three Pallas TPU kernels of ray_tpu/ops/flash_attention.py:
//   * flash_fwd_kernel (K1) — _flash_kernel via _flash_forward: O and the row
//     log-sum-exp lse = m + log(max(l, 1e-30)) of the scaled scores;
//   * flash_dq_kernel (K2) — _dq_kernel: dq = ds·K with p recomputed from
//     (q, k, lse) and ds = p * (dO·Vᵀ - delta) * scale;
//   * flash_dkv_kernel (K3) — _dkv_kernel: dv = pᵀ·dO, dk = dsᵀ·Q.
// delta = rowsum(dO * O) is computed by torch before K2/K3, as the JAX package
// leaves it to XLA. The mask is the JAX kernels' top-left row >= col, also
// when Lq != Lk, and masked scores contribute exactly 0.
//
// Operands are read in place in their [B, L, H, D] layout (any strides with a
// unit stride on D; the wrapper passes the b, l and h strides), so no folding
// copy to [B*H, L, D] is made. O, dq, dk and dv are written contiguous in the
// dtype of q, k and v; lse and delta are [B, H, L] f32. bf16 and f32 inputs,
// all arithmetic in f32; head_dim 32, 64 or 128.
//
// What bounds it on this card: at the training shape (B=16, L=1024, H=12,
// D=64, bf16, causal) K1 does 4·D flops per attended (query, key) pair —
// ~26 GFLOP — on ~100 MB of operands, ~260 flops a byte: on the tensor cores
// (989 TFLOP/s bf16) it would be ~0.03 ms, near the ridge; K2 (6·D a pair)
// and K3 (8·D a pair) are further on the compute side. So all three are
// compute-bound, and what matters is the arithmetic rate.
//
// What this first design does about it: it keeps every intermediate out of
// device memory (no L×L matrix; each operand tile is read from device memory
// once per block) and feeds the CUDA cores' f32 FMA pipe as well as a simple
// kernel can: 64×64 tiles in shared memory as f32 rows padded to D+4 floats,
// 256 threads each owning a 4×4 block of the score tile, reading operands
// with 16-byte shared loads that hit no bank twice, 2 loads per 16 FMAs. It
// does not use the tensor cores, so it is bounded by the f32 FMA rate (67
// TFLOP/s peak), about 15× above the bf16 bound. Making it fast (wgmma on
// bf16 tiles, TMA loads double-buffered against the math, warp
// specialisation) is a later PR's work.
//
// Design: a block of 256 threads owns one (batch·head, 64-row tile); the loop
// over the other operand's tiles takes the place of the TPU's sequential
// grid axis and stops at the diagonal when causal. K1 keeps (m, l, acc) in
// registers, with the 16 threads of a row reducing by shuffles within their
// half-warp. K2 owns a q tile and loops over kv tiles; K3 owns a kv tile and
// loops over q tiles. Each output element is summed by one thread in a fixed
// order and written once: no atomics, so the gradients are bit-for-bit
// repeatable from run to run. A length that is not a multiple of 64 is
// masked inside the kernel (rows past the end are loaded as zeros, their
// scores masked, their outputs not written).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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
template <>
struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ __forceinline__ static void unpack(const uint4& u, float* out) {
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(&w[i]);
      float2 f = __bfloat1622float2(b);
      out[2 * i] = f.x;
      out[2 * i + 1] = f.y;
    }
  }
};

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

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

template <typename T, int D>
int launch(int which, const Args& a) {
  const dim3 block(kThreads);
  const int q_tiles = (a.Lq + kTile - 1) / kTile;
  const int k_tiles = (a.Lk + kTile - 1) / kTile;
  if (which == 0) {
    const size_t smem = smem_bytes<D>(3, 1);
    auto kern = flash_fwd_kernel<T, D>;
    if (int rc = prepare(kern, smem)) return rc;
    kern<<<dim3(q_tiles, a.B * a.H), block, smem, a.stream>>>(
        static_cast<const T*>(a.q), static_cast<const T*>(a.k),
        static_cast<const T*>(a.v), static_cast<T*>(a.o),
        static_cast<float*>(a.lse_out), a.sq, a.sk, a.sv, a.H, a.Lq, a.Lk,
        a.scale, a.causal);
  } else if (which == 1) {
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
