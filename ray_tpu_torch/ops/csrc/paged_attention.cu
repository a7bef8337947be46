// Paged attention over the block-pool KV cache, for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel ray_tpu/ops/paged_attention.py:_paged_kernel.
// Query t of slot s sits at absolute position lengths[s] + t and attends every
// kv position <= that, gathered through the slot's block table
// tables[s, :] (block 0 is the trash block). Online softmax in f32, the same
// -1e30 mask value as the JAX kernel, output in q's dtype.
//
// What bounds it on this card: decode (T = 1) reads each slot's live K and V
// once, S * ctx * H * D * sizeof(elem) bytes each, and does ~4 flops per byte
// read — far below the ~295 flops/byte the H100 needs to be compute-bound, so
// it is bandwidth-bound at 3.35 TB/s. The prefill (S = 1, T = bucket) does
// O(T * ctx) work on O(ctx) bytes and moves towards the compute side.
//
// What the design does about it:
//   * it reads only LIVE pages: a block loops over pages
//     j <= min((len + t_max) / bt, NB - 1) and never touches the dead tail of
//     a table (which points at trash);
//   * it reads each page once per (slot, head, tile of 8 query rows): a stage
//     of up to 64 keys (several pages) is loaded by all 256 threads of the
//     block with 16-byte loads, all in flight together, into shared memory,
//     and shared by the tile's warps;
//   * q, the pools and the output are read and written in their own
//     [S,T,H,D] / [nb,bt,H,D] layouts; nothing is transposed or gathered into
//     a [S, max_len, H, D] intermediate first.
//
// Design: grid (S, H, ceil(T/8)), 256 threads a block, one warp per query row
// (warps past T only help load). Per stage, lane i scores key i of each
// 32-key sub-block against the warp's row of q (read from shared memory, K
// rows padded to D+1 floats so the lanes' reads hit distinct banks), the warp
// updates (m, l) with the online softmax, and each lane accumulates elements
// lane, lane+32, ... of p * V in f32 registers. Masked keys contribute
// nothing, so NaN or garbage in a masked position cannot reach the output,
// and dead pages are never read at all.
//
// Not done yet (a later PR's work): decode at S=4, H=12 launches only 48
// blocks, with one computing warp each, on 132 SMs — a split-KV pass over the
// context for small T would fill the card; a q-tiled wgmma path would put the
// large-T prefill on the tensor cores; TMA (or cp.async) stage loads
// double-buffered against the math would hide the load latency that each
// stage now waits out.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;  // the JAX kernel's mask value
constexpr int kRows = 8;           // query rows (warps) per block
constexpr int kThreads = 32 * kRows;
constexpr unsigned kFull = 0xffffffffu;

// Keys staged per step: 64, or 32 at D = 128, so a stage of K and V in f32
// stays near 32 KB of shared memory.
template <int D>
__host__ __device__ constexpr int stage_keys() {
  return D >= 128 ? 32 : 64;
}

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

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) paged_attention_kernel(
    const T* __restrict__ q,           // [S, Tq, H, D]
    const T* __restrict__ k_pool,      // [num_blocks, bt, H, D] (one layer)
    const T* __restrict__ v_pool,      // [num_blocks, bt, H, D]
    const int* __restrict__ tables,    // [S, NB] pool block ids, 0 = trash
    const int* __restrict__ lengths,   // [S] context before the Tq tokens
    T* __restrict__ out,               // [S, Tq, H, D]
    int Tq, int H, int bt, int NB, int num_blocks, float scale) {
  constexpr int KS = stage_keys<D>();
  constexpr int EPL = D / 32;            // output elements per lane
  constexpr int VN = Vec<T>::N;          // elements per 16-byte load
  constexpr int VPR = D / VN;            // 16-byte loads per key row
  constexpr int KP = D + 1;              // padded K row (bank-conflict free)
  constexpr int LOADS = (2 * KS * VPR + kThreads - 1) / kThreads;
  extern __shared__ float smem[];
  float* ks = smem;                      // [KS][D+1]
  float* vs = ks + KS * KP;              // [KS][D]
  float* qs = vs + KS * D;               // [kRows][D]

  const int s = blockIdx.x;
  const int h = blockIdx.y;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int t0 = blockIdx.z * kRows;
  const int t = t0 + warp;
  const bool row_ok = t < Tq;
  const int ctx = lengths[s];
  const int t_hi = min(Tq, t0 + kRows) - 1;
  // Highest page holding a position any row of this tile attends.
  const int last_page = min((ctx + t_hi) / bt, NB - 1);
  const int q_pos = ctx + t;
  const size_t tok_stride = (size_t)H * D;   // between consecutive tokens
  const int pages_per_stage = KS / bt;        // bt <= 32 <= KS

  float* qrow = qs + warp * D;
  if (row_ok) {
    const T* qp = q + ((size_t)s * Tq + t) * tok_stride + (size_t)h * D;
#pragma unroll
    for (int e = 0; e < EPL; ++e)
      qrow[lane + 32 * e] = to_f32(qp[lane + 32 * e]);
  }
  float acc[EPL];
#pragma unroll
  for (int e = 0; e < EPL; ++e) acc[e] = 0.f;
  float m = kNegInf, l = 0.f;

  for (int p0 = 0; p0 <= last_page; p0 += pages_per_stage) {
    const int n_pages = min(pages_per_stage, last_page + 1 - p0);
    const int n_keys = n_pages * bt;
    // Issue every 16-byte load of the stage before storing any of it.
    uint4 buf[LOADS];
#pragma unroll
    for (int i = 0; i < LOADS; ++i) {
      const int idx = threadIdx.x + i * kThreads;
      const int which = idx / (KS * VPR);      // 0: K, 1: V
      const int rem = idx - which * (KS * VPR);
      const int key = rem / VPR;
      if (which < 2 && key < n_keys) {
        // A table entry out of range is clamped, as the JAX gather clamps.
        int blk = tables[(size_t)s * NB + p0 + key / bt];
        blk = min(max(blk, 0), num_blocks - 1);
        const T* base = which ? v_pool : k_pool;
        const size_t off = ((size_t)blk * bt + key % bt) * tok_stride +
                           (size_t)h * D + (rem - key * VPR) * VN;
        buf[i] = __ldg(reinterpret_cast<const uint4*>(base + off));
      }
    }
#pragma unroll
    for (int i = 0; i < LOADS; ++i) {
      const int idx = threadIdx.x + i * kThreads;
      const int which = idx / (KS * VPR);
      const int rem = idx - which * (KS * VPR);
      const int key = rem / VPR;
      if (which < 2 && key < n_keys) {
        float f[VN];
        Vec<T>::unpack(buf[i], f);
        const int c = (rem - key * VPR) * VN;
        float* dst = which ? vs + key * D + c : ks + key * KP + c;
#pragma unroll
        for (int e = 0; e < VN; ++e) dst[e] = f[e];
      }
    }
    __syncthreads();

    if (row_ok) {
      for (int k0 = 0; k0 < n_keys; k0 += 32) {
        const int key = k0 + lane;
        const bool valid = key < n_keys && p0 * bt + key <= q_pos;
        float sc = kNegInf;
        if (valid) {
          const float* kr = ks + key * KP;
          float dot = 0.f;
#pragma unroll
          for (int c = 0; c < D; ++c) dot += qrow[c] * kr[c];
          sc = dot * scale;
        }
        const unsigned vmask = __ballot_sync(kFull, valid);
        if (vmask == 0) continue;            // warp-uniform
        float blk_max = sc;
#pragma unroll
        for (int o = 16; o > 0; o >>= 1)
          blk_max = fmaxf(blk_max, __shfl_xor_sync(kFull, blk_max, o));
        const float m_new = fmaxf(m, blk_max);
        const float alpha = expf(m - m_new);
        const float p = valid ? expf(sc - m_new) : 0.f;
        float psum = p;
#pragma unroll
        for (int o = 16; o > 0; o >>= 1)
          psum += __shfl_xor_sync(kFull, psum, o);
        l = alpha * l + psum;
#pragma unroll
        for (int e = 0; e < EPL; ++e) acc[e] *= alpha;
        for (int j = 0; j < 32; ++j) {
          const float pj = __shfl_sync(kFull, p, j);
          if (vmask & (1u << j)) {           // masked keys skip
            const float* vr = vs + (k0 + j) * D;
#pragma unroll
            for (int e = 0; e < EPL; ++e) acc[e] += pj * vr[lane + 32 * e];
          }
        }
        m = m_new;
      }
    }
    __syncthreads();                   // stage fully read before the next load
  }

  if (row_ok) {
    const float denom = fmaxf(l, 1e-30f);
    T* op = out + ((size_t)s * Tq + t) * tok_stride + (size_t)h * D;
#pragma unroll
    for (int e = 0; e < EPL; ++e) store(op + lane + 32 * e, acc[e] / denom);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k_pool, const void* v_pool,
           const void* tables, const void* lengths, void* out, int S, int Tq,
           int H, int bt, int NB, int num_blocks, float scale,
           cudaStream_t stream) {
  constexpr int KS = stage_keys<D>();
  const dim3 grid(S, H, (Tq + kRows - 1) / kRows);
  const size_t smem = (size_t)(KS * (D + 1) + KS * D + kRows * D) *
                      sizeof(float);
  paged_attention_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pool),
      static_cast<const T*>(v_pool), static_cast<const int*>(tables),
      static_cast<const int*>(lengths), static_cast<T*>(out), Tq, H, bt, NB,
      num_blocks, scale);
  return 0;
}

template <typename T>
int launch_d(int D, const void* q, const void* k_pool, const void* v_pool,
             const void* tables, const void* lengths, void* out, int S, int Tq,
             int H, int bt, int NB, int num_blocks, float scale,
             cudaStream_t stream) {
  switch (D) {
    case 32:
      return launch<T, 32>(q, k_pool, v_pool, tables, lengths, out, S, Tq, H,
                           bt, NB, num_blocks, scale, stream);
    case 64:
      return launch<T, 64>(q, k_pool, v_pool, tables, lengths, out, S, Tq, H,
                           bt, NB, num_blocks, scale, stream);
    case 128:
      return launch<T, 128>(q, k_pool, v_pool, tables, lengths, out, S, Tq, H,
                            bt, NB, num_blocks, scale, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Returns cudaGetLastError() after the
// launch (0 = cudaSuccess); the Python wrapper raises on anything else.
// The pools and q must be 16-byte aligned (the wrapper checks).
extern "C" int ray_tpu_torch_paged_attention(
    const void* q, const void* k_pool, const void* v_pool, const void* tables,
    const void* lengths, void* out, int S, int Tq, int H, int D, int bt,
    int NB, int num_blocks, float scale, int dtype, void* stream) {
  if (S <= 0 || Tq <= 0 || H <= 0 || NB <= 0 || num_blocks <= 0 || bt <= 0 ||
      bt > 32)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int rc;
  if (dtype == 0)
    rc = launch_d<float>(D, q, k_pool, v_pool, tables, lengths, out, S, Tq, H,
                         bt, NB, num_blocks, scale, st);
  else if (dtype == 1)
    rc = launch_d<__nv_bfloat16>(D, q, k_pool, v_pool, tables, lengths, out, S,
                                 Tq, H, bt, NB, num_blocks, scale, st);
  else
    rc = (int)cudaErrorInvalidValue;
  if (rc != 0) return rc;
  return (int)cudaGetLastError();
}
