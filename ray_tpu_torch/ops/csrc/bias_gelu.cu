// The MLP up-projection's epilogue, forward and backward, for NVIDIA Hopper
// (sm_90a). A port-only pair: the JAX package leaves this work to XLA's
// fusion; eagerly (ops/layers.py's linear and gelu) it is eleven passes
// over the activation forward and about fifteen backward.
//
//   forward:  pre = bf16(y + f32(b)),  out = bf16(gelu(f32(pre)))
//   backward: dpre = bf16(f32(g) * gelu'(f32(pre))),
//             partial[s][c] = sum over split s's rows of f32(dpre[r][c])
//
// y is the f32 product x @ w of cuBLAS's bf16 GEMM, b the bf16 bias, g the
// bf16 gradient of out. gelu is the tanh approximation GPT-2 uses,
//   gelu(x) = 0.5 x (1 + tanh(k (x + 0.044715 x^3))),  k = sqrt(2 / pi),
// computed in f32 registers as x * s with s = 1 / (1 + exp(-2u)) (the same
// function: 1 + tanh(u) = 2 s), and rounded to bf16 once. Its derivative is
// s + 2 x s (1 - s) u'. The backward sums the ROUNDED dpre, as autograd's
// bias gradient sums the bf16 gradient it is handed; the wrapper adds the
// per-split partials in a fixed order, so db is bit-for-bit repeatable (no
// atomics).
//
// What bounds it on this card: a few dozen flops an element against 8 bytes
// (forward: 4 read, 2 + 2 written) or 6 bytes (backward: 2 + 2 read, 2
// written) — far below the ridge, so the kernels are bounded by HBM (3.35
// TB/s) and the design moves each byte once:
//   * a thread owns 8 adjacent columns: one or two 16-byte loads and one
//     16-byte store per tensor a row, a warp 256 contiguous columns;
//   * a block is 32 x 8 threads over a 256-column tile and one split of the
//     rows; it walks its rows 16 at a time, keeping its columns' bias (and
//     in the backward their running sums) in registers the whole way;
//   * a thread issues the loads of its two rows of a step before it computes
//     either, so two rows' bytes are in flight (one row a step held the
//     forward at 2.31 TB/s, two at 2.66, four no better, on the H100);
//   * the grid is the column tiles times as many row splits as fill the card
//     once (the wrapper asks `ray_tpu_torch_bias_gelu_slots` how many blocks
//     the card holds at once), so every block does the same work and no
//     second, partial wave is left at the end.
// The row count may be anything, 0 too (the backward then writes zero
// partials); the column count must be a multiple of 8.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kVec = 8;                          // columns a thread
constexpr int kColThreads = 32;                  // threads across a tile
constexpr int kRowThreads = 8;                   // threads down a split
constexpr int kTileCols = kVec * kColThreads;    // 256
constexpr int kThreads = kColThreads * kRowThreads;
constexpr int kUnroll = 2;                       // rows a thread in flight

constexpr float kK = 0.7978845608028654f;        // sqrt(2 / pi)
constexpr float kC = 0.044715f;

struct alignas(16) Bf16x8 {
  __nv_bfloat162 h[4];
};
static_assert(sizeof(Bf16x8) == sizeof(int4), "one 16-byte vector");

// s = 1 / (1 + exp(-2u)) = (1 + tanh(u)) / 2 at x; gelu(x) = x * s. A large
// |u| gives exp = inf or 0 and s exactly 0 or 1, never a NaN.
__device__ __forceinline__ float gelu_s(float x) {
  const float u = kK * (x + kC * x * x * x);
  return 1.0f / (1.0f + __expf(-2.0f * u));
}

// 8 bf16 values from one 16-byte streaming load (read once: no reuse in L2).
__device__ __forceinline__ Bf16x8 load8(const __nv_bfloat16* p) {
  const int4 v = __ldcs(reinterpret_cast<const int4*>(p));
  return *reinterpret_cast<const Bf16x8*>(&v);
}

__device__ __forceinline__ float gelu_grad(float x) {
  const float s = gelu_s(x);
  const float du = kK * (1.0f + 3.0f * kC * x * x);
  return s + 2.0f * x * s * (1.0f - s) * du;
}

__global__ void __launch_bounds__(kThreads)
bias_gelu_forward_kernel(const float* __restrict__ y,
                         const __nv_bfloat16* __restrict__ b,
                         __nv_bfloat16* __restrict__ pre,
                         __nv_bfloat16* __restrict__ out, long long rows,
                         int cols, long long split_rows) {
  const int col = blockIdx.x * kTileCols + threadIdx.x * kVec;
  if (col >= cols) return;
  float bias[kVec];
#pragma unroll
  for (int i = 0; i < kVec; ++i) bias[i] = __bfloat162float(b[col + i]);
  const long long r0 = blockIdx.y * split_rows;
  const long long r1 = min(rows, r0 + split_rows);
  for (long long r = r0 + threadIdx.y; r < r1; r += kRowThreads * kUnroll) {
    // All of this step's loads first, so kUnroll rows are in flight.
    float4 lo[kUnroll], hi[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long ru = r + u * kRowThreads;
      if (ru < r1) {
        const float4* src = reinterpret_cast<const float4*>(
            y + ru * cols + col);
        lo[u] = __ldcs(src);
        hi[u] = __ldcs(src + 1);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long ru = r + u * kRowThreads;
      if (ru >= r1) break;
      const float v[kVec] = {lo[u].x, lo[u].y, lo[u].z, lo[u].w,
                             hi[u].x, hi[u].y, hi[u].z, hi[u].w};
      Bf16x8 p, o;
#pragma unroll
      for (int i = 0; i < kVec / 2; ++i) {
        p.h[i] = __floats2bfloat162_rn(v[2 * i] + bias[2 * i],
                                       v[2 * i + 1] + bias[2 * i + 1]);
        const float2 x = __bfloat1622float2(p.h[i]);
        o.h[i] = __floats2bfloat162_rn(x.x * gelu_s(x.x), x.y * gelu_s(x.y));
      }
      const long long at = ru * cols + col;
      if (pre != nullptr) *reinterpret_cast<Bf16x8*>(pre + at) = p;
      *reinterpret_cast<Bf16x8*>(out + at) = o;
    }
  }
}

__global__ void __launch_bounds__(kThreads)
bias_gelu_backward_kernel(const __nv_bfloat16* __restrict__ g,
                          const __nv_bfloat16* __restrict__ pre,
                          __nv_bfloat16* __restrict__ dpre,
                          float* __restrict__ partial, long long rows,
                          int cols, long long split_rows) {
  __shared__ float4 sums[kRowThreads][kTileCols / 4];
  const int col = blockIdx.x * kTileCols + threadIdx.x * kVec;
  float acc[kVec] = {};
  if (col < cols) {
    const long long r0 = blockIdx.y * split_rows;
    const long long r1 = min(rows, r0 + split_rows);
    for (long long r = r0 + threadIdx.y; r < r1;
         r += kRowThreads * kUnroll) {
      Bf16x8 gv[kUnroll], pv[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const long long ru = r + u * kRowThreads;
        if (ru < r1) {
          gv[u] = load8(g + ru * cols + col);
          pv[u] = load8(pre + ru * cols + col);
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const long long ru = r + u * kRowThreads;
        if (ru >= r1) break;
        Bf16x8 d;
#pragma unroll
        for (int i = 0; i < kVec / 2; ++i) {
          const float2 gf = __bfloat1622float2(gv[u].h[i]);
          const float2 xf = __bfloat1622float2(pv[u].h[i]);
          d.h[i] = __floats2bfloat162_rn(gf.x * gelu_grad(xf.x),
                                         gf.y * gelu_grad(xf.y));
          const float2 df = __bfloat1622float2(d.h[i]);
          acc[2 * i] += df.x;
          acc[2 * i + 1] += df.y;
        }
        *reinterpret_cast<Bf16x8*>(dpre + ru * cols + col) = d;
      }
    }
  }
  sums[threadIdx.y][2 * threadIdx.x] = make_float4(acc[0], acc[1], acc[2],
                                                   acc[3]);
  sums[threadIdx.y][2 * threadIdx.x + 1] = make_float4(acc[4], acc[5],
                                                       acc[6], acc[7]);
  __syncthreads();
  // Thread t of the block adds its tile's column t over the 8 row threads.
  const int t = threadIdx.y * kColThreads + threadIdx.x;
  const int c = blockIdx.x * kTileCols + t;
  if (c < cols) {
    const float* flat = reinterpret_cast<const float*>(sums);
    float s = 0.0f;
#pragma unroll
    for (int j = 0; j < kRowThreads; ++j) s += flat[j * kTileCols + t];
    partial[blockIdx.y * static_cast<long long>(cols) + c] = s;
  }
}

int check(long long rows, int cols, int splits) {
  if (rows < 0 || cols <= 0 || cols % kVec != 0 || splits < 1 ||
      splits > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  return 0;
}

dim3 grid(int cols, int splits) {
  return dim3((cols + kTileCols - 1) / kTileCols, splits);
}

long long split_rows(long long rows, int splits) {
  return (rows + splits - 1) / splits;
}

}  // namespace

extern "C" int ray_tpu_torch_bias_gelu_slots(int backward, int* slots) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = backward ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                       &per_sm, bias_gelu_backward_kernel, kThreads, 0)
                 : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                       &per_sm, bias_gelu_forward_kernel, kThreads, 0);
  *slots = sms * per_sm;
  return static_cast<int>(e);
}

extern "C" int ray_tpu_torch_bias_gelu_forward(
    const void* y, const void* b, void* pre, void* out, long long rows,
    int cols, int splits, void* stream) {
  if (int rc = check(rows, cols, splits)) return rc;
  bias_gelu_forward_kernel<<<grid(cols, splits), dim3(kColThreads,
                                                            kRowThreads),
                             0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(y), static_cast<const __nv_bfloat16*>(b),
      static_cast<__nv_bfloat16*>(pre), static_cast<__nv_bfloat16*>(out),
      rows, cols, split_rows(rows, splits));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int ray_tpu_torch_bias_gelu_backward(
    const void* g, const void* pre, void* dpre, void* partial,
    long long rows, int cols, int splits, void* stream) {
  if (int rc = check(rows, cols, splits)) return rc;
  bias_gelu_backward_kernel<<<grid(cols, splits), dim3(kColThreads,
                                                             kRowThreads),
                              0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(g),
      static_cast<const __nv_bfloat16*>(pre),
      static_cast<__nv_bfloat16*>(dpre), static_cast<float*>(partial), rows,
      cols, split_rows(rows, splits));
  return static_cast<int>(cudaGetLastError());
}
