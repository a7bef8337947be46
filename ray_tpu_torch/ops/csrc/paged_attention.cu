// Paged attention over the block-pool KV cache, for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel ray_tpu/ops/paged_attention.py:_paged_kernel.
// Query t of slot s sits at absolute position lengths[s] + t and attends every
// kv position <= that, gathered through the slot's block table
// tables[s, :] (block 0 is the trash block; an out-of-range entry is clamped,
// as the JAX gather clamps). Online softmax in f32, the same -1e30 mask value
// as the JAX kernel, output in q's dtype.
//
// Two kernels behind one entry. The wrapper (ops/paged_attention.py,
// paged_route) picks one by dtype and T alone, never by the lengths, which
// stay on the card:
//
// * paged_prefill_wgmma_kernel — bf16 at T above the route's threshold: the
//   engine's prefill (S = 1, T = a prompt bucket). It does O(T · ctx) work on
//   O(ctx) bytes, ~1.6 GFLOP on ~3 MB at T = 1024, so it belongs on the
//   tensor cores. A block owns 64 query rows of one (slot, head), Q resident
//   in swizzled shared memory, and 4 warpgroups (2 at D = 128) share out its
//   64-key tiles: each streams its own through a two-stage cp.async ring,
//   S = Q·Kᵀ from shared memory and O += P·V with P from registers
//   (hopper_mma.cuh), pipelined as FlashAttention-3 does, and warpgroup 0
//   merges their (m, l, O). Key r of a tile comes from page
//   tables[s, (k0 + r) / bt], row (k0 + r) % bt. Keys past the tile's last
//   query position are zero-filled and never loaded: on the tensor cores a
//   masked p of 0 times a NaN in V is still NaN, so the CUDA-core design's
//   "masked keys are skipped" has to become "masked keys are zeros".
//
// * paged_decode_split_kernel — every f32 call, and bf16 at small T: the
//   engine's decode (S = slots, T = 1). It reads each slot's live K and V
//   once and does ~1 flop a byte, so it is bound by bytes, and at S = 4 by
//   latency: one block a (slot, head) would give 48 blocks walking up to
//   1000 keys in series on 132 SMs. So the context is split: a block owns 8
//   query rows of one (slot, head) and a fixed run of pages (the host plans
//   it from the static shapes, ops/paged_attention.py:split_plan); a split
//   past the slot's last live page exits at once. Stages of 64 keys (32 at
//   D = 128) come by cp.async, double-buffered against the math; all 8 warps
//   score (a key's dot products split over 4 or 8 threads) and all multiply
//   P·V (each thread 4 output columns over its own subset of the keys), in
//   f32 on the CUDA cores. A block with the only live split of its rows
//   writes the output itself; otherwise each writes (m, l, acc) to f32
//   scratch and the last to arrive merges them, out = Σ e^{m_i−m} acc_i /
//   Σ e^{m_i−m} l_i, counting arrivals on an int32 counter it resets to 0
//   for the next call. Every call is one launch. Masked keys are skipped, so
//   NaN in a masked position cannot reach a live output.
//
// Both kernels read q, the pools and the output in their own [S,T,H,D] /
// [nb,bt,H,D] layouts, and only live pages: pages past
// min((lengths[s] + t_hi) / bt, NB - 1) are never touched.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper_mma.cuh"

namespace {

constexpr float kNegInf = -1e30f;  // the JAX kernel's mask value
constexpr unsigned kFull = 0xffffffffu;

// Where a slot's keys live: key i of the context is row i % bt of pool
// block tables[s, i / bt], clamped into the pool.
struct Pages {
  const int* table;                // tables[s, :]
  int bt, num_blocks;
  long long tok;                   // elements between consecutive tokens, H·D
  int head;                        // h · D
  template <typename T>
  __device__ __forceinline__ const T* row(const T* pool, int key) const {
    const int page = key / bt;
    const int blk = min(max(table[page], 0), num_blocks - 1);
    return pool + ((long long)blk * bt + (key - page * bt)) * tok + head;
  }
};

// ---- prefill: bf16 on Hopper's warpgroup MMA ---------------------------------
namespace wg {

template <int D>
struct Prefill {
  // Warpgroups of a block. They own the same 64 query rows, each every
  // WGS-th key tile, and merge at the end: one warpgroup's chain of
  // products, softmax and loads takes ~2.5 µs a 64-key tile whatever the
  // ring's depth (as K1's warpgroups do), and at T = 1024 the heaviest q
  // tile has 16 key tiles, so the keys are shared out. Four fit the SM's
  // 64K registers at D <= 64 (120 a thread); two at D = 128.
  static constexpr int WGS = D == 128 ? 2 : 4;
  static constexpr int NT = 128 * WGS, BM = 64, BN = 64, NS = 2;
  static constexpr int NP = panels<D>();
  static constexpr int QB = tile_bytes<BM, D>();
  static constexpr int KB = tile_bytes<BN, D>();
  static constexpr int RING = 2 * NS * KB;          // a warpgroup's K and V
  static constexpr int E = NP * 32 + 4;             // (acc, m, l) a thread
  static_assert(E * 128 * 4 <= RING, "a partial must fit in a ring");
  static constexpr size_t smem = 1024 + QB + WGS * RING;
};

// The 128 threads of warpgroup `id` (0-based) meet; the others go on.
__device__ __forceinline__ void wg_barrier(int id) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(id + 1) : "memory");
}

// Keys [k0, k0 + 64) of one slot and head into a swizzled tile by the 128
// threads of a warpgroup (tid: the thread's index in it), each key's page
// looked up on its own (any bt); keys at or past n are zero-filled and never
// loaded.
template <int D>
__device__ __forceinline__ void load_keys(uint8_t* dst, const bf16* pool,
                                          const Pages& pg, int k0, int n,
                                          int tid) {
  constexpr int R = 64, CPR = D / 8;           // 16-byte chunks a row
  static_assert(R * CPR % 128 == 0, "tile not a whole number of loads");
#pragma unroll
  for (int i = 0; i < R * CPR / 128; ++i) {
    const int idx = tid + i * 128;
    const int r = idx / CPR, j = idx % CPR;
    const bool ok = k0 + r < n;
    tc::cp_async16(dst + sw_offset<R>(r, j),
                   ok ? pg.row(pool, k0 + r) + j * 8 : pool, ok);
  }
}

template <int D>
__global__ void __launch_bounds__(Prefill<D>::NT, 1)
    paged_prefill_wgmma_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k_pool,
    const bf16* __restrict__ v_pool, const int* __restrict__ tables,
    const int* __restrict__ lengths, bf16* __restrict__ out, int Tq, int H,
    int bt, int NB, int num_blocks, float scale) {
  using C = Prefill<D>;
  constexpr int BN = C::BN, NP = C::NP, BM = C::BM, NS = C::NS, WGS = C::WGS;
  extern __shared__ float4 smem4[];
  uint8_t* qs = align1024(smem4);              // [BM rows]
  const int wgi = threadIdx.x >> 7, tid = threadIdx.x & 127;
  uint8_t* ks = qs + C::QB + wgi * C::RING;    // [NS stages][BN rows], its own
  uint8_t* vs = ks + NS * C::KB;               // [NS stages][BN rows], its own

  const int sh = blockIdx.x, s = sh / H, h = sh % H;
  const int t0 = q_tile_start(BM);
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, c = lane & 3;
  const int wrow = t0 + warp * 16;             // this warp's first query row
  const int ctx = lengths[s];
  // The keys any row of the tile attends: up to the last row's position,
  // within the table. Later keys (the dead tail of the last live page, the
  // pages past it) are zero-filled.
  const int n_keys = min(ctx + min(Tq, t0 + BM), NB * bt);
  const int tiles = (n_keys + BN - 1) / BN;
  // This warpgroup's key tiles, wgi + i·WGS for i < mine (warpgroup 0 holds
  // tile 0, which every row sees).
  const int mine = tiles > wgi ? (tiles - wgi + WGS - 1) / WGS : 0;
  const Pages pg{tables + (long long)s * NB, bt, num_blocks, (long long)H * D,
                 h * D};

  // cp.async group 0 holds Q (warpgroup 0 loads it) and this warpgroup's
  // first K tile; group i ≥ 1 its K_i and V_{i-1} (those that exist), in
  // stages i % NS and (i - 1) % NS. The groups run NS - 1 ahead of the
  // products; an empty one is committed all the same, so every wait counts
  // alike.
  auto load_group = [&](int i) {
    if (i < mine)
      load_keys<D>(ks + (i % NS) * C::KB, k_pool, pg, (wgi + i * WGS) * BN,
                   n_keys, tid);
    if (i >= 1 && i <= mine)
      load_keys<D>(vs + ((i - 1) % NS) * C::KB, v_pool, pg,
                   (wgi + (i - 1) * WGS) * BN, n_keys, tid);
    tc::cp_async_commit();
  };
  if (wgi == 0)
    load_sw<BM, D, 128>(qs, q + (long long)s * Tq * pg.tok + h * D, pg.tok,
                        t0, Tq);
#pragma unroll
  for (int i = 0; i < NS; ++i) load_group(i);

  const uint32_t q_addr = tc::smem_u32(qs);
  const float sl2 = scale * tc::kLog2e;
  float acc[NP * 8][4];
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};  // l: this lane's part
  float alpha[2];
#pragma unroll
  for (int n = 0; n < NP * 8; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  // S_i = Q·K_iᵀ, issued as one commit group.
  auto issue_s = [&](float (&sc)[BN / 8][4], int i) {
    const uint32_t kt = tc::smem_u32(ks + (i % NS) * C::KB);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      mma_ss(sc, desc(q_addr + kmajor_step<BM>(kk)),
             desc(kt + kmajor_step<BN>(kk)), kk > 0);
    commit();
  };
  // O += P·V_i, P in registers, issued as one commit group.
  auto issue_pv = [&](const uint32_t (&pa)[BN / 16][4], int i) {
    const uint32_t vt = tc::smem_u32(vs + (i % NS) * C::KB);
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk)
#pragma unroll
      for (int p = 0; p < NP; ++p)
        mma_rs(panel(acc, p), pa[kk], desc(vt + mnmajor_step<BN>(kk, p)));
    commit();
  };
  // The online softmax of S_i into (m, l), as K1's: the max on raw scores, m
  // in log2 units, one FFMA into exp2 a p; P_i packed to bf16 A fragments,
  // and in alpha the factor O takes before P_i·V_i. Key col is masked for
  // query row t past ctx + t (and past n_keys, a zero): to kNegInf, so its p
  // is exactly 0. Only tiles that cross a row's diagonal or n_keys check.
  auto softmax = [&](float (&sc)[BN / 8][4], int i,
                     uint32_t (&pa)[BN / 16][4]) {
    const int k0 = (wgi + i * WGS) * BN;
    const bool masked = k0 + BN - 1 > ctx + wrow || k0 + BN > n_keys;
    if (masked) {
#pragma unroll
      for (int jj = 0; jj < BN / 8; ++jj)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = k0 + jj * 8 + 2 * c + (e & 1);
          const int row = wrow + g + (e >> 1) * 8;
          if (col > ctx + row || col >= n_keys) sc[jj][e] = kNegInf;
        }
    }
    float mx[2] = {kNegInf, kNegInf}, nm[2];
#pragma unroll
    for (int jj = 0; jj < BN / 8; ++jj)
#pragma unroll
      for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], sc[jj][e]);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(kFull, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(kFull, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r] * sl2);
      alpha[r] = exp2_ftz(m[r] - m_new);
      m[r] = m_new;
      nm[r] = -m_new;
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int jj = 0; jj < BN / 8; ++jj)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float p = exp2_ftz(fmaf(sc[jj][e], sl2, nm[e >> 1]));
        if (masked && sc[jj][e] == kNegInf) p = 0.f;
        sc[jj][e] = p;
        l[e >> 1] += p;
      }
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) tc::a_frag(pa[kk], sc, kk);
  };

  // Each warpgroup sweeps its own tiles: tile i's S and tile i-1's P·V are
  // issued together, and the softmax of S_i runs while P_{i-1}·V_{i-1} is
  // still on the tensor cores. Only Q is shared, so only its arrival needs
  // the whole block.
  float sc[BN / 8][4];
  uint32_t pa[BN / 16][4];                     // P of the tile whose P·V is next
  tc::cp_async_wait<NS - 1>();                 // group 0: Q and K_0
  proxy_fence();
  __syncthreads();
  if (mine > 0) {
    fence();
    issue_s(sc, 0);
    wait_group<0>();
    hold(sc);
    softmax(sc, 0, pa);                        // O is 0: alpha needs no use
  }
  for (int i = 1; i < mine; ++i) {
    tc::cp_async_wait<NS - 2>();               // group i: K_i and V_{i-1}
    proxy_fence();
    // Every product of tile i-1 is done in this warpgroup: the stages of
    // K_{i-1} and V_{i-2} may be refilled.
    wg_barrier(wgi);
    load_group(i + NS - 1);
    fence();
    issue_s(sc, i);
    issue_pv(pa, i - 1);
    wait_group<1>();
    hold(sc);                                  // S_i is here; P·V runs on
    uint32_t pn[BN / 16][4];
    softmax(sc, i, pn);
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
  }
  if (mine > 0) {
    tc::cp_async_wait<NS - 2>();               // group `mine`: the last V
    proxy_fence();
    wg_barrier(wgi);
    fence();
    issue_pv(pa, mine - 1);
    wait_group<0>();
    hold(acc);
    hold(pa);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(kFull, l[r], 1);
    l[r] += __shfl_xor_sync(kFull, l[r], 2);
  }

  // Warpgroups 1.. hand (acc, m, l) to warpgroup 0 through the rings of
  // warpgroups 1.. (thread-major: 128 consecutive floats an entry), which
  // rescales each to the common max and adds it.
  float* part = reinterpret_cast<float*>(qs + C::QB + C::RING);
  __syncthreads();                             // every ring is read no more
  if (wgi > 0) {
    float* p = part + (wgi - 1) * C::E * 128 + tid;
#pragma unroll
    for (int n = 0; n < NP * 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) p[(n * 4 + e) * 128] = acc[n][e];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      p[(NP * 32 + r) * 128] = m[r];
      p[(NP * 32 + 2 + r) * 128] = l[r];
    }
  }
  __syncthreads();
  if (wgi > 0) return;
#pragma unroll
  for (int w = 1; w < WGS; ++w) {
    const float* p = part + (w - 1) * C::E * 128 + tid;
    float a[2], b[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float mw = p[(NP * 32 + r) * 128];
      const float mm = fmaxf(m[r], mw);
      a[r] = exp2_ftz(m[r] - mm);
      b[r] = exp2_ftz(mw - mm);
      m[r] = mm;
      l[r] = l[r] * a[r] + p[(NP * 32 + 2 + r) * 128] * b[r];
    }
#pragma unroll
    for (int n = 0; n < NP * 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        acc[n][e] = acc[n][e] * a[e >> 1] + p[(n * 4 + e) * 128] * b[e >> 1];
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float denom = fmaxf(l[r], 1e-30f);
#pragma unroll
    for (int n = 0; n < NP * 8; ++n) {           // divided, as in JAX
      acc[n][2 * r] /= denom;
      acc[n][2 * r + 1] /= denom;
    }
  }
  // Each warp stages its 16 rows in its own part of warpgroup 0's K ring.
  const int sh_ = block_x();
  bf16* stage = reinterpret_cast<bf16*>(ks) + warp * 16 * (D + 8);
  tc::store_rows_tc<D>(stage, cols<D>(acc), out, sh_ / H, sh_ % H, H, Tq,
                       wrow, lane);
}

}  // namespace wg

// ---- decode: split over the context, CUDA cores --------------------------------
namespace split {

constexpr int kRows = 8;           // query rows of a block
constexpr int kThreads = 256;

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
  // 4 consecutive elements from shared memory.
  __device__ __forceinline__ static void load4(const uint8_t* p, float* out) {
    const float4 u = *reinterpret_cast<const float4*>(p);
    out[0] = u.x, out[1] = u.y, out[2] = u.z, out[3] = u.w;
  }
};
template <>
struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ __forceinline__ static void unpack2(uint32_t w, float* out) {
    const float2 f =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w));
    out[0] = f.x, out[1] = f.y;
  }
  __device__ __forceinline__ static void unpack(const uint4& u, float* out) {
    unpack2(u.x, out), unpack2(u.y, out + 2);
    unpack2(u.z, out + 4), unpack2(u.w, out + 6);
  }
  __device__ __forceinline__ static void load4(const uint8_t* p, float* out) {
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    unpack2(u.x, out), unpack2(u.y, out + 2);
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
struct Split {
  static constexpr int KS = D >= 128 ? 32 : 64;     // keys a stage
  // A staged K or V row, padded by 16 bytes: the 16-byte reads of
  // consecutive keys fall in different bank groups.
  static constexpr int ROW = D * (int)sizeof(T) + 16;
  static constexpr int STAGE = 2 * KS * ROW;        // K then V
  static constexpr int CPR = D * (int)sizeof(T) / 16;  // 16-byte chunks a row
  static constexpr int LPK = kThreads / KS;         // threads scoring one key
  static constexpr int DPT = D / LPK;               // dims each of them sums
  static constexpr int DC = D / 4;                  // 4-column output groups
  static constexpr int G = kThreads / DC;           // key groups of P·V
  static constexpr int RED = G * kRows * D * 4;     // their partial sums
  static constexpr int KV = 2 * STAGE > RED ? 2 * STAGE : RED;
  static constexpr size_t smem =
      KV + (size_t)(kRows * D + kRows * KS + 3 * kRows) * 4 + 16;
  static_assert(2 * KS * CPR % kThreads == 0, "stage not whole loads");
  static_assert(DPT * sizeof(T) % 16 == 0, "scoring reads 16 bytes");
};

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) paged_decode_split_kernel(
    const T* __restrict__ q,           // [S, Tq, H, D]
    const T* __restrict__ k_pool,      // [num_blocks, bt, H, D] (one layer)
    const T* __restrict__ v_pool,      // [num_blocks, bt, H, D]
    const int* __restrict__ tables,    // [S, NB] pool block ids, 0 = trash
    const int* __restrict__ lengths,   // [S] context before the Tq tokens
    T* __restrict__ out,               // [S, Tq, H, D]
    float* __restrict__ part_acc,      // [S, H, Tq, n_split, D]
    float* __restrict__ part_ml,       // [S, H, Tq, n_split, 2]
    int* __restrict__ counters,        // [S, H, ceil(Tq / kRows)], all 0
    int Tq, int H, int bt, int NB, int num_blocks, float scale,
    int pages_per_split, int n_split) {
  using C = Split<T, D>;
  constexpr int KS = C::KS, ROW = C::ROW;
  extern __shared__ float4 smem4[];
  uint8_t* kv = reinterpret_cast<uint8_t*>(smem4);  // [2 stages][K, V][KS]
  float* qs = reinterpret_cast<float*>(kv + C::KV); // [kRows][D]
  float* sc = qs + kRows * D;                       // scores, then p [kRows][KS]
  float* al = sc + kRows * KS;                      // alpha of the stage [kRows]
  float* ml = al + kRows;                           // final (m, l) [kRows][2]
  int* last = reinterpret_cast<int*>(ml + 2 * kRows);

  const int s = blockIdx.x, h = blockIdx.y;
  const int rt = blockIdx.z / n_split, sp = blockIdx.z - rt * n_split;
  const int t0 = rt * kRows;
  const int nr = min(kRows, Tq - t0);               // rows of this block
  const int ctx = lengths[s];
  const int n_keys = min(ctx + t0 + nr, NB * bt);   // keys its rows attend
  const int live = min(n_split, (n_keys - 1) / bt / pages_per_split + 1);
  if (sp >= live) return;                           // past the last live page
  const int k_begin = sp * pages_per_split * bt;
  const int k_end = min(n_keys, k_begin + pages_per_split * bt);
  const int stages = (k_end - k_begin + KS - 1) / KS;
  const Pages pg{tables + (long long)s * NB, bt, num_blocks, (long long)H * D,
                 h * D};
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  // Keys [k0, k0 + KS) ∩ [., k_end) of K and V into stage st; later keys
  // are zero-filled (and never read).
  auto load_stage = [&](int st, int k0) {
    uint8_t* dst = kv + (st & 1) * C::STAGE;
#pragma unroll
    for (int i = 0; i < 2 * KS * C::CPR / kThreads; ++i) {
      const int idx = threadIdx.x + i * kThreads;
      const int which = idx / (KS * C::CPR);        // 0: K, 1: V
      const int rem = idx - which * KS * C::CPR;
      const int r = rem / C::CPR, j = rem - r * C::CPR;
      const T* pool = which ? v_pool : k_pool;
      const bool ok = k0 + r < k_end;
      tc::cp_async16(dst + which * KS * ROW + r * ROW + j * 16,
                     ok ? pg.row(pool, k0 + r) + j * (16 / sizeof(T)) : pool,
                     ok);
    }
    tc::cp_async_commit();
  };
  load_stage(0, k_begin);
  for (int i = threadIdx.x; i < nr * D; i += kThreads) {
    const int r = i / D;
    qs[i] = to_f32(q[((long long)s * Tq + t0 + r) * pg.tok + h * D + i - r * D]);
  }

  // Scoring: threads [LPK·key, LPK·key + LPK) each sum DPT dims of one key.
  const int skey = threadIdx.x / C::LPK, part = threadIdx.x % C::LPK;
  // P·V: thread (dc, kg) sums output columns [4dc, 4dc + 4) over the keys
  // kg, kg + G, ... of each stage.
  const int dc = threadIdx.x % C::DC, kg = threadIdx.x / C::DC;
  float acc[kRows][4];
#pragma unroll
  for (int r = 0; r < kRows; ++r)
    acc[r][0] = acc[r][1] = acc[r][2] = acc[r][3] = 0.f;
  float m = kNegInf, l = 0.f;                       // row `warp`, in warp `warp`

  for (int st = 0; st < stages; ++st) {
    const int k0 = k_begin + st * KS;
    if (st + 1 < stages) {
      load_stage(st + 1, k0 + KS);
      tc::cp_async_wait<1>();
    } else {
      tc::cp_async_wait<0>();
    }
    __syncthreads();                                // stage st (and q) here
    const uint8_t* kt = kv + (st & 1) * C::STAGE;
    const uint8_t* vt = kt + KS * ROW;
    const int n_st = min(KS, k_end - k0);

    // Scores, scaled; a key past a row's position is kNegInf.
    {
      float dot[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) dot[r] = 0.f;
      if (skey < n_st) {
        constexpr int VN = Vec<T>::N;
        const uint8_t* kr = kt + skey * ROW + part * C::DPT * sizeof(T);
#pragma unroll
        for (int i = 0; i < C::DPT / VN; ++i) {
          float f[VN];
          Vec<T>::unpack(reinterpret_cast<const uint4*>(kr)[i], f);
#pragma unroll
          for (int r = 0; r < kRows; ++r) {
            if (r >= nr) break;
            const float* qr = qs + r * D + part * C::DPT + i * VN;
#pragma unroll
            for (int e = 0; e < VN; e += 4) {
              const float4 qv = *reinterpret_cast<const float4*>(qr + e);
              dot[r] = fmaf(qv.x, f[e], dot[r]);
              dot[r] = fmaf(qv.y, f[e + 1], dot[r]);
              dot[r] = fmaf(qv.z, f[e + 2], dot[r]);
              dot[r] = fmaf(qv.w, f[e + 3], dot[r]);
            }
          }
        }
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        if (r >= nr) break;
#pragma unroll
        for (int o = C::LPK / 2; o > 0; o >>= 1)
          dot[r] += __shfl_xor_sync(kFull, dot[r], o);
        if (part == 0)
          sc[r * KS + skey] = skey < n_st && k0 + skey <= ctx + t0 + r
                                  ? dot[r] * scale
                                  : kNegInf;
      }
    }
    __syncthreads();

    // Online softmax: warp r updates row r's (m, l) and turns its scores
    // into p (exactly 0 where masked) and its alpha.
    if (warp < nr) {
      float x[KS / 32], mx = kNegInf;
#pragma unroll
      for (int i = 0; i < KS / 32; ++i) {
        x[i] = sc[warp * KS + lane + 32 * i];
        mx = fmaxf(mx, x[i]);
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, o));
      const float m_new = fmaxf(m, mx);
      const float alpha = expf(m - m_new);
      float ps = 0.f;
#pragma unroll
      for (int i = 0; i < KS / 32; ++i) {
        const float p = x[i] == kNegInf ? 0.f : expf(x[i] - m_new);
        sc[warp * KS + lane + 32 * i] = p;
        ps += p;
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) ps += __shfl_xor_sync(kFull, ps, o);
      l = alpha * l + ps;
      m = m_new;
      if (lane == 0) al[warp] = alpha;
    }
    __syncthreads();

    // acc = alpha · acc + Σ p · V over this thread's keys; a masked key is
    // skipped, so what its V row holds cannot reach the output.
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      if (r >= nr) break;
      const float a = al[r];
      acc[r][0] *= a, acc[r][1] *= a, acc[r][2] *= a, acc[r][3] *= a;
    }
    for (int key = kg; key < n_st; key += C::G) {
      float v[4];
      Vec<T>::load4(vt + key * ROW + dc * 4 * sizeof(T), v);
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        if (r >= nr) break;
        if (k0 + key <= ctx + t0 + r) {
          const float p = sc[r * KS + key];
          acc[r][0] = fmaf(p, v[0], acc[r][0]);
          acc[r][1] = fmaf(p, v[1], acc[r][1]);
          acc[r][2] = fmaf(p, v[2], acc[r][2]);
          acc[r][3] = fmaf(p, v[3], acc[r][3]);
        }
      }
    }
    __syncthreads();                                // stage st & 1 is free
  }

  // The key groups' sums, added through shared memory (the stages are free).
  float* red = reinterpret_cast<float*>(kv);        // [G][kRows][D]
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    if (r >= nr) break;
    *reinterpret_cast<float4*>(red + (kg * kRows + r) * D + dc * 4) =
        make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
  }
  if (warp < nr && lane == 0) ml[2 * warp] = m, ml[2 * warp + 1] = l;
  __syncthreads();
  // Row t of this (slot, head) in the partials.
  const long long prow = ((long long)s * H + h) * Tq + t0;
  for (int i = threadIdx.x; i < nr * D; i += kThreads) {
    const int r = i / D, d = i - r * D;
    float sum = 0.f;
#pragma unroll 8
    for (int k = 0; k < C::G; ++k) sum += red[(k * kRows + r) * D + d];
    if (live == 1)
      store(out + ((long long)s * Tq + t0 + r) * pg.tok + h * D + d,
            sum / fmaxf(ml[2 * r + 1], 1e-30f));
    else
      part_acc[((prow + r) * n_split + sp) * D + d] = sum;
  }
  if (live == 1) return;
  if (threadIdx.x < nr) {
    float* p = part_ml + ((prow + threadIdx.x) * n_split + sp) * 2;
    p[0] = ml[2 * threadIdx.x], p[1] = ml[2 * threadIdx.x + 1];
  }

  // The last of the live splits to arrive merges them all.
  __threadfence();                                  // partials before the count
  __syncthreads();
  if (threadIdx.x == 0) {
    const int row_tiles = gridDim.z / n_split;
    int* ctr = counters + ((long long)s * H + h) * row_tiles + rt;
    *last = atomicAdd(ctr, 1) == live - 1;
    if (*last) atomicExch(ctr, 0);                  // ready for the next call
  }
  __syncthreads();
  if (!*last) return;
  __threadfence();
  for (int i = threadIdx.x; i < nr * D; i += kThreads) {
    const int r = i / D, d = i - r * D;
    const float* mlr = part_ml + (prow + r) * n_split * 2;
    const float* accr = part_acc + (prow + r) * n_split * D + d;
    float mx = kNegInf;
    for (int k = 0; k < live; ++k) mx = fmaxf(mx, __ldcg(mlr + 2 * k));
    float num = 0.f, den = 0.f;
    for (int k = 0; k < live; ++k) {
      const float w = expf(__ldcg(mlr + 2 * k) - mx);
      num = fmaf(w, __ldcg(accr + k * D), num);
      den = fmaf(w, __ldcg(mlr + 2 * k + 1), den);
    }
    store(out + ((long long)s * Tq + t0 + r) * pg.tok + h * D + d,
          num / fmaxf(den, 1e-30f));
  }
}

}  // namespace split

// ---- launch -----------------------------------------------------------------
template <typename K>
int prepare(K kernel, size_t smem) {
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

struct Args {
  const void *q, *k_pool, *v_pool, *tables, *lengths;
  void *out, *scratch, *counters;
  int S, Tq, H, bt, NB, num_blocks;
  float scale;
  int pages_per_split, n_split;
  cudaStream_t stream;
};

template <int D>
int launch_wgmma(const Args& a) {
  using C = wg::Prefill<D>;
  using tc::bf16;
  auto kern = wg::paged_prefill_wgmma_kernel<D>;
  if (int rc = prepare(kern, C::smem)) return rc;
  kern<<<dim3(a.S * a.H, (a.Tq + C::BM - 1) / C::BM), C::NT, C::smem,
         a.stream>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k_pool),
      static_cast<const bf16*>(a.v_pool), static_cast<const int*>(a.tables),
      static_cast<const int*>(a.lengths), static_cast<bf16*>(a.out), a.Tq,
      a.H, a.bt, a.NB, a.num_blocks, a.scale);
  return 0;
}

template <typename T, int D>
int launch_split(const Args& a) {
  using C = split::Split<T, D>;
  auto kern = split::paged_decode_split_kernel<T, D>;
  if (int rc = prepare(kern, C::smem)) return rc;
  const int row_tiles = (a.Tq + split::kRows - 1) / split::kRows;
  float* acc = static_cast<float*>(a.scratch);
  float* ml =
      acc ? acc + (size_t)a.S * a.H * a.Tq * a.n_split * D : nullptr;
  kern<<<dim3(a.S, a.H, row_tiles * a.n_split), split::kThreads, C::smem,
         a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k_pool),
      static_cast<const T*>(a.v_pool), static_cast<const int*>(a.tables),
      static_cast<const int*>(a.lengths), static_cast<T*>(a.out), acc, ml,
      static_cast<int*>(a.counters), a.Tq, a.H, a.bt, a.NB, a.num_blocks,
      a.scale, a.pages_per_split, a.n_split);
  return 0;
}

template <int D>
int launch(const Args& a, int dtype, int route) {
  if (route == 1) return dtype == 1 ? launch_wgmma<D>(a)
                                    : (int)cudaErrorInvalidValue;
  if (dtype == 0) return launch_split<float, D>(a);
  return launch_split<__nv_bfloat16, D>(a);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. route: 0 = paged_decode_split_kernel,
// 1 = paged_prefill_wgmma_kernel (bf16 only). The split kernel covers the
// table in n_split runs of pages_per_split pages; with n_split > 1 it needs
// `scratch` (S·H·Tq·n_split·(D + 2) floats) and `counters`
// (S·H·ceil(Tq / 8) int32, all 0, left 0). Returns cudaGetLastError() after
// the launch (0 = cudaSuccess); the Python wrapper raises on anything else.
// The pools and q must be 16-byte aligned (the wrapper checks).
extern "C" int ray_tpu_torch_paged_attention(
    const void* q, const void* k_pool, const void* v_pool, const void* tables,
    const void* lengths, void* out, void* scratch, void* counters, int S,
    int Tq, int H, int D, int bt, int NB, int num_blocks, float scale,
    int dtype, int route, int pages_per_split, int n_split, void* stream) {
  if (S <= 0 || Tq <= 0 || H <= 0 || NB <= 0 || num_blocks <= 0 || bt <= 0 ||
      bt > 32 || (dtype != 0 && dtype != 1) || (route != 0 && route != 1) ||
      n_split <= 0 || pages_per_split <= 0 ||
      (long long)pages_per_split * n_split < NB ||
      (n_split > 1 && (!scratch || !counters)))
    return (int)cudaErrorInvalidValue;
  Args a{q, k_pool, v_pool, tables, lengths, out, scratch, counters,
         S, Tq, H, bt, NB, num_blocks, scale, pages_per_split, n_split,
         static_cast<cudaStream_t>(stream)};
  int rc;
  switch (D) {
    case 32:
      rc = launch<32>(a, dtype, route);
      break;
    case 64:
      rc = launch<64>(a, dtype, route);
      break;
    case 128:
      rc = launch<128>(a, dtype, route);
      break;
    default:
      rc = (int)cudaErrorInvalidValue;
  }
  if (rc != 0) return rc;
  return (int)cudaGetLastError();
}
