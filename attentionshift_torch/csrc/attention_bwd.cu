// Attention backward kernels for the ViT and Swin backbones (bf16, head
// dim 64 or 32).
//
// Replaces two Pallas TPU kernels of attentionshift_tpu/ops/attention.py:
//   _bwd_kernel_dq   (:364, pass A of _pallas_backward): per query tile,
//                    recompute p, dP = dO v^T, D = sum_s p*dP,
//                    dQ = (p*(dP-D)) k / sqrt(d), and emit the per-row
//                    statistics pass B needs;
//   _bwd_kernel_dkv  (:402, pass B): per key tile, recompute the
//                    probability columns, dV = p^T dO,
//                    dK = (p*(dP-D))^T q / sqrt(d).
// Both run under the custom gradient of attention_with_capture and
// attention_no_capture (the head-averaged probabilities carry no gradient).
//
// What bounds them on the H100: the tensor cores. At the bench shape (B=1,
// H=6, T=4352, d=64) pass A needs three (T, T, d) products = 6*H*T^2*d =
// 43.6 GFLOP and pass B four = 58.2 GFLOP (seven in all, against five for a
// fused one-pass backward with f32 atomics on dQ, which would give up
// determinism), against ~20 MB of q/k/v/dO and gradients: far above the
// ~295 FLOP/byte ridge (44 us and 59 us at 989 TFLOP/s). Pass A runs two
// more, below. Nothing (T, T)-sized may reach device memory. The exp2 work
// (113 M per sweep) is ~30 us on the MUFU units, under the products. At
// head dim 32 (Swin's
// (1, 24, 1276, 32)) pass A's three products are 7.5 GFLOP (7.6 us)
// against 39.1 M exp2 (9.3 us at 16 per clock per SM, 132 SMs, 1980 MHz):
// the exp work bounds it; pass B's four, 10.0 GFLOP (10.1 us), are about
// even with its exp work.
//
// What the design does about it (helpers in hopper.cuh; both kernels are
// templates on the head dim, HeadTile<HD>: at 32 a tile is 64 rows of 64
// bytes under the 64-byte swizzle, the products that contract over d take
// two k16 steps and those whose N is d are m64n32k16):
//   * one block = one warpgroup = 64 rows of its own tile (query rows in
//     pass A, keys in pass B), loaded once by TMA; the loop walks 64-row
//     tiles of the other side through a two-slot ring in dynamic shared
//     memory, each tile one TMA load under the 128-byte swizzle from a 3-D
//     (B*H, T, 64) tensor map (rows >= T of a head arrive as zeros), with
//     mbarrier completion; thread 0 refills a slot as soon as the
//     warpgroup has finished with it (a third slot measured slower);
//   * every product is wgmma m64n64k16 with f32 accumulators. The 128-byte
//     rows of head dim 64 are one swizzle atom, so one tile serves both
//     majors: K-major for S = Q K^T and dP = dO V^T (pass A), S^T = K Q^T
//     and dP^T = V dO^T (pass B); MN-major (the descriptor's transpose bit)
//     for dQ += dS K, dV += P^T dO and dK += dS^T Q. No transposed copy of
//     any tile is stored;
//   * the second product of each pair takes p or dS from the first
//     product's accumulators as its register A operand, rounded to bf16;
//   * three blocks per SM (<= 168 registers a thread, ~50 KB of shared
//     memory each) overlap one block's exp work with another's products;
//     the bench shape's 408 blocks fill 396 slots and 12 more;
//   * the exp work is branch-free: a masked entry gets exp2(-inf) = 0 (a
//     branch around each exp2 serialised their latencies and cost pass B
//     2.6x). Pass B zeroes masked key rows at the store instead, since a
//     key's p reaches only its own rows of dK and dV.
// The row normaliser is the forward's log2-sum-exp (attn_flash_forward
// writes it), so p = exp2(s * scale_log2 - lse2) is one exp2. D = sum_s
// p*dP in f32 from the bf16 p, as the TPU kernel computes it: pass A sweeps
// the key tiles twice, the first time for S, dP and D alone, the second for
// dQ; pass B reads D. (FlashAttention's rowsum(dO * out) from the bf16 out
// is one sweep, but out's rounding moves D, and each row's error returns in
// dQ times the probability-weighted mean key: where the keys share a large
// common component, as a trained model's do, dQ landed 18x further from the
// exact gradient than the plain bf16 version on an H100, 3.6e-3 at a
// largest entry of ~0.04.) p and p*(dP-D) are rounded to bf16 before the
// products that consume them, as on the TPU. Key columns in the pad gap
// [pad_lo, pad_hi) and columns >= T get p = 0, so their dK and dV rows are
// written as exact zeros (they feed the qkv projection's gradient). No
// atomics: every output is written once, by one block, and is
// deterministic.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int TILE = TILE_ROWS;
constexpr int NTHREADS = 128;  // one warpgroup
constexpr int STAGES = 2;      // ring depth of the streamed tiles
constexpr int BLOCKS_PER_SM = 3;  // resident blocks the register budget is set for

// shared memory: two own tiles, STAGES slots of two tiles, (pass B) the
// streamed tiles' row statistics, the barriers, 1024 bytes of alignment slack
template <int HD>
__host__ __device__ constexpr size_t ring_bytes() {
  return (size_t)(2 + 2 * STAGES) * HeadTile<HD>::BYTES;
}
constexpr size_t STAT_BYTES = (size_t)2 * STAGES * TILE * sizeof(float);
constexpr size_t BAR_BYTES = (size_t)(1 + STAGES) * sizeof(uint64_t);
template <int HD>
constexpr size_t dq_smem() {
  return ring_bytes<HD>() + BAR_BYTES + 1024;
}
template <int HD>
constexpr size_t dkv_smem() {
  return ring_bytes<HD>() + STAT_BYTES + BAR_BYTES + 1024;
}

typedef __nv_bfloat16 bf16;

// round to bf16 and back: the value the second product will see
__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

__device__ __forceinline__ bool masked_col(int col, int T, int pad_lo, int pad_hi) {
  return col >= T || (col >= pad_lo && col < pad_hi);
}

// write a warpgroup's (64 x HD) f32 accumulator, scaled, as bf16 rows r_a
// (i < 2) and r_b (i >= 2) of a head matrix; a row whose scale is 0 is
// written as exact zeros, whatever its accumulator holds
template <int HD>
__device__ __forceinline__ void store_rows(bf16* mh, const float (&acc)[HD / 2], float scale_a,
                                           float scale_b, int r_a, int r_b, int tig, int T) {
#pragma unroll
  for (int j = 0; j < HD / 8; ++j) {
    int c = j * 8 + tig * 2;
    if (r_a < T)
      *reinterpret_cast<uint32_t*>(mh + (size_t)r_a * HD + c) =
          scale_a == 0.f ? 0u : pack_bf16(acc[4 * j] * scale_a, acc[4 * j + 1] * scale_a);
    if (r_b < T)
      *reinterpret_cast<uint32_t*>(mh + (size_t)r_b * HD + c) =
          scale_b == 0.f ? 0u : pack_bf16(acc[4 * j + 2] * scale_b, acc[4 * j + 3] * scale_b);
  }
}

// p = exp2(x) rounded to bf16, the value the second product sees. A
// masked entry gets x = -inf, so every element takes the same
// instructions and no branch splits the exp2s.
__device__ __forceinline__ float prob(float x) { return round_bf16(exp2f(x)); }

// Pass A's step on one streamed key tile (K at k_s, V right after it),
// once its slot's barrier shows phase ``parity``: S = Q K^T and
// dP = dO V^T, then s[] := p = exp2(s * scale_log2 - lse2) rounded to bf16,
// 0 at masked key columns (the gap, or past T).
template <int HD>
__device__ __forceinline__ void dq_tile_probs(float (&s)[32], float (&dp)[32],
                                              const uint8_t* q_s, const uint8_t* do_s,
                                              const uint8_t* k_s, uint64_t* bar, int parity,
                                              int key0, int tig, float lse_a, float lse_b, int T,
                                              int pad_lo, int pad_hi, float scale_log2) {
  using HT = HeadTile<HD>;
  const uint8_t* v_s = k_s + HT::BYTES;
  mbar_wait(bar, parity);
  wgmma_fence();
#pragma unroll
  for (int kc = 0; kc < HT::KSTEPS; ++kc)  // S = Q K^T
    wgmma_ss<0>(s, HT::kmajor(q_s, kc), HT::kmajor(k_s, kc), kc);
#pragma unroll
  for (int kc = 0; kc < HT::KSTEPS; ++kc)  // dP = dO V^T
    wgmma_ss<0>(dp, HT::kmajor(do_s, kc), HT::kmajor(v_s, kc), kc);
  wgmma_commit();
  wgmma_wait();
  fence_regs(s);
  fence_regs(dp);
  if (key0 + TILE > T || (key0 + TILE > pad_lo && key0 < pad_hi)) {
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int col = key0 + (i >> 2) * 8 + tig * 2 + (i & 1);
      const float x = s[i] * scale_log2 - ((i & 2) ? lse_b : lse_a);
      s[i] = prob(masked_col(col, T, pad_lo, pad_hi) ? -INFINITY : x);
    }
  } else {
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = prob(s[i] * scale_log2 - ((i & 2) ? lse_b : lse_a));
  }
}

// Pass A after iteration ``it`` (of ``nit``) is done with ring slot st:
// thread 0 refills it with the key tile of iteration it + STAGES.
template <int HD>
__device__ __forceinline__ void dq_release_slot(uint8_t* ring, int st, uint64_t* bar, int it,
                                                int nit, int ntiles, const CUtensorMap* map_k,
                                                const CUtensorMap* map_v, int plane, int tid) {
  constexpr int TB = HeadTile<HD>::BYTES;
  __syncthreads();  // every warp is done with slot st
  if (tid == 0 && it + STAGES < nit) {
    const int next = ((it + STAGES) % ntiles) * TILE;
    mbar_expect_tx(bar, 2 * TB);
    tma_load_tile(ring + (2 * st) * TB, map_k, bar, next, plane);
    tma_load_tile(ring + (2 * st + 1) * TB, map_v, bar, next, plane);
  }
}

// Pass A: D = sum_s p*dP per row of one 64-row query tile (first sweep of
// the key tiles), then its dQ (second sweep).
template <int HD>
__global__ void __launch_bounds__(NTHREADS, BLOCKS_PER_SM)
bwd_dq(const __grid_constant__ CUtensorMap map_q, const __grid_constant__ CUtensorMap map_k,
       const __grid_constant__ CUtensorMap map_v, const __grid_constant__ CUtensorMap map_do,
       const float* __restrict__ lse2, bf16* __restrict__ dq, float* __restrict__ dd, int H, int T,
       int pad_lo, int pad_hi, float scale_log2, float scale) {
  using HT = HeadTile<HD>;
  constexpr int TB = HT::BYTES;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  uint8_t* q_s = smem;
  uint8_t* do_s = smem + TB;
  uint8_t* ring = smem + 2 * TB;  // slot s: K at 2s, V at 2s + 1 tiles
  // [0] own tiles, [1 + s] slot s
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + ring_bytes<HD>());

  const int plane = blockIdx.z * H + blockIdx.y;
  const int row0 = blockIdx.x * TILE;
  const int ntiles = (T + TILE - 1) / TILE;
  // iteration it (of 2 * ntiles) takes key tile it % ntiles through ring
  // slot it % STAGES: the first ntiles accumulate D, the rest dQ
  const int nit = 2 * ntiles;
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int i = 0; i <= STAGES; ++i) mbar_init(&bars[i], 1);
    mbar_init_fence();
    mbar_expect_tx(&bars[0], 2 * TB);
    tma_load_tile(q_s, &map_q, &bars[0], row0, plane);
    tma_load_tile(do_s, &map_do, &bars[0], row0, plane);
    for (int s = 0; s < STAGES && s < nit; ++s) {
      const int key = (s % ntiles) * TILE;
      mbar_expect_tx(&bars[1 + s], 2 * TB);
      tma_load_tile(ring + (2 * s) * TB, &map_k, &bars[1 + s], key, plane);
      tma_load_tile(ring + (2 * s + 1) * TB, &map_v, &bars[1 + s], key, plane);
    }
  }
  __syncthreads();

  const size_t head = (size_t)plane * T * HD;
  const size_t rowbase = (size_t)plane * T;
  const int warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int r_a = row0 + warp * 16 + gid;
  const int r_b = r_a + 8;
  const float lse_a = r_a < T ? lse2[rowbase + r_a] : 0.f;
  const float lse_b = r_b < T ? lse2[rowbase + r_b] : 0.f;

  // D of rows r_a, r_b: a thread sums its quarter of each key tile's
  // columns, its quad the whole row at the end of the first sweep
  float d_a = 0.f, d_b = 0.f;
  float acc[HD / 2], s[32], dp[32];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) acc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;

  mbar_wait(&bars[0], 0);
  // first sweep: S, dP and p of each key tile, D += p * dP
  for (int it = 0; it < ntiles; ++it) {
    const int st = it % STAGES;
    const uint8_t* k_s = ring + (2 * st) * TB;
    dq_tile_probs<HD>(s, dp, q_s, do_s, k_s, &bars[1 + st], (it / STAGES) & 1, it * TILE, tig,
                      lse_a, lse_b, T, pad_lo, pad_hi, scale_log2);
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      if (i & 2)
        d_b += s[i] * dp[i];
      else
        d_a += s[i] * dp[i];
    }
    dq_release_slot<HD>(ring, st, &bars[1 + st], it, nit, ntiles, &map_k, &map_v, plane, tid);
  }
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    d_a += __shfl_xor_sync(0xffffffffu, d_a, off);
    d_b += __shfl_xor_sync(0xffffffffu, d_b, off);
  }
  // second sweep: dS = p * (dP - D), dQ += dS K
  for (int it = ntiles; it < nit; ++it) {
    const int st = it % STAGES;
    const uint8_t* k_s = ring + (2 * st) * TB;
    dq_tile_probs<HD>(s, dp, q_s, do_s, k_s, &bars[1 + st], (it / STAGES) & 1,
                      (it - ntiles) * TILE, tig, lse_a, lse_b, T, pad_lo, pad_hi, scale_log2);
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] *= dp[i] - ((i & 2) ? d_b : d_a);
    uint32_t ds[4][4];
    acc_to_a(ds, s);

    wgmma_fence();
#pragma unroll
    for (int kc = 0; kc < 4; ++kc)  // dQ += dS K
      wgmma_rs<1>(acc, ds[kc], HT::mnmajor(k_s, kc), 1);
    wgmma_commit();
    wgmma_wait();
    fence_regs(acc);
    fence_regs(ds);
    dq_release_slot<HD>(ring, st, &bars[1 + st], it, nit, ntiles, &map_k, &map_v, plane, tid);
  }

  store_rows<HD>(dq + head, acc, scale, scale, r_a, r_b, tig, T);
  if (tig == 0) {
    if (r_a < T) dd[rowbase + r_a] = d_a;
    if (r_b < T) dd[rowbase + r_b] = d_b;
  }
}

// Pass B: dK and dV of one 64-row key tile, on the transposed products
// (keys as rows, queries as columns).
template <int HD>
__global__ void __launch_bounds__(NTHREADS, BLOCKS_PER_SM)
bwd_dkv(const __grid_constant__ CUtensorMap map_q, const __grid_constant__ CUtensorMap map_k,
        const __grid_constant__ CUtensorMap map_v, const __grid_constant__ CUtensorMap map_do,
        const float* __restrict__ lse2, const float* __restrict__ dd, bf16* __restrict__ dk,
        bf16* __restrict__ dv, int H, int T, int pad_lo, int pad_hi, float scale_log2,
        float scale) {
  using HT = HeadTile<HD>;
  constexpr int TB = HT::BYTES;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  uint8_t* k_s = smem;
  uint8_t* v_s = smem + TB;
  uint8_t* ring = smem + 2 * TB;  // slot s: Q at 2s, dO at 2s + 1 tiles
  float* lse_s = reinterpret_cast<float*>(smem + ring_bytes<HD>());  // [STAGES][TILE]
  float* dd_s = lse_s + STAGES * TILE;                                // [STAGES][TILE]
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + ring_bytes<HD>() + STAT_BYTES);

  const int plane = blockIdx.z * H + blockIdx.y;
  const int key0 = blockIdx.x * TILE;
  const int ntiles = (T + TILE - 1) / TILE;
  const int tid = threadIdx.x;
  const size_t rowbase = (size_t)plane * T;
  if (tid == 0) {
    for (int i = 0; i <= STAGES; ++i) mbar_init(&bars[i], 1);
    mbar_init_fence();
    mbar_expect_tx(&bars[0], 2 * TB);
    tma_load_tile(k_s, &map_k, &bars[0], key0, plane);
    tma_load_tile(v_s, &map_v, &bars[0], key0, plane);
    for (int s = 0; s < STAGES && s < ntiles; ++s) {
      mbar_expect_tx(&bars[1 + s], 2 * TB);
      tma_load_tile(ring + (2 * s) * TB, &map_q, &bars[1 + s], s * TILE, plane);
      tma_load_tile(ring + (2 * s + 1) * TB, &map_do, &bars[1 + s], s * TILE, plane);
    }
  }
  // the row statistics of a query tile: threads 0-63 lse2, 64-127 D. A
  // query row past T gets lse2 = +inf, hence p = exp2(-inf) = 0
  const float* stat = tid < TILE ? lse2 : dd;
  float* stat_s = tid < TILE ? lse_s : dd_s;
  const int srow = tid & (TILE - 1);
  const float past_end = tid < TILE ? INFINITY : 0.f;
  for (int s = 0; s < STAGES && s < ntiles; ++s) {
    const int q = s * TILE + srow;
    stat_s[s * TILE + srow] = q < T ? stat[rowbase + q] : past_end;
  }
  __syncthreads();

  const size_t head = (size_t)plane * T * HD;
  const int warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int key_a = key0 + warp * 16 + gid;
  const int key_b = key_a + 8;
  const bool off_a = masked_col(key_a, T, pad_lo, pad_hi);
  const bool off_b = masked_col(key_b, T, pad_lo, pad_hi);

  float acc_k[HD / 2], acc_v[HD / 2], s[32], dp[32];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) acc_k[i] = acc_v[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;

  mbar_wait(&bars[0], 0);
  for (int qt = 0; qt < ntiles; ++qt) {
    const int st = qt % STAGES;
    const uint8_t* q_s = ring + (2 * st) * TB;
    const uint8_t* do_s = q_s + TB;
    // this thread's statistic of the tile that refills slot st, read early
    const int nq = (qt + STAGES) * TILE + srow;
    const float pre = qt + STAGES < ntiles && nq < T ? stat[rowbase + nq] : past_end;
    mbar_wait(&bars[1 + st], (qt / STAGES) & 1);

    wgmma_fence();
#pragma unroll
    for (int kc = 0; kc < HT::KSTEPS; ++kc)  // S^T = K Q^T
      wgmma_ss<0>(s, HT::kmajor(k_s, kc), HT::kmajor(q_s, kc), kc);
#pragma unroll
    for (int kc = 0; kc < HT::KSTEPS; ++kc)  // dP^T = V dO^T
      wgmma_ss<0>(dp, HT::kmajor(v_s, kc), HT::kmajor(do_s, kc), kc);
    wgmma_commit();
    wgmma_wait();
    fence_regs(s);
    fence_regs(dp);

    // masked key rows are zeroed at the store: a row's p reaches only its
    // own row of dK and dV
    const float* ls = lse_s + st * TILE;
    const float* dsum = dd_s + st * TILE;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int qc = (i >> 2) * 8 + tig * 2 + (i & 1);
      const float p = prob(s[i] * scale_log2 - ls[qc]);
      s[i] = p;
      dp[i] = p * (dp[i] - dsum[qc]);
    }
    uint32_t pa[4][4], da[4][4];
    acc_to_a(pa, s);
    acc_to_a(da, dp);

    wgmma_fence();
#pragma unroll
    for (int kc = 0; kc < 4; ++kc)  // dV += P^T dO
      wgmma_rs<1>(acc_v, pa[kc], HT::mnmajor(do_s, kc), 1);
#pragma unroll
    for (int kc = 0; kc < 4; ++kc)  // dK += dS^T Q
      wgmma_rs<1>(acc_k, da[kc], HT::mnmajor(q_s, kc), 1);
    wgmma_commit();
    wgmma_wait();
    fence_regs(acc_v);
    fence_regs(acc_k);
    fence_regs(pa);
    fence_regs(da);

    __syncthreads();  // every warp is done with slot st and its statistics
    if (qt + STAGES < ntiles) {
      stat_s[st * TILE + srow] = pre;  // read after the barrier of the next iteration
      if (tid == 0) {
        const int next = (qt + STAGES) * TILE;
        mbar_expect_tx(&bars[1 + st], 2 * TB);
        tma_load_tile(ring + (2 * st) * TB, &map_q, &bars[1 + st], next, plane);
        tma_load_tile(ring + (2 * st + 1) * TB, &map_do, &bars[1 + st], next, plane);
      }
    }
  }

  store_rows<HD>(dk + head, acc_k, off_a ? 0.f : scale, off_b ? 0.f : scale, key_a, key_b, tig,
                 T);
  store_rows<HD>(dv + head, acc_v, off_a ? 0.f : 1.f, off_b ? 0.f : 1.f, key_a, key_b, tig, T);
}

// one tensor map per (B*H, T, HD) input (0, or make_tile_map's code), and
// the other tensors' 16-byte alignment (TMA_MISALIGNED if not)
template <int HD>
int make_maps(CUtensorMap (&m)[4], const void* q, const void* k, const void* v, const void* dout,
              int planes, int T, const void* x, const void* y) {
  const void* base[4] = {q, k, v, dout};
  for (int i = 0; i < 4; ++i)
    if (int err = HeadTile<HD>::map(&m[i], base[i], planes, T)) return err;
  if (((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(y)) & 15) != 0)
    return TMA_MISALIGNED;
  return 0;
}

template <int HD>
int backward_dq(const void* q, const void* k, const void* v, const void* dout, const void* lse2,
                void* dq, void* dd, int B, int H, int T, int pad_lo, int pad_hi,
                float scale_log2, float scale, cudaStream_t stream) {
  constexpr int smem = (int)dq_smem<HD>();
  // a runtime call first: it makes the device's context current on this
  // thread (the autograd engine's), which the tensor-map encoding needs
  cudaError_t err =
      cudaFuncSetAttribute(bwd_dq<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  CUtensorMap m[4];
  if (int bad = make_maps<HD>(m, q, k, v, dout, B * H, T, dq, dd)) return bad;
  dim3 grid((T + TILE - 1) / TILE, H, B);
  bwd_dq<HD><<<grid, NTHREADS, smem, stream>>>(m[0], m[1], m[2], m[3], (const float*)lse2,
                                                (bf16*)dq, (float*)dd, H, T, pad_lo, pad_hi,
                                                scale_log2, scale);
  return (int)cudaGetLastError();
}

template <int HD>
int backward_dkv(const void* q, const void* k, const void* v, const void* dout, const void* lse2,
                 const void* dd, void* dk, void* dv, int B, int H, int T, int pad_lo, int pad_hi,
                 float scale_log2, float scale, cudaStream_t stream) {
  constexpr int smem = (int)dkv_smem<HD>();
  // a runtime call first: it makes the device's context current on this
  // thread (the autograd engine's), which the tensor-map encoding needs
  cudaError_t err =
      cudaFuncSetAttribute(bwd_dkv<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  CUtensorMap m[4];
  if (int bad = make_maps<HD>(m, q, k, v, dout, B * H, T, dk, dv)) return bad;
  dim3 grid((T + TILE - 1) / TILE, H, B);
  bwd_dkv<HD><<<grid, NTHREADS, smem, stream>>>(m[0], m[1], m[2], m[3], (const float*)lse2,
                                                 (const float*)dd, (bf16*)dk, (bf16*)dv, H, T,
                                                 pad_lo, pad_hi, scale_log2, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// q, k, v, dout, dq: (B, H, T, D) bf16 contiguous, 16-byte aligned,
// D = 64 or 32 (cudaErrorInvalidValue otherwise); lse2 (from
// attn_flash_forward on the same q, k) and dd: (B, H, T) f32. dd (D =
// sum_s p*dP per row) is written. Returns a cudaError_t, or a code of
// make_tile_map (>= 998) when a tensor map cannot be made.
int attn_backward_dq(const void* q, const void* k, const void* v, const void* dout,
                     const void* lse2, void* dq, void* dd, int B, int H, int T, int D,
                     int pad_lo, int pad_hi, float scale_log2, float scale, void* stream) {
  if (D == 64)
    return backward_dq<64>(q, k, v, dout, lse2, dq, dd, B, H, T, pad_lo, pad_hi, scale_log2,
                           scale, (cudaStream_t)stream);
  if (D == 32)
    return backward_dq<32>(q, k, v, dout, lse2, dq, dd, B, H, T, pad_lo, pad_hi, scale_log2,
                           scale, (cudaStream_t)stream);
  return (int)cudaErrorInvalidValue;
}

// dk, dv: (B, H, T, D) bf16; dd from attn_backward_dq on the same inputs.
int attn_backward_dkv(const void* q, const void* k, const void* v, const void* dout,
                      const void* lse2, const void* dd, void* dk, void* dv, int B, int H, int T,
                      int D, int pad_lo, int pad_hi, float scale_log2, float scale,
                      void* stream) {
  if (D == 64)
    return backward_dkv<64>(q, k, v, dout, lse2, dd, dk, dv, B, H, T, pad_lo, pad_hi, scale_log2,
                            scale, (cudaStream_t)stream);
  if (D == 32)
    return backward_dkv<32>(q, k, v, dout, lse2, dd, dk, dv, B, H, T, pad_lo, pad_hi, scale_log2,
                            scale, (cudaStream_t)stream);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
