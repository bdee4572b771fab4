// Attention backward kernels for the ViT and Swin backbones (bf16, head
// dim 64, 32, 128 or a multiple of 128 above it).
//
// Replaces two Pallas TPU kernels of attentionshift_tpu/ops/attention.py
// (bwd32_short replaces both at once, for head dim 32 and T <= 64):
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
// (113 M per sweep) is ~30 us on the MUFU units, under the products. Head
// dim 128 (and 72-120, which ops/attention.py pads onto it) doubles the
// products per exp2: the tensor cores bound it.
//
// Head dim 32 (and 8-24, padded onto it) has kernels of its own. At Swin's
// (1, 24, 1276, 32) pass A's three products are 7.5 GFLOP (7.6 us) against
// 39.1 M exp2 per sweep (9.3 us at 16 per clock per SM, 132 SMs, 1980 MHz):
// the exp work bounds it; pass B's four, 10.0 GFLOP (10.1 us), are about
// even with its exp work. At the decoder heads' short planes ((512, 8, 50,
// 32), (128, 8, 196, 32)) the bytes bound it. Tiles are 64 rows of 64 bytes
// under the 64-byte swizzle (HeadTile<32>), the products that contract over
// d take two k16 steps, those whose N is d are m64n32k16:
//   bwd32_dq    T > 64: one warpgroup a block, four blocks per SM, each
//               block walking units of 64 query rows (Swin: 480 units on
//               528 resident blocks, one round). Thread 0 keeps the K/V
//               ring and the next unit's Q and dO tiles loading across
//               units, so no unit waits on a load it could have had early;
//               a step's ring entry is refilled right after the
//               warpgroup's products on it. S and dP are taken one after
//               the other, so that at most one 64 x 64 accumulator is in
//               flight beside dQ's and a thread fits 128 registers (both
//               in flight, and dV beside dK in pass B, took 154 registers
//               and three blocks per SM: a third slower at Swin; two or four
//               warpgroups a block sharing the ring moved nothing). Where a
//               unit's p of every key tile fits
//               (T <= 256: 8 KB per tile) the first sweep keeps it in
//               shared memory and the second computes dP alone.
//   bwd32_dkv   T > 64: pass B the same way, units of 64 keys, the ring
//               carrying Q, dO and their rows' lse2 and D (each thread
//               reads its statistic a step ahead); per query tile S^T,
//               then P^T into dV beside dP^T, then dS^T into dK.
//   bwd32_short T <= 64 (the box head's T = 50, 4096 planes): a plane's
//               whole backward in one pass, one warpgroup walking whole
//               planes on persistent blocks and a producer warp keeping the
//               next planes in flight. D is final after the one key tile, P
//               and dS go to shared memory, where dV = P^T dO and dK = dS^T Q
//               read them as MN-major A operands (wgmma's transpose bit), and
//               dQ = dS K takes dS from registers: q, k, v, dO read once,
//               dq, dk, dv written once, one exp sweep.
// All three round p with one cvt per pair of entries and take exp2 as
// ex2.approx.ftz; a warp whose 16 rows are all masked skips its exp work,
// as does a group of 8 columns that lies wholly past T or in the gap (only
// a tile that reaches T or the gap tests its columns: per-pair branches on
// every tile cost pass B a third more time). No integer division per step:
// the ring's next entry is a cursor advanced once per entry (divisions per
// entry cost pass B a fifth more). The host picks the route, grids and
// whether p is kept (plan_b32, exported as attn_d32_bwd_plan and mirrored
// in ops/attention.py::d32_bwd_plan).
//
// What the design does about it at head dims 64 and 128 (helpers in
// hopper.cuh; both kernels are templates on the head dim, HeadTile<HD>):
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
//   * at head dim 128 a tile is two 64-column TMA boxes in one 16 KB slot
//     (HeadTile<128>); S and dP contract over eight k16 steps. Pass A keeps
//     dQ's 64 accumulators of m64n128k16 a thread. Pass B splits each key
//     tile's dK and dV by column halves over two blocks (blockIdx.x = 2 *
//     key tile + half): each recomputes S^T and dP^T over all 128 columns
//     and accumulates its half of dK and dV as m64n64k16 against that half
//     of Q and dO (two 64x128 f32 accumulators a warpgroup would need 128
//     registers a thread more). Both take two blocks per SM;
//   * head dims above 128 (ops/attention.py pads them to D = 128 *
//     ceil(d / 128)) take the wide route, bwd_dq_wide and bwd_dkv_wide:
//     slab c of a row is the HeadTile<128> at column 128 c of a map over the
//     whole row; S and dP (S^T and dP^T) accumulate over the NS = D / 128
//     slabs streamed through a two-slot ring (80 KB slots), so shared
//     memory does not grow with D. bwd_dq_wide writes one 128-column slab
//     of dQ per block (m64n128k16, K's output slab loaded beside the last
//     slab of the second sweep); bwd_dkv_wide one 64-column part of dK and
//     dV (m64n64k16, Q's and dO's parts beside the last slab). Each block
//     recomputes S and dP for its part, one block per SM, every product
//     waiting for itself: simple and right first;
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

#include <atomic>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int TILE = TILE_ROWS;
constexpr int NTHREADS = 128;  // one warpgroup
constexpr int STAGES = 2;      // ring depth of the streamed tiles
constexpr int BLOCKS_PER_SM = 3;  // resident blocks the register budget is set for

// the register budget's blocks per SM at head dim HD: two at 128
template <int HD>
__host__ __device__ constexpr int blocks_per_sm() {
  return HD == 128 ? 2 : BLOCKS_PER_SM;
}

// pass B's column parts: each block accumulates PART_COLS of the HD columns
// of dK and dV (two halves at 128, all of them otherwise)
template <int HD>
__host__ __device__ constexpr int dkv_parts() {
  return HD / HeadTile<HD>::PART_COLS;
}

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

// write a warpgroup's (64 x NC) f32 accumulator, scaled, as bf16 columns
// [c0, c0 + NC) of rows r_a (i < 2) and r_b (i >= 2) of a head matrix of ld
// (default HD) columns; a row whose scale is 0 is written as exact zeros,
// whatever its accumulator holds
template <int HD, int NC = HD>
__device__ __forceinline__ void store_rows(bf16* mh, const float (&acc)[NC / 2], float scale_a,
                                           float scale_b, int r_a, int r_b, int tig, int T,
                                           int c0 = 0, int ld = HD) {
#pragma unroll
  for (int j = 0; j < NC / 8; ++j) {
    int c = c0 + j * 8 + tig * 2;
    if (r_a < T)
      *reinterpret_cast<uint32_t*>(mh + (size_t)r_a * ld + c) =
          scale_a == 0.f ? 0u : pack_bf16(acc[4 * j] * scale_a, acc[4 * j + 1] * scale_a);
    if (r_b < T)
      *reinterpret_cast<uint32_t*>(mh + (size_t)r_b * ld + c) =
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
  using HT = HeadTile<HD>;
  constexpr int TB = HT::BYTES;
  __syncthreads();  // every warp is done with slot st
  if (tid == 0 && it + STAGES < nit) {
    const int next = ((it + STAGES) % ntiles) * TILE;
    mbar_expect_tx(bar, 2 * TB);
    HT::load(ring + (2 * st) * TB, map_k, bar, next, plane);
    HT::load(ring + (2 * st + 1) * TB, map_v, bar, next, plane);
  }
}

// Pass A: D = sum_s p*dP per row of one 64-row query tile (first sweep of
// the key tiles), then its dQ (second sweep).
template <int HD>
__global__ void __launch_bounds__(NTHREADS, blocks_per_sm<HD>())
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
    HT::load(q_s, &map_q, &bars[0], row0, plane);
    HT::load(do_s, &map_do, &bars[0], row0, plane);
    for (int s = 0; s < STAGES && s < nit; ++s) {
      const int key = (s % ntiles) * TILE;
      mbar_expect_tx(&bars[1 + s], 2 * TB);
      HT::load(ring + (2 * s) * TB, &map_k, &bars[1 + s], key, plane);
      HT::load(ring + (2 * s + 1) * TB, &map_v, &bars[1 + s], key, plane);
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

// Pass B: dK and dV of one 64-row key tile (columns part * PART_COLS on,
// PART_COLS of them), on the transposed products (keys as rows, queries as
// columns).
template <int HD>
__global__ void __launch_bounds__(NTHREADS, blocks_per_sm<HD>())
bwd_dkv(const __grid_constant__ CUtensorMap map_q, const __grid_constant__ CUtensorMap map_k,
        const __grid_constant__ CUtensorMap map_v, const __grid_constant__ CUtensorMap map_do,
        const float* __restrict__ lse2, const float* __restrict__ dd, bf16* __restrict__ dk,
        bf16* __restrict__ dv, int H, int T, int pad_lo, int pad_hi, float scale_log2,
        float scale) {
  using HT = HeadTile<HD>;
  constexpr int TB = HT::BYTES;
  constexpr int NC = HT::PART_COLS;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  uint8_t* k_s = smem;
  uint8_t* v_s = smem + TB;
  uint8_t* ring = smem + 2 * TB;  // slot s: Q at 2s, dO at 2s + 1 tiles
  float* lse_s = reinterpret_cast<float*>(smem + ring_bytes<HD>());  // [STAGES][TILE]
  float* dd_s = lse_s + STAGES * TILE;                                // [STAGES][TILE]
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + ring_bytes<HD>() + STAT_BYTES);

  const int plane = blockIdx.z * H + blockIdx.y;
  const int part = blockIdx.x % dkv_parts<HD>();
  const int key0 = blockIdx.x / dkv_parts<HD>() * TILE;
  const int ntiles = (T + TILE - 1) / TILE;
  const int tid = threadIdx.x;
  const size_t rowbase = (size_t)plane * T;
  if (tid == 0) {
    for (int i = 0; i <= STAGES; ++i) mbar_init(&bars[i], 1);
    mbar_init_fence();
    mbar_expect_tx(&bars[0], 2 * TB);
    HT::load(k_s, &map_k, &bars[0], key0, plane);
    HT::load(v_s, &map_v, &bars[0], key0, plane);
    for (int s = 0; s < STAGES && s < ntiles; ++s) {
      mbar_expect_tx(&bars[1 + s], 2 * TB);
      HT::load(ring + (2 * s) * TB, &map_q, &bars[1 + s], s * TILE, plane);
      HT::load(ring + (2 * s + 1) * TB, &map_do, &bars[1 + s], s * TILE, plane);
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

  float acc_k[NC / 2], acc_v[NC / 2], s[32], dp[32];
#pragma unroll
  for (int i = 0; i < NC / 2; ++i) acc_k[i] = acc_v[i] = 0.f;
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
    for (int kc = 0; kc < 4; ++kc)  // dV += P^T dO (this block's columns)
      wgmma_rs<1>(acc_v, pa[kc], HT::mnmajor_part(do_s, part, kc), 1);
#pragma unroll
    for (int kc = 0; kc < 4; ++kc)  // dK += dS^T Q (this block's columns)
      wgmma_rs<1>(acc_k, da[kc], HT::mnmajor_part(q_s, part, kc), 1);
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
        HT::load(ring + (2 * st) * TB, &map_q, &bars[1 + st], next, plane);
        HT::load(ring + (2 * st + 1) * TB, &map_do, &bars[1 + st], next, plane);
      }
    }
  }

  store_rows<HD, NC>(dk + head, acc_k, off_a ? 0.f : scale, off_b ? 0.f : scale, key_a, key_b,
                     tig, T, part * NC);
  store_rows<HD, NC>(dv + head, acc_v, off_a ? 0.f : 1.f, off_b ? 0.f : 1.f, key_a, key_b, tig, T,
                     part * NC);
}

// ------------------------------------------------------- the wide route
//
// Head dims above 128 (ops/attention.py zero-pads a multiple of 8 above
// 128 to D = 128 * ceil(d / 128)): a head row is NS = D / 128 slabs of 128
// columns, slab c the HeadTile<128> at column 128 c of a tensor map over
// the whole row. The products that contract over d (S and dP, S^T and
// dP^T) accumulate slab by slab through a ring of WIDE_STAGES slots, so
// shared memory does not grow with D; each block writes one part of its
// gradient, recomputing S and dP for it. Every product waits for itself:
// the route is simple and right first; it has had no redesign.

// bwd_dq_wide's slot: slabs c of Q, dO (the block's rows), K, V (the key
// tile), and in the second sweep at c = NS - 1 K's output slab
constexpr int WIDE_DQ_SLOT = 5 * Slab::BYTES;
// bwd_dkv_wide's slot: slabs c of K, V (the block's keys), Q, dO (the
// query tile), and at c = NS - 1 the 64-column parts of Q and dO the block
// writes
constexpr int WIDE_DKV_SLOT = 4 * Slab::BYTES + 2 * TILE_BYTES;
constexpr size_t wide_dq_smem() {
  return (size_t)WIDE_STAGES * WIDE_DQ_SLOT + WIDE_STAGES * sizeof(uint64_t) + 1024;
}
constexpr size_t wide_dkv_smem() {
  return (size_t)WIDE_STAGES * WIDE_DKV_SLOT + WIDE_STAGES * sizeof(uint64_t) + 1024;
}

// bwd_dq_wide's unit u = it * NS + c: iteration it (key tile it % ntiles;
// the first ntiles iterations are the first sweep), slab c
__device__ __forceinline__ void wide_dq_load(uint8_t* ring, uint64_t* bars,
                                             const CUtensorMap* const (&m)[4], int u, int NS, int ntiles,
                                             int sl, int row0, int plane) {
  const int st = u % WIDE_STAGES, it = u / NS, c = u % NS;
  const int key = it % ntiles * TILE, col = c * SLAB_COLS;
  uint8_t* slot = ring + st * WIDE_DQ_SLOT;
  const bool k_out = it >= ntiles && c == NS - 1;
  mbar_expect_tx(&bars[st], (k_out ? 5 : 4) * Slab::BYTES);
  Slab::load(slot, m[0], &bars[st], row0, plane, col);
  Slab::load(slot + Slab::BYTES, m[3], &bars[st], row0, plane, col);
  Slab::load(slot + 2 * Slab::BYTES, m[1], &bars[st], key, plane, col);
  Slab::load(slot + 3 * Slab::BYTES, m[2], &bars[st], key, plane, col);
  if (k_out) Slab::load(slot + 4 * Slab::BYTES, m[1], &bars[st], key, plane, sl * SLAB_COLS);
}

// Pass A on the wide route: one block = one warpgroup = 64 query rows and
// output slab sl of dQ (blockIdx.x = query tile * NS + sl). Per key tile S
// and dP over the NS slabs, then p (bf16, 0 at masked columns); the first
// sweep sums D = sum_s p dP, the second adds dS K_sl to dQ_sl (m64n128k16).
// Slab 0's block writes D.
__global__ void __launch_bounds__(NTHREADS, 1)
bwd_dq_wide(const __grid_constant__ CUtensorMap map_q, const __grid_constant__ CUtensorMap map_k,
            const __grid_constant__ CUtensorMap map_v, const __grid_constant__ CUtensorMap map_do,
            const float* __restrict__ lse2, bf16* __restrict__ dq, float* __restrict__ dd, int H,
            int T, int NS, int pad_lo, int pad_hi, float scale_log2, float scale) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ring = align1024(smem_raw);
  uint64_t* bars = reinterpret_cast<uint64_t*>(ring + WIDE_STAGES * WIDE_DQ_SLOT);
  const CUtensorMap* maps[4] = {&map_q, &map_k, &map_v, &map_do};
  const int plane = blockIdx.z * H + blockIdx.y;
  const int sl = blockIdx.x % NS;
  const int row0 = blockIdx.x / NS * TILE;
  const int ntiles = (T + TILE - 1) / TILE;
  const int nu = 2 * ntiles * NS;
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int i = 0; i < WIDE_STAGES; ++i) mbar_init(&bars[i], 1);
    mbar_init_fence();
    for (int u = 0; u < WIDE_STAGES && u < nu; ++u)
      wide_dq_load(ring, bars, maps, u, NS, ntiles, sl, row0, plane);
  }
  __syncthreads();

  const size_t rowbase = (size_t)plane * T;
  const int warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int r_a = row0 + warp * 16 + gid;
  const int r_b = r_a + 8;
  const float lse_a = r_a < T ? lse2[rowbase + r_a] : 0.f;
  const float lse_b = r_b < T ? lse2[rowbase + r_b] : 0.f;
  float d_a = 0.f, d_b = 0.f;
  float acc[64], s[32], dp[32];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;

  for (int u = 0; u < nu; ++u) {
    const int st = u % WIDE_STAGES, it = u / NS, c = u % NS;
    const uint8_t* slot = ring + st * WIDE_DQ_SLOT;
    mbar_wait(&bars[st], (u / WIDE_STAGES) & 1);
    fence_regs(s);
    fence_regs(dp);
    wgmma_fence();
#pragma unroll
    for (int kc = 0; kc < Slab::KSTEPS; ++kc)  // S += Q_c K_c^T
      wgmma_ss<0>(s, Slab::kmajor(slot, kc), Slab::kmajor(slot + 2 * Slab::BYTES, kc), c | kc);
#pragma unroll
    for (int kc = 0; kc < Slab::KSTEPS; ++kc)  // dP += dO_c V_c^T
      wgmma_ss<0>(dp, Slab::kmajor(slot + Slab::BYTES, kc),
                  Slab::kmajor(slot + 3 * Slab::BYTES, kc), c | kc);
    wgmma_commit();
    wgmma_wait();
    fence_regs(s);
    fence_regs(dp);
    if (c == NS - 1) {
      const int key0 = it % ntiles * TILE;
      const bool edge = key0 + TILE > T || (key0 + TILE > pad_lo && key0 < pad_hi);
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int col = key0 + (i >> 2) * 8 + tig * 2 + (i & 1);
        const float x = s[i] * scale_log2 - ((i & 2) ? lse_b : lse_a);
        s[i] = prob(edge && masked_col(col, T, pad_lo, pad_hi) ? -INFINITY : x);
      }
      if (it < ntiles) {  // first sweep: D += p * dP
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          if (i & 2)
            d_b += s[i] * dp[i];
          else
            d_a += s[i] * dp[i];
        }
        if (it == ntiles - 1) {
#pragma unroll
          for (int off = 1; off < 4; off <<= 1) {
            d_a += __shfl_xor_sync(0xffffffffu, d_a, off);
            d_b += __shfl_xor_sync(0xffffffffu, d_b, off);
          }
        }
      } else {  // second sweep: dS = p * (dP - D), dQ_sl += dS K_sl
#pragma unroll
        for (int i = 0; i < 32; ++i) s[i] *= dp[i] - ((i & 2) ? d_b : d_a);
        uint32_t ds[4][4];
        acc_to_a(ds, s);
        fence_regs(acc);
        fence_regs(ds);
        wgmma_fence();
#pragma unroll
        for (int kc = 0; kc < 4; ++kc)
          wgmma_rs<1>(acc, ds[kc], Slab::mnmajor(slot + 4 * Slab::BYTES, kc), 1);
        wgmma_commit();
        wgmma_wait();
        fence_regs(acc);
        fence_regs(ds);
      }
    }
    __syncthreads();  // every warp is done with unit u's slot
    if (tid == 0 && u + WIDE_STAGES < nu)
      wide_dq_load(ring, bars, maps, u + WIDE_STAGES, NS, ntiles, sl, row0, plane);
  }

  const int D = NS * SLAB_COLS;
  store_rows<SLAB_COLS>(dq + rowbase * D, acc, scale, scale, r_a, r_b, tig, T, sl * SLAB_COLS, D);
  if (sl == 0 && tig == 0) {
    if (r_a < T) dd[rowbase + r_a] = d_a;
    if (r_b < T) dd[rowbase + r_b] = d_b;
  }
}

// bwd_dkv_wide's unit u = qt * NS + c: query tile qt, slab c
__device__ __forceinline__ void wide_dkv_load(uint8_t* ring, uint64_t* bars,
                                              const CUtensorMap* const (&m)[4], int u, int NS, int part,
                                              int key0, int plane) {
  const int st = u % WIDE_STAGES, qt = u / NS, c = u % NS;
  const int col = c * SLAB_COLS;
  uint8_t* slot = ring + st * WIDE_DKV_SLOT;
  const bool last = c == NS - 1;
  mbar_expect_tx(&bars[st], 4 * Slab::BYTES + (last ? 2 * TILE_BYTES : 0));
  Slab::load(slot, m[1], &bars[st], key0, plane, col);
  Slab::load(slot + Slab::BYTES, m[2], &bars[st], key0, plane, col);
  Slab::load(slot + 2 * Slab::BYTES, m[0], &bars[st], qt * TILE, plane, col);
  Slab::load(slot + 3 * Slab::BYTES, m[3], &bars[st], qt * TILE, plane, col);
  if (last) {
    tma_load_box(slot + 4 * Slab::BYTES, m[0], &bars[st], part * 64, qt * TILE, plane);
    tma_load_box(slot + 4 * Slab::BYTES + TILE_BYTES, m[3], &bars[st], part * 64, qt * TILE,
                 plane);
  }
}

// Pass B on the wide route: one block = one warpgroup = 64 key rows and
// the 64-column part `part` of their dK and dV (blockIdx.x = key tile * 2
// NS + part). Per query tile S^T and dP^T over the NS slabs, then p and dS
// as in bwd_dkv (the statistics of the query rows read from lse2 and D; a
// row past T gets p = 0), dV_part += P^T dO_part, dK_part += dS^T Q_part
// (m64n64k16).
__global__ void __launch_bounds__(NTHREADS, 1)
bwd_dkv_wide(const __grid_constant__ CUtensorMap map_q, const __grid_constant__ CUtensorMap map_k,
             const __grid_constant__ CUtensorMap map_v, const __grid_constant__ CUtensorMap map_do,
             const float* __restrict__ lse2, const float* __restrict__ dd, bf16* __restrict__ dk,
             bf16* __restrict__ dv, int H, int T, int NS, int pad_lo, int pad_hi,
             float scale_log2, float scale) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ring = align1024(smem_raw);
  uint64_t* bars = reinterpret_cast<uint64_t*>(ring + WIDE_STAGES * WIDE_DKV_SLOT);
  const CUtensorMap* maps[4] = {&map_q, &map_k, &map_v, &map_do};
  const int plane = blockIdx.z * H + blockIdx.y;
  const int part = blockIdx.x % (2 * NS);
  const int key0 = blockIdx.x / (2 * NS) * TILE;
  const int ntiles = (T + TILE - 1) / TILE;
  const int nu = ntiles * NS;
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int i = 0; i < WIDE_STAGES; ++i) mbar_init(&bars[i], 1);
    mbar_init_fence();
    for (int u = 0; u < WIDE_STAGES && u < nu; ++u)
      wide_dkv_load(ring, bars, maps, u, NS, part, key0, plane);
  }
  __syncthreads();

  const size_t rowbase = (size_t)plane * T;
  const int warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int key_a = key0 + warp * 16 + gid;
  const int key_b = key_a + 8;
  const bool off_a = masked_col(key_a, T, pad_lo, pad_hi);
  const bool off_b = masked_col(key_b, T, pad_lo, pad_hi);
  float acc_k[32], acc_v[32], s[32], dp[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc_k[i] = acc_v[i] = s[i] = dp[i] = 0.f;

  for (int u = 0; u < nu; ++u) {
    const int st = u % WIDE_STAGES, qt = u / NS, c = u % NS;
    const uint8_t* slot = ring + st * WIDE_DKV_SLOT;
    mbar_wait(&bars[st], (u / WIDE_STAGES) & 1);
    fence_regs(s);
    fence_regs(dp);
    wgmma_fence();
#pragma unroll
    for (int kc = 0; kc < Slab::KSTEPS; ++kc)  // S^T += K_c Q_c^T
      wgmma_ss<0>(s, Slab::kmajor(slot, kc), Slab::kmajor(slot + 2 * Slab::BYTES, kc), c | kc);
#pragma unroll
    for (int kc = 0; kc < Slab::KSTEPS; ++kc)  // dP^T += V_c dO_c^T
      wgmma_ss<0>(dp, Slab::kmajor(slot + Slab::BYTES, kc),
                  Slab::kmajor(slot + 3 * Slab::BYTES, kc), c | kc);
    wgmma_commit();
    wgmma_wait();
    fence_regs(s);
    fence_regs(dp);
    if (c == NS - 1) {
      // masked key rows are zeroed at the store: a row's p reaches only its
      // own row of dK and dV
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int q = qt * TILE + (i >> 2) * 8 + tig * 2 + (i & 1);
        const float ls = q < T ? lse2[rowbase + q] : INFINITY;
        const float dsum = q < T ? dd[rowbase + q] : 0.f;
        const float p = prob(s[i] * scale_log2 - ls);
        s[i] = p;
        dp[i] = p * (dp[i] - dsum);
      }
      uint32_t pa[4][4], da[4][4];
      acc_to_a(pa, s);
      acc_to_a(da, dp);
      const uint8_t* q_p = slot + 4 * Slab::BYTES;
      const uint8_t* do_p = q_p + TILE_BYTES;
      fence_regs(acc_v);
      fence_regs(acc_k);
      fence_regs(pa);
      fence_regs(da);
      wgmma_fence();
#pragma unroll
      for (int kc = 0; kc < 4; ++kc)  // dV += P^T dO (this block's columns)
        wgmma_rs<1>(acc_v, pa[kc], desc_mnmajor(do_p, kc), 1);
#pragma unroll
      for (int kc = 0; kc < 4; ++kc)  // dK += dS^T Q (this block's columns)
        wgmma_rs<1>(acc_k, da[kc], desc_mnmajor(q_p, kc), 1);
      wgmma_commit();
      wgmma_wait();
      fence_regs(acc_v);
      fence_regs(acc_k);
      fence_regs(pa);
      fence_regs(da);
    }
    __syncthreads();  // every warp is done with unit u's slot
    if (tid == 0 && u + WIDE_STAGES < nu)
      wide_dkv_load(ring, bars, maps, u + WIDE_STAGES, NS, part, key0, plane);
  }

  const int D = NS * SLAB_COLS;
  store_rows<64>(dk + rowbase * D, acc_k, off_a ? 0.f : scale, off_b ? 0.f : scale, key_a, key_b,
                 tig, T, part * 64, D);
  store_rows<64>(dv + rowbase * D, acc_v, off_a ? 0.f : 1.f, off_b ? 0.f : 1.f, key_a, key_b, tig,
                 T, part * 64, D);
}

// ------------------------------------------------------- head dim 32
//
// bwd32_dq, bwd32_dkv and bwd32_short (see the header comment): the d = 32
// backward, designed for the exp2 work and the bytes that bound it there.
// Design constants that `chip_smoke.py --ablate attention_bwd` overrides:
#ifndef B32_STAGES
#define B32_STAGES 3  // ring slots of bwd32_dq (K, V) and bwd32_dkv (Q, dO, their statistics)
#endif
#ifndef B32_PCACHE
#define B32_PCACHE 1  // bwd32_dq keeps its bf16 p between the sweeps where that fits (T <= 256)
#endif
#ifndef B32_SHORT_STAGES
#define B32_SHORT_STAGES 2  // planes in flight per bwd32_short block
#endif

constexpr int KV32 = HeadTile<32>::BYTES;  // one 64-row tile at d = 32: 4 KB
// bwd32_dq and bwd32_dkv: one warpgroup a block, no producer warp (its
// registers would come out of the consumers'), four blocks per SM: 128
// registers a thread
constexpr int B32_BLOCKS_PER_SM = 4;
constexpr int B32_PCACHE_TILES = 4;         // key tiles whose p bwd32_dq keeps, at most
constexpr int PC_TILE = NTHREADS * 16 * 4;  // a warpgroup's kept p of one key tile: 16 pairs a thread
constexpr int DKV32_SLOT = 2 * KV32 + 2 * TILE * 4;  // Q, dO, then lse2 and D of their 64 rows
constexpr int PRODUCER_THREADS = 32;                 // bwd32_short's producer warp
constexpr int SHORT32_THREADS = NTHREADS + PRODUCER_THREADS;
constexpr int SHORT32_BLOCKS_PER_SM = 3;
constexpr int SHORT32_SLOT = 4 * KV32;  // Q, K, V and dO of one plane
constexpr size_t SM_SMEM = 233472;      // an SM's shared memory; a block also reserves 1 KB of it

// bwd32_dq: two buffers of the Q and dO tiles, the ring, `kept` key tiles of
// p, the barriers
constexpr size_t dq32_smem(int kept) {
  return (size_t)2 * 2 * KV32 + (size_t)B32_STAGES * 2 * KV32 + (size_t)kept * PC_TILE +
         (2 + B32_STAGES) * sizeof(uint64_t) + 1024;
}
// bwd32_dkv: two buffers of the K and V tiles, the ring, the barriers
constexpr size_t dkv32_smem() {
  return (size_t)2 * 2 * KV32 + (size_t)B32_STAGES * DKV32_SLOT +
         (2 + B32_STAGES) * sizeof(uint64_t) + 1024;
}
// bwd32_short: P and dS, the ring, each slot's lse2, the barriers
constexpr size_t short32_smem() {
  return (size_t)2 * TILE_BYTES + (size_t)B32_SHORT_STAGES * (SHORT32_SLOT + TILE * sizeof(float)) +
         2 * B32_SHORT_STAGES * sizeof(uint64_t) + 1024;
}
// whether bwd32_dq keeps p for `ntiles` key tiles: at most B32_PCACHE_TILES,
// with three blocks per SM still resident (four without)
constexpr bool dq32_keeps(int ntiles) {
  return B32_PCACHE && ntiles <= B32_PCACHE_TILES && (dq32_smem(ntiles) + 1024) * 3 <= SM_SMEM;
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// the two values of a packed bf16 pair as f32: the pair's first (low) and second
__device__ __forceinline__ float lo_bf16(uint32_t u) { return __uint_as_float(u << 16); }
__device__ __forceinline__ float hi_bf16(uint32_t u) { return __uint_as_float(u & 0xffff0000u); }

// the 64 columns from c0 on reach the gap or T; the 8 from c0 on are all masked
__device__ __forceinline__ bool tile_masked32(int c0, int T, int pad_lo, int pad_hi) {
  return c0 + TILE > T || (c0 + TILE > pad_lo && c0 < pad_hi);
}
__device__ __forceinline__ bool group_masked(int c0, int T, int pad_lo, int pad_hi) {
  return c0 >= T || (c0 >= pad_lo && c0 + 8 <= pad_hi);
}

// the consumer warpgroup of a block whose other warps are the producer's
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, 128;\n" ::: "memory");
}

// S (or dP) = A B^T of two K-major 64-row tiles, contracting over d = 32
__device__ __forceinline__ void issue_s32(float (&s)[32], const uint8_t* a, const uint8_t* b) {
#pragma unroll
  for (int kc = 0; kc < HeadTile<32>::KSTEPS; ++kc)
    wgmma_ss<0>(s, HeadTile<32>::kmajor(a, kc), HeadTile<32>::kmajor(b, kc), kc);
}

// the same product as a batch of its own, waited for
__device__ __forceinline__ void product32(float (&s)[32], const uint8_t* a, const uint8_t* b) {
  fence_regs(s);
  wgmma_fence();
  issue_s32(s, a, b);
  wgmma_commit();
  wgmma_wait();
  fence_regs(s);
}


// A thread's 32 entries of a 64 x 64 accumulator as 16 pairs: pair pi holds
// entries 2 pi and 2 pi + 1, in row r_a (pi even) or r_b (pi odd), columns
// 8 (pi / 2) + 2 tig and the next (hopper.cuh's layout); as the A operand of
// the next product, pair pi is a[pi / 4][pi % 4].
// p = exp2(s * scale_log2 - l) of the key tile from key0 on (l: l_a in row
// r_a, l_b in r_b), rounded to bf16 and packed in pairs: one cvt per pair.
// Masked columns (the gap, or past T) get 0: only a tile that reaches the
// gap or T tests columns, and a group of 8 columns wholly masked skips its
// exp2s.
__device__ __forceinline__ void probs32(uint32_t (&u)[16], const float (&s)[32], int key0, int tig,
                                        float l_a, float l_b, int T, int pad_lo, int pad_hi,
                                        float scale_log2) {
  if (tile_masked32(key0, T, pad_lo, pad_hi)) {
#pragma unroll
    for (int pi = 0; pi < 16; ++pi) {
      const int c0 = key0 + (pi >> 1) * 8, col = c0 + 2 * tig;
      const float l = (pi & 1) ? l_b : l_a;
      if (group_masked(c0, T, pad_lo, pad_hi)) {
        u[pi] = 0u;
      } else {
        const float x0 = masked_col(col, T, pad_lo, pad_hi) ? -INFINITY
                                                            : fmaf(s[2 * pi], scale_log2, -l);
        const float x1 = masked_col(col + 1, T, pad_lo, pad_hi)
                             ? -INFINITY
                             : fmaf(s[2 * pi + 1], scale_log2, -l);
        u[pi] = pack_bf16(ex2(x0), ex2(x1));
      }
    }
  } else {
#pragma unroll
    for (int pi = 0; pi < 16; ++pi) {
      const float l = (pi & 1) ? l_b : l_a;
      u[pi] = pack_bf16(ex2(fmaf(s[2 * pi], scale_log2, -l)), ex2(fmaf(s[2 * pi + 1], scale_log2, -l)));
    }
  }
}

// bwd32_dq and bwd32_dkv walk units of one 64-row tile each (pass A: query
// tiles, pass B: key tiles; unit u is tile u % ntiles of plane u / ntiles):
// block b takes units b, b + gridDim.x, ... (the host launches at most as
// many blocks as are resident at once). Thread 0 loads: a unit's own tiles
// (Q and dO in pass A, K and V in pass B) into one of two buffers while the
// unit before runs, and the streamed tiles of every unit into a ring whose
// entry counter runs on across the block's units, an entry refilled as soon
// as the warpgroup is done with the slot. So no unit waits on a load that
// could have been issued during the one before.

// the units block blockIdx.x takes
__device__ __forceinline__ int units32(int units) {
  return (units - (int)blockIdx.x + (int)gridDim.x - 1) / (int)gridDim.x;
}

// the block's unit i: its plane and tile
struct Unit32 {
  int plane, tile;
};
__device__ __forceinline__ Unit32 unit32(int i, int ntiles) {
  const int u = blockIdx.x + i * gridDim.x;
  return Unit32{u / ntiles, u % ntiles};
}

// two tiles of `x`'s row (maps m0, m1) into a buffer of two tiles at `dst`
__device__ __forceinline__ void own32_load(uint8_t* dst, uint64_t* bar, const CUtensorMap* m0,
                                           const CUtensorMap* m1, const Unit32& x) {
  mbar_expect_tx(bar, 2 * KV32);
  HeadTile<32>::load(dst, m0, bar, x.tile * TILE, x.plane);
  HeadTile<32>::load(dst + KV32, m1, bar, x.tile * TILE, x.plane);
}

// A walk over the block's ring entries in order, `per` entries a unit: the
// entry's unit, its index k within the unit and the unit's plane, advanced
// without a division per entry.
struct Cursor32 {
  int unit, k, plane;
};
__device__ __forceinline__ Cursor32 cursor32(int e, int per, int ntiles) {
  const int i = e / per;
  return Cursor32{i, e % per, unit32(i, ntiles).plane};
}
__device__ __forceinline__ void advance32(Cursor32& c, int per, int ntiles) {
  if (++c.k == per) {
    c.k = 0;
    c.plane = unit32(++c.unit, ntiles).plane;
  }
}

// bwd32_dq's ring entry at cursor c (2 ntiles entries a unit: the key tiles,
// twice) into slot st: the K and V tiles
__device__ __forceinline__ void dq32_ring(uint8_t* ring, uint64_t* full, const CUtensorMap* mk,
                                          const CUtensorMap* mv, int st, const Cursor32& c,
                                          int ntiles) {
  const int key = (c.k < ntiles ? c.k : c.k - ntiles) * TILE;
  mbar_expect_tx(&full[st], 2 * KV32);
  HeadTile<32>::load(ring + 2 * st * KV32, mk, &full[st], key, c.plane);
  HeadTile<32>::load(ring + (2 * st + 1) * KV32, mv, &full[st], key, c.plane);
}

// bwd32_dq: pass A at head dim 32. One block = one warpgroup walking units
// of 64 query rows, each sweeping the key tiles twice through the ring
// (first sweep: S, dP, p and D; second: dS and dQ), S and dP one after the
// other so that the two accumulators are never in flight at once beside
// dQ's. With KEPT (T <= 256) the first sweep keeps the bf16 p in shared
// memory, so the second computes dP alone and no exp2.
template <bool KEPT>
__global__ void __launch_bounds__(NTHREADS, B32_BLOCKS_PER_SM)
bwd32_dq(const __grid_constant__ CUtensorMap map_q, const __grid_constant__ CUtensorMap map_k,
         const __grid_constant__ CUtensorMap map_v, const __grid_constant__ CUtensorMap map_do,
         const float* __restrict__ lse2, bf16* __restrict__ dq, float* __restrict__ dd, int units,
         int T, int pad_lo, int pad_hi, float scale_log2, float scale) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);  // own buffer b: Q at tile 2 b, dO at 2 b + 1
  const int n = (T + TILE - 1) / TILE, mine = units32(units), entries = mine * 2 * n;
  uint8_t* ring = smem + 4 * KV32;               // slot s: K at tile 2 s, V at 2 s + 1
  uint8_t* kept = ring + B32_STAGES * 2 * KV32;  // p of key tile j: [(16 j + pair) NTHREADS + tid]
  uint64_t* bars = reinterpret_cast<uint64_t*>(kept + (KEPT ? n * PC_TILE : 0));  // [b] own b
  uint64_t* full = bars + 2;                                                       // [s] slot s
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  // thread 0's cursor: the next entry to load
  Cursor32 next = cursor32(0, 2 * n, n);
  if (tid == 0) {
    for (int i = 0; i < 2 + B32_STAGES; ++i) mbar_init(&bars[i], 1);
    mbar_init_fence();
    for (int i = 0; i < 2 && i < mine; ++i)
      own32_load(smem + 2 * i * KV32, &bars[i], &map_q, &map_do, unit32(i, n));
    for (int e = 0; e < B32_STAGES && e < entries; ++e, advance32(next, 2 * n, n))
      dq32_ring(ring, full, &map_k, &map_v, e, next, n);  // slot e
  }
  __syncthreads();
  uint32_t* pc = reinterpret_cast<uint32_t*>(kept) + tid;
  float s[32], dp[32], acc[16];
  uint32_t u[16];
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;
  // the unit's row statistics, each read a unit ahead
  float lse_a = 0.f, lse_b = 0.f;
  if (mine > 0) {
    const Unit32 x = unit32(0, n);
    const int r_a = x.tile * TILE + warp * 16 + gid;
    lse_a = r_a < T ? lse2[(size_t)x.plane * T + r_a] : 0.f;
    lse_b = r_a + 8 < T ? lse2[(size_t)x.plane * T + r_a + 8] : 0.f;
  }
  for (int i = 0, r = 0; i < mine; ++i) {
    const Unit32 x = unit32(i, n);
    const int b = i & 1;
    const int w0 = x.tile * TILE + warp * 16;  // the warp's first row
    const bool live = w0 < T;                  // the warp holds a row below T
    const int r_a = w0 + gid, r_b = r_a + 8;
    float next_a = 0.f, next_b = 0.f;
    if (i + 1 < mine) {
      const Unit32 y = unit32(i + 1, n);
      const int y_a = y.tile * TILE + warp * 16 + gid;
      next_a = y_a < T ? lse2[(size_t)y.plane * T + y_a] : 0.f;
      next_b = y_a + 8 < T ? lse2[(size_t)y.plane * T + y_a + 8] : 0.f;
    }
    const uint8_t* q_s = smem + 2 * b * KV32;
    const uint8_t* do_s = q_s + KV32;
    mbar_wait(&bars[b], (i >> 1) & 1);
#pragma unroll
    for (int k = 0; k < 16; ++k) acc[k] = 0.f;
    float d_a = 0.f, d_b = 0.f;
    for (int j = 0; j < n; ++j, ++r) {  // first sweep: D = sum p * dP
      const int st = r % B32_STAGES;
      const uint8_t* k_s = ring + 2 * st * KV32;
      mbar_wait(&full[st], (r / B32_STAGES) & 1);
      product32(s, q_s, k_s);  // S = Q K^T
      if (live) probs32(u, s, j * TILE, tig, lse_a, lse_b, T, pad_lo, pad_hi, scale_log2);
      product32(dp, do_s, k_s + KV32);  // dP = dO V^T, once S is no longer needed
      __syncthreads();  // every warp is done with slot st: refill it
      if (tid == 0 && r + B32_STAGES < entries) {
        dq32_ring(ring, full, &map_k, &map_v, st, next, n);
        advance32(next, 2 * n, n);
      }
      if (live) {
#pragma unroll
        for (int pi = 0; pi < 16; ++pi) {
          const float t = lo_bf16(u[pi]) * dp[2 * pi] + hi_bf16(u[pi]) * dp[2 * pi + 1];
          if (pi & 1)
            d_b += t;
          else
            d_a += t;
          if constexpr (KEPT) pc[(j * 16 + pi) * NTHREADS] = u[pi];
        }
      }
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      d_a += __shfl_xor_sync(0xffffffffu, d_a, off);
      d_b += __shfl_xor_sync(0xffffffffu, d_b, off);
    }
    for (int j = 0; j < n; ++j, ++r) {  // second sweep: dS = p * (dP - D), dQ += dS K
      const int st = r % B32_STAGES;
      const uint8_t* k_s = ring + 2 * st * KV32;
      mbar_wait(&full[st], (r / B32_STAGES) & 1);
      if constexpr (KEPT) {
        if (live) {
#pragma unroll
          for (int pi = 0; pi < 16; ++pi) u[pi] = pc[(j * 16 + pi) * NTHREADS];
        }
        product32(dp, do_s, k_s + KV32);
      } else {
        product32(s, q_s, k_s);
        if (live) probs32(u, s, j * TILE, tig, lse_a, lse_b, T, pad_lo, pad_hi, scale_log2);
        product32(dp, do_s, k_s + KV32);
      }
      uint32_t ds[4][4];
      if (live) {
#pragma unroll
        for (int pi = 0; pi < 16; ++pi) {
          const float dsum = (pi & 1) ? d_b : d_a;
          ds[pi >> 2][pi & 3] = pack_bf16(lo_bf16(u[pi]) * (dp[2 * pi] - dsum),
                                          hi_bf16(u[pi]) * (dp[2 * pi + 1] - dsum));
        }
      } else {
#pragma unroll
        for (int pi = 0; pi < 16; ++pi) ds[pi >> 2][pi & 3] = 0u;
      }
      fence_regs(acc);
      fence_regs(ds);
      wgmma_fence();
#pragma unroll
      for (int kc = 0; kc < 4; ++kc)  // dQ += dS K
        wgmma_rs<1>(acc, ds[kc], HeadTile<32>::mnmajor(k_s, kc), 1);
      wgmma_commit();
      wgmma_wait();
      fence_regs(acc);
      fence_regs(ds);
      __syncthreads();  // every warp is done with slot st (and, at the last, with own buffer b)
      if (tid == 0) {
        if (r + B32_STAGES < entries) {
          dq32_ring(ring, full, &map_k, &map_v, st, next, n);
          advance32(next, 2 * n, n);
        }
        if (j == n - 1 && i + 2 < mine)
          own32_load(smem + 2 * b * KV32, &bars[b], &map_q, &map_do, unit32(i + 2, n));
      }
    }
    const size_t rowbase = (size_t)x.plane * T;
    store_rows<32>(dq + rowbase * 32, acc, scale, scale, r_a, r_b, tig, T);
    if (tig == 0) {
      if (r_a < T) dd[rowbase + r_a] = d_a;
      if (r_b < T) dd[rowbase + r_b] = d_b;
    }
    lse_a = next_a;
    lse_b = next_b;
  }
}

// pass B's p^T of a thread's S^T entries (keys as rows, the query tile from
// q0 on as columns), rounded to bf16 and packed in pairs as the A operand
// of dV: exp2(s * scale_log2 - lse2 of the column), lse2 from the slot's
// statistics. A query past T has lse2 = +inf, hence p = 0; only the tile
// that reaches T tests its groups of 8 columns, and skips the exp2s of a
// group wholly past T.
__device__ __forceinline__ void probs_t32(uint32_t (&pa)[4][4], const float (&s)[32],
                                          const float* stat, int q0, int T, int tig,
                                          float scale_log2) {
  if (q0 + TILE <= T) {
#pragma unroll
    for (int pi = 0; pi < 16; ++pi) {
      const float2 l = *reinterpret_cast<const float2*>(stat + (pi >> 1) * 8 + 2 * tig);
      pa[pi >> 2][pi & 3] = pack_bf16(ex2(fmaf(s[2 * pi], scale_log2, -l.x)),
                                      ex2(fmaf(s[2 * pi + 1], scale_log2, -l.y)));
    }
  } else {
#pragma unroll
    for (int pi = 0; pi < 16; ++pi) {
      const float2 l = *reinterpret_cast<const float2*>(stat + (pi >> 1) * 8 + 2 * tig);
      pa[pi >> 2][pi & 3] = q0 + (pi >> 1) * 8 >= T
                                ? 0u
                                : pack_bf16(ex2(fmaf(s[2 * pi], scale_log2, -l.x)),
                                            ex2(fmaf(s[2 * pi + 1], scale_log2, -l.y)));
    }
  }
}

// bwd32_dkv's ring entry at cursor c (ntiles entries a unit: the query
// tiles) into slot st: thread t's row statistic `stat` (t < 64: lse2 of row
// t of the tile, else D of row t - 64; read a step ahead by dkv32_stat) into
// the slot, and thread 0 the Q and dO tiles. A row past T gets lse2 = +inf,
// hence p = 0, and D = 0.
__device__ __forceinline__ float dkv32_stat(const float* lse2, const float* dd, const Cursor32& c,
                                            int T, int tid) {
  const int q = c.k * TILE + (tid & (TILE - 1));
  if (q >= T) return tid < TILE ? INFINITY : 0.f;
  return (tid < TILE ? lse2 : dd)[(size_t)c.plane * T + q];
}
__device__ __forceinline__ void dkv32_ring(uint8_t* ring, uint64_t* full, const CUtensorMap* mq,
                                           const CUtensorMap* mdo, int st, const Cursor32& c,
                                           int tid, float stat) {
  uint8_t* slot = ring + st * DKV32_SLOT;
  reinterpret_cast<float*>(slot + 2 * KV32)[tid] = stat;
  if (tid == 0) {
    mbar_expect_tx(&full[st], 2 * KV32);
    HeadTile<32>::load(slot, mq, &full[st], c.k * TILE, c.plane);
    HeadTile<32>::load(slot + KV32, mdo, &full[st], c.k * TILE, c.plane);
  }
}

// bwd32_dkv: pass B at head dim 32. One block = one warpgroup walking units
// of 64 keys, on the transposed products (keys as rows, queries as
// columns): per query tile S^T, then P^T into dV beside dP^T, then dS^T into
// dK, so that no two of S^T, dP^T and the gradients' pairs of accumulators
// are in flight at once.
__global__ void __launch_bounds__(NTHREADS, B32_BLOCKS_PER_SM)
bwd32_dkv(const __grid_constant__ CUtensorMap map_q, const __grid_constant__ CUtensorMap map_k,
          const __grid_constant__ CUtensorMap map_v, const __grid_constant__ CUtensorMap map_do,
          const float* __restrict__ lse2, const float* __restrict__ dd, bf16* __restrict__ dk,
          bf16* __restrict__ dv, int units, int T, int pad_lo, int pad_hi, float scale_log2,
          float scale) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);  // own buffer b: K at tile 2 b, V at 2 b + 1
  const int n = (T + TILE - 1) / TILE, mine = units32(units), entries = mine * n;
  uint8_t* ring = smem + 4 * KV32;  // slot s: Q, dO, their rows' lse2 and D
  uint64_t* bars = reinterpret_cast<uint64_t*>(ring + B32_STAGES * DKV32_SLOT);  // [b] own b
  uint64_t* full = bars + 2;                                                     // [s] slot s
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  if (tid == 0) {
    for (int i = 0; i < 2 + B32_STAGES; ++i) mbar_init(&bars[i], 1);
    mbar_init_fence();
    for (int i = 0; i < 2 && i < mine; ++i)
      own32_load(smem + 2 * i * KV32, &bars[i], &map_k, &map_v, unit32(i, n));
  }
  __syncthreads();  // barriers initialised
  Cursor32 next = cursor32(0, n, n);  // every thread's cursor: the next entry to load
  for (int e = 0; e < B32_STAGES && e < entries; ++e, advance32(next, n, n))
    dkv32_ring(ring, full, &map_q, &map_do, e, next, tid, dkv32_stat(lse2, dd, next, T, tid));
  __syncthreads();  // the first slots' statistics in place
  float s[32], dp[32], acc_k[16], acc_v[16];
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;
  for (int i = 0, r = 0; i < mine; ++i) {
    const Unit32 x = unit32(i, n);
    const int b = i & 1;
    const uint8_t* k_s = smem + 2 * b * KV32;
    const uint8_t* v_s = k_s + KV32;
    const int w0 = x.tile * TILE + warp * 16;  // the warp's first key
    // the warp holds a key below T and outside the gap (masked keys' rows are
    // zeroed at the store: a key's p reaches only its own rows of dK and dV)
    const bool live = w0 < T && !(w0 >= pad_lo && w0 + 16 <= pad_hi);
    const int key_a = w0 + gid, key_b = key_a + 8;
#pragma unroll
    for (int k = 0; k < 16; ++k) acc_k[k] = acc_v[k] = 0.f;
    mbar_wait(&bars[b], (i >> 1) & 1);
    for (int qt = 0; qt < n; ++qt, ++r) {
      const int st = r % B32_STAGES;
      const uint8_t* q_s = ring + st * DKV32_SLOT;
      const uint8_t* do_s = q_s + KV32;
      const float* stat = reinterpret_cast<const float*>(q_s + 2 * KV32);
      const bool refill = r + B32_STAGES < entries;
      // this thread's statistic of the entry that refills slot st, read early
      const float pre = refill ? dkv32_stat(lse2, dd, next, T, tid) : 0.f;
      mbar_wait(&full[st], (r / B32_STAGES) & 1);
      uint32_t pa[4][4], da[4][4];
      product32(s, k_s, q_s);  // S^T = K Q^T
      if (live) {
        probs_t32(pa, s, stat, qt * TILE, T, tig, scale_log2);
      } else {
#pragma unroll
        for (int pi = 0; pi < 16; ++pi) pa[pi >> 2][pi & 3] = 0u;
      }
      // dV += P^T dO beside dP^T = V dO^T: S^T is no longer needed
      fence_regs(acc_v);
      fence_regs(pa);
      fence_regs(dp);
      wgmma_fence();
#pragma unroll
      for (int kc = 0; kc < 4; ++kc)
        wgmma_rs<1>(acc_v, pa[kc], HeadTile<32>::mnmajor(do_s, kc), 1);
      issue_s32(dp, v_s, do_s);
      wgmma_commit();
      wgmma_wait();
      fence_regs(acc_v);
      fence_regs(pa);
      fence_regs(dp);
      if (live) {
#pragma unroll
        for (int pi = 0; pi < 16; ++pi) {
          const float2 dsum =
              *reinterpret_cast<const float2*>(stat + TILE + (pi >> 1) * 8 + 2 * tig);
          const uint32_t pu = pa[pi >> 2][pi & 3];
          da[pi >> 2][pi & 3] = pack_bf16(lo_bf16(pu) * (dp[2 * pi] - dsum.x),
                                          hi_bf16(pu) * (dp[2 * pi + 1] - dsum.y));
        }
      } else {
#pragma unroll
        for (int pi = 0; pi < 16; ++pi) da[pi >> 2][pi & 3] = 0u;
      }
      fence_regs(acc_k);
      fence_regs(da);
      wgmma_fence();
#pragma unroll
      for (int kc = 0; kc < 4; ++kc)  // dK += dS^T Q
        wgmma_rs<1>(acc_k, da[kc], HeadTile<32>::mnmajor(q_s, kc), 1);
      wgmma_commit();
      wgmma_wait();
      fence_regs(acc_k);
      fence_regs(da);
      // every warp is done with slot st and its statistics (and, at the last
      // query tile, with own buffer b); the slot's next statistics are read
      // after the barrier of the next step
      __syncthreads();
      if (refill) {
        dkv32_ring(ring, full, &map_q, &map_do, st, next, tid, pre);
        advance32(next, n, n);
      }
      if (tid == 0 && qt == n - 1 && i + 2 < mine)
        own32_load(smem + 2 * b * KV32, &bars[b], &map_k, &map_v, unit32(i + 2, n));
    }
    const size_t head = (size_t)x.plane * T * 32;
    const bool off_a = masked_col(key_a, T, pad_lo, pad_hi);
    const bool off_b = masked_col(key_b, T, pad_lo, pad_hi);
    store_rows<32>(dk + head, acc_k, off_a ? 0.f : scale, off_b ? 0.f : scale, key_a, key_b, tig,
                   T);
    store_rows<32>(dv + head, acc_v, off_a ? 0.f : 1.f, off_b ? 0.f : 1.f, key_a, key_b, tig, T);
  }
}

// bwd32_short's plane p into ring slot st, by the producer warp: the plane's
// lse2 by its lanes (a row past T gets +inf, hence p = 0), then lane 0 its
// Q, K, V and dO tiles
__device__ __forceinline__ void short32_load(uint8_t* ring, float* stats, uint64_t* full,
                                             const CUtensorMap* const (&m)[4], const float* lse2,
                                             int st, int p, int T, int lane) {
  float* stat = stats + st * TILE;
#pragma unroll
  for (int h = 0; h < TILE / 32; ++h) {
    const int r = lane + 32 * h;
    stat[r] = r < T ? lse2[(size_t)p * T + r] : INFINITY;
  }
  __syncwarp();
  if (lane == 0) {
    uint8_t* slot = ring + st * SHORT32_SLOT;
    mbar_expect_tx(&full[st], SHORT32_SLOT);
#pragma unroll
    for (int i = 0; i < 4; ++i) HeadTile<32>::load(slot + i * KV32, m[i], &full[st], 0, p);
  }
}

// bwd32_short: head dim 32, T <= 64, where a plane is one query and one key
// tile: the whole backward of a plane in one pass. One block = one consumer
// warpgroup that walks planes blockIdx.x, + gridDim.x, ... (the host
// launches at most as many blocks as are resident at once), and a producer
// warp that keeps the next planes' Q, K, V, dO and lse2 in flight. Per
// plane: S and dP, p and D = sum p * dP (one key tile holds the whole row,
// so D is final at once), dS; P and dS go to shared memory as bf16 under
// the 128-byte swizzle, where dV = P^T dO and dK = dS^T Q read them as
// MN-major A operands, while dQ = dS K takes dS from registers. q, k, v and
// dO are read once and dq, dk, dv written once; D never leaves the block.
__global__ void __launch_bounds__(SHORT32_THREADS, SHORT32_BLOCKS_PER_SM)
bwd32_short(const __grid_constant__ CUtensorMap map_q, const __grid_constant__ CUtensorMap map_k,
            const __grid_constant__ CUtensorMap map_v, const __grid_constant__ CUtensorMap map_do,
            const float* __restrict__ lse2, bf16* __restrict__ dq, bf16* __restrict__ dk,
            bf16* __restrict__ dv, int planes, int T, int pad_lo, int pad_hi, float scale_log2,
            float scale) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  uint8_t* p_s = smem;                    // P: query rows, key columns
  uint8_t* ds_s = smem + TILE_BYTES;      // dS, the same way
  uint8_t* ring = smem + 2 * TILE_BYTES;  // slot s: Q, K, V, dO
  float* stats = reinterpret_cast<float*>(ring + B32_SHORT_STAGES * SHORT32_SLOT);  // [s][TILE]
  // [s] slot s arrived, [B32_SHORT_STAGES + s] slot s free
  uint64_t* full = reinterpret_cast<uint64_t*>(stats + B32_SHORT_STAGES * TILE);
  uint64_t* freed = full + B32_SHORT_STAGES;
  if (threadIdx.x == 0) {
    for (int s = 0; s < B32_SHORT_STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&freed[s], NTHREADS);
    }
    mbar_init_fence();
  }
  __syncthreads();
  if (threadIdx.x >= NTHREADS) {  // the producer warp: plane i once plane i - stages left its slot
    const CUtensorMap* maps[4] = {&map_q, &map_k, &map_v, &map_do};
    const int lane = threadIdx.x & 31;
    for (int i = 0, p = blockIdx.x; p < planes; ++i, p += gridDim.x) {
      const int st = i % B32_SHORT_STAGES;
      if (i >= B32_SHORT_STAGES) mbar_wait(&freed[st], (i / B32_SHORT_STAGES - 1) & 1);
      short32_load(ring, stats, full, maps, lse2, st, p, T, lane);
    }
    return;
  }
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  // rows r_a, r_b: queries of S, dP and dQ; keys of dK and dV
  const int r_a = warp * 16 + gid, r_b = r_a + 8;
  const bool live = warp * 16 < T;  // the warp holds a query below T
  const bool off_a = masked_col(r_a, T, pad_lo, pad_hi);
  const bool off_b = masked_col(r_b, T, pad_lo, pad_hi);
  float s[32], dp[32], gq[16], gk[16], gv[16];
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 16; ++i) gq[i] = gk[i] = gv[i] = 0.f;
  for (int i = 0, p = blockIdx.x; p < planes; ++i, p += gridDim.x) {
    const int st = i % B32_SHORT_STAGES;
    const uint8_t* q_s = ring + st * SHORT32_SLOT;
    const uint8_t* k_s = q_s + KV32;
    const uint8_t* v_s = q_s + 2 * KV32;
    const uint8_t* do_s = q_s + 3 * KV32;
    mbar_wait(&full[st], (i / B32_SHORT_STAGES) & 1);
    const float l_a = stats[st * TILE + r_a], l_b = stats[st * TILE + r_b];
    fence_regs(s);
    fence_regs(dp);
    wgmma_fence();
    issue_s32(s, q_s, k_s);    // S = Q K^T
    issue_s32(dp, do_s, v_s);  // dP = dO V^T
    wgmma_commit();
    wgmma_wait();
    fence_regs(s);
    fence_regs(dp);
    uint32_t u[16], ds[4][4];
    if (live) {
      probs32(u, s, 0, tig, l_a, l_b, T, pad_lo, pad_hi, scale_log2);
      float d_a = 0.f, d_b = 0.f;
#pragma unroll
      for (int pi = 0; pi < 16; ++pi) {
        const float t = lo_bf16(u[pi]) * dp[2 * pi] + hi_bf16(u[pi]) * dp[2 * pi + 1];
        if (pi & 1)
          d_b += t;
        else
          d_a += t;
      }
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        d_a += __shfl_xor_sync(0xffffffffu, d_a, off);
        d_b += __shfl_xor_sync(0xffffffffu, d_b, off);
      }
#pragma unroll
      for (int pi = 0; pi < 16; ++pi) {
        const float dsum = (pi & 1) ? d_b : d_a;
        ds[pi >> 2][pi & 3] = pack_bf16(lo_bf16(u[pi]) * (dp[2 * pi] - dsum),
                                        hi_bf16(u[pi]) * (dp[2 * pi + 1] - dsum));
      }
    } else {
#pragma unroll
      for (int pi = 0; pi < 16; ++pi) u[pi] = ds[pi >> 2][pi & 3] = 0u;
    }
    consumers_sync();  // the last plane's products are done with P and dS
#pragma unroll
    for (int pi = 0; pi < 16; ++pi) {
      const uint32_t at = swz128(r_a + 8 * (pi & 1), (pi >> 1) * 8 + 2 * tig);
      *reinterpret_cast<uint32_t*>(p_s + at) = u[pi];
      *reinterpret_cast<uint32_t*>(ds_s + at) = ds[pi >> 2][pi & 3];
    }
    fence_async_smem();
    consumers_sync();  // P and dS in place for the products
    fence_regs(gq);
    fence_regs(gk);
    fence_regs(gv);
    fence_regs(ds);
    wgmma_fence();
#pragma unroll
    for (int kc = 0; kc < 4; ++kc)  // dQ = dS K
      wgmma_rs<1>(gq, ds[kc], HeadTile<32>::mnmajor(k_s, kc), kc);
#pragma unroll
    for (int kc = 0; kc < 4; ++kc)  // dV = P^T dO
      wgmma_ss32<1, 1>(gv, desc_mnmajor(p_s, kc), HeadTile<32>::mnmajor(do_s, kc), kc);
#pragma unroll
    for (int kc = 0; kc < 4; ++kc)  // dK = dS^T Q
      wgmma_ss32<1, 1>(gk, desc_mnmajor(ds_s, kc), HeadTile<32>::mnmajor(q_s, kc), kc);
    wgmma_commit();
    wgmma_wait();
    fence_regs(gq);
    fence_regs(gk);
    fence_regs(gv);
    fence_regs(ds);
    mbar_arrive(&freed[st]);
    const size_t head = (size_t)p * T * 32;
    store_rows<32>(dq + head, gq, scale, scale, r_a, r_b, tig, T);
    store_rows<32>(dk + head, gk, off_a ? 0.f : scale, off_b ? 0.f : scale, r_a, r_b, tig, T);
    store_rows<32>(dv + head, gv, off_a ? 0.f : 1.f, off_b ? 0.f : 1.f, r_a, r_b, tig, T);
  }
}

// one tensor map per (B*H, T, HD) input (0, or encode_plane_map's code), and
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
  dim3 grid((T + TILE - 1) / TILE * dkv_parts<HD>(), H, B);
  bwd_dkv<HD><<<grid, NTHREADS, smem, stream>>>(m[0], m[1], m[2], m[3], (const float*)lse2,
                                                 (const float*)dd, (bf16*)dk, (bf16*)dv, H, T,
                                                 pad_lo, pad_hi, scale_log2, scale);
  return (int)cudaGetLastError();
}

// the wide route's passes: D = 128 NS; one map per (B*H, T, D) input
int wide_maps(CUtensorMap (&m)[4], const void* q, const void* k, const void* v, const void* dout,
              int planes, int T, int D, const void* x, const void* y) {
  const void* base[4] = {q, k, v, dout};
  for (int i = 0; i < 4; ++i)
    if (int err = Slab::map(&m[i], base[i], planes, T, D)) return err;
  if (((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(y)) & 15) != 0)
    return TMA_MISALIGNED;
  return 0;
}

int backward_dq_wide(const void* q, const void* k, const void* v, const void* dout,
                     const void* lse2, void* dq, void* dd, int B, int H, int T, int D, int pad_lo,
                     int pad_hi, float scale_log2, float scale, cudaStream_t stream) {
  constexpr int smem = (int)wide_dq_smem();
  // a runtime call first: it makes the device's context current on this
  // thread (the autograd engine's), which the tensor-map encoding needs
  cudaError_t err =
      cudaFuncSetAttribute(bwd_dq_wide, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  CUtensorMap m[4];
  if (int bad = wide_maps(m, q, k, v, dout, B * H, T, D, dq, dd)) return bad;
  const int NS = D / SLAB_COLS;
  dim3 grid((T + TILE - 1) / TILE * NS, H, B);
  bwd_dq_wide<<<grid, NTHREADS, smem, stream>>>(m[0], m[1], m[2], m[3], (const float*)lse2,
                                                (bf16*)dq, (float*)dd, H, T, NS, pad_lo, pad_hi,
                                                scale_log2, scale);
  return (int)cudaGetLastError();
}

int backward_dkv_wide(const void* q, const void* k, const void* v, const void* dout,
                      const void* lse2, const void* dd, void* dk, void* dv, int B, int H, int T,
                      int D, int pad_lo, int pad_hi, float scale_log2, float scale,
                      cudaStream_t stream) {
  constexpr int smem = (int)wide_dkv_smem();
  cudaError_t err =
      cudaFuncSetAttribute(bwd_dkv_wide, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  CUtensorMap m[4];
  if (int bad = wide_maps(m, q, k, v, dout, B * H, T, D, dk, dv)) return bad;
  const int NS = D / SLAB_COLS;
  dim3 grid((T + TILE - 1) / TILE * 2 * NS, H, B);
  bwd_dkv_wide<<<grid, NTHREADS, smem, stream>>>(m[0], m[1], m[2], m[3], (const float*)lse2,
                                                 (const float*)dd, (bf16*)dk, (bf16*)dv, H, T, NS,
                                                 pad_lo, pad_hi, scale_log2, scale);
  return (int)cudaGetLastError();
}

// ------------------------------------------------------- head dim 32, host
//
// The plan of a d = 32 backward (mirrored in ops/attention.py, d32_bwd_plan):
// the route (bwd32_short at T <= 64, else the pair), each kernel's grid and
// shared memory, whether bwd32_dq keeps p, and the blocks per SM the
// device reports for each.

// the four d = 32 backward kernels the plan chooses from
enum { K32B_DQ = 0, K32B_DQ_KEPT = 1, K32B_DKV = 2, K32B_SHORT = 3, K32B_KERNELS = 4 };

const void* kernel_b32(int which) {
  switch (which) {
    case K32B_DQ: return (const void*)bwd32_dq<false>;
    case K32B_DQ_KEPT: return (const void*)bwd32_dq<true>;
    case K32B_DKV: return (const void*)bwd32_dkv;
    default: return (const void*)bwd32_short;
  }
}

// The device's SMs and kernel `which`'s resident blocks per SM at `smem`
// bytes (after raising its shared-memory limit to them); asked once per
// (device, kernel, smem), kept as smem << 20 | per_sm.
cudaError_t occupancy_b32(int which, int smem, int* sms, int* per_sm) {
  constexpr int MAX_DEVICES = 64;
  static std::atomic<long long> known[MAX_DEVICES][K32B_KERNELS];
  static std::atomic<int> known_sms[MAX_DEVICES];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const void* kern = kernel_b32(which);
  if ((err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem)) !=
      cudaSuccess)
    return err;
  if ((err = cudaFuncSetAttribute(kern, cudaFuncAttributePreferredSharedMemoryCarveout,
                                  cudaSharedmemCarveoutMaxShared)) != cudaSuccess)
    return err;
  if (dev < MAX_DEVICES) {
    const long long k = known[dev][which].load(std::memory_order_relaxed);
    if (k > 0 && (k >> 20) == smem) {
      *per_sm = (int)(k & ((1 << 20) - 1));
      *sms = known_sms[dev].load(std::memory_order_relaxed);
      return cudaSuccess;
    }
  }
  if ((err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return err;
  const int threads = which == K32B_SHORT ? SHORT32_THREADS : NTHREADS;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, kern, threads, smem)) !=
      cudaSuccess)
    return err;
  if (*per_sm < 1) *per_sm = 1;
  if (dev < MAX_DEVICES) {
    known_sms[dev].store(*sms, std::memory_order_relaxed);
    known[dev][which].store(((long long)smem << 20) | *per_sm, std::memory_order_relaxed);
  }
  return cudaSuccess;
}

// at most `units` blocks, as many as are resident at once
int resident(long units, int sms, int per_sm) {
  const long slots = (long)sms * per_sm;
  return (int)(units < slots ? units : slots);
}

// plan[0] the route (1: bwd32_short, T <= 64; 0: bwd32_dq + bwd32_dkv);
// [1] bwd32_short's blocks, [2] its blocks per SM, [3] its shared memory;
// [4] bwd32_dq's kernel (K32B_DQ, or K32B_DQ_KEPT where it keeps p), [5]
// its blocks, [6] its blocks per SM, [7] its shared memory; [8] bwd32_dkv's
// blocks, [9] its blocks per SM, [10] its shared memory; [11] the SMs; [12]
// the units of either pass (planes x 64-row tiles).
cudaError_t plan_b32(int B, int H, int T, int* plan) {
  const int ntiles = (T + TILE - 1) / TILE;
  const long planes = (long)B * H;
  plan[0] = T <= TILE ? 1 : 0;
  plan[3] = (int)short32_smem();
  cudaError_t err = occupancy_b32(K32B_SHORT, plan[3], &plan[11], &plan[2]);
  if (err != cudaSuccess) return err;
  plan[1] = resident(planes, plan[11], plan[2]);
  const bool keeps = dq32_keeps(ntiles);
  plan[4] = keeps ? K32B_DQ_KEPT : K32B_DQ;
  plan[7] = (int)dq32_smem(keeps ? ntiles : 0);
  if ((err = occupancy_b32(plan[4], plan[7], &plan[11], &plan[6])) != cudaSuccess) return err;
  plan[12] = (int)(planes * ntiles);
  plan[5] = resident(plan[12], plan[11], plan[6]);
  plan[10] = (int)dkv32_smem();
  if ((err = occupancy_b32(K32B_DKV, plan[10], &plan[11], &plan[9])) != cudaSuccess) return err;
  plan[8] = resident(plan[12], plan[11], plan[9]);
  return cudaSuccess;
}

int backward_dq32(const void* q, const void* k, const void* v, const void* dout, const void* lse2,
                  void* dq, void* dd, int B, int H, int T, int pad_lo, int pad_hi,
                  float scale_log2, float scale, cudaStream_t stream) {
  int plan[13];
  // a runtime call first (in occupancy_b32): it makes the device's context
  // current on this thread (the autograd engine's), which the tensor-map
  // encoding needs
  cudaError_t err = plan_b32(B, H, T, plan);
  if (err != cudaSuccess) return (int)err;
  CUtensorMap m[4];
  if (int bad = make_maps<32>(m, q, k, v, dout, B * H, T, dq, dd)) return bad;
  if (plan[4] == K32B_DQ_KEPT)
    bwd32_dq<true><<<plan[5], NTHREADS, plan[7], stream>>>(
        m[0], m[1], m[2], m[3], (const float*)lse2, (bf16*)dq, (float*)dd, plan[12], T, pad_lo,
        pad_hi, scale_log2, scale);
  else
    bwd32_dq<false><<<plan[5], NTHREADS, plan[7], stream>>>(
        m[0], m[1], m[2], m[3], (const float*)lse2, (bf16*)dq, (float*)dd, plan[12], T, pad_lo,
        pad_hi, scale_log2, scale);
  return (int)cudaGetLastError();
}

int backward_dkv32(const void* q, const void* k, const void* v, const void* dout,
                   const void* lse2, const void* dd, void* dk, void* dv, int B, int H, int T,
                   int pad_lo, int pad_hi, float scale_log2, float scale, cudaStream_t stream) {
  int plan[13];
  cudaError_t err = plan_b32(B, H, T, plan);
  if (err != cudaSuccess) return (int)err;
  CUtensorMap m[4];
  if (int bad = make_maps<32>(m, q, k, v, dout, B * H, T, dk, dv)) return bad;
  bwd32_dkv<<<plan[8], NTHREADS, plan[10], stream>>>(
      m[0], m[1], m[2], m[3], (const float*)lse2, (const float*)dd, (bf16*)dk, (bf16*)dv,
      plan[12], T, pad_lo, pad_hi, scale_log2, scale);
  return (int)cudaGetLastError();
}

int backward_short32(const void* q, const void* k, const void* v, const void* dout,
                     const void* lse2, void* dq, void* dk, void* dv, int B, int H, int T,
                     int pad_lo, int pad_hi, float scale_log2, float scale, cudaStream_t stream) {
  int plan[13];
  cudaError_t err = plan_b32(B, H, T, plan);
  if (err != cudaSuccess) return (int)err;
  CUtensorMap m[4];
  if (int bad = make_maps<32>(m, q, k, v, dout, B * H, T, dq, dk)) return bad;
  if ((reinterpret_cast<uintptr_t>(dv) & 15) != 0) return TMA_MISALIGNED;
  bwd32_short<<<plan[1], SHORT32_THREADS, plan[3], stream>>>(
      m[0], m[1], m[2], m[3], (const float*)lse2, (bf16*)dq, (bf16*)dk, (bf16*)dv, B * H, T,
      pad_lo, pad_hi, scale_log2, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// q, k, v, dout, dq: (B, H, T, D) bf16 contiguous, 16-byte aligned,
// D = 64, 32, 128 or a multiple of 128 above it (the wide route;
// cudaErrorInvalidValue otherwise); lse2 (from attn_flash_forward on the
// same q, k) and dd: (B, H, T) f32. dd (D = sum_s p*dP per row) is written.
// Returns a cudaError_t, or a code of encode_plane_map (>= 998) when a
// tensor map cannot be made.
int attn_backward_dq(const void* q, const void* k, const void* v, const void* dout,
                     const void* lse2, void* dq, void* dd, int B, int H, int T, int D,
                     int pad_lo, int pad_hi, float scale_log2, float scale, void* stream) {
  if (D == 64)
    return backward_dq<64>(q, k, v, dout, lse2, dq, dd, B, H, T, pad_lo, pad_hi, scale_log2,
                           scale, (cudaStream_t)stream);
  if (D == 32)
    return backward_dq32(q, k, v, dout, lse2, dq, dd, B, H, T, pad_lo, pad_hi, scale_log2, scale,
                         (cudaStream_t)stream);
  if (D == 128)
    return backward_dq<128>(q, k, v, dout, lse2, dq, dd, B, H, T, pad_lo, pad_hi, scale_log2,
                            scale, (cudaStream_t)stream);
  if (wide_head_dim(D))
    return backward_dq_wide(q, k, v, dout, lse2, dq, dd, B, H, T, D, pad_lo, pad_hi, scale_log2,
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
    return backward_dkv32(q, k, v, dout, lse2, dd, dk, dv, B, H, T, pad_lo, pad_hi, scale_log2,
                          scale, (cudaStream_t)stream);
  if (D == 128)
    return backward_dkv<128>(q, k, v, dout, lse2, dd, dk, dv, B, H, T, pad_lo, pad_hi,
                             scale_log2, scale, (cudaStream_t)stream);
  if (wide_head_dim(D))
    return backward_dkv_wide(q, k, v, dout, lse2, dd, dk, dv, B, H, T, D, pad_lo, pad_hi,
                             scale_log2, scale, (cudaStream_t)stream);
  return (int)cudaErrorInvalidValue;
}

// dq, dk, dv: (B, H, T, 32) bf16, all three gradients of a head-dim-32
// backward with T <= 64 in one pass (bwd32_short; cudaErrorInvalidValue for
// another D or T); the other arguments as attn_backward_dq's.
int attn_backward_short(const void* q, const void* k, const void* v, const void* dout,
                        const void* lse2, void* dq, void* dk, void* dv, int B, int H, int T,
                        int D, int pad_lo, int pad_hi, float scale_log2, float scale,
                        void* stream) {
  if (D != 32 || T < 1 || T > TILE) return (int)cudaErrorInvalidValue;
  return backward_short32(q, k, v, dout, lse2, dq, dk, dv, B, H, T, pad_lo, pad_hi, scale_log2,
                          scale, (cudaStream_t)stream);
}

// The plan of a d = 32 backward at (B, H, T) into plan[13] (plan_b32:
// route, kernels, grids, blocks per SM, shared memory, SMs). Returns a
// cudaError_t.
int attn_d32_bwd_plan(int B, int H, int T, int* plan) { return (int)plan_b32(B, H, T, plan); }

}  // extern "C"
