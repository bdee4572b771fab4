// Attention forward kernels for the ViT and Swin backbones (bf16, head dim
// 64, 32, 128 or a multiple of 128 above it, any number of heads).
//
// Replaces two Pallas TPU kernels of attentionshift_tpu/ops/attention.py:
//   _kernel        (:251, via attention_with_capture): per-head softmax
//                  attention AND the head-averaged probability matrix;
//   _plain_kernel  (:315, via attention_no_capture): the same attention
//                  without the probability output.
//
// What bounds it on the H100. At the bench shape (B=1, H=6, T=4352, d=64)
// one plain call is 4*H*T^2*d = 29 GFLOP against 13 MB of q/k/v/out: far
// above the ~295 FLOP/byte ridge, so the tensor cores bound it (29 us at
// 989 TFLOP/s). Each of the two kernels also takes one exp2 per (head,
// row, key), 114 M at that shape: ~29 us at 16 per clock per SM, as long
// as the products at head dim 64, so the exp work has to run beside them.
// The capture call adds the (T, T) bf16 mean matrix, 38 MB written once
// (11 us at 3.35 TB/s), and the recompute of q.k^T for it.
//
// Head dim 32 (Swin's global blocks: B=1, H=24, T=1276) halves the
// products per exp2: 4*H*T^2*d = 5.0 GFLOP (5.1 us at 989 TFLOP/s)
// against 39.1 M exp2 per pass (9.3 us at 16 per clock per SM, 132 SMs,
// 1980 MHz), so there the exp work, not the tensor cores, bounds both
// kernels. Tiles are 64 rows of 64 bytes under the 64-byte swizzle
// (HeadTile<32> in hopper.cuh), S = Q K^T takes two k16 steps and O += P V
// is m64n32k16. Three kernels of their own serve d = 32:
//   flash_fwd32        T > 64 (Swin; the mask head's T = 196). Bound by
//                      exp2. Two warpgroups on 128 query rows share a K/V
//                      ring but never meet after the start: a producer
//                      warp refills a slot once both have freed it, so
//                      neither waits for the other's softmax; within a
//                      warpgroup the softmax of tile j runs beside the PV
//                      product of tile j - 1. The softmax's instruction
//                      stream, not the MUFU alone, holds it back (an exp2
//                      share on the FMA pipe lost time at every share, and
//                      so did products taken in turns by the warpgroups).
//   flash_fwd32_short  T <= 64 (the box head's T = 50, 4096 planes). Bound
//                      by bytes. One warpgroup per block walks whole planes
//                      (one query and one key tile each), the next planes'
//                      Q, K, V in flight while one computes; no warpgroup
//                      holds only rows past T.
//   attn_mean32        the mean pass. Bound by exp2. Four warpgroups per
//                      block share the resident query tiles and row
//                      statistics, each on its own key tiles through its
//                      own four-slot K ring that a lane of the producer
//                      warp refills; one S accumulator each (no S issued
//                      ahead) keeps them at ~90 registers, so that four fit.
// The host picks the kernel, grid and mean chunk (plan32, exported as
// attn_d32_plan and mirrored in ops/attention.py::d32_plan).
//
// Head dim 128 (ops/attention.py also pads head dims 72-120 onto it) doubles
// the products per exp2 again, so the tensor cores bound it as at 64. Its
// tile is two 64-column TMA boxes in one 16 KB slot (HeadTile<128>): S = Q
// K^T takes eight k16 steps, O += P V is m64n128k16 into 64 accumulators a
// thread. The flash pass's ring (10 tiles, 160 KB) and its registers (S,
// O, P: ~120 a thread) allow one block per SM; the mean pass keeps up to 8
// heads' query tiles resident (16 KB each).
//
// Head dims above 128 (ops/attention.py zero-pads a multiple of 8 above 128
// to D = 128 * ceil(d / 128); the TPU kernels take any d divisible by 8)
// take the wide route, flash_fwd_wide and attn_mean_wide: a head row is NS
// = D / 128 slabs of 128 columns, each a HeadTile<128> at column 128 c of a
// tensor map over the whole row, streamed through a two-slot ring, so
// shared memory does not grow with D. The tensor cores bound it as at 128.
// The flash pass is one warpgroup per (64 query rows, output slab): S
// accumulates over the NS slabs of Q and K, then the online softmax and
// O_sl += P V_sl (m64n128k16, 64 accumulators a thread); each of a query
// tile's NS blocks recomputes the same S, so the route does (NS + 1) / 2
// times the needed products (1.5x at d = 256, 2x at 384) and keeps O in
// registers at any D. The mean pass walks its units' slabs the same way,
// query tiles streamed. Every product waits for itself (no overlap of the
// exp work with the next product): simple and right first.
//
// What the design does about it (helpers in hopper.cuh). The TPU kernel
// kept all six heads' K/V and a (128, T) f32 row tile in 100 MB of VMEM;
// an SM has 227 KB, so the key axis is tiled. Tiles are 64 rows, loaded by
// TMA from 3-D (B*H, T, 64) tensor maps under the 128-byte swizzle (rows
// >= T of a head arrive as zeros) with mbarrier completion; each warpgroup
// owns a 64-row tile of queries; every product is a wgmma m64n64k16 with
// f32 accumulators, and ptxas keeps them asynchronous (no C751x warning)
// because every step issues one batch and waits for all of it.
//   flash_fwd   one block = two warpgroups = 128 query rows of one head,
//               two blocks per SM. Both warpgroups read each K and V tile
//               of a four-slot ring, refilled by thread 0 once both are
//               done with a slot, so each tile crosses L2 once per 128
//               rows. Per key tile: the online softmax on the S
//               accumulators, p rounded to bf16 into register A operands,
//               then one batch of O += P V (V read MN-major through the
//               descriptor's transpose bit, so no transposed copy of V
//               exists) and the next tile's S = Q K^T (both tiles
//               K-major). The two warpgroups and the other block on the SM
//               overlap one warpgroup's exp work with another's products.
//               It writes `out` and, for the capture call or a gradient,
//               each row's log2-sum-exp per head (the row normaliser,
//               known before heads are summed). The bench shape's 204
//               blocks fill 264 slots unevenly: 72 SMs hold two blocks and
//               60 one, so the busiest hold 4 of the 3.09 query tiles an
//               even share would give.
//   attn_mean   one block = one warpgroup per (64 query rows, chunk of key
//               tiles, image), three blocks per SM: the query tiles of all
//               heads loaded once and kept (H x 8 KB at d = 64, H x 4 KB at
//               32) while they fit in MEAN_RESIDENT_BYTES (16 heads at d =
//               64, 32 at d = 32); above that each unit's query tile
//               streams beside its K tile through the ring instead, which
//               reads Q once per (key tile, head) and lifts any head limit;
//               the K tile of every
//               (key tile, head) streams through a two-slot ring, so K is
//               read once per (row tile, head); S_h = Q_h K_h^T by wgmma
//               (the next head's product issued before this head's exp
//               work, two S accumulators), p = exp2(s - lse_h) summed over
//               heads in f32 registers, the mean tile written once in
//               bf16. The host picks the chunk length for the fewest,
//               shortest waves (4 key tiles at the bench shape, 1156
//               blocks). Nothing (T, T)-sized but the output itself touches
//               device memory.
// Columns in the pad gap [pad_lo, pad_hi) and columns >= T get p = 0, and
// only tiles that reach the gap or T test columns at all. The masking and
// the exp work are branch-free: a masked entry takes exp2(-inf) = 0 (a
// branch around each exp2 serialises their latencies). The row sum is
// floored at 1e-30 as on the TPU. The TPU's constant shift of 20 in exp2
// (a VPU choice) is replaced by the row max, which makes its exponent
// clamp at 100 unnecessary. No atomics: every output element is written
// once, by one block, in a fixed order.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>

#include "hopper.cuh"

namespace {

using namespace hopper;

// Design constants. Each may be overridden with -D at build time, which
// is how `chip_smoke.py --ablate` builds the variants it times.
#ifndef FWD_WARPGROUPS
#define FWD_WARPGROUPS 2  // 64-row query tiles per flash_fwd block
#endif
#ifndef FWD_STAGES
#define FWD_STAGES 4  // K/V ring slots of flash_fwd
#endif
#ifndef FWD_BLOCKS_PER_SM
#define FWD_BLOCKS_PER_SM 2
#endif
#ifndef MEAN_STAGES
#define MEAN_STAGES 2  // K ring slots of attn_mean
#endif
#ifndef MEAN_BLOCKS_PER_SM
#define MEAN_BLOCKS_PER_SM 3
#endif
#ifndef MEAN_MAX_CHUNK
#define MEAN_MAX_CHUNK 16  // key tiles per attn_mean block, at most
#endif
#ifndef MEAN_RESIDENT_BYTES
#define MEAN_RESIDENT_BYTES (16 * 8192)  // query tiles attn_mean keeps, at most
#endif
// head dim 32 (flash_fwd32, flash_fwd32_short, attn_mean32)
#ifndef F32_OVERLAP
#define F32_OVERLAP 1  // flash_fwd32: the softmax of tile j beside the PV product of tile j - 1
#endif
#ifndef F32_SHORT
#define F32_SHORT 1  // T <= 64 takes flash_fwd32_short (0: flash_fwd32)
#endif
#ifndef F32_SHORT_STAGES
#define F32_SHORT_STAGES 2  // planes in flight per flash_fwd32_short block
#endif
#ifndef M32_WARPGROUPS
#define M32_WARPGROUPS 4  // attn_mean32's warpgroups per block, over one set of query tiles
#endif
#ifndef M32_STAGES
#define M32_STAGES 4  // K ring slots of each attn_mean32 warpgroup
#endif
#ifndef M32_BLOCKS_PER_SM
#define M32_BLOCKS_PER_SM 1
#endif

constexpr int TILE = TILE_ROWS;
constexpr int WG_THREADS = 128;  // one warpgroup
constexpr int FWD_ROWS = FWD_WARPGROUPS * TILE_ROWS;
constexpr int FWD_THREADS = FWD_WARPGROUPS * WG_THREADS;
constexpr int WIDE_BLOCKS_PER_SM = 2;  // flash_fwd_wide blocks per SM (launch bounds)
constexpr int F32_STAGES = 4;          // K/V ring slots of flash_fwd32
constexpr int F32_BLOCKS_PER_SM = 2;   // flash_fwd32 blocks per SM (launch bounds)
constexpr int F32_SHORT_BLOCKS_PER_SM = 4;  // flash_fwd32_short blocks per SM (launch bounds)

// flash_fwd: the query tiles, FWD_STAGES slots of (K, V), the barriers
template <int HD>
constexpr size_t fwd_smem() {
  return (size_t)(FWD_WARPGROUPS + 2 * FWD_STAGES) * HeadTile<HD>::BYTES +
         (1 + FWD_STAGES) * sizeof(uint64_t) + 1024;
}

// attn_mean: H query tiles and MEAN_STAGES K slots, with H x 64 row
// statistics (resident); or MEAN_STAGES slots of a K and a query tile
// (streamed); the barriers
template <int HD>
size_t mean_smem(int H, bool resident) {
  const size_t tiles = resident ? (size_t)H + MEAN_STAGES : (size_t)2 * MEAN_STAGES;
  return tiles * HeadTile<HD>::BYTES + (resident ? (size_t)H * TILE * sizeof(float) : 0) +
         (1 + MEAN_STAGES) * sizeof(uint64_t) + 1024;
}

// bytes of a 64-row bf16 tile at head dim hd
constexpr long tile_bytes(int hd) { return (long)TILE_ROWS * hd * 2; }

// whether attn_mean keeps every head's query tile at head dim hd
bool mean_resident(int H, int hd) {
  return (long)H * tile_bytes(hd) <= (long)MEAN_RESIDENT_BYTES;
}

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ bool masked_col(int col, int T, int pad_lo, int pad_hi) {
  return col >= T || (col >= pad_lo && col < pad_hi);
}

// a 64-key tile from key0 on holds a column >= T or in the gap
__device__ __forceinline__ bool tile_masked(int key0, int T, int pad_lo, int pad_hi) {
  return key0 + TILE > T || (key0 + TILE > pad_lo && key0 < pad_hi);
}

// column of accumulator element i of a thread (d[4j + i'] layout, hopper.cuh)
__device__ __forceinline__ int acc_col(int i, int tig) { return (i >> 2) * 8 + tig * 2 + (i & 1); }

// max and sum of a thread's 16 accumulator entries of one row (`half` 0:
// the entries i with i & 2 == 0, row r_a; 2: row r_b), as a tree, so that
// the softmax's critical path is 4 deep instead of 16
__device__ __forceinline__ float row_max(const float (&d)[32], int half) {
  float m[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) m[j] = fmaxf(d[4 * j + half], d[4 * j + half + 1]);
#pragma unroll
  for (int w = 4; w > 0; w >>= 1)
#pragma unroll
    for (int j = 0; j < w; ++j) m[j] = fmaxf(m[j], m[j + w]);
  return m[0];
}

__device__ __forceinline__ float row_sum(const float (&d)[32], int half) {
  float m[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) m[j] = d[4 * j + half] + d[4 * j + half + 1];
#pragma unroll
  for (int w = 4; w > 0; w >>= 1)
#pragma unroll
    for (int j = 0; j < w; ++j) m[j] += m[j + w];
  return m[0];
}

// ------------------------------------------------------------- flash_fwd

struct FwdArgs {
  const uint8_t* q_s;
  uint8_t* ring;  // slot s: K at tile 2s, V at tile 2s + 1
  uint64_t* bars;  // [0] query tiles, [1 + s] slot s
  const CUtensorMap* map_k;
  const CUtensorMap* map_v;
  int plane, n, T, pad_lo, pad_hi, tig, tid;
  float scale_log2;
};

template <int HD>
__device__ __forceinline__ void fwd_load(const FwdArgs& a, int tile) {
  using HT = HeadTile<HD>;
  const int st = tile % FWD_STAGES;
  mbar_expect_tx(&a.bars[1 + st], 2 * HT::BYTES);
  HT::load(a.ring + (2 * st) * HT::BYTES, a.map_k, &a.bars[1 + st], tile * TILE, a.plane);
  HT::load(a.ring + (2 * st + 1) * HT::BYTES, a.map_v, &a.bars[1 + st], tile * TILE, a.plane);
}

// blocks per SM that flash_fwd's registers are budgeted for: the 64 O
// accumulators of head dim 128 leave room for one
template <int HD>
__host__ __device__ constexpr int fwd_blocks_per_sm() {
  return HD == 128 ? 1 : FWD_BLOCKS_PER_SM;
}

// Key tile j: `s` holds its finished S and no product is in flight. Takes
// the softmax of `s` and rescales `o`; then one batch of products, O +=
// P V of tile j and S of tile j + 1 into `s`, after which tile j's slot is
// refilled. Every step issues the same products and waits for all of them
// (wait_group 0), so that ptxas sees which accumulators are in flight and
// keeps the products asynchronous: the last tile recomputes its own S,
// which nobody reads.
// The online softmax of one key tile from key0 on: `s` holds its finished
// S. Masks the gap and the columns >= T, moves the running row maxima m
// (scale_log2 domain) and sums l, rescales the NO output accumulators `o`,
// and leaves p = exp2(s * scale_log2 - m) in `s` and, rounded to bf16, in
// the A fragments `pa`.
template <int NO>
__device__ __forceinline__ void online_softmax(float (&s)[32], float (&o)[NO],
                                               uint32_t (&pa)[4][4], float& m_a, float& m_b,
                                               float& l_a, float& l_b, int key0, int T,
                                               int pad_lo, int pad_hi, int tig,
                                               float scale_log2) {
  if (tile_masked(key0, T, pad_lo, pad_hi)) {
#pragma unroll
    for (int i = 0; i < 32; ++i)
      s[i] = masked_col(key0 + acc_col(i, tig), T, pad_lo, pad_hi) ? -INFINITY : s[i];
  }
  float mx_a = row_max(s, 0), mx_b = row_max(s, 2);
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, off));
    mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, off));
  }
  // the running max in the scale_log2 domain; a row with every column
  // masked so far keeps a zero shift (no inf - inf)
  const float mn_a = fmaxf(m_a, mx_a * scale_log2), mn_b = fmaxf(m_b, mx_b * scale_log2);
  const float sh_a = mn_a == -INFINITY ? 0.f : mn_a;
  const float sh_b = mn_b == -INFINITY ? 0.f : mn_b;
  const float al_a = ex2(m_a - sh_a), al_b = ex2(m_b - sh_b);
  m_a = mn_a;
  m_b = mn_b;
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = ex2(fmaf(s[i], scale_log2, (i & 2) ? -sh_b : -sh_a));
  l_a = l_a * al_a + row_sum(s, 0);
  l_b = l_b * al_b + row_sum(s, 2);
#pragma unroll
  for (int i = 0; i < NO; ++i) o[i] *= (i & 2) ? al_b : al_a;
  acc_to_a(pa, s);
}

// The flash pass's epilogue for the rows r_a, r_a + 8 of a warpgroup: the
// row sums over the quad, out = o / l as bf16 into columns [c0, c0 + 2 NO)
// of rows of `ld` elements from `oh`, and, where `lh` is not null, each
// row's log2-sum-exp.
template <int NO>
__device__ __forceinline__ void fwd_epilogue(const float (&o)[NO], float m_a, float m_b,
                                             float l_a, float l_b, int r_a, int T, bf16* oh,
                                             int ld, int c0, float* lh, int tig) {
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l_a += __shfl_xor_sync(0xffffffffu, l_a, off);
    l_b += __shfl_xor_sync(0xffffffffu, l_b, off);
  }
  l_a = fmaxf(l_a, 1e-30f);
  l_b = fmaxf(l_b, 1e-30f);
  const float inv_a = 1.f / l_a, inv_b = 1.f / l_b;
  const int r_b = r_a + 8;
#pragma unroll
  for (int j = 0; j < NO / 4; ++j) {
    const int c = c0 + j * 8 + tig * 2;
    if (r_a < T)
      *reinterpret_cast<uint32_t*>(oh + (size_t)r_a * ld + c) =
          pack_bf16(o[4 * j] * inv_a, o[4 * j + 1] * inv_a);
    if (r_b < T)
      *reinterpret_cast<uint32_t*>(oh + (size_t)r_b * ld + c) =
          pack_bf16(o[4 * j + 2] * inv_b, o[4 * j + 3] * inv_b);
  }
  if (lh != nullptr && tig == 0) {
    if (r_a < T) lh[r_a] = (m_a == -INFINITY ? 0.f : m_a) + log2f(l_a);
    if (r_b < T) lh[r_b] = (m_b == -INFINITY ? 0.f : m_b) + log2f(l_b);
  }
}

template <int HD>
__device__ __forceinline__ void fwd_step(const FwdArgs& a, float (&s)[32], float (&o)[HD / 2],
                                         uint32_t (&pa)[4][4], float& m_a, float& m_b,
                                         float& l_a, float& l_b, int j) {
  using HT = HeadTile<HD>;
  online_softmax<HD / 2>(s, o, pa, m_a, m_b, l_a, l_b, j * TILE, a.T, a.pad_lo, a.pad_hi, a.tig,
                         a.scale_log2);

  const bool more = j + 1 < a.n;
  if (more) mbar_wait(&a.bars[1 + (j + 1) % FWD_STAGES], ((j + 1) / FWD_STAGES) & 1);
  const uint8_t* k_s = a.ring + (2 * ((more ? j + 1 : j) % FWD_STAGES)) * HT::BYTES;
  const uint8_t* v_s = a.ring + (2 * (j % FWD_STAGES) + 1) * HT::BYTES;
  fence_regs(s);
  fence_regs(o);
  fence_regs(pa);
  wgmma_fence();
#pragma unroll
  for (int kc = 0; kc < 4; ++kc) wgmma_rs<1>(o, pa[kc], HT::mnmajor(v_s, kc), 1);
#pragma unroll
  for (int kc = 0; kc < HT::KSTEPS; ++kc)
    wgmma_ss<0>(s, HT::kmajor(a.q_s, kc), HT::kmajor(k_s, kc), kc);
  wgmma_commit();
  wgmma_wait();
  fence_regs(s);
  fence_regs(o);
  fence_regs(pa);
  __syncthreads();  // both warpgroups are done with tile j's slot
  if (a.tid == 0 && j + FWD_STAGES < a.n) fwd_load<HD>(a, j + FWD_STAGES);
}

template <int HD>
__global__ void __launch_bounds__(FWD_THREADS, fwd_blocks_per_sm<HD>())
flash_fwd(const __grid_constant__ CUtensorMap map_q, const __grid_constant__ CUtensorMap map_k,
          const __grid_constant__ CUtensorMap map_v, bf16* __restrict__ out,
          float* __restrict__ lse2, int H, int T, int pad_lo, int pad_hi, float scale_log2) {
  using HT = HeadTile<HD>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  const int wg = threadIdx.x >> 7;  // this warpgroup's query tile
  FwdArgs a;
  a.q_s = smem + wg * HT::BYTES;
  a.ring = smem + FWD_WARPGROUPS * HT::BYTES;
  a.bars = reinterpret_cast<uint64_t*>(a.ring + 2 * FWD_STAGES * HT::BYTES);
  a.map_k = &map_k;
  a.map_v = &map_v;
  a.plane = blockIdx.z * H + blockIdx.y;
  a.n = (T + TILE - 1) / TILE;
  a.T = T;
  a.pad_lo = pad_lo;
  a.pad_hi = pad_hi;
  a.tid = threadIdx.x;
  a.tig = threadIdx.x & 3;
  a.scale_log2 = scale_log2;
  const int row0 = blockIdx.x * FWD_ROWS;
  if (a.tid == 0) {
    for (int i = 0; i <= FWD_STAGES; ++i) mbar_init(&a.bars[i], 1);
    mbar_init_fence();
    mbar_expect_tx(&a.bars[0], FWD_WARPGROUPS * HT::BYTES);
    for (int w = 0; w < FWD_WARPGROUPS; ++w)
      HT::load(smem + w * HT::BYTES, &map_q, &a.bars[0], row0 + w * TILE, a.plane);
    for (int t = 0; t < FWD_STAGES && t < a.n; ++t) fwd_load<HD>(a, t);
  }
  __syncthreads();

  float sc[32], o[HD / 2];
  uint32_t pa[4][4];
#pragma unroll
  for (int i = 0; i < 32; ++i) sc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;
  float m_a = -INFINITY, m_b = -INFINITY, l_a = 0.f, l_b = 0.f;

  mbar_wait(&a.bars[0], 0);
  mbar_wait(&a.bars[1], 0);
  wgmma_fence();
#pragma unroll
  for (int kc = 0; kc < HT::KSTEPS; ++kc)
    wgmma_ss<0>(sc, HT::kmajor(a.q_s, kc), HT::kmajor(a.ring, kc), kc);
  wgmma_commit();
  wgmma_wait();
  fence_regs(sc);
  for (int j = 0; j < a.n; ++j) fwd_step<HD>(a, sc, o, pa, m_a, m_b, l_a, l_b, j);

  const int r_a = row0 + wg * TILE + ((a.tid >> 5) & 3) * 16 + ((a.tid & 31) >> 2);
  fwd_epilogue<HD / 2>(o, m_a, m_b, l_a, l_b, r_a, T, out + (size_t)a.plane * T * HD, HD, 0,
                       lse2 == nullptr ? nullptr : lse2 + (size_t)a.plane * T, a.tig);
}

// ------------------------------------------------------------- attn_mean

// acc += p = exp2(s * scale_log2 - lse2) of one head's S tile `s` of the
// key tile from key0 on (nl: minus the rows' lse2); 0 at the gap and at
// columns >= T
__device__ __forceinline__ void add_probs(float (&acc)[32], const float (&s)[32], float nl_a,
                                          float nl_b, int key0, int T, int pad_lo, int pad_hi,
                                          int tig, float scale_log2) {
  if (tile_masked(key0, T, pad_lo, pad_hi)) {
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const float x = fmaf(s[i], scale_log2, (i & 2) ? nl_b : nl_a);
      acc[i] += ex2(masked_col(key0 + acc_col(i, tig), T, pad_lo, pad_hi) ? -INFINITY : x);
    }
  } else {
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] += ex2(fmaf(s[i], scale_log2, (i & 2) ? nl_b : nl_a));
  }
}

// the head sum `acc` of rows r_a, r_a + 8 and the key tile from key0 on,
// times inv_h, into this image's (T, T) mean as bf16
__device__ __forceinline__ void store_mean_tile(bf16* mean, const float (&acc)[32], int r_a,
                                                int key0, int T, int tig, float inv_h) {
  const bool even = (T & 1) == 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int col = key0 + j * 8 + tig * 2;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = r_a + 8 * half;
      const float x0 = acc[4 * j + 2 * half] * inv_h, x1 = acc[4 * j + 2 * half + 1] * inv_h;
      bf16* dst = mean + (size_t)r * T + col;
      if (r < T) {
        if (even && col < T) {
          *reinterpret_cast<uint32_t*>(dst) = pack_bf16(x0, x1);
        } else {  // odd T: a row starts at an odd element, store singly
          if (col < T) dst[0] = __float2bfloat16(x0);
          if (col + 1 < T) dst[1] = __float2bfloat16(x1);
        }
      }
    }
  }
}

struct MeanArgs {
  const uint8_t* q_s;  // H query tiles (resident)
  uint8_t* ring;       // MEAN_STAGES slots: K, then (streamed) the unit's query tile
  const float* lse_s;  // [H][TILE] row statistics of the block's rows (resident)
  const float* lse2;   // this image's (H, T) row statistics (streamed)
  uint64_t* bars;      // [0] query tiles, [1 + s] slot s
  const CUtensorMap* map_q;
  const CUtensorMap* map_k;
  bf16* mean;  // this image's (T, T)
  int b, H, kt0, n, row0, row_a, T, pad_lo, pad_hi, tig, tid;
  float scale_log2, inv_h;
};

// bytes of a ring slot: a K tile, and the unit's query tile if streamed
template <int HD, bool RES>
__device__ __forceinline__ constexpr int mean_slot_bytes() {
  return (RES ? 1 : 2) * HeadTile<HD>::BYTES;
}

// unit u: key tile kt0 + u / H of head u % H
template <int HD, bool RES>
__device__ __forceinline__ void mean_load(const MeanArgs& a, int u) {
  constexpr int SLOT = mean_slot_bytes<HD, RES>();
  const int st = u % MEAN_STAGES;
  uint8_t* slot = a.ring + st * SLOT;
  const int plane = a.b * a.H + u % a.H;
  mbar_expect_tx(&a.bars[1 + st], SLOT);
  HeadTile<HD>::load(slot, a.map_k, &a.bars[1 + st], (a.kt0 + u / a.H) * TILE, plane);
  if constexpr (!RES)
    HeadTile<HD>::load(slot + HeadTile<HD>::BYTES, a.map_q, &a.bars[1 + st], a.row0, plane);
}

// S = Q_h K_h^T of unit u, whose slot has arrived, into s (one commit group)
template <int HD, bool RES>
__device__ __forceinline__ void mean_issue_s(const MeanArgs& a, float (&s)[32], int u) {
  using HT = HeadTile<HD>;
  const uint8_t* k_s = a.ring + (u % MEAN_STAGES) * mean_slot_bytes<HD, RES>();
  const uint8_t* q_s = RES ? a.q_s + (u % a.H) * HT::BYTES : k_s + HT::BYTES;
  fence_regs(s);
  wgmma_fence();
#pragma unroll
  for (int kc = 0; kc < HT::KSTEPS; ++kc)
    wgmma_ss<0>(s, HT::kmajor(q_s, kc), HT::kmajor(k_s, kc), kc);
  wgmma_commit();
}

// Unit u: `cur` holds its finished S. Issues the next unit's S into `nxt`,
// adds this unit's probabilities to `acc`, writes the tile after its last
// head, and returns with `nxt` finished. As in fwd_step every step issues
// and waits alike: the last unit recomputes its own S, which nobody reads.
template <int HD, bool RES>
__device__ __forceinline__ void mean_step(const MeanArgs& a, float (&cur)[32], float (&nxt)[32],
                                          float (&acc)[32], int u) {
  const bool more = u + 1 < a.n;
  if (more) mbar_wait(&a.bars[1 + (u + 1) % MEAN_STAGES], ((u + 1) / MEAN_STAGES) & 1);
  mean_issue_s<HD, RES>(a, nxt, more ? u + 1 : u);
  __syncthreads();  // every warp is done with unit u's slot
  if (a.tid == 0 && u + MEAN_STAGES < a.n) mean_load<HD, RES>(a, u + MEAN_STAGES);

  const int h = u % a.H;
  const int key0 = (a.kt0 + u / a.H) * TILE;
  float nl_a, nl_b;
  if constexpr (RES) {
    nl_a = -a.lse_s[h * TILE + a.row_a];
    nl_b = -a.lse_s[h * TILE + a.row_a + 8];
  } else {  // a row past T gets 0 (never stored)
    const int r_a = a.row0 + a.row_a;
    const float* lh = a.lse2 + (size_t)h * a.T;
    nl_a = r_a < a.T ? -lh[r_a] : 0.f;
    nl_b = r_a + 8 < a.T ? -lh[r_a + 8] : 0.f;
  }
  add_probs(acc, cur, nl_a, nl_b, key0, a.T, a.pad_lo, a.pad_hi, a.tig, a.scale_log2);
  if (h == a.H - 1) {  // every head summed: write the tile, start the next
    store_mean_tile(a.mean, acc, a.row0 + a.row_a, key0, a.T, a.tig, a.inv_h);
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] = 0.f;
  }

  wgmma_wait();
  fence_regs(nxt);
}

template <int HD, bool RES>
__global__ void __launch_bounds__(WG_THREADS, MEAN_BLOCKS_PER_SM)
attn_mean(const __grid_constant__ CUtensorMap map_q, const __grid_constant__ CUtensorMap map_k,
          const float* __restrict__ lse2, bf16* __restrict__ mean, int H, int T, int pad_lo,
          int pad_hi, float scale_log2, int chunk) {
  constexpr int TB = HeadTile<HD>::BYTES;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  MeanArgs a;
  a.q_s = smem;
  a.ring = smem + (RES ? H : 0) * TB;
  float* lse_s = reinterpret_cast<float*>(a.ring + MEAN_STAGES * mean_slot_bytes<HD, RES>());
  a.lse_s = lse_s;
  a.bars = reinterpret_cast<uint64_t*>(lse_s + (RES ? H * TILE : 0));
  a.map_q = &map_q;
  a.map_k = &map_k;
  a.b = blockIdx.z;
  a.H = H;
  a.lse2 = lse2 + (size_t)a.b * H * T;
  a.mean = mean + (size_t)a.b * T * T;
  a.kt0 = blockIdx.x * chunk;
  const int ntiles = (T + TILE - 1) / TILE;
  a.n = min(chunk, ntiles - a.kt0) * H;
  a.T = T;
  a.pad_lo = pad_lo;
  a.pad_hi = pad_hi;
  a.tid = threadIdx.x;
  a.tig = threadIdx.x & 3;
  a.row_a = (threadIdx.x >> 5) * 16 + ((threadIdx.x & 31) >> 2);
  a.scale_log2 = scale_log2;
  a.inv_h = 1.f / (float)H;
  const int row0 = blockIdx.y * TILE;
  a.row0 = row0;
  if (a.tid == 0) {
    for (int i = 0; i <= MEAN_STAGES; ++i) mbar_init(&a.bars[i], 1);
    mbar_init_fence();
    if constexpr (RES) {
      mbar_expect_tx(&a.bars[0], H * TB);
      for (int h = 0; h < H; ++h)
        HeadTile<HD>::load(smem + h * TB, &map_q, &a.bars[0], row0, a.b * H + h);
    }
    for (int u = 0; u < MEAN_STAGES && u < a.n; ++u) mean_load<HD, RES>(a, u);
  }
  if constexpr (RES) {
    // the rows' log2-sum-exp per head; a row past T gets 0 (never stored)
    for (int i = a.tid; i < H * TILE; i += WG_THREADS) {
      const int r = row0 + (i & (TILE - 1));
      lse_s[i] = r < T ? lse2[((size_t)a.b * H + i / TILE) * T + r] : 0.f;
    }
  }
  __syncthreads();

  float sa[32], sb[32], acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) sa[i] = sb[i] = acc[i] = 0.f;
  if constexpr (RES) mbar_wait(&a.bars[0], 0);
  mbar_wait(&a.bars[1], 0);
  mean_issue_s<HD, RES>(a, sa, 0);
  wgmma_wait();
  fence_regs(sa);
  for (int u = 0; u < a.n; u += 2) {
    mean_step<HD, RES>(a, sa, sb, acc, u);
    if (u + 1 < a.n) mean_step<HD, RES>(a, sb, sa, acc, u + 1);
  }
}

// ------------------------------------------------------- the wide route
//
// Head dims above 128 (ops/attention.py zero-pads a multiple of 8 above
// 128 to D = 128 * ceil(d / 128)): a head row is NS = D / 128 slabs of 128
// columns, slab c the HeadTile<128> at column 128 c of a tensor map over
// the whole row (two 64-column TMA boxes, 16 KB per 64 rows), so shared
// memory does not grow with D. S = Q K^T accumulates slab by slab, eight
// k16 steps each, into one accumulator. Every product waits for itself:
// the route is simple and right first; it has had no redesign.

// ring slot of flash_fwd_wide: the unit's Q and K slabs, then V's output slab
constexpr int WIDE_FWD_SLOT = 3 * Slab::BYTES;
constexpr size_t wide_fwd_smem() {
  return (size_t)WIDE_STAGES * WIDE_FWD_SLOT + WIDE_STAGES * sizeof(uint64_t) + 1024;
}
// ring slot of attn_mean_wide: the unit's K and Q slabs
constexpr int WIDE_MEAN_SLOT = 2 * Slab::BYTES;
constexpr size_t wide_mean_smem() {
  return (size_t)WIDE_STAGES * WIDE_MEAN_SLOT + WIDE_STAGES * sizeof(uint64_t) + 1024;
}

// flash_fwd_wide's unit u = j * NS + c: slab c of the block's query rows
// and of key tile j, and at c = NS - 1 slab sl of V's key tile j
__device__ __forceinline__ void wide_fwd_load(uint8_t* ring, uint64_t* bars,
                                              const CUtensorMap* map_q, const CUtensorMap* map_k,
                                              const CUtensorMap* map_v, int u, int NS, int sl,
                                              int row0, int plane) {
  const int st = u % WIDE_STAGES, j = u / NS, c = u % NS;
  uint8_t* slot = ring + st * WIDE_FWD_SLOT;
  const bool last = c == NS - 1;
  mbar_expect_tx(&bars[st], (last ? 3 : 2) * Slab::BYTES);
  Slab::load(slot, map_q, &bars[st], row0, plane, c * SLAB_COLS);
  Slab::load(slot + Slab::BYTES, map_k, &bars[st], j * TILE, plane, c * SLAB_COLS);
  if (last) Slab::load(slot + 2 * Slab::BYTES, map_v, &bars[st], j * TILE, plane, sl * SLAB_COLS);
}

// One block = one warpgroup = 64 query rows of one head and output slab sl
// (blockIdx.x = query tile * NS + sl). Per key tile, NS units through a
// WIDE_STAGES-slot ring: S += Q_c K_c^T; after the last, the online softmax
// of flash_fwd and O_sl += P V_sl (m64n128k16). The NS blocks of a query
// tile compute the same S in the same order, so they share the softmax's
// statistics bit for bit; slab 0's block writes lse2.
__global__ void __launch_bounds__(WG_THREADS, WIDE_BLOCKS_PER_SM)
flash_fwd_wide(const __grid_constant__ CUtensorMap map_q, const __grid_constant__ CUtensorMap map_k,
               const __grid_constant__ CUtensorMap map_v, bf16* __restrict__ out,
               float* __restrict__ lse2, int H, int T, int NS, int pad_lo, int pad_hi,
               float scale_log2) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ring = align1024(smem_raw);
  uint64_t* bars = reinterpret_cast<uint64_t*>(ring + WIDE_STAGES * WIDE_FWD_SLOT);
  const int plane = blockIdx.z * H + blockIdx.y;
  const int sl = blockIdx.x % NS;
  const int row0 = blockIdx.x / NS * TILE;
  const int nu = (T + TILE - 1) / TILE * NS;
  const int tid = threadIdx.x, tig = tid & 3;
  if (tid == 0) {
    for (int i = 0; i < WIDE_STAGES; ++i) mbar_init(&bars[i], 1);
    mbar_init_fence();
    for (int u = 0; u < WIDE_STAGES && u < nu; ++u)
      wide_fwd_load(ring, bars, &map_q, &map_k, &map_v, u, NS, sl, row0, plane);
  }
  __syncthreads();

  float s[32], o[64];
  uint32_t pa[4][4];
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 64; ++i) o[i] = 0.f;
  float m_a = -INFINITY, m_b = -INFINITY, l_a = 0.f, l_b = 0.f;
  for (int u = 0; u < nu; ++u) {
    const int st = u % WIDE_STAGES, c = u % NS;
    const uint8_t* slot = ring + st * WIDE_FWD_SLOT;
    mbar_wait(&bars[st], (u / WIDE_STAGES) & 1);
    fence_regs(s);
    wgmma_fence();
#pragma unroll
    for (int kc = 0; kc < Slab::KSTEPS; ++kc)
      wgmma_ss<0>(s, Slab::kmajor(slot, kc), Slab::kmajor(slot + Slab::BYTES, kc), c | kc);
    wgmma_commit();
    wgmma_wait();
    fence_regs(s);
    if (c == NS - 1) {
      online_softmax<64>(s, o, pa, m_a, m_b, l_a, l_b, u / NS * TILE, T, pad_lo, pad_hi, tig,
                         scale_log2);
      fence_regs(o);
      fence_regs(pa);
      wgmma_fence();
#pragma unroll
      for (int kc = 0; kc < 4; ++kc)
        wgmma_rs<1>(o, pa[kc], Slab::mnmajor(slot + 2 * Slab::BYTES, kc), 1);
      wgmma_commit();
      wgmma_wait();
      fence_regs(o);
      fence_regs(pa);
    }
    __syncthreads();  // every warp is done with unit u's slot
    if (tid == 0 && u + WIDE_STAGES < nu)
      wide_fwd_load(ring, bars, &map_q, &map_k, &map_v, u + WIDE_STAGES, NS, sl, row0, plane);
  }
  const int r_a = row0 + (tid >> 5) * 16 + ((tid & 31) >> 2);
  fwd_epilogue<64>(o, m_a, m_b, l_a, l_b, r_a, T, out + (size_t)plane * T * NS * SLAB_COLS,
                   NS * SLAB_COLS, sl * SLAB_COLS,
                   sl == 0 && lse2 != nullptr ? lse2 + (size_t)plane * T : nullptr, tig);
}

// attn_mean_wide's sub-unit w = u * NS + c: slab c of unit u's K tile (key
// tile kt0 + u / H of head u % H) and of its query tile
__device__ __forceinline__ void wide_mean_load(uint8_t* ring, uint64_t* bars,
                                               const CUtensorMap* map_q, const CUtensorMap* map_k,
                                               int w, int NS, int H, int kt0, int row0,
                                               int plane0) {
  const int st = w % WIDE_STAGES, u = w / NS, c = w % NS;
  uint8_t* slot = ring + st * WIDE_MEAN_SLOT;
  mbar_expect_tx(&bars[st], WIDE_MEAN_SLOT);
  Slab::load(slot, map_k, &bars[st], (kt0 + u / H) * TILE, plane0 + u % H, c * SLAB_COLS);
  Slab::load(slot + Slab::BYTES, map_q, &bars[st], row0, plane0 + u % H, c * SLAB_COLS);
}

// The mean pass on the wide route: one block = one warpgroup per (64
// query rows, chunk of key tiles, image) as attn_mean with its query tiles
// streamed, unit u = (key tile kt0 + u / H, head u % H); each unit is NS
// sub-units of one slab each through the ring, S summed over them, then
// the unit's probabilities added over the heads as in attn_mean.
__global__ void __launch_bounds__(WG_THREADS, MEAN_BLOCKS_PER_SM)
attn_mean_wide(const __grid_constant__ CUtensorMap map_q, const __grid_constant__ CUtensorMap map_k,
               const float* __restrict__ lse2, bf16* __restrict__ mean, int H, int T, int NS,
               int pad_lo, int pad_hi, float scale_log2, int chunk) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ring = align1024(smem_raw);
  uint64_t* bars = reinterpret_cast<uint64_t*>(ring + WIDE_STAGES * WIDE_MEAN_SLOT);
  const int b = blockIdx.z;
  const int kt0 = blockIdx.x * chunk;
  const int ntiles = (T + TILE - 1) / TILE;
  const int nw = min(chunk, ntiles - kt0) * H * NS;
  const int row0 = blockIdx.y * TILE;
  const int tid = threadIdx.x, tig = tid & 3;
  const int r_a = row0 + (tid >> 5) * 16 + ((tid & 31) >> 2);
  const float* lb = lse2 + (size_t)b * H * T;
  bf16* mb = mean + (size_t)b * T * T;
  const float inv_h = 1.f / (float)H;
  if (tid == 0) {
    for (int i = 0; i < WIDE_STAGES; ++i) mbar_init(&bars[i], 1);
    mbar_init_fence();
    for (int w = 0; w < WIDE_STAGES && w < nw; ++w)
      wide_mean_load(ring, bars, &map_q, &map_k, w, NS, H, kt0, row0, b * H);
  }
  __syncthreads();

  float s[32], acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = acc[i] = 0.f;
  for (int w = 0; w < nw; ++w) {
    const int st = w % WIDE_STAGES, c = w % NS, u = w / NS;
    const uint8_t* slot = ring + st * WIDE_MEAN_SLOT;
    mbar_wait(&bars[st], (w / WIDE_STAGES) & 1);
    fence_regs(s);
    wgmma_fence();
#pragma unroll
    for (int kc = 0; kc < Slab::KSTEPS; ++kc)
      wgmma_ss<0>(s, Slab::kmajor(slot + Slab::BYTES, kc), Slab::kmajor(slot, kc), c | kc);
    wgmma_commit();
    wgmma_wait();
    fence_regs(s);
    __syncthreads();  // every warp is done with sub-unit w's slot
    if (tid == 0 && w + WIDE_STAGES < nw)
      wide_mean_load(ring, bars, &map_q, &map_k, w + WIDE_STAGES, NS, H, kt0, row0, b * H);
    if (c == NS - 1) {
      const int h = u % H;
      const int key0 = (kt0 + u / H) * TILE;
      const float* lh = lb + (size_t)h * T;  // a row past T gets 0 (never stored)
      const float nl_a = r_a < T ? -lh[r_a] : 0.f;
      const float nl_b = r_a + 8 < T ? -lh[r_a + 8] : 0.f;
      add_probs(acc, s, nl_a, nl_b, key0, T, pad_lo, pad_hi, tig, scale_log2);
      if (h == H - 1) {  // every head summed: write the tile, start the next
        store_mean_tile(mb, acc, r_a, key0, T, tig, inv_h);
#pragma unroll
        for (int i = 0; i < 32; ++i) acc[i] = 0.f;
      }
    }
  }
}

// ------------------------------------------------------- head dim 32
//
// flash_fwd32, flash_fwd32_short and attn_mean32 (see the header comment):
// the d = 32 forward, designed for the exp2 work that bounds it there.

constexpr int KV32 = HeadTile<32>::BYTES;  // one 64-row tile at d = 32: 4 KB
constexpr int PRODUCER_THREADS = 32;  // the producer warp, after the consumers
constexpr int F32_CONSUMERS = 2 * WG_THREADS;
constexpr int F32_THREADS = F32_CONSUMERS + PRODUCER_THREADS;
constexpr int SHORT32_THREADS = WG_THREADS + PRODUCER_THREADS;
constexpr int M32_THREADS = M32_WARPGROUPS * WG_THREADS + PRODUCER_THREADS;
constexpr int SHORT32_SLOT = 3 * KV32;  // flash_fwd32_short's ring slot: Q, K, V of one plane

// The online softmax of one key tile from key0 on at d = 32: online_softmax
// returning the rows' rescale factors
// (al_a, al_b) instead of applying them, so that the caller can rescale O
// once its product in flight has landed.
__device__ __forceinline__ void softmax32(float (&s)[32], uint32_t (&pa)[4][4], float& m_a,
                                          float& m_b, float& l_a, float& l_b, float& al_a,
                                          float& al_b, int key0, int T, int pad_lo, int pad_hi,
                                          int tig, float scale_log2) {
  if (tile_masked(key0, T, pad_lo, pad_hi)) {
#pragma unroll
    for (int i = 0; i < 32; ++i)
      s[i] = masked_col(key0 + acc_col(i, tig), T, pad_lo, pad_hi) ? -INFINITY : s[i];
  }
  float mx_a = row_max(s, 0), mx_b = row_max(s, 2);
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, off));
    mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, off));
  }
  const float mn_a = fmaxf(m_a, mx_a * scale_log2), mn_b = fmaxf(m_b, mx_b * scale_log2);
  const float sh_a = mn_a == -INFINITY ? 0.f : mn_a;
  const float sh_b = mn_b == -INFINITY ? 0.f : mn_b;
  al_a = ex2(m_a - sh_a);
  al_b = ex2(m_b - sh_b);
  m_a = mn_a;
  m_b = mn_b;
#pragma unroll
  for (int i = 0; i < 32; ++i)
    s[i] = ex2(fmaf(s[i], scale_log2, (i & 2) ? -sh_b : -sh_a));
  l_a = l_a * al_a + row_sum(s, 0);
  l_b = l_b * al_b + row_sum(s, 2);
  acc_to_a(pa, s);
}

__device__ __forceinline__ void rescale16(float (&o)[16], float al_a, float al_b) {
#pragma unroll
  for (int i = 0; i < 16; ++i) o[i] *= (i & 2) ? al_b : al_a;
}

struct Fwd32 {
  const uint8_t* q_s;  // this warpgroup's query tile
  uint8_t* ring;       // slot s: K at tile 2s, V at tile 2s + 1
  uint64_t* bars;      // [0] query tiles, [1 + s] slot s arrived, [1 + F32_STAGES + s] slot s free
  const CUtensorMap* map_k;
  const CUtensorMap* map_v;
  int plane, n, T, pad_lo, pad_hi, tig, wg, consumers;
  float scale_log2;
};

__device__ __forceinline__ void fwd32_load(const Fwd32& a, int tile) {
  const int st = tile % F32_STAGES;
  mbar_expect_tx(&a.bars[1 + st], 2 * KV32);
  HeadTile<32>::load(a.ring + 2 * st * KV32, a.map_k, &a.bars[1 + st], tile * TILE, a.plane);
  HeadTile<32>::load(a.ring + (2 * st + 1) * KV32, a.map_v, &a.bars[1 + st], tile * TILE, a.plane);
}

// This warpgroup is done with key tile j's slot (its products on it waited
// for). No block-wide barrier: every consumer thread arrives on the slot's
// "free" barrier, which the producer warp waits on before it refills the
// slot with tile j + F32_STAGES; so one warpgroup never waits for the
// other's softmax, and no consumer issues a load.
__device__ __forceinline__ void fwd32_release(const Fwd32& a, int j) {
  mbar_arrive(&a.bars[1 + F32_STAGES + j % F32_STAGES]);
}

// S = Q K^T of key tile j (its slot has arrived) into s, one commit group
__device__ __forceinline__ void fwd32_issue_s(const Fwd32& a, float (&s)[32], int j) {
  const uint8_t* k_s = a.ring + 2 * (j % F32_STAGES) * KV32;
#pragma unroll
  for (int kc = 0; kc < HeadTile<32>::KSTEPS; ++kc)
    wgmma_ss<0>(s, HeadTile<32>::kmajor(a.q_s, kc), HeadTile<32>::kmajor(k_s, kc), kc);
  wgmma_commit();
}

// O += P V of key tile j, one commit group
__device__ __forceinline__ void fwd32_issue_pv(const Fwd32& a, float (&o)[16],
                                               const uint32_t (&pa)[4][4], int j) {
  const uint8_t* v_s = a.ring + (2 * (j % F32_STAGES) + 1) * KV32;
#pragma unroll
  for (int kc = 0; kc < 4; ++kc) wgmma_rs<1>(o, pa[kc], HeadTile<32>::mnmajor(v_s, kc), 1);
  wgmma_commit();
}

// Key tile j >= 1 with overlap: S of tile j and O += P V of tile j - 1 (P
// in `pv`) issued together; the softmax of tile j
// (into `pn`) runs once S has landed, while the PV product is still in
// flight; then O is rescaled and tile j - 1's slot released.
__device__ __forceinline__ void fwd32_step(const Fwd32& a, float (&s)[32], float (&o)[16],
                                           uint32_t (&pv)[4][4], uint32_t (&pn)[4][4],
                                           float& m_a, float& m_b, float& l_a, float& l_b,
                                           int j) {
  mbar_wait(&a.bars[1 + j % F32_STAGES], (j / F32_STAGES) & 1);
  fence_regs(s);
  fence_regs(o);
  fence_regs(pv);
  wgmma_fence();
  fwd32_issue_s(a, s, j);
  fwd32_issue_pv(a, o, pv, j - 1);
  wgmma_wait_n<1>();
  fence_regs(s);
  float al_a, al_b;
  softmax32(s, pn, m_a, m_b, l_a, l_b, al_a, al_b, j * TILE, a.T, a.pad_lo, a.pad_hi, a.tig,
            a.scale_log2);
  wgmma_wait();
  fence_regs(o);
  fence_regs(pv);
  fence_regs(pn);
  rescale16(o, al_a, al_b);
  fwd32_release(a, j - 1);
}

// the last key tile's O += P V (P in `pa`)
__device__ __forceinline__ void fwd32_last(const Fwd32& a, float (&o)[16], uint32_t (&pa)[4][4]) {
  fence_regs(o);
  fence_regs(pa);
  wgmma_fence();
  fwd32_issue_pv(a, o, pa, a.n - 1);
  wgmma_wait();
  fence_regs(o);
  fence_regs(pa);
}

// flash_fwd32: head dim 32, T > 64. One block = two consumer warpgroups =
// 128 query rows of one plane (a last block whose second query tile lies
// past T runs one), sharing a ring of F32_STAGES K/V slots, and a producer
// warp. The warpgroups never meet after the start: each counts itself out
// of a slot, and the producer warp refills it once both have
// (fwd32_release). Within a warpgroup, the softmax of tile j runs beside the
// PV product of tile j - 1 (F32_OVERLAP; 0: every product waited for before
// the next softmax).
__global__ void __launch_bounds__(F32_THREADS, F32_BLOCKS_PER_SM)
flash_fwd32(const __grid_constant__ CUtensorMap map_q, const __grid_constant__ CUtensorMap map_k,
            const __grid_constant__ CUtensorMap map_v, bf16* __restrict__ out,
            float* __restrict__ lse2, int H, int T, int pad_lo, int pad_hi, float scale_log2) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  Fwd32 a;
  a.wg = threadIdx.x >> 7;
  a.q_s = smem + a.wg * KV32;
  a.ring = smem + 2 * KV32;
  a.bars = reinterpret_cast<uint64_t*>(a.ring + 2 * F32_STAGES * KV32);
  a.map_k = &map_k;
  a.map_v = &map_v;
  a.plane = blockIdx.z * H + blockIdx.y;
  a.n = (T + TILE - 1) / TILE;
  a.T = T;
  a.pad_lo = pad_lo;
  a.pad_hi = pad_hi;
  a.tig = threadIdx.x & 3;
  a.scale_log2 = scale_log2;
  const int row0 = blockIdx.x * 2 * TILE;
  a.consumers = row0 + TILE < T ? 2 : 1;
  if (threadIdx.x == 0) {
    for (int i = 0; i <= F32_STAGES; ++i) mbar_init(&a.bars[i], 1);
    for (int i = 0; i < F32_STAGES; ++i) mbar_init(&a.bars[1 + F32_STAGES + i], a.consumers * WG_THREADS);
    mbar_init_fence();
    mbar_expect_tx(&a.bars[0], a.consumers * KV32);
    for (int w = 0; w < a.consumers; ++w)
      HeadTile<32>::load(smem + w * KV32, &map_q, &a.bars[0], row0 + w * TILE, a.plane);
    for (int t = 0; t < F32_STAGES && t < a.n; ++t) fwd32_load(a, t);
  }
  __syncthreads();
  if (threadIdx.x >= F32_CONSUMERS) {  // the producer warp: tile t once tile t - F32_STAGES is done
    if (threadIdx.x == F32_CONSUMERS)
      for (int t = F32_STAGES; t < a.n; ++t) {
        mbar_wait(&a.bars[1 + F32_STAGES + t % F32_STAGES], (t / F32_STAGES - 1) & 1);
        fwd32_load(a, t);
      }
    return;
  }
  if (a.wg >= a.consumers) return;

  float s[32], o[16];
  uint32_t p0[4][4], p1[4][4];
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 16; ++i) o[i] = 0.f;
  float m_a = -INFINITY, m_b = -INFINITY, l_a = 0.f, l_b = 0.f, al_a, al_b;

  mbar_wait(&a.bars[0], 0);
  mbar_wait(&a.bars[1], 0);
  fence_regs(s);
  wgmma_fence();
  fwd32_issue_s(a, s, 0);
  wgmma_wait();
  fence_regs(s);
  softmax32(s, p0, m_a, m_b, l_a, l_b, al_a, al_b, 0, T, pad_lo, pad_hi, a.tig, scale_log2);
  if (F32_OVERLAP) {
    for (int j = 1;; j += 2) {
      if (j >= a.n) {
        fwd32_last(a, o, p0);
        break;
      }
      fwd32_step(a, s, o, p0, p1, m_a, m_b, l_a, l_b, j);
      if (j + 1 >= a.n) {
        fwd32_last(a, o, p1);
        break;
      }
      fwd32_step(a, s, o, p1, p0, m_a, m_b, l_a, l_b, j + 1);
    }
  } else {  // every product waited for before the next softmax
    for (int j = 0;; ++j) {
      fence_regs(o);
      fence_regs(p0);
      wgmma_fence();
      fwd32_issue_pv(a, o, p0, j);
      wgmma_wait();
      fence_regs(o);
      fence_regs(p0);
      fwd32_release(a, j);
      if (j + 1 >= a.n) break;
      mbar_wait(&a.bars[1 + (j + 1) % F32_STAGES], ((j + 1) / F32_STAGES) & 1);
      fence_regs(s);
      wgmma_fence();
      fwd32_issue_s(a, s, j + 1);
      wgmma_wait();
      fence_regs(s);
      softmax32(s, p0, m_a, m_b, l_a, l_b, al_a, al_b, (j + 1) * TILE, T, pad_lo, pad_hi,
                a.tig, scale_log2);
      rescale16(o, al_a, al_b);
    }
  }
  const int r_a = row0 + a.wg * TILE + ((threadIdx.x >> 5) & 3) * 16 + ((threadIdx.x & 31) >> 2);
  fwd_epilogue<16>(o, m_a, m_b, l_a, l_b, r_a, T, out + (size_t)a.plane * T * 32, 32, 0,
                   lse2 == nullptr ? nullptr : lse2 + (size_t)a.plane * T, a.tig);
}

// flash_fwd32_short's load of plane p's Q, K and V (one tile each) into slot st
__device__ __forceinline__ void short32_load(uint8_t* ring, uint64_t* bars, const CUtensorMap* mq,
                                             const CUtensorMap* mk, const CUtensorMap* mv, int st,
                                             int p) {
  uint8_t* slot = ring + st * SHORT32_SLOT;
  mbar_expect_tx(&bars[st], SHORT32_SLOT);
  HeadTile<32>::load(slot, mq, &bars[st], 0, p);
  HeadTile<32>::load(slot + KV32, mk, &bars[st], 0, p);
  HeadTile<32>::load(slot + 2 * KV32, mv, &bars[st], 0, p);
}

// flash_fwd32_short: head dim 32, T <= 64, where a plane is one query tile
// and one key tile. One block = one warpgroup that walks planes blockIdx.x,
// + gridDim.x, ... (the host launches as many blocks as are resident at
// once, or fewer), so no warpgroup holds a row past T beyond the plane's
// own; the next F32_SHORT_STAGES - 1 planes' Q, K and V are in flight
// through the ring while the current one computes (loaded by the producer
// warp once the warpgroup has freed their slot). Bound by bytes (q, k, v
// and out cross device memory once).
__global__ void __launch_bounds__(SHORT32_THREADS, F32_SHORT_BLOCKS_PER_SM)
flash_fwd32_short(const __grid_constant__ CUtensorMap map_q,
                  const __grid_constant__ CUtensorMap map_k,
                  const __grid_constant__ CUtensorMap map_v, bf16* __restrict__ out,
                  float* __restrict__ lse2, int planes, int T, int pad_lo, int pad_hi,
                  float scale_log2) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ring = align1024(smem_raw);
  // [s] slot s arrived, [F32_SHORT_STAGES + s] slot s free
  uint64_t* bars = reinterpret_cast<uint64_t*>(ring + F32_SHORT_STAGES * SHORT32_SLOT);
  const int tid = threadIdx.x, tig = tid & 3;
  if (tid == 0) {
    for (int i = 0; i < F32_SHORT_STAGES; ++i) mbar_init(&bars[i], 1);
    for (int i = 0; i < F32_SHORT_STAGES; ++i) mbar_init(&bars[F32_SHORT_STAGES + i], WG_THREADS);
    mbar_init_fence();
    for (int i = 0; i < F32_SHORT_STAGES; ++i) {
      const int p = blockIdx.x + i * gridDim.x;
      if (p < planes) short32_load(ring, bars, &map_q, &map_k, &map_v, i, p);
    }
  }
  __syncthreads();
  if (tid >= WG_THREADS) {  // the producer warp: plane i's slot once plane i - stages left it
    if (tid == WG_THREADS)
      for (int i = F32_SHORT_STAGES, p = blockIdx.x + i * gridDim.x; p < planes;
           ++i, p += gridDim.x) {
        const int st = i % F32_SHORT_STAGES;
        mbar_wait(&bars[F32_SHORT_STAGES + st], (i / F32_SHORT_STAGES - 1) & 1);
        short32_load(ring, bars, &map_q, &map_k, &map_v, st, p);
      }
    return;
  }
  const int r_a = (tid >> 5) * 16 + ((tid & 31) >> 2);
  float s[32], o[16];
  uint32_t pa[4][4];
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 16; ++i) o[i] = 0.f;
  for (int i = 0, p = blockIdx.x; p < planes; ++i, p += gridDim.x) {
    const int st = i % F32_SHORT_STAGES;
    const uint8_t* slot = ring + st * SHORT32_SLOT;
    mbar_wait(&bars[st], (i / F32_SHORT_STAGES) & 1);
    fence_regs(s);
    wgmma_fence();
#pragma unroll
    for (int kc = 0; kc < HeadTile<32>::KSTEPS; ++kc)
      wgmma_ss<0>(s, HeadTile<32>::kmajor(slot, kc), HeadTile<32>::kmajor(slot + KV32, kc), kc);
    wgmma_commit();
    wgmma_wait();
    fence_regs(s);
    float m_a = -INFINITY, m_b = -INFINITY, l_a = 0.f, l_b = 0.f, al_a, al_b;
    softmax32(s, pa, m_a, m_b, l_a, l_b, al_a, al_b, 0, T, pad_lo, pad_hi, tig, scale_log2);
    fence_regs(o);
    fence_regs(pa);
    wgmma_fence();
#pragma unroll
    for (int kc = 0; kc < 4; ++kc)
      wgmma_rs<1>(o, pa[kc], HeadTile<32>::mnmajor(slot + 2 * KV32, kc), kc);
    wgmma_commit();
    wgmma_wait();
    fence_regs(o);
    fence_regs(pa);
    mbar_arrive(&bars[F32_SHORT_STAGES + st]);  // this thread is done with the slot
    fwd_epilogue<16>(o, m_a, m_b, l_a, l_b, r_a, T, out + (size_t)p * T * 32, 32, 0,
                     lse2 == nullptr ? nullptr : lse2 + (size_t)p * T, tig);
  }
}

struct Mean32 {
  const uint8_t* q_s;  // H query tiles (resident)
  uint8_t* ring;       // this warpgroup's M32_STAGES slots: K, then (streamed) the unit's query tile
  const float* lse_s;  // [H][TILE] row statistics of the block's rows (resident)
  const float* lse2;   // this image's (H, T) row statistics (streamed)
  uint64_t* bars;      // this warpgroup's [s] slot s arrived, [M32_STAGES + s] slot s free
  const CUtensorMap* map_q;
  const CUtensorMap* map_k;
  bf16* mean;  // this image's (T, T)
  int b, H, kt0, n, row0, row_a, T, pad_lo, pad_hi, tig;
  float scale_log2, inv_h;
};

template <bool RES>
__device__ __forceinline__ constexpr int mean32_slot_bytes() {
  return (RES ? 1 : 2) * KV32;
}

// unit u of this warpgroup: its key tile kt0 + (u / H) * M32_WARPGROUPS of head u % H
template <bool RES>
__device__ __forceinline__ int mean32_key_tile(const Mean32& a, int u) {
  return a.kt0 + (u / a.H) * M32_WARPGROUPS;
}

template <bool RES>
__device__ __forceinline__ void mean32_load(const Mean32& a, int u) {
  constexpr int SLOT = mean32_slot_bytes<RES>();
  const int st = u % M32_STAGES;
  uint8_t* slot = a.ring + st * SLOT;
  const int plane = a.b * a.H + u % a.H;
  mbar_expect_tx(&a.bars[st], SLOT);
  HeadTile<32>::load(slot, a.map_k, &a.bars[st], mean32_key_tile<RES>(a, u) * TILE, plane);
  if constexpr (!RES) HeadTile<32>::load(slot + KV32, a.map_q, &a.bars[st], a.row0, plane);
}

template <bool RES>
__device__ __forceinline__ void mean32_issue_s(const Mean32& a, float (&s)[32], int u) {
  const uint8_t* k_s = a.ring + (u % M32_STAGES) * mean32_slot_bytes<RES>();
  const uint8_t* q_s = RES ? a.q_s + (u % a.H) * KV32 : k_s + KV32;
  fence_regs(s);
  wgmma_fence();
#pragma unroll
  for (int kc = 0; kc < HeadTile<32>::KSTEPS; ++kc)
    wgmma_ss<0>(s, HeadTile<32>::kmajor(q_s, kc), HeadTile<32>::kmajor(k_s, kc), kc);
  wgmma_commit();
}

// unit u's probabilities (S in `s`) added to the head sum `acc`; after the
// last head the tile is written and `acc` starts again
template <bool RES>
__device__ __forceinline__ void mean32_probs(const Mean32& a, const float (&s)[32],
                                             float (&acc)[32], int u) {
  const int h = u % a.H;
  const int key0 = mean32_key_tile<RES>(a, u) * TILE;
  float nl_a, nl_b;
  if constexpr (RES) {
    nl_a = -a.lse_s[h * TILE + a.row_a];
    nl_b = -a.lse_s[h * TILE + a.row_a + 8];
  } else {  // a row past T gets 0 (never stored)
    const int r_a = a.row0 + a.row_a;
    const float* lh = a.lse2 + (size_t)h * a.T;
    nl_a = r_a < a.T ? -lh[r_a] : 0.f;
    nl_b = r_a + 8 < a.T ? -lh[r_a + 8] : 0.f;
  }
  add_probs(acc, s, nl_a, nl_b, key0, a.T, a.pad_lo, a.pad_hi, a.tig, a.scale_log2);
  if (h == a.H - 1) {  // every head summed: write the tile, start the next
    store_mean_tile(a.mean, acc, a.row0 + a.row_a, key0, a.T, a.tig, a.inv_h);
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] = 0.f;
  }
}

// this warpgroup is done with unit u's slot: its producer lane may refill it
template <bool RES>
__device__ __forceinline__ void mean32_release(const Mean32& a, int u) {
  mbar_arrive(&a.bars[M32_STAGES + u % M32_STAGES]);
}

// attn_mean32: the mean pass at head dim 32. One block = M32_WARPGROUPS
// warpgroups per (64 query rows, chunk of key tiles, image) and a producer
// warp; warpgroup w takes the chunk's key tiles w, w + M32_WARPGROUPS, ...
// and every head of each, through a ring of M32_STAGES K slots of its own
// that producer lane w refills, so more warps share one set of resident
// query tiles (H x 4 KB) and row statistics, and each K load has
// M32_STAGES - 1 units of exp work to arrive in. With one S accumulator
// a warpgroup waits for each unit's product, and the other warpgroups' exp
// work runs meanwhile. Streamed above MEAN_RESIDENT_BYTES
// as attn_mean. Every output tile is written once, by the warpgroup that
// owns its key tile.
template <bool RES>
__global__ void __launch_bounds__(M32_THREADS, M32_BLOCKS_PER_SM)
attn_mean32(const __grid_constant__ CUtensorMap map_q, const __grid_constant__ CUtensorMap map_k,
            const float* __restrict__ lse2, bf16* __restrict__ mean, int H, int T, int pad_lo,
            int pad_hi, float scale_log2, int chunk) {
  constexpr int SLOT = mean32_slot_bytes<RES>();
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  const bool producer = threadIdx.x >= M32_WARPGROUPS * WG_THREADS;
  // a consumer's warpgroup; lane w of the producer warp loads warpgroup w's units
  const int wg = producer ? (threadIdx.x & 31) : threadIdx.x >> 7;
  const int tid = threadIdx.x & (WG_THREADS - 1);
  uint8_t* rings = smem + (RES ? H : 0) * KV32;
  float* lse_s = reinterpret_cast<float*>(rings + M32_WARPGROUPS * M32_STAGES * SLOT);
  // [0] query tiles, then per warpgroup w [1 + 2 w M32_STAGES + s] slot s arrived and
  // [1 + (2 w + 1) M32_STAGES + s] slot s free
  uint64_t* bars = reinterpret_cast<uint64_t*>(lse_s + (RES ? H * TILE : 0));
  Mean32 a;
  a.q_s = smem;
  a.ring = rings + wg * M32_STAGES * SLOT;
  a.lse_s = lse_s;
  a.bars = bars + 1 + 2 * wg * M32_STAGES;
  a.map_q = &map_q;
  a.map_k = &map_k;
  a.b = blockIdx.z;
  a.H = H;
  a.lse2 = lse2 + (size_t)a.b * H * T;
  a.mean = mean + (size_t)a.b * T * T;
  const int ntiles = (T + TILE - 1) / TILE;
  const int c0 = blockIdx.x * chunk, cn = min(chunk, ntiles - c0);
  a.kt0 = c0 + wg;
  a.n = (wg < cn ? (cn - wg + M32_WARPGROUPS - 1) / M32_WARPGROUPS : 0) * H;
  a.T = T;
  a.pad_lo = pad_lo;
  a.pad_hi = pad_hi;
  a.tig = tid & 3;
  a.row_a = (tid >> 5) * 16 + ((tid & 31) >> 2);
  a.scale_log2 = scale_log2;
  a.inv_h = 1.f / (float)H;
  const int row0 = blockIdx.y * TILE;
  a.row0 = row0;
  if (threadIdx.x == 0) {
    mbar_init(&bars[0], 1);
    for (int w = 0; w < M32_WARPGROUPS; ++w)
      for (int i = 0; i < M32_STAGES; ++i) {
        mbar_init(&bars[1 + 2 * w * M32_STAGES + i], 1);
        mbar_init(&bars[1 + (2 * w + 1) * M32_STAGES + i], WG_THREADS);
      }
    mbar_init_fence();
    if constexpr (RES) {
      mbar_expect_tx(&bars[0], H * KV32);
      for (int h = 0; h < H; ++h)
        HeadTile<32>::load(smem + h * KV32, &map_q, &bars[0], row0, a.b * H + h);
    }
  }
  if constexpr (RES) {
    // the rows' log2-sum-exp per head; a row past T gets 0 (never stored)
    for (int i = threadIdx.x; i < H * TILE; i += M32_THREADS) {
      const int r = row0 + (i & (TILE - 1));
      lse_s[i] = r < T ? lse2[((size_t)a.b * H + i / TILE) * T + r] : 0.f;
    }
  }
  __syncthreads();  // barriers initialised, statistics in place
  if (producer) {  // lane w: unit u of warpgroup w once unit u - M32_STAGES has left its slot
    if (wg < M32_WARPGROUPS)
      for (int u = 0; u < a.n; ++u) {
        if (u >= M32_STAGES)
          mbar_wait(&a.bars[M32_STAGES + u % M32_STAGES], (u / M32_STAGES - 1) & 1);
        mean32_load<RES>(a, u);
      }
    return;
  }
  if (a.n == 0) return;

  float acc[32], s[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = s[i] = 0.f;
  if constexpr (RES) mbar_wait(&bars[0], 0);
  // one S accumulator: each unit's product waited for before its exp work
  for (int u = 0; u < a.n; ++u) {
    mbar_wait(&a.bars[u % M32_STAGES], (u / M32_STAGES) & 1);
    mean32_issue_s<RES>(a, s, u);
    wgmma_wait();
    fence_regs(s);
    mean32_release<RES>(a, u);
    mean32_probs<RES>(a, s, acc, u);
  }
}

// Key tiles per attn_mean block: the grid runs in waves of `slots`
// resident blocks, and a block costs its chunk plus about half a tile's
// worth for loading the H query tiles. Short chunks keep the last wave
// short; ties go to the shorter chunk.
int mean_chunk(int ntiles, int row_blocks, int slots) {
  int best = 1;
  long best_cost = -1;
  for (int c = 1; c <= ntiles && c <= MEAN_MAX_CHUNK; ++c) {
    const long blocks = (long)row_blocks * ((ntiles + c - 1) / c);
    const long cost = (blocks + slots - 1) / slots * (2 * c + 1);
    if (best_cost < 0 || cost < best_cost) {
      best = c;
      best_cost = cost;
    }
  }
  return best;
}

// Resident blocks of attn_mean instance `kern` (one of five: head dim 64 or
// 128 x resident, and the wide route's) on the current device for `smem` bytes
// of shared memory per block: SMs x blocks per SM. The device is asked
// once per (instance, smem), kept as smem << 20 | slots.
cudaError_t mean_slots(const void* kern, int instance, int smem, int* slots) {
  constexpr int MAX_DEVICES = 64;
  static std::atomic<long long> known[MAX_DEVICES][5];
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < MAX_DEVICES) {
    const long long k = known[dev][instance].load(std::memory_order_relaxed);
    if (k > 0 && (k >> 20) == smem) {
      *slots = (int)(k & ((1 << 20) - 1));
      return cudaSuccess;
    }
  }
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, WG_THREADS, smem)) !=
      cudaSuccess)
    return err;
  *slots = sms * (per_sm > 0 ? per_sm : 1);
  if (dev < MAX_DEVICES)
    known[dev][instance].store(((long long)smem << 20) | *slots, std::memory_order_relaxed);
  return cudaSuccess;
}

int aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

template <int HD>
int flash_forward(const void* q, const void* k, const void* v, void* out, void* lse2, int B,
                  int H, int T, int pad_lo, int pad_hi, float scale_log2, cudaStream_t stream) {
  using HT = HeadTile<HD>;
  constexpr int smem = (int)fwd_smem<HD>();
  // a runtime call first: it makes the device's context current on this
  // thread (the autograd engine's, under checkpointing), which the
  // tensor-map encoding needs
  cudaError_t err =
      cudaFuncSetAttribute(flash_fwd<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess)  // the SM's 228 KB as shared memory: two blocks of 81 KB fit (d = 64)
    err = cudaFuncSetAttribute(flash_fwd<HD>, cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return (int)err;
  CUtensorMap mq, mk, mv;
  if (int bad = HT::map(&mq, q, B * H, T)) return bad;
  if (int bad = HT::map(&mk, k, B * H, T)) return bad;
  if (int bad = HT::map(&mv, v, B * H, T)) return bad;
  if (!aligned16(out)) return TMA_MISALIGNED;
  dim3 grid((T + FWD_ROWS - 1) / FWD_ROWS, H, B);
  flash_fwd<HD><<<grid, FWD_THREADS, smem, stream>>>(mq, mk, mv, (bf16*)out, (float*)lse2, H, T,
                                                      pad_lo, pad_hi, scale_log2);
  return (int)cudaGetLastError();
}

template <int HD, bool RES>
int mean_forward(const void* q, const void* k, const void* lse2, void* mean, int B, int H, int T,
                 int pad_lo, int pad_hi, float scale_log2, cudaStream_t stream) {
  using HT = HeadTile<HD>;
  const int smem = (int)mean_smem<HD>(H, RES);
  const void* kern = (const void*)attn_mean<HD, RES>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kern, cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return (int)err;
  CUtensorMap mq, mk;
  if (int bad = HT::map(&mq, q, B * H, T)) return bad;
  if (int bad = HT::map(&mk, k, B * H, T)) return bad;
  if (!aligned16(mean)) return TMA_MISALIGNED;
  int slots = 0;
  if ((err = mean_slots(kern, (HD == 128 ? 2 : 0) + (RES ? 1 : 0), smem, &slots)) != cudaSuccess)
    return (int)err;
  const int ntiles = (T + TILE - 1) / TILE;
  const int chunk = mean_chunk(ntiles, B * ntiles, slots);
  dim3 grid((ntiles + chunk - 1) / chunk, ntiles, B);
  attn_mean<HD, RES><<<grid, WG_THREADS, smem, stream>>>(
      mq, mk, (const float*)lse2, (bf16*)mean, H, T, pad_lo, pad_hi, scale_log2, chunk);
  return (int)cudaGetLastError();
}

// the wide route's flash pass: D = 128 NS, grid (query tiles x NS, H, B)
int flash_forward_wide(const void* q, const void* k, const void* v, void* out, void* lse2, int B,
                       int H, int T, int D, int pad_lo, int pad_hi, float scale_log2,
                       cudaStream_t stream) {
  constexpr int smem = (int)wide_fwd_smem();
  // a runtime call first: it makes the device's context current on this
  // thread, which the tensor-map encoding needs
  cudaError_t err =
      cudaFuncSetAttribute(flash_fwd_wide, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(flash_fwd_wide, cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return (int)err;
  CUtensorMap mq, mk, mv;
  if (int bad = Slab::map(&mq, q, B * H, T, D)) return bad;
  if (int bad = Slab::map(&mk, k, B * H, T, D)) return bad;
  if (int bad = Slab::map(&mv, v, B * H, T, D)) return bad;
  if (!aligned16(out)) return TMA_MISALIGNED;
  const int NS = D / SLAB_COLS;
  dim3 grid((T + TILE - 1) / TILE * NS, H, B);
  flash_fwd_wide<<<grid, WG_THREADS, smem, stream>>>(mq, mk, mv, (bf16*)out, (float*)lse2, H, T,
                                                     NS, pad_lo, pad_hi, scale_log2);
  return (int)cudaGetLastError();
}

// the wide route's mean pass, query tiles streamed: grid (key chunks,
// query tiles, B) as mean_forward
int mean_forward_wide(const void* q, const void* k, const void* lse2, void* mean, int B, int H,
                      int T, int D, int pad_lo, int pad_hi, float scale_log2,
                      cudaStream_t stream) {
  constexpr int smem = (int)wide_mean_smem();
  const void* kern = (const void*)attn_mean_wide;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kern, cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return (int)err;
  CUtensorMap mq, mk;
  if (int bad = Slab::map(&mq, q, B * H, T, D)) return bad;
  if (int bad = Slab::map(&mk, k, B * H, T, D)) return bad;
  if (!aligned16(mean)) return TMA_MISALIGNED;
  int slots = 0;
  if ((err = mean_slots(kern, 4, smem, &slots)) != cudaSuccess) return (int)err;
  const int ntiles = (T + TILE - 1) / TILE;
  const int chunk = mean_chunk(ntiles, B * ntiles, slots);
  dim3 grid((ntiles + chunk - 1) / chunk, ntiles, B);
  attn_mean_wide<<<grid, WG_THREADS, smem, stream>>>(mq, mk, (const float*)lse2, (bf16*)mean, H,
                                                     T, D / SLAB_COLS, pad_lo, pad_hi,
                                                     scale_log2, chunk);
  return (int)cudaGetLastError();
}

// ------------------------------------------------------- head dim 32, host
//
// The plan of a d = 32 forward (mirrored in ops/attention.py, d32_plan):
// which flash kernel, its grid and shared memory; the mean pass's
// resident or streamed query tiles, chunk of key tiles and shared memory;
// and the blocks per SM the device reports for each.

constexpr size_t fwd32_smem() {
  return (size_t)(2 + 2 * F32_STAGES) * KV32 + (1 + 2 * F32_STAGES) * sizeof(uint64_t) + 1024;
}
constexpr size_t short32_smem() {
  return (size_t)F32_SHORT_STAGES * SHORT32_SLOT + 2 * F32_SHORT_STAGES * sizeof(uint64_t) + 1024;
}
size_t mean32_smem(int H, bool resident) {
  const size_t ring = (size_t)M32_WARPGROUPS * M32_STAGES * (resident ? 1 : 2) * KV32;
  return (resident ? (size_t)H * KV32 + (size_t)H * TILE * sizeof(float) : 0) + ring +
         (1 + 2 * M32_WARPGROUPS * M32_STAGES) * sizeof(uint64_t) + 1024;
}
constexpr size_t SMEM_LIMIT = 232448;  // what a block may use (227 KB)

bool mean32_resident(int H) {
  return (long)H * KV32 <= (long)MEAN_RESIDENT_BYTES && mean32_smem(H, true) <= SMEM_LIMIT;
}

// Key tiles per attn_mean32 block: mean_chunk's rule, a block's time now
// ceil(c / M32_WARPGROUPS) key tiles (its warpgroups take them side by side)
int mean32_chunk(int ntiles, int row_blocks, int slots) {
  int best = 1;
  long best_cost = -1;
  for (int c = 1; c <= ntiles && c <= MEAN_MAX_CHUNK; ++c) {
    const long blocks = (long)row_blocks * ((ntiles + c - 1) / c);
    const long cost =
        (blocks + slots - 1) / slots * (2 * ((c + M32_WARPGROUPS - 1) / M32_WARPGROUPS) + 1);
    if (best_cost < 0 || cost < best_cost) {
      best = c;
      best_cost = cost;
    }
  }
  return best;
}

// the four d = 32 kernels the plan chooses from
enum { K32_FLASH = 0, K32_SHORT = 1, K32_MEAN_RES = 2, K32_MEAN_STREAM = 3 };

const void* kernel32(int which) {
  switch (which) {
    case K32_FLASH: return (const void*)flash_fwd32;
    case K32_SHORT: return (const void*)flash_fwd32_short;
    case K32_MEAN_RES: return (const void*)attn_mean32<true>;
    default: return (const void*)attn_mean32<false>;
  }
}
int threads32(int which) {
  return which == K32_FLASH ? F32_THREADS : which == K32_SHORT ? SHORT32_THREADS : M32_THREADS;
}

// The device's SMs and kernel `which`'s resident blocks per SM at `smem`
// bytes (after raising its shared-memory limit to them); asked once per
// (device, kernel, smem), kept as smem << 20 | per_sm.
cudaError_t occupancy32(int which, int smem, int* sms, int* per_sm) {
  constexpr int MAX_DEVICES = 64;
  static std::atomic<long long> known[MAX_DEVICES][4];
  static std::atomic<int> known_sms[MAX_DEVICES];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const void* kern = kernel32(which);
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
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, kern, threads32(which),
                                                           smem)) != cudaSuccess)
    return err;
  if (*per_sm < 1) *per_sm = 1;
  if (dev < MAX_DEVICES) {
    known_sms[dev].store(*sms, std::memory_order_relaxed);
    known[dev][which].store(((long long)smem << 20) | *per_sm, std::memory_order_relaxed);
  }
  return cudaSuccess;
}

// plan[0] flash kernel (K32_FLASH or K32_SHORT), [1] its blocks (grid x;
// flash_fwd32's grid is (plan[1], H, B)), [2] its blocks per SM, [3] its
// shared memory; [4] the mean pass's kernel (K32_MEAN_RES or
// K32_MEAN_STREAM), [5] its chunk of key tiles, [6] its key chunks (grid
// x of (plan[6], query tiles, B)), [7] its blocks per SM, [8] its shared
// memory; [9] the SMs. Fills the flash part ([0-3], `flash`) or the mean
// part ([4-8]), and [9].
cudaError_t plan32(int B, int H, int T, bool flash, int* plan) {
  if (flash) {
    const bool short_route = F32_SHORT && T <= TILE;
    plan[0] = short_route ? K32_SHORT : K32_FLASH;
    plan[3] = (int)(short_route ? short32_smem() : fwd32_smem());
    cudaError_t err = occupancy32(plan[0], plan[3], &plan[9], &plan[2]);
    if (err != cudaSuccess) return err;
    const int slots = plan[9] * plan[2];
    plan[1] = short_route ? (B * H < slots ? B * H : slots) : (T + 2 * TILE - 1) / (2 * TILE);
    return cudaSuccess;
  }
  const bool res = mean32_resident(H);
  const int ntiles = (T + TILE - 1) / TILE;
  plan[4] = res ? K32_MEAN_RES : K32_MEAN_STREAM;
  plan[8] = (int)mean32_smem(H, res);
  cudaError_t err = occupancy32(plan[4], plan[8], &plan[9], &plan[7]);
  if (err != cudaSuccess) return err;
  plan[5] = mean32_chunk(ntiles, B * ntiles, plan[9] * plan[7]);
  plan[6] = (ntiles + plan[5] - 1) / plan[5];
  return cudaSuccess;
}

int flash_forward32(const void* q, const void* k, const void* v, void* out, void* lse2, int B,
                    int H, int T, int pad_lo, int pad_hi, float scale_log2, cudaStream_t stream) {
  int plan[10];
  // a runtime call first (in occupancy32): it makes the device's context
  // current on this thread, which the tensor-map encoding needs
  cudaError_t err = plan32(B, H, T, true, plan);
  if (err != cudaSuccess) return (int)err;
  CUtensorMap mq, mk, mv;
  if (int bad = HeadTile<32>::map(&mq, q, B * H, T)) return bad;
  if (int bad = HeadTile<32>::map(&mk, k, B * H, T)) return bad;
  if (int bad = HeadTile<32>::map(&mv, v, B * H, T)) return bad;
  if (!aligned16(out)) return TMA_MISALIGNED;
  if (plan[0] == K32_SHORT)
    flash_fwd32_short<<<plan[1], SHORT32_THREADS, plan[3], stream>>>(
        mq, mk, mv, (bf16*)out, (float*)lse2, B * H, T, pad_lo, pad_hi, scale_log2);
  else
    flash_fwd32<<<dim3(plan[1], H, B), F32_THREADS, plan[3], stream>>>(
        mq, mk, mv, (bf16*)out, (float*)lse2, H, T, pad_lo, pad_hi, scale_log2);
  return (int)cudaGetLastError();
}

int mean_forward32(const void* q, const void* k, const void* lse2, void* mean, int B, int H, int T,
                   int pad_lo, int pad_hi, float scale_log2, cudaStream_t stream) {
  int plan[10];
  cudaError_t err = plan32(B, H, T, false, plan);
  if (err != cudaSuccess) return (int)err;
  CUtensorMap mq, mk;
  if (int bad = HeadTile<32>::map(&mq, q, B * H, T)) return bad;
  if (int bad = HeadTile<32>::map(&mk, k, B * H, T)) return bad;
  if (!aligned16(mean)) return TMA_MISALIGNED;
  const dim3 grid(plan[6], (T + TILE - 1) / TILE, B);
  const int threads = M32_THREADS;
  if (plan[4] == K32_MEAN_RES)
    attn_mean32<true><<<grid, threads, plan[8], stream>>>(
        mq, mk, (const float*)lse2, (bf16*)mean, H, T, pad_lo, pad_hi, scale_log2, plan[5]);
  else
    attn_mean32<false><<<grid, threads, plan[8], stream>>>(
        mq, mk, (const float*)lse2, (bf16*)mean, H, T, pad_lo, pad_hi, scale_log2, plan[5]);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// q, k, v, out: (B, H, T, D) bf16 contiguous, 16-byte aligned, D = 64, 32,
// 128 or a multiple of 128 above it (the wide route; cudaErrorInvalidValue
// otherwise). lse2: (B, H, T) f32 or null. Returns a cudaError_t, or a code
// of encode_plane_map (>= 998) when a tensor map cannot be made.
int attn_flash_forward(const void* q, const void* k, const void* v, void* out, void* lse2,
                       int B, int H, int T, int D, int pad_lo, int pad_hi, float scale_log2,
                       void* stream) {
  if (D == 64)
    return flash_forward<64>(q, k, v, out, lse2, B, H, T, pad_lo, pad_hi, scale_log2,
                             (cudaStream_t)stream);
  if (D == 32)
    return flash_forward32(q, k, v, out, lse2, B, H, T, pad_lo, pad_hi, scale_log2,
                           (cudaStream_t)stream);
  if (D == 128)
    return flash_forward<128>(q, k, v, out, lse2, B, H, T, pad_lo, pad_hi, scale_log2,
                              (cudaStream_t)stream);
  if (wide_head_dim(D))
    return flash_forward_wide(q, k, v, out, lse2, B, H, T, D, pad_lo, pad_hi, scale_log2,
                              (cudaStream_t)stream);
  return (int)cudaErrorInvalidValue;
}

// The most heads whose query tiles attn_mean_forward keeps at head dim D;
// above it they are streamed (no limit). The wide route keeps none.
int attn_mean_resident_heads(int D) {
  return wide_head_dim(D) ? 0 : (int)(MEAN_RESIDENT_BYTES / tile_bytes(D));
}

// mean: (B, T, T) bf16, 16-byte aligned; lse2 from attn_flash_forward on
// the same q, k; any H >= 1, D as attn_flash_forward takes it. Returns as
// attn_flash_forward.
int attn_mean_forward(const void* q, const void* k, const void* lse2, void* mean, int B, int H,
                      int T, int D, int pad_lo, int pad_hi, float scale_log2, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (H >= 1 && wide_head_dim(D))
    return mean_forward_wide(q, k, lse2, mean, B, H, T, D, pad_lo, pad_hi, scale_log2, st);
  if (H < 1 || (D != 64 && D != 32 && D != 128)) return (int)cudaErrorInvalidValue;
  const bool res = mean_resident(H, D);
  if (D == 64)
    return res ? mean_forward<64, true>(q, k, lse2, mean, B, H, T, pad_lo, pad_hi, scale_log2, st)
               : mean_forward<64, false>(q, k, lse2, mean, B, H, T, pad_lo, pad_hi, scale_log2, st);
  if (D == 128)
    return res ? mean_forward<128, true>(q, k, lse2, mean, B, H, T, pad_lo, pad_hi, scale_log2, st)
               : mean_forward<128, false>(q, k, lse2, mean, B, H, T, pad_lo, pad_hi, scale_log2,
                                          st);
  return mean_forward32(q, k, lse2, mean, B, H, T, pad_lo, pad_hi, scale_log2, st);
}

// The plan of a d = 32 forward at (B, H, T) into plan[10] (plan32: kernels,
// grids, blocks per SM, shared memory, SMs). Returns a cudaError_t.
int attn_d32_plan(int B, int H, int T, int* plan) {
  cudaError_t err = plan32(B, H, T, true, plan);
  return (int)(err != cudaSuccess ? err : plan32(B, H, T, false, plan));
}

}  // extern "C"
