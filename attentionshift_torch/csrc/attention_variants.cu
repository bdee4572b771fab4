// Design variants of the capture-attention forward (bf16, head dim 32, 64 or
// 128: every kernel is a template on the head dim, HeadTile<HD> of
// hopper.cuh; ops/attention_variants.py zero-pads any other width up to 128
// onto the smallest instance at least as wide, with the true d's scale, and
// any width above 128 to a multiple of 128 for the wide route at the end of
// this file).
//
// Replaces the five Pallas TPU kernels of the attention microbenchmark,
// tools/analysis/microbench_attention.py:
//   kern  (:148, via v2 :171)  v2-bf16e     q pre-scaled by d^-0.5*log2(e) in
//                                           bf16, e = exp2(min(logit, 100))
//                                           rounded to bf16, row sum of the
//                                           bf16 e on the vector unit, PV from
//                                           the bf16 e and divided afterwards;
//   kern3 (:201, via v3 :224)  v3-nomin     v2 without the min(., 100) clamp;
//   kern4 (:255, via v4 :282)  v4-mxsum     v2 with the row sum as a matrix
//                                           product e @ ones(T, 8);
//   kern5 (:317, via v5 :337)  v5-batched   v2 with all heads at once instead
//                                           of a head loop, the mean divided by
//                                           H once after the sum over heads;
//   kern6 (:371, via v6 :393)  v6-fusedsum  v2 with the row sum folded into PV:
//                                           V carries 8 all-ones columns and
//                                           the denominator is column 64.
// All five return out (B, H, T, d) and the head-averaged probabilities
// (B, T, T) = sum_h e_h * recip_h / H, recip = 1 / max(rowsum, 1e-30), with
// the TPU kernels' constant-shift softmax: no row maximum, logits in the
// log2 domain shifted by -20.
//
// What bounds them on the H100. At the tool's shape (B=1, H=6, T=4301) one
// call is 4*H*T^2*d = 28.4 GFLOP (30.2 with v6's 72 columns) against 13 MB of
// q/k/v/out and the 37 MB mean: the tensor cores bound it (29 us at 989
// TFLOP/s; the mean's write is 11 us at 3.35 TB/s). Each e is an exp2, H*T^2
// = 111 M per pass: 27 us per pass at 16 per clock per SM (1980 MHz, 132
// SMs), so two passes over e cost 53 us of MUFU work that has to run beside
// the products.
//
// v2, v3, v4, v6: the Hopper design (helpers in hopper.cuh), two kernels
// per call as the shipped capture pair of attention.cu. Tiles are 64 rows,
// loaded by TMA from 3-D (B*H, T, 64) tensor maps under the 128-byte
// swizzle with mbarrier completion; every product is a wgmma with f32
// accumulators.
//   out pass    (attn_v2_bf16e, attn_v3_nomin, attn_v4_mxsum,
//               attn_v6_fusedsum) one block = two warpgroups = 128 query
//               rows of one (image, head), VAR_BLOCKS_PER_SM blocks per SM
//               (204 blocks at the tool's shape: one wave; one block per
//               SM at head dim 128, whose 64 O accumulators a thread and
//               16 KB tiles leave room for no second). Both
//               warpgroups read each K and V tile of a VAR_STAGES-slot ring,
//               refilled by thread 0 once both are done with a slot. Per key
//               tile: S = Q K^T (wgmma m64n64k16 from shared memory), e
//               rounded to bf16 into register A fragments, then one batch of
//               O += e V (wgmma from registers, V read MN-major through the
//               descriptor's transpose bit, so no transposed copy of V
//               exists) and the next tile's S. The constant shift needs no
//               running maximum, so O only adds: no rescale.
//                 v2 adds the bf16 e into two f32 row sums per thread and
//                 reduces them over the four threads of a row once, at the
//                 end; v3 is v2 with e = exp2(s - 20), no min(., 100) (the
//                 CLAMPED template flag of both passes);
//                 v4 issues one more wgmma per k16 step, m64n8k16 with the e
//                 fragments as A and a 1 KB slot of bf16 1.0 as B (ones read
//                 as ones under any swizzle): every column of that
//                 accumulator is the row sum, on the tensor cores;
//                 v6 takes V as (B, H, T, HD + 8), its last 8 columns ones
//                 (after the padded width where ops/attention_variants.py
//                 pads), and reads the denominator from column HD of e @ V
//                 as the JAX kernel does (the description below is at HD =
//                 64; the column slot is the same at 32 and 128). Columns 0-63 arrive as the usual swizzled V
//                 tile (a 64-column box of a map over the 144-byte rows);
//                 columns 64-71 of the same 64 keys as a 1 KB slot per ring
//                 stage (an 8-column box without swizzle, on the stage's
//                 mbarrier), read by one m64n8k16 per k16 step: 64 key rows
//                 of 16 bytes with N contiguous, so B is MN-major (the
//                 transpose bit) in 8 x 16-byte core matrices, 128 bytes
//                 apart in K. Column 64 of that accumulator sits in the first
//                 thread of each quad; the others take it by shuffle. Built
//                 with -D VAR_V6_N72=1 PV is one m64n72k16 instead: a second
//                 128-byte-swizzled box at column 64 (zeros past column 72
//                 from TMA's out-of-bounds fill) right after the V tile, the
//                 descriptor's leading byte offset stepping to it (head
//                 dim 64 only).
//               It writes out and recip (B, H, T) f32 into a workspace the
//               caller allocates.
//   mean pass   (attn_var_mean: v2, v4, v6; attn_var_mean_nomin: v3) one
//               block = one warpgroup per (64 query rows, chunk of key
//               tiles, image), as attn_mean: the query tiles of every head
//               loaded once and kept (at most VMEAN_RESIDENT_HEADS; above
//               that each (key tile, head) unit brings its own query tile
//               beside its K tile through the ring, so no head count is
//               refused), K streamed per (key tile, head) through a
//               VMEAN_STAGES-slot ring, S of the next unit issued before this
//               unit's exp work; e recomputed with the same instructions in
//               the same k16 order as in the out pass, so it has the same
//               bits; e_h * recip_h / H added over the heads in f32 registers
//               and each mean tile written once, in bf16. No atomics: every
//               output element is written once, in a fixed order. The host
//               picks the chunk length for the fewest, shortest waves.
// Where trouble lies, and what the design does about it:
//   - key columns >= T: TMA fills rows past T with zeros, which give s = 0
//     and e = 2^-20, not 0. Only the last key tile can hold them (4301 =
//     67*64 + 13: a ragged last tile at the tool's T); there each logit past
//     T is set to -inf before the exp2 (a select, no branch around the
//     exp2), so e = 0, in both passes alike;
//   - the mean's rows are not 16-byte aligned at odd T (a row of 4301 is
//     8602 bytes), so the mean cannot be stored by TMA: store_mean2 stores
//     pairs where a row starts at an even element, single entries otherwise;
//   - scaling q: one bf16 multiply per element rounded once, as q * scale in
//     the storage dtype (the product of two bf16 is exact in f32, so __hmul2
//     matches), done in shared memory after the tile arrives and made
//     visible to wgmma with fence.proxy.async, in both passes alike;
//   - exp2 accuracy: ex2.approx.ftz flushes subnormal results to 0 and may
//     differ from torch.exp2 by an f32 ulp before the bf16 rounding (the
//     card checks allow 4 bf16 ulps of |out| and, per mean entry, the limit
//     of ops/attention_variants.py::mean_limit); integer inputs come out
//     exact, so the clamp still gives 2^100 at both keys. v3's logits of 128
//     and above give inf, then a NaN row, as in the plain version and the
//     JAX kernel: nothing guards them;
//   - v6's column slot: its 8 columns are N, contiguous per key, the
//     opposite of v4's K-major ones slot. Ones read as ones under any
//     descriptor, so the card tests also feed columns that are not ones;
//   - head count: the out pass has one block per (row block, head) and
//     takes any H; the mean pass keeps every head's query tile only up to
//     VMEAN_RESIDENT_HEADS and streams them above it (heads one at a time,
//     added in f32 all the same); v5 likewise (V5_RESIDENT_HEADS), and its
//     recips move to the workspace above V5_SMEM_RECIP_HEADS;
//   - wgmma asynchrony: every step issues one batch of products and waits
//     for all of it, accumulators and A registers fenced on both sides, so
//     ptxas keeps the products asynchronous (no C751x warning).
//
// v5 (attn_v5_batched): the JAX kernel's defining choice, every head of a
// query tile in one grid step with out and mean in one launch, as ONE
// kernel on a thread block cluster. One block = two warpgroups = 128 query
// rows of one image; a cluster = the C blocks (ranks) of those rows, so the
// grid is (C, ceil(T / 128), B) and fills the card where one block per
// query tile (34 at the tool's T) would leave most SMs idle. The host picks
// C (at most 8, portable) for the fewest, fullest waves from
// cudaOccupancyMaxActiveClusters at the kernel's shared memory.
//   sweep 1   out, whole heads per rank: rank r takes heads r, r + C, ...
//             (ceil((H - r) / C) of them, none where r >= H) over every key
//             tile, as the out pass does. TMA brings the head's two query
//             tiles and a V5_STAGES-slot K/V ring (prefetched across
//             heads); per key tile the out pass's step: S by wgmma, e into
//             A fragments (e_frags), the row sums, O += e V (V MN-major);
//             out and recip straight from the registers. The warpgroups
//             share each slot but do not wait for each other: each counts
//             itself out of a slot (a shared-memory count) and the second
//             one out refills it, so they drift by up to the ring's depth.
//             After sweep 1 one cluster barrier, then every rank copies the
//             other ranks' recips (distributed shared memory).
//   sweep 2   the mean of the rank's key chunk (rank r: key tiles r nk / C
//             .. (r + 1) nk / C), one 64-row half of the block at a time
//             (both warpgroups read its query tiles: kept for up to
//             V5_RESIDENT_HEADS heads, else streamed with K), warpgroup w
//             taking the chunk's key tiles 2p + w through a ring of its
//             own, on its own. Per (tile, head) unit: S (the products of
//             sweep 1 in the same k16 order: the same bits), e with
//             e_frags's arithmetic, acc += e * recip_h (__fmul_rn,
//             __fadd_rn) in head order, after the last head acc / H
//             (kern5's one division, __fdiv_rn) stored once, staged in
//             shared memory and written a row at a time (at the tool's odd
//             T store_mean2's pairs are single entries, 8 rows a warp
//             store: eight sectors touched for 64 bytes).
//             One S buffer: a second (as mean_pass has) spilled at the
//             128 registers that two blocks per SM leave.
// No atomics: every out and mean element is written once, so two calls
// are bitwise equal. The recips of every head stay in shared memory up to
// V5_SMEM_RECIP_HEADS heads (512 bytes a head); above that the (B, H, T)
// workspace holds them (each rank stores its own heads' rows, read after
// sweep 1's barrier), so no head count is refused. Shared memory at 6
// heads: about 105 KB, two blocks per SM. A rank without heads or without
// a key chunk (more ranks than heads or key tiles) joins every barrier.
// What bounds v5 on the card: the grid. Its blocks run at about the two
// passes' rates, but 34 query tiles x C ranks cannot fill 132 SMs x 2
// evenly (C = 6 at the tool's shape: 204 blocks, 60 SMs holding one); see
// PERF.md.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

#include <atomic>

#include "hopper.cuh"

namespace {

namespace cg = cooperative_groups;
using namespace hopper;

// Design constants of the Hopper design. Each may be overridden with -D at
// build time, which is how `chip_smoke.py --ablate attention_variants`
// builds the variants it times.
#ifndef VAR_STAGES
#define VAR_STAGES 4  // K/V ring slots of the out pass
#endif
#ifndef VAR_BLOCKS_PER_SM
#define VAR_BLOCKS_PER_SM 2  // out-pass blocks per SM (launch bounds)
#endif
#ifndef VAR_V6_N72
#define VAR_V6_N72 0  // v6: PV as one m64n72k16 per k16 step instead of n64 + n8
#endif
#ifndef VMEAN_STAGES
#define VMEAN_STAGES 2  // ring slots of the mean pass
#endif
#ifndef VMEAN_BLOCKS_PER_SM
#define VMEAN_BLOCKS_PER_SM 3  // mean-pass blocks per SM (launch bounds)
#endif
#ifndef VMEAN_MAX_CHUNK
#define VMEAN_MAX_CHUNK 16  // key tiles per mean-pass block, at most
#endif
#ifndef VMEAN_RESIDENT_HEADS
#define VMEAN_RESIDENT_HEADS 12  // most heads whose query tiles the mean pass keeps (at d = 64;
                                 // as many bytes at 32 and 128)
#endif

#ifndef V5_CLUSTER
#define V5_CLUSTER 0  // v5: blocks per cluster; 0: the host picks (v5_cluster)
#endif
#ifndef V5_STAGES
#define V5_STAGES 3  // v5: K/V ring slots of sweep 1
#endif
#ifndef V5_RESIDENT_HEADS
#define V5_RESIDENT_HEADS 7  // v5: most heads whose query tiles sweep 2 keeps (2 blocks/SM;
                             // at d = 64, as many bytes at 32 and 128)
#endif

static_assert(VMEAN_STAGES >= 2, "a mean-pass slot is refilled while the next one is read");
static_assert(V5_CLUSTER >= 0 && V5_CLUSTER <= 8, "v5 clusters are portable: at most 8 blocks");

constexpr float SHIFT = 20.f;  // the constant softmax shift, log2 domain
constexpr float CLAMP = 100.f;  // the exponent clamp of the clamped variants

typedef __nv_bfloat16 bf16;

// ------------------------------------------------------------ Hopper design

constexpr int TILE = TILE_ROWS;
constexpr int WG_THREADS = 128;  // one warpgroup
constexpr int OUT_WARPGROUPS = 2;
constexpr int OUT_ROWS = OUT_WARPGROUPS * TILE;
constexpr int OUT_THREADS = OUT_WARPGROUPS * WG_THREADS;
constexpr int ONES_BYTES = 1024;  // v4's B operand: 8 rows of 64 bf16 ones
constexpr int COLS_BYTES = TILE * 16;  // v6's B operand: V's ones columns (HD..HD+7) of 64 keys
constexpr uint32_t BF16_ONES = 0x3F803F80u;

// How the out pass takes each row's sum of e.
enum RowSum {
  SUM_SHUFFLE = 0,   // v2, v3: f32 adds on the vector units
  SUM_MMA_ONES = 1,  // v4: e @ ones, a slot of ones made in shared memory
  SUM_V_COLS = 2,    // v6: column 64 of e @ V[:, 64:72], V's columns from memory
};

// v6 built with one m64n72k16 per k16 step (head dim 64 only): a third
// tile per ring slot
template <int HD>
__host__ __device__ constexpr bool n72(int sum) {
  return sum == SUM_V_COLS && VAR_V6_N72 && HD == 64;
}
template <int HD>
__host__ __device__ constexpr int ring_tiles(int sum) { return n72<HD>(sum) ? 3 : 2; }
// v4's ones, or v6's column slot of each ring stage
template <int HD>
__host__ __device__ constexpr int side_bytes(int sum) {
  return sum == SUM_MMA_ONES                      ? ONES_BYTES
         : sum == SUM_V_COLS && !n72<HD>(sum) ? VAR_STAGES * COLS_BYTES
                                                  : 0;
}
// bytes one ring stage receives
template <int HD>
__host__ __device__ constexpr int stage_bytes(int sum) {
  return ring_tiles<HD>(sum) * HeadTile<HD>::BYTES +
         (sum == SUM_V_COLS && !n72<HD>(sum) ? COLS_BYTES : 0);
}

// out pass: the query tiles, VAR_STAGES ring slots of (K, V[, V's columns
// 64-127]), the ones or column slots, the barriers. v6 adds 1 KB per ring
// slot (8 KB under VAR_V6_N72)
template <int HD>
constexpr size_t out_smem(int sum) {
  return (size_t)(OUT_WARPGROUPS + ring_tiles<HD>(sum) * VAR_STAGES) * HeadTile<HD>::BYTES +
         side_bytes<HD>(sum) + (1 + VAR_STAGES) * sizeof(uint64_t) + 1024;
}

// out-pass blocks per SM that the registers are budgeted for: the 64 O
// accumulators of head dim 128 leave room for one
template <int HD>
__host__ __device__ constexpr int out_blocks_per_sm() {
  return HD == 128 ? 1 : VAR_BLOCKS_PER_SM;
}

// whether the mean pass keeps every head's query tile: as many bytes as
// VMEAN_RESIDENT_HEADS tiles of head dim 64
template <int HD>
bool mean_resident(int H) {
  return (long)H * HeadTile<HD>::BYTES <= (long)VMEAN_RESIDENT_HEADS * TILE_BYTES;
}

// mean pass: the resident query tiles, VMEAN_STAGES slots of K (and of the
// unit's query tile when they are not resident), the barriers
template <int HD>
size_t mean_smem(int H, bool resident) {
  return (size_t)(resident ? H : 0) * HeadTile<HD>::BYTES +
         (size_t)VMEAN_STAGES * (resident ? 1 : 2) * HeadTile<HD>::BYTES +
         (1 + VMEAN_STAGES) * sizeof(uint64_t) + 1024;
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// column of accumulator element i of a thread (d[4j + i'] layout, hopper.cuh)
__device__ __forceinline__ int acc_col(int i, int tig) { return (i >> 2) * 8 + tig * 2 + (i & 1); }

// the bf16 halves of a packed pair, as f32
__device__ __forceinline__ float bf_lo(uint32_t p) { return __uint_as_float(p << 16); }
__device__ __forceinline__ float bf_hi(uint32_t p) { return __uint_as_float(p & 0xFFFF0000u); }

// two adjacent mean entries (row r, columns col, col + 1) as bf16: a pair
// where a row starts at an even element (even T), single entries otherwise
__device__ __forceinline__ void store_mean2(bf16* mb, int r, int col, int T, float x0, float x1) {
  if (r >= T) return;
  bf16* dst = mb + (size_t)r * T + col;
  if ((T & 1) == 0 && col + 1 < T) {
    *reinterpret_cast<uint32_t*>(dst) = pack_bf16(x0, x1);
  } else {
    if (col < T) dst[0] = __float2bfloat16(x0);
    if (col + 1 < T) dst[1] = __float2bfloat16(x1);
  }
}

// e of a thread's 32 logits of a 64 x 64 tile whose keys start at key0,
// rounded to bf16 A fragments (pe[kc][i] holds entries 8kc + 2i, 8kc + 2i +
// 1: row a for even i, row b for odd i): exp2(min(s - 20, 100)), or
// exp2(s - 20) unclamped. Both passes call this on the same S, so both get
// the same bits. Keys >= T (zeros from TMA) get -inf: e = 0.
template <bool CLAMPED>
__device__ __forceinline__ void e_frags(uint32_t (&pe)[4][4], float (&s)[32], int key0, int T,
                                        int tig) {
  if (key0 + TILE > T) {
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = key0 + acc_col(i, tig) < T ? s[i] : -INFINITY;
  }
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = ex2(CLAMPED ? fminf(s[i] - SHIFT, CLAMP) : s[i] - SHIFT);
  acc_to_a(pe, s);
}

// `bytes` of bf16 query tile in shared memory times the scale, each product
// rounded once to bf16 (q * scale in the storage dtype), by `nthreads`
// threads; then ordered before later wgmma reads (the caller syncs)
__device__ __forceinline__ void scale_tiles(uint8_t* p, int bytes, __nv_bfloat162 s2, int tid,
                                            int nthreads) {
  for (int i = tid * 16; i < bytes; i += nthreads * 16) {
    uint4 x = *reinterpret_cast<uint4*>(p + i);
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&x);
#pragma unroll
    for (int j = 0; j < 4; ++j) h[j] = __hmul2(h[j], s2);
    *reinterpret_cast<uint4*>(p + i) = x;
  }
  fence_async_smem();
}

__device__ __forceinline__ void fence_regs4(float (&d)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// v6's column slot, k16 step kc: 64 key rows of 16 bytes (8 columns, N
// contiguous), no swizzle. MN-major core matrices are 8 keys x 16 bytes;
// the next 8 keys follow 128 bytes on (the K-direction offset); N has one
// core matrix, so the other offset is never stepped (set alike).
__device__ __forceinline__ uint64_t desc_cols(const void* slot, int kc) {
  return make_desc(smem_addr(slot) + kc * 256, 128, 128, 0);
}

// D (64 x 8, f32: d[0..1] row 16*warp + lane/4, columns 2*(lane%4) + 0..1;
// d[2..3] eight rows on) (+)= A (64 x 16 bf16 in registers, the m16n8k16 A
// layout) * B (16 x 8 slot: K-major for TRANS_B = 0, MN-major for 1).
// hopper.cuh has the n64 products only.
template <int TRANS_B>
__device__ __forceinline__ void wgmma_rs_n8(float (&d)[4], const uint32_t (&a)[4], uint64_t desc_b,
                                            int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, %8, p, 1, 1, %10;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(acc), "n"(TRANS_B));
}

// D (64 x 72, f32) (+)= A (registers) * B (16 x 72, MN-major, two
// 128-byte-swizzled atoms TILE_BYTES apart): columns 0-63 into d, 64-71 into
// x (the m64n72 layout: d[4j + i] for j < 8, x[i] for j = 8)
// (used only in a build with -D VAR_V6_N72=1)
[[maybe_unused]] __device__ __forceinline__ void wgmma_rs_n72(float (&d)[32], float (&x)[4],
                                                              const uint32_t (&a)[4],
                                                              uint64_t desc_b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %41, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n72k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35}, "
      "{%36, %37, %38, %39}, %40, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(x[0]), "+f"(x[1]), "+f"(x[2]), "+f"(x[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(acc));
}

// --------------------------------------------------------------- out pass

struct OutArgs {
  const uint8_t* q_s;  // this warpgroup's query tile (scaled)
  uint8_t* ring;       // slot s: K at tile r*s, V at tile r*s + 1 (r = ring_tiles)
  uint8_t* side;       // v4's ones; v6's column slot of stage s at s * COLS_BYTES
  uint64_t* bars;      // [0] query tiles, [1 + s] slot s
  const CUtensorMap* map_k;
  const CUtensorMap* map_v;
  const CUtensorMap* map_c;  // v6: V's columns 64-71
  int plane, n, T, tig, tid;
};

template <int HD, int SUM>
__device__ __forceinline__ void out_load(const OutArgs& a, int tile) {
  using HT = HeadTile<HD>;
  const int st = tile % VAR_STAGES;
  uint8_t* slot = a.ring + ring_tiles<HD>(SUM) * st * HT::BYTES;
  uint64_t* bar = &a.bars[1 + st];
  mbar_expect_tx(bar, stage_bytes<HD>(SUM));
  HT::load(slot, a.map_k, bar, tile * TILE, a.plane);
  HT::load(slot + HT::BYTES, a.map_v, bar, tile * TILE, a.plane);
  if (n72<HD>(SUM))  // columns 64-127 of V: 64-71, then zeros
    tma_load_box(slot + 2 * HT::BYTES, a.map_v, bar, HD, tile * TILE, a.plane);
  else if (SUM == SUM_V_COLS)
    tma_load_box(a.side + st * COLS_BYTES, a.map_c, bar, HD, tile * TILE, a.plane);
}

// Key tile j: `s` holds its finished S and no product is in flight. Takes
// e of `s` (and, for v2 and v3, adds it to the row sums); then one batch of
// products, O += e V of tile j (v4: and the row sums e @ ones; v6: and e @
// V[:, 64:72]) and S of tile j + 1 into `s`, after which tile j's slot is
// refilled. Every step issues the same products and waits for all of them,
// so that ptxas keeps them asynchronous: the last tile recomputes its own
// S, which nobody reads.
template <int HD, int SUM, bool CLAMPED>
__device__ __forceinline__ void out_step(const OutArgs& a, float (&s)[32], float (&o)[HD / 2],
                                         float (&rs)[4], uint32_t (&pa)[4][4], float& sum_a,
                                         float& sum_b, int j) {
  using HT = HeadTile<HD>;
  e_frags<CLAMPED>(pa, s, j * TILE, a.T, a.tig);
  if (SUM == SUM_SHUFFLE) {
#pragma unroll
    for (int kc = 0; kc < 4; ++kc) {
      sum_a += (bf_lo(pa[kc][0]) + bf_hi(pa[kc][0])) + (bf_lo(pa[kc][2]) + bf_hi(pa[kc][2]));
      sum_b += (bf_lo(pa[kc][1]) + bf_hi(pa[kc][1])) + (bf_lo(pa[kc][3]) + bf_hi(pa[kc][3]));
    }
  }

  const bool more = j + 1 < a.n;
  if (more) mbar_wait(&a.bars[1 + (j + 1) % VAR_STAGES], ((j + 1) / VAR_STAGES) & 1);
  const uint8_t* k_s =
      a.ring + ring_tiles<HD>(SUM) * ((more ? j + 1 : j) % VAR_STAGES) * HT::BYTES;
  const uint8_t* v_s = a.ring + (ring_tiles<HD>(SUM) * (j % VAR_STAGES) + 1) * HT::BYTES;
  fence_regs(s);
  fence_regs(o);
  fence_regs(pa);
  if (SUM != SUM_SHUFFLE) fence_regs4(rs);
  wgmma_fence();
  if constexpr (n72<HD>(SUM)) {
#pragma unroll
    for (int kc = 0; kc < 4; ++kc) wgmma_rs_n72(o, rs, pa[kc], desc_mnmajor(v_s, kc), 1);
  } else {
#pragma unroll
    for (int kc = 0; kc < 4; ++kc) wgmma_rs<1>(o, pa[kc], HT::mnmajor(v_s, kc), 1);
  }
  if (SUM == SUM_MMA_ONES) {
#pragma unroll
    for (int kc = 0; kc < 4; ++kc) wgmma_rs_n8<0>(rs, pa[kc], desc_kmajor(a.side, 0), 1);
  } else if (SUM == SUM_V_COLS && !n72<HD>(SUM)) {
    const uint8_t* c_s = a.side + (j % VAR_STAGES) * COLS_BYTES;
#pragma unroll
    for (int kc = 0; kc < 4; ++kc) wgmma_rs_n8<1>(rs, pa[kc], desc_cols(c_s, kc), 1);
  }
#pragma unroll
  for (int kc = 0; kc < HT::KSTEPS; ++kc)
    wgmma_ss<0>(s, HT::kmajor(a.q_s, kc), HT::kmajor(k_s, kc), kc);
  wgmma_commit();
  wgmma_wait();
  fence_regs(s);
  fence_regs(o);
  fence_regs(pa);
  if (SUM != SUM_SHUFFLE) fence_regs4(rs);
  __syncthreads();  // both warpgroups are done with tile j's slot
  if (a.tid == 0 && j + VAR_STAGES < a.n) out_load<HD, SUM>(a, j + VAR_STAGES);
}

template <int HD, int SUM, bool CLAMPED>
__device__ __forceinline__ void out_pass(const CUtensorMap& map_q, const CUtensorMap& map_k,
                                         const CUtensorMap& map_v, const CUtensorMap& map_c,
                                         bf16* __restrict__ out, float* __restrict__ recip, int H,
                                         int T, float qscale) {
  using HT = HeadTile<HD>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  const int wg = threadIdx.x >> 7;  // this warpgroup's query tile
  OutArgs a;
  a.q_s = smem + wg * HT::BYTES;
  a.ring = smem + OUT_WARPGROUPS * HT::BYTES;
  a.side = a.ring + ring_tiles<HD>(SUM) * VAR_STAGES * HT::BYTES;
  a.bars = reinterpret_cast<uint64_t*>(a.side + side_bytes<HD>(SUM));
  a.map_k = &map_k;
  a.map_v = &map_v;
  a.map_c = &map_c;
  a.plane = blockIdx.z * H + blockIdx.y;
  a.n = (T + TILE - 1) / TILE;
  a.T = T;
  a.tid = threadIdx.x;
  a.tig = threadIdx.x & 3;
  const int row0 = blockIdx.x * OUT_ROWS;
  if (a.tid == 0) {
    for (int i = 0; i <= VAR_STAGES; ++i) mbar_init(&a.bars[i], 1);
    mbar_init_fence();
    mbar_expect_tx(&a.bars[0], OUT_WARPGROUPS * HT::BYTES);
    for (int w = 0; w < OUT_WARPGROUPS; ++w)
      HT::load(smem + w * HT::BYTES, &map_q, &a.bars[0], row0 + w * TILE, a.plane);
    for (int t = 0; t < VAR_STAGES && t < a.n; ++t) out_load<HD, SUM>(a, t);
  }
  if (SUM == SUM_MMA_ONES) {
    for (int i = a.tid; i < ONES_BYTES / 4; i += OUT_THREADS)
      reinterpret_cast<uint32_t*>(a.side)[i] = BF16_ONES;
  }
  __syncthreads();  // the barriers are initialised
  mbar_wait(&a.bars[0], 0);
  scale_tiles(smem, OUT_WARPGROUPS * HT::BYTES, __float2bfloat162_rn(qscale), a.tid,
              OUT_THREADS);  // its fence also covers the ones
  __syncthreads();

  float s[32], o[HD / 2], rs[4] = {0.f, 0.f, 0.f, 0.f};
  uint32_t pa[4][4];
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = 0.f;
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;
  float sum_a = 0.f, sum_b = 0.f;

  mbar_wait(&a.bars[1], 0);
  wgmma_fence();
#pragma unroll
  for (int kc = 0; kc < HT::KSTEPS; ++kc)
    wgmma_ss<0>(s, HT::kmajor(a.q_s, kc), HT::kmajor(a.ring, kc), kc);
  wgmma_commit();
  wgmma_wait();
  fence_regs(s);
  for (int j = 0; j < a.n; ++j) out_step<HD, SUM, CLAMPED>(a, s, o, rs, pa, sum_a, sum_b, j);

  if (SUM == SUM_SHUFFLE) {
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      sum_a += __shfl_xor_sync(0xffffffffu, sum_a, off);
      sum_b += __shfl_xor_sync(0xffffffffu, sum_b, off);
    }
  } else if (SUM == SUM_V_COLS) {  // column HD of e @ V[:, HD:HD+8]: the quad's first thread holds it
    const int lead = threadIdx.x & 28;
    sum_a = __shfl_sync(0xffffffffu, rs[0], lead);
    sum_b = __shfl_sync(0xffffffffu, rs[2], lead);
  } else {  // every column of e @ ones is the row sum
    sum_a = rs[0];
    sum_b = rs[2];
  }
  const float inv_a = 1.f / fmaxf(sum_a, 1e-30f), inv_b = 1.f / fmaxf(sum_b, 1e-30f);
  const int r_a = row0 + wg * TILE + ((a.tid >> 5) & 3) * 16 + ((a.tid & 31) >> 2);
  const int r_b = r_a + 8;
  bf16* oh = out + (size_t)a.plane * T * HD;
#pragma unroll
  for (int j = 0; j < HD / 8; ++j) {
    const int c = j * 8 + a.tig * 2;
    if (r_a < T)
      *reinterpret_cast<uint32_t*>(oh + (size_t)r_a * HD + c) =
          pack_bf16(o[4 * j] * inv_a, o[4 * j + 1] * inv_a);
    if (r_b < T)
      *reinterpret_cast<uint32_t*>(oh + (size_t)r_b * HD + c) =
          pack_bf16(o[4 * j + 2] * inv_b, o[4 * j + 3] * inv_b);
  }
  if (a.tig == 0) {
    float* rh = recip + (size_t)a.plane * T;
    if (r_a < T) rh[r_a] = inv_a;
    if (r_b < T) rh[r_b] = inv_b;
  }
}

// map_c: v6's map of V's ones columns HD..HD+7 (the others ignore it)
#define OUT_ARGS                                                                             \
  const __grid_constant__ CUtensorMap map_q, const __grid_constant__ CUtensorMap map_k,      \
      const __grid_constant__ CUtensorMap map_v, const __grid_constant__ CUtensorMap map_c,  \
      bf16 *__restrict__ out, float *__restrict__ recip, int H, int T, float qscale
#define OUT_PASS(SUM, CLAMPED) \
  out_pass<HD, SUM, CLAMPED>(map_q, map_k, map_v, map_c, out, recip, H, T, qscale)

template <int HD>
__global__ void __launch_bounds__(OUT_THREADS, out_blocks_per_sm<HD>()) attn_v2_bf16e(OUT_ARGS) {
  OUT_PASS(SUM_SHUFFLE, true);
}

template <int HD>
__global__ void __launch_bounds__(OUT_THREADS, out_blocks_per_sm<HD>()) attn_v3_nomin(OUT_ARGS) {
  OUT_PASS(SUM_SHUFFLE, false);
}

template <int HD>
__global__ void __launch_bounds__(OUT_THREADS, out_blocks_per_sm<HD>()) attn_v4_mxsum(OUT_ARGS) {
  OUT_PASS(SUM_MMA_ONES, true);
}

template <int HD>
__global__ void __launch_bounds__(OUT_THREADS, out_blocks_per_sm<HD>())
attn_v6_fusedsum(OUT_ARGS) {
  OUT_PASS(SUM_V_COLS, true);
}

// -------------------------------------------------------------- mean pass

struct MeanArgs {
  uint8_t* q_res;  // the H resident query tiles (scaled), or null: streamed
  uint8_t* ring;   // VMEAN_STAGES slots: K, then the unit's query tile if streamed
  uint64_t* bars;  // [0] resident query tiles, [1 + s] slot s
  const CUtensorMap* map_q;
  const CUtensorMap* map_k;
  const float* recip;  // this image's (H, T)
  bf16* mean;          // this image's (T, T)
  int b, H, kt0, n, row0, row_a, slot_bytes, T, tig, tid;
  __nv_bfloat162 s2;
  float inv_h;
};

// unit u: key tile kt0 + u / H of head u % H
__device__ __forceinline__ uint8_t* mean_slot(const MeanArgs& a, int u) {
  return a.ring + (u % VMEAN_STAGES) * a.slot_bytes;
}

template <int HD>
__device__ __forceinline__ const uint8_t* mean_q(const MeanArgs& a, int u) {
  return a.q_res != nullptr ? a.q_res + (u % a.H) * HeadTile<HD>::BYTES
                            : mean_slot(a, u) + HeadTile<HD>::BYTES;
}

template <int HD>
__device__ __forceinline__ void mean_load(const MeanArgs& a, int u) {
  using HT = HeadTile<HD>;
  const int st = u % VMEAN_STAGES;
  uint8_t* slot = mean_slot(a, u);
  const int plane = a.b * a.H + u % a.H;
  mbar_expect_tx(&a.bars[1 + st], a.slot_bytes);
  HT::load(slot, a.map_k, &a.bars[1 + st], (a.kt0 + u / a.H) * TILE, plane);
  if (a.q_res == nullptr) HT::load(slot + HT::BYTES, a.map_q, &a.bars[1 + st], a.row0, plane);
}

// wait for unit u's slot; a streamed query tile is scaled where it arrived
template <int HD>
__device__ __forceinline__ void mean_arrive(const MeanArgs& a, int u) {
  mbar_wait(&a.bars[1 + u % VMEAN_STAGES], (u / VMEAN_STAGES) & 1);
  if (a.q_res == nullptr) {
    scale_tiles(mean_slot(a, u) + HeadTile<HD>::BYTES, HeadTile<HD>::BYTES, a.s2, a.tid,
                WG_THREADS);
    __syncthreads();
  }
}

// S of unit u, whose slot has arrived, into s (one commit group); the
// products of the out pass's S in the same order
template <int HD>
__device__ __forceinline__ void mean_issue_s(const MeanArgs& a, float (&s)[32], int u) {
  using HT = HeadTile<HD>;
  const uint8_t* q_s = mean_q<HD>(a, u);
  const uint8_t* k_s = mean_slot(a, u);
  fence_regs(s);
  wgmma_fence();
#pragma unroll
  for (int kc = 0; kc < HT::KSTEPS; ++kc)
    wgmma_ss<0>(s, HT::kmajor(q_s, kc), HT::kmajor(k_s, kc), kc);
  wgmma_commit();
}

// Unit u: `cur` holds its finished S. Issues the next unit's S into `nxt`,
// adds this unit's e * recip / H to `acc`, writes the tile after its last
// head, and returns with `nxt` finished. As in out_step every step issues
// and waits alike: the last unit recomputes its own S, which nobody reads.
template <int HD, bool CLAMPED>
__device__ __forceinline__ void mean_step(const MeanArgs& a, float (&cur)[32], float (&nxt)[32],
                                          float (&acc)[32], int u) {
  const bool more = u + 1 < a.n;
  if (more) mean_arrive<HD>(a, u + 1);
  mean_issue_s<HD>(a, nxt, more ? u + 1 : u);
  __syncthreads();  // every warp is done with unit u's slot
  if (a.tid == 0 && u + VMEAN_STAGES < a.n) mean_load<HD>(a, u + VMEAN_STAGES);

  const int h = u % a.H;
  const int key0 = (a.kt0 + u / a.H) * TILE;
  const int r_a = a.row0 + a.row_a, r_b = r_a + 8;
  const float* rh = a.recip + (size_t)h * a.T;
  const float c_a = r_a < a.T ? rh[r_a] * a.inv_h : 0.f;
  const float c_b = r_b < a.T ? rh[r_b] * a.inv_h : 0.f;
  uint32_t pe[4][4];
  e_frags<CLAMPED>(pe, cur, key0, a.T, a.tig);
  // the plain version's roundings: the product, then the sum (no FMA)
#pragma unroll
  for (int kc = 0; kc < 4; ++kc) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float c = (i & 1) ? c_b : c_a;
      acc[8 * kc + 2 * i] = __fadd_rn(acc[8 * kc + 2 * i], __fmul_rn(bf_lo(pe[kc][i]), c));
      acc[8 * kc + 2 * i + 1] =
          __fadd_rn(acc[8 * kc + 2 * i + 1], __fmul_rn(bf_hi(pe[kc][i]), c));
    }
  }

  if (h == a.H - 1) {  // every head summed: write the tile, start the next
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = key0 + j * 8 + a.tig * 2;
      store_mean2(a.mean, r_a, col, a.T, acc[4 * j], acc[4 * j + 1]);
      store_mean2(a.mean, r_b, col, a.T, acc[4 * j + 2], acc[4 * j + 3]);
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] = 0.f;
  }

  wgmma_wait();
  fence_regs(nxt);
}

template <int HD, bool CLAMPED>
__device__ __forceinline__ void mean_pass(const CUtensorMap& map_q, const CUtensorMap& map_k,
                                          const float* __restrict__ recip, bf16* __restrict__ mean,
                                          int H, int T, float qscale, int chunk, int resident) {
  using HT = HeadTile<HD>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  MeanArgs a;
  a.q_res = resident ? smem : nullptr;
  a.slot_bytes = (resident ? 1 : 2) * HT::BYTES;
  a.ring = smem + (resident ? H : 0) * HT::BYTES;
  a.bars = reinterpret_cast<uint64_t*>(a.ring + VMEAN_STAGES * a.slot_bytes);
  a.map_q = &map_q;
  a.map_k = &map_k;
  a.b = blockIdx.z;
  a.H = H;
  a.recip = recip + (size_t)a.b * H * T;
  a.mean = mean + (size_t)a.b * T * T;
  a.kt0 = blockIdx.x * chunk;
  const int ntiles = (T + TILE - 1) / TILE;
  a.n = min(chunk, ntiles - a.kt0) * H;
  a.row0 = blockIdx.y * TILE;
  a.row_a = (threadIdx.x >> 5) * 16 + ((threadIdx.x & 31) >> 2);
  a.T = T;
  a.tid = threadIdx.x;
  a.tig = threadIdx.x & 3;
  a.s2 = __float2bfloat162_rn(qscale);
  a.inv_h = 1.f / (float)H;
  if (a.tid == 0) {
    for (int i = 0; i <= VMEAN_STAGES; ++i) mbar_init(&a.bars[i], 1);
    mbar_init_fence();
    if (resident) {
      mbar_expect_tx(&a.bars[0], H * HT::BYTES);
      for (int h = 0; h < H; ++h)
        HT::load(smem + h * HT::BYTES, &map_q, &a.bars[0], a.row0, a.b * H + h);
    }
    for (int u = 0; u < VMEAN_STAGES && u < a.n; ++u) mean_load<HD>(a, u);
  }
  __syncthreads();  // the barriers are initialised
  if (resident) {
    mbar_wait(&a.bars[0], 0);
    scale_tiles(smem, H * HT::BYTES, a.s2, a.tid, WG_THREADS);
    __syncthreads();
  }

  float sa[32], sb[32], acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) sa[i] = sb[i] = acc[i] = 0.f;
  mean_arrive<HD>(a, 0);
  mean_issue_s<HD>(a, sa, 0);
  wgmma_wait();
  fence_regs(sa);
  for (int u = 0; u < a.n; u += 2) {
    mean_step<HD, CLAMPED>(a, sa, sb, acc, u);
    if (u + 1 < a.n) mean_step<HD, CLAMPED>(a, sb, sa, acc, u + 1);
  }
}

#define MEAN_ARGS                                                                          \
  const __grid_constant__ CUtensorMap map_q, const __grid_constant__ CUtensorMap map_k,    \
      const float *__restrict__ recip, bf16 *__restrict__ mean, int H, int T, float qscale, \
      int chunk, int resident

// v2, v4, v6: e clamped at 2^100
template <int HD>
__global__ void __launch_bounds__(WG_THREADS, VMEAN_BLOCKS_PER_SM) attn_var_mean(MEAN_ARGS) {
  mean_pass<HD, true>(map_q, map_k, recip, mean, H, T, qscale, chunk, resident);
}

// v3: no clamp (a kernel of its own name, so that profiles and ptxas tell
// the two apart)
template <int HD>
__global__ void __launch_bounds__(WG_THREADS, VMEAN_BLOCKS_PER_SM) attn_var_mean_nomin(MEAN_ARGS) {
  mean_pass<HD, false>(map_q, map_k, recip, mean, H, T, qscale, chunk, resident);
}

// ------------------------------------------------ v5: one fused launch

constexpr int V5_THREADS = 256;  // two warpgroups
// launch bounds: two blocks per SM (128 registers a thread); one at head
// dim 128, whose 64 O accumulators a thread leave no room for a second
template <int HD>
__host__ __device__ constexpr int v5_blocks_per_sm() {
  return HD == 128 ? 1 : 2;
}
// sweep 2's ring slots per warpgroup: a third costs the second block per SM
constexpr int V5_STAGES2 = 2;
// most heads whose recips stay in shared memory (512 bytes a head); more
// would cost the second block per SM
constexpr int V5_SMEM_RECIP_HEADS = 24;
constexpr int V5_ROWS = 2 * TILE;  // query rows per block
constexpr int V5_MAX_CLUSTER = 8;  // portable cluster sizes
constexpr int V5_STAGE_LD = TILE + 8;  // row stride (bf16) of a mean tile staged for its store
// barriers: sweep 1's query tiles, ring 1, ring 2 of each warpgroup, sweep 2's query tiles
constexpr int V5_NBARS = 2 + V5_STAGES + 2 * V5_STAGES2;

// Shared memory, from the 1024-byte aligned base: a region that the two
// sweeps use in turn, then the barriers, ring 1's release counts, then
// recip (H, 128) f32 (above V5_SMEM_RECIP_HEADS heads only the current
// head's; the table then lives in the caller's (B, H, T) workspace).
//   sweep 1: the head's two query tiles | V5_STAGES slots of (K, V)
//   sweep 2: resident: the 64-row query tile of every head | V5_STAGES2
//            slots of a K tile per warpgroup; streamed: V5_STAGES2 slots
//            of (K tile, query tile) per warpgroup; then a 64 x 64 bf16
//            mean tile per warpgroup, staged for its store
template <int HD>
__host__ __device__ constexpr int v5_slot2_bytes(bool resident) {
  return (resident ? 1 : 2) * HeadTile<HD>::BYTES;
}
template <int HD>
__host__ __device__ constexpr int v5_sweep1_bytes() {
  return (2 + 2 * V5_STAGES) * HeadTile<HD>::BYTES;
}
template <int HD>
__host__ __device__ constexpr int v5_sweep2_bytes(int H, bool resident) {
  return (resident ? H : 0) * HeadTile<HD>::BYTES + 2 * V5_STAGES2 * v5_slot2_bytes<HD>(resident) +
         2 * TILE * V5_STAGE_LD * 2;
}
template <int HD>
__host__ __device__ constexpr int v5_region_bytes(int H, bool resident) {
  return v5_sweep1_bytes<HD>() > v5_sweep2_bytes<HD>(H, resident)
             ? v5_sweep1_bytes<HD>()
             : v5_sweep2_bytes<HD>(H, resident);
}
__host__ __device__ constexpr int v5_recip_heads(int H) { return H <= V5_SMEM_RECIP_HEADS ? H : 1; }
template <int HD>
size_t v5_smem(int H, bool resident) {
  return (size_t)v5_region_bytes<HD>(H, resident) + V5_NBARS * sizeof(uint64_t) +
         V5_STAGES * sizeof(uint32_t) + (size_t)v5_recip_heads(H) * V5_ROWS * sizeof(float) + 1024;
}
// whether sweep 2 keeps every head's query tile: as many bytes as
// V5_RESIDENT_HEADS tiles of head dim 64
template <int HD>
bool v5_resident(int H) {
  return (long)H * HeadTile<HD>::BYTES <= (long)V5_RESIDENT_HEADS * TILE_BYTES;
}

struct V5Args {
  uint8_t* region;
  uint64_t* bars;  // [0] q1, [1 + s] ring 1, [1 + V5_STAGES + w * V5_STAGES2 + s] ring 2, last: q2
  uint32_t* released;  // ring 1: warpgroups done with each slot, counted up
  float* recip;    // (H, 128): 1 / max(row sum, 1e-30) of every head; (1, 128) above V5_SMEM_RECIP_HEADS
  float* work;     // the (B, H, T) table above V5_SMEM_RECIP_HEADS heads, else null
  const CUtensorMap* map_q;
  const CUtensorMap* map_k;
  const CUtensorMap* map_v;
  int plane0, row0, kt0, n, H, T, tid, tig, wg, resident;
  // sweep 1: heads h0, h0 + hstep, ... (nh of them) over all n1 key tiles
  int h0, hstep, nh, n1;
  __nv_bfloat162 s2;
};

// the 128 threads of warpgroup `wg` only
__device__ __forceinline__ void v5_wg_sync(int wg) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
}

// local row (0..127) of accumulator rows "a" of thread t (row b is 8 on)
__device__ __forceinline__ int v5_row_a(int t) {
  return (t >> 7) * TILE + ((t >> 5) & 3) * 16 + ((t & 31) >> 2);
}

// sweep 1, unit u = i * n1 + j: key tile j of head h0 + i hstep
template <int HD>
__device__ __forceinline__ uint8_t* v5_slot1(const V5Args& a, int u) {
  return a.region + (2 + 2 * (u % V5_STAGES)) * HeadTile<HD>::BYTES;
}

template <int HD>
__device__ __forceinline__ void v5_load1(const V5Args& a, int u) {
  using HT = HeadTile<HD>;
  uint64_t* bar = &a.bars[1 + u % V5_STAGES];
  uint8_t* slot = v5_slot1<HD>(a, u);
  const int row = u % a.n1 * TILE, plane = a.plane0 + a.h0 + u / a.n1 * a.hstep;
  mbar_expect_tx(bar, 2 * HT::BYTES);
  HT::load(slot, a.map_k, bar, row, plane);
  HT::load(slot + HT::BYTES, a.map_v, bar, row, plane);
}

// head h's two query tiles into the start of the region
template <int HD>
__device__ __forceinline__ void v5_load_q1(const V5Args& a, int h) {
  using HT = HeadTile<HD>;
  mbar_expect_tx(&a.bars[0], 2 * HT::BYTES);
  for (int w = 0; w < 2; ++w)
    HT::load(a.region + w * HT::BYTES, a.map_q, &a.bars[0], a.row0 + w * TILE, a.plane0 + h);
}

// Sweep 1, unit u (key tile j of its head), one warpgroup: out_step of
// v2. `s` holds the tile's finished S; e of it into
// the row sums and the A fragments, then O += e V of this tile and S of
// the next (the last tile recomputes its own S, which nobody reads). The
// warpgroups run on their own: each counts itself out of the slot, and the
// second one out refills it with the unit V5_STAGES on, across heads.
template <int HD>
__device__ __forceinline__ void v5_step1(const V5Args& a, float (&s)[32], float (&o)[HD / 2],
                                         uint32_t (&pa)[4][4], float& sum_a, float& sum_b, int u,
                                         int j) {
  using HT = HeadTile<HD>;
  e_frags<true>(pa, s, j * TILE, a.T, a.tig);
#pragma unroll
  for (int kc = 0; kc < 4; ++kc) {
    sum_a += (bf_lo(pa[kc][0]) + bf_hi(pa[kc][0])) + (bf_lo(pa[kc][2]) + bf_hi(pa[kc][2]));
    sum_b += (bf_lo(pa[kc][1]) + bf_hi(pa[kc][1])) + (bf_lo(pa[kc][3]) + bf_hi(pa[kc][3]));
  }
  const bool more = j + 1 < a.n1;
  if (more) mbar_wait(&a.bars[1 + (u + 1) % V5_STAGES], ((u + 1) / V5_STAGES) & 1);
  const uint8_t* q_s = a.region + a.wg * HT::BYTES;
  const uint8_t* k_s = v5_slot1<HD>(a, more ? u + 1 : u);
  const uint8_t* v_s = v5_slot1<HD>(a, u) + HT::BYTES;
  fence_regs(s);
  fence_regs(o);
  fence_regs(pa);
  wgmma_fence();
#pragma unroll
  for (int kc = 0; kc < 4; ++kc) wgmma_rs<1>(o, pa[kc], HT::mnmajor(v_s, kc), 1);
#pragma unroll
  for (int kc = 0; kc < HT::KSTEPS; ++kc)
    wgmma_ss<0>(s, HT::kmajor(q_s, kc), HT::kmajor(k_s, kc), kc);
  wgmma_commit();
  wgmma_wait();
  fence_regs(s);
  fence_regs(o);
  fence_regs(pa);
  v5_wg_sync(a.wg);  // this warpgroup is done with unit u's slot
  if ((a.tid & 127) == 0) {
    __threadfence_block();
    const uint32_t before = atomicAdd(&a.released[u % V5_STAGES], 1u);
    __threadfence_block();
    if ((before & 1) && u + V5_STAGES < a.nh * a.n1) v5_load1<HD>(a, u + V5_STAGES);
  }
}

// End of head h: v2's out pass epilogue, the rows' sums over the quad and
// out straight from the registers; recip into this rank's table (or the
// workspace). No cluster barrier; the next head's query tiles come once
// both warpgroups are past this head's.
template <int HD>
__device__ __forceinline__ void v5_head_own(const V5Args& a, const float (&o)[HD / 2], float sum_a,
                                            float sum_b, int h, bf16* __restrict__ out) {
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    sum_a += __shfl_xor_sync(0xffffffffu, sum_a, off);
    sum_b += __shfl_xor_sync(0xffffffffu, sum_b, off);
  }
  const float inv_a = 1.f / fmaxf(sum_a, 1e-30f), inv_b = 1.f / fmaxf(sum_b, 1e-30f);
  const int la = v5_row_a(a.tid), r_a = a.row0 + la, r_b = r_a + 8;
  bf16* oh = out + (size_t)(a.plane0 + h) * a.T * HD;
#pragma unroll
  for (int j = 0; j < HD / 8; ++j) {
    const int c = j * 8 + a.tig * 2;
    if (r_a < a.T)
      *reinterpret_cast<uint32_t*>(oh + (size_t)r_a * HD + c) =
          pack_bf16(o[4 * j] * inv_a, o[4 * j + 1] * inv_a);
    if (r_b < a.T)
      *reinterpret_cast<uint32_t*>(oh + (size_t)r_b * HD + c) =
          pack_bf16(o[4 * j + 2] * inv_b, o[4 * j + 3] * inv_b);
  }
  if (a.tig == 0) {
    if (a.work == nullptr) {
      a.recip[h * V5_ROWS + la] = inv_a;
      a.recip[h * V5_ROWS + la + 8] = inv_b;
    } else {
      float* wh = a.work + (size_t)(a.plane0 + h) * a.T;
      if (r_a < a.T) wh[r_a] = inv_a;
      if (r_b < a.T) wh[r_b] = inv_b;
    }
  }
  __syncthreads();
  if (a.tid == 0 && h + a.hstep < a.H) v5_load_q1<HD>(a, h + a.hstep);
}

// recip of head h, local row i (0..127) of the block, for sweep 2: row i
// of the shared table, or of the workspace (0 past T, never read there)
__device__ __forceinline__ float v5_recip(const V5Args& a, int h, int i) {
  if (a.work == nullptr) return a.recip[h * V5_ROWS + i];
  return a.row0 + i < a.T ? __ldcg(a.work + (size_t)(a.plane0 + h) * a.T + a.row0 + i) : 0.f;
}

// Sweep 2 runs over one 64-row half of the block at a time (both
// warpgroups read its query tiles). Warpgroup w takes the chunk's key
// tiles kt0 + 2p + w with a ring of its own and runs on its own: unit v =
// p * H + head. Its ring units are counted over both halves (g0).
struct V5Half {
  int g0, n2, row;  // this warpgroup's first ring unit and units; the first query row
};

template <int HD>
__device__ __forceinline__ uint8_t* v5_slot2(const V5Args& a, int g) {
  return a.region + (a.resident ? a.H * HeadTile<HD>::BYTES : 0) +
         (a.wg * V5_STAGES2 + g % V5_STAGES2) * v5_slot2_bytes<HD>(a.resident);
}

__device__ __forceinline__ uint64_t* v5_bar2(const V5Args& a, int g) {
  return &a.bars[1 + V5_STAGES + a.wg * V5_STAGES2 + g % V5_STAGES2];
}

template <int HD>
__device__ __forceinline__ void v5_load2(const V5Args& a, const V5Half& f, int v) {
  using HT = HeadTile<HD>;
  const int g = f.g0 + v;
  uint64_t* bar = v5_bar2(a, g);
  uint8_t* slot = v5_slot2<HD>(a, g);
  const int plane = a.plane0 + v % a.H, row = (a.kt0 + 2 * (v / a.H) + a.wg) * TILE;
  mbar_expect_tx(bar, v5_slot2_bytes<HD>(a.resident));
  HT::load(slot, a.map_k, bar, row, plane);
  if (!a.resident) HT::load(slot + HT::BYTES, a.map_q, bar, f.row, plane);
}

// A warpgroup's staged 64 x 64 mean tile (rows row.., columns col0..) into
// the (T, T) mean, whole rows at a time: 4-byte pairs at even T, single
// entries at odd T (a row then starts at an odd element every other row),
// consecutive lanes on consecutive entries either way. The next write of
// the stage comes after the warpgroup's next barrier.
__device__ __forceinline__ void v5_store_tile(const V5Args& a, const bf16* st, int row, int col0,
                                              bf16* __restrict__ mean) {
  const int warp = (a.tid >> 5) & 3, lane = a.tid & 31;
  for (int r = warp * 16; r < warp * 16 + 16 && row + r < a.T; ++r) {
    bf16* dst = mean + (size_t)(row + r) * a.T + col0;
    const bf16* src = st + r * V5_STAGE_LD;
    if ((a.T & 1) == 0) {
      if (col0 + 2 * lane < a.T)
        *reinterpret_cast<uint32_t*>(dst + 2 * lane) =
            *reinterpret_cast<const uint32_t*>(src + 2 * lane);
    } else {
      if (col0 + lane < a.T) dst[lane] = src[lane];
      if (col0 + lane + 32 < a.T) dst[lane + 32] = src[lane + 32];
    }
  }
}

// Unit v of this warpgroup: S of its tile (the products of sweep 1, so the
// same bits), the slot handed back for the unit V5_STAGES2 on, then e_h *
// recip_h added to `acc` (the product, then the sum, in head order; the
// plain version's roundings: no FMA), and after the last head acc / H
// (one division) stored.
template <int HD>
__device__ __forceinline__ void v5_step2(const V5Args& a, const V5Half& f, float (&s)[32],
                                         float (&acc)[32], int v, bf16* __restrict__ mean) {
  using HT = HeadTile<HD>;
  const int g = f.g0 + v;
  uint8_t* slot = v5_slot2<HD>(a, g);
  mbar_wait(v5_bar2(a, g), (g / V5_STAGES2) & 1);
  const uint8_t* q_s = a.resident ? a.region + (v % a.H) * HT::BYTES : slot + HT::BYTES;
  if (!a.resident) {  // this warpgroup's copy of the query tile, scaled where it arrived
    scale_tiles(slot + HT::BYTES, HT::BYTES, a.s2, a.tid & 127, WG_THREADS);
    v5_wg_sync(a.wg);
  }
  fence_regs(s);
  wgmma_fence();
#pragma unroll
  for (int kc = 0; kc < HT::KSTEPS; ++kc)
    wgmma_ss<0>(s, HT::kmajor(q_s, kc), HT::kmajor(slot, kc), kc);
  wgmma_commit();
  wgmma_wait();
  fence_regs(s);
  v5_wg_sync(a.wg);  // this warpgroup is done with the slot
  if ((a.tid & 127) == 0 && v + V5_STAGES2 < f.n2) v5_load2<HD>(a, f, v + V5_STAGES2);

  const int h = v % a.H;
  const int tile = a.kt0 + 2 * (v / a.H) + a.wg;
  const int la = f.row - a.row0 + v5_row_a(a.tid & 127);
  const float c_a = v5_recip(a, h, la), c_b = v5_recip(a, h, la + 8);
  // e_frags's arithmetic one element at a time (no A fragments to hold):
  // the same bits; element i is in row b where i & 2
  const bool ragged = (tile + 1) * TILE > a.T;
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const float x = !ragged || tile * TILE + acc_col(i, a.tig) < a.T ? s[i] : -INFINITY;
    const float e = __bfloat162float(__float2bfloat16_rn(ex2(fminf(x - SHIFT, CLAMP))));
    acc[i] = __fadd_rn(acc[i], __fmul_rn(e, (i & 2) ? c_b : c_a));
  }
  if (h == a.H - 1) {  // every head summed: store this tile, start the next
    bf16* st = reinterpret_cast<bf16*>(a.region + v5_sweep2_bytes<HD>(a.H, a.resident)) -
               (2 - a.wg) * TILE * V5_STAGE_LD;
    const int lr = v5_row_a(a.tid & 127);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = j * 8 + a.tig * 2;
      *reinterpret_cast<uint32_t*>(st + lr * V5_STAGE_LD + c) =
          pack_bf16(__fdiv_rn(acc[4 * j], (float)a.H), __fdiv_rn(acc[4 * j + 1], (float)a.H));
      *reinterpret_cast<uint32_t*>(st + (lr + 8) * V5_STAGE_LD + c) =
          pack_bf16(__fdiv_rn(acc[4 * j + 2], (float)a.H), __fdiv_rn(acc[4 * j + 3], (float)a.H));
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] = 0.f;
    v5_wg_sync(a.wg);
    v5_store_tile(a, st, f.row, tile * TILE, mean);
  }
}

// One block = 128 query rows of one image (two warpgroups, 64 rows each);
// one cluster = the C ranks of those rows. Sweep 1: out of rank r's heads
// r, r + C, ...; sweep 2: the mean of rank r's chunk of the key tiles,
// from every head's recips.
template <int HD>
__global__ void __launch_bounds__(V5_THREADS, v5_blocks_per_sm<HD>())
attn_v5_batched(const __grid_constant__ CUtensorMap map_q, const __grid_constant__ CUtensorMap map_k,
                const __grid_constant__ CUtensorMap map_v, bf16* __restrict__ out,
                bf16* __restrict__ mean, float* __restrict__ work, int H, int T, float qscale,
                int resident) {
  using HT = HeadTile<HD>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  cg::cluster_group cl = cg::this_cluster();
  const int C = (int)cl.num_blocks(), rank = (int)cl.block_rank();
  const int nk = (T + TILE - 1) / TILE;
  V5Args a;
  a.region = smem;
  a.bars = reinterpret_cast<uint64_t*>(smem + v5_region_bytes<HD>(H, resident != 0));
  a.released = reinterpret_cast<uint32_t*>(a.bars + V5_NBARS);
  a.recip = reinterpret_cast<float*>(a.released + V5_STAGES);
  a.work = H <= V5_SMEM_RECIP_HEADS ? nullptr : work;
  a.map_q = &map_q;
  a.map_k = &map_k;
  a.map_v = &map_v;
  a.plane0 = blockIdx.z * H;
  a.row0 = blockIdx.y * V5_ROWS;
  a.kt0 = rank * nk / C;  // sweep 2, an even split: chunks differ by a tile at most
  a.n = (rank + 1) * nk / C - a.kt0;
  a.h0 = rank;  // sweep 1, heads round-robin
  a.hstep = C;
  a.nh = rank < H ? (H - 1 - rank) / C + 1 : 0;
  a.n1 = nk;
  a.H = H;
  a.T = T;
  a.tid = threadIdx.x;
  a.tig = threadIdx.x & 3;
  a.wg = threadIdx.x >> 7;
  a.resident = resident;
  a.s2 = __float2bfloat162_rn(qscale);
  if (a.tid == 0) {
    for (int i = 0; i < V5_NBARS; ++i) mbar_init(&a.bars[i], 1);
    for (int i = 0; i < V5_STAGES; ++i) a.released[i] = 0u;
    mbar_init_fence();
    if (a.nh > 0) v5_load_q1<HD>(a, a.h0);
    for (int u = 0; u < V5_STAGES && u < a.nh * a.n1; ++u) v5_load1<HD>(a, u);
  }
  __syncthreads();  // the barriers are initialised

  {  // ---- sweep 1: out, heads in turn
    float s[32], o[HD / 2];
    uint32_t pa[4][4];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = 0.f;
    for (int k = 0; k < a.nh; ++k) {  // this rank's k-th head
      const int h = a.h0 + k * a.hstep;
      mbar_wait(&a.bars[0], k & 1);
      scale_tiles(a.region, 2 * HT::BYTES, a.s2, a.tid, V5_THREADS);
      __syncthreads();
#pragma unroll
      for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;
      float sum_a = 0.f, sum_b = 0.f;
      const int u0 = k * a.n1;
      mbar_wait(&a.bars[1 + u0 % V5_STAGES], (u0 / V5_STAGES) & 1);
      const uint8_t* q_s = a.region + a.wg * HT::BYTES;
      const uint8_t* k_s = v5_slot1<HD>(a, u0);
      fence_regs(s);
      wgmma_fence();
#pragma unroll
      for (int kc = 0; kc < HT::KSTEPS; ++kc)
        wgmma_ss<0>(s, HT::kmajor(q_s, kc), HT::kmajor(k_s, kc), kc);
      wgmma_commit();
      wgmma_wait();
      fence_regs(s);
      for (int j = 0; j < a.n1; ++j) v5_step1<HD>(a, s, o, pa, sum_a, sum_b, u0 + j, j);
      v5_head_own<HD>(a, o, sum_a, sum_b, h, out);
    }
    // every rank takes the other ranks' recips (head h is rank h % C's)
    cl.sync();
    if (a.work == nullptr)
      for (int i = a.tid; i < H * V5_ROWS; i += V5_THREADS)
        if ((i / V5_ROWS) % C != rank) a.recip[i] = cl.map_shared_rank(a.recip, (i / V5_ROWS) % C)[i];
    cl.sync();  // no rank reads another's table any more
  }

  // ---- sweep 2: the mean of this rank's columns, one half of the rows at a time
  bf16* mb = mean + (size_t)blockIdx.z * T * T;
  float s[32], acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = acc[i] = 0.f;
  uint64_t* bar_q2 = &a.bars[V5_NBARS - 1];
  const int n2 = (a.n + 1 - a.wg) / 2 * H;  // this warpgroup's tiles kt0 + 2p + wg, every head
  for (int half = 0; half < 2; ++half) {
    const V5Half f{half * n2, n2, a.row0 + half * TILE};
    if (f.row >= T || a.n == 0) break;
    if (a.tid == 0 && resident) {
      mbar_expect_tx(bar_q2, H * HT::BYTES);
      for (int h = 0; h < H; ++h)
        HT::load(a.region + h * HT::BYTES, &map_q, bar_q2, f.row, a.plane0 + h);
    }
    if ((a.tid & 127) == 0)
      for (int v = 0; v < V5_STAGES2 && v < f.n2; ++v) v5_load2<HD>(a, f, v);
    if (resident) {
      mbar_wait(bar_q2, half & 1);
      scale_tiles(a.region, H * HT::BYTES, a.s2, a.tid, V5_THREADS);
      __syncthreads();
    }
    for (int v = 0; v < f.n2; ++v) v5_step2<HD>(a, f, s, acc, v, mb);
    __syncthreads();  // both warpgroups are done with this half's slots and query tiles
  }
}

// Key tiles per mean-pass block: the grid runs in waves of `slots`
// resident blocks, and a block costs its chunk plus about half a tile's
// worth for loading its query tiles. Short chunks keep the last wave
// short; ties go to the shorter chunk. At most max_chunk tiles.
int mean_chunk(int ntiles, int row_blocks, int slots, int max_chunk) {
  int best = 1;
  long best_cost = -1;
  for (int c = 1; c <= ntiles && c <= max_chunk; ++c) {
    const long blocks = (long)row_blocks * ((ntiles + c - 1) / c);
    const long cost = (blocks + slots - 1) / slots * (2 * c + 1);
    if (best_cost < 0 || cost < best_cost) {
      best = c;
      best_cost = cost;
    }
  }
  return best;
}

// Resident blocks of the mean-pass kernel (clamped or not, head dim HD)
// on the current device for `smem` bytes of shared memory per block: SMs x
// blocks per SM. The kernels may differ in registers, so each template
// instance keeps its own answers, asked once per (device, smem) and kept as
// smem << 20 | slots.
template <int HD, bool CLAMPED>
cudaError_t mean_slots(int smem, int* slots) {
  constexpr int MAX_DEVICES = 64;
  static std::atomic<long long> known[MAX_DEVICES];
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < MAX_DEVICES) {
    const long long k = known[dev].load(std::memory_order_relaxed);
    if (k > 0 && (k >> 20) == smem) {
      *slots = (int)(k & ((1 << 20) - 1));
      return cudaSuccess;
    }
  }
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, CLAMPED ? attn_var_mean<HD> : attn_var_mean_nomin<HD>, WG_THREADS, smem);
  if (err != cudaSuccess) return err;
  *slots = sms * (per_sm > 0 ? per_sm : 1);
  if (dev < MAX_DEVICES) known[dev].store(((long long)smem << 20) | *slots, std::memory_order_relaxed);
  return cudaSuccess;
}

int aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

cudaError_t max_shared(const void* kern, int bytes) {
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kern, cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  return err;
}

// v2, v3, v4 or v6 at head dim HD: the out pass, then the mean pass, on one
// stream. v6's V is (B, H, T, HD + 8), its ones in the last 8 columns.
template <int HD>
int hopper_variant(int variant, const void* q, const void* k, const void* v, void* out,
                   void* mean, void* recip, int B, int H, int T, float qscale,
                   cudaStream_t stream) {
  using HT = HeadTile<HD>;
  if (recip == nullptr || H < 1 || T < 1) return (int)cudaErrorInvalidValue;
  const void* out_kern;
  size_t osmem;
  switch (variant) {
    case 2: out_kern = (const void*)attn_v2_bf16e<HD>, osmem = out_smem<HD>(SUM_SHUFFLE); break;
    case 3: out_kern = (const void*)attn_v3_nomin<HD>, osmem = out_smem<HD>(SUM_SHUFFLE); break;
    case 4: out_kern = (const void*)attn_v4_mxsum<HD>, osmem = out_smem<HD>(SUM_MMA_ONES); break;
    case 6: out_kern = (const void*)attn_v6_fusedsum<HD>, osmem = out_smem<HD>(SUM_V_COLS); break;
    default: return (int)cudaErrorInvalidValue;
  }
  const bool clamped = variant != 3;
  const bool resident = mean_resident<HD>(H);
  const int msmem = (int)mean_smem<HD>(H, resident);
  // runtime calls first: they make the device's context current on this
  // thread, which the tensor-map encoding needs
  cudaError_t err = max_shared(out_kern, (int)osmem);
  if (err == cudaSuccess)
    err = max_shared(clamped ? (const void*)attn_var_mean<HD>
                             : (const void*)attn_var_mean_nomin<HD>, msmem);
  if (err != cudaSuccess) return (int)err;
  CUtensorMap mq, mk, mv, mc;
  if (int bad = HT::map(&mq, q, B * H, T)) return bad;
  if (int bad = HT::map(&mk, k, B * H, T)) return bad;
  if (variant == 6) {  // HD + 8 columns: the HD-column tiles, and the 8 columns from HD
    if (int bad = HT::map(&mv, v, B * H, T, HD + 8)) return bad;
    if (int bad = make_plane_map(&mc, v, B * H, T, HD + 8, 8, false)) return bad;
  } else {
    if (int bad = HT::map(&mv, v, B * H, T)) return bad;
    mc = mv;
  }
  if (!aligned16(out) || !aligned16(mean) || !aligned16(recip)) return TMA_MISALIGNED;
  dim3 grid((T + OUT_ROWS - 1) / OUT_ROWS, H, B);
  switch (variant) {
    case 2:
      attn_v2_bf16e<HD><<<grid, OUT_THREADS, osmem, stream>>>(mq, mk, mv, mc, (bf16*)out,
                                                              (float*)recip, H, T, qscale);
      break;
    case 3:
      attn_v3_nomin<HD><<<grid, OUT_THREADS, osmem, stream>>>(mq, mk, mv, mc, (bf16*)out,
                                                              (float*)recip, H, T, qscale);
      break;
    case 4:
      attn_v4_mxsum<HD><<<grid, OUT_THREADS, osmem, stream>>>(mq, mk, mv, mc, (bf16*)out,
                                                              (float*)recip, H, T, qscale);
      break;
    default:
      attn_v6_fusedsum<HD><<<grid, OUT_THREADS, osmem, stream>>>(mq, mk, mv, mc, (bf16*)out,
                                                                 (float*)recip, H, T, qscale);
  }
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  int slots = 0;
  if ((err = clamped ? mean_slots<HD, true>(msmem, &slots) : mean_slots<HD, false>(msmem, &slots)) !=
      cudaSuccess)
    return (int)err;
  const int ntiles = (T + TILE - 1) / TILE;
  const int chunk = mean_chunk(ntiles, B * ntiles, slots, VMEAN_MAX_CHUNK);
  dim3 mgrid((ntiles + chunk - 1) / chunk, ntiles, B);
  if (clamped)
    attn_var_mean<HD><<<mgrid, WG_THREADS, msmem, stream>>>(
        mq, mk, (const float*)recip, (bf16*)mean, H, T, qscale, chunk, resident ? 1 : 0);
  else
    attn_var_mean_nomin<HD><<<mgrid, WG_THREADS, msmem, stream>>>(
        mq, mk, (const float*)recip, (bf16*)mean, H, T, qscale, chunk, resident ? 1 : 0);
  return (int)cudaGetLastError();
}

// Clusters of C v5 blocks (head dim HD) with `smem` bytes each that the
// current device holds at once (cudaOccupancyMaxActiveClusters: every block
// of a cluster on one GPC), asked once per (device, C, smem) and kept as
// smem << 20 | n.
template <int HD>
cudaError_t v5_active(int C, int smem, int* n) {
  constexpr int MAX_DEVICES = 64;
  static std::atomic<long long> known[MAX_DEVICES][V5_MAX_CLUSTER + 1];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < MAX_DEVICES) {
    const long long k = known[dev][C].load(std::memory_order_relaxed);
    if (k > 0 && (k >> 20) == smem) {
      *n = (int)(k & ((1 << 20) - 1));
      return cudaSuccess;
    }
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(C, 64, 1);
  cfg.blockDim = dim3(V5_THREADS);
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if ((err = cudaOccupancyMaxActiveClusters(n, attn_v5_batched<HD>, &cfg)) != cudaSuccess)
    return err;
  if (dev < MAX_DEVICES) known[dev][C].store(((long long)smem << 20) | *n, std::memory_order_relaxed);
  return cudaSuccess;
}

// v5's shared memory at H heads, set as the kernel's limit (a runtime call
// first: the tensor-map encoding needs the device's context current)
template <int HD>
cudaError_t v5_prepare(int H, bool resident, int* smem) {
  *smem = (int)v5_smem<HD>(H, resident);
  return max_shared((const void*)attn_v5_batched<HD>, *smem);
}

// Blocks per cluster: V5_CLUSTER if set, else the C (at most 8, at most the
// key tiles) whose clusters finish in the fewest block lifetimes, counted
// as waves (v5_active clusters at once) times the tile steps a block runs:
// sweep 1, ceil(H / C) nk (whole heads); sweep 2, H ceil(nk / C); ties go
// to the smaller C.
template <int HD>
cudaError_t v5_cluster(int B, int H, int T, int smem, int* cluster) {
  if (V5_CLUSTER > 0) {
    *cluster = V5_CLUSTER;
    return cudaSuccess;
  }
  const int nk = (T + TILE - 1) / TILE;
  const long tiles = (long)B * ((T + V5_ROWS - 1) / V5_ROWS);
  long best = -1;
  for (int c = 1; c <= V5_MAX_CLUSTER && c <= nk; ++c) {
    int active = 0;
    cudaError_t err = v5_active<HD>(c, smem, &active);
    if (err != cudaSuccess) return err;
    if (active < 1) continue;
    const long chunk = (nk + c - 1) / c;
    const long cost = (tiles + active - 1) / active * ((H + c - 1) / c * nk + H * chunk);
    if (best < 0 || cost < best) {
      best = cost;
      *cluster = c;
    }
  }
  return best < 0 ? cudaErrorInvalidConfiguration : cudaSuccess;
}

// v5 at head dim HD: one launch on a grid of (C, ceil(T / 128), B) blocks
// in clusters of C; `work` (B, H, T) f32 holds the recips above
// V5_SMEM_RECIP_HEADS heads
template <int HD>
int v5_forward(const void* q, const void* k, const void* v, void* out, void* mean, void* work,
               int B, int H, int T, float qscale, cudaStream_t stream) {
  using HT = HeadTile<HD>;
  if (H < 1 || T < 1 || work == nullptr) return (int)cudaErrorInvalidValue;
  const bool resident = v5_resident<HD>(H);
  int smem = 0, C = 0;
  cudaError_t err = v5_prepare<HD>(H, resident, &smem);
  if (err == cudaSuccess) err = v5_cluster<HD>(B, H, T, smem, &C);
  if (err != cudaSuccess) return (int)err;
  CUtensorMap mq, mk, mv;
  if (int bad = HT::map(&mq, q, B * H, T)) return bad;
  if (int bad = HT::map(&mk, k, B * H, T)) return bad;
  if (int bad = HT::map(&mv, v, B * H, T)) return bad;
  if (!aligned16(out) || !aligned16(mean) || !aligned16(work)) return TMA_MISALIGNED;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(C, (T + V5_ROWS - 1) / V5_ROWS, B);
  cfg.blockDim = dim3(V5_THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, attn_v5_batched<HD>, mq, mk, mv, (bf16*)out, (bf16*)mean,
                           (float*)work, H, T, qscale, resident ? 1 : 0);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// the cluster size v5_forward<HD> launches at (B, H, T), or minus the
// cudaError_t that stops it
template <int HD>
int v5_cluster_size(int B, int H, int T) {
  int smem = 0, C = 0;
  cudaError_t err = v5_prepare<HD>(H, v5_resident<HD>(H), &smem);
  if (err == cudaSuccess) err = v5_cluster<HD>(B, H, T, smem, &C);
  return err == cudaSuccess ? C : -(int)err;
}

// ------------------------------------------------ the wide route (d > 128)
//
// Head dims above 128, zero-padded by ops/attention_variants.py to KD = 128
// ceil(d / 128) (wide_head_dim of hopper.cuh), with the true d's bf16 scale
// and, for v6, the 8 ones columns after KD. A head row is NS = KD / 128
// slabs of 128 columns, slab s the Slab (HeadTile<128>) at column 128 s of
// a tensor map over the whole row. Every tile arrives by TMA on an
// mbarrier ring that a producer warp keeps full, and every product is a
// wgmma. The host's plan (wide_plan: exported as attn_wide_plan, mirrored
// by ops/attention_variants.py::wide_variant_plan) sizes all three kernels.
//   out pass   attn_v2_wide, attn_v3_wide, attn_v4_wide, attn_v6_wide
//              (templates on W, the consumer warpgroups of a block): one
//              block per (64 query rows, group of G = W output slabs, image
//              and head); warpgroup c keeps O of slab c of the group in
//              registers (64 f32 a thread). Q stays in shared memory for
//              the whole block, scaled once; where it does not fit beside
//              a ring of W_MIN_SLOTS, it streams through the ring beside K
//              instead. S of key tile j is computed once per group, by
//              warpgroup j % G, over every slab (NS x 8 k16 steps into one
//              accumulator, one chain of products where the ring holds the
//              tile's slabs at once: the mean pass's order, so both passes
//              get the same e bits), one tile ahead of the PV products, so
//              that one warpgroup's S and exp work runs beside the others'
//              products. The owner rounds e to bf16, adds its row sums and
//              writes e into a swizzled 8 KB tile (W_E_SLOTS of them), from
//              which every warpgroup takes O_c += e V_c (m64n128k16, both
//              operands in shared memory). The ring's entries are 16 KB
//              slabs in the order the warpgroups use them, K of tile j + 1
//              before V of tile j; every warpgroup passes every entry in
//              order (a wait on a barrier's parity is sound only on the
//              phase after the one its thread last saw complete), giving
//              back at once those it does not use.
//              Row sums: v2 and v3 add the bf16 e in f32; v4 multiplies e
//              by a 1 KB operand of bf16 ones (m64n8k16); v6 by V's columns
//              KD .. KD + 7, an 8-column TMA box that arrives with K's last
//              slab. Each warpgroup adds up its own key tiles; the G partial
//              sums of a row are then added in warpgroup order through
//              shared memory, so every slab of a row divides by the same
//              bits, and so do the blocks of the other slab groups (their
//              warpgroups own the same key tiles). Slab 0 writes the recip
//              into the (B, H, T) workspace.
//              Registers: an SM's file is four sub-partitions of 16,384, a
//              warp's on one, so a block of W warpgroups and the producer
//              warp (4 W + 1 warps) leaves 168 registers a thread at W = 2
//              and 128 at W = 3; at W = 4, 96, where ptxas serializes the
//              products (C7512). So G is at most 3: NS = 2 and 3 take one
//              group, NS = 4 two of two, above ceil(NS / 3) groups, S
//              computed once per group.
//   mean pass  attn_var_mean_wide (v3: attn_var_mean_nomin_wide): one block
//              = two warpgroups (128 query rows) and a producer warp per
//              (chunk of key tiles, row pair, image), two blocks per SM;
//              units (key tile, head) in head order, each NS entries of (K
//              slab, the two row tiles' Q slabs) through a two-entry ring,
//              each Q slab scaled where it arrived; S by wgmma over the
//              slabs in the out pass's order, then e * (recip_h * (1 / H))
//              added in head order (__fmul_rn, __fadd_rn) and each mean
//              tile stored once.
//   v5         attn_v5_wide<W>, one launch on clusters of C blocks: grid
//              (C, ceil(T / 64), B). Sweep 1: rank r takes heads r, r + C,
//              ... and runs the out pass's body (v2's arithmetic) for each
//              head and slab group, writing out and the recips into the
//              workspace; a cluster barrier; sweep 2: rank r takes its key
//              chunk over every head with the mean pass's body, on
//              `lanes` warpgroups, each with a ring and a producer lane of
//              its own, the head sum divided by H once (__fdiv_rn).
// Generic writes to shared memory that the async proxy reads (the scaled
// Q, the e tiles) are fenced with fence.proxy.async.shared::cta: the form
// of every state space waits for the block's TMA reads in flight.
// What holds the route (PERF.md, section 6): two or three warpgroups an SM
// (the register file), each running its chain of products, its exp work
// and its ring waits one after another. Fewer bytes did not help: two
// query tiles sharing each K and V slab (TMA multicast on clusters of two)
// and mean units of two key tiles were both slower. No atomics and no sum
// split in an order that changes between runs: two calls agree bit for
// bit.

constexpr int SLAB = Slab::BYTES;    // one 64-row slab of 128 columns: 16 KB
constexpr int W_MAX_WARPGROUPS = 3;  // out pass: consumer warpgroups (slabs) a block, at most
constexpr int W_E_SLOTS = 2;         // out pass: e tiles (S runs a tile ahead)
constexpr int W_MIN_SLOTS = 4;       // out pass: fewer ring slots beside a resident Q: Q streams
constexpr int W_MAX_SLOTS = 16;      // out pass: ring slots, at most
constexpr int WM_ROWS = 2;           // mean pass: query row tiles a block, a warpgroup each
constexpr int WM_SLOTS = 2;          // mean pass: ring entries
constexpr int WM_BLOCKS_PER_SM = 2;
constexpr int WM_MAX_CHUNK = 16;     // mean pass: key tiles a block, at most
constexpr int W5_SLOTS = 2;          // v5's sweep 2: ring entries a lane
constexpr int W5_MAX_CLUSTER = 4;    // v5: blocks a cluster, at most (a GPC holds 16 or 18 of
                                     // these one-per-SM blocks: larger clusters leave SMs idle)
constexpr int W_PRODUCER = 32;       // the producer warp, after the consumer warpgroups
constexpr int W_SMEM_LIMIT = 232448;  // what a block may use (227 KB)
constexpr int W_ALIGN = 1024;         // reserved for the 1024-byte alignment of the slots
constexpr int W_RED_BYTES = W_MAX_WARPGROUPS * TILE * (int)sizeof(float);  // row sums
constexpr int W_BAR_BYTES = 512;                                          // mbarriers
constexpr int W_TAIL = W_RED_BYTES + W_BAR_BYTES;
constexpr int WM_THREADS = WM_ROWS * WG_THREADS + W_PRODUCER;

// the plan of one call, as attn_wide_plan exports it (20 ints); a block of
// the out pass and of v5 holds `slabs` consumer warpgroups
struct WidePlan {
  int sms, slabs, groups, qstream, slots, out_smem, out_x, out_y, out_z;
  int chunk, mean_smem, mean_x, mean_y, mean_z;
  int cluster, lanes, v5_smem, v5_x, v5_y, v5_z;
};
constexpr int WIDE_PLAN_INTS = 20;
static_assert(sizeof(WidePlan) == WIDE_PLAN_INTS * sizeof(int), "the plan is 20 ints");

// the out pass's ring slot: a 16 KB slab (v6: and the 1 KB column box)
int wide_slot_bytes(int variant) { return SLAB + (variant == 6 ? COLS_BYTES : 0); }

// The out pass's block at NS slabs: its slabs (= warpgroups), slab groups,
// whether Q streams, ring slots, and its shared memory (the region from the
// aligned base to the row sums, and in all)
struct WideShape {
  int slabs, groups, qstream, slots, region, smem;
};

WideShape wide_shape(int NS, int variant) {
  WideShape s{};
  const int ng = (NS + W_MAX_WARPGROUPS - 1) / W_MAX_WARPGROUPS;
  s.slabs = (NS + ng - 1) / ng;
  s.groups = (NS + s.slabs - 1) / s.slabs;
  const int slot = wide_slot_bytes(variant);
  for (int qs = 0; qs < 2; ++qs) {  // Q resident, else streamed
    const long fixed = (qs ? 0L : (long)NS * SLAB) + (long)W_E_SLOTS * TILE_BYTES +
                       (variant == 4 ? ONES_BYTES : 0);
    const long room = ((long)W_SMEM_LIMIT - W_ALIGN - W_TAIL - fixed) / slot;
    s.qstream = qs;
    s.slots = (int)(room < W_MAX_SLOTS ? room : W_MAX_SLOTS);
    s.region = (int)(fixed + (long)s.slots * slot);
    if (s.slots >= W_MIN_SLOTS) break;
  }
  s.smem = W_ALIGN + s.region + W_TAIL;
  return s;
}

// The plan at (B, H, T, KD) for `variant` on `sms` SMs. The mean pass's
// chunk as mean_chunk picks it for two blocks per SM. v5's cluster size C
// (at most 4, at most the key tiles): the fewest waves (sms / C clusters at
// once, one block per SM) times the slab products of a block's warpgroup,
// sweep 1 (ceil(H / C) heads, every group and key tile: NS for S and G for
// PV, on G warpgroups) and sweep 2 (ceil(nk / C) key tiles over `lanes`
// lanes, every head, NS each); ties go to the smaller C.
WidePlan wide_plan(int B, int H, int T, int KD, int variant, int sms) {
  WidePlan p{};
  const int NS = KD / SLAB_COLS, nk = (T + TILE - 1) / TILE;
  const WideShape s = wide_shape(NS, variant);
  p.sms = sms;
  p.slabs = s.slabs;
  p.groups = s.groups;
  p.qstream = s.qstream;
  p.slots = s.slots;
  p.out_smem = s.smem;
  p.out_x = nk;
  p.out_y = s.groups;
  p.out_z = B * H;
  const int pairs = (T + WM_ROWS * TILE - 1) / (WM_ROWS * TILE);
  p.chunk = mean_chunk(nk, B * pairs, sms * WM_BLOCKS_PER_SM, WM_MAX_CHUNK);
  p.mean_smem = W_ALIGN + WM_SLOTS * (1 + WM_ROWS) * SLAB + W_TAIL;
  p.mean_x = (nk + p.chunk - 1) / p.chunk;
  p.mean_y = pairs;
  p.mean_z = B;
  const WideShape f = wide_shape(NS, 2);  // v5's sweep 1 has v2's arithmetic
  const int by_room = f.region / (W5_SLOTS * 2 * SLAB);
  p.lanes = f.slabs < by_room ? f.slabs : by_room;
  p.v5_smem = f.smem;
  long best = -1;
  for (int c = 1; c <= W5_MAX_CLUSTER && c <= nk; ++c) {
    const long active = sms / c > 0 ? sms / c : 1;
    const long waves = ((long)B * nk + active - 1) / active;
    const long s1 = (long)((H + c - 1) / c) * f.groups * nk * (NS + f.slabs);
    const long s2 = (long)H * (((nk + c - 1) / c + p.lanes - 1) / p.lanes) * NS * f.slabs;
    const long cost = waves * (s1 + s2);
    if (best < 0 || cost < best) {
      best = cost;
      p.cluster = c;
    }
  }
  p.v5_x = p.cluster;
  p.v5_y = nk;
  p.v5_z = B;
  return p;
}

// what the kernels take of the plan
struct WideArgs {
  int NS, G, groups, slots, qstream, lanes, chunk, H, T;
};

// the consumer warpgroups of a block only (the producer warp not): named barrier 1
__device__ __forceinline__ void consumers_sync(int nthreads) {
  asm volatile("bar.sync 1, %0;\n" ::"r"(nthreads) : "memory");
}

// one warpgroup's 128 threads: named barrier 2 + w
__device__ __forceinline__ void warpgroup_sync(int w) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(2 + w) : "memory");
}

// generic writes to shared memory made visible to this block's async proxy
// (wgmma, TMA): the shared::cta form of fence.proxy.async. (The form of
// every state space waits for the block's TMA reads of global memory in
// flight: 10-25 % of the route's time at the tool's shape, PERF.md §6.)
__device__ __forceinline__ void fence_async_cta() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// scale_tiles with that fence
__device__ __forceinline__ void scale_slabs(uint8_t* p, int bytes, __nv_bfloat162 s2, int tid,
                                            int nthreads) {
  for (int i = tid * 16; i < bytes; i += nthreads * 16) {
    uint4 x = *reinterpret_cast<uint4*>(p + i);
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&x);
#pragma unroll
    for (int j = 0; j < 4; ++j) h[j] = __hmul2(h[j], s2);
    *reinterpret_cast<uint4*>(p + i) = x;
  }
  fence_async_cta();
}

// A ring of `slots` slots of `bytes`; entry n lives in slot n % slots. The
// producer claims an entry (waits until the entry `slots` before it was
// freed, arms the slot's barrier for the entry's bytes), its consumers
// take it (wait for the bytes) and give it back (every consumer thread
// arrives once: the "empty" barrier counts them).
struct WRing {
  uint8_t* base;
  uint64_t* full;
  uint64_t* empty;
  int slots, bytes;

  __device__ __forceinline__ uint64_t* bar(int n) const { return &full[n % slots]; }
  __device__ __forceinline__ uint8_t* slot(int n) const { return base + (n % slots) * bytes; }
  __device__ __forceinline__ uint8_t* claim(int n, int tx) const {
    const int st = n % slots;
    if (n >= slots) mbar_wait(&empty[st], ((n / slots) - 1) & 1);
    mbar_expect_tx(&full[st], tx);
    return base + st * bytes;
  }
  __device__ __forceinline__ uint8_t* take(int n) const {
    const int st = n % slots;
    mbar_wait(&full[st], (n / slots) & 1);
    return base + st * bytes;
  }
  __device__ __forceinline__ void give(int n) const { mbar_arrive(&empty[n % slots]); }
};

// ------------------------------------------------ wide out pass, the body

struct WOut {
  WRing ring;
  uint8_t* q;     // resident Q: slab s at s SLAB, scaled
  uint8_t* e;     // e tiles, slot i at i TILE_BYTES
  uint8_t* ones;  // v4's B operand
  float* red;     // (G, 64): each warpgroup's row sums
  uint64_t* efull;   // [i]: the owner wrote the tile (its 128 threads)
  uint64_t* eempty;  // [i]: the G warpgroups are done with it
  uint64_t* qfull;   // the resident Q arrived (once per item)
  uint64_t* qempty;  // every consumer thread is done with it
  const CUtensorMap* mq;
  const CUtensorMap* mk;
  const CUtensorMap* mv;
  const CUtensorMap* mc;  // v6: V's columns KD .. KD + 7
  int NS, G, qs, nk, T;
};

// Shared memory of the out pass (and of v5's sweep 1), from the aligned
// base: Q | e tiles | v4's ones | ring | row sums | barriers
template <int SUM>
__device__ __forceinline__ WOut wout_layout(uint8_t* smem, const WideArgs& a) {
  WOut w;
  w.NS = a.NS;
  w.G = a.G;
  w.qs = a.qstream;
  w.nk = (a.T + TILE - 1) / TILE;
  w.T = a.T;
  w.q = smem;
  w.e = smem + (w.qs ? 0 : w.NS * SLAB);
  w.ones = w.e + W_E_SLOTS * TILE_BYTES;
  w.ring.base = w.ones + (SUM == SUM_MMA_ONES ? ONES_BYTES : 0);
  w.ring.slots = a.slots;
  w.ring.bytes = SLAB + (SUM == SUM_V_COLS ? COLS_BYTES : 0);
  w.red = reinterpret_cast<float*>(w.ring.base + a.slots * w.ring.bytes);
  uint64_t* bars = reinterpret_cast<uint64_t*>(reinterpret_cast<uint8_t*>(w.red) + W_RED_BYTES);
  w.ring.full = bars;
  w.ring.empty = bars + a.slots;
  w.efull = bars + 2 * a.slots;
  w.eempty = w.efull + W_E_SLOTS;
  w.qfull = w.eempty + W_E_SLOTS;
  w.qempty = w.qfull + 1;
  return w;
}

// the barriers' counts (one thread): every consumer thread passes every
// ring entry
__device__ __forceinline__ void wout_init(const WOut& w) {
  for (int i = 0; i < w.ring.slots; ++i) {
    mbar_init(&w.ring.full[i], 1);
    mbar_init(&w.ring.empty[i], w.G * WG_THREADS);
  }
  for (int i = 0; i < W_E_SLOTS; ++i) {
    mbar_init(&w.efull[i], WG_THREADS);
    mbar_init(&w.eempty[i], w.G * WG_THREADS);
  }
  mbar_init(w.qfull, 1);
  mbar_init(w.qempty, w.G * WG_THREADS);
}

// An item's entries, from its first on: step t = 0 .. nk holds K of tile t
// (t < nk; NS entries, or NS (Q, K) pairs where Q streams), then V of tile
// t - 1 (t > 0; the item's nsl output slabs). First entry of tile t's K:
__device__ __forceinline__ int wk_entry(const WOut& w, int nsl, int t) {
  return t * (w.NS * (1 + w.qs) + nsl) - (t > 0 ? nsl : 0);
}
// ... and of tile t's V
__device__ __forceinline__ int wv_entry(const WOut& w, int nsl, int t) {
  const int ku = w.NS * (1 + w.qs);
  return (t + 1) * (ku + nsl) - nsl + (t + 1 < w.nk ? ku : 0);
}

// The producer thread, one item: (head plane, slabs g0 .. g0 + nsl - 1,
// query rows from row0), its entries numbered from n0
template <int SUM>
__device__ void wout_produce(const WOut& w, int item, int plane, int g0, int nsl, int row0,
                             int n0) {
  if (!w.qs) {
    if (item > 0) mbar_wait(w.qempty, (item - 1) & 1);
    mbar_expect_tx(w.qfull, w.NS * SLAB);
    for (int s = 0; s < w.NS; ++s)
      Slab::load(w.q + s * SLAB, w.mq, w.qfull, row0, plane, s * SLAB_COLS);
  }
  int n = n0;
  for (int t = 0; t <= w.nk; ++t) {
    if (t < w.nk)
      for (int s = 0; s < w.NS; ++s) {
        if (w.qs) {
          uint8_t* slot = w.ring.claim(n, SLAB);
          Slab::load(slot, w.mq, w.ring.bar(n), row0, plane, s * SLAB_COLS);
          ++n;
        }
        const bool cols = SUM == SUM_V_COLS && s == w.NS - 1;
        uint8_t* slot = w.ring.claim(n, SLAB + (cols ? COLS_BYTES : 0));
        Slab::load(slot, w.mk, w.ring.bar(n), t * TILE, plane, s * SLAB_COLS);
        if (cols)
          tma_load_box(slot + SLAB, w.mc, w.ring.bar(n), w.NS * SLAB_COLS, t * TILE, plane);
        ++n;
      }
    if (t > 0)
      for (int c = 0; c < nsl; ++c) {
        uint8_t* slot = w.ring.claim(n, SLAB);
        Slab::load(slot, w.mv, w.ring.bar(n), (t - 1) * TILE, plane, (g0 + c) * SLAB_COLS);
        ++n;
      }
  }
}

// A warpgroup's e fragments (e_frags's layout) into a 64 x 64 bf16 tile of
// the tile convention (128-byte rows under the 128-byte swizzle): wgmma's
// K-major A operand. Eight rows of a warp's store land on eight chunks of
// the swizzle, so the 32 lanes hit 32 banks.
__device__ __forceinline__ void store_e(uint8_t* tile, const uint32_t (&pa)[4][4], int lt) {
  const int ra = ((lt >> 5) & 3) * 16 + ((lt & 31) >> 2), tig = lt & 3;
#pragma unroll
  for (int kc = 0; kc < 4; ++kc)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      *reinterpret_cast<uint32_t*>(
          tile + swz128(ra + 8 * (i & 1), 16 * kc + 8 * (i >> 1) + 2 * tig)) = pa[kc][i];
}

// Entries from the cursor nc up to (not with) n that this warpgroup does
// not use: taken and given back at once
__device__ __forceinline__ void wout_pass(const WOut& w, int& nc, int n) {
  for (; nc < n; ++nc) {
    w.ring.take(nc);
    w.ring.give(nc);
  }
}

// the entry n that this warpgroup uses, past the ones before it
__device__ __forceinline__ uint8_t* wout_take(const WOut& w, int& nc, int n) {
  wout_pass(w, nc, n);
  nc = n + 1;
  return w.ring.take(n);
}

// Takes the entries n .. m of the ring (a streamed Q slab, at an even
// offset from `first`, scaled where it arrived)
__device__ __forceinline__ void wout_take_run(const WOut& w, int& nc, int first, int n, int m,
                                              int lt, int wg, __nv_bfloat162 s2) {
  for (int i = n; i <= m; ++i) {
    uint8_t* slot = wout_take(w, nc, i);
    if (w.qs && ((i - first) & 1) == 0) scale_slabs(slot, SLAB, s2, lt, WG_THREADS);
  }
  if (w.qs) warpgroup_sync(wg);
}

// S += Q K^T of slab sl, whose entries start at nq (Q, where it streams)
__device__ __forceinline__ void wout_slab_products(const WOut& w, float (&s)[32], int sl, int nq) {
  const uint8_t* qt = w.qs ? w.ring.slot(nq) : w.q + sl * SLAB;
  const uint8_t* kt = w.ring.slot(nq + w.qs);
#pragma unroll
  for (int kc = 0; kc < Slab::KSTEPS; ++kc)
    wgmma_ss<0>(s, Slab::kmajor(qt, kc), Slab::kmajor(kt, kc), sl | kc);
}

// S of key tile t into s, from entry n on, every slab in order: one chain
// of products waited once where the ring holds all the tile's entries at
// once, else one chain a slab. Gives the entries back once their products
// are done; v6's last K slab stays taken (its column box is read next):
// returned, with its entry in `held`.
template <int SUM>
__device__ __forceinline__ const uint8_t* wout_scores(const WOut& w, float (&s)[32], int n,
                                                      int& nc, int lt, int wg, __nv_bfloat162 s2,
                                                      int& held) {
  const int ku = w.NS * (1 + w.qs), last = n + ku - 1;
  if (ku <= w.ring.slots) {
    wout_take_run(w, nc, n, n, last, lt, wg, s2);
    fence_regs(s);
    wgmma_fence();
    for (int sl = 0; sl < w.NS; ++sl) wout_slab_products(w, s, sl, n + sl * (1 + w.qs));
    wgmma_commit();
    wgmma_wait();
    fence_regs(s);
    for (int i = n; i < last; ++i) w.ring.give(i);
  } else {
    for (int sl = 0; sl < w.NS; ++sl) {
      const int nq = n + sl * (1 + w.qs);
      wout_take_run(w, nc, n, nq, nq + w.qs, lt, wg, s2);
      fence_regs(s);
      wgmma_fence();
      wout_slab_products(w, s, sl, nq);
      wgmma_commit();
      wgmma_wait();
      fence_regs(s);
      for (int i = nq; i < nq + w.qs + (sl + 1 < w.NS); ++i) w.ring.give(i);
    }
  }
  if (SUM == SUM_V_COLS) {
    held = last;
    return w.ring.slot(last);
  }
  w.ring.give(last);
  return nullptr;
}

// Key tile t, by its owner: S, e into e tile t (once the warpgroups are
// done with the tile that used its slot before), and this warpgroup's part
// of the row sums
template <int SUM, bool CLAMPED>
__device__ __forceinline__ void wout_own(const WOut& w, float (&rs)[4], float& sum_a,
                                         float& sum_b, int t, int n, int& nc, int eu, int lt,
                                         int wg, __nv_bfloat162 s2) {
  float s[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = 0.f;
  int held = 0;
  const uint8_t* last = wout_scores<SUM>(w, s, n, nc, lt, wg, s2, held);
  uint32_t pa[4][4];
  e_frags<CLAMPED>(pa, s, t * TILE, w.T, lt & 3);
  const int es = eu % W_E_SLOTS;
  if (eu >= W_E_SLOTS) mbar_wait(&w.eempty[es], ((eu / W_E_SLOTS) - 1) & 1);
  store_e(w.e + es * TILE_BYTES, pa, lt);
  fence_async_cta();
  mbar_arrive(&w.efull[es]);
  if constexpr (SUM == SUM_SHUFFLE) {
#pragma unroll
    for (int kc = 0; kc < 4; ++kc) {
      sum_a += (bf_lo(pa[kc][0]) + bf_hi(pa[kc][0])) + (bf_lo(pa[kc][2]) + bf_hi(pa[kc][2]));
      sum_b += (bf_lo(pa[kc][1]) + bf_hi(pa[kc][1])) + (bf_lo(pa[kc][3]) + bf_hi(pa[kc][3]));
    }
  } else {
    fence_regs4(rs);
    fence_regs(pa);
    wgmma_fence();
#pragma unroll
    for (int kc = 0; kc < 4; ++kc) {
      if constexpr (SUM == SUM_MMA_ONES)
        wgmma_rs_n8<0>(rs, pa[kc], desc_kmajor(w.ones, 0), 1);
      else
        wgmma_rs_n8<1>(rs, pa[kc], desc_cols(last + SLAB, kc), 1);
    }
    wgmma_commit();
    wgmma_wait();
    fence_regs4(rs);
    fence_regs(pa);
    if constexpr (SUM == SUM_V_COLS) w.ring.give(held);
  }
}

// One item for warpgroup c of W: (head plane, slabs g0 .., rows from row0),
// its entries from n0 on, its e tiles counted from e0 on. O of slab g0 + c
// (if the item has it), S of the key tiles t with t % G == c, one tile
// ahead; then the row sums over the warpgroups in order, out and (slab 0)
// the recips.
template <int SUM, bool CLAMPED>
__device__ void wout_consume(const WOut& w, int W, int item, int plane, int g0, int nsl,
                             int row0, int n0, int e0, int c, bf16* __restrict__ out,
                             float* __restrict__ recip, __nv_bfloat162 s2) {
  const int ct = threadIdx.x, lt = ct & 127, tig = ct & 3, wg = ct >> 7;
  const int la = ((lt >> 5) & 3) * 16 + ((lt & 31) >> 2);
  if (!w.qs) {
    mbar_wait(w.qfull, item & 1);
    scale_slabs(w.q, w.NS * SLAB, s2, ct, W * WG_THREADS);
    consumers_sync(W * WG_THREADS);
  }
  float o[64], rs[4] = {0.f, 0.f, 0.f, 0.f};
  float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
  for (int i = 0; i < 64; ++i) o[i] = 0.f;
  // Tile t's K entries: its owner's S; the other warpgroups pass them
  // before they wait for an e tile, so that a ring shorter than NS slabs
  // still fills
  const int ku = w.NS * (1 + w.qs);
  int nc = n0;  // the next ring entry this warpgroup passes
  auto tile_k = [&](int t) {
    if (t % w.G == c)
      wout_own<SUM, CLAMPED>(w, rs, sum_a, sum_b, t, n0 + wk_entry(w, nsl, t), nc, e0 + t, lt, wg,
                             s2);
    else
      wout_pass(w, nc, n0 + wk_entry(w, nsl, t) + ku);
  };
  tile_k(0);
  for (int j = 0; j < w.nk; ++j) {
    if (j + 1 < w.nk) tile_k(j + 1);
    const int eu = e0 + j, es = eu % W_E_SLOTS;
    mbar_wait(&w.efull[es], (eu / W_E_SLOTS) & 1);
    if (c < nsl) {
      const int nv = n0 + wv_entry(w, nsl, j) + c;
      const uint8_t* vt = wout_take(w, nc, nv);
      const uint8_t* et = w.e + es * TILE_BYTES;
      fence_regs(o);
      wgmma_fence();
#pragma unroll
      for (int kc = 0; kc < 4; ++kc)
        wgmma_ss<1>(o, desc_kmajor(et, kc), Slab::mnmajor(vt, kc), 1);
      wgmma_commit();
      wgmma_wait();
      fence_regs(o);
      w.ring.give(nv);
    }
    mbar_arrive(&w.eempty[es]);
    // past every V slab of tile j, so that a warpgroup without a slab (the
    // last group's) does not hold the ring until its next S
    wout_pass(w, nc, n0 + wv_entry(w, nsl, j) + nsl);
  }

  if constexpr (SUM == SUM_SHUFFLE) {
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      sum_a += __shfl_xor_sync(0xffffffffu, sum_a, off);
      sum_b += __shfl_xor_sync(0xffffffffu, sum_b, off);
    }
  } else if constexpr (SUM == SUM_V_COLS) {  // column KD: the quad's first thread holds it
    const int lead = ct & 28;
    sum_a = __shfl_sync(0xffffffffu, rs[0], lead);
    sum_b = __shfl_sync(0xffffffffu, rs[2], lead);
  } else {  // every column of e @ ones is the row sum
    sum_a = rs[0];
    sum_b = rs[2];
  }
  if (tig == 0) {
    w.red[c * TILE + la] = sum_a;
    w.red[c * TILE + la + 8] = sum_b;
  }
  consumers_sync(W * WG_THREADS);
  float ta = w.red[la], tb = w.red[la + 8];
  for (int i = 1; i < w.G; ++i) {  // the warpgroups in order: the same bits in every slab
    ta += w.red[i * TILE + la];
    tb += w.red[i * TILE + la + 8];
  }
  const float inv_a = 1.f / fmaxf(ta, 1e-30f), inv_b = 1.f / fmaxf(tb, 1e-30f);
  const int r_a = row0 + la, r_b = r_a + 8, KD = w.NS * SLAB_COLS;
  if (c < nsl) {
    bf16* oh = out + (size_t)plane * w.T * KD + (g0 + c) * SLAB_COLS;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int col = j * 8 + tig * 2;
      if (r_a < w.T)
        *reinterpret_cast<uint32_t*>(oh + (size_t)r_a * KD + col) =
            pack_bf16(o[4 * j] * inv_a, o[4 * j + 1] * inv_a);
      if (r_b < w.T)
        *reinterpret_cast<uint32_t*>(oh + (size_t)r_b * KD + col) =
            pack_bf16(o[4 * j + 2] * inv_b, o[4 * j + 3] * inv_b);
    }
  }
  if (c == 0 && g0 == 0 && tig == 0) {
    float* rh = recip + (size_t)plane * w.T;
    if (r_a < w.T) rh[r_a] = inv_a;
    if (r_b < w.T) rh[r_b] = inv_b;
  }
  mbar_arrive(w.qempty);
  consumers_sync(W * WG_THREADS);  // the row sums are read before the next item writes them
}

// ------------------------------------------------ wide mean pass, the body

// A lane's ring; entry n = slab n % NS of unit n / NS; unit u = the lane's
// key tile u / H, head u % H. An entry holds K's slab, then the Q slab of
// each of the lane's R row tiles.
struct WMean {
  WRing ring;
  int NS, R, H, T;
};

// the lane's producer: `ntiles` key tiles kt0, kt0 + kstep, ... of image b,
// rows from row0
__device__ void wmean_produce(const WMean& m, const CUtensorMap* mq, const CUtensorMap* mk,
                              int b, int row0, int kt0, int kstep, int ntiles) {
  int n = 0;
  for (int p = 0; p < ntiles; ++p)
    for (int h = 0; h < m.H; ++h)
      for (int s = 0; s < m.NS; ++s, ++n) {
        uint8_t* slot = m.ring.claim(n, (1 + m.R) * SLAB);
        const int plane = b * m.H + h;
        Slab::load(slot, mk, m.ring.bar(n), (kt0 + p * kstep) * TILE, plane, s * SLAB_COLS);
        for (int r = 0; r < m.R; ++r)
          Slab::load(slot + (1 + r) * SLAB, mq, m.ring.bar(n), row0 + r * TILE, plane,
                     s * SLAB_COLS);
      }
}

// e of accumulator entry i of S (e_frags's arithmetic one element at a
// time: the same bits), 0 for a key past T
template <bool CLAMPED>
__device__ __forceinline__ float e_at(float s, bool valid) {
  const float x = valid ? s : -INFINITY;
  return __bfloat162float(__float2bfloat16_rn(ex2(CLAMPED ? fminf(x - SHIFT, CLAMP) : x - SHIFT)));
}

// Row tile r of the lane, warpgroup wg: per unit, S over the slabs (the out
// pass's order), e, acc += e * c_h in head order (the product, then the
// sum: no FMA), c_h = recip_h / H (v2, v3, v4, v6) or recip_h (v5, whose
// sum is divided by H once before the store); each mean tile stored after
// its last head. `recip`: the image's (H, T), `mean` its (T, T).
template <bool CLAMPED, bool V5>
__device__ void wmean_consume(const WMean& m, int r, int wg, const float* recip,
                              bf16* __restrict__ mean, int row0, int kt0, int kstep, int ntiles,
                              __nv_bfloat162 s2) {
  const int lt = threadIdx.x & 127, tig = lt & 3;
  const int r_a = row0 + r * TILE + ((lt >> 5) & 3) * 16 + ((lt & 31) >> 2), r_b = r_a + 8;
  const int T = m.T;
  const float inv_h = 1.f / (float)m.H;
  float s[32], acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = acc[i] = 0.f;
  int n = 0;
  for (int p = 0; p < ntiles; ++p) {
    const int key0 = (kt0 + p * kstep) * TILE;
    const bool ragged = key0 + TILE > T;
    for (int h = 0; h < m.H; ++h) {
      for (int sl = 0; sl < m.NS; ++sl, ++n) {
        uint8_t* slot = m.ring.take(n);
        uint8_t* qt = slot + (1 + r) * SLAB;
        scale_slabs(qt, SLAB, s2, lt, WG_THREADS);
        warpgroup_sync(wg);
        fence_regs(s);
        wgmma_fence();
#pragma unroll
        for (int kc = 0; kc < Slab::KSTEPS; ++kc)
          wgmma_ss<0>(s, Slab::kmajor(qt, kc), Slab::kmajor(slot, kc), sl | kc);
        wgmma_commit();
        wgmma_wait();
        fence_regs(s);
        m.ring.give(n);
      }
      const float* rh = recip + (size_t)h * T;
      float c_a = 0.f, c_b = 0.f;
      if (V5) {
        if (r_a < T) c_a = __ldcg(rh + r_a);
        if (r_b < T) c_b = __ldcg(rh + r_b);
      } else {
        if (r_a < T) c_a = rh[r_a] * inv_h;
        if (r_b < T) c_b = rh[r_b] * inv_h;
      }
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const float e = e_at<CLAMPED>(s[i], !ragged || key0 + acc_col(i, tig) < T);
        acc[i] = __fadd_rn(acc[i], __fmul_rn(e, (i & 2) ? c_b : c_a));
      }
    }
    // every head summed: the tile (v5: the sum divided by H once)
    const float hf = (float)m.H;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = key0 + j * 8 + tig * 2;
      float x[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) x[i] = V5 ? __fdiv_rn(acc[4 * j + i], hf) : acc[4 * j + i];
      store_mean2(mean, r_a, col, T, x[0], x[1]);
      store_mean2(mean, r_b, col, T, x[2], x[3]);
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] = 0.f;
  }
}

// ------------------------------------------------ wide kernels

// out pass of v2, v3, v4, v6: one item per block
template <int W, int SUM, bool CLAMPED>
__device__ __forceinline__ void wide_out(const CUtensorMap& mq, const CUtensorMap& mk,
                                         const CUtensorMap& mv, const CUtensorMap& mc,
                                         bf16* __restrict__ out, float* __restrict__ recip,
                                         const WideArgs& a, float qscale) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  WOut w = wout_layout<SUM>(smem, a);
  w.mq = &mq;
  w.mk = &mk;
  w.mv = &mv;
  w.mc = &mc;
  if (threadIdx.x == 0) {
    wout_init(w);
    mbar_init_fence();
  }
  if (SUM == SUM_MMA_ONES) {
    for (int i = threadIdx.x; i < ONES_BYTES / 4; i += blockDim.x)
      reinterpret_cast<uint32_t*>(w.ones)[i] = BF16_ONES;
    fence_async_cta();
  }
  __syncthreads();
  const int plane = blockIdx.z, g0 = blockIdx.y * a.G, row0 = blockIdx.x * TILE;
  const int nsl = a.G < a.NS - g0 ? a.G : a.NS - g0;
  if (threadIdx.x >= W * WG_THREADS) {
    if (threadIdx.x == W * WG_THREADS) wout_produce<SUM>(w, 0, plane, g0, nsl, row0, 0);
    return;
  }
  wout_consume<SUM, CLAMPED>(w, W, 0, plane, g0, nsl, row0, 0, 0, threadIdx.x >> 7, out, recip,
                             __float2bfloat162_rn(qscale));
}

#define WIDE_OUT_ARGS                                                                         \
  const __grid_constant__ CUtensorMap map_q, const __grid_constant__ CUtensorMap map_k,       \
      const __grid_constant__ CUtensorMap map_v, const __grid_constant__ CUtensorMap map_c,   \
      bf16 *__restrict__ out, float *__restrict__ recip, WideArgs a, float qscale
#define WIDE_OUT(NAME, SUM, CLAMPED)                                                          \
  template <int W>                                                                            \
  __global__ void __launch_bounds__(W* WG_THREADS + W_PRODUCER, 1) NAME(WIDE_OUT_ARGS) {       \
    wide_out<W, SUM, CLAMPED>(map_q, map_k, map_v, map_c, out, recip, a, qscale);             \
  }
WIDE_OUT(attn_v2_wide, SUM_SHUFFLE, true)
WIDE_OUT(attn_v3_wide, SUM_SHUFFLE, false)
WIDE_OUT(attn_v4_wide, SUM_MMA_ONES, true)
WIDE_OUT(attn_v6_wide, SUM_V_COLS, true)
#undef WIDE_OUT

// mean pass of v2, v4, v6 (clamped) and v3: one lane of WM_ROWS warpgroups
template <bool CLAMPED>
__device__ __forceinline__ void wide_mean(const CUtensorMap& mq, const CUtensorMap& mk,
                                          const float* __restrict__ recip,
                                          bf16* __restrict__ mean, const WideArgs& a,
                                          float qscale) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  WMean m;
  m.NS = a.NS;
  m.R = WM_ROWS;
  m.H = a.H;
  m.T = a.T;
  m.ring.base = smem;
  m.ring.slots = WM_SLOTS;
  m.ring.bytes = (1 + WM_ROWS) * SLAB;
  m.ring.full = reinterpret_cast<uint64_t*>(smem + WM_SLOTS * m.ring.bytes + W_RED_BYTES);
  m.ring.empty = m.ring.full + WM_SLOTS;
  if (threadIdx.x == 0) {
    for (int i = 0; i < WM_SLOTS; ++i) {
      mbar_init(&m.ring.full[i], 1);
      mbar_init(&m.ring.empty[i], WM_ROWS * WG_THREADS);
    }
    mbar_init_fence();
  }
  __syncthreads();
  const int b = blockIdx.z, row0 = blockIdx.y * WM_ROWS * TILE, kt0 = blockIdx.x * a.chunk;
  const int nk = (a.T + TILE - 1) / TILE;
  const int ntiles = a.chunk < nk - kt0 ? a.chunk : nk - kt0;
  if (threadIdx.x >= WM_ROWS * WG_THREADS) {
    if (threadIdx.x == WM_ROWS * WG_THREADS)
      wmean_produce(m, &mq, &mk, b, row0, kt0, 1, ntiles);
    return;
  }
  const int wg = threadIdx.x >> 7;
  wmean_consume<CLAMPED, false>(m, wg, wg, recip + (size_t)b * a.H * a.T,
                                mean + (size_t)b * a.T * a.T, row0, kt0, 1, ntiles,
                                __float2bfloat162_rn(qscale));
}

#define WIDE_MEAN_ARGS                                                                  \
  const __grid_constant__ CUtensorMap map_q, const __grid_constant__ CUtensorMap map_k, \
      const float *__restrict__ recip, bf16 *__restrict__ mean, WideArgs a, float qscale
__global__ void __launch_bounds__(WM_THREADS, WM_BLOCKS_PER_SM)
    attn_var_mean_wide(WIDE_MEAN_ARGS) {
  wide_mean<true>(map_q, map_k, recip, mean, a, qscale);
}
__global__ void __launch_bounds__(WM_THREADS, WM_BLOCKS_PER_SM)
    attn_var_mean_nomin_wide(WIDE_MEAN_ARGS) {
  wide_mean<false>(map_q, map_k, recip, mean, a, qscale);
}

// v5: one block = rank r of a cluster of C over query rows blockIdx.y * 64
// of image blockIdx.z. Sweep 1: heads r, r + C, ..., every slab group
// (items in that order), v2's out pass; the recips into `work`. Sweep 2:
// key tiles [r nk / C, (r + 1) nk / C) over every head, lane l of the
// block's `lanes` (warpgroup l, producer lane l) taking every lanes-th of
// them; a warpgroup past the lanes rests.
template <int W>
__global__ void __launch_bounds__(W* WG_THREADS + W_PRODUCER, 1)
    attn_v5_wide(const __grid_constant__ CUtensorMap map_q,
                 const __grid_constant__ CUtensorMap map_k,
                 const __grid_constant__ CUtensorMap map_v, bf16* __restrict__ out,
                 bf16* __restrict__ mean, float* __restrict__ work, WideArgs a, float qscale) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  cg::cluster_group cl = cg::this_cluster();
  const int C = (int)cl.num_blocks(), rank = (int)cl.block_rank();
  WOut w = wout_layout<SUM_SHUFFLE>(smem, a);
  w.mq = &map_q;
  w.mk = &map_k;
  w.mv = &map_v;
  w.mc = &map_v;
  uint64_t* bars2 = w.qempty + 1;  // sweep 2: lane l's full at 2 W5_SLOTS l, then its empty
  const int H = a.H, T = a.T, nk = (T + TILE - 1) / TILE, b = blockIdx.z;
  const int row0 = blockIdx.y * TILE;
  const int wg = threadIdx.x >> 7, producer = W * WG_THREADS;
  const int l = threadIdx.x >= producer ? threadIdx.x - producer : wg;  // sweep 2's lane
  WMean lane;
  lane.NS = a.NS;
  lane.R = 1;
  lane.H = H;
  lane.T = T;
  lane.ring.slots = W5_SLOTS;
  lane.ring.bytes = 2 * SLAB;
  lane.ring.base = smem + l * W5_SLOTS * lane.ring.bytes;
  lane.ring.full = bars2 + 2 * W5_SLOTS * l;
  lane.ring.empty = lane.ring.full + W5_SLOTS;
  if (threadIdx.x == 0) {
    wout_init(w);
    for (int i = 0; i < a.lanes * W5_SLOTS; ++i) {
      mbar_init(&bars2[2 * W5_SLOTS * (i / W5_SLOTS) + i % W5_SLOTS], 1);
      mbar_init(&bars2[2 * W5_SLOTS * (i / W5_SLOTS) + W5_SLOTS + i % W5_SLOTS], WG_THREADS);
    }
    mbar_init_fence();
  }
  __syncthreads();
  const __nv_bfloat162 s2 = __float2bfloat162_rn(qscale);

  // ---- sweep 1: out of this rank's heads
  const int nh = rank < H ? (H - 1 - rank) / C + 1 : 0;
  for (int item = 0, n0 = 0; item < nh * a.groups; ++item) {
    const int plane = b * H + rank + item / a.groups * C, g0 = item % a.groups * a.G;
    const int nsl = a.G < a.NS - g0 ? a.G : a.NS - g0;
    if (threadIdx.x == producer)
      wout_produce<SUM_SHUFFLE>(w, item, plane, g0, nsl, row0, n0);
    else if (threadIdx.x < producer)
      wout_consume<SUM_SHUFFLE, true>(w, W, item, plane, g0, nsl, row0, n0, item * nk, wg, out,
                                      work, s2);
    n0 += nk * (a.NS * (1 + a.qstream) + nsl);
  }
  __syncwarp();
  cl.sync();  // every rank's recips are in the workspace

  // ---- sweep 2: the mean of this rank's key tiles
  const int kt0 = rank * nk / C, nr = (rank + 1) * nk / C - kt0;
  const int ntiles = nr > l ? (nr - 1 - l) / a.lanes + 1 : 0;
  if (l < a.lanes) {
    if (threadIdx.x >= producer)
      wmean_produce(lane, &map_q, &map_k, b, row0, kt0 + l, a.lanes, ntiles);
    else
      wmean_consume<true, true>(lane, 0, wg, work + (size_t)b * H * T, mean + (size_t)b * T * T,
                                row0, kt0 + l, a.lanes, ntiles, s2);
  }
}

// the kernel of the out pass of `variant` with W consumer warpgroups
const void* wide_out_kernel(int variant, int W) {
#define WIDE_OUT_FOR(WW)                                 \
  if (W == WW) switch (variant) {                        \
      case 2: return (const void*)attn_v2_wide<WW>;      \
      case 3: return (const void*)attn_v3_wide<WW>;      \
      case 4: return (const void*)attn_v4_wide<WW>;      \
      case 6: return (const void*)attn_v6_wide<WW>;      \
    }
  WIDE_OUT_FOR(2)
  WIDE_OUT_FOR(3)
#undef WIDE_OUT_FOR
  return nullptr;
}

const void* wide_v5_kernel(int W) {
  switch (W) {
    case 2: return (const void*)attn_v5_wide<2>;
    case 3: return (const void*)attn_v5_wide<3>;
  }
  return nullptr;
}

cudaError_t device_sms(int* sms) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  return err;
}

// variants 2..6 on the wide route at head dim KD (a multiple of 128 above
// 128): v2, v3, v4, v6 two kernels (out pass, mean pass), v5 one
int wide_variant(int variant, const void* q, const void* k, const void* v, void* out,
                 void* mean, void* work, int B, int H, int T, int KD, float qscale,
                 cudaStream_t stream) {
  if (work == nullptr || H < 1 || T < 1 || B < 1 || variant < 2 || variant > 6)
    return (int)cudaErrorInvalidValue;
  int sms = 0;
  cudaError_t err = device_sms(&sms);
  if (err != cudaSuccess) return (int)err;
  const WidePlan p = wide_plan(B, H, T, KD, variant, sms);
  const WideArgs a{KD / SLAB_COLS, p.slabs, p.groups, p.slots, p.qstream,
                   p.lanes,        p.chunk, H,        T};
  const void* kern = variant == 5 ? wide_v5_kernel(p.slabs) : wide_out_kernel(variant, p.slabs);
  if (kern == nullptr) return (int)cudaErrorInvalidConfiguration;
  // runtime calls first: they make the device's context current on this
  // thread, which the tensor-map encoding needs
  err = max_shared(kern, variant == 5 ? p.v5_smem : p.out_smem);
  const void* mkern = variant == 3 ? (const void*)attn_var_mean_nomin_wide
                                   : (const void*)attn_var_mean_wide;
  if (err == cudaSuccess && variant != 5) err = max_shared(mkern, p.mean_smem);
  if (err != cudaSuccess) return (int)err;
  CUtensorMap mq, mk, mv, mc;
  if (int bad = Slab::map(&mq, q, B * H, T, KD)) return bad;
  if (int bad = Slab::map(&mk, k, B * H, T, KD)) return bad;
  if (variant == 6) {  // KD + 8 columns: the slabs, and the 8 columns from KD
    if (int bad = Slab::map(&mv, v, B * H, T, KD + 8)) return bad;
    if (int bad = make_plane_map(&mc, v, B * H, T, KD + 8, 8, false)) return bad;
  } else {
    if (int bad = Slab::map(&mv, v, B * H, T, KD)) return bad;
    mc = mv;
  }
  if (!aligned16(out) || !aligned16(mean) || !aligned16(work)) return TMA_MISALIGNED;
  bf16 *ob = (bf16*)out, *mb = (bf16*)mean;
  float* wb = (float*)work;
  if (variant == 5) {
    void* args[] = {&mq, &mk, &mv, &ob, &mb, &wb, (void*)&a, &qscale};
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(p.v5_x, p.v5_y, p.v5_z);
    cfg.blockDim = dim3(p.slabs * WG_THREADS + W_PRODUCER);
    cfg.dynamicSmemBytes = p.v5_smem;
    cfg.stream = stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = p.cluster;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    if ((err = cudaLaunchKernelExC(&cfg, kern, args)) != cudaSuccess) return (int)err;
    return (int)cudaGetLastError();
  }
  void* oargs[] = {&mq, &mk, &mv, &mc, &ob, &wb, (void*)&a, &qscale};
  err = cudaLaunchKernel(kern, dim3(p.out_x, p.out_y, p.out_z),
                         dim3(p.slabs * WG_THREADS + W_PRODUCER), oargs, p.out_smem, stream);
  if (err != cudaSuccess) return (int)err;
  void* margs[] = {&mq, &mk, &wb, &mb, (void*)&a, &qscale};
  err = cudaLaunchKernel(mkern, dim3(p.mean_x, p.mean_y, p.mean_z), dim3(WM_THREADS), margs,
                         p.mean_smem, stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <int HD>
int variant_forward(int variant, const void* q, const void* k, const void* v, void* out,
                    void* mean, void* work, int B, int H, int T, float qscale,
                    cudaStream_t stream) {
  if (variant == 5) return v5_forward<HD>(q, k, v, out, mean, work, B, H, T, qscale, stream);
  return hopper_variant<HD>(variant, q, k, v, out, mean, work, B, H, T, qscale, stream);
}

}  // namespace

extern "C" {

// variant 2..6 as in the list at the top, at head dim D = 32, 64 or 128, or
// on the wide route at a multiple of 128 above it (cudaErrorInvalidValue
// otherwise; ops/attention_variants.py zero-pads any other width onto one). q, k, out: (B, H, T, D)
// bf16 contiguous, 16-byte aligned; v: (B, H, T, D), for variant 6
// (B, H, T, D + 8) with ones in the last 8 columns (the kernel reads them:
// the denominator is column D of e @ v); mean: (B, T, T) bf16; work: a
// (B, H, T) f32 workspace (each row's recip: written by the out pass and
// read by the mean pass; variant 5 uses it only above V5_SMEM_RECIP_HEADS
// heads, and always on the wide route). qscale: d^-0.5 * log2(e) of the
// true head dim, already rounded to bf16. Any H >= 1. Returns a
// cudaError_t, or a code of make_plane_map (>= 998) when a tensor map
// cannot be made.
int attn_variant_forward(int variant, const void* q, const void* k, const void* v, void* out,
                         void* mean, void* work, int B, int H, int T, int D, float qscale,
                         void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (D == 64) return variant_forward<64>(variant, q, k, v, out, mean, work, B, H, T, qscale, st);
  if (D == 32) return variant_forward<32>(variant, q, k, v, out, mean, work, B, H, T, qscale, st);
  if (D == 128)
    return variant_forward<128>(variant, q, k, v, out, mean, work, B, H, T, qscale, st);
  if (wide_head_dim(D))
    return wide_variant(variant, q, k, v, out, mean, work, B, H, T, D, qscale, st);
  return (int)cudaErrorInvalidValue;
}

// The cluster size attn_variant_forward(5, ...) launches at (B, H, T, D) on
// the current device, or minus the cudaError_t that stops it.
int attn_v5_cluster(int B, int H, int T, int D) {
  if (B < 1 || H < 1 || T < 1) return -(int)cudaErrorInvalidValue;
  if (D == 64) return v5_cluster_size<64>(B, H, T);
  if (D == 32) return v5_cluster_size<32>(B, H, T);
  if (D == 128) return v5_cluster_size<128>(B, H, T);
  if (wide_head_dim(D)) {
    int sms = 0;
    const cudaError_t err = device_sms(&sms);
    return err == cudaSuccess ? wide_plan(B, H, T, D, 5, sms).cluster : -(int)err;
  }
  return -(int)cudaErrorInvalidValue;
}

// The wide route's plan of attn_variant_forward(variant, ...) at (B, H, T,
// KD) on the current device, as 20 ints (WidePlan's fields in order: sms,
// slabs, groups, qstream, slots, out_smem, out grid x y z, chunk,
// mean_smem, mean grid x y z, cluster, lanes, v5_smem, v5 grid x y z),
// mirrored by ops/attention_variants.py::
// wide_variant_plan. Returns a cudaError_t.
int attn_wide_plan(int B, int H, int T, int KD, int variant, int* out) {
  if (B < 1 || H < 1 || T < 1 || !wide_head_dim(KD) || variant < 2 || variant > 6 ||
      out == nullptr)
    return (int)cudaErrorInvalidValue;
  int sms = 0;
  const cudaError_t err = device_sms(&sms);
  if (err != cudaSuccess) return (int)err;
  const WidePlan p = wide_plan(B, H, T, KD, variant, sms);
  memcpy(out, &p, sizeof(p));
  return 0;
}

}  // extern "C"
