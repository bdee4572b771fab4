// Cosine mean-shift fixpoint (Stage C), one thread block cluster per instance.
//
// Replaces the Pallas TPU kernel _kernel of
// attentionshift_tpu/ops/meanshift_kernel.py:47 (via cosine_shift_fixpoint).
// Per instance g, with prototypes P (K, D), features f (N, D), box mask m
// (N,) and raw feature norms nb (N,), n_shift iterations of
//   sim[k,n]  = (P_k . f_n) * m_n / (max(|P_k|, 1e-8) * max(nb_n * m_n, 1e-8))
//   logw      = sim / (temp * tau_k) - logsumexp_n(sim / (temp * tau_k))
//   idx[n]    = argmax_k logw[k, n]          (first maximum wins)
//   P_k      <- sum_{n: idx[n] = k} exp(logw[k, n]) * m_n * f_n
//   tau_k    <- max(1 - mean_{n: idx[n] = k} sim'[k, n], 1e-10)  (sim' from the new P)
// then the final similarity against the UNMASKED features,
//   out_sim[k, n] = (P_k . f_n) / (max(|P_k|, 1e-8) * max(nb_n, 1e-8)).
// Dot operands are rounded to bf16 when mm_bf16 (the model's matmul dtype)
// and accumulate in f32; everything else is f32, as on the TPU.
//
// What bounds it on the H100. At the bench shape (G=20, K=20, N=4200,
// D=384) the inputs are 13 MB and the output 6.7 MB (6 us at 3.35 TB/s);
// the dot products are 11 passes x 2*K*N*D = 0.7 GFLOP per instance, 15 us
// for all 20 at 989 TFLOP/s. Neither bound is near: the first design
// (clusters of 8 blocks, one block per SM) took 1.8 ms because only 15
// clusters fit the card, so the time was two waves of a block's lifetime,
// and in a lifetime the scalar phases (log-sum-exp, assignment, the sum of
// 8 partials through distributed shared memory) weighed as much as either
// product. In this design the time is set per block: each warpgroup
// streams its boxes one after another (about 1-2 k cycles per box whether
// its ring holds one slot or two), and every iteration is a chain of
// dependent steps with cluster-wide reductions between them.
//
// What the design does about it. Each instance runs on a cluster of C
// blocks of 512 threads; the host picks C (and the ring depth) from
// cudaOccupancyMaxActiveClusters so that all instances run in one wave
// where that is possible. Block r owns features [r*S, (r+1)*S), S a
// multiple of 64, and keeps their similarities (K x S, f32), mask values
// and norms in shared memory. With bf16 operands both products are wgmma
// from one kind of tile: each of the four warpgroups streams (64 features,
// 64 dims) bf16 boxes of the block's features through its own TMA ring
// (128-byte swizzle, rows and columns past the matrix zero-filled). The
// similarity is S = F P^T (M = 64 features, N = KP prototypes, the box read
// K-major, P^T from a swizzled bf16 copy of the prototypes; warpgroups take
// tiles in turn); the update is P^T = F^T W^T (M = 64 dims, N = KP,
// contracting the box's 64 features: the same box read MN-major through the
// descriptor's transpose bit; two warpgroups per group of dims, on the even
// and the odd tiles), W^T a one-hot weighted (KP, 64) bf16 tile per feature
// tile built from each feature's (prototype, weight). No transposed feature
// copy. All 16 warps run the reductions over features, each prototype's row
// split over P warps and combined in the block before the cluster step.
// Per iteration four cluster barriers: the log-sum-exp, the prototype sum,
// the new prototypes, the bandwidths. The prototype sum is a reduce-scatter
// through distributed shared memory: rank r adds every rank's partial of
// its own columns in rank order and writes the result (the dot-operand
// copy, its part of the squared norms, and on the last iteration the
// output) into every rank, so each block holds bit-identical prototypes
// and bandwidths. The f32 path keeps scalar FMAs (one feature and KP
// accumulators per thread) on the same cluster structure.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace cg = cooperative_groups;
using namespace hopper;

namespace {

// design constants (-D overrides build variants, see ops/_build.py)
#ifndef MS_ROUND_BOXES
#define MS_ROUND_BOXES 3  // 64-dim boxes of the update each warpgroup accumulates at once
#endif

#ifndef MS_ROW_PARTS
#define MS_ROW_PARTS 4  // warps that share one prototype's row in a reduction over features
#endif

constexpr int NWG = 4;  // warpgroups; each streams features through its own ring
constexpr int NTHREADS = 128 * NWG;
constexpr int NWARPS = NTHREADS / 32;
constexpr int MAX_STAGES = 2;  // ring slots per warpgroup (the host may take fewer)
constexpr int MAX_CLUSTER = 16;  // above 8: a non-portable cluster size
constexpr int BOX_BYTES = 64 * 128;
constexpr int R = MS_ROUND_BOXES;
constexpr int P = MS_ROW_PARTS;

typedef __nv_bfloat16 bf16;

template <bool BF16>
__device__ __forceinline__ float rnd(float x) {
  if (BF16) return __bfloat162float(__float2bfloat16(x));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

// the 128 threads of warpgroup `wg` only
__device__ __forceinline__ void wg_sync(int wg) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
}

// D (64 x N, f32: N/2 per thread) += A (64 x 16) * B (16 x N), both from
// shared memory; TA / TB: the operand is MN-major (transpose bit)
#define MS_WGMMA_HEAD(NN, LIST, P) \
  "{\n.reg .pred p;\nsetp.ne.b32 p, %" #P ", 0;\n" \
  "wgmma.mma_async.sync.aligned.m64n" #NN "k16.f32.bf16.bf16 " LIST
template <int N, int TA, int TB>
__device__ __forceinline__ void wgmma(float (&d)[N / 2], uint64_t da, uint64_t db) {
  const int one = 1;
  if constexpr (N == 8) {
    asm volatile(MS_WGMMA_HEAD(8, "{%0, %1, %2, %3}", 6) ", %4, %5, p, 1, 1, %7, %8;\n}\n"
                 : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
                 : "l"(da), "l"(db), "r"(one), "n"(TA), "n"(TB));
  } else if constexpr (N == 16) {
    asm volatile(MS_WGMMA_HEAD(16, "{%0, %1, %2, %3, %4, %5, %6, %7}", 10)
                 ", %8, %9, p, 1, 1, %11, %12;\n}\n"
                 : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
                   "+f"(d[6]), "+f"(d[7])
                 : "l"(da), "l"(db), "r"(one), "n"(TA), "n"(TB));
  } else if constexpr (N == 24) {
    asm volatile(MS_WGMMA_HEAD(24, "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11}", 14)
                 ", %12, %13, p, 1, 1, %15, %16;\n}\n"
                 : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
                   "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11])
                 : "l"(da), "l"(db), "r"(one), "n"(TA), "n"(TB));
  } else {
    static_assert(N == 32, "KP is 8, 16, 24 or 32");
    asm volatile(MS_WGMMA_HEAD(32,
                               "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
                               "%14, %15}",
                               18) ", %16, %17, p, 1, 1, %19, %20;\n}\n"
                 : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
                   "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
                   "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
                 : "l"(da), "l"(db), "r"(one), "n"(TA), "n"(TB));
  }
}
#undef MS_WGMMA_HEAD

template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// ------------------------------------------------------------ the layout

__host__ __device__ inline size_t up(size_t x, size_t a) { return (x + a - 1) / a * a; }

struct Layout {
  size_t ring, op, x, part, w, mv, nbv, idx, small, bars, total;
};

// Shared memory of one block: the TMA rings (bf16 only), the dot-operand
// copy of the prototypes (bf16: one swizzled (KP, 64) slot per 64 dims;
// f32: (D, KP)), region X (the block's similarities; in the update the W^T
// tiles and, after them, this block's partial prototype sums), each
// feature's weight, mask, norm and prototype, small per-prototype arrays,
// barriers.
__host__ __device__ inline Layout layout(int KP, bool bf16, int D, int tb, int stages) {
  const size_t S = (size_t)tb * 64;
  Layout L;
  L.ring = 0;
  const size_t ring = bf16 ? (size_t)NWG * stages * BOX_BYTES : 0;
  L.op = ring;
  const size_t op = bf16 ? (size_t)((D + 63) / 64) * KP * 128 : (size_t)D * KP * 4;
  L.x = up(L.op + op, 1024);
  const size_t wt = bf16 ? (size_t)tb * KP * 128 : 0;
  // one round of the update covers every dim: the partial sums overwrite
  // the W^T tiles once the products are done; else they follow them
  const bool one_round = (D + 63) / 64 <= 2 * R;
  L.part = one_round ? L.x : L.x + wt;
  const size_t part = (size_t)KP * (D + 4) * 4;
  const size_t upd = one_round ? (wt > part ? wt : part) : wt + part;
  const size_t sim = (size_t)KP * (S + 4) * 4;
  const size_t x = sim > upd ? sim : upd;
  L.w = up(L.x + x, 16);
  L.mv = L.w + S * 4;
  L.nbv = L.mv + S * 4;
  L.idx = L.nbv + S * 4;
  L.small = up(L.idx + S, 16);
  L.bars = L.small + (size_t)(8 + 4 * P + MAX_CLUSTER) * KP * 4;
  L.total = L.bars + NWG * MAX_STAGES * 8 + 1024;  // + the alignment of the base
  return L;
}

struct Params {
  const float *prot0, *mask, *f, *ft, *nbase;
  float *out_prot, *out_sim;
  int K, N, D, n_shift, tb, stages;
  float tau0, temp;
};

// sim[k, n] from the accumulated dot, feature n's mask value and norm:
// masked, or unmasked (the final similarity)
__device__ __forceinline__ float cosine(float dot, bool masked, float mv, float nb, float na_k) {
  if (masked) return dot * mv / (na_k * fmaxf(nb * mv, 1e-8f));
  return dot / (na_k * fmaxf(nb, 1e-8f));
}

// One warpgroup's stream of (64 features, 64 dims) boxes through its ring.
// Every thread of the warpgroup keeps the same count of boxes `seq`; box i
// of a pass sits in slot (seq + i) % stages.
struct Ring {
  uint8_t* slots;
  uint64_t* full;
  const CUtensorMap* map;
  int stages, seq;

  __device__ uint8_t* slot(int i) const { return slots + ((seq + i) % stages) * BOX_BYTES; }
  __device__ void load(int i, int col, int row) const {
    const int s = (seq + i) % stages;
    mbar_expect_tx(&full[s], BOX_BYTES);
    tma_load_2d(slots + s * BOX_BYTES, map, &full[s], col, row);
  }
  __device__ void wait(int i) const {
    mbar_wait(&full[(seq + i) % stages], ((seq + i) / stages) & 1);
  }
};

// Similarity pass of warpgroup wg on the tensor cores: its feature tiles
// j = wg, wg + NWG, ... of the block's `ntile`; box (j, db) of every 64 dims.
// mv, nbv: the block's features' mask values (null: unmasked) and norms.
template <int KP>
__device__ void sim_pass_wgmma(Ring& ring, const uint8_t* op, const float* na, const float* mv,
                               const float* nbv, float* dst, int ld, int col0, int K, int n_lo,
                               int cnt, int ntile, int D, int wg) {
  const int DT = (D + 63) / 64;
  const int tid = threadIdx.x & 127, wl = tid >> 5, lane = tid & 31;
  const int mine = ntile > wg ? (ntile - wg + NWG - 1) / NWG : 0;
  const int total = mine * DT;
  auto load = [&](int i) {
    ring.load(i, (i % DT) * 64, n_lo + (wg + NWG * (i / DT)) * 64);
  };
  if (tid == 0)
    for (int i = 0; i < min(ring.stages, total); ++i) load(i);
  float acc[KP / 2];
  for (int i = 0; i < total; ++i) {
    const int db = i % DT;
    if (db == 0) {
#pragma unroll
      for (int e = 0; e < KP / 2; ++e) acc[e] = 0.f;
    }
    ring.wait(i);
    const uint8_t* box = ring.slot(i);
    wgmma_fence();
#pragma unroll
    for (int kc = 0; kc < 4; ++kc)
      wgmma<KP, 0, 0>(acc, desc_kmajor(box, kc), desc_kmajor(op + db * KP * 128, kc));
    wgmma_commit();
    wgmma_wait();
    fence_acc(acc);
    wg_sync(wg);  // every warp is done with the slot
    if (tid == 0 && i + ring.stages < total) load(i + ring.stages);
    if (db != DT - 1) continue;
    const int t0 = (wg + NWG * (i / DT)) * 64 + 16 * wl + (lane >> 2);
#pragma unroll
    for (int e = 0; e < KP / 2; ++e) {
      const int t = t0 + ((e & 2) ? 8 : 0);
      const int k = (e >> 2) * 8 + 2 * (lane & 3) + (e & 1);
      if (t < cnt && k < K)
        dst[(size_t)k * ld + n_lo + t - col0] =
            cosine(acc[e], mv != nullptr, mv != nullptr ? mv[t] : 1.f, nbv[t], na[k]);
    }
  }
  ring.seq += total;
}

// Update on the tensor cores: the partial P^T = F^T W^T over the block's
// tiles, into part (KP x D + 4, f32), in rounds of 2R boxes of 64 dims.
// Warpgroups wg and wg + 2 take the same R boxes (wg % 2 picks which), on
// the even and the odd feature tiles: every warpgroup streams as many
// boxes. The odd tiles' partials are added after the even ones are stored.
template <int KP>
__device__ void update_wgmma(Ring& ring, const uint8_t* wt, float* part, int n_lo, int ntile,
                             int D, int wg) {
  const int DT = (D + 63) / 64;
  const int tid = threadIdx.x & 127, wl = tid >> 5, lane = tid & 31;
  const int half = wg >> 1;
  const int mine = ntile > half ? (ntile - half + 1) / 2 : 0;  // tiles half, half + 2, ...
  for (int base = 0; base < DT; base += 2 * R) {
    const int b0 = base + (wg & 1) * R;
    int nd = 0;
#pragma unroll
    for (int r = 0; r < R; ++r) nd += b0 + r < DT;
    const int total = mine * nd;
    auto load = [&](int i) {
      ring.load(i, (b0 + i % max(nd, 1)) * 64, n_lo + (half + 2 * (i / max(nd, 1))) * 64);
    };
    if (tid == 0)
      for (int i = 0; i < min(ring.stages, total); ++i) load(i);
    float acc[R][KP / 2];
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int e = 0; e < KP / 2; ++e) acc[r][e] = 0.f;
    int i = 0;
    for (int jj = 0; jj < mine; ++jj) {
      const uint8_t* wj = wt + (half + 2 * jj) * KP * 128;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (r >= nd) continue;
        ring.wait(i);
        const uint8_t* box = ring.slot(i);
        wgmma_fence();
#pragma unroll
        for (int kc = 0; kc < 4; ++kc)
          wgmma<KP, 1, 0>(acc[r], desc_mnmajor(box, kc), desc_kmajor(wj, kc));
        wgmma_commit();
        wgmma_wait();
        fence_acc(acc[r]);
        wg_sync(wg);  // every warp is done with the slot
        if (tid == 0 && i + ring.stages < total) load(i + ring.stages);
        ++i;
      }
    }
    ring.seq += total;
    // rows of the accumulator are dims, columns prototypes: the even tiles'
    // partials are stored once every warpgroup is done with the W^T tiles,
    // then the odd tiles' are added
    for (int h = 0; h < 2; ++h) {
      __syncthreads();
      if (half != h) continue;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (r >= nd) continue;
        const int d0 = (b0 + r) * 64 + 16 * wl + (lane >> 2);
#pragma unroll
        for (int e = 0; e < KP / 2; ++e) {
          const int d = d0 + ((e & 2) ? 8 : 0);
          const int k = (e >> 2) * 8 + 2 * (lane & 3) + (e & 1);
          float* pp = part + k * (D + 4) + d;
          if (d < D) *pp = h == 0 ? acc[r][e] : *pp + acc[r][e];
        }
      }
    }
  }
}

// f32 similarity pass: one feature and KP accumulators per thread, scalar
// FMAs, the operand (D, KP) f32
template <int KP>
__device__ void sim_pass_f32(const float* protT, const float* na, const float* __restrict__ ft,
                             const float* m, const float* __restrict__ nbase, float* dst, int ld,
                             int col0, int K, int N, int n_lo, int n_hi, int D) {
  for (int base = n_lo; base < n_hi; base += NTHREADS) {
    const int n = base + (int)threadIdx.x;
    float acc[KP];
#pragma unroll
    for (int k = 0; k < KP; ++k) acc[k] = 0.f;
    for (int d = 0; d < D; ++d) {
      const float fv = n < n_hi ? ft[(size_t)d * N + n] : 0.f;
      const float4* pr = reinterpret_cast<const float4*>(protT + d * KP);
#pragma unroll
      for (int k4 = 0; k4 < KP / 4; ++k4) {
        const float4 q = pr[k4];
        acc[4 * k4 + 0] = fmaf(q.x, fv, acc[4 * k4 + 0]);
        acc[4 * k4 + 1] = fmaf(q.y, fv, acc[4 * k4 + 1]);
        acc[4 * k4 + 2] = fmaf(q.z, fv, acc[4 * k4 + 2]);
        acc[4 * k4 + 3] = fmaf(q.w, fv, acc[4 * k4 + 3]);
      }
    }
    if (n >= n_hi) continue;
#pragma unroll
    for (int k = 0; k < KP; ++k)
      if (k < K)
        dst[(size_t)k * ld + n - col0] =
            cosine(acc[k], m != nullptr, m != nullptr ? m[n] : 1.f, nbase[n], na[k]);
  }
}

// (max, sum of exp - max) pairs m[2i], m[2i + 1], i < P, combined in order
__device__ __forceinline__ void combine_lse(const float* m, float* out) {
  float mx = -INFINITY, sum = 0.f;
#pragma unroll
  for (int i = 0; i < P; ++i) mx = fmaxf(mx, m[2 * i]);
#pragma unroll
  for (int i = 0; i < P; ++i)
    if (m[2 * i] > -INFINITY) sum += m[2 * i + 1] * expf(m[2 * i] - mx);
  out[0] = mx;
  out[1] = sum;
}

// one prototype value into a block's dot-operand copy
template <int KP, bool BF16>
__device__ __forceinline__ void put_pair(uint8_t* op, int k, int d, float v0, float v1, int D) {
  if (BF16) {
    __nv_bfloat162 p = __floats2bfloat162_rn(v0, v1);
    *reinterpret_cast<__nv_bfloat162*>(op + (d >> 6) * KP * 128 + swz128(k, d & 63)) = p;
  } else {
    float* o = reinterpret_cast<float*>(op);
    o[d * KP + k] = v0;
    if (d + 1 < D) o[(d + 1) * KP + k] = v1;
  }
}

template <int KP, bool BF16>
__global__ void __launch_bounds__(NTHREADS, 1)
meanshift_kernel(const __grid_constant__ CUtensorMap fmap, const Params p) {
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int g = blockIdx.x / C;
  const int K = p.K, N = p.N, D = p.D;
  const int S = p.tb * 64, LDS = S + 4, PD = D + 4;
  const int n_lo = rank * S;
  const int cnt = max(0, min(S, N - n_lo));  // features this block owns
  const int ntile = (cnt + 63) / 64;
  const int DT = (D + 63) / 64;
  const Layout L = layout(KP, BF16, D, p.tb, p.stages);
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  uint8_t* op = smem + L.op;
  float* sim = reinterpret_cast<float*>(smem + L.x);
  uint8_t* wt = smem + L.x;
  float* part = reinterpret_cast<float*>(smem + L.part);
  float* w = reinterpret_cast<float*>(smem + L.w);
  float* mv = reinterpret_cast<float*>(smem + L.mv);
  float* nbv = reinterpret_cast<float*>(smem + L.nbv);
  int8_t* idx = reinterpret_cast<int8_t*>(smem + L.idx);
  float* tau = reinterpret_cast<float*>(smem + L.small);
  float* na = tau + KP;
  float* lse = na + KP;
  float* inv = lse + KP;                   // 1 / (temp * tau_k)
  float* red_lse = inv + KP;               // (KP, P, 2): each part's (max, sum of exp)
  float* red_dens = red_lse + 2 * P * KP;  // (KP, P, 2): each part's (sum, count)
  float* blk_lse = red_dens + 2 * P * KP;  // (KP, 2): the block's (max, sum of exp)
  float* blk_dens = blk_lse + 2 * KP;      // (KP, 2): the block's (sum, count)
  float* normbuf = blk_dens + 2 * KP;      // (MAX_CLUSTER, KP): each rank's squared norms
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L.bars);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, wg = tid >> 7;
  const float* m = p.mask + (size_t)g * N;
  Ring ring{smem + L.ring + wg * p.stages * BOX_BYTES, bars + wg * MAX_STAGES, &fmap, p.stages, 0};
  // a reduction over the block's features takes them in P parts
  const int part_len = (cnt + P - 1) / P;

  if (BF16 && (tid & 127) == 0) {
    for (int s = 0; s < p.stages; ++s) mbar_init(&ring.full[s], 1);
    mbar_init_fence();
  }
  // the initial prototypes, the same in every block: norms and operand
  const float* p0 = p.prot0 + (size_t)g * K * D;
  for (int k = warp; k < KP; k += NWARPS) {
    float s = 0.f;
    for (int d = 2 * lane; d < DT * 64; d += 64) {
      const float v0 = k < K && d < D ? p0[k * D + d] : 0.f;
      const float v1 = k < K && d + 1 < D ? p0[k * D + d + 1] : 0.f;
      s += v0 * v0 + v1 * v1;
      if (BF16 || d < D) put_pair<KP, BF16>(op, k, d, v0, v1, D);
    }
    s = warp_sum(s);
    if (lane == 0) na[k] = fmaxf(sqrtf(s), 1e-8f);
  }
  for (int k = tid; k < KP; k += NTHREADS) tau[k] = p.tau0;
  for (int t = tid; t < S; t += NTHREADS) {
    w[t] = 0.f;
    idx[t] = -1;
    mv[t] = t < cnt ? m[n_lo + t] : 0.f;
    nbv[t] = t < cnt ? p.nbase[n_lo + t] : 0.f;
  }
  fence_async_smem();
  __syncthreads();

  auto sim_pass = [&](const float* mm, float* dst, int ld, int col0) {
    if (BF16) {
      sim_pass_wgmma<KP>(ring, op, na, mm != nullptr ? mv : nullptr, nbv, dst, ld, col0, K, n_lo,
                         cnt, ntile, D, wg);
    } else {
      sim_pass_f32<KP>(reinterpret_cast<const float*>(op), na, p.ft, mm, p.nbase, dst, ld, col0, K,
                       N, n_lo, n_lo + cnt, D);
    }
  };
  if (p.n_shift > 0) sim_pass(m, sim, LDS, n_lo);
  __syncthreads();

  // the columns whose cluster-wide sum this rank computes
  const int dc = ((D + C - 1) / C + 1) & ~1;
  const int c0 = min(D, rank * dc), c1 = min(D, c0 + dc);

  for (int it = 0; it < p.n_shift; ++it) {
    // log-sum-exp over N of sim / (temp * tau_k): the (max, sum of exp -
    // max) of each part of the block's features, one warp per (prototype,
    // part) ...
    for (int task = warp; task < K * P; task += NWARPS) {
      const int k = task / P, pl = (task % P) * part_len, ph = min(cnt, pl + part_len);
      const float rk = 1.f / (p.temp * tau[k]);
      const float* row = sim + (size_t)k * LDS;
      float mx = -INFINITY;
      for (int t = pl + lane; t < ph; t += 32) mx = fmaxf(mx, row[t]);
      mx = __fmul_rn(warp_max(mx), rk);  // x -> x * rk is monotone: the max of the scaled row
      // __fmul_rn: the scaled value rounded before the subtraction, never
      // contracted into an FMA (with tau at its 1e-10 floor the scale is
      // 1e11, and an unrounded product minus its own rounding is +-4096)
      float sum = 0.f;
      for (int t = pl + lane; t < ph; t += 32) sum += expf(__fmul_rn(row[t], rk) - mx);
      sum = warp_sum(sum);
      if (lane == 0) {
        red_lse[2 * task] = mx;
        red_lse[2 * task + 1] = sum;
      }
    }
    __syncthreads();
    // ... combined over the parts, then over the cluster's ranks, in order
    for (int k = tid; k < K; k += NTHREADS) combine_lse(red_lse + 2 * P * k, blk_lse + 2 * k);
    cluster.sync();
    for (int k = tid; k < K; k += NTHREADS) {
      float mx = -INFINITY, sum = 0.f;
      for (int r = 0; r < C; ++r) mx = fmaxf(mx, cluster.map_shared_rank(blk_lse, r)[2 * k]);
      for (int r = 0; r < C; ++r) {
        const float* rr = cluster.map_shared_rank(blk_lse, r) + 2 * k;
        if (rr[0] > -INFINITY) sum += rr[1] * expf(rr[0] - mx);
      }
      lse[k] = logf(sum) + mx;
      inv[k] = 1.f / (p.temp * tau[k]);
    }
    __syncthreads();
    // hard assignment per feature (first maximum wins) and its weight
    for (int t = tid; t < cnt; t += NTHREADS) {
      float best = -INFINITY;
      int bi = 0;
      for (int k = 0; k < K; ++k) {
        const float lw = __fmul_rn(sim[(size_t)k * LDS + t], inv[k]) - lse[k];
        if (lw > best) {
          best = lw;
          bi = k;
        }
      }
      idx[t] = (int8_t)bi;
      w[t] = rnd<BF16>(expf(best) * mv[t]);
    }
    __syncthreads();
    // this block's partial prototypes ...
    if (BF16) {
      // W^T tiles (KP, 64 features) in region X, then the products
      for (int i = tid; i < ntile * 32; i += NTHREADS) {
        const int j = i >> 5, c = 2 * (i & 31), t = j * 64 + c;
        const int i0 = idx[t], i1 = idx[t + 1];
        const float w0 = w[t], w1 = w[t + 1];
        uint8_t* tile = wt + j * KP * 128;
#pragma unroll
        for (int k = 0; k < KP; ++k)
          *reinterpret_cast<__nv_bfloat162*>(tile + swz128(k, c)) =
              __floats2bfloat162_rn(i0 == k ? w0 : 0.f, i1 == k ? w1 : 0.f);
      }
      fence_async_smem();
      __syncthreads();
      update_wgmma<KP>(ring, wt, part, n_lo, ntile, D, wg);
    } else {
      for (int i = tid; i < KP * PD; i += NTHREADS) part[i] = 0.f;
      __syncthreads();
      for (int d = tid; d < D; d += NTHREADS)
        for (int t = 0; t < cnt; ++t) {
          const float wv = w[t];
          if (wv == 0.f) continue;
          part[idx[t] * PD + d] = fmaf(wv, p.f[(size_t)(n_lo + t) * D + d], part[idx[t] * PD + d]);
        }
    }
    __syncthreads();
    cluster.sync();
    // ... summed over the cluster in rank order, this rank's columns, and
    // written into every rank
    const bool last = it + 1 == p.n_shift;
    for (int k = warp; k < KP; k += NWARPS) {
      float ss = 0.f;
      for (int d = c0 + 2 * lane; d < c1; d += 64) {
        float v0 = 0.f, v1 = 0.f;
        for (int r = 0; r < C; ++r) {
          const float* pr = cluster.map_shared_rank(part, r) + k * PD;
          v0 += pr[d];
          if (d + 1 < c1) v1 += pr[d + 1];
        }
        ss += v0 * v0 + v1 * v1;
        for (int r = 0; r < C; ++r) put_pair<KP, BF16>(cluster.map_shared_rank(op, r), k, d, v0, v1, D);
        if (last && k < K) {
          float* o = p.out_prot + ((size_t)g * K + k) * D;
          o[d] = v0;
          if (d + 1 < c1) o[d + 1] = v1;
        }
      }
      ss = warp_sum(ss);
      if (lane == 0)
        for (int r = 0; r < C; ++r) cluster.map_shared_rank(normbuf, r)[rank * KP + k] = ss;
    }
    fence_async_smem();
    cluster.sync();
    fence_async_smem();
    for (int k = tid; k < KP; k += NTHREADS) {
      float s = 0.f;
      for (int r = 0; r < C; ++r) s += normbuf[r * KP + k];
      na[k] = fmaxf(sqrtf(s), 1e-8f);
    }
    __syncthreads();
    if (last) break;  // the last tau update is never read
    sim_pass(m, sim, LDS, n_lo);
    __syncthreads();
    // density bandwidth: tau_k = max(1 - mean assigned sim, 1e-10)
    for (int task = warp; task < K * P; task += NWARPS) {
      const int k = task / P, pl = (task % P) * part_len, ph = min(cnt, pl + part_len);
      const float* row = sim + (size_t)k * LDS;
      float sum = 0.f, n = 0.f;
      for (int t = pl + lane; t < ph; t += 32) {
        if (idx[t] == k) {
          sum += row[t];
          n += 1.f;
        }
      }
      sum = warp_sum(sum);
      n = warp_sum(n);
      if (lane == 0) {
        red_dens[2 * task] = sum;
        red_dens[2 * task + 1] = n;
      }
    }
    __syncthreads();
    for (int k = tid; k < K; k += NTHREADS) {
      float sum = 0.f, n = 0.f;
      for (int q = 0; q < P; ++q) {
        sum += red_dens[2 * (P * k + q)];
        n += red_dens[2 * (P * k + q) + 1];
      }
      blk_dens[2 * k] = sum;
      blk_dens[2 * k + 1] = n;
    }
    cluster.sync();
    for (int k = tid; k < K; k += NTHREADS) {
      float sum = 0.f, n = 0.f;
      for (int r = 0; r < C; ++r) {
        const float* rr = cluster.map_shared_rank(blk_dens, r) + 2 * k;
        sum += rr[0];
        n += rr[1];
      }
      const float dens = 1.f - (n >= 1.f ? sum / fmaxf(n, 1.f) : 0.f);
      tau[k] = fmaxf(dens, 1e-10f);
    }
    __syncthreads();
  }

  sim_pass(nullptr, p.out_sim + (size_t)g * K * N, N, 0);
  if (p.n_shift == 0 && rank == 0)
    for (int i = tid; i < K * D; i += NTHREADS) p.out_prot[(size_t)g * K * D + i] = p0[i];
  cluster.sync();  // no block leaves while another may read its shared memory
}

template <int KP, bool BF16>
cudaError_t prepare(size_t smem) {
  cudaError_t e = cudaFuncSetAttribute(meanshift_kernel<KP, BF16>,
                                       cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (e != cudaSuccess) return e;
  return cudaFuncSetAttribute(meanshift_kernel<KP, BF16>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <int KP, bool BF16>
int launch(const CUtensorMap& map, const Params& a, int G, int C, cudaStream_t stream) {
  const size_t smem = layout(KP, BF16, a.D, a.tb, a.stages).total;
  cudaError_t e = prepare<KP, BF16>(smem);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(G * C);
  cfg.blockDim = dim3(NTHREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, meanshift_kernel<KP, BF16>, map, a);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

template <bool BF16>
int dispatch(const CUtensorMap& map, const Params& a, int G, int C, cudaStream_t s) {
  if (a.K <= 8) return launch<8, BF16>(map, a, G, C, s);
  if (a.K <= 16) return launch<16, BF16>(map, a, G, C, s);
  if (a.K <= 24) return launch<24, BF16>(map, a, G, C, s);
  return launch<32, BF16>(map, a, G, C, s);
}

template <int KP, bool BF16>
int max_clusters(int C, size_t smem) {
  cudaError_t e = prepare<KP, BF16>(smem);
  if (e != cudaSuccess) return -(int)e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(C * 64);
  cfg.blockDim = dim3(NTHREADS);
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int n = 0;
  e = cudaOccupancyMaxActiveClusters(&n, meanshift_kernel<KP, BF16>, &cfg);
  return e == cudaSuccess ? n : -(int)e;
}


// ----------------------------------------- the second route: any K (above 32)
//
// The cluster kernel keeps its K x S similarities in shared memory and its
// prototypes' accumulators in registers, so it stops at K = 32. Above it the
// wrapper takes this route: the same iteration as a chain of simple kernels
// per step, the (G, K, N) similarities in device memory (out_sim serves as
// that scratch until the final pass writes it), on the stream in order:
//   kw_init     na_k = max(|P_k|, 1e-8), tau_k = tau0               (G K warps)
//   per iteration:
//   kw_sim      s[k, n] = cosine(P_k . f_n) / (temp * tau_k), dots of the
//               rounded operands as f32 FMAs, 64 x 64 tiles    (G, K/64, N/64)
//   kw_lse      lse_k = log sum_n exp(s[k, n] - max) + max        (G K blocks)
//   kw_assign   idx_n = first argmax_k (s[k, n] - lse_k), w_n = the weight
//               exp(.) at idx_n times m_n, rounded to the operand type (G N)
//   kw_update   P_k = sum_{n: idx_n = k} w_n f_n                   (G K blocks)
//   kw_density  na_k from the new P_k, tau_k = max(1 - mean_{n: idx_n = k}
//               cosine(P_k . f_n), 1e-10)                          (G K blocks)
//   The last two find their features by warp ballots over idx: each warp
//   takes a contiguous range of N in feature order, and the warps' sums are
//   added in warp order.
//   then kw_sim once more against the unmasked features into out_sim.
// No atomics: every sum runs in a fixed order, so two calls agree bit for bit.

constexpr int KW_TILE = 64;    // prototypes x features of one kw_sim block
constexpr int KW_BD = 16;      // dims per step of kw_sim
constexpr int KW_THREADS = 256;
constexpr int KW_ACC = 8;      // dims per lane of kw_update per sweep

struct KwParams {
  const float *mask, *f, *nbase;  // f: (N, D) f32 operands, or bf16 through fb
  const bf16* fb;
  float *prot, *sim, *lse, *tau, *na, *w;  // prot: out_prot, the current P
  int* idx;
  int K, N, D;
  float tau0, temp;
};

template <bool BF16>
__device__ __forceinline__ float feat(const KwParams& p, size_t i) {
  if (BF16) return __bfloat162float(p.fb[i]);
  return p.f[i];
}

// one warp per prototype row: its norm, and tau0
__global__ void kw_init(KwParams p, int rows) {
  const int row = blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const float* pr = p.prot + (size_t)row * p.D;
  float s = 0.f;
  for (int d = lane; d < p.D; d += 32) s += pr[d] * pr[d];
  s = warp_sum(s);
  if (lane == 0) {
    p.na[row] = fmaxf(sqrtf(s), 1e-8f);
    p.tau[row] = p.tau0;
  }
}

// s = P F^T of one instance's 64 x 64 tile: thread (tx, ty) owns prototypes
// ty + 16 i and features tx + 16 j; masked: the iteration's scaled
// similarity, else the final one against the unmasked features
template <bool BF16>
__global__ void __launch_bounds__(KW_THREADS) kw_sim(KwParams p, bool masked) {
  __shared__ float ps[KW_BD][KW_TILE + 1];
  __shared__ float fs[KW_BD][KW_TILE + 1];
  const int g = blockIdx.z, k0 = blockIdx.y * KW_TILE, n0 = blockIdx.x * KW_TILE;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const float* prot = p.prot + (size_t)g * p.K * p.D;
  float acc[4][4] = {};
  for (int d0 = 0; d0 < p.D; d0 += KW_BD) {
    for (int i = threadIdx.x; i < KW_TILE * KW_BD; i += KW_THREADS) {
      const int r = i / KW_BD, c = i % KW_BD, d = d0 + c;
      const int k = k0 + r, n = n0 + r;
      ps[c][r] = (k < p.K && d < p.D) ? rnd<BF16>(prot[(size_t)k * p.D + d]) : 0.f;
      fs[c][r] = (n < p.N && d < p.D) ? feat<BF16>(p, (size_t)n * p.D + d) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int c = 0; c < KW_BD; ++c) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = ps[c][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = fs[c][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
  const float* mrow = p.mask + (size_t)g * p.N;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int k = k0 + ty + 16 * i;
    if (k >= p.K) continue;
    const size_t gk = (size_t)g * p.K + k;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx + 16 * j;
      if (n >= p.N) continue;
      const float c = cosine(acc[i][j], masked, masked ? mrow[n] : 1.f, p.nbase[n], p.na[gk]);
      p.sim[gk * p.N + n] = masked ? __fdiv_rn(c, p.temp * p.tau[gk]) : c;
    }
  }
}

// the block's max or sum, in every thread; red: one float per warp
__device__ float block_reduce(float x, float* red, bool is_max) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x / 32;
  x = is_max ? warp_max(x) : warp_sum(x);
  __syncthreads();
  if (lane == 0) red[warp] = x;
  __syncthreads();
  float r = red[0];
  for (int i = 1; i < (int)blockDim.x / 32; ++i) r = is_max ? fmaxf(r, red[i]) : r + red[i];
  return r;
}

// one block per (instance, prototype) row of the scaled similarities
__global__ void __launch_bounds__(KW_THREADS) kw_lse(KwParams p) {
  __shared__ float red[KW_THREADS / 32];
  const size_t row = blockIdx.x;
  const float* s = p.sim + row * p.N;
  float mx = -INFINITY;
  for (int n = threadIdx.x; n < p.N; n += KW_THREADS) mx = fmaxf(mx, s[n]);
  mx = block_reduce(mx, red, true);
  float sum = 0.f;
  for (int n = threadIdx.x; n < p.N; n += KW_THREADS) sum += expf(s[n] - mx);
  sum = block_reduce(sum, red, false);
  if (threadIdx.x == 0) p.lse[row] = logf(sum) + mx;
}

// one thread per (instance, feature): the hard assignment (first maximum
// of the log weights wins, as torch's argmax) and the rounded weight
template <bool BF16>
__global__ void kw_assign(KwParams p, int G) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (size_t)G * p.N) return;
  const int g = (int)(i / p.N), n = (int)(i % p.N);
  const size_t base = (size_t)g * p.K;
  int best = 0;
  float top = p.sim[base * p.N + n] - p.lse[base];
  for (int k = 1; k < p.K; ++k) {
    const float lw = p.sim[(base + k) * p.N + n] - p.lse[base + k];
    if (lw > top) {
      top = lw;
      best = k;
    }
  }
  p.idx[i] = best;
  p.w[i] = p.mask[i] != 0.f ? rnd<BF16>(expf(top)) : 0.f;
}

// The features warp w of a block scans for its prototype: the w-th of
// KW_WARPS contiguous ranges of [0, N), 32 at a time by a ballot of idx == k,
// so each warp meets its matches in feature order
constexpr int KW_WARPS = 16;  // warps of kw_update and kw_density: the features of one
                              // prototype may be most of N (near-ties merge prototypes)

// one block per (instance, prototype): the weighted sum of its features,
// each warp's matches in feature order, the warps' partial sums added in
// warp order; lanes over dims, KW_ACC dims per lane per sweep of 32 KW_ACC
template <bool BF16>
__global__ void __launch_bounds__(32 * KW_WARPS) kw_update(KwParams p) {
  __shared__ float part[KW_WARPS][32 * KW_ACC];
  const int g = blockIdx.x / p.K, k = blockIdx.x % p.K;
  const int lane = threadIdx.x & 31, warp = threadIdx.x / 32;
  const int* idx = p.idx + (size_t)g * p.N;
  const float* w = p.w + (size_t)g * p.N;
  const int per = (p.N + KW_WARPS - 1) / KW_WARPS;
  const int n0 = warp * per, n1 = min(p.N, n0 + per);
  float* out = p.prot + ((size_t)g * p.K + k) * p.D;
  for (int d0 = 0; d0 < p.D; d0 += 32 * KW_ACC) {
    float acc[KW_ACC] = {};
    for (int base = n0; base < n1; base += 32) {
      const int n = base + lane;
      unsigned m = __ballot_sync(0xffffffffu, n < n1 && idx[n] == k);
      while (m) {
        const int nn = base + __ffs(m) - 1;
        m &= m - 1;
        const float wt = w[nn];
        const size_t row = (size_t)nn * p.D;
#pragma unroll
        for (int a = 0; a < KW_ACC; ++a) {
          const int d = d0 + lane + 32 * a;
          if (d < p.D) acc[a] = fmaf(wt, feat<BF16>(p, row + d), acc[a]);
        }
      }
    }
#pragma unroll
    for (int a = 0; a < KW_ACC; ++a) part[warp][lane + 32 * a] = acc[a];
    __syncthreads();
    for (int c = threadIdx.x; c < 32 * KW_ACC; c += 32 * KW_WARPS) {
      const int d = d0 + c;  // part[v][lane + 32 a] holds dim d0 + lane + 32 a
      float sum = part[0][c];
      for (int v = 1; v < KW_WARPS; ++v) sum += part[v][c];
      if (d < p.D) out[d] = sum;
    }
    __syncthreads();
  }
}

// one block per (instance, prototype): the new norm, then the mean
// similarity of the features assigned to it (masked ones add 0 and count),
// each warp's matches in feature order, the warps' sums added in warp order
template <bool BF16>
__global__ void __launch_bounds__(32 * KW_WARPS) kw_density(KwParams p) {
  extern __shared__ float kw_smem[];
  constexpr int NW = KW_WARPS;
  float* pk = kw_smem;             // the prototype's operand copy, D floats
  float* red = kw_smem + p.D;      // one slot per warp
  __shared__ int rcnt[NW];
  const int g = blockIdx.x / p.K, k = blockIdx.x % p.K;
  const int lane = threadIdx.x & 31, warp = threadIdx.x / 32;
  const size_t gk = (size_t)g * p.K + k;
  const float* pr = p.prot + gk * p.D;
  float s = 0.f;
  for (int d = threadIdx.x; d < p.D; d += 32 * KW_WARPS) {
    s += pr[d] * pr[d];
    pk[d] = rnd<BF16>(pr[d]);
  }
  const float na = fmaxf(sqrtf(block_reduce(s, red, false)), 1e-8f);
  const int* idx = p.idx + (size_t)g * p.N;
  const float* mrow = p.mask + (size_t)g * p.N;
  const int per = (p.N + NW - 1) / NW;
  const int n0 = warp * per, n1 = min(p.N, n0 + per);
  float dens = 0.f;  // this warp's sum, in every lane
  int cnt = 0;
  for (int base = n0; base < n1; base += 32) {
    const int n = base + lane;
    unsigned m = __ballot_sync(0xffffffffu, n < n1 && idx[n] == k);
    cnt += __popc(m);
    while (m) {
      const int nn = base + __ffs(m) - 1;
      m &= m - 1;
      const float mv = mrow[nn];
      if (mv == 0.f) continue;
      float dot = 0.f;
      for (int d = lane; d < p.D; d += 32) dot = fmaf(pk[d], feat<BF16>(p, (size_t)nn * p.D + d), dot);
      dens += cosine(warp_sum(dot), true, mv, p.nbase[nn], na);
    }
  }
  __syncthreads();  // block_reduce's last reads of red are done
  if (lane == 0) {
    red[warp] = dens;
    rcnt[warp] = cnt;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float sum = 0.f;
    int total = 0;
    for (int i = 0; i < NW; ++i) {
      sum += red[i];
      total += rcnt[i];
    }
    const float n = (float)total;
    p.na[gk] = na;
    p.tau[gk] = fmaxf(1.f - (n >= 1.f ? sum / fmaxf(n, 1.f) : 0.f), 1e-10f);
  }
}

template <bool BF16>
int kw_forward(const KwParams& p, const float* prot0, int G, int n_shift, cudaStream_t s) {
  const size_t pbytes = (size_t)G * p.K * p.D * sizeof(float);
  cudaError_t e = cudaMemcpyAsync(p.prot, prot0, pbytes, cudaMemcpyDeviceToDevice, s);
  if (e != cudaSuccess) return (int)e;
  const int rows = G * p.K;
  kw_init<<<(rows + 7) / 8, 256, 0, s>>>(p, rows);
  const dim3 sim_grid((p.N + KW_TILE - 1) / KW_TILE, (p.K + KW_TILE - 1) / KW_TILE, G);
  const size_t dens_smem = (p.D + KW_WARPS) * sizeof(float);
  if (dens_smem > 48 * 1024) {
    e = cudaFuncSetAttribute(kw_density<BF16>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)dens_smem);
    if (e != cudaSuccess) return (int)e;
  }
  const size_t gn = (size_t)G * p.N;
  for (int it = 0; it < n_shift; ++it) {
    kw_sim<BF16><<<sim_grid, KW_THREADS, 0, s>>>(p, true);
    kw_lse<<<rows, KW_THREADS, 0, s>>>(p);
    kw_assign<BF16><<<(unsigned)((gn + 255) / 256), 256, 0, s>>>(p, G);
    kw_update<BF16><<<rows, 32 * KW_WARPS, 0, s>>>(p);
    kw_density<BF16><<<rows, 32 * KW_WARPS, dens_smem, s>>>(p);
  }
  kw_sim<BF16><<<sim_grid, KW_THREADS, 0, s>>>(p, false);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Shared memory of one block for KP prototypes (8, 16, 24 or 32), D dims,
// tb tiles of 64 features and `stages` ring slots per warpgroup (1 to 4).
size_t meanshift_smem_bytes(int KP, int bf16, int D, int tb, int stages) {
  return layout(KP, bf16 != 0, D, tb, stages).total;
}

// How many clusters of C blocks with `smem` bytes each can be resident at
// once (cudaOccupancyMaxActiveClusters), or minus the cudaError_t.
int meanshift_max_clusters(int KP, int bf16, int C, size_t smem) {
  if (bf16) {
    if (KP == 8) return max_clusters<8, true>(C, smem);
    if (KP == 16) return max_clusters<16, true>(C, smem);
    if (KP == 24) return max_clusters<24, true>(C, smem);
    return max_clusters<32, true>(C, smem);
  }
  if (KP == 8) return max_clusters<8, false>(C, smem);
  if (KP == 16) return max_clusters<16, false>(C, smem);
  if (KP == 24) return max_clusters<24, false>(C, smem);
  return max_clusters<32, false>(C, smem);
}

// prot0 (G, K, D), mask (G, N), nbase (N,): f32 contiguous; K <= 32.
// f32 dots: f (N, D) and ft (D, N) f32, fb null.
// bf16 dots: fb (N, D) bf16 (the features rounded once), f/ft null;
// D a multiple of 16.
// cluster: blocks per instance (<= 8); tb: 64-feature tiles per block
// (cluster * tb * 64 >= N); stages: ring slots per warpgroup (1 to 4).
// out_prot (G, K, D), out_sim (G, K, N): f32.
int meanshift_forward(const void* prot0, const void* mask, const void* f, const void* ft,
                      const void* fb, const void* nbase, void* out_prot, void* out_sim, int G,
                      int K, int N, int D, int n_shift, int cluster, int tb, int stages,
                      float tau0, float temp, int mm_bf16, void* stream) {
  if (cluster < 1 || cluster > MAX_CLUSTER || stages < 1 || stages > MAX_STAGES ||
      (long)cluster * tb * 64 < N)
    return (int)cudaErrorInvalidValue;
  const Params a{(const float*)prot0, (const float*)mask, (const float*)f, (const float*)ft,
                 (const float*)nbase, (float*)out_prot, (float*)out_sim, K, N, D, n_shift, tb,
                 stages, tau0, temp};
  CUtensorMap map = {};
  if (mm_bf16) {
    // a runtime call first: the driver entry point needs the context current
    cudaFree(nullptr);
    if (int bad = make_map_2d(&map, fb, N, D)) return bad;
    return dispatch<true>(map, a, G, cluster, (cudaStream_t)stream);
  }
  return dispatch<false>(map, a, G, cluster, (cudaStream_t)stream);
}

// The second route (any K; the wrapper takes it above K = 32): prot0 (G, K,
// D), mask (G, N), nbase (N,) f32 contiguous; f (N, D) f32 operands, or with
// mm_bf16 fb (N, D) bf16 (the features rounded once) and f null. work: f32
// scratch of meanshift_kwide_work_floats(G, K, N) floats. out_prot (G, K,
// D), out_sim (G, K, N) f32; out_prot also carries the iterates and out_sim
// the scaled similarities until the final pass. Any D >= 1, N >= 1.
size_t meanshift_kwide_work_floats(int G, int K, int N) {
  return 3 * (size_t)G * K + 2 * (size_t)G * N;
}

int meanshift_kwide_forward(const void* prot0, const void* mask, const void* f, const void* fb,
                            const void* nbase, void* out_prot, void* out_sim, void* work, int G,
                            int K, int N, int D, int n_shift, float tau0, float temp,
                            int mm_bf16, void* stream) {
  if (G < 1 || K < 1 || N < 1 || D < 1 || n_shift < 0 || (mm_bf16 ? fb : f) == nullptr)
    return (int)cudaErrorInvalidValue;
  float* wk = (float*)work;
  const size_t gk = (size_t)G * K, gn = (size_t)G * N;
  const KwParams p{(const float*)mask, (const float*)f, (const float*)nbase, (const bf16*)fb,
                   (float*)out_prot, (float*)out_sim, wk, wk + gk, wk + 2 * gk,
                   wk + 3 * gk, (int*)(wk + 3 * gk + gn), K, N, D, tau0, temp};
  const cudaStream_t s = (cudaStream_t)stream;
  if (mm_bf16) return kw_forward<true>(p, (const float*)prot0, G, n_shift, s);
  return kw_forward<false>(p, (const float*)prot0, G, n_shift, s);
}

}  // extern "C"
