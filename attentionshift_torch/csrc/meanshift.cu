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
// wrapper takes this route: the same iteration as a short chain of kernels
// per step, the (G, K, N) similarities in device memory (out_sim serves as
// that scratch until the final pass writes it), on the stream in order. No
// atomics: every sum runs in a fixed order, so two calls agree bit for bit.
//   kwt_init    the initial prototypes' squared norms per 64 dims, and with
//               bf16 operands their bf16 copy pb                 (G K warps)
//   per iteration:
//   sim         c[k, n] = cosine(P_k . f_n), unscaled, into out_sim, per
//               (64 features, 64 prototypes) tile; from the second
//               iteration on also each (prototype, tile)'s (sum, count) of
//               c over the tile's features the previous iteration assigned
//               to it: c is the similarity to the new prototypes, so these
//               are the density partials of the previous update
//   kwt_lse     tau_k from the density partials in tile order (tau0 at the
//               first iteration), then s = c / (temp tau_k), written back
//               over c, and lse_k of s over N                     (G K blocks)
//   kwt_assign  idx_n = first argmax_k (s - lse_k), w_n = exp(.) m_n,
//               rounded to bf16 with bf16 operands
//                                                (G N / 32 blocks of 8 warps)
//   update      P_k = sum_{n: idx_n = k} w_n f_n, and its squared norms per
//               64 dims
//   then sim once more, against the unmasked features, into out_sim.
// Only the two products depend on the operand type: with f32 operands
// (exact f32 products) kw_sim and kw_update on scalar FMAs; with bf16
// operands kwt_sim and kwt_update on the tensor cores (further below).

constexpr int KW_TILE = 64;  // prototypes x features of one kw_sim block, and the tiles of the partials
constexpr int KWT_LSE_THREADS = 256;
constexpr int KWT_ASSIGN_GROUPS = 8;  // groups of prototypes per feature in kwt_assign

struct KwtParams {
  const float *mask, *nbase;
  const float* f;     // (N, D): the f32 operands (null with bf16 operands)
  const bf16* fb;     // (N, D): the bf16 operands (null with f32 operands)
  float *prot, *sim;  // out_prot (G, K, D): the iterate; out_sim (G, K, N): c, then the output
  bf16* pb;           // (G, K, D): the prototypes rounded to bf16 (null with f32 operands)
  float* norm;        // (G, K, DT): squared norms per 64 dims
  float2* dens;       // (G, K, NT): (sum, count) of c over each tile's assigned features
  float *lse, *w;     // (G, K): the log-sum-exps; (G, N): the weights
  int* idx;           // (G, N): the assignments
  int K, N, D, NT, DT;
  float tau0, temp;
};

// the scratch's parts, offsets in floats, each a multiple of 4 (16 bytes)
struct KwtWork {
  size_t pb, norm, dens, lse, w, idx, total;
};

inline KwtWork kwt_work(int G, int K, int N, int D, bool bf16) {
  const size_t gk = (size_t)G * K, gn = (size_t)G * N;
  const size_t nt = (N + 63) / 64, dt = (D + 63) / 64;
  KwtWork o;
  o.pb = 0;
  o.norm = o.pb + (bf16 ? up(gk * D / 2, 4) : 0);
  o.dens = o.norm + up(gk * dt, 4);
  o.lse = o.dens + up(2 * gk * nt, 4);
  o.w = o.lse + up(gk, 4);
  o.idx = o.w + up(gn, 4);
  o.total = o.idx + up(gn, 4);
  return o;
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

// the initial prototypes: one warp per (instance, prototype) row
__global__ void kwt_init(const float* __restrict__ prot0, KwtParams p, int rows) {
  const int row = blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32, lane = threadIdx.x & 31;
  if (row >= rows) return;
  const float* pr = prot0 + (size_t)row * p.D;
  for (int db = 0; db < p.DT; ++db) {
    const int d = db * 64 + 2 * lane;
    const float v0 = d < p.D ? pr[d] : 0.f, v1 = d + 1 < p.D ? pr[d + 1] : 0.f;
    if (p.pb != nullptr && d < p.D)  // bf16 operands: D is even, d < D holds d + 1 too
      *reinterpret_cast<__nv_bfloat162*>(p.pb + (size_t)row * p.D + d) =
          __floats2bfloat162_rn(v0, v1);
    const float s = warp_sum(v0 * v0 + v1 * v1);
    if (lane == 0) p.norm[(size_t)row * p.DT + db] = s;
  }
}

// one block per (instance, prototype) row: tau_k (tau0 when `first`), then
// s = c / (temp tau_k), written over c, and the log-sum-exp of s over N:
// thread i takes n = i, i + KWT_LSE_THREADS, ... in order
__global__ void __launch_bounds__(KWT_LSE_THREADS) kwt_lse(KwtParams p, int first) {
  __shared__ float red[KWT_LSE_THREADS / 32];
  __shared__ float tt_s;
  const size_t row = blockIdx.x;
  if (threadIdx.x < 32) {
    float tau = p.tau0;
    if (!first) {  // the density partials in tile order per lane, the lanes by a fixed tree
      float sum = 0.f, n = 0.f;
      for (int i = threadIdx.x; i < p.NT; i += 32) {
        const float2 v = p.dens[row * p.NT + i];
        sum += v.x;
        n += v.y;
      }
      sum = warp_sum(sum);
      n = warp_sum(n);
      tau = fmaxf(1.f - (n >= 1.f ? sum / fmaxf(n, 1.f) : 0.f), 1e-10f);
    }
    if (threadIdx.x == 0) tt_s = p.temp * tau;
  }
  __syncthreads();
  const float tt = tt_s;
  float* s = p.sim + row * p.N;
  float mx = -INFINITY;
#pragma unroll 4
  for (int n = threadIdx.x; n < p.N; n += KWT_LSE_THREADS) mx = fmaxf(mx, s[n]);
  // x -> x / tt is monotone: the scaled row's max is the max's quotient
  mx = __fdiv_rn(block_reduce(mx, red, true), tt);
  // s / tt correctly rounded without a division (Markstein): rc the correctly
  // rounded reciprocal, q = s rc within an ulp, then q + (s - q tt) rc
  // rounded once
  const float rc = __frcp_rn(tt);
  float sum = 0.f;
  for (int n = threadIdx.x; n < p.N; n += KWT_LSE_THREADS) {
    const float q = __fmul_rn(s[n], rc);
    const float x = __fmaf_rn(__fmaf_rn(-q, tt, s[n]), rc, q);
    s[n] = x;
    sum += expf(x - mx);
  }
  sum = block_reduce(sum, red, false);
  if (threadIdx.x == 0) p.lse[row] = logf(sum) + mx;
}

// block (x, y): instance y, features [32 x, 32 x + 32); thread (lane, w)
// the lane's feature over the prototypes w, w + KWT_ASSIGN_GROUPS, ... The
// hard assignment (first maximum of the log weights wins, as torch's
// argmax: each group's first maximum, then the groups' largest, the lower
// prototype on a tie) and the weight, rounded to bf16 with bf16 operands.
template <bool BF16>
__global__ void __launch_bounds__(32 * KWT_ASSIGN_GROUPS) kwt_assign(KwtParams p) {
  __shared__ float top_s[KWT_ASSIGN_GROUPS][32];
  __shared__ int best_s[KWT_ASSIGN_GROUPS][32];
  const int g = blockIdx.y, lane = threadIdx.x & 31, w = threadIdx.x / 32;
  const int n = blockIdx.x * 32 + lane;
  const size_t base = (size_t)g * p.K;
  float top = -INFINITY;
  int best = p.K;
  if (n < p.N) {
    const float* c = p.sim + base * p.N + n;
#pragma unroll 4
    for (int k = w; k < p.K; k += KWT_ASSIGN_GROUPS) {
      const float lw = c[(size_t)k * p.N] - p.lse[base + k];
      if (lw > top) {
        top = lw;
        best = k;
      }
    }
  }
  top_s[w][lane] = top;
  best_s[w][lane] = best;
  __syncthreads();
  if (w != 0 || n >= p.N) return;
  for (int i = 1; i < KWT_ASSIGN_GROUPS; ++i) {
    const float v = top_s[i][lane];
    const int k = best_s[i][lane];
    if (v > top || (v == top && k < best)) {
      top = v;
      best = k;
    }
  }
  const size_t i = (size_t)g * p.N + n;
  p.idx[i] = best;
  p.w[i] = p.mask[i] != 0.f ? rnd<BF16>(expf(top)) : 0.f;
}

// ------------------------------------------ the second route with f32 operands

constexpr int KW_BD = 16;      // dims per step of kw_sim
constexpr int KW_THREADS = 256;
constexpr int KW_ACC = 8;      // dims per lane of kw_update per sweep

// s = P F^T of one instance's 64 x 64 tile: thread (tx, ty) owns prototypes
// ty + 16 i and features tx + 16 j. mode 0: the final similarity against
// the unmasked features; 1: the iteration's masked c; 2: c and the
// density partials of the tile (feature tile blockIdx.x)
__global__ void __launch_bounds__(KW_THREADS) kw_sim(KwtParams p, int mode) {
  __shared__ float ps[KW_BD][KW_TILE + 1];
  __shared__ float fs[KW_BD][KW_TILE + 1];
  __shared__ float na[KW_TILE], dv[KW_TILE];
  __shared__ int di[KW_TILE];  // the tile's features' assignment - k0, -1 past N
  const bool masked = mode > 0, density = mode == 2;
  const int g = blockIdx.z, k0 = blockIdx.y * KW_TILE, n0 = blockIdx.x * KW_TILE;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const float* prot = p.prot + (size_t)g * p.K * p.D;
  if (threadIdx.x < KW_TILE) {
    const int t = threadIdx.x, n = n0 + t;
    float s = 0.f;
    if (k0 + t < p.K)
      for (int db = 0; db < p.DT; ++db) s += p.norm[((size_t)g * p.K + k0 + t) * p.DT + db];
    na[t] = fmaxf(sqrtf(s), 1e-8f);
    di[t] = density && n < p.N ? p.idx[(size_t)g * p.N + n] - k0 : -1;
  }
  float acc[4][4] = {};
  for (int d0 = 0; d0 < p.D; d0 += KW_BD) {
    for (int i = threadIdx.x; i < KW_TILE * KW_BD; i += KW_THREADS) {
      const int r = i / KW_BD, c = i % KW_BD, d = d0 + c;
      const int k = k0 + r, n = n0 + r;
      ps[c][r] = (k < p.K && d < p.D) ? prot[(size_t)k * p.D + d] : 0.f;
      fs[c][r] = (n < p.N && d < p.D) ? p.f[(size_t)n * p.D + d] : 0.f;
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
    const int kl = ty + 16 * i, k = k0 + kl;
    if (k >= p.K) continue;
    const size_t gk = (size_t)g * p.K + k;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx + 16 * j;
      if (n >= p.N) continue;
      const float c = cosine(acc[i][j], masked, masked ? mrow[n] : 1.f, p.nbase[n], na[kl]);
      p.sim[gk * p.N + n] = c;
      if (di[tx + 16 * j] == kl) dv[tx + 16 * j] = c;
    }
  }
  if (!density) return;
  __syncthreads();
  // each prototype's sum over the tile's features assigned to it, in row order
  const int t = threadIdx.x;
  if (t < KW_TILE && k0 + t < p.K) {
    float sum = 0.f, cnt = 0.f;
    for (int r = 0; r < KW_TILE; ++r)
      if (di[r] == t) {
        sum += dv[r];
        cnt += 1.f;
      }
    p.dens[((size_t)g * p.K + k0 + t) * p.NT + blockIdx.x] = make_float2(sum, cnt);
  }
}

// The features warp w of a block scans for its prototype: the w-th of
// KW_WARPS contiguous ranges of [0, N), 32 at a time by a ballot of idx == k,
// so each warp meets its matches in feature order
constexpr int KW_WARPS = 16;  // warps of kw_update: the features of one prototype
                              // may be most of N (near-ties merge prototypes)

// one block per (instance, prototype): the weighted sum of its features,
// each warp's matches in feature order, the warps' partial sums added in
// warp order; lanes over dims, KW_ACC dims per lane per sweep of 32 KW_ACC;
// then its squared norms per 64 dims (warp w the boxes w, w + KW_WARPS, ...)
__global__ void __launch_bounds__(32 * KW_WARPS) kw_update(KwtParams p) {
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
          if (d < p.D) acc[a] = fmaf(wt, p.f[row + d], acc[a]);
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
    __syncthreads();  // the block's stores of out are seen by every thread after it
  }
  for (int db = warp; db < p.DT; db += KW_WARPS) {
    float s = 0.f;
    for (int d = db * 64 + lane; d < min(p.D, db * 64 + 64); d += 32) s += out[d] * out[d];
    s = warp_sum(s);
    if (lane == 0) p.norm[((size_t)g * p.K + k) * p.DT + db] = s;
  }
}

int kw_forward(const KwtParams& p, const float* prot0, int G, int n_shift, cudaStream_t s) {
  const int rows = G * p.K;
  cudaError_t e = cudaMemcpyAsync(p.prot, prot0, (size_t)rows * p.D * sizeof(float),
                                  cudaMemcpyDeviceToDevice, s);
  if (e != cudaSuccess) return (int)e;
  kwt_init<<<(rows + 7) / 8, 256, 0, s>>>(prot0, p, rows);
  const dim3 sim_grid(p.NT, (p.K + KW_TILE - 1) / KW_TILE, G);
  for (int it = 0; it < n_shift; ++it) {
    kw_sim<<<sim_grid, KW_THREADS, 0, s>>>(p, it > 0 ? 2 : 1);
    kwt_lse<<<rows, KWT_LSE_THREADS, 0, s>>>(p, it == 0);
    kwt_assign<false><<<dim3((p.N + 31) / 32, G), 32 * KWT_ASSIGN_GROUPS, 0, s>>>(p);
    kw_update<<<rows, 32 * KW_WARPS, 0, s>>>(p);
  }
  kw_sim<<<sim_grid, KW_THREADS, 0, s>>>(p, 0);
  return (int)cudaGetLastError();
}

// ------------------------- the second route with bf16 operands: the tensor cores
//
// The two products on wgmma from TMA-fed shared memory (the cluster
// kernel's (64 rows, 64 dims) bf16 boxes under the 128-byte swizzle), the
// prototypes in chunks of 64 (one m64n64k16 product's N):
//   kwt_sim     S = F P^T per (64 features, 64 prototypes): the feature box
//               and pb's box, both K-major; the KWT_WG consumer warpgroups
//               of a block take a tile each and share the prototype box of
//               each 64-dim step, a producer warp keeps a ring of such steps
//               in flight. Writes c and the density partials (see above).
//                                                 (tile groups, chunks, G)
//   kwt_update  P = W F over all N per (64 dims, chunk, instance): W (64
//               prototypes x 64 features, one nonzero per feature, bf16)
//               built in registers as the A operand, the feature box read
//               MN-major; warpgroup w takes the tiles w, w + KWU_WG, ...,
//               their sums added in warpgroup order. Writes P (f32, into
//               out_prot), pb and the squared norms
// What bounds it: at (G 20, K 256, N 4200, D 384) each product is 16.5
// GFLOP (17 us at 989 TFLOP/s) and the f32 similarities 86 MB, past the 50
// MB L2: per iteration kwt_sim writes them, kwt_lse reads them twice and
// writes them once, kwt_assign reads them, 128 us at 3.35 TB/s; at K 64
// they are 21.5 MB and stay in the L2. On the card kwt_sim is bound by its
// stores of c (their cosines and the rows' reads), kwt_lse by its three
// passes over c (its quotients take no division: see kwt_lse), kwt_update
// by its chain of dependent steps (a TMA wait, the products, their wait):
// hence several warpgroups per block, each on tiles
// of its own, and W in registers (a one-hot tile in shared memory needed a
// proxy fence per step, a third of the kernel's time).

#define KW_F8(i)                                                                           \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]), "+f"(d[i + 5]), \
      "+f"(d[i + 6]), "+f"(d[i + 7])

// D (64 x 64, f32: 32 per thread) += A (64 x 16) * B (16 x 64), both from
// shared memory; TA / TB: the operand is MN-major
template <int TA, int TB>
__device__ __forceinline__ void wgmma64(float (&d)[32], uint64_t da, uint64_t db) {
  const int one = 1;
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
               "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
               "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
               "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"
               ", %32, %33, p, 1, 1, %35, %36;\n}\n"
               : KW_F8(0), KW_F8(8), KW_F8(16), KW_F8(24)
               : "l"(da), "l"(db), "r"(one), "n"(TA), "n"(TB));
}
#undef KW_F8

constexpr int KC = 64;          // prototypes per chunk
constexpr int KWT_STAGES = 3;   // ring slots of kwt_sim: KWT_WG feature boxes + a prototype box each
constexpr int KWT_WG = 2;       // consumer warpgroups of kwt_sim, a feature tile each per round
constexpr int KWU_STAGES = 3;   // ring slots of kwt_update: KWU_WG feature boxes each
constexpr int KWU_WG = 4;       // consumer warpgroups of kwt_update, every KWU_WG-th tile each
constexpr int KWT_CONSUMERS = 128 * KWT_WG;
constexpr int KWT_THREADS = KWT_CONSUMERS + 32;  // + the producer warp
constexpr int KWU_CONSUMERS = 128 * KWU_WG;
constexpr int KWU_THREADS = KWU_CONSUMERS + 32;

// the ring, its "full" and "free" barriers, the chunk's norms, each
// warpgroup's rows of c and of assignments, the alignment of the base
constexpr size_t KWT_SIM_SMEM =
    KWT_STAGES * (KWT_WG + 1) * BOX_BYTES + 2 * KWT_STAGES * 8 + KC * 4 + KWT_WG * 64 * 8 + 1024;

// the ring, each warpgroup's (prototype, weight) pairs of two tiles, the
// barriers, the alignment; the other warpgroups' partial sums (64 KC
// floats each) reuse the ring once the products are done
constexpr size_t KWT_UPDATE_SMEM =
    KWU_STAGES * KWU_WG * BOX_BYTES + 2 * KWU_WG * 64 * 8 + 2 * KWU_STAGES * 8 + 1024;
static_assert((KWU_WG - 1) * 64 * KC * 4 <= KWU_STAGES * KWU_WG * BOX_BYTES,
              "the partial sums fit where the ring was");

__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 5, %0;\n" ::"n"(KWU_CONSUMERS) : "memory");
}

// The rows' (mask value, norm, assignment - k0) of this thread's two rows
// of `tile`, read before the round's products so that they arrive meanwhile.
struct KwtRows {
  float mv[2], nb[2];
  int ix[2];
};

__device__ __forceinline__ KwtRows kwt_rows(const KwtParams& p, int g, int k0, int tile,
                                            bool masked, bool density) {
  const int lane = threadIdx.x & 31, ra = 16 * ((threadIdx.x & 127) >> 5) + (lane >> 2);
  KwtRows r;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int n = tile * 64 + ra + 8 * h;
    const bool in = n < p.N;
    r.mv[h] = in && masked ? p.mask[(size_t)g * p.N + n] : 1.f;
    r.nb[h] = in ? p.nbase[n] : 1.f;
    r.ix[h] = in && density ? p.idx[(size_t)g * p.N + n] - k0 : -1;
  }
  return r;
}

// kwt_sim's writes of one warpgroup's tile: c into the similarities, and
// with `density` each prototype's (sum, count) over the tile's features that
// idx assigns to it. dv, di: the warpgroup's 64 rows of c at the assigned
// prototype and of the assignment (relative to k0, -1 outside the chunk).
__device__ __forceinline__ void kwt_sim_store(const float (&acc)[32], const KwtParams& p,
                                              const KwtRows& rows, const float* na, float* dv,
                                              int* di, int g, int k0, int tile, bool masked,
                                              bool density, int wg) {
  const int t = threadIdx.x & 127, lane = t & 31;
  const int ra = 16 * (t >> 5) + (lane >> 2);  // rows ra and ra + 8
  const float* mv = rows.mv;
  const float* nb = rows.nb;
  const int* ix = rows.ix;
  if (density && (lane & 3) == 0) {
    di[ra] = ix[0];
    di[ra + 8] = ix[1];
  }
  float* out = p.sim + (size_t)g * p.K * p.N;
#pragma unroll
  for (int e = 0; e < 32; ++e) {
    const int h = (e >> 1) & 1, kl = (e >> 2) * 8 + 2 * (lane & 3) + (e & 1);
    const int n = tile * 64 + ra + 8 * h;
    if (n < p.N && k0 + kl < p.K) {
      const float c = cosine(acc[e], masked, mv[h], nb[h], na[kl]);
      out[(size_t)(k0 + kl) * p.N + n] = c;
      if (kl == ix[h]) dv[ra + 8 * h] = c;
    }
  }
  if (!density) return;
  wg_sync(wg);
  if (t < KC && k0 + t < p.K) {
    float sum = 0.f, cnt = 0.f;
#pragma unroll 16
    for (int r = 0; r < 64; ++r)
      if (di[r] == t) {
        sum += dv[r];
        cnt += 1.f;
      }
    p.dens[((size_t)g * p.K + k0 + t) * p.NT + tile] = make_float2(sum, cnt);
  }
  wg_sync(wg);  // dv and di are read before the next tile writes them
}

// block (x, y, z): instance z, prototypes [64 y, 64 y + 64), feature tiles
// [x tpb, x tpb + tpb) in rounds of KWT_WG (warpgroup w takes the round's
// tile w); each round a step per 64 dims. Every step loads KWT_WG feature
// boxes (rows past N arrive as zeros) and the chunk's prototype box, and
// every warpgroup multiplies at every step: a tile past the block's only
// skips its stores.
__global__ void __launch_bounds__(KWT_THREADS, 2)
kwt_sim(const __grid_constant__ CUtensorMap fmap, const __grid_constant__ CUtensorMap pmap,
        const KwtParams p, int tpb, int masked, int density) {
  constexpr int SLOT = (KWT_WG + 1) * BOX_BYTES;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ring = align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + KWT_STAGES * SLOT);
  uint64_t* freed = full + KWT_STAGES;
  float* na = reinterpret_cast<float*>(freed + KWT_STAGES);
  float* dv = na + KC;
  int* di = reinterpret_cast<int*>(dv + KWT_WG * 64);
  const int g = blockIdx.z, k0 = blockIdx.y * KC;
  const int t0 = blockIdx.x * tpb, t1 = min(p.NT, t0 + tpb);
  const int rounds = (t1 - t0 + KWT_WG - 1) / KWT_WG, steps = rounds * p.DT;
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < KWT_STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&freed[s], KWT_CONSUMERS);
    }
    mbar_init_fence();
  }
  if (tid < KC) {
    float s = 0.f;
    if (k0 + tid < p.K)
      for (int db = 0; db < p.DT; ++db) s += p.norm[((size_t)g * p.K + k0 + tid) * p.DT + db];
    na[tid] = fmaxf(sqrtf(s), 1e-8f);
  }
  __syncthreads();
  if (tid >= KWT_CONSUMERS) {  // the producer warp: step s once step s - KWT_STAGES left its slot
    if (tid == KWT_CONSUMERS)
      for (int s = 0; s < steps; ++s) {
        const int st = s % KWT_STAGES, col = (s % p.DT) * 64, ta = t0 + KWT_WG * (s / p.DT);
        if (s >= KWT_STAGES) mbar_wait(&freed[st], (s / KWT_STAGES - 1) & 1);
        uint8_t* slot = ring + st * SLOT;
        mbar_expect_tx(&full[st], SLOT);
        for (int f = 0; f < KWT_WG; ++f)
          tma_load_2d(slot + f * BOX_BYTES, &fmap, &full[st], col, (ta + f) * 64);
        tma_load_box(slot + KWT_WG * BOX_BYTES, &pmap, &full[st], col, k0, g);
      }
    return;
  }
  const int wg = tid >> 7;
  float acc[32];
  for (int r = 0; r < rounds; ++r) {
    const int tile = t0 + KWT_WG * r + wg;
    const KwtRows rows = kwt_rows(p, g, k0, tile, masked != 0, density != 0);
#pragma unroll
    for (int e = 0; e < 32; ++e) acc[e] = 0.f;
    for (int db = 0; db < p.DT; ++db) {
      const int s = r * p.DT + db, st = s % KWT_STAGES;
      const uint8_t* slot = ring + st * SLOT;
      mbar_wait(&full[st], (s / KWT_STAGES) & 1);
      fence_acc(acc);
      wgmma_fence();
#pragma unroll
      for (int kc = 0; kc < 4; ++kc)
        wgmma64<0, 0>(acc, desc_kmajor(slot + wg * BOX_BYTES, kc),
                      desc_kmajor(slot + KWT_WG * BOX_BYTES, kc));
      wgmma_commit();
      wgmma_wait();
      fence_acc(acc);
      mbar_arrive(&freed[st]);
    }
    if (tile < t1)
      kwt_sim_store(acc, p, rows, na, dv + wg * 64, di + wg * 64, g, k0, tile, masked != 0,
                    density != 0, wg);
  }
}

// W's A fragment of k16 step kc for a warp's rows (prototypes 16 w + lane /
// 4 and that + 8 of the chunk) and the tile's features 16 kc + 2 (lane % 4)
// + {0, 1, 8, 9}: W[k, f] = w_f where the feature's prototype is k, else 0.
// ix, wv: the tile's 64 (prototype - k0, weight) pairs in shared memory.
__device__ __forceinline__ void kwt_w_fragment(uint32_t (&a)[4][4], const int* ix,
                                               const float* wv, int ra) {
  const int f0 = 2 * (threadIdx.x & 3);
#pragma unroll
  for (int kc = 0; kc < 4; ++kc) {
    float x[2][4];  // [row a / b][feature f, f + 1, f + 8, f + 9]
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int f = 16 * kc + f0 + (i & 1) + 8 * (i >> 1);
      const int k = ix[f];
      const float v = wv[f];
      x[0][i] = k == ra ? v : 0.f;
      x[1][i] = k == ra + 8 ? v : 0.f;
    }
    a[kc][0] = pack_bf16(x[0][0], x[0][1]);
    a[kc][1] = pack_bf16(x[1][0], x[1][1]);
    a[kc][2] = pack_bf16(x[0][2], x[0][3]);
    a[kc][3] = pack_bf16(x[1][2], x[1][3]);
  }
}

// block (x, y, z): dims [64 x, 64 x + 64), prototypes [64 y, 64 y + 64),
// instance z, over every feature tile: warpgroup w takes the tiles w, w +
// KWU_WG, ..., a step per KWU_WG tiles. The product is P = W F: W (64
// prototypes x 64 features, one nonzero per feature) built in registers as
// the A operand from the tile's (prototype, weight) pairs, F the feature
// box read MN-major; threads t < 64 of a warpgroup stage those pairs in
// shared memory a step ahead, read from device memory a step before that.
// A fragments alternate between two register sets, so a step's product
// runs while the next step's fragments are built.
__global__ void __launch_bounds__(KWU_THREADS, 1) kwt_update(const __grid_constant__ CUtensorMap fmap,
                                                            const KwtParams p) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ring = align1024(smem_raw);
  int* pix = reinterpret_cast<int*>(ring + KWU_STAGES * KWU_WG * BOX_BYTES);
  float* pwv = reinterpret_cast<float*>(pix + 2 * KWU_WG * 64);
  uint64_t* full = reinterpret_cast<uint64_t*>(pwv + 2 * KWU_WG * 64);
  uint64_t* freed = full + KWU_STAGES;
  const int db = blockIdx.x, k0 = blockIdx.y * KC, g = blockIdx.z;
  // an even count of steps: a step past the tiles multiplies zeros
  const int steps = ((p.NT + KWU_WG - 1) / KWU_WG + 1) & ~1;
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < KWU_STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&freed[s], KWU_CONSUMERS);
    }
    mbar_init_fence();
  }
  __syncthreads();
  if (tid >= KWU_CONSUMERS) {  // the producer warp
    if (tid == KWU_CONSUMERS)
      for (int s = 0; s < steps; ++s) {
        const int st = s % KWU_STAGES;
        if (s >= KWU_STAGES) mbar_wait(&freed[st], (s / KWU_STAGES - 1) & 1);
        uint8_t* slot = ring + st * KWU_WG * BOX_BYTES;
        mbar_expect_tx(&full[st], KWU_WG * BOX_BYTES);
        for (int f = 0; f < KWU_WG; ++f)
          tma_load_2d(slot + f * BOX_BYTES, &fmap, &full[st], db * 64, (KWU_WG * s + f) * 64);
      }
    return;
  }
  const int wg = tid >> 7, t = tid & 127, wl = t >> 5, lane = t & 31;
  const int ra = 16 * wl + (lane >> 2);  // this thread's rows (prototypes) ra, ra + 8
  int* ixw = pix + wg * 2 * 64;          // step s's pairs at [(s & 1) * 64]
  float* wvw = pwv + wg * 2 * 64;
  const int* idx = p.idx + (size_t)g * p.N;
  const float* w = p.w + (size_t)g * p.N;
  // thread t < 64: its feature of step s's tile, (prototype - k0, weight)
  auto fetch = [&](int s, int& k, float& v) {
    const int tile = KWU_WG * s + wg, n = tile * 64 + t;
    k = -1;
    v = 0.f;
    if (t < 64 && tile < p.NT && n < p.N) {
      k = idx[n] - k0;
      v = w[n];
    }
  };
  int nk;
  float nv;
  fetch(0, nk, nv);
  if (t < 64) {
    ixw[t] = nk;
    wvw[t] = nv;
  }
  fetch(1, nk, nv);
  float acc[32];
#pragma unroll
  for (int e = 0; e < 32; ++e) acc[e] = 0.f;
  uint32_t a0[4][4], a1[4][4];
  // prev: the fragments of step s - 1, kept by the fence after the wait
  // until its product is done
  auto step = [&](int s, uint32_t (&a)[4][4], uint32_t (&prev)[4][4]) {
    const int st = s % KWU_STAGES, cur = (s & 1) * 64;
    wg_sync(wg);  // step s's pairs are staged
    kwt_w_fragment(a, ixw + cur, wvw + cur, ra);
    mbar_wait(&full[st], (s / KWU_STAGES) & 1);
    const uint8_t* box = ring + (st * KWU_WG + wg) * BOX_BYTES;
    fence_regs(a);
    fence_acc(acc);
    wgmma_fence();
#pragma unroll
    for (int kc = 0; kc < 4; ++kc) wgmma_rs<1>(acc, a[kc], desc_mnmajor(box, kc), 1);
    wgmma_commit();
    wgmma_wait_n<1>();  // step s - 1's product is done: its slot and fragments are free
    fence_regs(prev);
    if (s > 0) mbar_arrive(&freed[(s - 1) % KWU_STAGES]);
    if (t < 64) {  // step s + 1's pairs into the other half (read at step s - 1, done)
      ixw[64 - cur + t] = nk;
      wvw[64 - cur + t] = nv;
    }
    fetch(s + 2, nk, nv);
  };
  for (int s = 0; s < steps; s += 2) {
    step(s, a0, a1);
    step(s + 1, a1, a0);
  }
  wgmma_wait();
  fence_acc(acc);
  fence_regs(a0);
  fence_regs(a1);
  mbar_arrive(&freed[(steps - 1) % KWU_STAGES]);
  // the other warpgroups' sums added to warpgroup 0's, in warpgroup order
  consumers_sync();
  float* part = reinterpret_cast<float*>(ring);
  if (wg > 0)
#pragma unroll
    for (int e = 0; e < 32; ++e) part[((wg - 1) * 32 + e) * 128 + t] = acc[e];
  consumers_sync();
  if (wg > 0) return;
  for (int v = 0; v < KWU_WG - 1; ++v)
#pragma unroll
    for (int e = 0; e < 32; ++e) acc[e] += part[(v * 32 + e) * 128 + t];
  // rows of the accumulator are prototypes, columns dims: each thread's
  // pairs of columns as one store, and each row's squared norm over these
  // 64 dims: the thread's 16 values in order, then its quad by a fixed tree
  const int d0 = db * 64 + 2 * (lane & 3);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int k = k0 + ra + 8 * h;
    float ss = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float v0 = acc[4 * j + 2 * h], v1 = acc[4 * j + 2 * h + 1];
      ss += v0 * v0 + v1 * v1;
      const int d = d0 + 8 * j;
      if (k < p.K && d < p.D) {  // D is even: d < D holds d + 1 too
        const size_t i = ((size_t)g * p.K + k) * p.D + d;
        *reinterpret_cast<float2*>(p.prot + i) = make_float2(v0, v1);
        *reinterpret_cast<__nv_bfloat162*>(p.pb + i) = __floats2bfloat162_rn(v0, v1);
      }
    }
    ss += __shfl_xor_sync(0xffffffffu, ss, 1);
    ss += __shfl_xor_sync(0xffffffffu, ss, 2);
    if ((lane & 3) == 0 && k < p.K) p.norm[((size_t)g * p.K + k) * p.DT + db] = ss;
  }
}

// The host's plan of the bf16 route: chunks of 64 prototypes, then the
// feature tiles per kwt_sim block (a multiple of KWT_WG; the fewest waves,
// given the blocks the card holds at once, times the rounds of KWT_WG tiles
// a block takes; the larger on a tie).
struct KwtPlan {
  int chunks, nt, dt, tpb, groups, sim_per_sm, upd_per_sm, sms;
};

inline int kwt_tiles_per_block(int G, int chunks, int nt, int slots) {
  int best = KWT_WG;
  long best_cost = -1;
  for (int tpb = KWT_WG; tpb < nt + KWT_WG; tpb += KWT_WG) {
    const long blocks = (long)G * chunks * ((nt + tpb - 1) / tpb);
    const long cost = (blocks + slots - 1) / slots * ((min(tpb, nt) + KWT_WG - 1) / KWT_WG);
    if (best_cost < 0 || cost <= best_cost) {
      best = tpb;
      best_cost = cost;
    }
  }
  return best;
}

// blocks of `kernel` one SM holds at once with `smem` bytes (its attribute
// set first), or minus the cudaError_t
inline int kwt_per_sm(const void* kernel, int threads, size_t smem) {
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return -(int)e;
  int n = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, threads, smem);
  return e == cudaSuccess ? n : -(int)e;
}

int kwt_plan(int G, int K, int N, int D, KwtPlan* pl) {
  pl->chunks = (K + KC - 1) / KC;
  pl->nt = (N + 63) / 64;
  pl->dt = (D + 63) / 64;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&pl->sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  pl->sim_per_sm = kwt_per_sm((const void*)kwt_sim, KWT_THREADS, KWT_SIM_SMEM);
  pl->upd_per_sm = kwt_per_sm((const void*)kwt_update, KWU_THREADS, KWT_UPDATE_SMEM);
  if (pl->sim_per_sm < 1) return pl->sim_per_sm < 0 ? -pl->sim_per_sm : (int)cudaErrorInvalidValue;
  if (pl->upd_per_sm < 1) return pl->upd_per_sm < 0 ? -pl->upd_per_sm : (int)cudaErrorInvalidValue;
  pl->tpb = kwt_tiles_per_block(G, pl->chunks, pl->nt, pl->sms * pl->sim_per_sm);
  pl->groups = (pl->nt + pl->tpb - 1) / pl->tpb;
  return 0;
}

int kwt_forward(const KwtParams& p, const float* prot0, int G, int n_shift, cudaStream_t s) {
  KwtPlan pl;
  if (int bad = kwt_plan(G, p.K, p.N, p.D, &pl)) return bad;
  CUtensorMap fmap = {}, pmap = {};
  if (int bad = make_map_2d(&fmap, p.fb, p.N, p.D)) return bad;
  if (int bad = make_plane_map(&pmap, p.pb, G, p.K, p.D, 64, true)) return bad;
  const dim3 sim_grid(pl.groups, pl.chunks, G);
  const int rows = G * p.K;
  kwt_init<<<(rows + 7) / 8, 256, 0, s>>>(prot0, p, rows);
  for (int it = 0; it < n_shift; ++it) {
    kwt_sim<<<sim_grid, KWT_THREADS, KWT_SIM_SMEM, s>>>(fmap, pmap, p, pl.tpb, 1, it > 0);
    kwt_lse<<<rows, KWT_LSE_THREADS, 0, s>>>(p, it == 0);
    kwt_assign<true><<<dim3((p.N + 31) / 32, G), 32 * KWT_ASSIGN_GROUPS, 0, s>>>(p);
    kwt_update<<<dim3(pl.dt, pl.chunks, G), KWU_THREADS, KWT_UPDATE_SMEM, s>>>(fmap, p);
  }
  kwt_sim<<<sim_grid, KWT_THREADS, KWT_SIM_SMEM, s>>>(fmap, pmap, p, pl.tpb, 0, 0);
  if (n_shift == 0) {
    cudaError_t e = cudaMemcpyAsync(p.prot, prot0, (size_t)rows * p.D * sizeof(float),
                                    cudaMemcpyDeviceToDevice, s);
    if (e != cudaSuccess) return (int)e;
  }
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

// Scratch of the second route in f32 floats: the prototypes' bf16 copy
// (bf16 operands only; D a multiple of 16), their squared norms per 64
// dims, the density partials per 64-feature tile, the log-sum-exp per
// prototype, weights and assignments per feature.
size_t meanshift_kwide_work_floats(int G, int K, int N, int D, int mm_bf16) {
  return kwt_work(G, K, N, D, mm_bf16 != 0).total;
}

// The bf16 route's plan on the current device: out[0] chunks of 64
// prototypes, [1] feature tiles, [2] 64-dim boxes, [3] feature tiles per
// kwt_sim block, [4] kwt_sim's blocks along the features, [5] kwt_sim's
// shared memory, [6] its blocks per SM, [7] kwt_update's shared memory, [8]
// its blocks per SM, [9] the SMs. Returns 0 or the cudaError_t.
int meanshift_kwide_plan(int G, int K, int N, int D, int* out) {
  KwtPlan pl;
  if (int bad = kwt_plan(G, K, N, D, &pl)) return bad;
  const int v[10] = {pl.chunks, pl.nt, pl.dt, pl.tpb, pl.groups, (int)KWT_SIM_SMEM,
                     pl.sim_per_sm, (int)KWT_UPDATE_SMEM, pl.upd_per_sm, pl.sms};
  for (int i = 0; i < 10; ++i) out[i] = v[i];
  return 0;
}

// The second route (any K; the wrapper takes it above K = 32): prot0 (G, K,
// D), mask (G, N), nbase (N,) f32 contiguous; f (N, D) f32 operands, or with
// mm_bf16 fb (N, D) bf16 (the features rounded once; D a multiple of 16) and
// f null. work: f32 scratch of meanshift_kwide_work_floats(G, K, N, D,
// mm_bf16) floats, 16-byte aligned. out_prot (G, K, D), out_sim (G, K, N)
// f32; out_prot also carries the iterates and out_sim the similarities
// until the final pass. Any D >= 1 (f32), N >= 1.
int meanshift_kwide_forward(const void* prot0, const void* mask, const void* f, const void* fb,
                            const void* nbase, void* out_prot, void* out_sim, void* work, int G,
                            int K, int N, int D, int n_shift, float tau0, float temp,
                            int mm_bf16, void* stream) {
  if (G < 1 || K < 1 || N < 1 || D < 1 || n_shift < 0 || (mm_bf16 ? fb : f) == nullptr ||
      (mm_bf16 && D % 16 != 0))
    return (int)cudaErrorInvalidValue;
  float* wk = (float*)work;
  const KwtWork o = kwt_work(G, K, N, D, mm_bf16 != 0);
  const KwtParams p{(const float*)mask, (const float*)nbase, mm_bf16 ? nullptr : (const float*)f,
                    mm_bf16 ? (const bf16*)fb : nullptr, (float*)out_prot, (float*)out_sim,
                    mm_bf16 ? (bf16*)(wk + o.pb) : nullptr, wk + o.norm, (float2*)(wk + o.dens),
                    wk + o.lse, wk + o.w, (int*)(wk + o.idx), K, N, D, (N + 63) / 64, (D + 63) / 64,
                    tau0, temp};
  const cudaStream_t s = (cudaStream_t)stream;
  if (!mm_bf16) return kw_forward(p, (const float*)prot0, G, n_shift, s);
  cudaFree(nullptr);  // a runtime call first: the tensor maps need the context current
  return kwt_forward(p, (const float*)prot0, G, n_shift, s);
}

}  // extern "C"
