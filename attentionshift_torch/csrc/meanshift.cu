// Cosine mean-shift fixpoint (Stage C), one cluster of 8 blocks per instance.
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
// D=384) the inputs are 13 MB and the output 6.7 MB (6 us at 3.35 TB/s),
// while the dot products are 11 passes x 2*K*N*D = 0.7 GFLOP per instance:
// the operations bound it, on the tensor cores in bf16 (15 us for all 20
// instances at 989 TFLOP/s). A first version with one block per instance
// took 5.4 ms whatever the instance count: one SM's serial chain of
// phases, each streaming all N features, bounded it.
//
// What the design does about it. Each instance runs on a cluster of 8
// blocks (thread block clusters); block r owns features [r*S, (r+1)*S).
// Its similarities (K x S) stay in its shared memory; per-prototype
// reductions over N (log-sum-exp, density) and the prototype sums are
// combined through distributed shared memory, in rank order, so every
// block holds bit-identical prototypes and bandwidths. The sim of the new
// prototypes is also the next iteration's sim, so one similarity pass per
// iteration. With bf16 dot operands both dense passes run on the tensor
// cores (mma.sync m16n8k16, f32 accumulation): the similarity as
// f(S x D) . P^T, the update as W(K x S) . f with W built in registers
// from each feature's (prototype, weight) pair; the features come
// pre-rounded to bf16 in both layouts, zero-padded to NP = a multiple of
// 128 rows. The f32 path keeps scalar FMAs (a K x 2 accumulator block per
// thread).

#include <cuda_bf16.h>
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int NTHREADS = 512;
constexpr int CLUSTER = 8;  // blocks per instance
constexpr int NCOL = 2;  // feature columns per thread in an f32 dot pass
constexpr int NWARPS = NTHREADS / 32;

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

__device__ __forceinline__ void mma16816(float c[4], const uint32_t a[4], const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld2(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// na[k] = max(|P_k|, 1e-8) over the unrounded f32 prototypes
__device__ void proto_norms(const float* prot, float* na, int K, int D) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int k = warp; k < K; k += NWARPS) {
    float s = 0.f;
    for (int d = lane; d < D; d += 32) s += prot[k * D + d] * prot[k * D + d];
    s = warp_sum(s);
    if (lane == 0) na[k] = fmaxf(sqrtf(s), 1e-8f);
  }
}

// the dot-operand copy of the prototypes: f32 transposed (D x KP) for the
// scalar path, bf16 row-major (KP x D+8) for the tensor cores; rows k >= K zero
template <int KP, bool BF16>
__device__ void stage_operand(const float* prot, float* op, int K, int D) {
  if (BF16) {
    bf16* pb = reinterpret_cast<bf16*>(op);
    for (int i = threadIdx.x; i < KP * D; i += NTHREADS) {
      const int k = i / D, d = i - k * D;
      pb[k * (D + 8) + d] = __float2bfloat16(k < K ? prot[i] : 0.f);
    }
  } else {
    for (int i = threadIdx.x; i < KP * D; i += NTHREADS) {
      const int d = i / KP, k = i - d * KP;
      op[i] = k < K ? prot[k * D + d] : 0.f;
    }
  }
}

// sim[k, n] from the accumulated dot: masked (m given) or unmasked (m null)
__device__ __forceinline__ float cosine(float dot, const float* m, const float* nbase,
                                        float na_k, int n) {
  if (m != nullptr) {
    const float mv = m[n];
    return dot * mv / (na_k * fmaxf(nbase[n] * mv, 1e-8f));
  }
  return dot / (na_k * fmaxf(nbase[n], 1e-8f));
}

// Similarity passes over features [n_lo, n_hi): sim[k, n] goes to
// dst[k * ld + n - col0] (the block's shared slice, or the output).

// f32 similarity pass: K x NCOL accumulators per thread, scalar FMAs
template <int KP>
__device__ void sim_pass_f32(const float* protT, const float* na, const float* __restrict__ ft,
                             const float* __restrict__ nbase, const float* m, float* dst, int ld,
                             int col0, int K, int N, int n_lo, int n_hi, int D) {
  for (int base = n_lo; base < n_hi; base += NTHREADS * NCOL) {
    int col[NCOL];
#pragma unroll
    for (int j = 0; j < NCOL; ++j) col[j] = base + j * NTHREADS + threadIdx.x;
    float acc[KP][NCOL];
#pragma unroll
    for (int k = 0; k < KP; ++k)
#pragma unroll
      for (int j = 0; j < NCOL; ++j) acc[k][j] = 0.f;
    for (int d = 0; d < D; ++d) {
      float fv[NCOL];
#pragma unroll
      for (int j = 0; j < NCOL; ++j) fv[j] = col[j] < n_hi ? ft[(size_t)d * N + col[j]] : 0.f;
      const float4* pr = reinterpret_cast<const float4*>(protT + d * KP);
#pragma unroll
      for (int k4 = 0; k4 < KP / 4; ++k4) {
        const float4 p = pr[k4];
#pragma unroll
        for (int j = 0; j < NCOL; ++j) {
          acc[4 * k4 + 0][j] = fmaf(p.x, fv[j], acc[4 * k4 + 0][j]);
          acc[4 * k4 + 1][j] = fmaf(p.y, fv[j], acc[4 * k4 + 1][j]);
          acc[4 * k4 + 2][j] = fmaf(p.z, fv[j], acc[4 * k4 + 2][j]);
          acc[4 * k4 + 3][j] = fmaf(p.w, fv[j], acc[4 * k4 + 3][j]);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < NCOL; ++j) {
      if (col[j] >= n_hi) continue;
#pragma unroll
      for (int k = 0; k < KP; ++k)
        if (k < K) dst[(size_t)k * ld + col[j] - col0] = cosine(acc[k][j], m, nbase, na[k], col[j]);
    }
  }
}

// bf16 similarity pass on the tensor cores: per warp, 16 features (rows of
// fb, A) against all KP prototypes (B from shared memory)
template <int KP>
__device__ void sim_pass_mma(const bf16* pb, const float* na, const bf16* __restrict__ fb,
                             const float* __restrict__ nbase, const float* m, float* dst, int ld,
                             int col0, int K, int n_lo, int n_hi, int D) {
  constexpr int NT = KP / 8;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int ldp = D + 8;
  for (int n0 = n_lo + warp * 16; n0 < n_hi; n0 += NWARPS * 16) {
    float acc[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
    const bf16* ra = fb + (size_t)(n0 + gid) * D;  // fb has a multiple of 16 rows
    const bf16* rb = ra + 8 * (size_t)D;
    // unrolled so several chunks' loads are in flight: with 16 warps an SM
    // would otherwise wait out the L2 latency on every chunk
#pragma unroll 4
    for (int c = tig * 2; c < D; c += 16) {
      const uint32_t a[4] = {ld2(ra + c), ld2(rb + c), ld2(ra + c + 8), ld2(rb + c + 8)};
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const bf16* pr = pb + (nt * 8 + gid) * ldp + c;
        const uint32_t bb[2] = {ld2(pr), ld2(pr + 8)};
        mma16816(acc[nt], a, bb);
      }
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int n = n0 + gid + (i >= 2 ? 8 : 0);
        const int k = nt * 8 + tig * 2 + (i & 1);
        if (n < n_hi && k < K) dst[(size_t)k * ld + n - col0] = cosine(acc[nt][i], m, nbase, na[k], n);
      }
    }
  }
}

// Update passes: part[k] = sum over the block's features assigned to k of
// w * f, for the S features from n_lo (local index s, w/idx in shared).

// f32 update: thread d owns column d (part zeroed by the caller)
__device__ void update_f32(float* part, const float* w, const int* idx,
                           const float* __restrict__ f, int n_lo, int S, int N, int D) {
  for (int d = threadIdx.x; d < D; d += NTHREADS) {
    for (int s = 0; s < S && n_lo + s < N; ++s) {
      const float ws = w[s];
      if (ws == 0.f) continue;
      part[idx[s] * D + d] = fmaf(ws, f[(size_t)(n_lo + s) * D + d], part[idx[s] * D + d]);
    }
  }
}

// bf16 update on the tensor cores: P = W . f with W (KP x NP) one-hot rows
// built in registers from (idx, w); per warp, 8 feature dims (B from ftb)
template <int KP>
__device__ void update_mma(float* part, const float* w, const int* idx,
                           const bf16* __restrict__ ftb, int NP, int n_lo, int S, int D) {
  constexpr int MT = (KP + 15) / 16;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;
  for (int d0 = warp * 8; d0 < D; d0 += NWARPS * 8) {
    float acc[MT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) acc[mt][0] = acc[mt][1] = acc[mt][2] = acc[mt][3] = 0.f;
    const bf16* col = ftb + (size_t)(d0 + gid) * NP + n_lo;
#pragma unroll 8
    for (int c = tig * 2; c < S; c += 16) {
      const uint32_t bb[2] = {ld2(col + c), ld2(col + c + 8)};
      const int i0 = idx[c], i1 = idx[c + 1], i2 = idx[c + 8], i3 = idx[c + 9];
      const float w0 = w[c], w1 = w[c + 1], w2 = w[c + 8], w3 = w[c + 9];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const int ka = mt * 16 + gid, kb = ka + 8;
        const uint32_t a[4] = {
            pack2(i0 == ka ? w0 : 0.f, i1 == ka ? w1 : 0.f),
            pack2(i0 == kb ? w0 : 0.f, i1 == kb ? w1 : 0.f),
            pack2(i2 == ka ? w2 : 0.f, i3 == ka ? w3 : 0.f),
            pack2(i2 == kb ? w2 : 0.f, i3 == kb ? w3 : 0.f)};
        mma16816(acc[mt], a, bb);
      }
    }
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int k = mt * 16 + gid + (i >= 2 ? 8 : 0);
        const int d = d0 + tig * 2 + (i & 1);
        if (k < KP) part[k * D + d] = acc[mt][i];
      }
    }
  }
}

template <int KP, bool BF16>
__global__ void __launch_bounds__(NTHREADS, 1)
meanshift_kernel(const float* __restrict__ prot0, const float* __restrict__ mask,
                 const float* __restrict__ f, const float* __restrict__ ft,
                 const bf16* __restrict__ fb, const bf16* __restrict__ ftb,
                 const float* __restrict__ nbase, float* __restrict__ out_prot,
                 float* __restrict__ out_sim, int K, int N, int NP, int D, int n_shift,
                 float tau0, float temp) {
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int g = blockIdx.x / CLUSTER;
  const int S = NP / CLUSTER;  // features per block, a multiple of 16
  const int n_lo = rank * S;
  const int n_hi = min(n_lo + S, N);
  extern __shared__ float smem[];
  float* prot = smem;               // KP * D, f32 prototypes (the same in every block)
  float* op = prot + KP * D;        // KP * D: the dot-operand copy, or this block's partial sums
  float* sim = op + KP * D;         // KP * S: this block's similarities
  float* w = sim + KP * S;          // S: weight of each feature for its prototype
  int* idx = reinterpret_cast<int*>(w + S);  // S: assigned prototype (-1 past N)
  float* tau = reinterpret_cast<float*>(idx + S);  // KP
  float* na = tau + KP;             // KP
  float* lse = na + KP;             // KP
  float* red = lse + KP;            // 2 * KP: this block's partial reductions

  const float* m = mask + (size_t)g * N;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  auto sim_pass = [&](const float* mm, float* dst, int ld, int col0) {
    if (BF16)
      sim_pass_mma<KP>(reinterpret_cast<const bf16*>(op), na, fb, nbase, mm, dst, ld, col0, K,
                       n_lo, n_hi, D);
    else
      sim_pass_f32<KP>(op, na, ft, nbase, mm, dst, ld, col0, K, N, n_lo, n_hi, D);
  };
  for (int i = threadIdx.x; i < KP * D; i += NTHREADS)
    prot[i] = i < K * D ? prot0[(size_t)g * K * D + i] : 0.f;
  for (int k = threadIdx.x; k < KP; k += NTHREADS) tau[k] = tau0;
  for (int t = threadIdx.x; t < S; t += NTHREADS) {
    w[t] = 0.f;
    idx[t] = -1;
  }
  __syncthreads();
  proto_norms(prot, na, K, D);
  stage_operand<KP, BF16>(prot, op, K, D);
  __syncthreads();
  if (n_shift > 0) sim_pass(m, sim, S, n_lo);
  __syncthreads();

  for (int it = 0; it < n_shift; ++it) {
    // log-sum-exp over N of sim / (temp * tau_k): each block's (max, sum
    // of exp - max) over its features, one warp per prototype ...
    for (int k = warp; k < K; k += NWARPS) {
      const float div = temp * tau[k];
      const float* row = sim + (size_t)k * S;
      float mx = -INFINITY;
      for (int t = lane; t < n_hi - n_lo; t += 32) mx = fmaxf(mx, row[t] / div);
      mx = warp_max(mx);
      float sum = 0.f;
      for (int t = lane; t < n_hi - n_lo; t += 32) sum += expf(row[t] / div - mx);
      sum = warp_sum(sum);
      if (lane == 0) {
        red[2 * k] = mx;
        red[2 * k + 1] = sum;
      }
    }
    cluster.sync();
    // ... combined over the cluster in rank order
    for (int k = threadIdx.x; k < K; k += NTHREADS) {
      float mx = -INFINITY, sum = 0.f;
      for (int r = 0; r < CLUSTER; ++r) mx = fmaxf(mx, cluster.map_shared_rank(red, r)[2 * k]);
      for (int r = 0; r < CLUSTER; ++r) {
        const float* rr = cluster.map_shared_rank(red, r);
        if (rr[2 * k] > -INFINITY) sum += rr[2 * k + 1] * expf(rr[2 * k] - mx);
      }
      lse[k] = logf(sum) + mx;
    }
    __syncthreads();
    // hard assignment per feature (first maximum wins) and its weight
    for (int t = threadIdx.x; t < n_hi - n_lo; t += NTHREADS) {
      float best = -INFINITY;
      int bi = 0;
      for (int k = 0; k < K; ++k) {
        const float lw = sim[(size_t)k * S + t] / (temp * tau[k]) - lse[k];
        if (lw > best) {
          best = lw;
          bi = k;
        }
      }
      idx[t] = bi;
      w[t] = rnd<BF16>(expf(best) * m[n_lo + t]);
    }
    __syncthreads();
    // this block's partial prototypes into op ...
    if (BF16) {
      update_mma<KP>(op, w, idx, ftb, NP, n_lo, S, D);
    } else {
      for (int i = threadIdx.x; i < KP * D; i += NTHREADS) op[i] = 0.f;
      __syncthreads();
      update_f32(op, w, idx, f, n_lo, S, N, D);
    }
    cluster.sync();
    // ... summed over the cluster in rank order
    for (int i = threadIdx.x; i < KP * D; i += NTHREADS) {
      float acc = 0.f;
      for (int r = 0; r < CLUSTER; ++r) acc += cluster.map_shared_rank(op, r)[i];
      prot[i] = acc;
    }
    cluster.sync();  // every block has read every partial before op is restaged
    proto_norms(prot, na, K, D);
    stage_operand<KP, BF16>(prot, op, K, D);
    __syncthreads();
    if (it + 1 == n_shift) break;  // the last tau update is never read
    sim_pass(m, sim, S, n_lo);
    __syncthreads();
    // density bandwidth: tau_k = max(1 - mean assigned sim, 1e-10)
    for (int k = warp; k < K; k += NWARPS) {
      const float* row = sim + (size_t)k * S;
      float sum = 0.f, cnt = 0.f;
      for (int t = lane; t < n_hi - n_lo; t += 32) {
        if (idx[t] == k) {
          sum += row[t];
          cnt += 1.f;
        }
      }
      sum = warp_sum(sum);
      cnt = warp_sum(cnt);
      if (lane == 0) {
        red[2 * k] = sum;
        red[2 * k + 1] = cnt;
      }
    }
    cluster.sync();
    for (int k = threadIdx.x; k < K; k += NTHREADS) {
      float sum = 0.f, cnt = 0.f;
      for (int r = 0; r < CLUSTER; ++r) {
        const float* rr = cluster.map_shared_rank(red, r);
        sum += rr[2 * k];
        cnt += rr[2 * k + 1];
      }
      const float dens = 1.f - (cnt >= 1.f ? sum / fmaxf(cnt, 1.f) : 0.f);
      tau[k] = fmaxf(dens, 1e-10f);
    }
    cluster.sync();  // every block has read red before it is rewritten
  }

  sim_pass(nullptr, out_sim + (size_t)g * K * N, N, 0);
  if (rank == 0)
    for (int i = threadIdx.x; i < K * D; i += NTHREADS) out_prot[(size_t)g * K * D + i] = prot[i];
  cluster.sync();  // no block leaves while another may read its shared memory
}

struct Args {
  const float *prot0, *mask, *f, *ft;
  const bf16 *fb, *ftb;
  const float* nbase;
  float *out_prot, *out_sim;
  int G, K, N, NP, D, n_shift;
  float tau0, temp;
};

template <int KP, bool BF16>
int launch(const Args& a, cudaStream_t stream) {
  const size_t S = a.NP / CLUSTER;
  const size_t smem = sizeof(float) * (2 * (size_t)KP * a.D + KP * S + 2 * S + 5 * KP);
  auto kern = meanshift_kernel<KP, BF16>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.G * CLUSTER);
  cfg.blockDim = dim3(NTHREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CLUSTER;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kern, a.prot0, a.mask, a.f, a.ft, a.fb, a.ftb, a.nbase, a.out_prot,
                         a.out_sim, a.K, a.N, a.NP, a.D, a.n_shift, a.tau0, a.temp);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

template <bool BF16>
int dispatch(const Args& a, cudaStream_t stream) {
  if (a.K <= 8) return launch<8, BF16>(a, stream);
  if (a.K <= 16) return launch<16, BF16>(a, stream);
  if (a.K <= 24) return launch<24, BF16>(a, stream);
  return launch<32, BF16>(a, stream);
}

}  // namespace

extern "C" {

// prot0 (G, K, D), mask (G, N), nbase (N,): f32 contiguous; K <= 32;
// NP >= N a multiple of 128 (8 blocks x 16 features).
// f32 dots: f (N, D) and ft (D, N) f32, fb/ftb null.
// bf16 dots: fb (NP, D) and ftb (D, NP) bf16, the features rounded and
// zero-padded to NP rows; f/ft null; D a multiple of 16.
// out_prot (G, K, D), out_sim (G, K, N): f32.
int meanshift_forward(const void* prot0, const void* mask, const void* f, const void* ft,
                      const void* fb, const void* ftb, const void* nbase, void* out_prot,
                      void* out_sim, int G, int K, int N, int NP, int D, int n_shift, float tau0,
                      float temp, int mm_bf16, void* stream) {
  const Args a{(const float*)prot0, (const float*)mask, (const float*)f, (const float*)ft,
               (const bf16*)fb, (const bf16*)ftb, (const float*)nbase, (float*)out_prot,
               (float*)out_sim, G, K, N, NP, D, n_shift, tau0, temp};
  return mm_bf16 ? dispatch<true>(a, (cudaStream_t)stream) : dispatch<false>(a, (cudaStream_t)stream);
}

}  // extern "C"
