// Attention backward kernels for the ViT backbone (bf16, head dim 64).
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
// What bounds them on the H100. At the bench shape (B=1, H=6, T=4352, d=64)
// pass A is three (T, T, d) products = 6*H*T^2*d = 43.6 GFLOP and pass B
// four = 58.2 GFLOP, against ~20 MB of q/k/v/dO/out and gradients: far above
// the ~295 FLOP/byte ridge, so the tensor cores bound both (44 us and 59 us
// at 989 TFLOP/s). Nothing (T, T)-sized may reach device memory.
//
// What the design does about it. The TPU kernels hold a (128, T) strip of
// every head in VMEM; an SM has 227 KB, so both passes tile the other axis:
//   bwd_dq   one block per (64 query rows, head, image), 4 warps x 16 rows.
//            Q and dO fragments stay in registers; the loop walks 64-key
//            tiles of K and V through shared memory. The row normaliser is
//            the forward's log2-sum-exp (attn_flash_forward writes it), so p
//            is one exp2 with no second sweep for the row sum; D is
//            rowsum(dO * out), the same number as sum_s p*dP, known before
//            the loop starts. D is written for pass B.
//   bwd_dkv  one block per (64 keys, head, image), 4 warps x 16 keys. It
//            works on the TRANSPOSED tiles (keys as rows): K and V fragments
//            in registers, 64-query tiles of Q and dO in shared memory, once
//            row-major (for S^T = K Q^T and dP^T = V dO^T) and once
//            transposed (for dV += P^T dO and dK += dS^T Q).
// Products are mma.sync m16n8k16 bf16 with f32 accumulation; p and
// p*(dP-D) are rounded to bf16 before the second product, as on the TPU.
// Key columns in the pad gap [pad_lo, pad_hi) and columns >= T get p = 0,
// so their dK and dV rows are written as exact zeros (they feed the qkv
// projection's gradient). No cp.async/TMA/wgmma yet: tiles are loaded
// synchronously, which a later change can pipeline.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int HD = 64;       // head dim
constexpr int BR = 64;       // rows of the block's own tile: 4 warps x 16
constexpr int BC = 64;       // rows of the tile walked by the loop
constexpr int NTHREADS = 128;
constexpr int LDS = HD + 8;  // smem row stride (bf16), keeps fragment reads conflict-free

typedef __nv_bfloat16 bf16;

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

// round to bf16 and back: the value the second product will see
__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

// two adjacent bf16 (row r, cols c, c+1) of a (T, 64) head matrix; 0 past T
__device__ __forceinline__ uint32_t ld2(const bf16* m, int r, int c, int T) {
  if (r >= T) return 0u;
  return *reinterpret_cast<const uint32_t*>(m + (size_t)r * HD + c);
}

__device__ __forceinline__ float2 unpack2(uint32_t u) {
  __nv_bfloat162 v = *reinterpret_cast<__nv_bfloat162*>(&u);
  return __bfloat1622float2(v);
}

__device__ __forceinline__ bool masked_col(int col, int T, int pad_lo, int pad_hi) {
  return col >= T || (col >= pad_lo && col < pad_hi);
}

// A fragments of a warp's 16 rows (r_a = r, r_b = r + 8) over the head dim
__device__ __forceinline__ void load_rows(uint32_t fa[4][4], const bf16* mh, int r_a, int r_b,
                                          int tig, int T) {
#pragma unroll
  for (int kc = 0; kc < 4; ++kc) {
    int c = kc * 16 + tig * 2;
    fa[kc][0] = ld2(mh, r_a, c, T);
    fa[kc][1] = ld2(mh, r_b, c, T);
    fa[kc][2] = ld2(mh, r_a, c + 8, T);
    fa[kc][3] = ld2(mh, r_b, c + 8, T);
  }
}

// Load a 64-row tile of a (T, 64) head matrix into shared memory, row-major
// (rm[row][d]) and, when asked, transposed (tr[d][row]); rows past T are 0.
__device__ __forceinline__ void load_tile(const bf16* mh, int row0, int T, bf16 (*rm)[LDS],
                                          bf16 (*tr)[BC + 8]) {
  for (int i = threadIdx.x; i < BC * (HD / 8); i += NTHREADS) {
    int r = i >> 3, c8 = (i & 7) * 8;
    uint4 x = make_uint4(0, 0, 0, 0);
    if (row0 + r < T) x = *reinterpret_cast<const uint4*>(mh + (size_t)(row0 + r) * HD + c8);
    if (rm != nullptr) *reinterpret_cast<uint4*>(&rm[r][c8]) = x;
    if (tr != nullptr) {
      const bf16* e = reinterpret_cast<const bf16*>(&x);
#pragma unroll
      for (int j = 0; j < 8; ++j) tr[c8 + j][r] = e[j];
    }
  }
}

// acc (16 x 64) = A (16 x 64 over the head dim, register fragments) times
// the transpose of a row-major shared tile (64 x 64)
__device__ __forceinline__ void mma_rows(float acc[8][4], const uint32_t fa[4][4],
                                         const bf16 (*rm)[LDS], int gid, int tig) {
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
#pragma unroll
    for (int kc = 0; kc < 4; ++kc) {
      uint32_t bb[2];
      bb[0] = *reinterpret_cast<const uint32_t*>(&rm[nt * 8 + gid][kc * 16 + tig * 2]);
      bb[1] = *reinterpret_cast<const uint32_t*>(&rm[nt * 8 + gid][kc * 16 + tig * 2 + 8]);
      mma16816(acc[nt], fa[kc], bb);
    }
  }
}

// acc (16 x 64 over the head dim) += P (16 x 64, f32 accumulator layout,
// rounded to bf16 here) times a shared tile given transposed (tr[d][row])
__device__ __forceinline__ void mma_acc(float acc[8][4], const float p[8][4],
                                        const bf16 (*tr)[BC + 8], int gid, int tig) {
#pragma unroll
  for (int kc = 0; kc < 4; ++kc) {
    // the accumulators of n-tiles (2c, 2c+1) are the A fragment of chunk c
    uint32_t pa[4];
    pa[0] = pack2(p[2 * kc][0], p[2 * kc][1]);
    pa[1] = pack2(p[2 * kc][2], p[2 * kc][3]);
    pa[2] = pack2(p[2 * kc + 1][0], p[2 * kc + 1][1]);
    pa[3] = pack2(p[2 * kc + 1][2], p[2 * kc + 1][3]);
#pragma unroll
    for (int dt = 0; dt < 8; ++dt) {
      uint32_t bb[2];
      bb[0] = *reinterpret_cast<const uint32_t*>(&tr[dt * 8 + gid][kc * 16 + tig * 2]);
      bb[1] = *reinterpret_cast<const uint32_t*>(&tr[dt * 8 + gid][kc * 16 + tig * 2 + 8]);
      mma16816(acc[dt], pa, bb);
    }
  }
}

// write a warp's (16 x 64) f32 accumulator, scaled, as bf16 rows of a head matrix
__device__ __forceinline__ void store_rows(bf16* mh, const float acc[8][4], float scale, int r_a,
                                           int r_b, int tig, int T) {
#pragma unroll
  for (int dt = 0; dt < 8; ++dt) {
    int c = dt * 8 + tig * 2;
    if (r_a < T)
      *reinterpret_cast<uint32_t*>(mh + (size_t)r_a * HD + c) =
          pack2(acc[dt][0] * scale, acc[dt][1] * scale);
    if (r_b < T)
      *reinterpret_cast<uint32_t*>(mh + (size_t)r_b * HD + c) =
          pack2(acc[dt][2] * scale, acc[dt][3] * scale);
  }
}

// Pass A: dQ of one 64-row query tile, and D = rowsum(dO * out) per row.
__global__ void __launch_bounds__(NTHREADS)
bwd_dq(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
       const bf16* __restrict__ out, const bf16* __restrict__ dout,
       const float* __restrict__ lse2, bf16* __restrict__ dq, float* __restrict__ dd, int H, int T,
       int pad_lo, int pad_hi, float scale_log2, float scale) {
  __shared__ __align__(16) bf16 Ks[BC][LDS];
  __shared__ __align__(16) bf16 Vs[BC][LDS];
  __shared__ __align__(16) bf16 Kt[HD][BC + 8];

  const int h = blockIdx.y, b = blockIdx.z;
  const size_t head = ((size_t)b * H + h) * (size_t)T * HD;
  const size_t rowbase = ((size_t)b * H + h) * (size_t)T;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int r_a = blockIdx.x * BR + warp * 16 + gid;
  const int r_b = r_a + 8;

  uint32_t qa[4][4], doa[4][4];
  load_rows(qa, q + head, r_a, r_b, tig, T);
  load_rows(doa, dout + head, r_a, r_b, tig, T);

  // D = rowsum(dO * out): a thread holds 16 of a row's 64 columns, its quad all
  float d_a = 0.f, d_b = 0.f;
  {
    uint32_t oa[4][4];
    load_rows(oa, out + head, r_a, r_b, tig, T);
#pragma unroll
    for (int kc = 0; kc < 4; ++kc) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float2 g = unpack2(doa[kc][i]), o = unpack2(oa[kc][i]);
        float s = g.x * o.x + g.y * o.y;
        if (i & 1) d_b += s; else d_a += s;
      }
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      d_a += __shfl_xor_sync(0xffffffffu, d_a, off);
      d_b += __shfl_xor_sync(0xffffffffu, d_b, off);
    }
  }
  const float lse_a = r_a < T ? lse2[rowbase + r_a] : 0.f;
  const float lse_b = r_b < T ? lse2[rowbase + r_b] : 0.f;

  float acc[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;

  const int ntiles = (T + BC - 1) / BC;
  for (int kt = 0; kt < ntiles; ++kt) {
    const int key0 = kt * BC;
    __syncthreads();  // previous tile fully consumed
    load_tile(k + head, key0, T, Ks, Kt);
    load_tile(v + head, key0, T, Vs, nullptr);
    __syncthreads();

    float s[8][4], dp[8][4];
    mma_rows(s, qa, Ks, gid, tig);    // S  = Q K^T
    mma_rows(dp, doa, Vs, gid, tig);  // dP = dO V^T
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        int col = key0 + nt * 8 + tig * 2 + (i & 1);
        float l = i < 2 ? lse_a : lse_b, dsum = i < 2 ? d_a : d_b;
        float p = masked_col(col, T, pad_lo, pad_hi)
                      ? 0.f : round_bf16(exp2f(s[nt][i] * scale_log2 - l));
        s[nt][i] = p * (dp[nt][i] - dsum);
      }
    }
    mma_acc(acc, s, Kt, gid, tig);  // dQ += dS K
  }

  store_rows(dq + head, acc, scale, r_a, r_b, tig, T);
  if (tig == 0) {
    if (r_a < T) dd[rowbase + r_a] = d_a;
    if (r_b < T) dd[rowbase + r_b] = d_b;
  }
}

// Pass B: dK and dV of one 64-row key tile, on the transposed tiles.
__global__ void __launch_bounds__(NTHREADS)
bwd_dkv(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
        const bf16* __restrict__ dout, const float* __restrict__ lse2,
        const float* __restrict__ dd, bf16* __restrict__ dk, bf16* __restrict__ dv, int H, int T,
        int pad_lo, int pad_hi, float scale_log2, float scale) {
  __shared__ __align__(16) bf16 Qs[BC][LDS];
  __shared__ __align__(16) bf16 Gs[BC][LDS];  // dO
  __shared__ __align__(16) bf16 Qt[HD][BC + 8];
  __shared__ __align__(16) bf16 Gt[HD][BC + 8];
  __shared__ float lse_s[BC];
  __shared__ float dd_s[BC];

  const int h = blockIdx.y, b = blockIdx.z;
  const size_t head = ((size_t)b * H + h) * (size_t)T * HD;
  const size_t rowbase = ((size_t)b * H + h) * (size_t)T;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int key_a = blockIdx.x * BR + warp * 16 + gid;
  const int key_b = key_a + 8;
  const bool off_a = masked_col(key_a, T, pad_lo, pad_hi);
  const bool off_b = masked_col(key_b, T, pad_lo, pad_hi);

  uint32_t ka[4][4], va[4][4];
  load_rows(ka, k + head, key_a, key_b, tig, T);
  load_rows(va, v + head, key_a, key_b, tig, T);

  float acc_k[8][4], acc_v[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    acc_k[i][0] = acc_k[i][1] = acc_k[i][2] = acc_k[i][3] = 0.f;
    acc_v[i][0] = acc_v[i][1] = acc_v[i][2] = acc_v[i][3] = 0.f;
  }

  const int ntiles = (T + BC - 1) / BC;
  for (int qt = 0; qt < ntiles; ++qt) {
    const int q0 = qt * BC;
    __syncthreads();  // previous tile fully consumed
    load_tile(q + head, q0, T, Qs, Qt);
    load_tile(dout + head, q0, T, Gs, Gt);
    if (threadIdx.x < BC) {
      int r = q0 + threadIdx.x;
      lse_s[threadIdx.x] = r < T ? lse2[rowbase + r] : 0.f;
      dd_s[threadIdx.x] = r < T ? dd[rowbase + r] : 0.f;
    }
    __syncthreads();

    float s[8][4], dp[8][4];
    mma_rows(s, ka, Qs, gid, tig);   // S^T  = K Q^T   (keys x queries)
    mma_rows(dp, va, Gs, gid, tig);  // dP^T = V dO^T
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        int qc = nt * 8 + tig * 2 + (i & 1);
        bool off = (i < 2 ? off_a : off_b) || q0 + qc >= T;
        float p = off ? 0.f : round_bf16(exp2f(s[nt][i] * scale_log2 - lse_s[qc]));
        s[nt][i] = p;
        dp[nt][i] = p * (dp[nt][i] - dd_s[qc]);
      }
    }
    mma_acc(acc_v, s, Gt, gid, tig);   // dV += P^T dO
    mma_acc(acc_k, dp, Qt, gid, tig);  // dK += dS^T Q
  }

  store_rows(dk + head, acc_k, scale, key_a, key_b, tig, T);
  store_rows(dv + head, acc_v, 1.f, key_a, key_b, tig, T);
}

}  // namespace

extern "C" {

// q, k, v, out, dout, dq: (B, H, T, 64) bf16 contiguous; lse2 (from
// attn_flash_forward on the same q, k) and dd: (B, H, T) f32. dd is written.
int attn_backward_dq(const void* q, const void* k, const void* v, const void* out,
                     const void* dout, const void* lse2, void* dq, void* dd, int B, int H, int T,
                     int pad_lo, int pad_hi, float scale_log2, float scale, void* stream) {
  dim3 grid((T + BR - 1) / BR, H, B);
  bwd_dq<<<grid, NTHREADS, 0, (cudaStream_t)stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)out, (const bf16*)dout,
      (const float*)lse2, (bf16*)dq, (float*)dd, H, T, pad_lo, pad_hi, scale_log2, scale);
  return (int)cudaGetLastError();
}

// dk, dv: (B, H, T, 64) bf16; dd from attn_backward_dq on the same inputs.
int attn_backward_dkv(const void* q, const void* k, const void* v, const void* dout,
                      const void* lse2, const void* dd, void* dk, void* dv, int B, int H, int T,
                      int pad_lo, int pad_hi, float scale_log2, float scale, void* stream) {
  dim3 grid((T + BR - 1) / BR, H, B);
  bwd_dkv<<<grid, NTHREADS, 0, (cudaStream_t)stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)dout, (const float*)lse2,
      (const float*)dd, (bf16*)dk, (bf16*)dv, H, T, pad_lo, pad_hi, scale_log2, scale);
  return (int)cudaGetLastError();
}

}  // extern "C"
