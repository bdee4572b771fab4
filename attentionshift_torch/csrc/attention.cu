// Attention forward kernels for the ViT backbone (bf16, head dim 64).
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
// 989 TFLOP/s). The capture call adds the (T, T) bf16 mean matrix, 38 MB
// written once (11 us at 3.35 TB/s), and the recompute of q.k^T for it.
//
// What the design does about it. The TPU kernel kept all six heads' K/V
// and a (128, T) f32 row tile in 100 MB of VMEM; an SM has 227 KB, so
// the key axis is tiled here:
//   flash_fwd   one block per (64 query rows, head, image): online softmax
//               over 64-key tiles with the row max subtracted, mma.sync
//               m16n8k16 bf16 products with f32 accumulation, the P tile
//               kept in registers between the two products. It writes
//               `out` and, for the capture call, each row's log2-sum-exp
//               per head (the row normaliser, known before heads are
//               summed).
//   attn_mean   one block per (64 query rows, 64 keys, image): recomputes
//               q.k^T for every head, p = exp2(s - lse_h), sums over heads,
//               and writes the mean tile once in bf16. Nothing (T, T)-sized
//               but the output itself touches device memory.
// Columns in the pad gap [pad_lo, pad_hi) and columns >= T get p = 0; the
// row sum is floored at 1e-30 as on the TPU. The TPU's constant shift of
// 20 in exp2 (a VPU choice) is replaced by the row max, which makes its
// exponent clamp at 100 unnecessary. No cp.async/TMA/wgmma yet: tiles are
// loaded synchronously, which a later change can pipeline.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int HD = 64;       // head dim
constexpr int BQ = 64;       // query rows per block: 4 warps x 16
constexpr int BK = 64;       // keys per tile
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

// two adjacent bf16 (row r, cols c, c+1) of a (T, 64) head matrix; 0 past T
__device__ __forceinline__ uint32_t ld2(const bf16* m, int r, int c, int T) {
  if (r >= T) return 0u;
  return *reinterpret_cast<const uint32_t*>(m + (size_t)r * HD + c);
}

__device__ __forceinline__ bool masked_col(int col, int T, int pad_lo, int pad_hi) {
  return col >= T || (col >= pad_lo && col < pad_hi);
}

// A fragments of a warp's 16 query rows over the whole head dim
__device__ __forceinline__ void load_q(uint32_t qa[4][4], const bf16* qh, int r_a, int r_b,
                                       int tig, int T) {
#pragma unroll
  for (int kc = 0; kc < 4; ++kc) {
    int c = kc * 16 + tig * 2;
    qa[kc][0] = ld2(qh, r_a, c, T);
    qa[kc][1] = ld2(qh, r_b, c, T);
    qa[kc][2] = ld2(qh, r_a, c + 8, T);
    qa[kc][3] = ld2(qh, r_b, c + 8, T);
  }
}

__global__ void __launch_bounds__(NTHREADS)
flash_fwd(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
          bf16* __restrict__ out, float* __restrict__ lse2, int H, int T, int pad_lo,
          int pad_hi, float scale_log2) {
  __shared__ __align__(16) bf16 Ks[BK][LDS];
  __shared__ __align__(16) bf16 Vt[HD][BK + 8];

  const int h = blockIdx.y, b = blockIdx.z;
  const size_t head = ((size_t)b * H + h) * (size_t)T * HD;
  const bf16* qh = q + head;
  const bf16* kh = k + head;
  const bf16* vh = v + head;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int r_a = blockIdx.x * BQ + warp * 16 + gid;
  const int r_b = r_a + 8;

  uint32_t qa[4][4];
  load_q(qa, qh, r_a, r_b, tig, T);

  float o[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.f;
  float m_a = -INFINITY, m_b = -INFINITY, l_a = 0.f, l_b = 0.f;

  const int ntiles = (T + BK - 1) / BK;
  for (int kt = 0; kt < ntiles; ++kt) {
    const int key0 = kt * BK;
    __syncthreads();  // previous tile fully consumed
    // 64 rows x 8 chunks of 8 bf16 per operand: 4 chunks per thread
    for (int i = threadIdx.x; i < BK * (HD / 8); i += NTHREADS) {
      int r = i >> 3, c8 = (i & 7) * 8;
      int key = key0 + r;
      uint4 kv = make_uint4(0, 0, 0, 0), vv = make_uint4(0, 0, 0, 0);
      if (key < T) {
        kv = *reinterpret_cast<const uint4*>(kh + (size_t)key * HD + c8);
        vv = *reinterpret_cast<const uint4*>(vh + (size_t)key * HD + c8);
      }
      *reinterpret_cast<uint4*>(&Ks[r][c8]) = kv;
      const bf16* ve = reinterpret_cast<const bf16*>(&vv);
#pragma unroll
      for (int j = 0; j < 8; ++j) Vt[c8 + j][r] = ve[j];
    }
    __syncthreads();

    // S = Q K^T for 16 rows x 64 keys (8 n-tiles of 8)
    float s[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
      for (int kc = 0; kc < 4; ++kc) {
        uint32_t bb[2];
        bb[0] = *reinterpret_cast<const uint32_t*>(&Ks[nt * 8 + gid][kc * 16 + tig * 2]);
        bb[1] = *reinterpret_cast<const uint32_t*>(&Ks[nt * 8 + gid][kc * 16 + tig * 2 + 8]);
        mma16816(s[nt], qa[kc], bb);
      }
    }
    // scale into the log2 domain, mask, and take the tile row max
    float tm_a = -INFINITY, tm_b = -INFINITY;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        int col = key0 + nt * 8 + tig * 2 + (i & 1);
        float x = masked_col(col, T, pad_lo, pad_hi) ? -INFINITY : s[nt][i] * scale_log2;
        s[nt][i] = x;
        if (i < 2) tm_a = fmaxf(tm_a, x); else tm_b = fmaxf(tm_b, x);
      }
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      tm_a = fmaxf(tm_a, __shfl_xor_sync(0xffffffffu, tm_a, off));
      tm_b = fmaxf(tm_b, __shfl_xor_sync(0xffffffffu, tm_b, off));
    }
    const float mn_a = fmaxf(m_a, tm_a), mn_b = fmaxf(m_b, tm_b);
    // a row with every column masked so far keeps a zero shift (no inf-inf)
    const float sh_a = mn_a == -INFINITY ? 0.f : mn_a;
    const float sh_b = mn_b == -INFINITY ? 0.f : mn_b;
    const float al_a = exp2f(m_a - sh_a), al_b = exp2f(m_b - sh_b);
    m_a = mn_a;
    m_b = mn_b;
    l_a *= al_a;
    l_b *= al_b;
#pragma unroll
    for (int dt = 0; dt < 8; ++dt) {
      o[dt][0] *= al_a; o[dt][1] *= al_a;
      o[dt][2] *= al_b; o[dt][3] *= al_b;
    }
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      s[nt][0] = exp2f(s[nt][0] - sh_a);
      s[nt][1] = exp2f(s[nt][1] - sh_a);
      s[nt][2] = exp2f(s[nt][2] - sh_b);
      s[nt][3] = exp2f(s[nt][3] - sh_b);
      l_a += s[nt][0] + s[nt][1];
      l_b += s[nt][2] + s[nt][3];
    }
    // O += P V: the S accumulators of n-tiles (2c, 2c+1) are the A fragment
    // of key chunk c
#pragma unroll
    for (int kc = 0; kc < 4; ++kc) {
      uint32_t pa[4];
      pa[0] = pack2(s[2 * kc][0], s[2 * kc][1]);
      pa[1] = pack2(s[2 * kc][2], s[2 * kc][3]);
      pa[2] = pack2(s[2 * kc + 1][0], s[2 * kc + 1][1]);
      pa[3] = pack2(s[2 * kc + 1][2], s[2 * kc + 1][3]);
#pragma unroll
      for (int dt = 0; dt < 8; ++dt) {
        uint32_t bb[2];
        bb[0] = *reinterpret_cast<const uint32_t*>(&Vt[dt * 8 + gid][kc * 16 + tig * 2]);
        bb[1] = *reinterpret_cast<const uint32_t*>(&Vt[dt * 8 + gid][kc * 16 + tig * 2 + 8]);
        mma16816(o[dt], pa, bb);
      }
    }
  }

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l_a += __shfl_xor_sync(0xffffffffu, l_a, off);
    l_b += __shfl_xor_sync(0xffffffffu, l_b, off);
  }
  l_a = fmaxf(l_a, 1e-30f);
  l_b = fmaxf(l_b, 1e-30f);
  const float inv_a = 1.f / l_a, inv_b = 1.f / l_b;
  bf16* oh = out + head;
#pragma unroll
  for (int dt = 0; dt < 8; ++dt) {
    int c = dt * 8 + tig * 2;
    if (r_a < T)
      *reinterpret_cast<uint32_t*>(oh + (size_t)r_a * HD + c) = pack2(o[dt][0] * inv_a, o[dt][1] * inv_a);
    if (r_b < T)
      *reinterpret_cast<uint32_t*>(oh + (size_t)r_b * HD + c) = pack2(o[dt][2] * inv_b, o[dt][3] * inv_b);
  }
  if (lse2 != nullptr && tig == 0) {
    float* lh = lse2 + ((size_t)b * H + h) * T;
    if (r_a < T) lh[r_a] = (m_a == -INFINITY ? 0.f : m_a) + log2f(l_a);
    if (r_b < T) lh[r_b] = (m_b == -INFINITY ? 0.f : m_b) + log2f(l_b);
  }
}

__global__ void __launch_bounds__(NTHREADS)
attn_mean(const bf16* __restrict__ q, const bf16* __restrict__ k, const float* __restrict__ lse2,
          bf16* __restrict__ mean, int H, int T, int pad_lo, int pad_hi, float scale_log2) {
  const int b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int r_a = blockIdx.y * BQ + warp * 16 + gid;
  const int r_b = r_a + 8;
  const int key0 = blockIdx.x * BK;

  float acc[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;

  for (int h = 0; h < H; ++h) {
    const size_t head = ((size_t)b * H + h) * (size_t)T * HD;
    const bf16* qh = q + head;
    const bf16* kh = k + head;
    uint32_t qa[4][4];
    load_q(qa, qh, r_a, r_b, tig, T);
    const float* lh = lse2 + ((size_t)b * H + h) * T;
    const float lse_a = r_a < T ? lh[r_a] : 0.f;
    const float lse_b = r_b < T ? lh[r_b] : 0.f;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      float s[4] = {0.f, 0.f, 0.f, 0.f};
      const int key = key0 + nt * 8 + gid;
#pragma unroll
      for (int kc = 0; kc < 4; ++kc) {
        uint32_t bb[2];
        bb[0] = ld2(kh, key, kc * 16 + tig * 2, T);
        bb[1] = ld2(kh, key, kc * 16 + tig * 2 + 8, T);
        mma16816(s, qa[kc], bb);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        int col = key0 + nt * 8 + tig * 2 + (i & 1);
        float l = i < 2 ? lse_a : lse_b;
        acc[nt][i] += masked_col(col, T, pad_lo, pad_hi) ? 0.f : exp2f(s[i] * scale_log2 - l);
      }
    }
  }

  const float inv_h = 1.f / (float)H;
  bf16* mb = mean + (size_t)b * T * T;
  const bool even = (T & 1) == 0;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    const int col = key0 + nt * 8 + tig * 2;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = half ? r_b : r_a;
      if (r >= T) continue;
      float x0 = acc[nt][2 * half] * inv_h, x1 = acc[nt][2 * half + 1] * inv_h;
      bf16* dst = mb + (size_t)r * T + col;
      if (even && col + 1 < T) {
        *reinterpret_cast<uint32_t*>(dst) = pack2(x0, x1);
      } else {
        if (col < T) dst[0] = __float2bfloat16(x0);
        if (col + 1 < T) dst[1] = __float2bfloat16(x1);
      }
    }
  }
}

}  // namespace

extern "C" {

// q, k, v, out: (B, H, T, 64) bf16 contiguous. lse2: (B, H, T) f32 or null.
int attn_flash_forward(const void* q, const void* k, const void* v, void* out, void* lse2,
                       int B, int H, int T, int pad_lo, int pad_hi, float scale_log2,
                       void* stream) {
  dim3 grid((T + BQ - 1) / BQ, H, B);
  flash_fwd<<<grid, NTHREADS, 0, (cudaStream_t)stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (bf16*)out, (float*)lse2, H, T, pad_lo,
      pad_hi, scale_log2);
  return (int)cudaGetLastError();
}

// mean: (B, T, T) bf16; lse2 from attn_flash_forward on the same q, k.
int attn_mean_forward(const void* q, const void* k, const void* lse2, void* mean, int B, int H,
                      int T, int pad_lo, int pad_hi, float scale_log2, void* stream) {
  dim3 grid((T + BK - 1) / BK, (T + BQ - 1) / BQ, B);
  attn_mean<<<grid, NTHREADS, 0, (cudaStream_t)stream>>>(
      (const bf16*)q, (const bf16*)k, (const float*)lse2, (bf16*)mean, H, T, pad_lo, pad_hi,
      scale_log2);
  return (int)cudaGetLastError();
}

}  // extern "C"
