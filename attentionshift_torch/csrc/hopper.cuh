// Hopper (sm_90a) building blocks for the hand-written kernels: mbarriers,
// TMA tile and box loads from a 3-D tensor map, wgmma matrix descriptors and the
// m64n128k16, m64n64k16 and m64n32k16 bf16 products with f32 accumulators (A in
// registers, or in shared memory: K-major at m64n128k16, of either major at
// m64n32k16), and a 1024-byte aligner for the dynamic shared memory that holds
// the swizzled slots.
//
// Tile convention: a (64 rows, 64) bf16 tile of a (planes, rows, 64) tensor
// is 64 rows of 128 bytes, loaded by TMA under CU_TENSOR_MAP_SWIZZLE_128B
// into a 1024-byte aligned slot. One such tile serves wgmma in both majors:
//   K-major   (the 64 columns are the contraction): desc_kmajor + 32 B per k16 step;
//   MN-major  (the 64 rows are the contraction):    desc_mnmajor + 2048 B per k16 step.
// A (64 rows, 32) tile of a (planes, rows, 32) tensor (head dim 32) is 64
// rows of 64 bytes under CU_TENSOR_MAP_SWIZZLE_64B (HeadTile<32>::map), in a
// 512-byte aligned slot of 4096 bytes, with the same two uses:
//   K-major   (two k16 steps):      desc_kmajor32 + 32 B per k16 step;
//   MN-major  (N = 32, m64n32k16):  desc_mnmajor32 + 1024 B per k16 step.
// A (64 rows, 128) tile of a (planes, rows, 128) tensor (head dim 128) is
// two such 64-column tiles side by side in one 16 KB slot: columns 0-63 in
// the first 8 KB, 64-127 in the second, each one TMA box under the 128-byte
// swizzle (HeadTile<128>::map: a 128-column map with 64-column boxes):
//   K-major   (eight k16 steps):   desc_kmajor of half kc / 4, k16 step kc % 4;
//   MN-major  (N = 128, m64n128k16): desc_mnmajor, whose leading byte offset
//             (8 KB) is the stride from one 64-column swizzle atom to the next.
// HeadTile<128>, HeadTile<64> and HeadTile<32> name these per head dim.
// Each also loads its tile from a wider tensor: HeadTile<HD>::map over a
// row of `cols` columns and HeadTile<HD>::load at a column offset. The wide
// route of the attention kernels (head dims above 128, padded to a multiple
// of 128) walks a head row as a run of 128-column slabs that way: slab c is
// the HeadTile<128> at column 128 c, with the descriptors above; v6 of the
// variants reads its padded V's first HD columns that way.
// The tensor map is encoded on the host through the entry point that
// cudaGetDriverEntryPoint returns, so no -lcuda is needed at link time.

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace hopper {

// ---------------------------------------------------------------- mbarrier

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// the first 1024-byte aligned address at or after p (the 128-byte swizzle
// repeats every 1024 bytes); dynamic shared memory reserves 1024 bytes for it
__device__ __forceinline__ uint8_t* align1024(uint8_t* p) {
  uint32_t s = smem_addr(p);
  return p + ((1024 - (s & 1023)) & 1023);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

// make the initialised barriers visible to the async proxy (TMA)
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// one arrival of this thread (a barrier whose count is the arrivals it waits for)
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}

// spin until the barrier's phase differs from `parity`
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "MBAR_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@done bra MBAR_DONE;\n"
      "bra MBAR_WAIT;\n"
      "MBAR_DONE:\n"
      "}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

// ---------------------------------------------------------------- TMA

// one box of a 3-D map at (col, row, plane); rows and columns past the
// tensor arrive as zeros; completes the box's bytes on `bar`
__device__ __forceinline__ void tma_load_box(void* dst, const CUtensorMap* map, uint64_t* bar,
                                             int col, int row, int plane) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(col), "r"(row), "r"(plane)
      : "memory");
}

// one (64, 64) bf16 tile at (row, plane) of a 3-D map: the box at column 0
__device__ __forceinline__ void tma_load_tile(void* dst, const CUtensorMap* map, uint64_t* bar,
                                              int row, int plane) {
  tma_load_box(dst, map, bar, 0, row, plane);
}

// one (64 rows, 64 columns) bf16 box at (col, row) of a 2-D map; rows and
// columns past the tensor arrive as zeros; completes `bytes` on `bar`
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int col, int row) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(col), "r"(row)
      : "memory");
}

constexpr int TILE_ROWS = 64;
constexpr int TILE_BYTES = TILE_ROWS * 128;

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault,
                                     &found);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (found == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// Map of a contiguous (planes, rows, cols) bf16 tensor (cols a multiple of
// 8: rows 16-byte aligned) with (box_cols, 64, 1) boxes, zeros outside the
// tensor: box_cols = 64 under the 128-byte swizzle (a 1024-byte aligned
// slot of 64 rows of 128 bytes), or without swizzle (64 rows of box_cols *
// 2 bytes, packed; at least 16 bytes). Returns 0, or a code that says why
// not: TMA_NO_ENTRY_POINT, TMA_MISALIGNED, or TMA_REFUSED + the CUresult of
// the encoding.
constexpr int TMA_NO_ENTRY_POINT = 999;
constexpr int TMA_MISALIGNED = 998;
constexpr int TMA_REFUSED = 1000;

inline int encode_plane_map(CUtensorMap* map, const void* base, int planes, int rows, int cols,
                            int box_cols, CUtensorMapSwizzle swizzle) {
  EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return TMA_NO_ENTRY_POINT;
  if ((reinterpret_cast<uintptr_t>(base) & 15) != 0 || cols % 8 != 0) return TMA_MISALIGNED;
  cuuint64_t dims[3] = {(cuuint64_t)cols, (cuuint64_t)rows, (cuuint64_t)planes};
  cuuint64_t strides[2] = {(cuuint64_t)cols * 2, (cuuint64_t)rows * cols * 2};
  cuuint32_t box[3] = {(cuuint32_t)box_cols, TILE_ROWS, 1};
  cuuint32_t elem[3] = {1, 1, 1};
  CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base), dims,
                      strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : TMA_REFUSED + (int)r;
}

inline int make_plane_map(CUtensorMap* map, const void* base, int planes, int rows, int cols,
                          int box_cols, bool swizzle128) {
  return encode_plane_map(map, base, planes, rows, cols, box_cols,
                          swizzle128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_NONE);
}

// bytes of a (64 rows, 32) bf16 tile under the 64-byte swizzle
constexpr int TILE32_BYTES = TILE_ROWS * 64;

// Map of a contiguous (rows, cols) bf16 matrix (cols a multiple of 8) with
// (64, 64) boxes, 128-byte swizzle, zeros outside the matrix; returns as
// encode_plane_map does.
inline int make_map_2d(CUtensorMap* map, const void* base, int rows, int cols) {
  EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return TMA_NO_ENTRY_POINT;
  if ((reinterpret_cast<uintptr_t>(base) & 15) != 0 || cols % 8 != 0) return TMA_MISALIGNED;
  cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  cuuint64_t strides[1] = {(cuuint64_t)cols * 2};
  cuuint32_t box[2] = {64, TILE_ROWS};
  cuuint32_t elem[2] = {1, 1};
  CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base), dims,
                      strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : TMA_REFUSED + (int)r;
}

// byte offset of element (row, col) of a 128-byte-swizzled slot of bf16
// rows of 64 (what TMA writes under CU_TENSOR_MAP_SWIZZLE_128B): the 16-byte
// chunk c of row r sits at chunk c ^ (r % 8)
__device__ __forceinline__ uint32_t swz128(int row, int col) {
  return row * 128 + ((((col >> 3) ^ row) & 7) << 4) + ((col & 7) << 1);
}

// make generic-proxy writes to shared memory visible to the async proxy
// (wgmma operands, TMA)
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async;\n" ::: "memory");
}

// ---------------------------------------------------------------- wgmma

// matrix descriptor of a slot in shared memory: start >> 4, leading and
// stride byte offsets >> 4, the layout type in bits 62-63 (1: 128-byte
// swizzle, the tile convention; 0: no swizzle, 8 x 16-byte core matrices)
__device__ __forceinline__ uint64_t make_desc(uint32_t saddr, uint32_t lbo, uint32_t sbo,
                                              uint64_t layout = 1) {
  return (uint64_t)((saddr & 0x3FFFF) >> 4) | ((uint64_t)((lbo & 0x3FFFF) >> 4) << 16) |
         ((uint64_t)((sbo & 0x3FFFF) >> 4) << 32) | (layout << 62);
}

// K-major operand (rows = M or N, the 64 columns = the contraction), k16 step kc
__device__ __forceinline__ uint64_t desc_kmajor(const void* tile, int kc) {
  return make_desc(smem_addr(tile) + kc * 32, 16, 1024);
}

// MN-major operand (rows = the contraction, the 64 columns = N), k16 step kc
__device__ __forceinline__ uint64_t desc_mnmajor(const void* tile, int kc) {
  return make_desc(smem_addr(tile) + kc * 2048, TILE_BYTES, 1024);
}

// The same for a 32-column tile under the 64-byte swizzle (layout type 2):
// an 8-row swizzle atom is 512 bytes, the stride between 8-row groups.
// K-major: the 32 columns are the contraction, k16 step kc of 2, 32 B each.
__device__ __forceinline__ uint64_t desc_kmajor32(const void* tile, int kc) {
  return make_desc(smem_addr(tile) + kc * 32, 16, 512, 2);
}

// MN-major: the 64 rows are the contraction (16 rows of 64 B per k16
// step), the 32 columns N, one swizzle atom wide
__device__ __forceinline__ uint64_t desc_mnmajor32(const void* tile, int kc) {
  return make_desc(smem_addr(tile) + kc * 1024, TILE32_BYTES, 512, 2);
}

// What a head dim's tiles are: bytes per 64-row tile, k16 steps of a
// product that contracts over the head dim, descriptors, tensor map, the
// TMA load of one tile (`bytes` BYTES on its barrier), and the MN-major
// descriptor of column part `part` of PART_COLS columns (a product whose N
// is PART_COLS: all HD columns at 64 and 32, one 64-column half at 128)
template <int HD>
struct HeadTile;

template <>
struct HeadTile<64> {
  static constexpr int BYTES = TILE_BYTES;
  static constexpr int KSTEPS = 4;
  static constexpr int PART_COLS = 64;
  __device__ static __forceinline__ uint64_t kmajor(const void* t, int kc) {
    return desc_kmajor(t, kc);
  }
  __device__ static __forceinline__ uint64_t mnmajor(const void* t, int kc) {
    return desc_mnmajor(t, kc);
  }
  __device__ static __forceinline__ uint64_t mnmajor_part(const void* t, int, int kc) {
    return desc_mnmajor(t, kc);
  }
  __device__ static __forceinline__ void load(void* dst, const CUtensorMap* m, uint64_t* bar,
                                              int row, int plane, int col0 = 0) {
    tma_load_box(dst, m, bar, col0, row, plane);
  }
  static int map(CUtensorMap* m, const void* base, int planes, int rows, int cols = 64) {
    return make_plane_map(m, base, planes, rows, cols, 64, true);
  }
};

template <>
struct HeadTile<32> {
  static constexpr int BYTES = TILE32_BYTES;
  static constexpr int KSTEPS = 2;
  static constexpr int PART_COLS = 32;
  __device__ static __forceinline__ uint64_t kmajor(const void* t, int kc) {
    return desc_kmajor32(t, kc);
  }
  __device__ static __forceinline__ uint64_t mnmajor(const void* t, int kc) {
    return desc_mnmajor32(t, kc);
  }
  __device__ static __forceinline__ uint64_t mnmajor_part(const void* t, int, int kc) {
    return desc_mnmajor32(t, kc);
  }
  __device__ static __forceinline__ void load(void* dst, const CUtensorMap* m, uint64_t* bar,
                                              int row, int plane, int col0 = 0) {
    tma_load_box(dst, m, bar, col0, row, plane);
  }
  static int map(CUtensorMap* m, const void* base, int planes, int rows, int cols = 32) {
    return encode_plane_map(m, base, planes, rows, cols, 32, CU_TENSOR_MAP_SWIZZLE_64B);
  }
};

template <>
struct HeadTile<128> {
  static constexpr int BYTES = 2 * TILE_BYTES;
  static constexpr int KSTEPS = 8;
  static constexpr int PART_COLS = 64;
  __device__ static __forceinline__ uint64_t kmajor(const void* t, int kc) {
    return desc_kmajor(static_cast<const uint8_t*>(t) + (kc >> 2) * TILE_BYTES, kc & 3);
  }
  __device__ static __forceinline__ uint64_t mnmajor(const void* t, int kc) {
    return desc_mnmajor(t, kc);
  }
  __device__ static __forceinline__ uint64_t mnmajor_part(const void* t, int part, int kc) {
    return desc_mnmajor(static_cast<const uint8_t*>(t) + part * TILE_BYTES, kc);
  }
  __device__ static __forceinline__ void load(void* dst, const CUtensorMap* m, uint64_t* bar,
                                              int row, int plane, int col0 = 0) {
    tma_load_box(dst, m, bar, col0, row, plane);
    tma_load_box(static_cast<uint8_t*>(dst) + TILE_BYTES, m, bar, col0 + 64, row, plane);
  }
  static int map(CUtensorMap* m, const void* base, int planes, int rows, int cols = 128) {
    return make_plane_map(m, base, planes, rows, cols, 64, true);
  }
};

// The wide route of the attention kernels: head dims above 128, zero-padded
// to a multiple of 128, walked as a run of 128-column slabs, each a
// HeadTile<128> at column 128 c of a map over the whole row.
using Slab = HeadTile<128>;
constexpr int SLAB_COLS = 128;
inline bool wide_head_dim(int D) { return D > SLAB_COLS && D % SLAB_COLS == 0; }
constexpr int WIDE_STAGES = 2;  // ring slots of every wide-route kernel

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// wait until every committed group has completed
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// wait until at most N committed groups are pending (groups complete in order)
template <int N>
__device__ __forceinline__ void wgmma_wait_n() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keep the compiler from touching registers an in-flight wgmma owns
__device__ __forceinline__ void fence_regs(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
__device__ __forceinline__ void fence_regs(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
__device__ __forceinline__ void fence_regs(float (&d)[16]) {
#pragma unroll
  for (int i = 0; i < 16; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
__device__ __forceinline__ void fence_regs(uint32_t (&a)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(a[i][j])::"memory");
}

#define HOPPER_D32                                                                              \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, " \
  "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"
#define HOPPER_D32_OUT(d)                                                                      \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),          \
      "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),  \
      "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),            \
      "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),            \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])

// D (64 x 64, f32) (+)= A (64 x 16, K-major slot) * B (16 x 64, slot of
// either major: TRANS_B = 1 for MN-major); accumulate when `acc` != 0
template <int TRANS_B>
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t desc_a, uint64_t desc_b,
                                         int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " HOPPER_D32
      ", %32, %33, p, 1, 1, 0, %35;\n}\n"
      : HOPPER_D32_OUT(d)
      : "l"(desc_a), "l"(desc_b), "r"(acc), "n"(TRANS_B));
}

// the same with A (64 x 16) in registers: warp w of the warpgroup holds rows
// 16w..16w+15 in the m16n8k16 A-fragment layout
template <int TRANS_B>
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t desc_b,
                                         int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " HOPPER_D32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : HOPPER_D32_OUT(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(acc), "n"(TRANS_B));
}

#undef HOPPER_D32
#undef HOPPER_D32_OUT

#define HOPPER_D16 \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}"
#define HOPPER_D16_OUT(d)                                                                     \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),         \
      "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), \
      "+f"(d[14]), "+f"(d[15])

// D (64 x 32, f32) (+)= A (64 x 16 in registers, as above) * B (16 x 32,
// slot of either major): m64n32k16, the products whose N is head dim 32
template <int TRANS_B>
__device__ __forceinline__ void wgmma_rs(float (&d)[16], const uint32_t (&a)[4], uint64_t desc_b,
                                         int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 " HOPPER_D16
      ", {%16, %17, %18, %19}, %20, p, 1, 1, %22;\n}\n"
      : HOPPER_D16_OUT(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(acc), "n"(TRANS_B));
}

// the same with A (64 x 16) from shared memory too: TRANS_A = 1 for an
// MN-major A (a slot whose rows are the contraction and whose 64 columns
// are M: desc_mnmajor), as the head-dim-32 backward reads P^T and dS^T
template <int TRANS_A, int TRANS_B>
__device__ __forceinline__ void wgmma_ss32(float (&d)[16], uint64_t desc_a, uint64_t desc_b,
                                           int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 " HOPPER_D16
      ", %16, %17, p, 1, 1, %19, %20;\n}\n"
      : HOPPER_D16_OUT(d)
      : "l"(desc_a), "l"(desc_b), "r"(acc), "n"(TRANS_A), "n"(TRANS_B));
}

#undef HOPPER_D16
#undef HOPPER_D16_OUT

#define HOPPER_D64                                                                              \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, " \
  "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "  \
  "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, "   \
  "%56, %57, %58, %59, %60, %61, %62, %63}"
#define HOPPER_D64_OUT(d)                                                                      \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),          \
      "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),  \
      "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),            \
      "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),            \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),            \
      "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),            \
      "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),            \
      "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),            \
      "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),            \
      "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),            \
      "+f"(d[62]), "+f"(d[63])

// D (64 x 128, f32) (+)= A (64 x 16 in registers) * B (16 x 128, MN-major:
// two 64-column swizzle atoms 8 KB apart): m64n128k16, the products whose
// N is head dim 128
template <int TRANS_B>
__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4], uint64_t desc_b,
                                         int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " HOPPER_D64
      ", {%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
      : HOPPER_D64_OUT(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(acc), "n"(TRANS_B));
}

// the same with A (64 x 16, K-major) from shared memory too: the wide
// route of the variants multiplies a bf16 tile of e kept there by V's slab
template <int TRANS_B>
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t desc_a, uint64_t desc_b,
                                         int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " HOPPER_D64
      ", %64, %65, p, 1, 1, 0, %67;\n}\n"
      : HOPPER_D64_OUT(d)
      : "l"(desc_a), "l"(desc_b), "r"(acc), "n"(TRANS_B));
}

#undef HOPPER_D64
#undef HOPPER_D64_OUT

// Accumulator layout of m64n64 (f32, 32 per thread; m64n32: 16, j < 4; m64n128: 64,
// j < 16): d[4j + i] is row
// 16*warp + lane/4 + 8*(i >> 1), column 8j + 2*(lane % 4) + (i & 1). The
// A fragment of k16 step kc of a product that contracts over those 64
// columns is d[8kc .. 8kc + 7], rounded to bf16 pairs:
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  uint32_t r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}

__device__ __forceinline__ void acc_to_a(uint32_t (&a)[4][4], const float (&d)[32]) {
#pragma unroll
  for (int kc = 0; kc < 4; ++kc) {
    a[kc][0] = pack_bf16(d[8 * kc + 0], d[8 * kc + 1]);
    a[kc][1] = pack_bf16(d[8 * kc + 2], d[8 * kc + 3]);
    a[kc][2] = pack_bf16(d[8 * kc + 4], d[8 * kc + 5]);
    a[kc][3] = pack_bf16(d[8 * kc + 6], d[8 * kc + 7]);
  }
}

}  // namespace hopper
