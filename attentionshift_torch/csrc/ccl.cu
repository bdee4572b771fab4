// Batched 8-connected component labelling, one block per plane.
//
// Replaces the Pallas TPU kernel _ccl_batch_kernel
// (attentionshift_tpu/ops/ccl.py:200, via connected_components_batch with
// use_pallas=True). Labels: background 0, a component's label is the
// minimum original flat index in it, plus 1. The fixpoint runs at most
// max_iters sweeps and returns the labels it has then, as the TPU kernel
// does.
//
// One sweep is exactly the TPU sweep (_batch_sweep_body, ccl.py:145-197):
//   (a) every foreground cell takes the minimum over its 3x3 window
//       (a synchronous update from the previous labels),
//   (b) every vertical run of foreground cells takes its run minimum
//       (the forward + reverse segmented min-scans along axis 1),
//   (c) every horizontal run takes its run minimum (axis 2).
// The loop stops when a sweep changes nothing or after max_iters sweeps.
// A plane that has converged is a fixpoint of the sweep, so labelling each
// plane on its own gives what the TPU's tile-wide loop gives.
//
// What bounds it on the H100. At the bench shape (140 planes of 50x84,
// 0.6 MB in, 2.4 MB out) the bytes take under 1 us; the time is the
// sweeps' latency: each sweep is three dependent phases with block-wide
// barriers, and a run minimum is a chain along its line. The first design
// walked each line serially, one thread per row or column, and read the
// mask from device memory in every phase: about 67 us per sweep.
//
// What the design does about it. The plane's mask and both label buffers
// (the synchronous 3x3 phase reads one and writes the other, which then
// becomes the labels) live in shared memory with a one-cell border of
// background, so the 3x3 phase needs no bounds checks and device memory
// is read once and written once. Each line's run minima are one warp's
// work (32 warps per plane): every lane takes a chunk of ceil(L / 32)
// consecutive cells, finds its chunk's trailing and leading run minima, a
// segmented min-scan over the lanes (shuffles of a value and its "chunk
// has background" bit packed in one int, forward and reverse) carries them
// across chunks, and two passes over the chunk write the forward scan and
// then the run minimum. The padded row stride is odd, so the lanes of a
// column scan hit distinct banks. A block-wide __syncthreads_or is the
// changed flag.
// Planes too large for shared memory run the same code on a per-plane
// buffer of the same layout in device memory.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

#ifndef CCL_THREADS
#define CCL_THREADS 1024
#endif

constexpr int NTHREADS = CCL_THREADS;
constexpr int NWARPS = NTHREADS / 32;
constexpr int BIG = 1 << 30;

// the padded plane: (H + 2) rows of LS cells, LS = W + 2 made odd
__host__ __device__ inline int row_stride(int W) { return (W + 2) | 1; }

__host__ __device__ inline size_t plane_bytes(int H, int W) {
  const size_t cells = (size_t)(H + 2) * row_stride(W);
  return (cells * (2 * sizeof(int) + 1) + 15) / 16 * 16;
}

// Replace every foreground run of one line (L cells from `base`, `stride`
// apart) by its minimum; one warp. Background cells hold BIG throughout.
__device__ void line_run_min(int* lab, const uint8_t* fg, int base, int stride, int L, int lane) {
  const int c = (L + 31) >> 5;
  const int lo = min(lane * c, L), hi = min(lo + c, L);
  // the chunk's trailing run minimum (what flows right), its leading run
  // minimum (what flows left), and whether it is foreground throughout
  int tail = BIG, head = BIG;
  bool open = true, lead = true;
  for (int j = lo; j < hi; ++j) {
    const int p = base + j * stride;
    if (fg[p]) {
      const int v = lab[p];
      tail = min(tail, v);
      if (lead) head = min(head, v);
    } else {
      tail = BIG;
      open = lead = false;
    }
  }
  // carries across chunks: inclusive segmented min-scans over the lanes of
  // (tail, open) from the left and (head, open) from the right, each pair
  // packed into one int (bit 31: a chunk with a background cell; labels
  // and BIG fit 31 bits), then shifted by one lane
  const int closed = open ? 0 : int(1u << 31) ;
  int ct = tail | closed, cr = head | closed;
#pragma unroll
  for (int s = 1; s < 32; s <<= 1) {
    const int t2 = __shfl_up_sync(0xffffffffu, ct, s);
    const int r2 = __shfl_down_sync(0xffffffffu, cr, s);
    if (lane >= s && ct >= 0) ct = min(ct, t2 & 0x7fffffff) | (t2 & int(1u << 31));
    if (lane + s < 32 && cr >= 0) cr = min(cr, r2 & 0x7fffffff) | (r2 & int(1u << 31));
  }
  __syncwarp();  // every lane has read its chunk before any lane writes
  int left = __shfl_up_sync(0xffffffffu, ct, 1) & 0x7fffffff;
  int right = __shfl_down_sync(0xffffffffu, cr, 1) & 0x7fffffff;
  if (lane == 0) left = BIG;
  if (lane == 31) right = BIG;
  // forward scan (the run minimum up to each cell) ...
  int run = left;
  for (int j = lo; j < hi; ++j) {
    const int p = base + j * stride;
    if (fg[p]) {
      run = min(run, lab[p]);
      lab[p] = run;
    } else {
      run = BIG;
    }
  }
  __syncwarp();
  // ... then the reverse scan over it: the minimum of the whole run
  run = right;
  for (int j = hi - 1; j >= lo; --j) {
    const int p = base + j * stride;
    if (fg[p]) {
      run = min(run, lab[p]);
      lab[p] = run;
    } else {
      run = BIG;
    }
  }
  __syncwarp();
}

__global__ void __launch_bounds__(NTHREADS)
ccl_kernel(const uint8_t* __restrict__ masks, int32_t* __restrict__ out,
           uint8_t* __restrict__ scratch, int H, int W, int max_iters, int in_smem) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int LS = row_stride(W);
  const int cells = (H + 2) * LS;
  uint8_t* buf = in_smem ? smem : scratch + (size_t)blockIdx.x * plane_bytes(H, W);
  int* lab = reinterpret_cast<int*>(buf);
  int* tmp = lab + cells;
  uint8_t* fg = reinterpret_cast<uint8_t*>(tmp + cells);
  const uint8_t* src = masks + (size_t)blockIdx.x * H * W;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  // the padded plane: border and background BIG in both buffers
  for (int i = threadIdx.x; i < cells; i += NTHREADS) {
    const int y = i / LS - 1, x = i - (y + 1) * LS - 1;
    const bool on = y >= 0 && y < H && x >= 0 && x < W && src[y * W + x];
    fg[i] = on;
    lab[i] = tmp[i] = on ? y * W + x : BIG;
  }
  __syncthreads();

  for (int it = 0; it < max_iters; ++it) {
    // (a) synchronous 3x3 minimum, lab -> tmp, one warp per row
    for (int y = warp; y < H; y += NWARPS) {
      for (int x = lane; x < W; x += 32) {
        const int p = (y + 1) * LS + x + 1;
        if (!fg[p]) continue;
        const int* a = lab + p - LS;
        const int* b = lab + p;
        const int* c = lab + p + LS;
        tmp[p] = min(min(min(a[-1], a[0]), min(a[1], b[-1])),
                     min(min(b[0], b[1]), min(min(c[-1], c[0]), c[1])));
      }
    }
    __syncthreads();
    // (b) vertical runs, one warp per column
    for (int x = warp; x < W; x += NWARPS) line_run_min(tmp, fg, LS + x + 1, LS, H, lane);
    __syncthreads();
    // (c) horizontal runs, one warp per row; then compare with the labels
    int changed = 0;
    for (int y = warp; y < H; y += NWARPS) {
      const int base = (y + 1) * LS + 1;
      line_run_min(tmp, fg, base, 1, W, lane);
      for (int x = lane; x < W; x += 32) changed |= tmp[base + x] != lab[base + x];
    }
    int* t = lab;
    lab = tmp;
    tmp = t;
    if (!__syncthreads_or(changed)) break;
  }

  int32_t* o = out + (size_t)blockIdx.x * H * W;
  for (int i = threadIdx.x; i < H * W; i += NTHREADS) {
    const int y = i / W, x = i - y * W;
    const int p = (y + 1) * LS + x + 1;
    o[i] = fg[p] ? lab[p] + 1 : 0;
  }
}

}  // namespace

extern "C" {

// bytes of one plane's working buffer (both label buffers and the mask,
// with their border): in shared memory when it fits, else per plane in
// the scratch buffer
size_t ccl_plane_bytes(int H, int W) { return plane_bytes(H, W); }

// masks: (M, H, W) bool (1 byte) contiguous; out: (M, H, W) int32;
// scratch: M * ccl_plane_bytes(H, W) bytes, used only when smem_bytes == 0.
int ccl_batch_forward(const void* masks, void* out, void* scratch, int M, int H, int W,
                      int max_iters, int smem_bytes, void* stream) {
  if (smem_bytes > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(ccl_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         smem_bytes);
    if (e != cudaSuccess) return (int)e;
  }
  ccl_kernel<<<M, NTHREADS, smem_bytes, (cudaStream_t)stream>>>(
      (const uint8_t*)masks, (int32_t*)out, (uint8_t*)scratch, H, W, max_iters,
      smem_bytes > 0 ? 1 : 0);
  return (int)cudaGetLastError();
}

}  // extern "C"
