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
// 2.4 MB in, 2.4 MB out) the bytes take under 2 us; the time is the
// sweeps' latency: each sweep is three dependent phases with block-wide
// barriers, and run scans walk a row or column serially.
//
// What the design does about it. The plane's labels (and a second buffer
// for the synchronous 3x3 update) stay in shared memory for the whole
// fixpoint, so device memory is read once and written once; a block-wide
// __syncthreads_or is the changed flag. Planes too large for shared memory
// keep the same algorithm on the output buffer and a scratch buffer in
// device memory.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NTHREADS = 256;
constexpr int BIG = 1 << 30;

// replace every foreground run along a line by its minimum
__device__ __forceinline__ void run_min(int* lab, const uint8_t* fg, int start, int stride,
                                        int len) {
  int i = 0;
  while (i < len) {
    if (!fg[start + i * stride]) {
      ++i;
      continue;
    }
    int j = i, m = BIG;
    while (j < len && fg[start + j * stride]) {
      m = min(m, lab[start + j * stride]);
      ++j;
    }
    for (int t = i; t < j; ++t) lab[start + t * stride] = m;
    i = j;
  }
}

__global__ void __launch_bounds__(NTHREADS)
ccl_kernel(const uint8_t* __restrict__ masks, int32_t* __restrict__ out,
           int32_t* __restrict__ scratch, int H, int W, int max_iters, int in_smem) {
  extern __shared__ int smem[];
  const int HW = H * W;
  const size_t plane = (size_t)blockIdx.x * HW;
  const uint8_t* fg = masks + plane;
  int* lab = in_smem ? smem : out + plane;
  int* tmp = in_smem ? smem + HW : scratch + plane;

  for (int i = threadIdx.x; i < HW; i += NTHREADS) lab[i] = fg[i] ? i : BIG;
  __syncthreads();

  for (int it = 0; it < max_iters; ++it) {
    // (a) synchronous 3x3 minimum
    for (int i = threadIdx.x; i < HW; i += NTHREADS) {
      if (!fg[i]) {
        tmp[i] = BIG;
        continue;
      }
      const int y = i / W, x = i - y * W;
      int m = lab[i];
      for (int dy = -1; dy <= 1; ++dy) {
        const int yy = y + dy;
        if (yy < 0 || yy >= H) continue;
        for (int dx = -1; dx <= 1; ++dx) {
          const int xx = x + dx;
          if (xx < 0 || xx >= W) continue;
          m = min(m, lab[yy * W + xx]);
        }
      }
      tmp[i] = m;
    }
    __syncthreads();
    // (b) vertical runs, one column per thread
    for (int x = threadIdx.x; x < W; x += NTHREADS) run_min(tmp, fg, x, W, H);
    __syncthreads();
    // (c) horizontal runs, one row per thread
    for (int y = threadIdx.x; y < H; y += NTHREADS) run_min(tmp, fg, y * W, 1, W);
    __syncthreads();
    int changed = 0;
    for (int i = threadIdx.x; i < HW; i += NTHREADS) {
      changed |= tmp[i] != lab[i];
      lab[i] = tmp[i];
    }
    if (!__syncthreads_or(changed)) break;
  }

  int32_t* o = out + plane;
  for (int i = threadIdx.x; i < HW; i += NTHREADS) o[i] = fg[i] ? lab[i] + 1 : 0;
}

}  // namespace

extern "C" {

// masks: (M, H, W) bool (1 byte) contiguous; out: (M, H, W) int32;
// scratch: (M, H, W) int32 used only when smem_bytes == 0.
int ccl_batch_forward(const void* masks, void* out, void* scratch, int M, int H, int W,
                      int max_iters, int smem_bytes, void* stream) {
  if (smem_bytes > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(ccl_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         smem_bytes);
    if (e != cudaSuccess) return (int)e;
  }
  ccl_kernel<<<M, NTHREADS, smem_bytes, (cudaStream_t)stream>>>(
      (const uint8_t*)masks, (int32_t*)out, (int32_t*)scratch, H, W, max_iters,
      smem_bytes > 0 ? 1 : 0);
  return (int)cudaGetLastError();
}

}  // extern "C"
