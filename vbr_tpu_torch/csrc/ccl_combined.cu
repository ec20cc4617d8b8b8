// Combined-phase 8-connected component labelling of binary images.
//
// Replaces the Pallas kernel of vbr_tpu/ops/ccl_pallas.py
// (_make_combined_kernel, launched by label_components_combined).  Every
// pixel gets the minimum padded linear index of its own-phase 8-connected
// component (foreground and background labelled together), computed by the
// same fixpoint with the same cap: labels start at the linear index, and
// each iteration
//   1. takes the min over the same-phase diagonal neighbours of the
//      iteration-start labels (orthogonal neighbours are covered by 2-3),
//   2. runs a segmented min-scan along every row, forward then reverse,
//   3. runs a segmented min-scan along every column, forward then reverse,
// where a segment starts wherever the phase differs from the predecessor
// (or at the image edge).  The loop stops after an iteration that changes
// nothing, or after max_iters iterations.  Labels after k iterations are
// identical to the TPU kernel's, including at the cap, where a
// union-find would return different (fully converged) labels.  A
// sequential segmented min equals the TPU kernel's gated Hillis-Steele
// scan exactly (min is exact and associative).
//
// What bounds it on an H100: latency and L2 bandwidth of one SM per image.
// Each iteration streams the label image (1.5 MB at 488x768 i32) a few
// times; the whole problem needs only the phase read and the labels
// written once (12 MB for 4 images, ~4 us at 3.35 TB/s), but the
// iteration count (data-dependent: a few to tens) and the grid-wide dependency
// between passes keep it far above that.
//
// Design: one CTA of 1024 threads per image, labels in device memory (two
// buffers; all four images fit in the 50 MB L2).  The diagonal pass is one
// thread per pixel.  Row scans give each warp whole rows and scan 32
// columns at a time with a warp-shuffle segmented scan plus a carry, so
// every load is coalesced.  Column scans give each thread one column and
// walk it top to bottom (adjacent threads, adjacent addresses).  A
// __syncthreads_or carries the "changed" flag.  The iteration count of
// each image is written out beside the labels.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kBig = 1 << 30;
constexpr unsigned kFull = 0xffffffffu;

// Inclusive segmented min-scan across the 32 lanes of a warp: lane i ends
// with the min over [its segment's first lane, i]; f = 1 starts a segment.
// Lanes whose segment began in an earlier chunk also fold in ``carry``.
__device__ __forceinline__ int warp_seg_min(int v, int f, int lane,
                                            int carry) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int vs = __shfl_up_sync(kFull, v, d);
    const int fs = __shfl_up_sync(kFull, f, d);
    if (lane >= d) {
      if (!f) v = min(v, vs);
      f |= fs;
    }
  }
  return f ? v : min(v, carry);
}

__global__ void __launch_bounds__(kThreads) ccl_combined_kernel(
    const int32_t* __restrict__ phase,  // (B, H, W) 0/1
    int32_t* labels,                    // (B, H, W) result
    int32_t* scratch,                   // (B, H, W) second buffer
    int32_t* iters,                     // (B,) iterations run
    int H, int W, int max_iters) {
  const int HW = H * W;  // < 2^31, checked by the launcher
  const int32_t* ph = phase + (size_t)blockIdx.x * HW;
  int32_t* const out = labels + (size_t)blockIdx.x * HW;
  int32_t* cur = out;
  int32_t* nxt = scratch + (size_t)blockIdx.x * HW;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;

  for (int i = tid; i < HW; i += blockDim.x) cur[i] = i;
  __syncthreads();

  int it = 0;
  int changed = 1;
  while (changed && it < max_iters) {
    // 1. same-phase diagonal min of the iteration-start labels
    for (int i = tid; i < HW; i += blockDim.x) {
      const int y = i / W;
      const int x = i - y * W;
      const int p = ph[i];
      int m = cur[i];
      if (y > 0) {
        if (x > 0 && ph[i - W - 1] == p) m = min(m, cur[i - W - 1]);
        if (x < W - 1 && ph[i - W + 1] == p) m = min(m, cur[i - W + 1]);
      }
      if (y < H - 1) {
        if (x > 0 && ph[i + W - 1] == p) m = min(m, cur[i + W - 1]);
        if (x < W - 1 && ph[i + W + 1] == p) m = min(m, cur[i + W + 1]);
      }
      nxt[i] = m;
    }
    __syncthreads();

    // 2. rows: forward then reverse segmented min, one warp per row
    for (int r = warp; r < H; r += nwarps) {
      int32_t* row = nxt + (size_t)r * W;
      const int32_t* prow = ph + (size_t)r * W;
      int carry = kBig;
      for (int base = 0; base < W; base += 32) {
        const int x = base + lane;
        const int f = (x == 0) || (prow[x] != prow[x - 1]);
        const int v = warp_seg_min(row[x], f, lane, carry);
        row[x] = v;
        carry = __shfl_sync(kFull, v, 31);
      }
      __syncwarp();
      carry = kBig;
      for (int base = W - 32; base >= 0; base -= 32) {
        const int x = base + 31 - lane;  // lane order runs right to left
        const int f = (x == W - 1) || (prow[x] != prow[x + 1]);
        const int v = warp_seg_min(row[x], f, lane, carry);
        row[x] = v;
        carry = __shfl_sync(kFull, v, 31);
      }
      __syncwarp();
    }
    __syncthreads();

    // 3. columns: forward then reverse segmented min, one thread per column
    int local = 0;
    for (int cx = tid; cx < W; cx += blockDim.x) {
      int run = kBig;
      int prev = -1;
      for (int y = 0; y < H; ++y) {
        const size_t i = (size_t)y * W + cx;
        const int p = ph[i];
        const int v = nxt[i];
        run = (p != prev) ? v : min(run, v);
        nxt[i] = run;
        prev = p;
      }
      prev = -1;
      for (int y = H - 1; y >= 0; --y) {
        const size_t i = (size_t)y * W + cx;
        const int p = ph[i];
        const int v = nxt[i];
        run = (p != prev) ? v : min(run, v);
        nxt[i] = run;
        local |= (run != cur[i]);
        prev = p;
      }
    }
    changed = __syncthreads_or(local);
    int32_t* t = cur;
    cur = nxt;
    nxt = t;
    ++it;
  }
  if (cur != out) {
    for (int i = tid; i < HW; i += blockDim.x) out[i] = cur[i];
  }
  if (tid == 0) iters[blockIdx.x] = it;
}

}  // namespace

extern "C" {

const char* vbr_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}

int vbr_ccl_combined(const int32_t* phase, int32_t* labels, int32_t* scratch,
                     int32_t* iters, int B, int H, int W, int max_iters,
                     void* stream) {
  if (W % 32 != 0 || (long long)H * W >= (1LL << 31)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (B > 0) {
    ccl_combined_kernel<<<B, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        phase, labels, scratch, iters, H, W, max_iters);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
