// Single-phase 8-connected component labelling of binary images.
//
// Replaces the Pallas kernel of vbr_tpu/ops/ccl_pallas.py
// (_make_label_kernel, launched by label_components_batched).  Every
// foreground pixel gets the minimum padded linear index of its 8-connected
// foreground component; background pixels get 2^30.  It is computed by the
// same fixpoint with the same cap: labels start at the linear index on the
// foreground, and each iteration
//   1. takes the min over the pixel and its 8 neighbours of the
//      iteration-start labels (background stays 2^30),
//   2. runs a segmented min-scan along every row, forward then reverse,
//   3. runs a segmented min-scan along every column, forward then reverse,
// where a segment is a run of foreground pixels.  The loop stops after an
// iteration that changes nothing, or after max_iters iterations, so labels
// after k iterations equal the TPU kernel's, including at the cap.  This
// iteration is not the combined-phase kernel's (ccl_combined.cu takes only
// the diagonal neighbours and segments on phase changes): the two may
// differ at the cap, so neither is derived from the other.  A sequential
// segmented min equals the TPU kernel's Hillis-Steele scan with reset =
// 1 - fg exactly: min is exact and associative, and a background pixel
// holds 2^30, the identity of min over labels.
//
// What bounds it on an H100: latency and L2 bandwidth of one SM per image,
// as for ccl_combined.cu: the problem needs the image read and the labels
// written once, but every iteration streams the label image a few times
// and the passes depend on each other across the whole image.
//
// Design: as ccl_combined.cu.  One CTA of 1024 threads per image, labels
// in device memory (two buffers).  The neighbour pass is one thread per
// pixel; row scans give each warp whole rows, 32 columns at a time, with a
// warp-shuffle segmented scan and a carry; column scans give each thread
// one column.  A __syncthreads_or carries the "changed" flag, and each
// image's iteration count is written out beside the labels.
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

__global__ void __launch_bounds__(kThreads) ccl_label_kernel(
    const int32_t* __restrict__ fg_all,  // (B, H, W) 0/1
    int32_t* labels,                     // (B, H, W) result
    int32_t* scratch,                    // (B, H, W) second buffer
    int32_t* iters,                      // (B,) iterations run
    int H, int W, int max_iters) {
  const int HW = H * W;  // < 2^30, checked by the launcher
  const int32_t* fg = fg_all + (size_t)blockIdx.x * HW;
  int32_t* const out = labels + (size_t)blockIdx.x * HW;
  int32_t* cur = out;
  int32_t* nxt = scratch + (size_t)blockIdx.x * HW;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;

  for (int i = tid; i < HW; i += blockDim.x) cur[i] = fg[i] ? i : kBig;
  __syncthreads();

  int it = 0;
  int changed = 1;
  while (changed && it < max_iters) {
    // 1. min over the 8 neighbours of the iteration-start labels
    for (int i = tid; i < HW; i += blockDim.x) {
      int m = kBig;
      if (fg[i]) {
        const int y = i / W;
        const int x = i - y * W;
        const int xl = x > 0, xr = x < W - 1;
        m = cur[i];
        if (xl) m = min(m, cur[i - 1]);
        if (xr) m = min(m, cur[i + 1]);
        if (y > 0) {
          m = min(m, cur[i - W]);
          if (xl) m = min(m, cur[i - W - 1]);
          if (xr) m = min(m, cur[i - W + 1]);
        }
        if (y < H - 1) {
          m = min(m, cur[i + W]);
          if (xl) m = min(m, cur[i + W - 1]);
          if (xr) m = min(m, cur[i + W + 1]);
        }
      }
      nxt[i] = m;
    }
    __syncthreads();

    // 2. rows: forward then reverse segmented min, one warp per row; a
    // background pixel starts a segment of its own and holds 2^30
    for (int r = warp; r < H; r += nwarps) {
      int32_t* row = nxt + (size_t)r * W;
      const int32_t* frow = fg + (size_t)r * W;
      int carry = kBig;
      for (int base = 0; base < W; base += 32) {
        const int x = base + lane;
        const int v = warp_seg_min(row[x], !frow[x], lane, carry);
        row[x] = v;
        carry = __shfl_sync(kFull, v, 31);
      }
      __syncwarp();
      carry = kBig;
      for (int base = W - 32; base >= 0; base -= 32) {
        const int x = base + 31 - lane;  // lane order runs right to left
        const int v = warp_seg_min(row[x], !frow[x], lane, carry);
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
      for (int y = 0; y < H; ++y) {
        const size_t i = (size_t)y * W + cx;
        run = fg[i] ? min(run, nxt[i]) : kBig;
        nxt[i] = run;
      }
      run = kBig;
      for (int y = H - 1; y >= 0; --y) {
        const size_t i = (size_t)y * W + cx;
        run = fg[i] ? min(run, nxt[i]) : kBig;
        nxt[i] = run;
        local |= (run != cur[i]);
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

int vbr_ccl_label(const int32_t* fg, int32_t* labels, int32_t* scratch,
                  int32_t* iters, int B, int H, int W, int max_iters,
                  void* stream) {
  if (W % 32 != 0 || (long long)H * W >= (1LL << 30)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (B > 0) {
    ccl_label_kernel<<<B, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        fg, labels, scratch, iters, H, W, max_iters);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
