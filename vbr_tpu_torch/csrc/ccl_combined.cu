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
// Two routes, chosen by shape alone in the launcher (ccl::ccl_route), both
// written in ccl_common.cuh over the Rule below:
//
//   * the cluster route: one thread-block cluster per image, the labels in
//     the cluster's shared memory, the phase as bits; device memory is
//     touched twice (phase in, labels and iterations out).  Every shape
//     whose band of rows fits the shared memory of a block at a cluster of
//     at most 8 takes it: the production 488x768 does, at 8.
//   * the general route for images too large for that: one CTA of 1024
//     threads per image, labels in device memory (two buffers).
//
// Both run the same iteration and write each image's iteration count
// beside the labels.  The least the card must do is read the phase (1 byte
// per pixel) and write the labels (4 bytes per pixel).
#include <cuda_runtime.h>
#include <stdint.h>

#include "ccl_common.cuh"

namespace {

// Diagonal neighbours of equal phase; a segment is a run of equal phase.
struct CombinedRule {
  static constexpr bool kOrthogonal = false;
  __device__ static int init(unsigned, int idx) { return idx; }
  __device__ static bool same(unsigned a, unsigned b) { return a == b; }
  __device__ static unsigned same_mask(unsigned w, unsigned v) {
    return ~(w ^ v);
  }
};

}  // namespace

extern "C" {

const char* vbr_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}

int vbr_ccl_combined_route(int H, int W, int* cluster, int* smem_bytes,
                           int* active) {
  return ccl::route<CombinedRule>(H, W, cluster, smem_bytes, active);
}

int vbr_ccl_combined(const uint8_t* phase, int32_t* labels, int32_t* scratch,
                     int32_t* iters, int B, int H, int W, int max_iters,
                     void* stream) {
  return ccl::label<CombinedRule>(phase, labels, scratch, iters, B, H, W,
                                  max_iters,
                                  static_cast<cudaStream_t>(stream));
}

}  // extern "C"
