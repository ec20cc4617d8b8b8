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
// Two routes, chosen by shape alone in the launcher (ccl::ccl_route), as
// for ccl_combined.cu and written with it in ccl_common.cuh over the Rule
// below: the cluster route (one thread-block cluster per image, labels in
// the cluster's shared memory, device memory touched twice) for every shape
// whose band of rows fits the shared memory of a block at a cluster of at
// most 8, and the general route for larger images (one CTA of 1024 threads
// per image, labels in device memory, two buffers).  Both write each
// image's iteration count beside the labels.  The least the card must do
// is read the image (1 byte per pixel) and write the labels (4 bytes per
// pixel).
#include <cuda_runtime.h>
#include <stdint.h>

#include "ccl_common.cuh"

namespace {

// All 8 neighbours; a segment is a run of foreground, and the background
// holds 2^30, the identity of min.
struct LabelRule {
  static constexpr bool kOrthogonal = true;
  __device__ static int init(unsigned p, int idx) {
    return p ? idx : ccl::kBig;
  }
  __device__ static bool same(unsigned a, unsigned b) { return a & b; }
  __device__ static unsigned same_mask(unsigned w, unsigned v) {
    return w & v;
  }
};

}  // namespace

extern "C" {

const char* vbr_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}

int vbr_ccl_label_route(int H, int W, int* cluster, int* smem_bytes,
                        int* active) {
  return ccl::route<LabelRule>(H, W, cluster, smem_bytes, active);
}

int vbr_ccl_label(const uint8_t* fg, int32_t* labels, int32_t* scratch,
                  int32_t* iters, int B, int H, int W, int max_iters,
                  void* stream) {
  return ccl::label<LabelRule>(fg, labels, scratch, iters, B, H, W,
                               max_iters, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
