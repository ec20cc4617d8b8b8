// Blocked visual-hull carve: per-voxel view count + colour gather.
//
// Replaces the Pallas kernel of vbr_tpu/ops/carve_pallas.py (_make_kernel,
// launched by _carve_blocked_device).  Same function, same blocked layout:
// voxels in (sub-block, voxel) order, 512 voxels per 8x8x8 sub-block, the
// packed per-(voxel, camera) geometry word pk = row<<10 | word<<3 | bit
// (row 1023 = projection outside the image), per-sub-block flags
// active (0 => no voxel can reach the view threshold) and full (1 => every
// voxel sees foreground in every camera, count = C without reads).
//
// Outputs are final: occ = active & count >= views_threshold (u8 0/1) and
// the colour-camera BGR pixel of each occupied voxel (u8, 0 elsewhere and
// where the colour camera's projection is invalid), so no int32 count or
// f32 colour plane is ever written.
//
// What bounds it on an H100: bytes.  Per voxel it reads C packed words
// (16 B at C=4), its colour column (4 B) and writes 4 B; at 128^3 that is
// ~42 MB of tables + 8 MB of outputs, ~15 us at 3.35 TB/s if every block
// were active.  The masks (C*H*W bytes, 1.25 MB) and the colour frame
// (0.9 MB) stay in L2 and are read by a direct byte gather.
//
// Design: one CTA per sub-block, one thread per voxel (512 threads), so
// table reads are fully coalesced (a warp reads 128 contiguous bytes of
// pk per camera).  The TPU kernel's one-hot bf16 MXU contraction and its
// 8-column bit-packed masks were workarounds for a machine without a
// gather; here the mask byte is read directly.  Inactive sub-blocks read
// nothing but their two flags and write zeros; full ones skip the mask
// reads.  Colours are gathered only for occupied voxels, which yields the
// same bytes as the TPU kernel's "gather when the block max reaches the
// threshold, mask by occupancy afterwards".
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBV = 512;

__global__ void __launch_bounds__(kBV) carve_blocked_kernel(
    const int32_t* __restrict__ pk,      // (nblk, C, BV)
    const int32_t* __restrict__ lcc,     // (nblk, BV) colour column, -1 invalid
    const int32_t* __restrict__ active,  // (nblk,)
    const int32_t* __restrict__ full,    // (nblk,)
    const uint8_t* __restrict__ masks,   // (C, H, W)
    const uint8_t* __restrict__ image,   // (H, W, 3) BGR colour-camera frame
    uint8_t* __restrict__ occ,           // (nblk, BV)
    uint8_t* __restrict__ col,           // (nblk, 3, BV)
    int C, int H, int W, int color_camera, int views_threshold) {
  const size_t b = blockIdx.x;
  const int v = threadIdx.x;
  const int act = active[b];
  const int is_full = full[b];
  int count = 0;
  if (is_full) {
    count = C;
  } else if (act) {
    for (int c = 0; c < C; ++c) {
      const int p = pk[(b * C + c) * kBV + v];
      const int row = p >> 10;
      if (row != 1023) {
        const int x = ((p >> 3) & 127) * 8 + (p & 7);
        count += masks[((size_t)c * H + row) * W + x] != 0;
      }
    }
  }
  const bool o = act && count >= views_threshold;
  uint8_t cb = 0, cg = 0, cr = 0;
  if (o) {
    const int row = pk[(b * C + color_camera) * kBV + v] >> 10;
    const int x = lcc[b * kBV + v];
    if (row != 1023 && x >= 0) {
      const uint8_t* px = image + ((size_t)row * W + x) * 3;
      cb = px[0];
      cg = px[1];
      cr = px[2];
    }
  }
  occ[b * kBV + v] = o ? 1 : 0;
  col[(b * 3 + 0) * kBV + v] = cb;
  col[(b * 3 + 1) * kBV + v] = cg;
  col[(b * 3 + 2) * kBV + v] = cr;
}

}  // namespace

extern "C" {

const char* vbr_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}

int vbr_carve_blocked(const int32_t* pk, const int32_t* lcc,
                      const int32_t* active, const int32_t* full,
                      const uint8_t* masks, const uint8_t* image,
                      uint8_t* occ, uint8_t* col, int nblk, int C, int H,
                      int W, int color_camera, int views_threshold,
                      void* stream) {
  if (nblk > 0) {
    carve_blocked_kernel<<<nblk, kBV, 0, static_cast<cudaStream_t>(stream)>>>(
        pk, lcc, active, full, masks, image, occ, col, C, H, W, color_camera,
        views_threshold);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
