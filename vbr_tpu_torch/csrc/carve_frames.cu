// Multi-frame blocked visual-hull carve: occupancy of NF frames per launch.
//
// Replaces the Pallas kernel of vbr_tpu/ops/carve_pallas.py
// (_make_counts_kernel, launched by _carve_frames_device).  Same function
// on the same blocked tables as carve_blocked.cu: the packed per-(voxel,
// camera) geometry word pk = row<<10 | word<<3 | bit (row 1023 = projection
// outside the image), a per-sub-block flag active (0 => no voxel reaches the
// view threshold in any frame of the chunk; computed on the frames' mask
// union) and full (1 => every voxel sees foreground in every camera in every
// frame; computed on the intersection).  No colours: the offline path
// gathers them on the host at occupied voxels.
//
// Output is the final occupancy, occ = active & count >= views_threshold
// (u8 0/1), frame-major: (NF, nblk, 512), so each frame's plane is the
// blocked layout that the single-frame carve emits and a warp's stores are
// contiguous.  The TPU kernel's int32 count plane (nsuper, nsub, 512, NF) is
// never written.
//
// What bounds it on an H100: bytes.  Per voxel of a computed block it reads
// C packed words (16 B at C = 4) once for the whole chunk and writes NF
// bytes; the masks (NF*C*H*W bytes, 10 MB at NF = 8) stay in L2 and are
// read by a direct byte gather.  Sharing the table read across the chunk's
// frames is what the TPU kernel's frame-widened matmul bought; its
// frame-packed bf16 mask layout and block-diagonal reduction were TPU
// layout and have no counterpart here.
//
// Design: one CTA per sub-block, one thread per voxel.  A thread decodes
// its voxel's word once per camera and tests that pixel in up to kGroup
// frames, whose counters are registers (the group loop is unrolled; a chunk
// longer than kGroup frames re-reads the words from L1/L2).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBV = 512;
constexpr int kGroup = 8;

__global__ void __launch_bounds__(kBV) carve_frames_kernel(
    const int32_t* __restrict__ pk,      // (nblk, C, BV)
    const int32_t* __restrict__ active,  // (nblk,)
    const int32_t* __restrict__ full,    // (nblk,)
    const uint8_t* __restrict__ masks,   // (NF, C, H, W)
    uint8_t* __restrict__ occ,           // (NF, nblk, BV)
    int nblk, int NF, int C, int H, int W, int views_threshold) {
  const size_t b = blockIdx.x;
  const int v = threadIdx.x;
  const size_t plane = (size_t)nblk * kBV;  // one frame of occ
  const size_t frame = (size_t)C * H * W;   // one frame of masks
  uint8_t* out = occ + b * kBV + v;
  if (!active[b] || full[b]) {
    const uint8_t o = (active[b] && C >= views_threshold) ? 1 : 0;
    for (int f = 0; f < NF; ++f) out[f * plane] = o;
    return;
  }
  for (int f0 = 0; f0 < NF; f0 += kGroup) {
    int count[kGroup];
#pragma unroll
    for (int i = 0; i < kGroup; ++i) count[i] = 0;
    for (int c = 0; c < C; ++c) {
      const int p = pk[(b * C + c) * kBV + v];
      const int row = p >> 10;
      if (row != 1023) {
        const int x = ((p >> 3) & 127) * 8 + (p & 7);
        const uint8_t* m = masks + f0 * frame + ((size_t)c * H + row) * W + x;
#pragma unroll
        for (int i = 0; i < kGroup; ++i) {
          if (f0 + i < NF) count[i] += m[i * frame] != 0;
        }
      }
    }
#pragma unroll
    for (int i = 0; i < kGroup; ++i) {
      if (f0 + i < NF) {
        out[(f0 + i) * plane] = count[i] >= views_threshold ? 1 : 0;
      }
    }
  }
}

}  // namespace

extern "C" {

const char* vbr_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}

int vbr_carve_frames(const int32_t* pk, const int32_t* active,
                     const int32_t* full, const uint8_t* masks, uint8_t* occ,
                     int nblk, int NF, int C, int H, int W,
                     int views_threshold, void* stream) {
  if (nblk > 0 && NF > 0) {
    carve_frames_kernel<<<nblk, kBV, 0, static_cast<cudaStream_t>(stream)>>>(
        pk, active, full, masks, occ, nblk, NF, C, H, W, views_threshold);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
