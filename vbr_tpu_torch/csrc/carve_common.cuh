// What the two blocked carves share: K1 (carve_blocked.cu, one frame with
// colours) and K4 (carve_frames.cu, NF frames, occupancy only).
//
// Both read the same blocked tables: the packed per-(voxel, camera)
// geometry word pk = row<<10 | word<<3 | bit (row 1023 = projection outside
// the image) of 512-voxel sub-blocks, and per-sub-block flags active and
// full.  Both run as a persistent grid: as many CTAs as the card holds at
// once (SMs x CTAs per SM from the occupancy calculator, at most the number
// of sub-blocks), CTA i taking sub-blocks i, i + G, i + 2G, ..., which spreads
// the active sub-blocks (they cluster around the subject) over the CTAs.
// Their ring kernels (the rig's C = 4) bring the tables into shared memory
// with 16-byte cp.async; their direct kernels (any other C) read them from
// device memory.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace carve {

constexpr int kBV = 512;           // voxels per 8x8x8 sub-block
constexpr int kInvalidRow = 1023;  // pk row of a projection outside the image
constexpr int kRound = 128;        // flags a CTA reads into shared memory at once

__device__ __forceinline__ void cp_async16(int4* smem, const int4* gmem) {
  const uint32_t dst = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// until at most N of this thread's committed groups are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Byte offset of a packed word's pixel in its camera's (H, W) mask, and
// whether the projection is valid; an invalid one points at pixel 0, so
// the load needs no branch and its byte is ignored.
__device__ __forceinline__ int mask_offset(int p, int W, bool& valid) {
  const int row = p >> 10;
  valid = row != kInvalidRow;
  const int x = ((p >> 3) & 127) * 8 + (p & 7);
  return valid ? row * W + x : 0;
}

// 1 when the packed word's projection is valid and its mask byte is set
__device__ __forceinline__ int mask_hit(const uint8_t* __restrict__ masks_c,
                                        int p, int W) {
  bool valid;
  const uint8_t m = masks_c[mask_offset(p, W, valid)];
  return (valid && m != 0) ? 1 : 0;
}

// The persistent walk over nblk sub-blocks.  This CTA's sub-blocks are
// blockIdx.x + j * gridDim.x; it takes them in rounds of kRound.  A round
// reads the kinds of its sub-blocks into kind[] (0 inactive, 1 to be
// counted, 2 full: active and full), then calls round(n, block_of), where
// block_of(j) is the round's j-th sub-block.
template <typename Round>
__device__ __forceinline__ void walk_rounds(int nblk,
                                            const int32_t* __restrict__ active,
                                            const int32_t* __restrict__ full,
                                            uint8_t* kind, Round&& round) {
  const int G = gridDim.x;
  const int n_own = (nblk - (int)blockIdx.x + G - 1) / G;
  for (int base = 0; base < n_own; base += kRound) {
    const int n = min(kRound, n_own - base);
    auto block_of = [=](int j) {
      return (size_t)blockIdx.x + (size_t)(base + j) * G;
    };
    for (int j = threadIdx.x; j < n; j += blockDim.x) {
      const size_t b = block_of(j);
      kind[j] = active[b] > 0 ? (full[b] > 0 ? 2 : 1) : 0;
    }
    __syncthreads();
    round(n, block_of);
    __syncthreads();  // kind is rewritten in the next round
  }
}

struct Plan {
  int status;    // a cudaError_t
  int c_static;  // 1: the ring kernel, C compiled in; 0: the direct kernel
  int smem;      // dynamic shared memory per CTA, bytes
  int per_sm;    // CTAs an SM holds
  int blocks;    // CTAs launched
};

// The persistent grid of `kernel` launched with `threads` threads and
// `smem` bytes of dynamic shared memory per CTA over `nblk` sub-blocks.
template <typename Kernel>
Plan persistent_plan(Kernel kernel, bool c_static, int threads, int smem,
                     int nblk) {
  Plan p = {};
  p.c_static = c_static;
  p.smem = smem;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
  }
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&p.per_sm, kernel,
                                                        threads, p.smem);
  }
  if (err == cudaSuccess && p.per_sm < 1) err = cudaErrorInvalidValue;
  p.status = static_cast<int>(err);
  if (err == cudaSuccess) {
    const long long resident = (long long)sms * p.per_sm;
    p.blocks = (int)(nblk < resident ? nblk : resident);
  }
  return p;
}

inline Plan invalid_plan() {
  Plan p = {};
  p.status = static_cast<int>(cudaErrorInvalidValue);
  return p;
}

}  // namespace carve
