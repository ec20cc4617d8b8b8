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
// (0.9 MB) stay in L2 and are read by a direct byte gather.  A production
// frame has one sub-block in seven active: the outputs are the largest
// stream, and what an active block costs is memory latency.
//
// Design (the TPU kernel's one-hot bf16 MXU contraction and its 8-column
// bit-packed masks were workarounds for a machine without a gather; here
// the mask byte is read directly):
//
//  * Persistent CTAs.  The grid is what the card holds at once (SMs x CTAs
//    per SM from the occupancy calculator, at most nblk) and does not grow
//    with the grid of voxels; CTA i takes sub-blocks i, i + G, i + 2G, ...,
//    which spreads the active ones (they cluster around the subject).
//  * Four voxels per thread, 128 threads per sub-block: pk is one int4 per
//    camera and thread (a warp reads 512 contiguous bytes), lcc one int4,
//    occ and each colour plane one 32-bit store (byte e = voxel 4v + e); an
//    inactive sub-block is one 16-byte store of zeros from each thread.
//  * Every load in flight at once.  A CTA reads its flags in one go, then
//    starts the copies of its first active sub-blocks' tables into a ring
//    of kStages stages of shared memory (16-byte cp.async: each thread
//    copies exactly the words it will use itself, so the ring needs no
//    block barrier and no mbarrier), zero-fills its inactive sub-blocks
//    while those copies fly, and then consumes stage after stage, starting
//    the next copy as a stage frees.  A full sub-block copies the colour
//    camera's words only.
//  * The rig's C = 4 is compiled in, so all 4 x C mask bytes of a thread
//    are independent loads after one wait.  The colour camera's words come
//    from the stage that the count read: no second read from device memory.
//  * Any other camera count takes carve_blocked_direct_kernel: the same
//    walk and outputs, each thread reading its int4 of pk per camera
//    straight from device memory, so no shared memory grows with C and no
//    count is refused.  At 55 and 56 cameras it ran in half the time of a
//    run-time-C ring of the same tables (PERF.md); no rig of another
//    count exists here to tune a ring for.  The launcher picks by C alone.
//  * Colours are gathered only for occupied voxels, which yields the same
//    bytes as the TPU kernel's "gather when the block max reaches the
//    threshold, mask by occupancy afterwards".
//
// The copy helpers, the mask gather, the persistent walk and its launch
// plan are shared with K4 (carve_common.cuh).
#include "carve_common.cuh"

namespace {

using namespace carve;

constexpr int kThreads = kBV / 4;  // four voxels per thread
constexpr int kStages = 2;         // table copies in flight per CTA
constexpr int kStaticC = 4;        // the rig's camera count

// An inactive sub-block b: 512 B of occ and 1536 B of col, all zero, one
// 16-byte store per thread.
__device__ __forceinline__ void zero_block(uint8_t* occ, uint8_t* col,
                                           size_t b, int tid) {
  int4* dst = tid < kThreads / 4
                  ? reinterpret_cast<int4*>(occ + b * kBV) + tid
                  : reinterpret_cast<int4*>(col + b * 3 * kBV) +
                        (tid - kThreads / 4);
  *dst = make_int4(0, 0, 0, 0);
}

// Thread tid's four voxels of sub-block b from their counts, the colour
// camera's packed words pc4 and colour columns lc4: occupancy and, at
// occupied voxels with a valid projection, the BGR pixel; one 32-bit store
// per output plane (byte e = voxel 4 * tid + e).
__device__ __forceinline__ void store_block(
    const int (&cnt)[4], int4 pc4, int4 lc4, const uint8_t* __restrict__ image,
    int W, int views_threshold, uint8_t* occ, uint8_t* col, size_t b,
    int tid) {
  const int pc[4] = {pc4.x, pc4.y, pc4.z, pc4.w};
  const int lc[4] = {lc4.x, lc4.y, lc4.z, lc4.w};
  uint32_t ow = 0, cb = 0, cg = 0, cr = 0;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const bool o = cnt[e] >= views_threshold;
    const int row = pc[e] >> 10;
    if (o && row != kInvalidRow && lc[e] >= 0) {
      const uint8_t* px = image + ((size_t)row * W + lc[e]) * 3;
      cb |= (uint32_t)px[0] << (8 * e);
      cg |= (uint32_t)px[1] << (8 * e);
      cr |= (uint32_t)px[2] << (8 * e);
    }
    ow |= (o ? 1u : 0u) << (8 * e);
  }
  reinterpret_cast<uint32_t*>(occ + b * kBV)[tid] = ow;
  uint32_t* cw = reinterpret_cast<uint32_t*>(col + b * 3 * kBV) + tid;
  cw[0] = cb;
  cw[kThreads] = cg;
  cw[2 * kThreads] = cr;
}

// The rig's camera count, compiled in.
__global__ void __launch_bounds__(kThreads) carve_blocked_kernel(
    const int32_t* __restrict__ pk,      // (nblk, C, BV)
    const int32_t* __restrict__ lcc,     // (nblk, BV) colour column, -1 invalid
    const int32_t* __restrict__ active,  // (nblk,)
    const int32_t* __restrict__ full,    // (nblk,)
    const uint8_t* __restrict__ masks,   // (C, H, W)
    const uint8_t* __restrict__ image,   // (H, W, 3) BGR colour-camera frame
    uint8_t* __restrict__ occ,           // (nblk, BV)
    uint8_t* __restrict__ col,           // (nblk, 3, BV)
    int nblk, int H, int W, int color_camera, int views_threshold) {
  extern __shared__ int4 ring[];          // [kStages][C + 1][kThreads]
  __shared__ uint8_t s_kind[kRound];      // 0 inactive, 1 count, 2 full
  constexpr int C = kStaticC;
  const int tid = threadIdx.x;
  const int stage_stride = (C + 1) * kThreads;
  int4* const mine = ring + tid;
  const size_t plane = (size_t)H * W;

  walk_rounds(nblk, active, full, s_kind, [&](int n, auto block_of) {
    // the next active sub-block of this round, or -1
    int next = 0;
    auto next_active = [&]() {
      while (next < n && s_kind[next] == 0) ++next;
      return next < n ? next++ : -1;
    };
    // start the copy of sub-block j's tables into a stage; every call is
    // one cp.async group, an empty one for j < 0, so that the group that
    // a wait has to leave pending is always the same number
    auto start_copy = [&](int j, int stage) {
      if (j >= 0) {
        const size_t b = block_of(j);
        int4* dst = mine + stage * stage_stride;
        const int4* src = reinterpret_cast<const int4*>(pk + b * C * kBV) + tid;
        if (s_kind[j] == 1) {
#pragma unroll
          for (int c = 0; c < C; ++c) {
            cp_async16(dst + c * kThreads, src + c * kThreads);
          }
        } else {
          cp_async16(dst + color_camera * kThreads,
                     src + color_camera * kThreads);
        }
        cp_async16(dst + C * kThreads,
                   reinterpret_cast<const int4*>(lcc + b * kBV) + tid);
      }
      cp_async_commit();
    };

#pragma unroll
    for (int st = 0; st < kStages; ++st) start_copy(next_active(), st);

    // inactive sub-blocks: 512 B of occ and 1536 B of col, all zero
    for (int j = 0; j < n; ++j) {
      if (s_kind[j] != 0) continue;
      zero_block(occ, col, block_of(j), tid);
    }

    int stage = 0;
    for (int j = 0; j < n; ++j) {
      const int kind = s_kind[j];
      if (kind == 0) continue;
      cp_async_wait<kStages - 1>();
      const int4* src = mine + stage * stage_stride;
      int cnt[4] = {C, C, C, C};
      if (kind == 1) {
        cnt[0] = cnt[1] = cnt[2] = cnt[3] = 0;
        int4 p[C];
#pragma unroll
        for (int c = 0; c < C; ++c) p[c] = src[c * kThreads];
#pragma unroll
        for (int c = 0; c < C; ++c) {
          const uint8_t* mc = masks + c * plane;
          cnt[0] += mask_hit(mc, p[c].x, W);
          cnt[1] += mask_hit(mc, p[c].y, W);
          cnt[2] += mask_hit(mc, p[c].z, W);
          cnt[3] += mask_hit(mc, p[c].w, W);
        }
      }
      store_block(cnt, src[color_camera * kThreads], src[C * kThreads], image,
                  W, views_threshold, occ, col, block_of(j), tid);
      // this thread has read its words of the stage: it may be refilled
      start_copy(next_active(), stage);
      stage = stage + 1 == kStages ? 0 : stage + 1;
    }
  });
}

// Any other C: carve_blocked_kernel's walk, counts and outputs, with pk and
// lcc read from device memory where that kernel reads its stage (no shared
// memory beyond the round's kinds).
__global__ void __launch_bounds__(kThreads) carve_blocked_direct_kernel(
    const int32_t* __restrict__ pk,      // (nblk, C, BV)
    const int32_t* __restrict__ lcc,     // (nblk, BV) colour column, -1 invalid
    const int32_t* __restrict__ active,  // (nblk,)
    const int32_t* __restrict__ full,    // (nblk,)
    const uint8_t* __restrict__ masks,   // (C, H, W)
    const uint8_t* __restrict__ image,   // (H, W, 3) BGR colour-camera frame
    uint8_t* __restrict__ occ,           // (nblk, BV)
    uint8_t* __restrict__ col,           // (nblk, 3, BV)
    int nblk, int C, int H, int W, int color_camera, int views_threshold) {
  __shared__ uint8_t s_kind[kRound];  // 0 inactive, 1 count, 2 full
  const int tid = threadIdx.x;
  const size_t plane = (size_t)H * W;

  walk_rounds(nblk, active, full, s_kind, [&](int n, auto block_of) {
    for (int j = 0; j < n; ++j) {
      const int kind = s_kind[j];
      const size_t b = block_of(j);
      if (kind == 0) {
        zero_block(occ, col, b, tid);
        continue;
      }
      const int4* src = reinterpret_cast<const int4*>(pk + b * C * kBV) + tid;
      int cnt[4] = {C, C, C, C};
      if (kind == 1) {
        cnt[0] = cnt[1] = cnt[2] = cnt[3] = 0;
        for (int c = 0; c < C; ++c) {
          const int4 p = src[c * kThreads];
          const uint8_t* mc = masks + c * plane;
          cnt[0] += mask_hit(mc, p.x, W);
          cnt[1] += mask_hit(mc, p.y, W);
          cnt[2] += mask_hit(mc, p.z, W);
          cnt[3] += mask_hit(mc, p.w, W);
        }
      }
      store_block(cnt, src[color_camera * kThreads],
                  reinterpret_cast<const int4*>(lcc + b * kBV)[tid], image, W,
                  views_threshold, occ, col, b, tid);
    }
  });
}

// Returns at once: its time between two events is what any launch costs.
__global__ void empty_kernel() {}

// C = kStaticC through the ring, another C straight from device memory.
Plan plan_launch(int nblk, int C, int H, int W, int color_camera) {
  if (nblk < 0 || C < 1 || H < 1 || W < 1 || color_camera < 0 ||
      color_camera >= C) {
    return invalid_plan();
  }
  return C == kStaticC
             ? persistent_plan(carve_blocked_kernel, true, kThreads,
                               kStages * (C + 1) * kThreads * (int)sizeof(int4),
                               nblk)
             : persistent_plan(carve_blocked_direct_kernel, false, kThreads, 0,
                               nblk);
}

}  // namespace

extern "C" {

const char* vbr_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}

int vbr_empty_launch(void* stream) {
  empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}

// out[0..3] = C fixed at compile time (0/1: the ring kernel or the direct
// one), shared bytes per CTA, CTAs per SM, CTAs launched: what
// vbr_carve_blocked would launch for this shape.
int vbr_carve_blocked_plan(int nblk, int C, int* out) {
  const Plan p = plan_launch(nblk, C, 1, 1, 0);
  out[0] = p.c_static;
  out[1] = p.smem;
  out[2] = p.per_sm;
  out[3] = p.blocks;
  return p.status;
}

int vbr_carve_blocked(const int32_t* pk, const int32_t* lcc,
                      const int32_t* active, const int32_t* full,
                      const uint8_t* masks, const uint8_t* image,
                      uint8_t* occ, uint8_t* col, int nblk, int C, int H,
                      int W, int color_camera, int views_threshold,
                      void* stream) {
  const Plan p = plan_launch(nblk, C, H, W, color_camera);
  if (p.status != 0) return p.status;
  if (nblk > 0 && p.c_static) {
    carve_blocked_kernel<<<p.blocks, kThreads, p.smem,
                           static_cast<cudaStream_t>(stream)>>>(
        pk, lcc, active, full, masks, image, occ, col, nblk, H, W,
        color_camera, views_threshold);
  } else if (nblk > 0) {
    carve_blocked_direct_kernel<<<p.blocks, kThreads, 0,
                                  static_cast<cudaStream_t>(stream)>>>(
        pk, lcc, active, full, masks, image, occ, col, nblk, C, H, W,
        color_camera, views_threshold);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
