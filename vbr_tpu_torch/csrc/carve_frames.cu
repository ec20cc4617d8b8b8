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
// blocked layout that the single-frame carve emits.  A full sub-block
// counts C without a read; an inactive one (full or not) is 0.  The TPU
// kernel's int32 count plane (nsuper, nsub, 512, NF) is never written.
//
// What bounds it on an H100: bytes.  At 128^3, NF = 8 and one sub-block in
// six active on the chunk's union, the occupancy (NF x 2 MB) is the largest
// stream, then the tables of the counted sub-blocks (16 B per voxel at
// C = 4, read once for the whole chunk); the masks (NF*C*H*W bytes, 10 MB)
// are read by a direct byte gather at the counted voxels' pixels.  Sharing
// the table read across the chunk's frames is what the TPU kernel's
// frame-widened matmul bought; its frame-packed bf16 mask layout and
// block-diagonal reduction were TPU layout and have no counterpart here.
//
// Design (K1's, carried over to NF frames; carve_common.cuh holds what the
// two share):
//
//  * Persistent CTAs: SMs x CTAs per SM from the occupancy calculator, at
//    most the number of sub-blocks; CTA i takes sub-blocks i, i + G, ...
//    and reads their flags kRound at a time into shared memory.
//  * Four voxels per thread, 128 threads per sub-block: pk is one int4 per
//    camera and thread, and for one frame the four voxels' counts are one
//    32-bit word, a byte per voxel (a count is at most C = 4, so bytes
//    never carry).  The threshold test is per
//    byte (__vcmpgeu4), and a frame's occupancy is one 32-bit store at
//    occ + (f * nblk + b) * 512 + 4 * tid (a warp writes 128 contiguous
//    bytes).  The counters of kGroup frames live in registers; a chunk of
//    more frames runs the groups one after the other on the same stage.
//  * pk of the counted sub-blocks goes through a kStages-deep ring of
//    16-byte cp.async in shared memory; each thread copies exactly the
//    words it will read itself, so the ring needs no block barrier and no
//    mbarrier, and every step commits one group (an empty one when nothing
//    is left) so the wait's constant holds.  A stage is refilled only after
//    every frame group has run on it: pk is read from device memory once
//    per chunk.
//  * After one wait, a thread's 4 voxels x C cameras x kGroup frames mask
//    bytes are independent loads: the invalid row is a select, not a
//    branch, and a group that runs past the chunk's last frame reads that
//    frame again instead of guarding its loads.
//  * Inactive and full sub-blocks are NF x 512 bytes of 0 or of 0x01, as
//    16-byte stores (32 per frame plane, spread over the CTA), issued while
//    the first stages' copies fly.
//  * C = 4 is compiled in, and with it NF = 8, the offline path's chunk;
//    another chunk takes the same kernel with NF at run time (in groups of
//    kGroup frames).
//  * Registers for kMinCtas = 8 CTAs per SM (64 a thread).  How many of a
//    thread's 128 gathers ptxas issues before it uses one follows the
//    budget, and not monotonically: 32 at 64 registers, 5 at 80, where it
//    interleaves them with their uses and the latencies add up (1.5x the
//    time).  So the budget is fixed here, not left to ptxas.
//
// Any other camera count, and a chunk whose kGroup x C x H x W does not fit
// an int (a frame group's masks are addressed with int offsets from a
// 64-bit base), takes carve_frames_direct_kernel: the same walk and
// stores, pk read per camera straight from device memory (once per frame,
// from L1 or L2 after the first), each voxel's count a 32-bit integer and
// masks addressed with 64-bit offsets, so no camera count and no chunk is
// refused.  At 56 and 57 cameras it ran in half the time of a run-time-C
// ring of the same tables (PERF.md).  The launcher picks by C and NF.
#include <limits.h>

#include "carve_common.cuh"

namespace {

using namespace carve;

constexpr int kStages = 2;     // table copies in flight per CTA
constexpr int kThreads = kBV / 4;  // four voxels per thread
constexpr int kGroup = 8;      // frames whose counters are registers
constexpr int kMinCtas = 8;    // CTAs per SM that ptxas leaves registers for
constexpr int kStaticC = 4;    // the rig's camera count
constexpr int kStaticNF = 8;   // the offline path's chunk
constexpr uint32_t kOnes = 0x01010101u;

// The rig's camera count, compiled in; NS > 0: the number of frames,
// likewise, 0: NF at run time.
template <int NS>
__global__ void __launch_bounds__(kThreads, kMinCtas) carve_frames_kernel(
    const int32_t* __restrict__ pk,      // (nblk, C, BV)
    const int32_t* __restrict__ active,  // (nblk,)
    const int32_t* __restrict__ full,    // (nblk,)
    const uint8_t* __restrict__ masks,   // (NF, C, H, W)
    uint8_t* __restrict__ occ,           // (NF, nblk, BV)
    int nblk, int NF_rt, int H, int W,
    uint32_t thr4,    // the view threshold, clamped to [0, C + 1], per byte
    uint32_t full4) {  // a full sub-block's occupancy word
  extern __shared__ int4 ring[];       // [kStages][C][kThreads]
  __shared__ uint8_t s_kind[kRound];   // 0 inactive, 1 count, 2 full
  constexpr int C = kStaticC;
  const int NF = NS > 0 ? NS : NF_rt;
  const int tid = threadIdx.x;
  const int stage_stride = C * kThreads;
  int4* const mine = ring + tid;
  const int cam = H * W;                // one camera's mask
  const int frame = C * cam;            // one frame of masks
  const size_t plane = (size_t)nblk * kBV;  // one frame of occ

  walk_rounds(nblk, active, full, s_kind, [&](int n, auto block_of) {
    // the next sub-block of this round to be counted, or -1
    int next = 0;
    auto next_count = [&]() {
      while (next < n && s_kind[next] != 1) ++next;
      return next < n ? next++ : -1;
    };
    // start the copy of sub-block j's tables into a stage; every call is
    // one cp.async group, an empty one for j < 0
    auto start_copy = [&](int j, int stage) {
      if (j >= 0) {
        const int4* src = reinterpret_cast<const int4*>(
            pk + block_of(j) * C * kBV) + tid;
        int4* dst = mine + stage * stage_stride;
#pragma unroll
        for (int c = 0; c < C; ++c) {
          cp_async16(dst + c * kThreads, src + c * kThreads);
        }
      }
      cp_async_commit();
    };

#pragma unroll
    for (int st = 0; st < kStages; ++st) start_copy(next_count(), st);

    // inactive and full sub-blocks, while the copies fly: NF planes of
    // kBV bytes, 16 at a time
    constexpr int kQuads = kBV / 16;  // 16-byte stores per frame plane
    for (int j = 0; j < n; ++j) {
      const int kind = s_kind[j];
      if (kind == 1) continue;
      const uint32_t v = kind == 2 ? full4 : 0u;
      uint8_t* base = occ + block_of(j) * kBV;
      for (int i = tid; i < NF * kQuads; i += kThreads) {
        reinterpret_cast<uint4*>(base + (size_t)(i / kQuads) * plane)
            [i % kQuads] = make_uint4(v, v, v, v);
      }
    }

    int stage = 0;
    for (int j = 0; j < n; ++j) {
      if (s_kind[j] != 1) continue;
      cp_async_wait<kStages - 1>();
      const int4* src = mine + stage * stage_stride;
      uint32_t* out = reinterpret_cast<uint32_t*>(occ + block_of(j) * kBV)
                      + tid;
      for (int f0 = 0; f0 < NF; f0 += kGroup) {
        // the group's frames, as int offsets from its first; past the
        // chunk's end the last frame is read again and its counts are not
        // stored, so that no load is guarded (a guarded load and its use
        // would wait for each other in turn)
        const uint8_t* group = masks + (size_t)f0 * frame;
        int fo[kGroup];
#pragma unroll
        for (int i = 0; i < kGroup; ++i) {
          fo[i] = (min(f0 + i, NF - 1) - f0) * frame;
        }
        // byte e of cnt[i] = the count of voxel 4 * tid + e in frame f0 + i
        uint32_t cnt[kGroup] = {};
        auto count_camera = [&](int c) {
          const int4 p4 = src[c * kThreads];
          const int p[4] = {p4.x, p4.y, p4.z, p4.w};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            bool valid;
            const uint8_t* px = group + c * cam + mask_offset(p[e], W, valid);
#pragma unroll
            for (int i = 0; i < kGroup; ++i) {
              const uint8_t m = px[fo[i]];  // loaded whether valid or not
              cnt[i] += (valid && m != 0 ? 1u : 0u) << (8 * e);
            }
          }
        };
#pragma unroll
        for (int c = 0; c < C; ++c) count_camera(c);
#pragma unroll
        for (int i = 0; i < kGroup; ++i) {
          if (f0 + i < NF) {
            out[(f0 + i) * (plane / 4)] = __vcmpgeu4(cnt[i], thr4) & kOnes;
          }
        }
      }
      // every frame group has read this stage: it may be refilled
      start_copy(next_count(), stage);
      stage = stage + 1 == kStages ? 0 : stage + 1;
    }
  });
}

// Any other C and any chunk: carve_frames_kernel's walk and stores, each
// voxel's count an int, pk read where that kernel reads its stage.
__global__ void __launch_bounds__(kThreads) carve_frames_direct_kernel(
    const int32_t* __restrict__ pk,      // (nblk, C, BV)
    const int32_t* __restrict__ active,  // (nblk,)
    const int32_t* __restrict__ full,    // (nblk,)
    const uint8_t* __restrict__ masks,   // (NF, C, H, W)
    uint8_t* __restrict__ occ,           // (NF, nblk, BV)
    int nblk, int NF, int C, int H, int W, int views_threshold,
    uint32_t full4) {  // a full sub-block's occupancy word
  __shared__ uint8_t s_kind[kRound];  // 0 inactive, 1 count, 2 full
  const int tid = threadIdx.x;
  const size_t cam = (size_t)H * W;         // one camera's mask
  const size_t frame = (size_t)C * cam;     // one frame of masks
  const size_t words = (size_t)nblk * kBV / 4;  // one frame of occ, words

  walk_rounds(nblk, active, full, s_kind, [&](int n, auto block_of) {
    for (int j = 0; j < n; ++j) {
      const int kind = s_kind[j];
      const size_t b = block_of(j);
      uint32_t* out = reinterpret_cast<uint32_t*>(occ + b * kBV) + tid;
      if (kind != 1) {
        const uint32_t v = kind == 2 ? full4 : 0u;
        for (int f = 0; f < NF; ++f) out[f * words] = v;
        continue;
      }
      const int4* src = reinterpret_cast<const int4*>(pk + b * C * kBV) + tid;
      for (int f = 0; f < NF; ++f) {
        const uint8_t* mf = masks + f * frame;
        int cnt[4] = {0, 0, 0, 0};
        for (int c = 0; c < C; ++c) {
          const int4 p = src[c * kThreads];
          const uint8_t* mc = mf + c * cam;
          cnt[0] += mask_hit(mc, p.x, W);
          cnt[1] += mask_hit(mc, p.y, W);
          cnt[2] += mask_hit(mc, p.z, W);
          cnt[3] += mask_hit(mc, p.w, W);
        }
        uint32_t w = 0;  // byte e = voxel 4 * tid + e
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          w |= (cnt[e] >= views_threshold ? 1u : 0u) << (8 * e);
        }
        out[f * words] = w;
      }
    }
  });
}

template <int NS>
Plan plan_for(int nblk) {
  return persistent_plan(carve_frames_kernel<NS>, true, kThreads,
                         kStages * kStaticC * kThreads * (int)sizeof(int4),
                         nblk);
}

// The launch for this shape: C = kStaticC through the ring, with NF =
// kStaticNF compiled in when it is the chunk's; any other shape straight
// from device memory.
Plan plan_launch(int nblk, int NF, int C, int H, int W, bool& nf_static) {
  nf_static = false;
  if (nblk < 0 || NF < 0 || C < 1 || H < 1 || W < 1) return invalid_plan();
  if (C == kStaticC && (long long)kGroup * C * H * W <= INT_MAX) {
    nf_static = NF == kStaticNF;
    return nf_static ? plan_for<kStaticNF>(nblk) : plan_for<0>(nblk);
  }
  return persistent_plan(carve_frames_direct_kernel, false, kThreads, 0, nblk);
}

}  // namespace

extern "C" {

const char* vbr_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}

// out[0..4] = C fixed at compile time (0/1: the ring kernel or the direct
// one), shared bytes per CTA, CTAs per SM, CTAs launched, NF fixed at
// compile time (0/1): what vbr_carve_frames would launch for this shape.
int vbr_carve_frames_plan(int nblk, int C, int NF, int* out) {
  bool nf_static;
  const Plan p = plan_launch(nblk, NF, C, 1, 1, nf_static);
  out[0] = p.c_static;
  out[1] = p.smem;
  out[2] = p.per_sm;
  out[3] = p.blocks;
  out[4] = nf_static;
  return p.status;
}

int vbr_carve_frames(const int32_t* pk, const int32_t* active,
                     const int32_t* full, const uint8_t* masks, uint8_t* occ,
                     int nblk, int NF, int C, int H, int W,
                     int views_threshold, void* stream) {
  bool nf_static;
  const Plan p = plan_launch(nblk, NF, C, H, W, nf_static);
  if (p.status != 0) return p.status;
  if (nblk > 0 && NF > 0) {
    const uint32_t full4 = C >= views_threshold ? kOnes : 0u;
    if (!p.c_static) {
      carve_frames_direct_kernel<<<p.blocks, kThreads, 0,
                                   static_cast<cudaStream_t>(stream)>>>(
          pk, active, full, masks, occ, nblk, NF, C, H, W, views_threshold,
          full4);
      return static_cast<int>(cudaGetLastError());
    }
    // a count is at most C, so a threshold past C + 1 changes nothing
    const int thr = views_threshold < 0 ? 0
                    : views_threshold > C + 1 ? C + 1 : views_threshold;
    auto kernel = nf_static ? carve_frames_kernel<kStaticNF>
                            : carve_frames_kernel<0>;
    kernel<<<p.blocks, kThreads, p.smem, static_cast<cudaStream_t>(stream)>>>(
        pk, active, full, masks, occ, nblk, NF, H, W,
        (uint32_t)thr * kOnes, full4);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
