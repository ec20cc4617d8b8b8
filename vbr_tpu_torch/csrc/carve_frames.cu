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
//    32-bit word, a byte per voxel (a count is at most C, so bytes never
//    carry: the launcher takes C <= kMaxC).  The threshold test is per
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
//    any other camera count or chunk takes the same kernel with C or NF at
//    run time (NF in groups of kGroup frames).  The launcher picks by C and
//    NF alone.
//  * Registers for kMinCtas = 8 CTAs per SM (64 a thread).  How many of a
//    thread's 128 gathers ptxas issues before it uses one follows the
//    budget, and not monotonically: 32 at 64 registers, 5 at 80, where it
//    interleaves them with their uses and the latencies add up (1.5x the
//    time).  So the budget is fixed here, not left to ptxas.
//
// Limits: C <= kMaxC for the byte counters, and the ring's shared memory
// (kStages x C x 2 KB per CTA) refuses more than 56 cameras before that;
// a frame group's masks are addressed with int offsets from a 64-bit base,
// so kGroup x C x H x W must fit an int (the tables' H < 1023, W < 1024
// keep that for any C the ring takes).  The launcher refuses the rest.
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
constexpr int kMaxC = 254;     // counts and threshold fit a byte
constexpr uint32_t kOnes = 0x01010101u;

// CS > 0: the number of cameras, fixed at compile time; 0: C at run time.
// NS > 0: the number of frames, likewise.
template <int CS, int NS>
__global__ void __launch_bounds__(kThreads, kMinCtas) carve_frames_kernel(
    const int32_t* __restrict__ pk,      // (nblk, C, BV)
    const int32_t* __restrict__ active,  // (nblk,)
    const int32_t* __restrict__ full,    // (nblk,)
    const uint8_t* __restrict__ masks,   // (NF, C, H, W)
    uint8_t* __restrict__ occ,           // (NF, nblk, BV)
    int nblk, int NF_rt, int C_rt, int H, int W,
    uint32_t thr4,    // the view threshold, clamped to [0, C + 1], per byte
    uint32_t full4) {  // a full sub-block's occupancy word
  extern __shared__ int4 ring[];       // [kStages][C][kThreads]
  __shared__ uint8_t s_kind[kRound];   // 0 inactive, 1 count, 2 full
  const int C = CS > 0 ? CS : C_rt;
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
        if constexpr (CS > 0) {
#pragma unroll
          for (int c = 0; c < CS; ++c) {
            cp_async16(dst + c * kThreads, src + c * kThreads);
          }
        } else {
          for (int c = 0; c < C; ++c) {
            cp_async16(dst + c * kThreads, src + c * kThreads);
          }
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
        if constexpr (CS > 0) {
#pragma unroll
          for (int c = 0; c < CS; ++c) count_camera(c);
        } else {
          for (int c = 0; c < C; ++c) count_camera(c);
        }
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

template <int CS, int NS>
Plan plan_for(int nblk, int C) {
  return persistent_plan(carve_frames_kernel<CS, NS>, CS > 0, kThreads,
                         kStages * C * kThreads * (int)sizeof(int4), nblk);
}

// The launch for this shape: C = kStaticC compiled in when it is the rig's,
// and then NF = kStaticNF too when it is the chunk's; else run time.
Plan plan_launch(int nblk, int NF, int C, int H, int W, bool& nf_static) {
  nf_static = false;
  if (nblk < 0 || NF < 0 || C < 1 || C > kMaxC || H < 1 || W < 1 ||
      (long long)kGroup * C * H * W > INT_MAX) {
    return invalid_plan();
  }
  if (C != kStaticC) return plan_for<0, 0>(nblk, C);
  nf_static = NF == kStaticNF;
  return nf_static ? plan_for<kStaticC, kStaticNF>(nblk, C)
                   : plan_for<kStaticC, 0>(nblk, C);
}

}  // namespace

extern "C" {

const char* vbr_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}

// out[0..4] = C fixed at compile time (0/1), shared bytes per CTA, CTAs per
// SM, CTAs launched, NF fixed at compile time (0/1): what vbr_carve_frames
// would launch for this shape.
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
    // a count is at most C, so a threshold past C + 1 changes nothing
    const int thr = views_threshold < 0 ? 0
                    : views_threshold > C + 1 ? C + 1 : views_threshold;
    const uint32_t full4 = C >= views_threshold ? kOnes : 0u;
    auto kernel = !p.c_static ? carve_frames_kernel<0, 0>
                  : nf_static ? carve_frames_kernel<kStaticC, kStaticNF>
                              : carve_frames_kernel<kStaticC, 0>;
    kernel<<<p.blocks, kThreads, p.smem, static_cast<cudaStream_t>(stream)>>>(
        pk, active, full, masks, occ, nblk, NF, C, H, W,
        (uint32_t)thr * kOnes, full4);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
