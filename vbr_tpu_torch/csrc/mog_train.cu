// Multi-frame training of the per-pixel mixture-of-Gaussians background
// model (the OpenCV bgsegm MOG update), T frames per launch.
//
// Replaces the Pallas kernel of vbr_tpu/ops/gmm.py (_make_train_kernel,
// launched by _train_chunk_pallas).  Same function: for each frame t of the
// chunk, every pixel runs _update_arrays with
// alpha = 1 / min(nframes + t + 1, history) and no training mask, on the
// state layout weight/sort_key (K, HW), mean/var (3, K, HW), updated in
// place.  The result is bit-equal to the plain PyTorch loop: build this
// file with -fmad=false (every multiply and add rounds on its own) and
// without fast math (division and sqrtf are IEEE).
//
// What bounds it on an H100: bytes.  The state is K*8 floats per pixel
// (1600 B at K = 50; 500 MB for a 486x644 camera), of which a pixel uses a
// few slots; the used slots must be read and written once per chunk, the
// frames (3 B per pixel and frame) read once.
//
// Design: one thread per pixel follows OpenCV's sequential loop directly:
// walk the valid prefix to the first match, update that slot, move it up
// past the slots whose stored key is smaller; else replace the slot at the
// break position; then rescale weights and keys by 1/sum(w).
//
//  * The high-water mark travels with the state.  ``used`` (HW,) i32 comes
//    in and goes out: every slot at or past used[pixel] holds weight 0 and
//    key 0, which the rescale leaves unchanged and the sequential sum
//    ignores exactly, so no loop looks past it.  Only a replacement raises
//    it.  No launch scans the K slots to find it.
//  * A pixel's used slots live on chip for the whole chunk, as the TPU
//    kernel keeps its pixel tile in VMEM.  Each thread copies its slots
//    < min(used, S) into shared memory with 4-byte cp.async (in the (K, HW)
//    layout a warp's 32 pixels are 128 contiguous bytes per slot and field;
//    all copies are in flight together), laid out [slot][field][thread] so
//    that neighbouring threads hit neighbouring banks whatever the slot and
//    a slot's fields sit at fixed offsets from its first.
//    The T frames run there, and the slots < min(used, S) (the mark may
//    have risen) go back to device memory once.  A thread touches only its
//    own column, so there is no block barrier anywhere.
//  * Slots at or past the cap S stay in device memory: one accessor in
//    front of every slot access (slot < S ? shared : device), same
//    arithmetic, so the result is the same bits whatever S is.  The update
//    is compiled twice: a warp whose pixels all stay below S in a frame
//    runs the copy without that test.
//    S * 2 KB of shared memory per CTA sets how many CTAs an SM holds.
//  * A thread fetches its three bytes of a frame two frames ahead of use.
//  * One CTA of 64 pixels per tile, as many CTAs as tiles: the kernel is
//    bound by the schedulers' instruction rate, a tile's time depends on
//    its data, and the hardware hands the next tile to whichever SM is free.
//    (A grid of resident CTAs striding over the tiles measured slower.)
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 64;              // pixels per CTA
constexpr int kFields = 8;               // w, key, mu[3], var[3]
constexpr float kEps = 1.1920929e-07f;   // FLT_EPSILON
constexpr float kW0 = 0.05f;             // initial weight
constexpr float kVar0 = 900.0f;          // 4 * (default sigma 15)^2
constexpr float kSk0 = (float)(0.05 / 30.0);  // w0 / (2 * default sigma)

enum Field { kW = 0, kKey = 1, kMu0 = 2, kMu1 = 3, kMu2 = 4, kVar0f = 5,
             kVar1f = 6, kVar2f = 7 };

__device__ __forceinline__ void cp_async4(float* smem, const float* gmem) {
  const uint32_t dst = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst),
               "l"(gmem)
               : "memory");
}

// One pixel's slots: those below S in this thread's column of shared
// memory, the others in the pixel's column of device memory.  kAllShared
// says that the caller knows every index it passes to be below S.
struct Slots {
  float* sm;           // shared: field f, slot k at sm[(k * kFields + f) * kThreads]
  float* gp[kFields];  // device: field f, slot k at gp[f][k * hw]
  size_t hw;
  int S;

  template <int F, bool kAllShared>
  __device__ __forceinline__ float get(int k) const {
    return (kAllShared || k < S) ? sm[(k * kFields + F) * kThreads]
                                 : gp[F][k * hw];
  }
  template <int F, bool kAllShared>
  __device__ __forceinline__ void set(int k, float v) const {
    if (kAllShared || k < S) {
      sm[(k * kFields + F) * kThreads] = v;
    } else {
      gp[F][k * hw] = v;
    }
  }
  template <int F, bool kAllShared>
  __device__ __forceinline__ void move(int dst, int src) const {
    set<F, kAllShared>(dst, get<F, kAllShared>(src));
  }
};

// One frame of one pixel: OpenCV's sequential update on the pixel's slots.
// With A (all shared) the caller knows that no index reaches S.
template <bool A>
__device__ __forceinline__ void update_pixel(const Slots& s, int& used,
                                             float x0, float x1, float x2,
                                             float alpha, int K, float vt,
                                             float min_var) {
  // walk the valid prefix up to the first match; it ends at ``used`` at
  // the latest, where the weight is 0
  int c = -1;
  int k = 0;
  float wk = 0.f, varsum = 0.f;
  float m0 = 0.f, m1 = 0.f, m2 = 0.f, v0 = 0.f, v1 = 0.f, v2 = 0.f;
  float d0 = 0.f, d1 = 0.f, d2 = 0.f;
  for (; k < used; ++k) {
    wk = s.get<kW, A>(k);
    if (wk < kEps) break;
    m0 = s.get<kMu0, A>(k);
    m1 = s.get<kMu1, A>(k);
    m2 = s.get<kMu2, A>(k);
    v0 = s.get<kVar0f, A>(k);
    v1 = s.get<kVar1f, A>(k);
    v2 = s.get<kVar2f, A>(k);
    d0 = x0 - m0;
    d1 = x1 - m1;
    d2 = x2 - m2;
    const float dist2 = (d0 * d0 + d1 * d1) + d2 * d2;
    varsum = (v0 + v1) + v2;
    if (dist2 < vt * varsum) {
      c = k;
      break;
    }
  }

  if (c >= 0) {
    // matched slot: new weight, mean, variance; key = new w / sqrt(old sum)
    const float wn = wk + alpha * (1.0f - wk);
    const float n0 = m0 + alpha * d0;
    const float n1 = m1 + alpha * d1;
    const float n2 = m2 + alpha * d2;
    const float u0 = fmaxf(v0 + alpha * (d0 * d0 - v0), min_var);
    const float u1 = fmaxf(v1 + alpha * (d1 * d1 - v1), min_var);
    const float u2 = fmaxf(v2 + alpha * (d2 * d2 - v2), min_var);
    const float kn = wn / sqrtf(varsum);
    // it moves up to p = (largest j < c with stored key >= kn) + 1
    int p = 0;
    for (int j = c - 1; j >= 0; --j) {
      if (s.get<kKey, A>(j) >= kn) {
        p = j + 1;
        break;
      }
    }
    for (int j = c; j > p; --j) {  // slots p .. c-1 move down by one
      s.move<kW, A>(j, j - 1);
      s.move<kKey, A>(j, j - 1);
      s.move<kMu0, A>(j, j - 1);
      s.move<kMu1, A>(j, j - 1);
      s.move<kMu2, A>(j, j - 1);
      s.move<kVar0f, A>(j, j - 1);
      s.move<kVar1f, A>(j, j - 1);
      s.move<kVar2f, A>(j, j - 1);
    }
    s.set<kW, A>(p, wn);
    s.set<kKey, A>(p, kn);
    s.set<kMu0, A>(p, n0);
    s.set<kMu1, A>(p, n1);
    s.set<kMu2, A>(p, n2);
    s.set<kVar0f, A>(p, u0);
    s.set<kVar1f, A>(p, u1);
    s.set<kVar2f, A>(p, u2);
  } else {
    // no match: a fresh mode at the break position (first empty, else last)
    const int r = min(k, K - 1);
    s.set<kW, A>(r, kW0);
    s.set<kKey, A>(r, kSk0);
    s.set<kMu0, A>(r, x0);
    s.set<kMu1, A>(r, x1);
    s.set<kMu2, A>(r, x2);
    s.set<kVar0f, A>(r, kVar0);
    s.set<kVar1f, A>(r, kVar0);
    s.set<kVar2f, A>(r, kVar0);
    used = max(used, r + 1);
  }

  // rescale weights and keys by 1 / sum(w), summed slot 0 .. K-1 in order
  float total = s.get<kW, true>(0);
  for (int j = 1; j < used; ++j) total = total + s.get<kW, A>(j);
  const float scale = 1.0f / total;
  for (int j = 0; j < used; ++j) {
    s.set<kW, A>(j, s.get<kW, A>(j) * scale);
    s.set<kKey, A>(j, s.get<kKey, A>(j) * scale);
  }
}

__global__ void __launch_bounds__(kThreads) mog_train_kernel(
    const uint8_t* __restrict__ frames,   // (T, HW, 3) colour-converted
    float* __restrict__ w,                // (K, HW)
    float* __restrict__ key,              // (K, HW)
    float* __restrict__ mu,               // (3, K, HW)
    float* __restrict__ var,              // (3, K, HW)
    const int32_t* __restrict__ nframes,  // () frames seen before this chunk
    int32_t* __restrict__ nframes_out,    // () = nframes + T
    int32_t* __restrict__ used_io,        // (HW,) high-water mark, in and out
    int T, int K, int HW, int history, float vt, float min_var, int S) {
  extern __shared__ float smem[];  // [S][kFields][kThreads]
  const size_t hw = (size_t)HW;
  const size_t ch = (size_t)K * hw;  // channel stride of mu / var
  const int nf0 = nframes[0];
  if (blockIdx.x == 0 && threadIdx.x == 0) nframes_out[0] = nf0 + T;
  const int pix = blockIdx.x * kThreads + threadIdx.x;
  if (pix >= HW) return;  // no barrier below: a thread may leave alone

  Slots s;
  s.sm = smem + threadIdx.x;
  s.hw = hw;
  s.S = S;
  s.gp[kW] = w + pix;
  s.gp[kKey] = key + pix;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    s.gp[kMu0 + c] = mu + c * ch + pix;
    s.gp[kVar0f + c] = var + c * ch + pix;
  }

  int used = used_io[pix];  // slots at or past it hold weight 0 and key 0
  const int cached = min(used, S);
  for (int k = 0; k < cached; ++k) {
#pragma unroll
    for (int f = 0; f < kFields; ++f) {
      cp_async4(s.sm + (k * kFields + f) * kThreads, s.gp[f] + k * hw);
    }
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");

  // the pixel's bytes of frames t (a) and t+1 (b) wait in registers
  const uint8_t* fp = frames + (size_t)pix * 3;
  const size_t fstride = hw * 3;
  uint8_t a0 = fp[0], a1 = fp[1], a2 = fp[2];
  uint8_t b0 = 0, b1 = 0, b2 = 0;
  if (T > 1) {
    b0 = fp[fstride];
    b1 = fp[fstride + 1];
    b2 = fp[fstride + 2];
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");

  for (int t = 0; t < T; ++t) {
    const float x0 = a0, x1 = a1, x2 = a2;
    a0 = b0;
    a1 = b1;
    a2 = b2;
    if (t + 2 < T) {
      const uint8_t* px = fp + (size_t)(t + 2) * fstride;
      b0 = px[0];
      b1 = px[1];
      b2 = px[2];
    }
    const float alpha = 1.0f / (float)min(nf0 + t + 1, history);
    // while no pixel of the warp can reach slot S in this frame (a
    // replacement lands at min(used, K - 1) at most), the frame touches
    // shared memory only: the copy of the update without the residence
    // test in front of each access
    if (__all_sync(__activemask(), min(used, K - 1) < S)) {
      update_pixel<true>(s, used, x0, x1, x2, alpha, K, vt, min_var);
    } else {
      update_pixel<false>(s, used, x0, x1, x2, alpha, K, vt, min_var);
    }
  }

  const int back = min(used, S);
  for (int k = 0; k < back; ++k) {
#pragma unroll
    for (int f = 0; f < kFields; ++f) {
      s.gp[f][k * hw] = s.sm[(k * kFields + f) * kThreads];
    }
  }
  used_io[pix] = used;
}

struct Plan {
  int status;  // a cudaError_t
  int slots;   // S = min(cache_slots, K)
  int smem;    // dynamic shared memory per CTA, bytes
  int per_sm;  // CTAs an SM holds
  int blocks;  // CTAs launched: one per kThreads pixels
};

Plan plan_launch(int K, int HW, int cache_slots) {
  Plan p = {};
  if (K < 1 || HW < 0 || HW > (1 << 30) || cache_slots < 1 ||
      (long long)K * HW >= (1LL << 40)) {
    p.status = static_cast<int>(cudaErrorInvalidValue);
    return p;
  }
  p.slots = cache_slots < K ? cache_slots : K;
  p.smem = p.slots * kFields * kThreads * (int)sizeof(float);
  p.blocks = (HW + kThreads - 1) / kThreads;
  cudaError_t err = cudaFuncSetAttribute(
      mog_train_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(mog_train_kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  }
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &p.per_sm, mog_train_kernel, kThreads, p.smem);
  }
  if (err == cudaSuccess && p.per_sm < 1) err = cudaErrorInvalidValue;
  p.status = static_cast<int>(err);
  return p;
}

}  // namespace

extern "C" {

const char* vbr_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}

// out[0..3] = cached slots, shared bytes per CTA, CTAs an SM holds, CTAs
// launched: what vbr_mog_train would launch for this shape.
int vbr_mog_train_plan(int K, int HW, int cache_slots, int* out) {
  const Plan p = plan_launch(K, HW, cache_slots);
  out[0] = p.slots;
  out[1] = p.smem;
  out[2] = p.per_sm;
  out[3] = p.blocks;
  return p.status;
}

int vbr_mog_train(const uint8_t* frames, float* w, float* key, float* mu,
                  float* var, const int32_t* nframes, int32_t* nframes_out,
                  int32_t* used, int T, int K, int HW, int history, float vt,
                  float min_var, int cache_slots, void* stream) {
  if (history < 1 || T < 1 || HW < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Plan p = plan_launch(K, HW, cache_slots);
  if (p.status != 0) return p.status;
  mog_train_kernel<<<p.blocks, kThreads, p.smem,
                     static_cast<cudaStream_t>(stream)>>>(
      frames, w, key, mu, var, nframes, nframes_out, used, T, K, HW, history,
      vt, min_var, p.slots);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
