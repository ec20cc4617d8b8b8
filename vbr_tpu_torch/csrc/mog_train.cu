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
// (1600 B at K = 50; 500 MB for a 486x644 camera) and must be read and
// written once per chunk; the frames add 3 B per pixel and frame.  The TPU
// kernel keeps a pixel tile's whole state in VMEM across the chunk for that
// reason and works on all K slots of every pixel every frame, as one-hot
// selects and rolls, because a TPU has no gather.
//
// Design: one thread per pixel follows OpenCV's sequential loop directly:
// walk the valid prefix to the first match, update that slot, move it up
// past the slots whose stored key is smaller; else replace the slot at the
// break position; then rescale weights and keys by 1/sum(w).  State stays
// in device memory in the (K, HW) layout, so a warp's 32 pixels read 128
// contiguous bytes per slot and field.  A pixel touches only the slots it
// walks, plus weight and key of its used slots for the rescale: slots
// past the last one ever written hold weight 0 and key 0, which the rescale
// leaves unchanged and the sequential sum ignores exactly, so the loops
// stop at that high-water mark (found by one pass over the weights and
// keys at the start, raised by a replacement).  Slots are indexed in
// device memory, never in a per-thread array.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr float kEps = 1.1920929e-07f;   // FLT_EPSILON
constexpr float kW0 = 0.05f;             // initial weight
constexpr float kVar0 = 900.0f;          // 4 * (default sigma 15)^2
constexpr float kSk0 = (float)(0.05 / 30.0);  // w0 / (2 * default sigma)

__global__ void __launch_bounds__(kThreads) mog_train_kernel(
    const uint8_t* __restrict__ frames,  // (T, HW, 3) colour-converted
    float* __restrict__ w,               // (K, HW)
    float* __restrict__ key,             // (K, HW)
    float* __restrict__ mu,              // (3, K, HW)
    float* __restrict__ var,             // (3, K, HW)
    const int32_t* __restrict__ nframes, // () frames seen before this chunk
    int T, int K, int HW, int history, float vt, float min_var) {
  const int pix = blockIdx.x * blockDim.x + threadIdx.x;
  if (pix >= HW) return;
  const size_t hw = (size_t)HW;
  const size_t ch = (size_t)K * hw;  // channel stride of mu / var
  const int nf0 = nframes[0];

  int used = 0;  // slots at or past ``used`` hold weight 0 and key 0
  for (int k = 0; k < K; ++k) {
    if (w[k * hw + pix] != 0.0f || key[k * hw + pix] != 0.0f) used = k + 1;
  }

  for (int t = 0; t < T; ++t) {
    const uint8_t* px = frames + ((size_t)t * hw + pix) * 3;
    const float x0 = px[0], x1 = px[1], x2 = px[2];
    const float alpha = 1.0f / (float)min(nf0 + t + 1, history);

    // walk the valid prefix up to the first match
    int c = -1;
    int k = 0;
    float wk = 0.f, varsum = 0.f;
    float m0 = 0.f, m1 = 0.f, m2 = 0.f, v0 = 0.f, v1 = 0.f, v2 = 0.f;
    float d0 = 0.f, d1 = 0.f, d2 = 0.f;
    for (; k < K; ++k) {
      const size_t i = k * hw + pix;
      wk = w[i];
      if (wk < kEps) break;
      m0 = mu[i]; m1 = mu[ch + i]; m2 = mu[2 * ch + i];
      v0 = var[i]; v1 = var[ch + i]; v2 = var[2 * ch + i];
      d0 = x0 - m0; d1 = x1 - m1; d2 = x2 - m2;
      const float dist2 = (d0 * d0 + d1 * d1) + d2 * d2;
      varsum = (v0 + v1) + v2;
      if (dist2 < vt * varsum) { c = k; break; }
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
        if (key[j * hw + pix] >= kn) { p = j + 1; break; }
      }
      for (int j = c; j > p; --j) {  // slots p .. c-1 move down by one
        const size_t dst = j * hw + pix, src = dst - hw;
        w[dst] = w[src];
        key[dst] = key[src];
        mu[dst] = mu[src]; mu[ch + dst] = mu[ch + src];
        mu[2 * ch + dst] = mu[2 * ch + src];
        var[dst] = var[src]; var[ch + dst] = var[ch + src];
        var[2 * ch + dst] = var[2 * ch + src];
      }
      const size_t i = p * hw + pix;
      w[i] = wn;
      key[i] = kn;
      mu[i] = n0; mu[ch + i] = n1; mu[2 * ch + i] = n2;
      var[i] = u0; var[ch + i] = u1; var[2 * ch + i] = u2;
    } else {
      // no match: a fresh mode at the break position (first empty, else last)
      const int r = min(k, K - 1);
      const size_t i = r * hw + pix;
      w[i] = kW0;
      key[i] = kSk0;
      mu[i] = x0; mu[ch + i] = x1; mu[2 * ch + i] = x2;
      var[i] = kVar0; var[ch + i] = kVar0; var[2 * ch + i] = kVar0;
      used = max(used, r + 1);
    }

    // rescale weights and keys by 1 / sum(w), summed slot 0 .. K-1 in order
    float total = w[pix];
    for (int j = 1; j < used; ++j) total = total + w[j * hw + pix];
    const float scale = 1.0f / total;
    for (int j = 0; j < used; ++j) {
      const size_t i = j * hw + pix;
      w[i] = w[i] * scale;
      key[i] = key[i] * scale;
    }
  }
}

}  // namespace

extern "C" {

const char* vbr_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}

int vbr_mog_train(const uint8_t* frames, float* w, float* key, float* mu,
                  float* var, const int32_t* nframes, int T, int K, int HW,
                  int history, float vt, float min_var, void* stream) {
  if (K < 1 || history < 1 || (long long)K * HW >= (1LL << 40)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (HW > 0 && T > 0) {
    const int blocks = (HW + kThreads - 1) / kThreads;
    mog_train_kernel<<<blocks, kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
        frames, w, key, mu, var, nframes, T, K, HW, history, vt, min_var);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
