// vbr_host — the port's native host tails, a plain C API for ctypes.
//
// Counterpart of the two OpenCV-free functions of vbr_tpu/native/vbr_host.cpp
// (which also holds an OpenCV decoder and MOG oracle the port does not
// need):
//
//  1. vbr_yuv420_pack — the host pack of the reduced-byte ingest,
//     byte-identical to ops/color.py::_bgr_to_yuv420_numpy.
//  2. vbr_mc_emit — triangles from a surface wire's (cell, config) pairs,
//     bit-identical to ops/marching_cubes.py::_triangles_from_wire_numpy.
//
// Build: native/build.py (g++ -O2 -ffp-contract=off: a fused multiply-add
// in (v + base) * spacing + origin would round once where numpy rounds
// twice).

#include <cstdint>

extern "C" {

// ---- YUV 4:2:0 pack ----
//
// (C, H, W, 3) u8 BGR -> (C, H*3/2, W) u8: the Y plane, then H/2 rows of
// U (left half) and V (right half).  Integer BT.601 full range with
// arithmetic shifts, each chroma sample the mean of its 2x2 block with +2
// rounding, every output clipped to [0, 255].  H and W are even.

void vbr_yuv420_pack(const uint8_t* bgr, int C, int H, int W,
                     uint8_t* out) {
  const long plane = static_cast<long>(H) * W;
  const long out_plane = static_cast<long>(H * 3 / 2) * W;
  for (int c = 0; c < C; ++c) {
    const uint8_t* src = bgr + c * plane * 3;
    uint8_t* dst_y = out + c * out_plane;
    uint8_t* dst_ch = dst_y + plane;
    for (int i = 0; i < H; i += 2) {
      const uint8_t* r0 = src + static_cast<long>(i) * W * 3;
      const uint8_t* r1 = r0 + W * 3;
      uint8_t* y0 = dst_y + static_cast<long>(i) * W;
      uint8_t* y1 = y0 + W;
      uint8_t* urow = dst_ch + static_cast<long>(i / 2) * W;
      uint8_t* vrow = urow + W / 2;
      for (int j = 0; j < W; j += 2) {
        int us = 0, vs = 0;
        const uint8_t* px[4] = {r0 + 3 * j, r0 + 3 * (j + 1),
                                r1 + 3 * j, r1 + 3 * (j + 1)};
        uint8_t* yo[4] = {y0 + j, y0 + j + 1, y1 + j, y1 + j + 1};
        for (int k = 0; k < 4; ++k) {
          const int b = px[k][0], g = px[k][1], r = px[k][2];
          const int y = (77 * r + 150 * g + 29 * b + 128) >> 8;
          us += ((-43 * r - 85 * g + 128 * b + 128) >> 8) + 128;
          vs += ((128 * r - 107 * g - 21 * b + 128) >> 8) + 128;
          *yo[k] = static_cast<uint8_t>(y < 0 ? 0 : (y > 255 ? 255 : y));
        }
        const int u = (us + 2) >> 2, v = (vs + 2) >> 2;
        urow[j / 2] = static_cast<uint8_t>(u < 0 ? 0 : (u > 255 ? 255 : u));
        vrow[j / 2] = static_cast<uint8_t>(v < 0 ? 0 : (v > 255 ? 255 : v));
      }
    }
  }
}

// ---- marching-cubes wire emission ----
//
// For each of the n active cells (flat index idx[i] into the (nx-1, ny1,
// nz1) cell grid, corner configuration cfg[i]) append the valid triangles
// of table row cfg[i] ((256, T, 9) f32 vertices relative to the cell base,
// (256, T) u8 valid flags), placed as (v + base) * spacing + origin in
// f32.  Returns the number of triangles written to out (room for n * T).

int vbr_mc_emit(const int32_t* idx, const uint8_t* cfg, int n,
                const float* table, const uint8_t* tvalid, int T,
                int ny1, int nz1, const float* origin,
                const float* spacing, float* out) {
  long m = 0;
  const long plane = static_cast<long>(ny1) * nz1;
  for (int i = 0; i < n; ++i) {
    const int c = cfg[i];
    const long id = idx[i];
    const float base[3] = {static_cast<float>(id / plane),
                           static_cast<float>((id / nz1) % ny1),
                           static_cast<float>(id % nz1)};
    const float* trow = table + static_cast<long>(c) * T * 9;
    const uint8_t* vrow = tvalid + static_cast<long>(c) * T;
    for (int t = 0; t < T; ++t) {
      if (!vrow[t]) continue;
      const float* v = trow + static_cast<long>(t) * 9;
      float* o = out + m * 9;
      for (int k = 0; k < 9; ++k) {
        const int ax = k % 3;
        o[k] = (v[k] + base[ax]) * spacing[ax] + origin[ax];
      }
      ++m;
    }
  }
  return static_cast<int>(m);
}

}  // extern "C"
