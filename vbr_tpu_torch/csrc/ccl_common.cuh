// The two labelling kernels (ccl_combined.cu, ccl_label.cu), written once
// over a Rule type: the cluster route (one thread-block cluster per image,
// the label image in the cluster's shared memory), the general route (one
// CTA per image, the labels in device memory) and the launcher that picks
// between them by shape alone.
//
// Both kernels run the fixpoint of vbr_tpu/ops/ccl_pallas.py: labels start
// at the padded linear index; per iteration a neighbour pass on the
// iteration-start labels, then segmented min-scans along the rows (forward,
// reverse) and along the columns (forward, reverse); stop after an
// iteration that changes nothing or after max_iters.  They differ in the
// neighbour set and in what a segment is, which a Rule type states:
//
//   Rule::kOrthogonal        neighbour pass takes all 8 neighbours (else the
//                            4 diagonals, gated on equal phase)
//   Rule::init(p, idx)       a pixel's first label
//   Rule::same(a, b)         two adjacent pixels of phases a, b share a segment
//   Rule::same_mask(w, v)    the same for 32 pixels at once (bit masks)
//
// What bounded the device-memory kernels on an H100 was the latency of one
// SM per image streaming 2 x 1.5 MB of labels through L2 five times per
// iteration.  Here the image is cut into bands of whole rows, one band per
// CTA of a cluster of up to 8 (488x768: 61 rows, 187 KB of labels per CTA),
// so device memory is touched twice: the phase is read once (into one bit
// per pixel), the labels and the iteration count are written once.
//
//   * One label buffer.  Every pass only lowers labels (each is a min that
//     includes the pixel itself), so "the iteration changed something" is
//     the OR of "a pass stored a lower value", and no iteration-start copy
//     is kept.  The neighbour pass, which must read iteration-start values
//     while it writes, walks the band in groups of kGroup pixels: a group
//     computes its results into registers (four adjacent pixels per thread
//     and step), saves the old values of its last W+4 pixels for the next
//     group, and stores after a barrier.  The neighbouring bands' edge
//     rows stand in halo rows: each CTA writes its own two, once final,
//     into its neighbours' halos through distributed shared memory.
//   * Row scans stay inside a CTA: a warp per row, 128 columns at a time:
//     a lane scans its four pixels, a shuffle scan gated by each lane's
//     segment start joins the lanes, and a carry joins the steps.
//   * Column scans: each CTA scans its band (four adjacent columns per
//     thread, the phase as a nibble), publishes
//     per column its exit value and whether the carry passes through the
//     whole band, and after a cluster barrier folds the summaries of the
//     bands before it into an incoming carry that it applies to the leading
//     segment of its band.  Min is exact and associative, so this equals the
//     sequential scan bit for bit.
//   * The loop's exit is cluster-wide: each CTA publishes its changed flag
//     and every warp reads all of them after a cluster barrier, so all CTAs
//     of a cluster leave in the same iteration.
//
// The passes are bound by the SM's instruction throughput rather than by
// shared memory.
//
// A shape whose band does not fit the shared memory of a block at a cluster
// of 8 takes the general route (ccl_general_kernel): one CTA of 1024
// threads per image and two label buffers in device memory, bound by the
// latency and L2 bandwidth of one SM per image.  Its neighbour pass is one
// thread per pixel; row scans give each warp whole rows, 32 columns at a
// time; column scans give each thread one column; the change test compares
// against the iteration-start buffer.  ccl_route() decides by shape alone.
#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace ccl {

namespace cg = cooperative_groups;

constexpr int kThreads = 1024;
constexpr int kBig = 1 << 30;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kPerThread = 16;                   // neighbour pass: pixels per thread and group
constexpr int kGroup = kPerThread * kThreads;    // pixels per group
constexpr int kMaxCluster = 8;                   // the portable cluster size
constexpr int kBandRows = 64;                    // prefer bands no taller than this
constexpr int kColBatch = 4;                     // column scan: rows loaded ahead

// Words of shared memory of one CTA holding a band of R rows of W pixels,
// in the kernel's order: labels with a halo row above and below, two save
// buffers of the neighbour pass, the column summaries of both directions,
// the changed flag, phase bits with their halo rows (plus a word of slack
// at each end).
inline long long smem_words(int R, int W) {
  const int wpr = W / 32;
  return (long long)(R + 2) * W + 2LL * (W + 32) + 2LL * W + 4 +
         ((long long)(R + 2) * wpr + 2);
}

// Cluster size for an (H, W) image, 0 for the general route.  The smallest
// cluster of 1, 2, 4, 8 whose band fits max_smem bytes and, where a larger
// one would still fit, is at most kBandRows tall.
inline int ccl_route(int H, int W, int max_smem, int* smem_bytes) {
  *smem_bytes = 0;
  if (H <= 0 || W <= 0 || W % 128 != 0 || H % kMaxCluster != 0 ||
      W + 4 > kGroup) {
    return 0;
  }
  int pick = 0;
  for (int cs = 1; cs <= kMaxCluster; cs *= 2) {
    const long long bytes = 4 * smem_words(H / cs, W);
    if (bytes > max_smem) continue;
    pick = cs;
    *smem_bytes = (int)bytes;
    if (H / cs <= kBandRows) break;
  }
  return pick;
}

inline int max_optin_smem(int* out) {
  int dev = 0;
  cudaError_t st = cudaGetDevice(&dev);
  if (st != cudaSuccess) return (int)st;
  return (int)cudaDeviceGetAttribute(
      out, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
}

// Bit j of the result: byte j of ``u`` is not 0.
__device__ __forceinline__ unsigned nonzero_bytes(unsigned u) {
  const unsigned nz = (((u & 0x7f7f7f7fu) + 0x7f7f7f7fu) | u) & 0x80808080u;
  return ((nz >> 7) * 0x01020408u) >> 24;
}

// Inclusive segmented min-scan across a warp.  Bit l of ``cont`` says that
// lane l continues the segment of lane l-1.  A lane whose segment began
// before lane 0 also folds in ``carry``.
__device__ __forceinline__ int warp_seg_min(int v, unsigned cont, int lane,
                                            int carry) {
  const unsigned starts = ~cont & (kFull >> (31 - lane));  // at or below me
  const int st = starts ? 31 - __clz(starts) : -1;
  const int lo = max(st, 0);
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int vs = __shfl_up_sync(kFull, v, d);
    if (lane - d >= lo) v = min(v, vs);
  }
  return st < 0 ? min(v, carry) : v;
}

// 1. neighbour pass over the band, in place (see the header note), four
// adjacent pixels per thread and step.  ``lab``/``bits`` point at the band's
// first row; both have their halos.
template <class Rule>
__device__ __forceinline__ void neighbour_pass(int* lab, const unsigned* bits,
                                               int* lbuf, int W, int wpr,
                                               int npix, unsigned magic,
                                               int& chg) {
  const int tid = threadIdx.x;
  const int LB = W + 32;
  for (int g = 0, gs = 0; gs < npix; ++g, gs += kGroup) {
    const int ge = min(gs + kGroup, npix);
    const int* prev = lbuf + ((g + 1) & 1) * LB;  // old [gs-W-4, gs)
    int* save = lbuf + (g & 1) * LB;              // old [ge-W-4, ge)
    if (ge < npix) {
      for (int j = tid; j < W + 4; j += kThreads) save[j] = lab[ge - W - 4 + j];
    }
    // iteration-start labels: groups before this one are already rewritten
    auto old = [&](int idx) {
      return (g > 0 && idx < gs) ? prev[idx - gs + W + 4] : lab[idx];
    };
    auto old4 = [&](int idx) {  // idx % 4 == 0
      return *reinterpret_cast<const int4*>(
          (g > 0 && idx < gs) ? prev + (idx - gs + W + 4) : lab + idx);
    };
    int4 res[kPerThread / 4];
#pragma unroll
    for (int k = 0; k < kPerThread / 4; ++k) {
      const int i = gs + (k * kThreads + tid) * 4;  // pixels i .. i+3
      if (i < ge) {
        const int c = i >> 5;  // word of the bit image
        const int sh = i & 31;
        const int cx = c - (int)__umulhi((unsigned)c, magic) * wpr;
        const unsigned own = bits[c];
        const bool has_l = cx > 0 || sh > 0;         // pixel i-1 is in the row
        const bool has_r = cx < wpr - 1 || sh < 28;  // pixel i+4 is in the row
        const int4 m0 = *reinterpret_cast<const int4*>(lab + i);
        int4 m = m0;
        // rows above and below, columns i-1 .. i+4
        const int4 u = old4(i - W);
        const int4 d = *reinterpret_cast<const int4*>(lab + i + W);
        const int ul = has_l ? old(i - W - 1) : kBig;
        const int ur = has_r ? old(i - W + 4) : kBig;
        const int dl = has_l ? lab[i + W - 1] : kBig;
        const int dr = has_r ? lab[i + W + 4] : kBig;
        if (Rule::kOrthogonal) {
          // background holds 2^30 and stays: only the foreground takes
          const unsigned fg = (own >> sh) & 0xFu;
          if (fg) {
            const int ml = has_l ? old(i - 1) : kBig;
            const int mr = has_r ? lab[i + 4] : kBig;
            const int c0 = min(ul, min(ml, dl));  // column mins, i-1 .. i+4
            const int c1 = min(u.x, min(m.x, d.x));
            const int c2 = min(u.y, min(m.y, d.y));
            const int c3 = min(u.z, min(m.z, d.z));
            const int c4 = min(u.w, min(m.w, d.w));
            const int c5 = min(ur, min(mr, dr));
            if (fg & 1u) m.x = min(c0, min(c1, c2));
            if (fg & 2u) m.y = min(c1, min(c2, c3));
            if (fg & 4u) m.z = min(c2, min(c3, c4));
            if (fg & 8u) m.w = min(c3, min(c4, c5));
          }
        } else {
          const unsigned up = bits[c - wpr], dn = bits[c + wpr];
          const unsigned up_l = (up << 1) | (bits[c - wpr - 1] >> 31);
          const unsigned up_r = (up >> 1) | (bits[c - wpr + 1] << 31);
          const unsigned dn_l = (dn << 1) | (bits[c + wpr - 1] >> 31);
          const unsigned dn_r = (dn >> 1) | (bits[c + wpr + 1] << 31);
          // bit j: the neighbour of pixel i+j in that diagonal has its phase
          // (a neighbour outside the row was loaded as 2^30)
          const unsigned t_ul = (~(own ^ up_l) >> sh) & 0xFu;
          const unsigned t_ur = (~(own ^ up_r) >> sh) & 0xFu;
          const unsigned t_dl = (~(own ^ dn_l) >> sh) & 0xFu;
          const unsigned t_dr = (~(own ^ dn_r) >> sh) & 0xFu;
          if (t_ul & 1u) m.x = min(m.x, ul);
          if (t_ul & 2u) m.y = min(m.y, u.x);
          if (t_ul & 4u) m.z = min(m.z, u.y);
          if (t_ul & 8u) m.w = min(m.w, u.z);
          if (t_ur & 1u) m.x = min(m.x, u.y);
          if (t_ur & 2u) m.y = min(m.y, u.z);
          if (t_ur & 4u) m.z = min(m.z, u.w);
          if (t_ur & 8u) m.w = min(m.w, ur);
          if (t_dl & 1u) m.x = min(m.x, dl);
          if (t_dl & 2u) m.y = min(m.y, d.x);
          if (t_dl & 4u) m.z = min(m.z, d.y);
          if (t_dl & 8u) m.w = min(m.w, d.z);
          if (t_dr & 1u) m.x = min(m.x, d.y);
          if (t_dr & 2u) m.y = min(m.y, d.z);
          if (t_dr & 4u) m.z = min(m.z, d.w);
          if (t_dr & 8u) m.w = min(m.w, dr);
        }
        chg |= (m.x != m0.x) | (m.y != m0.y) | (m.z != m0.z) | (m.w != m0.w);
        res[k] = m;
      }
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kPerThread / 4; ++k) {
      const int i = gs + (k * kThreads + tid) * 4;
      if (i < ge) *reinterpret_cast<int4*>(lab + i) = res[k];
    }
    __syncthreads();
  }
}

// 2. one row scan in the direction of kFwd: the warp takes 128 columns at a
// time, four adjacent ones per lane.  A lane scans its four, the warp scans
// the lanes' last values, and each lane folds the value that reaches it into
// its leading pixels.
template <class Rule, bool kFwd>
__device__ __forceinline__ void row_scan(int* row, const unsigned* brow,
                                         int wpr, int lane, int& chg) {
  const int ln = kFwd ? lane : 31 - lane;  // lane order is scan order
  int carry = kBig;
  for (int q = 0; q < wpr / 4; ++q) {
    const int wi = (kFwd ? q : wpr / 4 - 1 - q) * 4 + (ln >> 3);
    const unsigned w = brow[wi];
    unsigned cont;  // bit x: pixel x continues the segment of the one before
    if (kFwd) {
      cont = Rule::same_mask(w, (w << 1) | (wi ? brow[wi - 1] >> 31 : 0u));
      if (wi == 0) cont &= ~1u;
    } else {
      cont = Rule::same_mask(
          w, (w >> 1) | (wi < wpr - 1 ? brow[wi + 1] << 31 : 0u));
      if (wi == wpr - 1) cont &= ~(1u << 31);
    }
    const unsigned nib = (cont >> ((ln & 7) * 4)) & 0xFu;
    int4* const at = reinterpret_cast<int4*>(row + wi * 32 + (ln & 7) * 4);
    const int4 a = *at;
    // in scan order: values e0..e3, f_j = e_j continues e_(j-1)
    const int e0 = kFwd ? a.x : a.w, e1 = kFwd ? a.y : a.z;
    const int e2 = kFwd ? a.z : a.y, e3 = kFwd ? a.w : a.x;
    const bool f0 = nib & (kFwd ? 1u : 8u), f1 = nib & (kFwd ? 2u : 4u);
    const bool f2 = nib & (kFwd ? 4u : 2u), f3 = nib & (kFwd ? 8u : 1u);
    int s0 = e0;
    int s1 = f1 ? min(s0, e1) : e1;
    int s2 = f2 ? min(s1, e2) : e2;
    int s3 = f3 ? min(s2, e3) : e3;
    // a lane without a segment start continues the lane before it
    const unsigned lanes = __ballot_sync(kFull, f0 && f1 && f2 && f3);
    const int end = warp_seg_min(s3, lanes, lane, carry);
    int cin = __shfl_up_sync(kFull, end, 1);
    if (lane == 0) cin = carry;
    carry = __shfl_sync(kFull, end, 31);
    if (f0) {
      s0 = min(s0, cin);
      if (f1) {
        s1 = min(s1, cin);
        if (f2) {
          s2 = min(s2, cin);
          if (f3) s3 = min(s3, cin);
        }
      }
    }
    if ((s0 != e0) | (s1 != e1) | (s2 != e2) | (s3 != e3)) {
      *at = kFwd ? make_int4(s0, s1, s2, s3) : make_int4(s3, s2, s1, s0);
      chg = 1;
    }
  }
}

// 2. row scans, forward then reverse: a warp per row.
template <class Rule>
__device__ __forceinline__ void row_scans(int* lab, const unsigned* bits,
                                          int R, int W, int wpr, int& chg) {
  const int lane = threadIdx.x & 31;
  for (int r = threadIdx.x >> 5; r < R; r += kThreads / 32) {
    row_scan<Rule, true>(lab + r * W, bits + r * wpr, wpr, lane, chg);
    __syncwarp();
    row_scan<Rule, false>(lab + r * W, bits + r * wpr, wpr, lane, chg);
  }
}

// 3a. column scan of the band in the direction of kFwd, four adjacent
// columns per thread; publishes per column (exit value << 1 | the carry
// passes through this band).
template <class Rule, bool kFwd>
__device__ __forceinline__ void col_scan_band(int* lab, const unsigned* bits,
                                              unsigned* sums, int R, int W,
                                              int wpr, bool has_pred,
                                              int& chg) {
  for (int x = threadIdx.x * 4; x < W; x += kThreads * 4) {
    const unsigned* bcol = bits + (x >> 5);
    const int sh = x & 31;
    int* col = lab + x;
    unsigned prevp = (bcol[(kFwd ? -1 : R) * wpr] >> sh) & 0xFu;
    int4 run = make_int4(kBig, kBig, kBig, kBig);
    unsigned whole = 0xFu, seam = 0u;  // a bit per column
    for (int j0 = 0; j0 < R; j0 += kColBatch) {
      int4 v[kColBatch];
      unsigned p[kColBatch];
#pragma unroll
      for (int u = 0; u < kColBatch; ++u) {
        const int j = j0 + u;
        const int y = kFwd ? j : R - 1 - j;
        if (j < R) {
          v[u] = *reinterpret_cast<const int4*>(col + y * W);
          p[u] = (bcol[y * wpr] >> sh) & 0xFu;
        }
      }
#pragma unroll
      for (int u = 0; u < kColBatch; ++u) {
        const int j = j0 + u;
        const int y = kFwd ? j : R - 1 - j;
        if (j < R) {
          const unsigned same = Rule::same_mask(p[u], prevp) & 0xFu;
          const unsigned cont = j > 0 ? same : 0u;
          if (j == 0) seam = has_pred ? same : 0u;
          else whole &= same;
          run.x = (cont & 1u) ? min(run.x, v[u].x) : v[u].x;
          run.y = (cont & 2u) ? min(run.y, v[u].y) : v[u].y;
          run.z = (cont & 4u) ? min(run.z, v[u].z) : v[u].z;
          run.w = (cont & 8u) ? min(run.w, v[u].w) : v[u].w;
          if ((run.x != v[u].x) | (run.y != v[u].y) | (run.z != v[u].z) |
              (run.w != v[u].w)) {
            *reinterpret_cast<int4*>(col + y * W) = run;
            chg = 1;
          }
          prevp = p[u];
        }
      }
    }
    const unsigned pass = whole & seam;
    *reinterpret_cast<uint4*>(sums + x) = make_uint4(
        ((unsigned)run.x << 1) | (pass & 1u),
        ((unsigned)run.y << 1) | ((pass >> 1) & 1u),
        ((unsigned)run.z << 1) | ((pass >> 2) & 1u),
        ((unsigned)run.w << 1) | ((pass >> 3) & 1u));
  }
}

// 3b. fold the summaries of the bands before this one into each column's
// incoming carry and apply it to the band's leading segment.
template <class Rule, bool kFwd>
__device__ __forceinline__ void col_apply_carry(cg::cluster_group& cluster,
                                                int* lab, const unsigned* bits,
                                                unsigned* sums, int R, int W,
                                                int wpr, bool has_pred,
                                                int& chg) {
  if (!has_pred) return;
  const int rank = (int)cluster.block_rank();
  for (int x = threadIdx.x; x < W; x += kThreads) {
    const unsigned* bcol = bits + (x >> 5);
    const int sh = x & 31;
    int* col = lab + x;
    unsigned prevp = (bcol[(kFwd ? -1 : R) * wpr] >> sh) & 1u;
    const unsigned p0 = (bcol[(kFwd ? 0 : R - 1) * wpr] >> sh) & 1u;
    if (!Rule::same(prevp, p0)) continue;
    // a set pass bit says that band has a predecessor, so k stays in range
    int k = kFwd ? rank - 1 : rank + 1;
    unsigned s = cluster.map_shared_rank(sums, k)[x];
    int c = (int)(s >> 1);
    while (s & 1u) {
      k += kFwd ? -1 : 1;
      s = cluster.map_shared_rank(sums, k)[x];
      c = min(c, (int)(s >> 1));
    }
    prevp = p0;
    for (int j = 0; j < R; ++j) {
      const int y = kFwd ? j : R - 1 - j;
      const unsigned p = (bcol[y * wpr] >> sh) & 1u;
      if (j > 0 && !Rule::same(prevp, p)) break;
      // values fall along a scanned segment: once the carry is no lower
      // than one of them it is no lower than the rest
      if (c >= col[y * W]) break;
      col[y * W] = c;
      chg = 1;
      prevp = p;
    }
  }
}

template <class Rule>
__global__ void __launch_bounds__(kThreads, 1) ccl_cluster_kernel(
    const uint8_t* __restrict__ phase,  // (B, H, W), nonzero = phase 1
    int32_t* __restrict__ labels,       // (B, H, W) result
    int32_t* __restrict__ iters,        // (B,) iterations run
    int H, int W, int max_iters) {
  cg::cluster_group cluster = cg::this_cluster();
  const int cs = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int img = blockIdx.x / cs;
  const int R = H / cs;  // rows of a band; the launcher checked H % cs == 0
  const int wpr = W / 32;
  const int npix = R * W;
  const int row0 = rank * R;
  const int tid = threadIdx.x;
  const int lane = tid & 31;

  extern __shared__ __align__(16) int smem[];
  int* const lab = smem + W;  // past the top halo row
  int* const lbuf = smem + (R + 2) * W;
  unsigned* const sum_f = reinterpret_cast<unsigned*>(lbuf + 2 * (W + 32));
  unsigned* const sum_r = sum_f + W;
  int* const my_chg = reinterpret_cast<int*>(sum_r + W);
  unsigned* const bits = reinterpret_cast<unsigned*>(my_chg + 4) + 1 + wpr;

  // phase bits of the band and of the rows just outside it, from device
  // memory, 16 pixels per thread and two threads per word; rows outside the
  // image are 0 and their labels 2^30
  const uint8_t* ph = phase + (size_t)img * H * W;
  const int nseg = (R + 2) * (W / 16);
  for (int base = 0; base < nseg; base += kThreads) {
    const int s = base + tid;
    const int y = row0 - 1 + s / (W / 16);
    const int x = (s % (W / 16)) * 16;
    uint4 q = make_uint4(0u, 0u, 0u, 0u);
    if (s < nseg && y >= 0 && y < H) {
      q = *reinterpret_cast<const uint4*>(ph + (size_t)y * W + x);
    }
    const unsigned half = nonzero_bytes(q.x) | (nonzero_bytes(q.y) << 4) |
                          (nonzero_bytes(q.z) << 8) |
                          (nonzero_bytes(q.w) << 12);
    const unsigned other = __shfl_down_sync(kFull, half, 1);
    if (s < nseg && !(lane & 1)) bits[(s >> 1) - wpr] = half | (other << 16);
  }
  if (tid == 0) {
    bits[-wpr - 1] = 0;
    bits[(R + 1) * wpr] = 0;
    *my_chg = 1;
  }
  __syncthreads();
  for (int i = tid - W; i < npix + W; i += kThreads) {
    const unsigned p = (bits[i >> 5] >> (i & 31)) & 1u;
    lab[i] = (i >= 0 && i < npix) ? Rule::init(p, row0 * W + i) : kBig;
  }

  const unsigned magic = kFull / (unsigned)wpr + 1;  // c / wpr by multiply
  const bool has_up = rank > 0, has_dn = rank < cs - 1;
  // A band's edge rows go into its neighbours' halo rows once they are
  // final: the neighbours read them in their next neighbour pass, after
  // the barrier at the loop's top, and are past their last one by now.
  auto push_edge_rows = [&]() {
    __syncthreads();
    for (int x = tid; x < W; x += kThreads) {
      if (has_up) cluster.map_shared_rank(lab, rank - 1)[npix + x] = lab[x];
      if (has_dn) {
        cluster.map_shared_rank(lab, rank + 1)[x - W] = lab[npix - W + x];
      }
    }
  };
  cluster.sync();  // every CTA of the cluster runs and has its halos set
  push_edge_rows();
  int it = 0;
  while (true) {
    cluster.sync();  // labels, halo rows and flags of the last iteration
    const int f = lane < cs ? *cluster.map_shared_rank(my_chg, lane) : 0;
    if (!__any_sync(kFull, f) || it >= max_iters) break;

    int chg = 0;
    neighbour_pass<Rule>(lab, bits, lbuf, W, wpr, npix, magic, chg);
    row_scans<Rule>(lab, bits, R, W, wpr, chg);
    __syncthreads();
    col_scan_band<Rule, true>(lab, bits, sum_f, R, W, wpr, has_up, chg);
    cluster.sync();
    col_apply_carry<Rule, true>(cluster, lab, bits, sum_f, R, W, wpr, has_up,
                                chg);
    // the carry went down one column per thread; the scan back up takes
    // four columns per thread
    __syncthreads();
    col_scan_band<Rule, false>(lab, bits, sum_r, R, W, wpr, has_dn, chg);
    cluster.sync();
    col_apply_carry<Rule, false>(cluster, lab, bits, sum_r, R, W, wpr, has_dn,
                                 chg);
    chg = __syncthreads_or(chg);
    if (tid == 0) *my_chg = chg;
    push_edge_rows();
    ++it;
  }

  int4* dst = reinterpret_cast<int4*>(labels + ((size_t)img * H + row0) * W);
  const int4* src = reinterpret_cast<const int4*>(lab);
  for (int i = tid; i < npix / 4; i += kThreads) dst[i] = src[i];
  if (rank == 0 && tid == 0) iters[img] = it;
  cluster.sync();  // no CTA leaves while another may read its flag or halo
}

// One row scan of the general route in the direction of kFwd: the warp
// takes 32 columns at a time, lane order is scan order.
template <class Rule, bool kFwd>
__device__ __forceinline__ void general_row_scan(int32_t* row,
                                                 const uint8_t* prow, int W,
                                                 int lane) {
  int carry = kBig;
  for (int q = 0; q < W; q += 32) {
    const int x = kFwd ? q + lane : W - 1 - q - lane;
    const int xp = kFwd ? x - 1 : x + 1;  // the pixel before x in scan order
    const bool cont = xp >= 0 && xp < W &&
                      Rule::same(prow[x] != 0, prow[xp] != 0);
    const int v =
        warp_seg_min(row[x], __ballot_sync(kFull, cont), lane, carry);
    row[x] = v;
    carry = __shfl_sync(kFull, v, 31);
  }
}

// One column scan of the general route in the direction of kFwd; the
// reverse one, the last pass of an iteration, also compares against the
// iteration-start labels ``before``.
template <class Rule, bool kFwd>
__device__ __forceinline__ void general_col_scan(int32_t* col,
                                                 const uint8_t* pcol,
                                                 const int32_t* before, int H,
                                                 int W, int& chg) {
  int run = kBig;
  unsigned prev = 0;
  for (int j = 0; j < H; ++j) {
    const size_t i = (size_t)(kFwd ? j : H - 1 - j) * W;
    const unsigned p = pcol[i] != 0;
    const int v = col[i];
    run = (j > 0 && Rule::same(p, prev)) ? min(run, v) : v;
    col[i] = run;
    if (!kFwd) chg |= run != before[i];
    prev = p;
  }
}

// The general route: one CTA per image, two label buffers in device memory.
template <class Rule>
__global__ void __launch_bounds__(kThreads) ccl_general_kernel(
    const uint8_t* __restrict__ phase,  // (B, H, W), nonzero = phase 1
    int32_t* labels,                    // (B, H, W) result
    int32_t* scratch,                   // (B, H, W) second buffer
    int32_t* iters,                     // (B,) iterations run
    int H, int W, int max_iters) {
  const int HW = H * W;  // < 2^30, checked by the launcher
  const uint8_t* ph = phase + (size_t)blockIdx.x * HW;
  int32_t* const out = labels + (size_t)blockIdx.x * HW;
  int32_t* cur = out;
  int32_t* nxt = scratch + (size_t)blockIdx.x * HW;
  const int tid = threadIdx.x;
  const int lane = tid & 31;

  for (int i = tid; i < HW; i += kThreads) cur[i] = Rule::init(ph[i] != 0, i);
  __syncthreads();

  int it = 0;
  int changed = 1;
  while (changed && it < max_iters) {
    // 1. neighbour pass on the iteration-start labels
    for (int i = tid; i < HW; i += kThreads) {
      const unsigned p = ph[i] != 0;
      int m = cur[i];
      if (!Rule::kOrthogonal || p) {
        const int y = i / W;
        const int x = i - y * W;
#pragma unroll
        for (int dy = -1; dy <= 1; ++dy) {
          if (y + dy < 0 || y + dy >= H) continue;
#pragma unroll
          for (int dx = -1; dx <= 1; ++dx) {
            if (x + dx < 0 || x + dx >= W) continue;
            if (!Rule::kOrthogonal && (dx == 0 || dy == 0)) continue;
            const int n = i + dy * W + dx;
            if (Rule::kOrthogonal || Rule::same(p, ph[n] != 0)) {
              m = min(m, cur[n]);
            }
          }
        }
      }
      nxt[i] = m;
    }
    __syncthreads();

    // 2. rows, forward then reverse: a warp per row
    for (int r = tid >> 5; r < H; r += kThreads / 32) {
      int32_t* row = nxt + (size_t)r * W;
      const uint8_t* prow = ph + (size_t)r * W;
      general_row_scan<Rule, true>(row, prow, W, lane);
      __syncwarp();
      general_row_scan<Rule, false>(row, prow, W, lane);
    }
    __syncthreads();

    // 3. columns, forward then reverse: a thread per column
    int chg = 0;
    for (int x = tid; x < W; x += kThreads) {
      general_col_scan<Rule, true>(nxt + x, ph + x, cur + x, H, W, chg);
      general_col_scan<Rule, false>(nxt + x, ph + x, cur + x, H, W, chg);
    }
    changed = __syncthreads_or(chg);
    int32_t* t = cur;
    cur = nxt;
    nxt = t;
    ++it;
  }
  if (cur != out) {
    for (int i = tid; i < HW; i += kThreads) out[i] = cur[i];
  }
  if (tid == 0) iters[blockIdx.x] = it;
}

// The launch configuration of ``clusters`` clusters of ``cs`` CTAs, after
// the kernel was allowed its dynamic shared memory.
struct ClusterLaunch {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
};

template <class Rule>
inline cudaError_t prepare_cluster_launch(ClusterLaunch* l, int clusters,
                                          int cs, int smem_bytes,
                                          cudaStream_t stream) {
  l->cfg = cudaLaunchConfig_t{};
  l->cfg.gridDim = dim3((unsigned)clusters * cs, 1, 1);
  l->cfg.blockDim = dim3(kThreads, 1, 1);
  l->cfg.dynamicSmemBytes = (size_t)smem_bytes;
  l->cfg.stream = stream;
  l->attr[0].id = cudaLaunchAttributeClusterDimension;
  l->attr[0].val.clusterDim.x = (unsigned)cs;
  l->attr[0].val.clusterDim.y = 1;
  l->attr[0].val.clusterDim.z = 1;
  l->cfg.attrs = l->attr;
  l->cfg.numAttrs = 1;
  return cudaFuncSetAttribute(ccl_cluster_kernel<Rule>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              smem_bytes);
}

// Launch the cluster route: B clusters of ``cs`` CTAs.
template <class Rule>
inline cudaError_t launch_cluster(const uint8_t* phase, int32_t* labels,
                                  int32_t* iters, int B, int H, int W,
                                  int max_iters, int cs, int smem_bytes,
                                  cudaStream_t stream) {
  // the kernel moves 16 bytes at a time
  if (reinterpret_cast<uintptr_t>(phase) % 16 ||
      reinterpret_cast<uintptr_t>(labels) % 16) {
    return cudaErrorMisalignedAddress;
  }
  ClusterLaunch l;
  cudaError_t st = prepare_cluster_launch<Rule>(&l, B, cs, smem_bytes, stream);
  if (st != cudaSuccess) return st;
  st = cudaLaunchKernelEx(&l.cfg, ccl_cluster_kernel<Rule>, phase, labels,
                          iters, H, W, max_iters);
  if (st != cudaSuccess) return st;
  return cudaGetLastError();
}

// How many clusters of this route the card runs at once (for reports).
template <class Rule>
inline cudaError_t active_clusters(int cs, int smem_bytes, int* out) {
  ClusterLaunch l;
  const cudaError_t st =
      prepare_cluster_launch<Rule>(&l, 1, cs, smem_bytes, nullptr);
  if (st != cudaSuccess) return st;
  return cudaOccupancyMaxActiveClusters(out, ccl_cluster_kernel<Rule>, &l.cfg);
}

// The route an (H, W) image takes on the current card: *cluster is the
// cluster size (0: the general route), *smem_bytes the shared memory of one
// CTA, *active how many such clusters the card runs at once.
template <class Rule>
inline int route(int H, int W, int* cluster, int* smem_bytes, int* active) {
  int max_smem = 0;
  const int st = max_optin_smem(&max_smem);
  if (st != 0) return st;
  *active = 0;
  *cluster = ccl_route(H, W, max_smem, smem_bytes);
  if (*cluster == 0) return 0;
  return (int)active_clusters<Rule>(*cluster, *smem_bytes, active);
}

// Label B images.  ``scratch`` (a second (B, H, W) label buffer) is read on
// the general route only and may be null on the cluster route.
template <class Rule>
inline int label(const uint8_t* phase, int32_t* labels, int32_t* scratch,
                 int32_t* iters, int B, int H, int W, int max_iters,
                 cudaStream_t stream) {
  // a label is a linear index below 2^30
  if (W % 32 != 0 || (long long)H * W >= (long long)kBig) {
    return (int)cudaErrorInvalidValue;
  }
  if (B <= 0) return 0;
  int max_smem = 0, smem_bytes = 0;
  const int st = max_optin_smem(&max_smem);
  if (st != 0) return st;
  const int cs = ccl_route(H, W, max_smem, &smem_bytes);
  if (cs > 0) {
    return (int)launch_cluster<Rule>(phase, labels, iters, B, H, W, max_iters,
                                     cs, smem_bytes, stream);
  }
  if (scratch == nullptr) return (int)cudaErrorInvalidValue;
  ccl_general_kernel<Rule><<<B, kThreads, 0, stream>>>(
      phase, labels, scratch, iters, H, W, max_iters);
  return (int)cudaGetLastError();
}

}  // namespace ccl
