// Shared response stage of the DoH kernels K1 (doh_select.cu) and K4
// (doh_score_map.cu): the separable Gaussian-derivative correlations and
// the scale max of the determinant-of-Hessian response over one tile of
// kTR image rows x tile_cols(halo) columns plus a ring of one row/column on
// each side (the 3x3 NMS ring and the sub-pixel neighbours).
//
// Register-blocked, so that FP32 issue and not shared memory sets the pace:
//  * vertical pass: thread t owns column t of the tile's kVW plane columns.
//    It loads a chunk of kChunk + 2R image samples of its column into
//    registers once (edge-clamped global loads, L1-cached: the clamp is the
//    edge padding of imagestitch_tpu/ops/pallas/doh.py:278-279, :331-332)
//    and every tap of the three vertical correlations reads them from
//    there; the three planes go to shared memory;
//  * horizontal pass: each thread owns kSeg consecutive outputs of one ring
//    row (a warp covers a row), loads the kSeg + 2R plane values they need
//    once per plane and runs the taps out of registers.  Plane columns are
//    stored with one spare float every kSeg columns (pcol), so the 32 lanes
//    of a warp, kSeg columns apart, read 32 different banks;
//  * the scale max of the response stays in registers across scales and is
//    written once, into the same shared memory (read by the epilogues).
// Radii are template arguments (kMinRadius..kMaxRadius), so every tap loop
// unrolls and the register windows are indexed at compile time.
//
// Products and sums use __fmul_rn/__fadd_rn in the order of the plain
// PyTorch version (ops/kernels/doh.py _response_ring): per output, the
// product with tap 0, then each further product added in tap order.  The
// compiler cannot contract them into FMAs, so the kernels agree with it bit
// for bit.  With the separate multiply and add, the FP32 issue rate is half
// the card's FMA peak: that half is this stage's ceiling.
#pragma once
#include <cuda_runtime.h>

namespace doh {

constexpr int kThreads = 256;          // threads per block
constexpr int kVW = kThreads;          // vertical-pass columns per tile
constexpr int kRR = 16;                // ring rows per tile
constexpr int kTR = kRR - 2;           // image rows per tile
constexpr int kMinBlocks = 3;          // blocks per SM (80 registers)
constexpr int kChunk = 8;              // vertical rows per register block
constexpr int kSeg = 8;                // horizontal outputs per thread item
constexpr int kSegs = kVW / kSeg;      // items per ring row (one warp)
constexpr int kMaxScales = 4;
constexpr int kMinRadius = 2;
constexpr int kMaxRadius = 10;
constexpr int kMaxTaps = 2 * kMaxRadius + 1;
constexpr int kTapFloats = kMaxScales * 3 * kMaxTaps;

static_assert(kSegs == 32, "a warp covers one ring row");
static_assert(kRR % kChunk == 0, "whole vertical chunks");

// padded shared-memory column of plane column c
__host__ __device__ constexpr int pcol(int c) { return c + c / kSeg; }
// plane row stride: the horizontal pass reads up to column kVW + kSeg - 2
constexpr int kPW = pcol(kVW + kSeg - 1) + 1;

// output columns of a tile: the kVW plane columns less the ring and the
// largest radius on each side
__host__ __device__ constexpr int tile_cols(int halo) {
  return kVW - 2 - 2 * halo;
}

struct DohParams {
  int n_scales;
  int halo;                            // largest radius
  int radius[kMaxScales];
  float s4[kMaxScales];                // sigma^4 per scale
  float taps[kTapFloats];              // [scale][g, dg, ddg][tap]
};

// shared memory of the stage: the tap tables, then three planes of kRR x
// kPW floats (the response ring reuses the first kRR x kPW of them)
constexpr int kSmemFloats = kTapFloats + 3 * kRR * kPW;

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// Fill the kernel parameters from the host tap tables; returns the halo
// (largest radius) or -1 for an invalid table.
inline int fill_params(DohParams& p, int n_scales, const int* radii,
                       const float* s4, const float* taps) {
  if (n_scales < 1 || n_scales > kMaxScales) return -1;
  p = DohParams{};
  p.n_scales = n_scales;
  int halo = 0;
  for (int s = 0; s < n_scales; ++s) {
    if (radii[s] < kMinRadius || radii[s] > kMaxRadius) return -1;
    p.radius[s] = radii[s];
    p.s4[s] = s4[s];
    halo = radii[s] > halo ? radii[s] : halo;
  }
  for (int e = 0; e < n_scales * 3 * kMaxTaps; ++e) p.taps[e] = taps[e];
  p.halo = halo;
  return halo;
}

// Vertical correlations for ring rows r0-1 .. r0-1+kRR-1 at radius R:
// plane 0 with g, plane 1 with ddg, plane 2 with dg.  Plane column t (this
// thread's) is image column c0 - 1 - R + t, so that each scale's
// horizontal taps start at plane column kSeg * seg.
template <int R>
__device__ __forceinline__ void vertical(const float* __restrict__ band,
                                         int pitch, int h, int w, int r0,
                                         int c0, const float* __restrict__ tp,
                                         float* planes) {
  constexpr int NT = 2 * R + 1, NX = kChunk + 2 * R;
  const float* g = tp;
  const float* dg = tp + kMaxTaps;
  const float* ddg = tp + 2 * kMaxTaps;
  const int gc = clampi(c0 - 1 - R + (int)threadIdx.x, 0, w - 1);
  const int pc = pcol(threadIdx.x);
#pragma unroll 1     // one copy of the chunk's code: the body is unrolled
  for (int ch = 0; ch < kRR; ch += kChunk) {
    float x[NX];
#pragma unroll
    for (int m = 0; m < NX; ++m)
      x[m] = __ldg(band + (size_t)clampi(r0 - 1 - R + ch + m, 0, h - 1) *
                              pitch + gc);
    float a[kChunk], b[kChunk], c[kChunk];
    {
      const float g0 = g[0], dd0 = ddg[0], d0 = dg[0];
#pragma unroll
      for (int i = 0; i < kChunk; ++i) {
        a[i] = __fmul_rn(x[i], g0);
        b[i] = __fmul_rn(x[i], dd0);
        c[i] = __fmul_rn(x[i], d0);
      }
    }
#pragma unroll
    for (int t = 1; t < NT; ++t) {
      const float gt = g[t], ddt = ddg[t], dt = dg[t];
#pragma unroll
      for (int i = 0; i < kChunk; ++i) {
        a[i] = __fadd_rn(a[i], __fmul_rn(x[i + t], gt));
        b[i] = __fadd_rn(b[i], __fmul_rn(x[i + t], ddt));
        c[i] = __fadd_rn(c[i], __fmul_rn(x[i + t], dt));
      }
    }
#pragma unroll
    for (int i = 0; i < kChunk; ++i) {
      planes[(0 * kRR + ch + i) * kPW + pc] = a[i];
      planes[(1 * kRR + ch + i) * kPW + pc] = b[i];
      planes[(2 * kRR + ch + i) * kPW + pc] = c[i];
    }
  }
}

// One plane row's horizontal correlation at radius R for the kSeg outputs
// whose tap 0 sits at plane column kSeg * seg (``seg_row`` = row + pcol(kSeg
// * seg), so every load has a constant offset).
template <int R>
__device__ __forceinline__ void horiz_row(const float* seg_row,
                                          const float* __restrict__ k,
                                          float (&out)[kSeg]) {
  constexpr int NT = 2 * R + 1, NX = kSeg + 2 * R;
  float y[NX];
#pragma unroll
  for (int m = 0; m < NX; ++m) y[m] = seg_row[pcol(m)];
  const float k0 = k[0];
#pragma unroll
  for (int j = 0; j < kSeg; ++j) out[j] = __fmul_rn(y[j], k0);
#pragma unroll
  for (int t = 1; t < NT; ++t) {
    const float kt = k[t];
#pragma unroll
    for (int j = 0; j < kSeg; ++j)
      out[j] = __fadd_rn(out[j], __fmul_rn(y[j + t], kt));
  }
}

// Horizontal correlations, determinant and scale max of one item: ring row
// ``i``, outputs kSeg * seg .. kSeg * seg + kSeg - 1.
template <int R>
__device__ __forceinline__ void horizontal(const float* planes, int i,
                                           int seg,
                                           const float* __restrict__ tp,
                                           float s4, bool first,
                                           float (&rmax)[kSeg]) {
  const float* base = planes + i * kPW + pcol(seg * kSeg);
  const float* g = tp;
  const float* dg = tp + kMaxTaps;
  const float* ddg = tp + 2 * kMaxTaps;
  float xx[kSeg], v[kSeg];
  horiz_row<R>(base, ddg, xx);
  horiz_row<R>(base + kRR * kPW, g, v);
#pragma unroll
  for (int j = 0; j < kSeg; ++j) xx[j] = __fmul_rn(xx[j], v[j]);  // xx*yy
  horiz_row<R>(base + 2 * kRR * kPW, dg, v);
#pragma unroll
  for (int j = 0; j < kSeg; ++j) {
    float r = __fmul_rn(s4, __fsub_rn(xx[j], __fmul_rn(v[j], v[j])));
    rmax[j] = first ? r : fmaxf(rmax[j], r);
  }
}

#define DOH_RADIUS_CASES(CALL) \
  switch (radius) {            \
    case 2: CALL(2); break;    \
    case 3: CALL(3); break;    \
    case 4: CALL(4); break;    \
    case 5: CALL(5); break;    \
    case 6: CALL(6); break;    \
    case 7: CALL(7); break;    \
    case 8: CALL(8); break;    \
    case 9: CALL(9); break;    \
    default: CALL(10); break;  \
  }

// Scale-max DoH response on ring rows r0-1 .. r0+kTR and ring columns
// c0-1 .. c0+tile_cols(halo) of the (h, w) image at ``band`` (row stride
// ``pitch``), into ``smem`` (kSmemFloats floats).  Read it back with
// resp_at(smem, ri, rj), ring row ri and ring column rj counted from the
// tile's ring origin.  Called by all kThreads threads; ends with
// __syncthreads().
__device__ inline void response_tile(const float* __restrict__ band,
                                     int pitch, int h, int w, int r0, int c0,
                                     const DohParams& p, float* smem) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int halo = p.halo;
  float* s_taps = smem;
  float* planes = smem + kTapFloats;
  for (int e = tid; e < p.n_scales * 3 * kMaxTaps; e += kThreads)
    s_taps[e] = p.taps[e];
  __syncthreads();

  // horizontal items: ring rows warp and warp + 8, outputs from kSeg * lane;
  // outputs past the ring (tile_cols + 2) are not computed
  const bool live = lane * kSeg < tile_cols(halo) + 2;
  float rmax[2][kSeg];

  for (int s = 0; s < p.n_scales; ++s) {
    const int radius = p.radius[s];
    const float* tp = s_taps + s * 3 * kMaxTaps;
#define DOH_VERTICAL(R) vertical<R>(band, pitch, h, w, r0, c0, tp, planes)
    DOH_RADIUS_CASES(DOH_VERTICAL)
#undef DOH_VERTICAL
    __syncthreads();
    if (live) {
      const float s4 = p.s4[s];
#define DOH_HORIZONTAL(R)                                                 \
  horizontal<R>(planes, warp, lane, tp, s4, s == 0, rmax[0]);             \
  horizontal<R>(planes, warp + 8, lane, tp, s4, s == 0, rmax[1])
      DOH_RADIUS_CASES(DOH_HORIZONTAL)
#undef DOH_HORIZONTAL
    }
    __syncthreads();
  }
  if (live) {
#pragma unroll
    for (int u = 0; u < 2; ++u)
#pragma unroll
      for (int j = 0; j < kSeg; ++j)
        planes[(warp + 8 * u) * kPW + pcol(lane * kSeg + j)] = rmax[u][j];
  }
  __syncthreads();
}

static_assert(kRR == 2 * (kThreads / 32), "two ring rows per warp");

// the response at ring row ri, ring column rj of the last response_tile
__device__ __forceinline__ float resp_at(const float* smem, int ri, int rj) {
  return smem[kTapFloats + ri * kPW + pcol(rj)];
}

// NMS score of tile pixel (i, j), image pixel (gr, gc): the response where
// it is >= its 8 neighbours, inside the border and above the threshold,
// else 0.
__device__ __forceinline__ float nms_score(const float* smem, int i, int j,
                                           int gr, int gc, int h, int w,
                                           int border, float threshold) {
  const float* q = smem + kTapFloats;
  const int c0 = pcol(j), c1 = pcol(j + 1), c2 = pcol(j + 2);
  const float* up = q + i * kPW;
  const float* mid = up + kPW;
  const float* dn = mid + kPW;
  float cen = mid[c1];
  float m = fmaxf(fmaxf(fmaxf(up[c0], up[c1]), fmaxf(up[c2], mid[c0])),
                  fmaxf(fmaxf(mid[c2], dn[c0]), fmaxf(dn[c1], dn[c2])));
  bool inside = gr >= border && gr < h - border &&
                gc >= border && gc < w - border;
  return (cen >= m && inside && cen > threshold) ? cen : 0.0f;
}

// Set the dynamic shared-memory limit of ``kernel`` when it needs more than
// the default 48 KB.
template <typename K>
inline cudaError_t allow_smem(K kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

}  // namespace doh
