// Shared stage of the DoH kernels K1 (doh_select.cu) and K4
// (doh_score_map.cu): the edge-clamped input tile, the separable Gaussian
// -derivative correlations and the scale max of the determinant-of-Hessian
// response, for one tile of kTR image rows x kTC columns plus a ring of one
// row/column on each side (the 3x3 NMS ring and the sub-pixel neighbours).
//
// Clamped loads are the edge padding of imagestitch_tpu/ops/pallas/doh.py
// (:278-279 and :331-332), so the ring at image edges holds responses of the
// edge-padded image, never -inf.  Products and sums use __fmul_rn/__fadd_rn
// in the order of the plain PyTorch version (ops/kernels/doh.py
// _response_ring), so the compiler cannot contract them into FMAs and the
// kernels agree with it bit for bit.
#pragma once
#include <cuda_runtime.h>

namespace doh {

constexpr int kTR = 8;                 // image rows per tile
constexpr int kTC = 128;               // columns per tile
constexpr int kThreads = kTR * 32;
constexpr int kMaxScales = 4;
constexpr int kMaxRadius = 10;
constexpr int kMaxTaps = 2 * kMaxRadius + 1;
constexpr int kRC = kTC + 2;           // response tile width (with the ring)

struct DohParams {
  int n_scales;
  int radius[kMaxScales];
  float s4[kMaxScales];                // sigma^4 per scale
  float g[kMaxScales][kMaxTaps];       // Gaussian
  float dg[kMaxScales][kMaxTaps];      // first derivative
  float ddg[kMaxScales][kMaxTaps];     // second derivative
};

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// floats of shared memory the response stage needs, excluding the response
// tile itself: the input tile and the three row-correlation planes
__host__ __device__ inline int stage_floats(int halo) {
  const int in_rows = kTR + 2 + 2 * halo, in_cols = kTC + 2 + 2 * halo;
  return in_rows * in_cols + 3 * (kTR + 2) * in_cols;
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
    if (radii[s] < 1 || radii[s] > kMaxRadius) return -1;
    p.radius[s] = radii[s];
    p.s4[s] = s4[s];
    halo = radii[s] > halo ? radii[s] : halo;
    for (int t = 0; t < kMaxTaps; ++t) {
      p.g[s][t] = taps[(s * 3 + 0) * kMaxTaps + t];
      p.dg[s][t] = taps[(s * 3 + 1) * kMaxTaps + t];
      p.ddg[s][t] = taps[(s * 3 + 2) * kMaxTaps + t];
    }
  }
  return halo;
}

// Scale-max DoH response on image rows r0-1 .. r0+kTR and columns
// c0-1 .. c0+kTC into s_resp ((kTR+2) x kRC, row-major).  ``stage`` holds
// stage_floats(halo) floats.  Called by all kThreads threads of the block;
// ends with __syncthreads().
__device__ inline void response_tile(const float* __restrict__ img, int h,
                                     int w, int r0, int c0, int halo,
                                     const DohParams& p, float* stage,
                                     float* s_resp) {
  const int tid = threadIdx.x;
  const int in_rows = kTR + 2 + 2 * halo;
  const int in_cols = kTC + 2 + 2 * halo;
  float* s_in = stage;                                 // in_rows x in_cols
  float* s_l = s_in + in_rows * in_cols;               // 3 x (kTR+2) x in_cols

  // stage image rows r0-1-halo.., cols c0-1-halo.. (edge-clamped)
  for (int e = tid; e < in_rows * in_cols; e += kThreads) {
    int i = e / in_cols, j = e - i * in_cols;
    int gr = clampi(r0 - 1 - halo + i, 0, h - 1);
    int gc = clampi(c0 - 1 - halo + j, 0, w - 1);
    s_in[e] = img[(size_t)gr * w + gc];
  }
  __syncthreads();

  for (int s = 0; s < p.n_scales; ++s) {
    const int rs = p.radius[s], nt = 2 * rs + 1, off = halo - rs;
    const int l_cols = kTC + 2 + 2 * rs;
    // row correlations: lxx_r (g), lyy_r (ddg), lxy_r (dg)
    for (int e = tid; e < (kTR + 2) * l_cols; e += kThreads) {
      int i = e / l_cols, jj = e - i * l_cols;
      const float* src = s_in + (i + off) * in_cols + jj + off;
      float v = src[0];
      float a = __fmul_rn(v, p.g[s][0]);
      float b = __fmul_rn(v, p.ddg[s][0]);
      float c = __fmul_rn(v, p.dg[s][0]);
      for (int t = 1; t < nt; ++t) {
        v = src[t * in_cols];
        a = __fadd_rn(a, __fmul_rn(v, p.g[s][t]));
        b = __fadd_rn(b, __fmul_rn(v, p.ddg[s][t]));
        c = __fadd_rn(c, __fmul_rn(v, p.dg[s][t]));
      }
      s_l[(0 * (kTR + 2) + i) * in_cols + jj] = a;
      s_l[(1 * (kTR + 2) + i) * in_cols + jj] = b;
      s_l[(2 * (kTR + 2) + i) * in_cols + jj] = c;
    }
    __syncthreads();
    // column correlations -> DoH -> scale max
    for (int e = tid; e < (kTR + 2) * kRC; e += kThreads) {
      int i = e / kRC, j = e - i * kRC;
      const float* la = s_l + (0 * (kTR + 2) + i) * in_cols + j;
      const float* lb = s_l + (1 * (kTR + 2) + i) * in_cols + j;
      const float* lc = s_l + (2 * (kTR + 2) + i) * in_cols + j;
      float xx = __fmul_rn(la[0], p.ddg[s][0]);
      float yy = __fmul_rn(lb[0], p.g[s][0]);
      float xy = __fmul_rn(lc[0], p.dg[s][0]);
      for (int t = 1; t < nt; ++t) {
        xx = __fadd_rn(xx, __fmul_rn(la[t], p.ddg[s][t]));
        yy = __fadd_rn(yy, __fmul_rn(lb[t], p.g[s][t]));
        xy = __fadd_rn(xy, __fmul_rn(lc[t], p.dg[s][t]));
      }
      float r = __fmul_rn(p.s4[s],
                          __fsub_rn(__fmul_rn(xx, yy), __fmul_rn(xy, xy)));
      s_resp[e] = (s == 0) ? r : fmaxf(s_resp[e], r);
    }
    __syncthreads();
  }
}

// NMS score of the tile pixel whose response sits at q = s_resp + (i+1)*kRC
// + (j+1): the response where it is >= its 8 neighbours, inside the border
// and above the threshold, else 0.
__device__ __forceinline__ float nms_score(const float* q, int gr, int gc,
                                           int h, int w, int border,
                                           float threshold) {
  float cen = q[0];
  float m = fmaxf(fmaxf(fmaxf(q[-kRC - 1], q[-kRC]), fmaxf(q[-kRC + 1], q[-1])),
                  fmaxf(fmaxf(q[1], q[kRC - 1]), fmaxf(q[kRC], q[kRC + 1])));
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
