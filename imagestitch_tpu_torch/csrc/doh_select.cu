// K1: fused multi-scale determinant-of-Hessian + 3x3 NMS + sub-pixel +
// per-row top-R candidate selection.
//
// Replaces imagestitch_tpu/ops/pallas/doh.py::doh_select (the Pallas call at
// doh.py:285, kernel body _make_select_kernel at doh.py:143).
//
// What bounds it on an H100: not device memory.  A 5 MP octave-0 frame is
// read once (20 MB) and only H x R candidates are written, while each pixel
// costs 6 separable correlations of 9-13 taps per scale (~400 flops).  Every
// tap is a shared-memory read plus a separate multiply and add, and one
// block per 8 image rows leaves few blocks per SM, so shared-memory reads,
// instruction issue and occupancy set its speed, far below the FP32 peak.
// The TPU version turned the correlations into banded (Toeplitz) MXU
// matmuls over 128-lane column tiles; Hopper has no layout rule that needs
// this, so here they are direct FP32 correlations out of shared memory.
//
// Design:
//  * one block of 8 warps owns 8 image rows over the full width, walking
//    the width in 128-column chunks (a 2584-wide row of 8 + halo rows would
//    not fit in shared memory);
//  * per chunk the block runs the response stage shared with K4
//    (doh_common.cuh): it stages the edge-clamped input tile once (clamped
//    indices are the edge padding of doh.py:278-279), runs the row
//    correlations into shared memory, then the column correlations, and
//    keeps the scale max of the response on rows/cols -1..+1 beyond the
//    chunk, so the NMS ring and the sub-pixel neighbours read responses of
//    the edge-padded image exactly as the Pallas kernel does;
//  * each warp owns one row: it takes the chunk's top-R NMS survivors by
//    (score desc, column asc) with warp shuffles, computes their sub-pixel
//    offsets from the raw response, and merges them into the row's running
//    top-R (earlier chunks have lower columns, so ties keep the running
//    entry: the first-lane tie-break of the Pallas kernel).
// Products and sums use __fmul_rn/__fadd_rn in the order of the plain
// PyTorch version (ops/kernels/doh.py::doh_select_plain), so the compiler
// cannot contract them into FMAs and the two agree bit for bit.
#include <cuda_runtime.h>
#include <climits>

#include "doh_common.cuh"

namespace {

using doh::DohParams;
using doh::kRC;
using doh::kTC;
using doh::kThreads;
using doh::kTR;
constexpr int kMaxCands = 8;
constexpr unsigned kFull = 0xffffffffu;

// strict (score desc, column asc) order
__device__ __forceinline__ bool better(float sa, int ca, float sb, int cb) {
  return sa > sb || (sa == sb && ca < cb);
}

// parabola-vertex offset, exact refine_subpixel arithmetic
__device__ __forceinline__ float axis_off(float m, float p, float c) {
  float den = __fmul_rn(2.0f, __fsub_rn(__fadd_rn(m, p), __fmul_rn(2.0f, c)));
  float off = fabsf(den) > 1e-12f ? __fdiv_rn(__fsub_rn(m, p), den) : 0.0f;
  return fminf(fmaxf(off, -0.5f), 0.5f);
}

__global__ void __launch_bounds__(kThreads)
doh_select_kernel(const float* __restrict__ img, int h, int w, int r_cands,
                  float threshold, int border, int halo, DohParams p,
                  float* __restrict__ out_sc, int* __restrict__ out_col,
                  float* __restrict__ out_dr, float* __restrict__ out_dc) {
  extern __shared__ float smem[];
  float* stage = smem;                                 // doh::stage_floats
  float* s_resp = stage + doh::stage_floats(halo);     // (kTR+2) x kRC
  float* s_sc = s_resp + (kTR + 2) * kRC;              // kTR x kTC

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int r0 = blockIdx.x * kTR;
  const int row = r0 + warp;

  // this warp's running top-R for its row (identical in every lane)
  float best_s[kMaxCands], best_dr[kMaxCands], best_dc[kMaxCands];
  int best_c[kMaxCands];
  int n_best = 0;

  for (int c0 = 0; c0 < w; c0 += kTC) {
    doh::response_tile(img, h, w, r0, c0, halo, p, stage, s_resp);

    // NMS (center >= its 8 neighbours), border, threshold
    for (int e = tid; e < kTR * kTC; e += kThreads) {
      int i = e / kTC, j = e - i * kTC;
      int gr = r0 + i, gc = c0 + j;
      float sc = 0.0f;
      if (gr < h && gc < w)
        sc = doh::nms_score(s_resp + (i + 1) * kRC + (j + 1), gr, gc, h, w,
                            border, threshold);
      s_sc[e] = sc;
    }
    __syncthreads();

    if (row < h) {
      float* srow = s_sc + warp * kTC;
      float cs[kMaxCands], cdr[kMaxCands], cdc[kMaxCands];
      int cc[kMaxCands];
      int nc = 0;
      for (int t = 0; t < r_cands; ++t) {
        float bs = 0.0f;
        int bc = INT_MAX;
        for (int j = lane; j < kTC; j += 32) {
          float v = srow[j];
          if (v > 0.0f && better(v, j, bs, bc)) { bs = v; bc = j; }
        }
        for (int o = 16; o > 0; o >>= 1) {
          float os = __shfl_xor_sync(kFull, bs, o);
          int oc = __shfl_xor_sync(kFull, bc, o);
          if (better(os, oc, bs, bc)) { bs = os; bc = oc; }
        }
        if (!(bs > 0.0f)) break;                       // warp-uniform
        const float* q = s_resp + (warp + 1) * kRC + (bc + 1);
        cs[nc] = bs;
        cc[nc] = c0 + bc;
        cdr[nc] = axis_off(q[-kRC], q[kRC], q[0]);
        cdc[nc] = axis_off(q[-1], q[1], q[0]);
        ++nc;
        if (lane == (bc & 31)) srow[bc] = 0.0f;        // the owning lane
        __syncwarp();
      }
      // merge running (lower columns) and chunk lists, keep the top r_cands
      float ns[kMaxCands], ndr[kMaxCands], ndc[kMaxCands];
      int ncol[kMaxCands];
      int a = 0, b = 0, n = 0;
      while (n < r_cands && (a < n_best || b < nc)) {
        bool take_a = (b >= nc) || (a < n_best && best_s[a] >= cs[b]);
        if (take_a) {
          ns[n] = best_s[a]; ncol[n] = best_c[a];
          ndr[n] = best_dr[a]; ndc[n] = best_dc[a]; ++a;
        } else {
          ns[n] = cs[b]; ncol[n] = cc[b]; ndr[n] = cdr[b]; ndc[n] = cdc[b]; ++b;
        }
        ++n;
      }
      for (int k = 0; k < n; ++k) {
        best_s[k] = ns[k]; best_c[k] = ncol[k];
        best_dr[k] = ndr[k]; best_dc[k] = ndc[k];
      }
      n_best = n;
    }
    __syncthreads();                                   // smem reused next chunk
  }

  if (row < h && lane == 0) {
    for (int k = 0; k < r_cands; ++k) {
      size_t o = (size_t)row * r_cands + k;
      bool live = k < n_best;
      out_sc[o] = live ? best_s[k] : 0.0f;
      out_col[o] = live ? best_c[k] : 0;
      out_dr[o] = live ? best_dr[k] : 0.0f;
      out_dc[o] = live ? best_dc[k] : 0.0f;
    }
  }
}

}  // namespace

extern "C" int doh_select_launch(const float* img, int h, int w, int r_cands,
                                 float threshold, int border, int n_scales,
                                 const int* radii, const float* s4,
                                 const float* taps, float* sc, int* col,
                                 float* dr, float* dc, void* stream) {
  DohParams p;
  int halo = doh::fill_params(p, n_scales, radii, s4, taps);
  if (h < 1 || w < 1 || halo < 0 || r_cands < 1 || r_cands > kMaxCands)
    return (int)cudaErrorInvalidValue;
  size_t smem = sizeof(float) * ((size_t)doh::stage_floats(halo) +
                                 (kTR + 2) * kRC + kTR * kTC);
  cudaError_t e = doh::allow_smem(doh_select_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((h + kTR - 1) / kTR);
  doh_select_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      img, h, w, r_cands, threshold, border, halo, p, sc, col, dr, dc);
  return (int)cudaGetLastError();
}
