// K4: fused multi-scale determinant-of-Hessian + 3x3 NMS + border +
// threshold, written as a full score map plus the raw scale-max response.
//
// Replaces imagestitch_tpu/ops/pallas/doh.py::doh_score_map (the Pallas call
// at doh.py:337, kernel body _make_kernel at doh.py:57).
//
// What bounds it on an H100: as for K1 (doh_select.cu), the correlations,
// not device memory.  It reads a 5 MP octave-0 frame once (20 MB) and
// writes two maps of the same size (40 MB), about 20 us of HBM time at
// 3.35 TB/s, against ~400 flops a pixel done as separate rounded multiplies
// and adds out of shared memory.
//
// Design: the response stage is K1's (doh_common.cuh): edge-clamped tile
// loads, row correlations into shared memory, column correlations and the
// scale max over the tile plus its one-pixel ring.  There is no per-row
// selection, so unlike K1 every (8-row, 128-column) tile is its own block
// (a 2-D grid: 5,082 blocks at octave 0 rather than 242), and each thread
// writes the NMS score and the raw response of its pixels straight out,
// coalesced along the row.  The NMS ring reads responses of the
// edge-padded image, as the Pallas kernel does (doh.py:327-332, :83-100).
// Products and sums follow the plain version's order without FMA
// contraction, so score and raw are bit-equal to
// ops/kernels/doh.py::doh_score_map_plain.
#include <cuda_runtime.h>

#include "doh_common.cuh"

namespace {

using doh::DohParams;
using doh::kRC;
using doh::kTC;
using doh::kThreads;
using doh::kTR;

__global__ void __launch_bounds__(kThreads)
doh_score_map_kernel(const float* __restrict__ img, int h, int w,
                     float threshold, int border, int halo, DohParams p,
                     float* __restrict__ out_score,
                     float* __restrict__ out_raw) {
  extern __shared__ float smem[];
  float* stage = smem;                                 // doh::stage_floats
  float* s_resp = stage + doh::stage_floats(halo);     // (kTR+2) x kRC
  const int r0 = blockIdx.y * kTR, c0 = blockIdx.x * kTC;

  doh::response_tile(img, h, w, r0, c0, halo, p, stage, s_resp);

  for (int e = threadIdx.x; e < kTR * kTC; e += kThreads) {
    int i = e / kTC, j = e - i * kTC;
    int gr = r0 + i, gc = c0 + j;
    if (gr < h && gc < w) {
      const float* q = s_resp + (i + 1) * kRC + (j + 1);
      size_t o = (size_t)gr * w + gc;
      out_score[o] = doh::nms_score(q, gr, gc, h, w, border, threshold);
      out_raw[o] = q[0];
    }
  }
}

}  // namespace

extern "C" int doh_score_map_launch(const float* img, int h, int w,
                                    float threshold, int border, int n_scales,
                                    const int* radii, const float* s4,
                                    const float* taps, float* score,
                                    float* raw, void* stream) {
  DohParams p;
  int halo = doh::fill_params(p, n_scales, radii, s4, taps);
  if (h < 1 || w < 1 || halo < 0) return (int)cudaErrorInvalidValue;
  size_t smem = sizeof(float) * ((size_t)doh::stage_floats(halo) +
                                 (kTR + 2) * kRC);
  cudaError_t e = doh::allow_smem(doh_score_map_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((w + kTC - 1) / kTC, (h + kTR - 1) / kTR);
  doh_score_map_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      img, h, w, threshold, border, halo, p, score, raw);
  return (int)cudaGetLastError();
}
