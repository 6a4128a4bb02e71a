// K4: fused multi-scale determinant-of-Hessian + 3x3 NMS + border +
// threshold, written as a full score map plus the raw scale-max response.
//
// Replaces imagestitch_tpu/ops/pallas/doh.py::doh_score_map (the Pallas call
// at doh.py:337, kernel body _make_kernel at doh.py:57).
//
// What bounds it on an H100: as for K1 (doh_select.cu), the correlations'
// FP32 instruction issue, not device memory.  It reads a 5 MP octave-0
// frame once (20 MB) and writes two maps of the same size (40 MB), about
// 20 us of HBM time at 3.35 TB/s, against 402 operations a pixel done as
// separate rounded multiplies and adds.
//
// Design: the response stage is K1's (doh_common.cuh): register-blocked
// vertical and horizontal correlations and the scale max over a tile of
// kTR rows x tile_cols(halo) columns plus its one-pixel ring.  There is no
// per-row selection, so every tile is its own block of a 2-D grid, and each
// warp writes the NMS score and the raw response of its tile rows straight
// out, coalesced along the row.  The NMS ring reads responses of the
// edge-padded image, as the Pallas kernel does (doh.py:327-332, :83-100).
// Products and sums follow the plain version's order without FMA
// contraction, so score and raw are bit-equal to
// ops/kernels/doh.py::doh_score_map_plain.
#include <cuda_runtime.h>

#include "doh_common.cuh"

namespace {

using doh::DohParams;
using doh::kThreads;
using doh::kTR;

__global__ void __launch_bounds__(kThreads, doh::kMinBlocks)
doh_score_map_kernel(const float* __restrict__ img, int h, int w,
                     float threshold, int border,
                     const __grid_constant__ DohParams p,
                     float* __restrict__ out_score,
                     float* __restrict__ out_raw) {
  extern __shared__ float smem[];
  const int tc = doh::tile_cols(p.halo);
  const int r0 = blockIdx.y * kTR, c0 = blockIdx.x * tc;

  doh::response_tile(img, w, h, w, r0, c0, p, smem);

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int i = warp; i < kTR && r0 + i < h; i += kThreads / 32) {
    const int gr = r0 + i;
    for (int j = lane; j < tc && c0 + j < w; j += 32) {
      const int gc = c0 + j;
      const size_t o = (size_t)gr * w + gc;
      out_score[o] = doh::nms_score(smem, i, j, gr, gc, h, w, border,
                                    threshold);
      out_raw[o] = doh::resp_at(smem, i + 1, j + 1);
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
  const int halo = doh::fill_params(p, n_scales, radii, s4, taps);
  if (h < 1 || w < 1 || halo < 0) return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * doh::kSmemFloats;
  cudaError_t e = doh::allow_smem(doh_score_map_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  const int tc = doh::tile_cols(halo);
  dim3 grid((w + tc - 1) / tc, (h + kTR - 1) / kTR);
  doh_score_map_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      img, h, w, threshold, border, p, score, raw);
  return (int)cudaGetLastError();
}
