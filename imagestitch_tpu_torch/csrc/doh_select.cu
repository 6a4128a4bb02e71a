// K1: fused multi-scale determinant-of-Hessian + 3x3 NMS + sub-pixel +
// per-row top-R candidate selection, for all octaves of a frame in one
// launch.
//
// Replaces imagestitch_tpu/ops/pallas/doh.py::doh_select (the Pallas call at
// doh.py:285, kernel body _make_select_kernel at doh.py:143).
//
// What bounds it on an H100: FP32 instruction issue.  A 1936x2584 frame's
// four octaves are read once (26 MB, 8 us of HBM time) and only H x R
// candidates are written, while each pixel costs six separable correlations
// of 9-13 taps per scale (402 operations, chip_smoke.py doh_operations).
// The kernel must stay bit-equal to the plain version, so every multiply and
// add is its own rounded instruction (no FMA): the ceiling is half the
// card's FP32 FMA rate, about 0.08 ms for the four octaves.
//
// Design:
//  * one launch covers the frame's octaves, the bands of the pyramid atlas
//    (one base pointer, a row offset, h, w, border and R per octave); the
//    1-D grid walks a tile table over all octaves, largest first, so the
//    small octaves fill the SMs the large one leaves idle at its tail;
//  * each block owns one tile of kTR (14) rows x tile_cols(halo) columns
//    (242 at radii 4-6) and runs the register-blocked response stage of
//    doh_common.cuh (FP32 issue, not shared memory, sets its pace; the
//    ring and halo cost ~1.15x the counted operations);
//  * per tile row, a warp takes the tile's top-R NMS survivors by (score
//    desc, column asc) with shuffles, computes their sub-pixel offsets from
//    the raw response, and writes them to a scratch list per (row, tile);
//  * a second, small kernel (a warp per row, a lane per tile list) merges
//    each row's tile lists into its global top-R, taking the next best by
//    (score desc, column asc) among all lists: ties keep the lower column,
//    the first-lane tie-break of the Pallas kernel.
// Products and sums use __fmul_rn/__fadd_rn in the order of the plain
// PyTorch version (ops/kernels/doh.py::doh_select_plain), so the compiler
// cannot contract them into FMAs and the two agree bit for bit.
#include <cuda_runtime.h>
#include <climits>

#include "doh_common.cuh"

namespace {

using doh::DohParams;
using doh::kThreads;
using doh::kTR;
constexpr int kMaxCands = 8;
constexpr int kMaxOctaves = 8;
constexpr int kLaneCols = (doh::kVW + 31) / 32;   // tile columns per lane
constexpr unsigned kFull = 0xffffffffu;

struct Octaves {
  int n;
  int row_off[kMaxOctaves];     // first atlas row of the band
  int h[kMaxOctaves], w[kMaxOctaves];
  int border[kMaxOctaves], r_cands[kMaxOctaves];
  int col_tiles[kMaxOctaves];
  int tile0[kMaxOctaves + 1];   // first block of each octave
  int row0[kMaxOctaves + 1];    // first merged row of each octave
  int scratch0[kMaxOctaves];    // first scratch entry of each octave
  int out0[kMaxOctaves];        // first output slot of each octave
};

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

// scratch entry: (score, column bits, dr, dc); score 0 marks an empty slot
__global__ void __launch_bounds__(kThreads, doh::kMinBlocks)
doh_select_tiles(const float* __restrict__ atlas, int pitch, float threshold,
                 const __grid_constant__ DohParams p,
                 const __grid_constant__ Octaves t,
                 float4* __restrict__ scratch) {
  extern __shared__ float smem[];
  int o = 0;
  while (o + 1 < t.n && (int)blockIdx.x >= t.tile0[o + 1]) ++o;
  const int nct = t.col_tiles[o];
  const int tb = blockIdx.x - t.tile0[o];
  const int rt = tb / nct, ct = tb - rt * nct;
  const int h = t.h[o], w = t.w[o];
  const int tc = doh::tile_cols(p.halo);
  const int r0 = rt * kTR, c0 = ct * tc;
  doh::response_tile(atlas + (size_t)t.row_off[o] * pitch, pitch, h, w, r0,
                     c0, p, smem);

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int rc = t.r_cands[o], border = t.border[o];
  for (int i = warp; i < kTR; i += kThreads / 32) {
    const int gr = r0 + i;
    if (gr >= h) break;                                  // warp-uniform
    float sc[kLaneCols];
#pragma unroll
    for (int q = 0; q < kLaneCols; ++q) {
      const int j = lane + 32 * q, gc = c0 + j;
      sc[q] = (j < tc && gc < w)
                  ? doh::nms_score(smem, i, j, gr, gc, h, w, border, threshold)
                  : 0.0f;
    }
    float4* out = scratch + t.scratch0[o] + ((size_t)gr * nct + ct) * rc;
    for (int k = 0; k < rc; ++k) {
      float bs = 0.0f;
      int bj = INT_MAX;
#pragma unroll
      for (int q = 0; q < kLaneCols; ++q)
        if (sc[q] > 0.0f && better(sc[q], lane + 32 * q, bs, bj)) {
          bs = sc[q];
          bj = lane + 32 * q;
        }
      for (int off = 16; off > 0; off >>= 1) {
        float os = __shfl_xor_sync(kFull, bs, off);
        int oj = __shfl_xor_sync(kFull, bj, off);
        if (better(os, oj, bs, bj)) { bs = os; bj = oj; }
      }
      if (!(bs > 0.0f)) {                                // warp-uniform
        if (lane == 0) out[k] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        break;
      }
      if (lane == 0) {
        const float cen = doh::resp_at(smem, i + 1, bj + 1);
        out[k] = make_float4(
            bs, __int_as_float(c0 + bj),
            axis_off(doh::resp_at(smem, i, bj + 1),
                     doh::resp_at(smem, i + 2, bj + 1), cen),
            axis_off(doh::resp_at(smem, i + 1, bj),
                     doh::resp_at(smem, i + 1, bj + 2), cen));
      }
#pragma unroll
      for (int q = 0; q < kLaneCols; ++q)
        if (lane + 32 * q == bj) sc[q] = 0.0f;           // the owning lane
    }
  }
}

// One warp per row of every octave: the row's top-R over its tile lists.
// The k-th best is the best entry strictly after the (k-1)-th in the
// (score desc, column asc) order.  Each lane takes the tile lists lane,
// lane + 32, ...: a list is sorted, so its candidate is its first entry
// after the (k-1)-th, and its scan stops at that entry or an empty one.
__global__ void __launch_bounds__(kThreads)
doh_select_merge(const __grid_constant__ Octaves t,
                 const float4* __restrict__ scratch,
                 float* __restrict__ out_sc, int* __restrict__ out_col,
                 float* __restrict__ out_dr, float* __restrict__ out_dc) {
  const int g = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (g >= t.row0[t.n]) return;                          // warp-uniform
  int o = 0;
  while (o + 1 < t.n && g >= t.row0[o + 1]) ++o;
  const int gr = g - t.row0[o], rc = t.r_cands[o], nct = t.col_tiles[o];
  const float4* lists = scratch + t.scratch0[o] + (size_t)gr * nct * rc;
  const size_t o0 = (size_t)t.out0[o] + (size_t)gr * rc;
  float ps = __int_as_float(0x7f800000);                // +inf
  int pc = -1;
  for (int k = 0; k < rc; ++k) {
    float bs = 0.0f, bdr = 0.0f, bdc = 0.0f;
    int bc = INT_MAX;
    for (int ct = lane; ct < nct; ct += 32) {
      for (int m = 0; m < rc; ++m) {
        const float4 e = lists[ct * rc + m];
        if (!(e.x > 0.0f)) break;
        const int c = __float_as_int(e.y);
        if (!better(ps, pc, e.x, c)) continue;           // taken already
        if (better(e.x, c, bs, bc)) { bs = e.x; bc = c; bdr = e.z; bdc = e.w; }
        break;
      }
    }
    for (int off = 16; off > 0; off >>= 1) {
      const float os = __shfl_xor_sync(kFull, bs, off);
      const int oc = __shfl_xor_sync(kFull, bc, off);
      const float odr = __shfl_xor_sync(kFull, bdr, off);
      const float odc = __shfl_xor_sync(kFull, bdc, off);
      if (better(os, oc, bs, bc)) { bs = os; bc = oc; bdr = odr; bdc = odc; }
    }
    const bool live = bs > 0.0f;                         // warp-uniform
    if (lane == 0) {
      out_sc[o0 + k] = live ? bs : 0.0f;
      out_col[o0 + k] = live ? bc : 0;
      out_dr[o0 + k] = live ? bdr : 0.0f;
      out_dc[o0 + k] = live ? bdc : 0.0f;
    }
    if (live) { ps = bs; pc = bc; } else { ps = 0.0f; pc = INT_MAX; }
  }
}

}  // namespace

// bands: n_oct x (row_off, h, w, border, r_cands) in the atlas of row
// stride ``pitch``; outputs: per octave h x r_cands slots, octave after
// octave; scratch: ``scratch_entries`` float4 (the wrapper sizes it as
// sum h * ceil(w / tile_cols(halo)) * r_cands).
extern "C" int doh_select_launch(const float* atlas, int pitch, int n_oct,
                                 const int* bands, float threshold,
                                 int n_scales, const int* radii,
                                 const float* s4, const float* taps,
                                 float* sc, int* col, float* dr, float* dc,
                                 float* scratch, int scratch_entries,
                                 void* stream) {
  DohParams p;
  const int halo = doh::fill_params(p, n_scales, radii, s4, taps);
  if (halo < 0 || n_oct < 1 || n_oct > kMaxOctaves)
    return (int)cudaErrorInvalidValue;
  const int tc = doh::tile_cols(halo);
  Octaves t{};
  t.n = n_oct;
  long long tiles = 0, rows = 0, entries = 0, slots = 0;
  for (int o = 0; o < n_oct; ++o) {
    const int* b = bands + 5 * o;
    const int h = b[1], w = b[2], rc = b[4];
    if (b[0] < 0 || h < 1 || w < 1 || w > pitch || rc < 1 || rc > kMaxCands)
      return (int)cudaErrorInvalidValue;
    t.row_off[o] = b[0];
    t.h[o] = h;
    t.w[o] = w;
    t.border[o] = b[3];
    t.r_cands[o] = rc;
    t.col_tiles[o] = (w + tc - 1) / tc;
    t.tile0[o] = (int)tiles;
    t.row0[o] = (int)rows;
    t.scratch0[o] = (int)entries;
    t.out0[o] = (int)slots;
    tiles += (long long)((h + kTR - 1) / kTR) * t.col_tiles[o];
    rows += h;
    entries += (long long)h * t.col_tiles[o] * rc;
    slots += (long long)h * rc;
  }
  t.tile0[n_oct] = (int)tiles;
  t.row0[n_oct] = (int)rows;
  if (entries != scratch_entries || tiles > INT_MAX)
    return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * doh::kSmemFloats;
  cudaError_t e = doh::allow_smem(doh_select_tiles, smem);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t s = (cudaStream_t)stream;
  doh_select_tiles<<<(unsigned)tiles, kThreads, smem, s>>>(
      atlas, pitch, threshold, p, t, (float4*)scratch);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int rows_per_block = kThreads / 32;
  doh_select_merge<<<(unsigned)((rows + rows_per_block - 1) / rows_per_block),
                     kThreads, 0, s>>>(
      t, (const float4*)scratch, sc, col, dr, dc);
  return (int)cudaGetLastError();
}
