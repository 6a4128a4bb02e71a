// K4: fused multi-scale determinant-of-Hessian + 3x3 NMS + border +
// threshold over all octave bands of a frame's pyramid atlas in one launch,
// with the NMS survivors compacted into one list (the score-map pool), or
// written as a full score map (``doh_score_map`` of one image).
//
// Replaces imagestitch_tpu/ops/pallas/doh.py::doh_score_map (doh.py:311, the
// Pallas call at doh.py:337, kernel body _make_kernel at doh.py:57).
//
// What bounds it on an H100: FP32 instruction issue, as for K1
// (doh_select.cu).  Each pixel costs 402 operations (six separable
// correlations of 9-13 taps per scale, the determinant, the scale max and
// the NMS; chip_smoke.py doh_operations): 2.68 GFLOP for a 1936x2584
// frame's four octaves, 0.040 ms at the card's FP32 peak.  Every multiply
// and add is its own rounded instruction, to stay bit-equal to the plain
// version, so the ceiling is half that rate, 0.080 ms.  Device memory is
// not the limit: the bands are read once and the raw response written once
// (8 bytes a pixel, 53 MB a frame, 16 us at 3.35 TB/s), plus 8 bytes a
// survivor.
//
// Design:
//  * one launch covers the frame's bands (K1's band table: a row offset, h,
//    w and border per octave); the 1-D grid walks a tile table over all
//    bands, largest first, so the small octaves fill the SMs the large one
//    leaves idle at its tail;
//  * each block owns one tile of kTR (14) rows x tile_cols(halo) columns
//    and runs K1's register-blocked response stage (doh_common.cuh), then
//    the NMS of doh_common.cuh's nms_score;
//  * the raw scale-max response goes to an atlas-shaped buffer (the pool's
//    sub-pixel step reads it at every chosen slot, empty ones included);
//  * compaction epilogue, instead of a full score map: a warp ballot over
//    each (tile row, 32 columns) gives the survivors (score > 0) and their
//    places in the warp, a block prefix sum over the warps' counts their
//    places in the tile, and one atomicAdd per block reserves the tile's
//    run in the frame's one list (a second adds it to its band's count).
//    An entry is the 64-bit key
//      band << 60 | (0x7FFFFFFF - bits(score)) << 29 | flat index in band:
//    ascending keys group the bands in order and, inside a band, are the
//    (score desc, index asc) order of a stable descending sort of its
//    score map.  So the order the atomics land in does not matter, and one
//    sort orders every band (ops/kernels/doh.py top_k_from_survivors);
//  * the list holds sum h x w entries, the most there can be (NMS keeps
//    ties, so a plateau keeps every pixel): no capacity check and no second
//    route.  A band holds at most 2^29 pixels (the key's index field), a
//    frame at most 2^31 - 1;
//  * the full-map mode (template flag) writes the score map beside the raw
//    response and compacts nothing.
// Products and sums use __fmul_rn/__fadd_rn in the order of the plain
// PyTorch version (ops/kernels/doh.py::doh_score_map_plain), so scores and
// raw responses are bit-equal to it.
#include <cuda_runtime.h>
#include <climits>

#include "doh_common.cuh"

namespace {

using doh::DohParams;
using doh::kThreads;
using doh::kTR;
constexpr int kMaxBands = 8;
constexpr int kIndexBits = 29;                           // key index field
constexpr int kWarps = kThreads / 32;
constexpr int kWarpRows = (kTR + kWarps - 1) / kWarps;   // tile rows a warp
constexpr int kLaneCols = (doh::kVW + 31) / 32;          // tile columns a lane
constexpr unsigned kFull = 0xffffffffu;

struct Bands {
  int n;
  int row_off[kMaxBands];        // first atlas row of the band
  int h[kMaxBands], w[kMaxBands], border[kMaxBands];
  int col_tiles[kMaxBands];
  int tile0[kMaxBands + 1];      // first block of each band
};

template <bool kFullMap>
__global__ void __launch_bounds__(kThreads, doh::kMinBlocks)
doh_score_map_kernel(const float* __restrict__ atlas, int pitch,
                     float threshold, const __grid_constant__ DohParams p,
                     const __grid_constant__ Bands t,
                     float* __restrict__ out_raw,
                     float* __restrict__ out_score,
                     unsigned long long* __restrict__ keys,
                     int* __restrict__ counts) {
  extern __shared__ float smem[];
  __shared__ int s_run[kWarps];                   // each warp's first entry
  int o = 0;
  while (o + 1 < t.n && (int)blockIdx.x >= t.tile0[o + 1]) ++o;
  const int nct = t.col_tiles[o];
  const int tb = blockIdx.x - t.tile0[o];
  const int rt = tb / nct, ct = tb - rt * nct;
  const int h = t.h[o], w = t.w[o], border = t.border[o];
  const int tc = doh::tile_cols(p.halo);
  const int r0 = rt * kTR, c0 = ct * tc;
  const size_t band0 = (size_t)t.row_off[o] * pitch;
  doh::response_tile(atlas + band0, pitch, h, w, r0, c0, p, smem);

  // tile rows warp + kWarps * u, tile columns lane + 32 * q
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float sc[kWarpRows][kLaneCols];
  int run = 0;                                    // the warp's survivors
#pragma unroll
  for (int u = 0; u < kWarpRows; ++u) {
    const int i = warp + kWarps * u, gr = r0 + i;
#pragma unroll
    for (int q = 0; q < kLaneCols; ++q) {
      const int j = lane + 32 * q, gc = c0 + j;
      float s = 0.0f;
      if (i < kTR && gr < h && j < tc && gc < w) {
        s = doh::nms_score(smem, i, j, gr, gc, h, w, border, threshold);
        const size_t a = band0 + (size_t)gr * pitch + gc;
        out_raw[a] = doh::resp_at(smem, i + 1, j + 1);
        if (kFullMap) out_score[a] = s;
      }
      sc[u][q] = s;
      if (!kFullMap) run += __popc(__ballot_sync(kFull, s > 0.0f));
    }
  }
  if (kFullMap) return;

  // block prefix sum of the warps' counts; one atomicAdd reserves the run
  if (lane == 0) s_run[warp] = run;
  __syncthreads();
  if (threadIdx.x == 0) {
    int total = 0;
    for (int k = 0; k < kWarps; ++k) {
      const int c = s_run[k];
      s_run[k] = total;
      total += c;
    }
    int base = 0;
    if (total > 0) {
      base = atomicAdd(counts + t.n, total);
      atomicAdd(counts + o, total);
    }
    for (int k = 0; k < kWarps; ++k) s_run[k] += base;
  }
  __syncthreads();
  const unsigned long long band = (unsigned long long)o << 60;
  int at = s_run[warp];
  const unsigned below = (1u << lane) - 1u;
#pragma unroll
  for (int u = 0; u < kWarpRows; ++u) {
    const int gr = r0 + warp + kWarps * u;
#pragma unroll
    for (int q = 0; q < kLaneCols; ++q) {
      const float s = sc[u][q];
      const unsigned live = __ballot_sync(kFull, s > 0.0f);
      if (s > 0.0f)
        keys[at + __popc(live & below)] =
            band |
            ((unsigned long long)(0x7FFFFFFFu - __float_as_uint(s))
             << kIndexBits) |
            (unsigned)(gr * w + c0 + lane + 32 * q);
      at += __popc(live);
    }
  }
}

}  // namespace

// bands: n_bands x (row_off, h, w, border) in the atlas of row stride
// ``pitch``; raw: atlas-shaped, written inside the bands.  Full-map mode
// (``score`` not null): the score map, atlas-shaped, beside it.  Otherwise
// ``keys`` holds ``key_capacity`` = sum h * w entries, and ``counts``
// (n_bands + 1 ints, zeroed here) receives each band's survivors and, last,
// their total, the keys written.
extern "C" int doh_score_map_launch(const float* atlas, int pitch,
                                    int n_bands, const int* bands,
                                    float threshold, int n_scales,
                                    const int* radii, const float* s4,
                                    const float* taps, float* raw,
                                    float* score, long long* keys,
                                    long long key_capacity, int* counts,
                                    void* stream) {
  DohParams p;
  const int halo = doh::fill_params(p, n_scales, radii, s4, taps);
  if (halo < 0 || n_bands < 1 || n_bands > kMaxBands)
    return (int)cudaErrorInvalidValue;
  const bool full = score != nullptr;
  if (!full && (keys == nullptr || counts == nullptr))
    return (int)cudaErrorInvalidValue;
  const int tc = doh::tile_cols(halo);
  Bands t{};
  t.n = n_bands;
  long long tiles = 0, entries = 0;
  for (int o = 0; o < n_bands; ++o) {
    const int* b = bands + 4 * o;
    const int h = b[1], w = b[2];
    if (b[0] < 0 || h < 1 || w < 1 || w > pitch ||
        (long long)h * w > (1LL << kIndexBits))
      return (int)cudaErrorInvalidValue;
    t.row_off[o] = b[0];
    t.h[o] = h;
    t.w[o] = w;
    t.border[o] = b[3];
    t.col_tiles[o] = (w + tc - 1) / tc;
    t.tile0[o] = (int)tiles;
    tiles += (long long)((h + kTR - 1) / kTR) * t.col_tiles[o];
    entries += (long long)h * w;
  }
  t.tile0[n_bands] = (int)tiles;
  if (tiles > INT_MAX || entries > INT_MAX ||
      (!full && entries != key_capacity))
    return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * doh::kSmemFloats;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t e;
  if (full) {
    e = doh::allow_smem(doh_score_map_kernel<true>, smem);
    if (e != cudaSuccess) return (int)e;
    doh_score_map_kernel<true><<<(unsigned)tiles, kThreads, smem, s>>>(
        atlas, pitch, threshold, p, t, raw, score, nullptr, nullptr);
  } else {
    e = cudaMemsetAsync(counts, 0, sizeof(int) * (n_bands + 1), s);
    if (e != cudaSuccess) return (int)e;
    e = doh::allow_smem(doh_score_map_kernel<false>, smem);
    if (e != cudaSuccess) return (int)e;
    doh_score_map_kernel<false><<<(unsigned)tiles, kThreads, smem, s>>>(
        atlas, pitch, threshold, p, t, raw, nullptr,
        (unsigned long long*)keys, counts);
  }
  return (int)cudaGetLastError();
}
