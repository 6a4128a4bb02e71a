// K2: upright SURF-128 / SURF-64 descriptors for keypoints of the pyramid
// atlas.
//
// Replaces imagestitch_tpu/ops/pallas/describe.py::describe_atlas (the Pallas
// call at describe.py:226, kernel body _make_describe_kernel at :86).
//
// What bounds it on an H100: the latency of the scattered 18x18 window
// reads.  Each keypoint reads 1.3 KB from atlas rows that few other
// keypoints share, does ~10k flops and writes 512 bytes, so the kernel is a
// gather whose speed is the number of window loads in flight and the number
// of memory transactions per descriptor.  The TPU version streamed the
// atlas in 256-row bands through VMEM, with keypoints pre-sorted per band,
// 8-row and 128-lane aligned window copies and lane-shift extraction: all
// of that existed because Mosaic cannot gather.
//
// Design: one warp describes kPerWarp keypoints, kWarps warps a block.
//  * the warp first issues every window load of its keypoints (starts
//    clamped so the window lies inside the atlas: the CLIP semantics of the
//    XLA gather) into registers, then stages them in shared memory: 22
//    independent loads a lane in flight instead of a dependent chain;
//    consecutive keypoints are row-major per octave, so neighbouring warps
//    share L2 lines of the atlas;
//  * lane l computes the 8 samples (i, j) = (2t + l/16, l%16), t = 0..7:
//    3-tap smoothed central-difference gradients (exact
//    describe._grads_from_samples taps), times the Gaussian window weight,
//    which the block stages from the wrapper's cached device table;
//  * every lane's samples share one subregion column (j/4) and two samples
//    fall in each subregion row, so the 4x4 subregion sums are per-lane
//    partial sums over 8 lanes; a reduce-scatter (three shuffle steps that
//    halve the values a lane holds) leaves each lane with 4 (SURF-64: 2)
//    finished values that are adjacent in the descriptor;
//  * the L2 norm (+1e-8 guard) is one warp reduction, and the warp writes
//    the descriptor as 32 coalesced 16-byte stores (SURF-64: 8 bytes).
// Sums run in another order than the plain version, so the two agree to
// float32 rounding, not bit for bit.
#include <cuda_runtime.h>

namespace {

constexpr int kWin = 18;
constexpr int kWarps = 4;
constexpr int kPerWarp = 2;
constexpr int kLoads = (kWin * kWin + 31) / 32;
constexpr unsigned kFull = 0xffffffffu;

// one reduce-scatter step over lanes ``mask`` apart: of the 2n values the
// lane holds, it keeps the half selected by its ``mask`` bit, summed with
// the partner's same half
template <int N>
__device__ __forceinline__ void scatter_step(const float (&v)[2 * N],
                                             float (&o)[N], int lane,
                                             int mask) {
  const bool upper = lane & mask;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const float keep = upper ? v[i + N] : v[i];
    const float send = upper ? v[i] : v[i + N];
    o[i] = keep + __shfl_xor_sync(kFull, send, mask);
  }
}

template <bool EXT>
__device__ __forceinline__ void describe_one(const float (*q)[kWin + 1],
                                             const float* s_gw, int lane,
                                             float* __restrict__ out) {
  constexpr int NCH = EXT ? 8 : 4;
  const int j = lane & 15, hi = lane >> 4;
  float v[4 * NCH];                       // [subregion row a][channel c]
#pragma unroll
  for (int e = 0; e < 4 * NCH; ++e) v[e] = 0.0f;

#pragma unroll
  for (int t = 0; t < 8; ++t) {
    const int i = 2 * t + hi, a = t >> 1;
    float sm0 = 0.25f * q[i][j] + 0.5f * q[i + 1][j] + 0.25f * q[i + 2][j];
    float sm2 = 0.25f * q[i][j + 2] + 0.5f * q[i + 1][j + 2] +
                0.25f * q[i + 2][j + 2];
    float gx = 0.5f * sm0 - 0.5f * sm2;
    float d0 = 0.5f * q[i][j] - 0.5f * q[i + 2][j];
    float d1 = 0.5f * q[i][j + 1] - 0.5f * q[i + 2][j + 1];
    float d2 = 0.5f * q[i][j + 2] - 0.5f * q[i + 2][j + 2];
    float gy = 0.25f * d0 + 0.5f * d1 + 0.25f * d2;
    float wgt = s_gw[i * 16 + j];
    float sx = gx * wgt, sy = gy * wgt;
    float* acc = v + a * NCH;             // a is a constant once unrolled
    if constexpr (EXT) {
      bool py = sy >= 0.0f, px = sx >= 0.0f;
      acc[0] += py ? sx : 0.0f;
      acc[1] += py ? 0.0f : sx;
      acc[2] += py ? fabsf(sx) : 0.0f;
      acc[3] += py ? 0.0f : fabsf(sx);
      acc[4] += px ? sy : 0.0f;
      acc[5] += px ? 0.0f : sy;
      acc[6] += px ? fabsf(sy) : 0.0f;
      acc[7] += px ? 0.0f : fabsf(sy);
    } else {
      acc[0] += sx;
      acc[1] += sy;
      acc[2] += fabsf(sx);
      acc[3] += fabsf(sy);
    }
  }

  // lanes of one subregion column b = (lane >> 2) & 3 differ in bits 4, 1
  // and 0.  Bit 4 picks a's high bit, bit 1 its low bit, bit 0 the channel
  // half: the lane ends with channels (NCH/2) * bit0 .. of subregion
  // (a, b), summed over its 8 lanes.
  float v1[2 * NCH], v2[NCH], v3[NCH / 2];
  scatter_step<2 * NCH>(v, v1, lane, 16);
  scatter_step<NCH>(v1, v2, lane, 2);
  scatter_step<NCH / 2>(v2, v3, lane, 1);
  float sq = 0.0f;
#pragma unroll
  for (int c = 0; c < NCH / 2; ++c) sq += v3[c] * v3[c];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) sq += __shfl_xor_sync(kFull, sq, o);
  const float denom = sqrtf(sq) + 1e-8f;
  const int a = 2 * ((lane >> 4) & 1) + ((lane >> 1) & 1);
  const int b = (lane >> 2) & 3;
  float* o = out + (a * 4 + b) * NCH + (NCH / 2) * (lane & 1);
  if constexpr (EXT)
    *reinterpret_cast<float4*>(o) = make_float4(
        v3[0] / denom, v3[1] / denom, v3[2] / denom, v3[3] / denom);
  else
    *reinterpret_cast<float2*>(o) = make_float2(v3[0] / denom,
                                                v3[1] / denom);
}

__global__ void __launch_bounds__(kWarps * 32)
describe_kernel(const float* __restrict__ atlas, int ah, int aw,
                const int* __restrict__ r0w, const int* __restrict__ c0w,
                int k, const float* __restrict__ gw, int extended,
                float* __restrict__ out) {
  __shared__ float s_q[kWarps][kPerWarp][kWin][kWin + 1];
  __shared__ float s_gw[256];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int e = tid; e < 256; e += kWarps * 32) s_gw[e] = gw[e];
  const int kp0 = (blockIdx.x * kWarps + warp) * kPerWarp;

  // every window load of the warp's keypoints before any math
  float x[kPerWarp][kLoads];
#pragma unroll
  for (int u = 0; u < kPerWarp; ++u) {
    const int kp = kp0 + u;
    if (kp >= k) continue;
    int r0 = r0w[kp], c0 = c0w[kp];
    r0 = r0 < 0 ? 0 : (r0 > ah - kWin ? ah - kWin : r0);
    c0 = c0 < 0 ? 0 : (c0 > aw - kWin ? aw - kWin : c0);
    const float* base = atlas + (size_t)r0 * aw + c0;
#pragma unroll
    for (int l = 0; l < kLoads; ++l) {
      const int e = lane + 32 * l;
      if (e < kWin * kWin)
        x[u][l] = __ldg(base + (size_t)(e / kWin) * aw + e % kWin);
    }
  }
#pragma unroll
  for (int u = 0; u < kPerWarp; ++u)
#pragma unroll
    for (int l = 0; l < kLoads; ++l) {
      const int e = lane + 32 * l;
      if (kp0 + u < k && e < kWin * kWin)
        s_q[warp][u][e / kWin][e % kWin] = x[u][l];
    }
  __syncthreads();

#pragma unroll
  for (int u = 0; u < kPerWarp; ++u) {
    const int kp = kp0 + u;
    if (kp >= k) break;                                  // warp-uniform
    if (extended)
      describe_one<true>(s_q[warp][u], s_gw, lane, out + (size_t)kp * 128);
    else
      describe_one<false>(s_q[warp][u], s_gw, lane, out + (size_t)kp * 64);
  }
}

}  // namespace

extern "C" int describe_launch(const float* atlas, int ah, int aw,
                               const int* r0, const int* c0, int k,
                               const float* gw, int extended, float* out,
                               void* stream) {
  if (ah < kWin || aw < kWin || k < 0) return (int)cudaErrorInvalidValue;
  if (k == 0) return (int)cudaSuccess;
  const int per_block = kWarps * kPerWarp;
  dim3 grid((k + per_block - 1) / per_block);
  describe_kernel<<<grid, kWarps * 32, 0, (cudaStream_t)stream>>>(
      atlas, ah, aw, r0, c0, k, gw, extended, out);
  return (int)cudaGetLastError();
}
