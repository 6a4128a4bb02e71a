// K3: fused all-pairs squared-L2 distance + top-2 + matched coordinates,
// and K5: the same top-2 without the coordinates.
//
// Replaces imagestitch_tpu/ops/pallas/matcher.py::top2_l2_coords (K3, the
// Pallas call at matcher.py:150, kernel body _matcher_coords_kernel at :47)
// and ::top2_l2 (K5, the Pallas call at matcher.py:93, kernel body
// _matcher_kernel at :28).  K5 is the same kernel with null coordinate
// pointers: matcher_top2_launch.  The TPU kernel took only query counts
// that are multiples of its 256-row tile; here any Ka and Kb go, the ragged
// last query and train tiles masked.
//
// What bounds it on an H100: FP32 arithmetic.  A replay dispatch matches
// pairs x configs batches of 1024 x 1024 descriptors of 128 floats
// (0.27 GFLOP each) and reads only 1 MB per batch, far above the card's
// FP32 ridge.  The TPU kernel kept a whole (256, K) distance tile in VMEM
// and reduced it with masked lane reductions; here no distance matrix
// exists anywhere: distances are formed in registers and folded straight
// into a running top-2.
//
// Design: one block per (batch, 64-query tile); 16 x 16 threads, each owning
// 4 queries x 4 train columns of every 64-row train tile.
//  * the query tile (64 x D) sits in shared memory for the whole block and
//    the train tiles stream through it in 32-wide slices of D;
//  * dot products are FP32 FMAs (no tensor cores, no TF32), |a|^2 and |b|^2
//    are computed in-kernel, d = max(|a|^2 + |b|^2 - 2ab, 0);
//  * invalid train rows are skipped; each thread keeps a running
//    (d0, i0, d1) per query over its columns in ascending order with strict
//    '<' (first-index ties, d1 = d0 on exact ties), then the 16 threads of a
//    query row merge with an index-aware rule, giving exactly the first
//    argmin and the min over the other columns, as match._top2_min does;
//  * the matched train row and column coordinates are read at i0 (K3
//    only: K5 passes null rows_b/cols_b/out_rb/out_cb and skips the read).
// K5 on the whole-image path matches 11,616 x 11,616 descriptors of one
// pair (34.6 GFLOP) in only 182 query blocks for 132 SMs, so 50 SMs get
// two blocks and the rest one: a later PR can split the train axis.
// With no valid train row a query gets d0 = d1 = 3.4e38 and i0 = 0, the
// argmin of an all-masked row.
#include <cuda_runtime.h>

namespace {

constexpr int kQ = 64;            // queries per block
constexpr int kB = 64;            // train rows per tile
constexpr int kKc = 32;           // descriptor slice per train load
constexpr int kMaxD = 128;
constexpr int kThreads = 256;
constexpr float kBig = 3.4e38f;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ void push(float d, int j, float& d0, int& i0,
                                     float& d1) {
  if (d < d0) { d1 = d0; d0 = d; i0 = j; }
  else if (d < d1) { d1 = d; }
}

// fold another partition's (e0, j0, e1) into (d0, i0, d1)
__device__ __forceinline__ void merge(float e0, int j0, float e1, float& d0,
                                      int& i0, float& d1) {
  if (e0 < d0 || (e0 == d0 && j0 < i0)) {
    d1 = fminf(d0, e1); d0 = e0; i0 = j0;
  } else {
    d1 = fminf(d1, e0);
  }
}

__global__ void __launch_bounds__(kThreads)
matcher_kernel(const float* __restrict__ da, const float* __restrict__ db,
               const unsigned char* __restrict__ valid_b,
               const float* __restrict__ rows_b,
               const float* __restrict__ cols_b, int ka, int kb, int d,
               float* __restrict__ out_d0, int* __restrict__ out_i0,
               float* __restrict__ out_d1, float* __restrict__ out_rb,
               float* __restrict__ out_cb) {
  __shared__ float s_a[kQ][kMaxD + 1];
  __shared__ float s_b[kB][kKc + 1];
  __shared__ float s_na[kQ];
  __shared__ float s_nb[kB];
  __shared__ unsigned char s_vb[kB];

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int batch = blockIdx.y, q0 = blockIdx.x * kQ;
  const float* a_base = da + (size_t)batch * ka * d;
  const float* b_base = db + (size_t)batch * kb * d;
  const unsigned char* vb_base = valid_b + (size_t)batch * kb;

  for (int e = tid; e < kQ * d; e += kThreads) {
    int q = e / d, k = e - q * d;
    s_a[q][k] = (q0 + q < ka) ? a_base[(size_t)(q0 + q) * d + k] : 0.0f;
  }
  __syncthreads();
  if (tid < kQ) {
    float s = 0.0f;
    for (int k = 0; k < d; ++k) s = fmaf(s_a[tid][k], s_a[tid][k], s);
    s_na[tid] = s;
  }

  float d0[4], d1[4];
  int i0[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) { d0[i] = kBig; d1[i] = kBig; i0[i] = 0; }

  for (int t0 = 0; t0 < kb; t0 += kB) {
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) acc[i][jj] = 0.0f;
    __syncthreads();                         // previous tile's s_nb/s_vb read
    if (tid < kB) {
      s_nb[tid] = 0.0f;
      s_vb[tid] = (t0 + tid < kb) ? vb_base[t0 + tid] : 0;
    }
    for (int kc = 0; kc < d; kc += kKc) {
      __syncthreads();                       // previous slice consumed
      for (int e = tid; e < kB * kKc; e += kThreads) {
        int r = e / kKc, k = e - r * kKc;
        s_b[r][k] = (t0 + r < kb) ? b_base[(size_t)(t0 + r) * d + kc + k]
                                  : 0.0f;
      }
      __syncthreads();
      if (tid < kB) {
        float s = s_nb[tid];
        for (int k = 0; k < kKc; ++k) s = fmaf(s_b[tid][k], s_b[tid][k], s);
        s_nb[tid] = s;
      }
#pragma unroll 8
      for (int k = 0; k < kKc; ++k) {
        float av[4], bv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) av[i] = s_a[ty + 16 * i][kc + k];
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) bv[jj] = s_b[tx + 16 * jj][k];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int jj = 0; jj < 4; ++jj)
            acc[i][jj] = fmaf(av[i], bv[jj], acc[i][jj]);
      }
    }
    __syncthreads();                         // s_nb complete
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const int r = tx + 16 * jj;
      if (!s_vb[r]) continue;                // also covers rows past kb
      const float nb = s_nb[r];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float dist = __fsub_rn(__fadd_rn(s_na[ty + 16 * i], nb),
                               __fmul_rn(2.0f, acc[i][jj]));
        push(fmaxf(dist, 0.0f), t0 + r, d0[i], i0[i], d1[i]);
      }
    }
  }

  // the 16 threads of a query row are the 16 lanes sharing bit 4 of laneid
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    for (int o = 8; o > 0; o >>= 1) {
      float e0 = __shfl_xor_sync(kFull, d0[i], o);
      int j0 = __shfl_xor_sync(kFull, i0[i], o);
      float e1 = __shfl_xor_sync(kFull, d1[i], o);
      merge(e0, j0, e1, d0[i], i0[i], d1[i]);
    }
    const int q = q0 + ty + 16 * i;
    if (tx == 0 && q < ka) {
      const size_t o = (size_t)batch * ka + q;
      const size_t m = (size_t)batch * kb + i0[i];
      out_d0[o] = d0[i];
      out_i0[o] = i0[i];
      out_d1[o] = d1[i];
      if (out_rb != nullptr) {
        out_rb[o] = rows_b[m];
        out_cb[o] = cols_b[m];
      }
    }
  }
}

}  // namespace

extern "C" int matcher_launch(const float* da, const float* db,
                              const unsigned char* valid_b,
                              const float* rows_b, const float* cols_b,
                              int batch, int ka, int kb, int d, float* d0,
                              int* i0, float* d1, float* rb_sel,
                              float* cb_sel, void* stream) {
  if (batch < 0 || ka < 0 || kb < 1 || d < kKc || d > kMaxD || d % kKc != 0)
    return (int)cudaErrorInvalidValue;
  if (batch == 0 || ka == 0) return (int)cudaSuccess;
  dim3 grid((ka + kQ - 1) / kQ, batch);
  matcher_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      da, db, valid_b, rows_b, cols_b, ka, kb, d, d0, i0, d1, rb_sel, cb_sel);
  return (int)cudaGetLastError();
}

extern "C" int matcher_top2_launch(const float* da, const float* db,
                                   const unsigned char* valid_b, int batch,
                                   int ka, int kb, int d, float* d0, int* i0,
                                   float* d1, void* stream) {
  return matcher_launch(da, db, valid_b, nullptr, nullptr, batch, ka, kb, d,
                        d0, i0, d1, nullptr, nullptr, stream);
}
