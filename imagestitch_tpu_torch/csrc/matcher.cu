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
// What bounds it on an H100: the products a.b, 2 * D operations a distance.
// A replay dispatch matches 64 batches of 1024 x 1024 descriptors of 128
// floats and reads 1 MB a batch, far above the card's ridge; the
// whole-image path matches 11,616 x 11,616.  In FP32 FMAs on the CUDA cores
// the floor is 67 TFLOP/s.  Here the products run on the tensor cores at
// FP32 accuracy, "3xTF32": each operand x splits into hi = tf32(x) and
// lo = tf32(x - hi), and a.b accumulates lo.hi + hi.lo + hi.hi in FP32 with
// mma.sync m16n8k8 TF32 (three MMAs at the 495 TFLOP/s TF32 rate; the lo.lo
// term, under 2^-22 of |a||b|, is dropped).  No distance matrix exists
// anywhere: distances are formed from the accumulator fragments and folded
// straight into a running top-2.
//
// Design: a block takes 128 queries of one batch and sweeps one split of the
// train axis in 128-row tiles; 8 warps, 2 along the queries x 4 along the
// train rows, each warp a 64 x 32 tile of 4 x 4 MMA tiles.
//  * the block's query tile sits in shared memory for the whole sweep,
//    split once into hi and lo planes stored in the MMA fragment order, so a
//    thread reads its four A values of an m tile and k step as one float4;
//    |a|^2 is an exact FP32 FMA chain in column order, as |b|^2 is;
//  * train tiles stream in 32-column slices through a 4-stage cp.async ring
//    (one barrier a slice), so the copies of the next three slices overlap
//    the MMAs of this one; B is split into hi and lo as its fragments load,
//    from rows padded by 4 floats so that a warp's loads hit 32 banks;
//  * each k step issues the 16 lo.hi MMAs, then the hi.lo, then the hi.hi,
//    so consecutive MMAs write different accumulators;
//  * after a tile's last slice, d = max(fl(fl(|a|^2 + |b|^2) - fl(2ab)), 0)
//    for each accumulator element; invalid train rows count as 3.4e38; each
//    thread pushes its columns in ascending order with strict '<' into a
//    running (d0, i0, d1) per row (first-index ties, d1 = d0 on exact ties),
//    with selects and no branch (a branchy push, whose lanes diverge, was
//    markedly slower);
//  * the 4 threads of a quad merge by shuffles and the 4 warps of a row band
//    through shared memory with an index-aware rule (merge below), which is
//    exact and order-free, so the result is deterministic;
//  * the grid is (query tiles, batch, S): with few blocks (K5 on one pair)
//    the wrapper splits the train axis into S ranges of whole tiles; each
//    split writes its (d0, i0, d1) to scratch the wrapper allocates, and a
//    merge kernel folds the splits with the same rule and, for K3, reads
//    the matched train coordinates at the final i0.  S = 1 writes the
//    outputs directly.
// What bounds it now: not the MMAs.  Without them the kernel keeps most of
// its time: the fragment loads, the B split, the ring's barriers and the
// epilogue, issued by two warps a scheduler; a wgmma version of this
// design was barely faster (PERF.md section 6).
// With no valid train row a query gets d0 = d1 = 3.4e38 and i0 = 0, the
// argmin of an all-masked row.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 128;              // queries per block
constexpr int kBN = 128;              // train rows per tile
constexpr int kKC = 32;               // descriptor columns per ring stage
constexpr int kStages = 4;
constexpr int kMaxD = 128;
constexpr int kThreads = 256;
constexpr int kWarpsN = 4;            // warps along the train rows
constexpr int kWM = 64, kWN = 32;     // warp tile
constexpr int kMT = kWM / 16, kNT = kWN / 8;
constexpr int kBStride = kKC + 4;     // padded train slice row (floats)
constexpr float kBig = 3.4e38f;
constexpr unsigned kFull = 0xffffffffu;
// the raw query tile is staged in the ring before the ring starts
static_assert(kBM * (kMaxD + 4) <= kStages * kBN * kBStride, "staging");

size_t smem_bytes(int d) {
  return sizeof(float) * ((size_t)2 * kBM * d             // query hi, lo
                          + (size_t)kStages * kBN * kBStride  // train ring
                          + kBN + kBM);                   // |b|^2, |a|^2
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           int src_bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

// c += a * b, one m16n8k8 TF32 product with FP32 accumulation
__device__ __forceinline__ void mma(float* c, const uint32_t* a,
                                    const uint32_t* b) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// push column j at distance d: branch-free, so that the lanes of a warp,
// each at its own place in its rows' top-2, do not diverge
__device__ __forceinline__ void push(float d, int j, float& d0, int& i0,
                                     float& d1) {
  const bool first = d < d0;
  d1 = first ? d0 : fminf(d1, d);
  i0 = first ? j : i0;
  d0 = first ? d : d0;
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

__global__ void __launch_bounds__(kThreads, 1)
matcher_tc_kernel(const float* __restrict__ da, const float* __restrict__ db,
                  const unsigned char* __restrict__ valid_b,
                  const float* __restrict__ rows_b,
                  const float* __restrict__ cols_b, int ka, int kb, int d,
                  int tiles_per_split, float* __restrict__ part,
                  float* __restrict__ out_d0, int* __restrict__ out_i0,
                  float* __restrict__ out_d1, float* __restrict__ out_rb,
                  float* __restrict__ out_cb) {
  extern __shared__ __align__(16) float smem[];
  float* s_ah = smem;                // [m tile][k step][lane][4]
  float* s_al = s_ah + kBM * d;
  float* s_b = s_al + kBM * d;
  float* s_nb = s_b + kStages * kBN * kBStride;
  float* s_na = s_nb + kBN;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp / kWarpsN, wn = warp % kWarpsN;
  const int batch = blockIdx.y, q0 = blockIdx.x * kBM, split_id = blockIdx.z;
  const float* a_base = da + (size_t)batch * ka * d;
  const float* b_base = db + (size_t)batch * kb * d;
  const unsigned char* vb_base = valid_b + (size_t)batch * kb;

  const int n_tiles = (kb + kBN - 1) / kBN;
  const int tile0 = split_id * tiles_per_split;
  const int tile1 = min(n_tiles, tile0 + tiles_per_split);
  const int nk = d / kKC;
  const int total = max(tile1 - tile0, 0) * nk;   // ring slices

  auto load_slice = [&](int it) {
    float* dst = s_b + (it % kStages) * kBN * kBStride;
    const int r0 = (tile0 + it / nk) * kBN, kc = (it % nk) * kKC;
    for (int e = tid; e < kBN * kKC / 4; e += kThreads) {
      const int r = e >> 3, c = (e & 7) * 4;
      const bool in = r0 + r < kb;
      cp_async16(dst + r * kBStride + c,
                 in ? b_base + (size_t)(r0 + r) * d + kc + c : b_base,
                 in ? 16 : 0);
    }
  };
  // the query tile: raw into the (not yet started) ring with rows padded
  // to d + 4, |a|^2, then hi and lo in the MMA fragment order, so that a
  // thread reads its four A values of an m tile and k step as one float4
  const int lds = d + 4, d4 = d / 4, ksteps = d / 8;
  float* s_raw = s_b;
  for (int e = tid; e < kBM * d4; e += kThreads) {
    const int r = e / d4, c = (e - r * d4) * 4;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (q0 + r < ka)
      v = *reinterpret_cast<const float4*>(a_base + (size_t)(q0 + r) * d + c);
    *reinterpret_cast<float4*>(s_raw + r * lds + c) = v;
  }
  __syncthreads();
  if (tid < kBM) {
    float s = 0.0f;
    for (int k = 0; k < d; k += 4) {
      const float4 v = *reinterpret_cast<const float4*>(s_raw + tid * lds + k);
      s = fmaf(v.x, v.x, s); s = fmaf(v.y, v.y, s);
      s = fmaf(v.z, v.z, s); s = fmaf(v.w, v.w, s);
    }
    s_na[tid] = s;
  }
  for (int e = tid; e < kBM / 16 * ksteps * 32; e += kThreads) {
    const int ln = e & 31, ks = (e >> 5) % ksteps, mt = (e >> 5) / ksteps;
    const float* p = s_raw + (mt * 16 + (ln >> 2)) * lds + ks * 8 + (ln & 3);
    uint32_t h[4], l[4];
    split(p[0], h[0], l[0]);
    split(p[8 * lds], h[1], l[1]);
    split(p[4], h[2], l[2]);
    split(p[8 * lds + 4], h[3], l[3]);
    reinterpret_cast<uint4*>(s_ah)[e] = make_uint4(h[0], h[1], h[2], h[3]);
    reinterpret_cast<uint4*>(s_al)[e] = make_uint4(l[0], l[1], l[2], l[3]);
  }
  __syncthreads();                   // the raw tile is consumed
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < total) load_slice(s);
    cp_async_commit();
  }

  float acc[kMT][kNT][4];
  float b0[kMT][2], b1[kMT][2];
  int bi[kMT][2];
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      b0[mt][h] = kBig; b1[mt][h] = kBig; bi[mt][h] = 0;
    }
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.0f;
  float nb_acc = 0.0f;
  float na[kMT][2];                  // |a|^2 of this thread's 8 rows
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      na[mt][h] = s_na[wm * kWM + mt * 16 + g + 8 * h];

  for (int it = 0; it < total; ++it) {
    cp_async_wait<kStages - 2>();
    __syncthreads();                 // slice `it` landed; slice it-1 consumed
    if (it + kStages - 1 < total) load_slice(it + kStages - 1);
    cp_async_commit();
    const float* sb = s_b + (it % kStages) * kBN * kBStride;
    const int kc = (it % nk) * kKC;
    const float* nb_row = sb + (tid & (kBN - 1)) * kBStride;
#pragma unroll
    for (int kk = 0; kk < kKC; kk += 8) {
      // |b|^2: an FMA chain in column order, 8 columns a k step; every
      // thread runs one (threads tid and tid + 128 the same row), so the
      // chain interleaves with the MMAs instead of holding half the block
#pragma unroll
      for (int k = kk; k < kk + 8; k += 4) {
        const float4 v = *reinterpret_cast<const float4*>(nb_row + k);
        nb_acc = fmaf(v.x, v.x, nb_acc); nb_acc = fmaf(v.y, v.y, nb_acc);
        nb_acc = fmaf(v.z, v.z, nb_acc); nb_acc = fmaf(v.w, v.w, nb_acc);
      }
      uint32_t bh[kNT][2], bl[kNT][2];
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt) {
        const float* p = sb + (wn * kWN + nt * 8 + g) * kBStride + kk + t;
        split(p[0], bh[nt][0], bl[nt][0]);
        split(p[4], bh[nt][1], bl[nt][1]);
      }
      uint32_t ah[kMT][4], al[kMT][4];
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt) {
        const int f = ((wm * kMT + mt) * ksteps + (kc + kk) / 8) * 32 + lane;
        const uint4 h = reinterpret_cast<const uint4*>(s_ah)[f];
        const uint4 l = reinterpret_cast<const uint4*>(s_al)[f];
        ah[mt][0] = h.x; ah[mt][1] = h.y; ah[mt][2] = h.z; ah[mt][3] = h.w;
        al[mt][0] = l.x; al[mt][1] = l.y; al[mt][2] = l.z; al[mt][3] = l.w;
      }
      // term by term, so that consecutive MMAs write different tiles
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt) mma(acc[mt][nt], al[mt], bh[nt]);
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt) mma(acc[mt][nt], ah[mt], bl[nt]);
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt) mma(acc[mt][nt], ah[mt], bh[nt]);
    }
    if (it % nk == nk - 1) {         // the tile's last slice: epilogue
      const int r0 = (tile0 + it / nk) * kBN;
      if (tid < kBN)
        s_nb[tid] = (r0 + tid < kb && vb_base[r0 + tid]) ? nb_acc : -1.0f;
      nb_acc = 0.0f;
      __syncthreads();
      float nb[kNT][2];
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
        for (int c = 0; c < 2; ++c)
          nb[nt][c] = s_nb[wn * kWN + nt * 8 + 2 * t + c];
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
#pragma unroll
          for (int nt = 0; nt < kNT; ++nt) {
#pragma unroll
            for (int c = 0; c < 2; ++c) {
              const float dist = __fsub_rn(
                  __fadd_rn(na[mt][h], nb[nt][c]),
                  __fmul_rn(2.0f, acc[mt][nt][2 * h + c]));
              // an invalid row (or one past kb) pushes 3.4e38, which
              // changes nothing
              push(nb[nt][c] < 0.0f ? kBig : fmaxf(dist, 0.0f),
                   r0 + wn * kWN + nt * 8 + 2 * t + c, b0[mt][h], bi[mt][h],
                   b1[mt][h]);
            }
            acc[mt][nt][2 * h] = 0.0f;
            acc[mt][nt][2 * h + 1] = 0.0f;
          }
        }
      }
    }
  }
  cp_async_wait<0>();

  // the 4 threads of a quad share their rows
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int o = 1; o < 4; o <<= 1) {
        const float e0 = __shfl_xor_sync(kFull, b0[mt][h], o);
        const int j0 = __shfl_xor_sync(kFull, bi[mt][h], o);
        const float e1 = __shfl_xor_sync(kFull, b1[mt][h], o);
        merge(e0, j0, e1, b0[mt][h], bi[mt][h], b1[mt][h]);
      }
  // then the 4 warps of a row band, through the (now idle) ring
  __syncthreads();
  float* s_red = s_b;                // [kWarpsN][kBM][3]
  if (t == 0) {
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float* p = s_red + (wn * kBM + wm * kWM + mt * 16 + g + 8 * h) * 3;
        p[0] = b0[mt][h];
        p[1] = __int_as_float(bi[mt][h]);
        p[2] = b1[mt][h];
      }
  }
  __syncthreads();
  if (tid < kBM && q0 + tid < ka) {
    float d0 = s_red[tid * 3], d1 = s_red[tid * 3 + 2];
    int i0 = __float_as_int(s_red[tid * 3 + 1]);
    for (int w = 1; w < kWarpsN; ++w) {
      const float* p = s_red + (w * kBM + tid) * 3;
      merge(p[0], __float_as_int(p[1]), p[2], d0, i0, d1);
    }
    const size_t o = (size_t)batch * ka + q0 + tid;
    if (part != nullptr) {           // one split of several: to scratch
      const size_t plane = (size_t)gridDim.z * gridDim.y * ka;
      const size_t s = (size_t)split_id * gridDim.y * ka + o;
      part[s] = d0;
      reinterpret_cast<int*>(part)[plane + s] = i0;
      part[2 * plane + s] = d1;
    } else {
      out_d0[o] = d0;
      out_i0[o] = i0;
      out_d1[o] = d1;
      if (out_rb != nullptr) {
        const size_t m = (size_t)batch * kb + i0;
        out_rb[o] = rows_b[m];
        out_cb[o] = cols_b[m];
      }
    }
  }
}

// folds the S splits of each query row in split order, then writes the
// outputs (and, for K3, the coordinates at the final i0)
__global__ void matcher_merge_kernel(const float* __restrict__ part,
                                     int splits, int nbatch, int ka, int kb,
                                     const float* __restrict__ rows_b,
                                     const float* __restrict__ cols_b,
                                     float* __restrict__ out_d0,
                                     int* __restrict__ out_i0,
                                     float* __restrict__ out_d1,
                                     float* __restrict__ out_rb,
                                     float* __restrict__ out_cb) {
  const size_t n = (size_t)nbatch * ka;
  const size_t o = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (o >= n) return;
  const size_t plane = (size_t)splits * n;
  const int* pi = reinterpret_cast<const int*>(part) + plane;
  float d0 = part[o], d1 = part[2 * plane + o];
  int i0 = pi[o];
  for (int s = 1; s < splits; ++s) {
    const size_t p = s * n + o;
    merge(part[p], pi[p], part[2 * plane + p], d0, i0, d1);
  }
  out_d0[o] = d0;
  out_i0[o] = i0;
  out_d1[o] = d1;
  if (out_rb != nullptr) {
    const size_t m = (o / ka) * kb + i0;
    out_rb[o] = rows_b[m];
    out_cb[o] = cols_b[m];
  }
}

}  // namespace

// splits: S ranges of whole 128-row train tiles (1: no merge); scratch:
// 3 * S * batch * ka words (d0, i0, d1 planes) when S > 1, else unused
extern "C" int matcher_launch(const float* da, const float* db,
                              const unsigned char* valid_b,
                              const float* rows_b, const float* cols_b,
                              int batch, int ka, int kb, int d, int splits,
                              float* scratch, float* d0, int* i0, float* d1,
                              float* rb_sel, float* cb_sel, void* stream) {
  if (batch < 0 || batch > 65535 || ka < 0 || kb < 1 || d < kKC ||
      d > kMaxD || d % kKC != 0 || splits < 1)
    return (int)cudaErrorInvalidValue;
  const int n_tiles = (kb + kBN - 1) / kBN;
  const int per = (n_tiles + splits - 1) / splits;
  // every split holds at least one tile; scratch where there are several
  if (splits > n_tiles || (splits - 1) * per >= n_tiles ||
      (splits > 1 && scratch == nullptr))
    return (int)cudaErrorInvalidValue;
  if (batch == 0 || ka == 0) return (int)cudaSuccess;
  static bool attr_set[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 64 && !attr_set[dev]) {
    err = cudaFuncSetAttribute(matcher_tc_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem_bytes(kMaxD));
    if (err != cudaSuccess) return (int)err;
    attr_set[dev] = true;
  }
  cudaStream_t st = (cudaStream_t)stream;
  dim3 grid((ka + kBM - 1) / kBM, batch, splits);
  matcher_tc_kernel<<<grid, kThreads, smem_bytes(d), st>>>(
      da, db, valid_b, rows_b, cols_b, ka, kb, d, per,
      splits > 1 ? scratch : nullptr, d0, i0, d1, rb_sel, cb_sel);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return (int)err;
  const size_t n = (size_t)batch * ka;
  matcher_merge_kernel<<<(unsigned)((n + 255) / 256), 256, 0, st>>>(
      scratch, splits, batch, ka, kb, rows_b, cols_b, d0, i0, d1, rb_sel,
      cb_sel);
  return (int)cudaGetLastError();
}

extern "C" int matcher_top2_launch(const float* da, const float* db,
                                   const unsigned char* valid_b, int batch,
                                   int ka, int kb, int d, int splits,
                                   float* scratch, float* d0, int* i0,
                                   float* d1, void* stream) {
  return matcher_launch(da, db, valid_b, nullptr, nullptr, batch, ka, kb, d,
                        splits, scratch, d0, i0, d1, nullptr, nullptr,
                        stream);
}
