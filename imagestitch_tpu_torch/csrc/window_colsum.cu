// K6: per-keypoint column sums of a rows x cols window of an atlas,
// out[i, c] = sum_{r < rows} atlas[r0[i] + r, ca[i] + c].
//
// Replaces scripts/profile_r4_micro2.py::proto (the Pallas call at
// profile_r4_micro2.py:150, kernel body _proto_kernel at :128-145): the
// round-4 prototype of K2's band-streamed window backbone, which reads a
// 24 x 256 window per keypoint and keeps the column sums of its first 128
// columns.
//
// What bounds it on an H100: device memory.  Each keypoint reads 24 rows of
// 512 bytes and does 23 adds a column, so the work is a gather of windows.
// The TPU version streamed the atlas in 256-row bands (plus a 24-row halo)
// into VMEM and looked keypoints up per band by scalar prefetch, because
// Mosaic cannot gather from device memory.  Here each block reads its
// keypoint's window straight from device memory; neighbouring keypoints
// share rows, and L2 (50 MB, more than the atlas) serves those.
//
// Design: one block of 128 threads per keypoint, one thread per column.
// The block loads its own (r0, ca); each row of the window is one coalesced
// 512-byte read; the rows are summed in order with __fadd_rn from 0, so the
// kernel is bit-equal to the plain version (ops/kernels/window_sum.py).
// TMA loads and several keypoints per block are later work.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads)
window_colsum_kernel(const float* __restrict__ atlas, int aw,
                     const int* __restrict__ r0, const int* __restrict__ ca,
                     int rows, int cols, float* __restrict__ out) {
  const int kp = blockIdx.x;
  const float* win = atlas + (size_t)r0[kp] * aw + ca[kp];
  float* o = out + (size_t)kp * cols;
  for (int c = threadIdx.x; c < cols; c += kThreads) {
    float acc = 0.0f;
    for (int r = 0; r < rows; ++r)
      acc = __fadd_rn(acc, win[(size_t)r * aw + c]);
    o[c] = acc;
  }
}

}  // namespace

extern "C" int window_colsum_launch(const float* atlas, int ah, int aw,
                                    const int* r0, const int* ca, int k,
                                    int rows, int cols, float* out,
                                    void* stream) {
  if (rows < 1 || cols < 1 || rows > ah || cols > aw || k < 0)
    return (int)cudaErrorInvalidValue;
  if (k == 0) return (int)cudaSuccess;
  window_colsum_kernel<<<k, kThreads, 0, (cudaStream_t)stream>>>(
      atlas, aw, r0, ca, rows, cols, out);
  return (int)cudaGetLastError();
}
