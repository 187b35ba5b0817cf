// Masked trilinear sampling with clamped-base extrapolation.
//
// Replaces the TPU kernel sdfest_tpu/render/pallas_kernel.py:
// sample_sdf_pallas -> _sample_impl -> _sample_kernel (the pc values of the
// fused render + pc forward, render/api.py:305).
//
// Design.  One thread per point: it reads its point and mask, and a row
// whose mask is 0 writes 0 and reads nothing else; a valid row gathers its
// 8 corners through the read-only cache and writes value * mask.  The TPU
// kernel's one-hot MXU factorization, y/z windows and tile compaction
// worked around the TPU's slow gathers and are not carried over.
//
// What bounds it on the H100: device-memory bytes (16 B of point + mask in
// and 4 B out per row; the 1 MiB grid is read from L2 after its first
// touch).  Loads are coalesced across the warp; nothing else is needed.
#include <cuda_runtime.h>

#include "trilinear.cuh"

namespace {

__global__ void sample_kernel(const float* __restrict__ sdf,
                              const float* __restrict__ points,
                              const float* __restrict__ mask,
                              float* __restrict__ out, int n, int res) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float m = mask[i];
  if (m == 0.0f) {
    out[i] = 0.0f;
    return;
  }
  const float v = sdfest::sample(sdf, points[3 * i], points[3 * i + 1],
                                 points[3 * i + 2], res);
  out[i] = v * m;
}

}  // namespace

extern "C" int sdfest_sample(const float* sdf, const float* points,
                             const float* mask, float* out, int n, int res,
                             void* stream) {
  if (n <= 0) return 0;
  const int blocks = (n + sdfest::kThreads - 1) / sdfest::kThreads;
  sample_kernel<<<blocks, sdfest::kThreads, 0, (cudaStream_t)stream>>>(
      sdf, points, mask, out, n, res);
  return (int)cudaGetLastError();
}
