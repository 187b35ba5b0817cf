// Gradient of trilinear sampling w.r.t. the SDF grid (the sampler's
// transpose): each of a point's 8 corner weights times its cotangent,
// accumulated into a (res, res, res) grid.
//
// Replaces the TPU kernel sdfest_tpu/render/pallas_kernel.py:
// scatter_sdf_grad_pallas -> _scatter_impl -> _scatter_kernel (the sdf
// gradient of the fused backward, render/api.py:79-95).
//
// Design.  One thread per point with a nonzero cotangent; it does one
// atomicAdd per corner into a grid that the wrapper zero-fills with
// torch.zeros.  NOT DETERMINISTIC: the order of the float atomics changes
// from run to run, so the last bits of the sums do.  The JAX kernel is
// deterministic (a matmul transpose accumulated over sequential grid steps,
// which has no counterpart on 132 SMs running blocks in no order).
//
// What bounds it on the H100: device-memory bytes for the points and
// cotangents (16 B per row), then the L2 atomic throughput where many rays
// hit the same voxels; the 1 MiB grid stays in L2, so the atomics resolve
// there.
#include <cuda_runtime.h>

#include "trilinear.cuh"

namespace {

__global__ void scatter_kernel(const float* __restrict__ points,
                               const float* __restrict__ cot,
                               float* __restrict__ grad, int n, int res) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float g = cot[i];
  if (g == 0.0f) return;
  const sdfest::Cell cell =
      sdfest::locate(points[3 * i], points[3 * i + 1], points[3 * i + 2], res);
  const float wx[2] = {1.0f - cell.fx, cell.fx};
  const float wy[2] = {1.0f - cell.fy, cell.fy};
  const float wz[2] = {1.0f - cell.fz, cell.fz};
  const int rr = res * res;
#pragma unroll
  for (int dx = 0; dx < 2; ++dx)
#pragma unroll
    for (int dy = 0; dy < 2; ++dy)
#pragma unroll
      for (int dz = 0; dz < 2; ++dz)
        atomicAdd(grad + cell.idx + dx * rr + dy * res + dz,
                  wx[dx] * wy[dy] * wz[dz] * g);
}

}  // namespace

extern "C" int sdfest_scatter(const float* points, const float* cot,
                              float* grad, int n, int res, void* stream) {
  if (n <= 0) return 0;
  const int blocks = (n + sdfest::kThreads - 1) / sdfest::kThreads;
  scatter_kernel<<<blocks, sdfest::kThreads, 0, (cudaStream_t)stream>>>(
      points, cot, grad, n, res);
  return (int)cudaGetLastError();
}
