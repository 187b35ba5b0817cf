// Trilinear value and its gradient w.r.t. the normalized point, masked.
//
// Replaces the TPU kernel sdfest_tpu/render/pallas_kernel.py:
// sample_sdf_grad_pallas -> _sample_grad_impl -> _sample_grad_kernel /
// _sample_grad_tile_win (the residuals of the fused backward,
// render/api.py:68-76 inside _render_pc_bwd).
//
// Design.  One thread per point; blockIdx.z is the hypothesis, whose grid,
// points, mask and outputs are its own (as in sample.cu; 8 x 614,400 rows:
// 39.1 us against 8 x 6.5, 1.3x the bytes' bound, on an NVIDIA H100 80GB
// HBM3 at 700 W; PERF.md section 6).  A row whose mask is 0 writes zeros
// and reads nothing else.  A valid row gathers its 8 corners once and
// forms the value and the three partials of the extrapolated trilinear
// form in closed form (piecewise-constant base cell, constant-slope
// fraction, chain factor (res - 1) / 2, as autodiff of the XLA sampler
// gives); each output is multiplied by the mask once.
//
// What bounds it on the H100: device-memory bytes (16 B in and 16 B out per
// row).  The gradient reuses the gathered corners, so it costs no extra
// memory traffic over the value.
#include <cuda_runtime.h>

#include "trilinear.cuh"

namespace {

__global__ void sample_grad_kernel(const float* __restrict__ sdf,
                                   const float* __restrict__ points,
                                   const float* __restrict__ mask,
                                   float* __restrict__ value,
                                   float* __restrict__ grad, int n, int res) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const size_t z = blockIdx.z;
  sdf += z * res * res * res;
  points += z * 3 * n;
  mask += z * n;
  value += z * n;
  grad += z * 3 * n;
  const float m = mask[i];
  if (m == 0.0f) {
    value[i] = 0.0f;
    grad[3 * i] = 0.0f;
    grad[3 * i + 1] = 0.0f;
    grad[3 * i + 2] = 0.0f;
    return;
  }
  const sdfest::Cell cell =
      sdfest::locate(points[3 * i], points[3 * i + 1], points[3 * i + 2], res);
  float c[2][2][2];
  sdfest::gather(sdf, cell, res, c);
  const float wx[2] = {1.0f - cell.fx, cell.fx};
  const float wy[2] = {1.0f - cell.fy, cell.fy};
  const float wz[2] = {1.0f - cell.fz, cell.fz};
  float c0[2][2];
#pragma unroll
  for (int dy = 0; dy < 2; ++dy)
#pragma unroll
    for (int dz = 0; dz < 2; ++dz)
      c0[dy][dz] = c[0][dy][dz] * wx[0] + c[1][dy][dz] * wx[1];
  const float c00_0 = c0[0][0] * wy[0] + c0[1][0] * wy[1];
  const float c00_1 = c0[0][1] * wy[0] + c0[1][1] * wy[1];
  const float v = c00_0 * wz[0] + c00_1 * wz[1];
  float gx = 0.0f;
#pragma unroll
  for (int dy = 0; dy < 2; ++dy)
#pragma unroll
    for (int dz = 0; dz < 2; ++dz)
      gx += (c[1][dy][dz] - c[0][dy][dz]) * wy[dy] * wz[dz];
  const float gy =
      (c0[1][0] - c0[0][0]) * wz[0] + (c0[1][1] - c0[0][1]) * wz[1];
  const float gz = c00_1 - c00_0;
  const float s = (float)(res - 1) * 0.5f;
  value[i] = v * m;
  grad[3 * i] = gx * s * m;
  grad[3 * i + 1] = gy * s * m;
  grad[3 * i + 2] = gz * s * m;
}

}  // namespace

extern "C" int sdfest_sample_grad(const float* sdf, const float* points,
                                  const float* mask, float* value,
                                  float* grad, int n, int batch, int res,
                                  void* stream) {
  if (n <= 0 || batch <= 0) return 0;
  const dim3 blocks((n + sdfest::kThreads - 1) / sdfest::kThreads, 1, batch);
  sample_grad_kernel<<<blocks, sdfest::kThreads, 0, (cudaStream_t)stream>>>(
      sdf, points, mask, value, grad, n, res);
  return (int)cudaGetLastError();
}
