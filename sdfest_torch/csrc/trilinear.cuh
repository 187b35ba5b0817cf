// Trilinear sampling of a (res, res, res) float32 SDF grid, shared by the
// march, sample, sample-grad and scatter kernels.
//
// Semantics are those of sdfest_tpu/ops/interpolation.py:28-96: the grid
// spans [-1, 1]^3 and is indexed sdf[x][y][z]; the base cell per axis is
// floor((p + 1) * (res - 1) / 2) clamped to [0, res - 2], and the fraction
// is taken against the clamped cell, so it leaves [0, 1] outside the volume
// (constant-slope extrapolation).  The lerps are written in the same order
// as the JAX and PyTorch versions; the library is compiled with
// -fmad=false, so every product and sum rounds as it does there.
//
// No texture-unit filtering: its 8-bit fractional weights are coarser than
// the sampling error the JAX package already rejected near the surface.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace sdfest {

constexpr int kThreads = 256;

struct Cell {
  int idx;  // flat index of corner (0, 0, 0)
  float fx, fy, fz;
  bool inside;  // unclamped cell was a valid cell
};

__device__ __forceinline__ float base_frac_axis(float p, int res, int* base,
                                                bool* inside) {
  const float grid_size = 2.0f / (float)(res - 1);
  const float c = floorf((p + 1.0f) * (float)(res - 1) * 0.5f);
  *inside = *inside && c >= 0.0f && c <= (float)(res - 2);
  const float b = fminf(fmaxf(c, 0.0f), (float)(res - 2));
  *base = (int)b;
  const float origin = b * grid_size - 1.0f;
  return (p - origin) / grid_size;
}

__device__ __forceinline__ Cell locate(float px, float py, float pz, int res) {
  Cell cell;
  int bx, by, bz;
  cell.inside = true;
  cell.fx = base_frac_axis(px, res, &bx, &cell.inside);
  cell.fy = base_frac_axis(py, res, &by, &cell.inside);
  cell.fz = base_frac_axis(pz, res, &bz, &cell.inside);
  cell.idx = (bx * res + by) * res + bz;
  return cell;
}

// The 8 corners c[dx][dy][dz], read through the read-only data cache.
__device__ __forceinline__ void gather(const float* __restrict__ sdf,
                                       const Cell& cell, int res,
                                       float c[2][2][2]) {
  const int rr = res * res;
#pragma unroll
  for (int dx = 0; dx < 2; ++dx)
#pragma unroll
    for (int dy = 0; dy < 2; ++dy)
#pragma unroll
      for (int dz = 0; dz < 2; ++dz)
        c[dx][dy][dz] = __ldg(sdf + cell.idx + dx * rr + dy * res + dz);
}

// The 8 corners of a bf16 copy of the grid, widened to float32 (exact),
// for the bf16-gated march: the weights and lerps then run in float32.
__device__ __forceinline__ void gather_bf16(
    const __nv_bfloat16* __restrict__ sdf, const Cell& cell, int res,
    float c[2][2][2]) {
  const int rr = res * res;
#pragma unroll
  for (int dx = 0; dx < 2; ++dx)
#pragma unroll
    for (int dy = 0; dy < 2; ++dy)
#pragma unroll
      for (int dz = 0; dz < 2; ++dz)
        c[dx][dy][dz] = __bfloat162float(
            __ldg(sdf + cell.idx + dx * rr + dy * res + dz));
}

// Value of the interpolant (the order of _lerp_corners).
__device__ __forceinline__ float lerp(const float c[2][2][2],
                                      const Cell& cell) {
  const float ux = 1.0f - cell.fx, uy = 1.0f - cell.fy, uz = 1.0f - cell.fz;
  const float c00 = c[0][0][0] * ux + c[1][0][0] * cell.fx;
  const float c01 = c[0][0][1] * ux + c[1][0][1] * cell.fx;
  const float c10 = c[0][1][0] * ux + c[1][1][0] * cell.fx;
  const float c11 = c[0][1][1] * ux + c[1][1][1] * cell.fx;
  const float d0 = c00 * uy + c10 * cell.fy;
  const float d1 = c01 * uy + c11 * cell.fy;
  return d0 * uz + d1 * cell.fz;
}

__device__ __forceinline__ float sample(const float* __restrict__ sdf,
                                        float px, float py, float pz,
                                        int res) {
  const Cell cell = locate(px, py, pz, res);
  float c[2][2][2];
  gather(sdf, cell, res, c);
  return lerp(c, cell);
}

}  // namespace sdfest
