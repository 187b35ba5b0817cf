// Gradient of trilinear sampling w.r.t. the SDF grid (the sampler's
// transpose): each of a point's 8 corner weights times its cotangent,
// accumulated into a (res, res, res) grid.
//
// Replaces the TPU kernel sdfest_tpu/render/pallas_kernel.py:
// scatter_sdf_grad_pallas -> _scatter_impl -> _scatter_kernel (the sdf
// gradient of the fused backward, render/api.py:79-95).
//
// Design.  One thread per row, into a grid that the wrapper zero-fills with
// torch.zeros.  On the main path ~92% of the rows have a zero cotangent,
// and the active ones lie side by side (the queries are 16x16 tile-major),
// so the lanes of a warp mostly share a handful of base cells:
//  1. a warp votes (__ballot_sync) on cotangent != 0, and a warp with no
//     active row leaves before it reads a point;
//  2. __match_any_sync groups the warp's active lanes by base cell; the
//     lowest lane of each group sums the group's 8 corner contributions
//     (shuffles, members in lane order) and issues the group's atomics
//     alone (their results unused: RED instructions);
//  3. when res is even, a leader whose cell has an even z index adds each
//     z-pair of corners with one 8-byte float2 atomicAdd (sm_90): 4
//     atomics instead of 8 (an odd res or z index takes 8 scalar ones).
// 4. blockIdx.z is the hypothesis: its points and cotangents (n rows) and
//    its grid (res^3 values) are its own, and since a block holds rows of
//    one hypothesis only, no warp aggregates across two (8 x 614,400 rows:
//    20.9-21.2 us with the fill against 8 x 7.7, on an NVIDIA H100 80GB
//    HBM3 at 700 W; PERF.md section 6).
// NOT DETERMINISTIC: the order of the float atomics across warps changes
// from run to run, so the last bits of the sums do.  The JAX kernel is
// deterministic (a matmul transpose accumulated over sequential grid steps,
// which has no counterpart on 132 SMs running blocks in no order).
//
// What bounds it on the H100: device-memory bytes for the cotangents (4 B
// per row), the active rows' points and the 1 MiB grid written once; the
// grid stays in L2, so the atomics resolve there, and without aggregation
// the 32 lanes' atomics on a few shared addresses serialize in L2.  A
// zero fill fused into the kernel (a cooperative launch with a grid-wide
// barrier before the atomics) measured slower than torch.zeros plus this
// launch, and is not used.  Measured on an NVIDIA H100 80GB HBM3 at 700 W
// (PERF.md section 6, chip run 5): 4.0 us per launch inside the
// 50-iteration full-frame call (one atomic per corner and row: 5.0 us);
// 7.9-8.0 us against that design's 8.9-9.0 us for the wrapper (fill
// included) over 614,400 rows, of which 5.8-5.9 us is the floor with
// every cotangent zero; float2 pairs 0.3-0.6 us faster than scalar
// atomics.
#include <cuda_runtime.h>

#include "trilinear.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;

__global__ void scatter_kernel(const float* __restrict__ points,
                               const float* __restrict__ cot,
                               float* __restrict__ grad, int n, int res) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const size_t z = blockIdx.z;
  points += z * 3 * n;
  cot += z * n;
  grad += z * res * res * res;
  const float g = i < n ? cot[i] : 0.0f;
  const bool live = g != 0.0f;
  // every lane of the warp stays until the shuffles: no exit before here
  if (__ballot_sync(kFull, live) == 0u) return;

  // this lane's 8 corner contributions c[dx * 4 + dy * 2 + dz]
  float c[8];
  int key = -1;  // the base cell; -1 for a lane with nothing to add
  if (live) {
    const sdfest::Cell cell = sdfest::locate(points[3 * i], points[3 * i + 1],
                                             points[3 * i + 2], res);
    const float wx[2] = {1.0f - cell.fx, cell.fx};
    const float wy[2] = {1.0f - cell.fy, cell.fy};
    const float wz[2] = {1.0f - cell.fz, cell.fz};
#pragma unroll
    for (int k = 0; k < 8; ++k)
      c[k] = wx[k >> 2] * wy[(k >> 1) & 1] * wz[k & 1] * g;
    key = cell.idx;
  } else {
#pragma unroll
    for (int k = 0; k < 8; ++k) c[k] = 0.0f;
  }
  const int lane = threadIdx.x & 31;
  const unsigned group = __match_any_sync(kFull, key);
  const bool leader = live && __ffs(group) - 1 == lane;
  // the leader adds its group's other members, lowest lane first
  unsigned rest = leader ? group & (group - 1u) : 0u;
  while (__any_sync(kFull, rest != 0u)) {
    const int src = rest ? __ffs(rest) - 1 : lane;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const float v = __shfl_sync(kFull, c[k], src);
      if (rest) c[k] += v;
    }
    rest &= rest - 1u;
  }
  if (!leader) return;

  const int rr = res * res;
  // an even res and key put each z-pair at an 8-byte aligned address
  if (((res | key) & 1) == 0) {
#pragma unroll
    for (int k = 0; k < 8; k += 2)
      atomicAdd(reinterpret_cast<float2*>(grad + key + (k >> 2) * rr +
                                          ((k >> 1) & 1) * res),
                make_float2(c[k], c[k + 1]));
  } else {
#pragma unroll
    for (int k = 0; k < 8; ++k)
      atomicAdd(grad + key + (k >> 2) * rr + ((k >> 1) & 1) * res + (k & 1),
                c[k]);
  }
}

}  // namespace

// grad: 8-byte aligned (the float2 atomics of an even res; res^3 floats per
// hypothesis keep every hypothesis's grid so).  batch hypotheses of n rows
// each, one after the other in every operand.
extern "C" int sdfest_scatter(const float* points, const float* cot,
                              float* grad, int n, int batch, int res,
                              void* stream) {
  if (n <= 0 || batch <= 0) return 0;
  const dim3 blocks((n + sdfest::kThreads - 1) / sdfest::kThreads, 1, batch);
  scatter_kernel<<<blocks, sdfest::kThreads, 0, (cudaStream_t)stream>>>(
      points, cot, grad, n, res);
  return (int)cudaGetLastError();
}
