// Masked trilinear sampling with clamped-base extrapolation.
//
// Replaces the TPU kernel sdfest_tpu/render/pallas_kernel.py:
// sample_sdf_pallas -> _sample_impl -> _sample_kernel (the pc values of the
// fused render + pc forward, render/api.py:305).
//
// Design.  One thread per row.  It issues the loads of its point and of
// its mask together (the point's before the mask is known, so that the two
// latencies overlap); a row whose mask is 0 writes 0 and touches nothing
// else; a valid row gathers its 8 corners through the read-only cache and
// writes value * mask.  The TPU kernel's one-hot MXU factorization, y/z
// windows and tile compaction worked around the TPU's slow gathers and are
// not carried over.
//
// What bounds it on the H100: not its bytes (4 B of mask and 4 B of output
// per row, 12 B of point; 2.54 MB at the main path's 307,200 rows, a bound
// of 0.76 us) but the launch and one chain of dependent loads per active
// warp.  Measured on an NVIDIA H100 80GB HBM3 at 700 W (PERF.md section
// 6): an empty kernel of the same 1,200 blocks takes 2.4-2.7 us of the
// 4.2-4.6 us; inputs cold in HBM cost ~1 us more than inputs hot in L2.
// Several rows per thread (4 with 16-byte loads, or 2) measured slower:
// the object's rows are consecutive, so they lengthen each active warp's
// chain more than the fewer blocks shorten the launch.
#include <cuda_runtime.h>

#include "trilinear.cuh"

namespace {

// A load issued where it is written (not sunk into the branch that uses
// it), so that it is in flight together with the mask's.
__device__ __forceinline__ float load_now(const float* p) {
  float v;
  asm volatile("ld.global.nc.f32 %0, [%1];" : "=f"(v) : "l"(p));
  return v;
}

__global__ void sample_kernel(const float* __restrict__ sdf,
                              const float* __restrict__ points,
                              const float* __restrict__ mask,
                              float* __restrict__ out, int n, int res) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float px = load_now(points + 3 * i);
  const float py = load_now(points + 3 * i + 1);
  const float pz = load_now(points + 3 * i + 2);
  const float m = mask[i];
  if (m == 0.0f) {
    out[i] = 0.0f;
    return;
  }
  out[i] = sdfest::sample(sdf, px, py, pz, res) * m;
}

__global__ void empty_kernel() {}

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

// An empty kernel of `blocks` blocks of kThreads: the launch floor that
// chip_smoke.py times at the sampler's geometry.
extern "C" int sdfest_empty(int blocks, void* stream) {
  empty_kernel<<<blocks, sdfest::kThreads, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}
