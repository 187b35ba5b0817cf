// Sphere-trace march: a posed, scaled 64^3 SDF rendered into a depth image.
//
// Replaces the TPU kernel sdfest_tpu/render/pallas_kernel.py:
// render_depth_pallas_fwd -> _render_fwd_impl -> _march_kernel /
// _march_kernel_body, default "v2" branch (culling=True, adaptive=True,
// relaxation=1, no bf16, no aux), and its ROI crop branch
// (pallas_kernel.py:1708-1760, :1660-1667).
//
// ROI renders: the kernel marches whatever n rays it is given.  An ROI
// render passes the (Hr, Wr) crop of the camera's direction field at the
// ROI offset (gathered once per refinement phase on the device, see
// render/api.py: ray_set); a ray's result depends on its direction alone,
// so the ROI render equals the crop of the full render bit for bit and no
// tile alignment is needed.
//
// Design.  One thread per pixel, 256 threads per block.  The TPU kernel
// marched 16x16-pixel tiles in lock-step with one-hot MXU matmuls standing
// in for gathers; on Hopper a ray reads its 8 trilinear corners directly
// (__ldg through L1/L2: the 1 MiB grid stays resident in the 50 MB L2), and
// every ray runs its own trip count.
//
// Per ray:
//  1. rotate the host-constant f32 camera ray into the object frame;
//  2. OBB slab test exactly as sdfest_tpu/render/xla.py:50-72;
//  3. up to max_steps steps, each one sample or one bound lookup:
//     - culling: the coarse 16^3 lower-bound table (coarse_min_table, kept
//       in shared memory, 16 KB) gives a certified step C*scale when
//       C*scale >= threshold*t + 1e-5 (pallas_kernel.py:524, :1155); a
//       bound step restarts the over-relaxation chain (:1157-1158);
//     - otherwise a fine sample; with `adaptive` the per-ray
//       over-relaxation with certified revert of pallas_kernel.py:1082-1112
//       (omega from 1.4, +0.2 per certified step up to 1.9, reset to 1 on
//       revert; a hit fires only on a certified sample);
//     - the ray stops once t >= t_max, checked after every step.
//  depth = -t * d_z at the hit, 0 otherwise.
// The TPU decided coarse/fine per tile; here each ray decides for itself.
// That changes only the stepping noise, inside the JAX package's own parity
// bar (hit agreement > 0.995, |ddepth| < 5e-3 where both hit).
//
// What bounds it on the H100: neither bytes (about 6 MB in and out at
// 640x480) nor arithmetic, but the latency of dependent L2 gathers along
// each ray's step chain and the divergence of trip counts within a warp.
// The design keeps the hot table in shared memory and lets rays retire
// independently; grouping rays by expected trip count is left for later.
#include <cuda_runtime.h>

#include "trilinear.cuh"

namespace {

constexpr int kNC = 16;  // coarse culling grid per axis
constexpr float kOmegaInit = 1.4f;
constexpr float kOmegaGrow = 0.2f;
constexpr float kOmegaMax = 1.9f;

// pose: [rot (3x3, row-major), origin_o (3), inv_scale, scale]
__global__ void march_kernel(const float* __restrict__ sdf,
                             const float* __restrict__ coarse,
                             const float* __restrict__ dirs,
                             const float* __restrict__ pose,
                             float* __restrict__ depth, int n, int res,
                             float threshold, int max_steps, int culling,
                             int adaptive) {
  __shared__ float coarse_s[kNC * kNC * kNC];
  if (culling) {
    for (int k = threadIdx.x; k < kNC * kNC * kNC; k += blockDim.x)
      coarse_s[k] = coarse[k];
    __syncthreads();
  }
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;

  float rot[9];
#pragma unroll
  for (int k = 0; k < 9; ++k) rot[k] = __ldg(pose + k);
  const float ox = __ldg(pose + 9), oy = __ldg(pose + 10), oz = __ldg(pose + 11);
  const float inv_scale = __ldg(pose + 12);
  const float scale = __ldg(pose + 13);

  const float dx = dirs[3 * i], dy = dirs[3 * i + 1], dz = dirs[3 * i + 2];
  // dirs_o = dirs @ rot
  float d[3];
#pragma unroll
  for (int a = 0; a < 3; ++a)
    d[a] = dx * rot[a] + dy * rot[3 + a] + dz * rot[6 + a];

  // slab test of the ray (origin 0) against the box, e = -origin_o
  const float e[3] = {-ox, -oy, -oz};
  float lo = -INFINITY, hi = INFINITY;
  bool miss_parallel = false;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    if (fabsf(d[a]) <= 1e-20f) {
      miss_parallel = miss_parallel || fabsf(e[a]) > scale;
    } else {
      const float t1 = (e[a] + scale) / d[a];
      const float t2 = (e[a] - scale) / d[a];
      lo = fmaxf(lo, fminf(t1, t2));
      hi = fminf(hi, fmaxf(t1, t2));
    }
  }
  float t = fmaxf(lo, -1e-10f);
  const float t_max = hi;
  const bool hit_box = !miss_parallel && t <= t_max && t_max >= 0.0f;
  t = fmaxf(t, 0.0f);
  float result = 0.0f;
  if (hit_box && t < t_max) {
    float stepped = 0.0f, d_prev = 0.0f;
    float omega = adaptive ? kOmegaInit : 1.0f;
    for (int step = 0; step < max_steps; ++step) {
      const float px = (ox + t * d[0]) * inv_scale;
      const float py = (oy + t * d[1]) * inv_scale;
      const float pz = (oz + t * d[2]) * inv_scale;
      if (culling) {
        const float h = kNC * 0.5f;
        const int cx = (int)fminf(fmaxf(floorf((px + 1.0f) * h), 0.0f), kNC - 1);
        const int cy = (int)fminf(fmaxf(floorf((py + 1.0f) * h), 0.0f), kNC - 1);
        const int cz = (int)fminf(fmaxf(floorf((pz + 1.0f) * h), 0.0f), kNC - 1);
        const float cd = coarse_s[(cx * kNC + cy) * kNC + cz] * scale;
        if (cd >= threshold * t + 1e-5f) {
          t = t + cd;
          stepped = 0.0f;
          if (!(t < t_max)) break;
          continue;
        }
      }
      const float dist = sdfest::sample(sdf, px, py, pz, res) * scale;
      if (adaptive) {
        if (stepped > d_prev + dist && stepped > 0.0f) {
          // uncertified overstep: back to the last certified point
          t = t - stepped + d_prev;
          stepped = 0.0f;
          omega = 1.0f;
        } else {
          if (dist < threshold * t) {
            result = -t * dz;
            break;
          }
          const float step_len = omega * dist;
          t = t + step_len;
          stepped = step_len;
          d_prev = dist;
          omega = fminf(omega + kOmegaGrow, kOmegaMax);
        }
      } else {
        if (dist < threshold * t) {
          result = -t * dz;
          break;
        }
        t = t + dist;
      }
      if (!(t < t_max)) break;
    }
  }
  depth[i] = result;
}

}  // namespace

extern "C" int sdfest_march(const float* sdf, const float* coarse,
                            const float* dirs, const float* pose,
                            float* depth, int n, int res, float threshold,
                            int max_steps, int culling, int adaptive,
                            void* stream) {
  if (n <= 0) return 0;
  const int blocks = (n + sdfest::kThreads - 1) / sdfest::kThreads;
  march_kernel<<<blocks, sdfest::kThreads, 0, (cudaStream_t)stream>>>(
      sdf, coarse, dirs, pose, depth, n, res, threshold, max_steps, culling,
      adaptive);
  return (int)cudaGetLastError();
}
