// Sphere-trace march: a posed, scaled 64^3 SDF rendered into a depth image.
//
// Replaces the TPU kernel sdfest_tpu/render/pallas_kernel.py:
// render_depth_pallas_fwd -> _render_fwd_impl -> _march_kernel /
// _march_kernel_body, in these branches:
//  - march_kernel: the default "v2" branch (culling=True, adaptive=True,
//    relaxation=1, no bf16, no aux), the plain branch (culling and adaptive
//    off, :1377-1397), the relaxed branches (relaxation > 1, with culling
//    :1398-1501 and without :1502-1548) and the ROI crop branch
//    (pallas_kernel.py:1708-1760, :1660-1667);
//  - march_warm_kernel: the warm/aux corridor march of temporal coherence
//    (t_init/skip in, aux=True, :636-650, :657-776), described above it;
//  - the bf16-verified branches, as the kBf16 instances of both kernels:
//    the culling march (bf16=True, :1296-1376), the relaxed culling march
//    (:1445-1472) and the warm/aux march (:777-881), described at
//    kBf16Err below.
// Every TPU branch of the march has its counterpart here.
//
// ROI renders: the kernel marches whatever n rays it is given.  An ROI
// render passes the (Hr, Wr) crop of the camera's direction field at the
// ROI offset (gathered once per refinement phase on the device, see
// render/api.py: ray_set); a ray's result depends on its direction alone,
// so the ROI render equals the crop of the full render bit for bit and no
// tile alignment is needed.
//
// Design.  One thread per pixel; in a culling march a block of 256 threads
// is one 16x16 tile of the (H, W) raster (a flat (N, 3) ray set, or a
// march without culling: 256 consecutive rays; without a table to skip,
// tiles only cost time: 15.0 against 14.3 us for the plain march).  The
// TPU kernel marched 16x16-pixel tiles in lock-step with one-hot MXU
// matmuls standing in for gathers; on Hopper a ray reads its 8 trilinear
// corners directly (__ldg through L1/L2: the 1 MiB grid stays resident in
// the 50 MB L2), and every ray runs its own trip count.  Rays are read and
// written in raster order; a thread outside a ragged raster's edge takes
// part in the block's barriers and writes nothing.
//
// Hypotheses.  Both kernels take a batch of hypotheses from blockIdx.z
// (grid_of): hypothesis z reads its own grid, bf16 grid, coarse table and
// pose (each at z times its size past the base) and writes its own outputs
// (z * n past theirs), and the rays, shared by all, are read by every
// hypothesis.  The vote and the table copy stay per (tile, hypothesis)
// block; an unbatched call is the launch with one hypothesis.  This stands
// for the JAX package's vmap over hypotheses (refine_batch), which runs its
// Pallas calls one hypothesis after another (_sequential_vmap,
// pallas_kernel.py:176-206): here one launch serves every hypothesis
// (the default march: 36.3-36.6 us for 8 at 640x480 against 8 x 16.1-16.3,
// and a byte bound of 4.3 us, 14.4 MB with the shared directions read once,
// on an NVIDIA H100 80GB HBM3 at 700 W, PERF.md section 6).
//
// Per-tile culling (the TPU kernel's compaction to active tiles,
// pallas_kernel.py:546-561 with _obb_interval_tile :564, done per block
// without a prefetch pass), in both kernels: every thread first runs its
// ray's slab test, then the block votes (__syncthreads_or).  A tile where no
// ray marches writes its non-marching outputs and leaves without the coarse
// table (the warm march also counts skipped rays and warm starts past the
// exit as not marching); in the others
// thread 0 issues one TMA bulk copy of it into shared memory and the tile
// waits on the copy's mbarrier.  The table lives in dynamic shared memory,
// at its 128-byte aligned base (a TMA copy into a merely 16-byte aligned
// destination measured several times slower), so a launch without culling
// holds none and the SM's L1 stays with the grid's gathers.
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
//     - with relaxation > 1 (Keinert et al. 2014; `adaptive` is ignored, as
//       the TPU dispatch takes v2 only when relaxation <= 1): a fine step
//       goes t += relaxation * d; when the unbounding spheres of two
//       consecutive samples do not overlap (stepped > d_prev + d) the ray
//       reverts to t - stepped + d_prev and steps plainly from there
//       (:1512-1535); with culling a bound step is taken only when the
//       bound also validates the pending overshoot (stepped <= d_prev + cd)
//       and resets the chain (:1414-1417, :1481-1487);
//     - the ray stops once t >= t_max, checked after every step.
//  depth = -t * d_z at the hit, 0 otherwise.
// The TPU decided coarse/fine per tile; here each ray decides for itself.
// That changes only the stepping noise, inside the JAX package's own parity
// bar (hit agreement > 0.995, |ddepth| < 5e-3 where both hit).
//
// What bounds it on the H100: neither bytes (about 5 MB in and out at
// 640x480) nor arithmetic, but the latency of dependent L2 gathers along
// each ray's step chain and the divergence of trip counts within a warp.
// A design that copies the table (16 KB, 32 KB for bf16) into every block
// before its first ray starts moves 19.7 MB (39.3 MB) from L2 per 640x480
// launch of 1,200 blocks, where only ~8% of the rays meet the box; here the
// copy happens only in tiles with a ray in the box (124 of 1,200 on
// average at the timed poses).  Measured on an NVIDIA H100 80GB HBM3 at
// 700 W, mean of 30 launches at 640x480 (PERF.md section 6, chip run 5):
// the default march takes 16.2 us and the bf16 march 18.8-18.9 us, against
// 18.9 and 22.1 us with the copy in every block.  A float4 copy by the
// whole block after the vote, and a TMA copy issued before the slab test,
// measured slower (PERF.md section 6).
// What remains: a frame where every ray misses the box still takes 4.6-4.7
// us (1,200 blocks of 48 registers, 5 per SM: two waves of slab tests),
// and the longest per-ray step chains of the active tiles, with trip-count
// divergence; grouping rays by expected trip count is left for later.
// The bf16 branch halves the bytes of a fast sample (a 512 KiB bf16 grid)
// but gathers twice on a verified step and gives up the adaptive
// over-relaxation.
#include <cuda_runtime.h>

#include "trilinear.cuh"

namespace {

constexpr int kNC = 16;  // coarse culling grid per axis
constexpr int kCells = kNC * kNC * kNC;
constexpr float kOmegaInit = 1.4f;
constexpr float kOmegaGrow = 0.2f;
constexpr float kOmegaMax = 1.9f;

// bf16-verified sampling (bf16_march).  A fine step first takes a sample
// d_fast on a bf16 copy of the grid (the wrapper rounds it once per grid,
// round to nearest even); only the 8 corners are rounded, the weights, the
// lerps and the sums stay float32 in the order of sdfest::lerp.  Its error
// is bounded by err = kBf16Err * amax * scale, amax the max |value| over
// the coarse cell's window (the second column of the interleaved table).
// If d_fast < threshold*t + err the ray may be within reach of a hit: the
// step is verified with the exact fp32 sample and runs as the fp32 march
// would.  Otherwise the fp32 value d >= d_fast - err >= threshold*t, so no
// hit is possible and the ray takes a certified fast step:
//  - culling march: t += d_fast - err (:1351-1353), with relaxation 1 and
//    no adaptive over-relaxation (the TPU takes v2 only without bf16);
//  - relaxed culling march: Keinert's update with the certified radius
//    d_fast - err and the step relaxation * d_fast, no hit (:1462-1467);
//  - warm/aux march: the corridor takes the lower bound d_fast - err, and
//    t += d_fast - err (:839-845).
// The TPU verified a whole 16x16 tile when any of its rays was a
// candidate; here each ray decides for itself, which changes only the
// stepping noise, inside the march's bar.
//
// The bound.  bf16 keeps 8 significant bits, so rounding to nearest moves
// a corner c by at most 2^-8 |c|.  Inside the box the trilinear weights w_i
// lie in [0, 1] and sum to 1, so |d_fast - d| <= sum_i w_i 2^-8 |c_i| <=
// 2^-8 amax = 3.9e-3 amax, plus the float32 rounding of the two lerps, of
// order 1e-7 amax.  6e-3 (the TPU's _BF16_ERR) keeps a 1.5x margin.
// Rounding the weights as well would double the worst case to ~7.8e-3
// amax; they are not rounded.  (The TPU's 1-pass bf16 matmul rounds both
// operands, and its comment takes bf16's rounding as 2^-9.)
constexpr float kBf16Err = 6e-3f;

// A ray in the object frame and its slab test against the scaled box
// (sdfest_tpu/render/xla.py:50-72): every product and sum in the order of
// render/plain.py (object_rays, obb_interval), so t_min and t_max equal the
// plain version's bit for bit.
struct Ray {
  float ox, oy, oz, inv_scale, scale;
  float d[3];
  float dz;  // camera-frame z of the direction (depth = -t * dz)
  float t_min, t_max;
  bool hit;
};

// pose: [rot (3x3, row-major), origin_o (3), inv_scale, scale]
__device__ __forceinline__ Ray setup_ray(const float* __restrict__ dirs,
                                         const float* __restrict__ pose,
                                         int i) {
  Ray r;
  float rot[9];
#pragma unroll
  for (int k = 0; k < 9; ++k) rot[k] = __ldg(pose + k);
  r.ox = __ldg(pose + 9);
  r.oy = __ldg(pose + 10);
  r.oz = __ldg(pose + 11);
  r.inv_scale = __ldg(pose + 12);
  r.scale = __ldg(pose + 13);
  const float dx = dirs[3 * i], dy = dirs[3 * i + 1], dz = dirs[3 * i + 2];
  r.dz = dz;
  // dirs_o = dirs @ rot
#pragma unroll
  for (int a = 0; a < 3; ++a)
    r.d[a] = dx * rot[a] + dy * rot[3 + a] + dz * rot[6 + a];
  // slab test of the ray (origin 0) against the box, e = -origin_o
  const float e[3] = {-r.ox, -r.oy, -r.oz};
  float lo = -INFINITY, hi = INFINITY;
  bool miss_parallel = false;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    if (fabsf(r.d[a]) <= 1e-20f) {
      miss_parallel = miss_parallel || fabsf(e[a]) > r.scale;
    } else {
      const float t1 = (e[a] + r.scale) / r.d[a];
      const float t2 = (e[a] - r.scale) / r.d[a];
      lo = fmaxf(lo, fminf(t1, t2));
      hi = fminf(hi, fmaxf(t1, t2));
    }
  }
  const float t = fmaxf(lo, -1e-10f);
  r.t_max = hi;
  r.hit = !miss_parallel && t <= r.t_max && r.t_max >= 0.0f;
  r.t_min = fmaxf(t, 0.0f);
  return r;
}

// The coarse cell of a point, as the lookup of pallas_kernel.py:524.
__device__ __forceinline__ int coarse_cell(float px, float py, float pz) {
  const float h = kNC * 0.5f;
  const int cx = (int)fminf(fmaxf(floorf((px + 1.0f) * h), 0.0f), kNC - 1);
  const int cy = (int)fminf(fmaxf(floorf((py + 1.0f) * h), 0.0f), kNC - 1);
  const int cz = (int)fminf(fmaxf(floorf((pz + 1.0f) * h), 0.0f), kNC - 1);
  return (cx * kNC + cy) * kNC + cz;
}

// The pixel of this thread, -1 outside the rays.  h > 0: the block is the
// 16x16 tile (blockIdx.x, blockIdx.y) of an (h, w) raster, thread k at
// (row k / 16, column k % 16) of the tile; h == 0: a flat set of n rays in
// 1-D blocks.
constexpr int kTile = 16;
static_assert(kTile * kTile == sdfest::kThreads, "a block is one tile");

// The hypothesis of this block and the offsets of its operands: its grid
// (res^3 values), its coarse table (`table_floats`), its pose (14 floats)
// and its outputs (n values each).
struct Hyp {
  size_t grid, table, pose, rays;
};

// Blocks of 256 the warm march keeps resident per SM: the register budget
// of 5 (at most 51 registers, 48 allocated) for the fp32 instance and of 4
// for the bf16 one, what each took before the hypothesis offsets.  Left to
// itself ptxas gave both 56 registers, and the fp32 instance fell to 4
// blocks: a launch of short blocks (a frame where every ray is skipped)
// went from 6.4 to 7.5 us on an NVIDIA H100 80GB HBM3 at 700 W (PERF.md
// section 6).  march_kernel takes no bound: the same bound of 5 slowed its
// fp32 instances by 0.5-0.8 us at the 48 registers they take anyway.
constexpr int kWarmBlocks = 5;

__device__ __forceinline__ Hyp hypothesis(int n, int res, int table_floats) {
  const size_t z = blockIdx.z;
  return {z * res * res * res, z * table_floats, z * 14, z * n};
}

__device__ __forceinline__ int pixel_index(int n, int h, int w) {
  if (h == 0) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    return i < n ? i : -1;
  }
  const int x = blockIdx.x * kTile + (int)threadIdx.x % kTile;
  const int y = blockIdx.y * kTile + (int)threadIdx.x / kTile;
  return x < w && y < h ? y * w + x : -1;
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// One thread: arm the block's mbarrier for `bytes` and start one TMA bulk
// copy of them from global (16-byte aligned) into shared memory.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          unsigned bytes,
                                          unsigned long long* bar) {
  const unsigned b = smem_addr(bar);
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(b) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   b),
               "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(b)
      : "memory");
}

// Wait until the copy armed on `bar` has landed (phase 0 completed).
__device__ __forceinline__ void bulk_wait(unsigned long long* bar) {
  const unsigned b = smem_addr(bar);
  unsigned done = 0;
  while (!done) {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(b)
        : "memory");
  }
}

// The coarse table of both marches, copied by one TMA bulk copy into the
// block's dynamic shared memory `s` (sized by the launch: 0 bytes when the
// march does not cull).  kPairs (the bf16 marches): one float2 (min bound,
// max |value|) per cell, 32 KB; otherwise the min bounds alone, 16 KB.
template <bool kPairs>
struct TableView {
  static constexpr int kFloats = kPairs ? 2 * kCells : kCells;
  static constexpr unsigned kBytes = kFloats * sizeof(float);
  float* s;

  // the block's table at the base of the dynamic shared memory (a launch
  // with no static shared memory, so the TMA destination is 128-byte
  // aligned), and the mbarrier of its bulk copy just after it
  __device__ __forceinline__ unsigned long long* barrier() const {
    return reinterpret_cast<unsigned long long*>(s + kFloats);
  }

  // thread 0 starts the copy, and every thread of the block waits for it
  __device__ __forceinline__ void load(const float* __restrict__ coarse)
      const {
    if (threadIdx.x == 0) bulk_copy(s, coarse, kBytes, barrier());
    __syncthreads();  // the barrier is armed before anyone waits on it
    bulk_wait(barrier());
  }

  // the certified lower bound at a point (times scale) and, with kPairs,
  // the max |value| of its window in *amax
  __device__ __forceinline__ float bound(float px, float py, float pz,
                                         float scale, float* amax) const {
    const int c = coarse_cell(px, py, pz);
    if constexpr (kPairs) {
      const float2 b = reinterpret_cast<const float2*>(s)[c];
      *amax = b.y;
      return b.x * scale;
    } else {
      return s[c] * scale;
    }
  }
};

// The bf16 gate of a fine step at a located cell: d_fast and its error.
struct Bf16Sample {
  float d_fast, err;
};

__device__ __forceinline__ Bf16Sample bf16_sample(
    const __nv_bfloat16* __restrict__ sdf_b, const sdfest::Cell& cell,
    int res, float amax, float scale) {
  float c[2][2][2];
  sdfest::gather_bf16(sdf_b, cell, res, c);
  return {sdfest::lerp(c, cell) * scale, kBf16Err * amax * scale};
}

__device__ __forceinline__ float fp32_sample(const float* __restrict__ sdf,
                                             const sdfest::Cell& cell,
                                             int res, float scale) {
  float c[2][2][2];
  sdfest::gather(sdf, cell, res, c);
  return sdfest::lerp(c, cell) * scale;
}

// kRelaxed: relaxation > 1; kBf16: the bf16-verified branch, always with
// culling, where `culling` and `adaptive` are not read (the wrapper
// dispatches: bf16 without culling is the fp32 plain march).  Template
// parameters, so that the default branch's step loop carries no test of
// either.
template <bool kRelaxed, bool kBf16>
__global__ void march_kernel(const float* __restrict__ sdf,
                             const __nv_bfloat16* __restrict__ sdf_b,
                             const float* __restrict__ coarse,
                             const float* __restrict__ dirs,
                             const float* __restrict__ pose,
                             float* __restrict__ depth, int n, int h, int w,
                             int res, float threshold, int max_steps,
                             int culling, int adaptive, float relaxation) {
  extern __shared__ __align__(128) float4 dynamic_smem[];
  const TableView<kBf16> table{reinterpret_cast<float*>(dynamic_smem)};
  const Hyp hyp = hypothesis(n, res, TableView<kBf16>::kFloats);
  sdf += hyp.grid;
  if (kBf16) sdf_b += hyp.grid;
  const bool cull = kBf16 || culling;
  if (cull) coarse += hyp.table;
  pose += hyp.pose;
  const bool adapt = !kBf16 && adaptive;
  const int i = pixel_index(n, h, w);
  const size_t row = hyp.rays + i;  // the ray's depth of this hypothesis

  Ray r;
  bool marches = false;
  if (i >= 0) {
    r = setup_ray(dirs, pose, i);
    marches = r.hit && r.t_min < r.t_max;
  }
  if (cull) {
    // every thread of the block reaches the vote, ragged edge included
    if (!__syncthreads_or(marches)) {  // no ray of the tile meets the box
      if (i >= 0) depth[row] = 0.0f;
      return;
    }
    table.load(coarse);
  }
  if (i < 0) return;

  float t = r.t_min;
  float result = 0.0f;
  if (marches) {
    float stepped = 0.0f, d_prev = 0.0f;
    float omega = adapt ? kOmegaInit : 1.0f;
    for (int step = 0; step < max_steps; ++step) {
      const float px = (r.ox + t * r.d[0]) * r.inv_scale;
      const float py = (r.oy + t * r.d[1]) * r.inv_scale;
      const float pz = (r.oz + t * r.d[2]) * r.inv_scale;
      float amax = 0.0f;
      if (cull) {
        const float cd = table.bound(px, py, pz, r.scale, &amax);
        if (cd >= threshold * t + 1e-5f &&
            !(kRelaxed && stepped > d_prev + cd)) {
          t = t + cd;
          stepped = 0.0f;
          if (kRelaxed) d_prev = 0.0f;
          if (!(t < r.t_max)) break;
          continue;
        }
      }
      const sdfest::Cell cell = sdfest::locate(px, py, pz, res);
      if constexpr (kBf16) {
        const Bf16Sample b = bf16_sample(sdf_b, cell, res, amax, r.scale);
        if (!(b.d_fast < threshold * t + b.err)) {  // certified fast step
          if constexpr (kRelaxed) {
            const float d_cert = b.d_fast - b.err;
            if (stepped > d_prev + d_cert && stepped > 0.0f) {
              t = t - stepped + d_prev;
              stepped = 0.0f;
            } else {
              const float step_len = relaxation * b.d_fast;
              t = t + step_len;
              stepped = step_len;
              d_prev = d_cert;
            }
          } else {
            t = t + b.d_fast - b.err;
          }
          if (!(t < r.t_max)) break;
          continue;
        }
      }
      const float dist = fp32_sample(sdf, cell, res, r.scale);
      if (kRelaxed || adapt) {
        if (stepped > d_prev + dist && stepped > 0.0f) {
          // uncertified overstep: back to the last certified point
          t = t - stepped + d_prev;
          stepped = 0.0f;
          omega = 1.0f;
        } else {
          if (dist < threshold * t) {
            result = -t * r.dz;
            break;
          }
          const float step_len = (kRelaxed ? relaxation : omega) * dist;
          t = t + step_len;
          stepped = step_len;
          d_prev = dist;
          omega = fminf(omega + kOmegaGrow, kOmegaMax);
        }
      } else {
        if (dist < threshold * t) {
          result = -t * r.dz;
          break;
        }
        t = t + dist;
      }
      if (!(t < r.t_max)) break;
    }
  }
  depth[row] = result;
}

// Warm/aux corridor march (temporal coherence).  Replaces the aux branch of
// _march_kernel_body (pallas_kernel.py:636-650, :657-776): the culling
// march with relaxation 1 and no over-relaxation, per-ray warm-start and
// skip inputs, and the corridor outputs the skip rule of
// sdfest_torch/render/warm.py reads.
//
// Per ray: t0 = max(t_min, t_init) when t_init >= 0, else t_min; the ray
// marches when it hits the box, t0 < t_max and skip <= 0.  Every step is a
// bound step (coarse bound cd >= threshold*t + 1e-5) or a fine sample, and
// either value v, a lower bound of the field at t, first updates the
// corridor (`corridor()` of :673-682): min_dip = min over consecutive
// values of (v_prev + v - (t - t_prev)) / 2, a 1-Lipschitz lower bound of
// the field between them; v0 = the first value; v_prev/t_prev = the last.
// A fine sample then tests the hit (depth = -t * d_z) or steps t += v.
// Outputs: t (terminal), v0, min_dip and v_last (0 when the ray took no
// step) and t_last; a ray that does not march gives depth 0, t = t_last =
// t0 and zeros, as the TPU wrapper fills its unwritten tiles (:1880-1891).
//
// The TPU decided coarse/fine per 16x16 tile and sampled only a y-window of
// the grid per iteration; here each ray decides for itself.  The depth
// keeps the march's bar (hit agreement > 0.995, |ddepth| < 5e-3), but the
// corridor fields are not the TPU's to the bit: they are the same kind of
// certified lower bounds, which is all the skip rule needs.  max_steps
// counts one sample or one bound lookup per step (the TPU counted
// while-iterations of up to _UNROLL_AUX sub-steps); at 500, the default of
// warm_render_step, it rarely binds.
//
// With kBf16 (pallas_kernel.py:777-881) a fine step is gated by a bf16
// sample (kBf16Err above); a fast step feeds the corridor its certified
// lower bound d_fast - err and takes no hit.
//
// Design: march_kernel's.  A frame (h > 0) launches one block per 16x16
// tile, a flat set of n rays 1-D blocks of 256.  Every thread first runs
// its ray's slab test and warm start, then the block votes on "this ray
// marches" (hit, t0 < t_max, skip <= 0).  A tile where no ray marches
// writes the non-marching outputs and leaves without the coarse table;
// every other tile copies it with one TMA bulk copy after the vote into
// dynamic shared memory.
//
// What bounds it on the H100: as march_kernel, the longest dependent step
// chain of the launch; it moves 2 more inputs and 5 more outputs per ray
// (13.6 MB at 640x480 against 5 MB, a bound of 4.07 us).  Measured on an
// NVIDIA H100 80GB HBM3 at 700 W at 640x480 (PERF.md section 6), one
// hypothesis: a frame where every ray is skipped takes 6.7 us (6.6-6.7
// before the hypothesis axis, 9.9-10.1 with the table copied into every
// block); cold and mid-refinement inputs 18.1-18.3 us (17.9-18.1 before,
// 20.3-20.7).  8 hypotheses in one launch: 55.9 us cold against 8 x 18.2
// and a byte bound of 24.8 us (83 MB, the directions read once).  In the
// middle of a refinement a third of the steps go, skipped rays and warm
// starts near the surface, but 114 of the 124 active tiles stay and the
// longest ray's chain stays at ~29 of ~30 steps, so mid-refinement still
// reads what cold reads.
template <bool kBf16>
__global__ void __launch_bounds__(sdfest::kThreads,
                                  kBf16 ? kWarmBlocks - 1 : kWarmBlocks)
march_warm_kernel(
    const float* __restrict__ sdf, const __nv_bfloat16* __restrict__ sdf_b,
    const float* __restrict__ coarse, const float* __restrict__ dirs,
    const float* __restrict__ pose, const float* __restrict__ t_init,
    const float* __restrict__ skip, float* __restrict__ depth,
    float* __restrict__ t_out, float* __restrict__ v0_out,
    float* __restrict__ min_dip_out, float* __restrict__ v_last_out,
    float* __restrict__ t_last_out, int n, int h, int w, int res,
    float threshold, int max_steps) {
  extern __shared__ __align__(128) float4 dynamic_smem[];
  const TableView<kBf16> table{reinterpret_cast<float*>(dynamic_smem)};
  const Hyp hyp = hypothesis(n, res, TableView<kBf16>::kFloats);
  coarse += hyp.table;
  pose += hyp.pose;
  // this hypothesis's grid (and bf16 grid) as a 32-bit offset of each
  // cell's index, the grid pointers left as the launch passed them: a
  // bumped 64-bit grid pointer, rebuilt on every fine step under the
  // register bound, cost ~0.6 us of a one-hypothesis launch (PERF.md
  // section 6); the wrapper keeps batch * res^3 below 2^31
  const int grid = static_cast<int>(blockIdx.z) * res * res * res;
  // the ray's row of this hypothesis in t_init, skip and the six outputs:
  // one index, not eight bumped pointers live across the step loop
  const int i = pixel_index(n, h, w);
  const size_t row = hyp.rays + i;

  Ray r;
  float t0 = 0.0f;
  bool marches = false;
  if (i >= 0) {
    r = setup_ray(dirs, pose, i);
    const float ti = t_init[row];
    t0 = ti >= 0.0f ? fmaxf(r.t_min, ti) : r.t_min;
    marches = r.hit && t0 < r.t_max && skip[row] <= 0.0f;
  }
  // every thread of the block reaches the vote, ragged edge included
  if (!__syncthreads_or(marches)) {  // no ray of the tile marches
    if (i >= 0) {
      depth[row] = 0.0f;
      t_out[row] = t0;
      v0_out[row] = 0.0f;
      min_dip_out[row] = 0.0f;
      v_last_out[row] = 0.0f;
      t_last_out[row] = t0;
    }
    return;
  }
  table.load(coarse);
  if (i < 0) return;

  float t = t0;
  float result = 0.0f;
  float v_prev = 0.0f, t_prev = t0, min_dip = 1e9f, v0 = 0.0f;
  bool have = false;
  if (marches) {
    for (int step = 0; step < max_steps; ++step) {
      const float px = (r.ox + t * r.d[0]) * r.inv_scale;
      const float py = (r.oy + t * r.d[1]) * r.inv_scale;
      const float pz = (r.oz + t * r.d[2]) * r.inv_scale;
      float amax = 0.0f;
      const float cd = table.bound(px, py, pz, r.scale, &amax);
      // v: a lower bound of the field at t; may_hit: v is the exact sample
      float v = cd;
      bool may_hit = false;
      if (!(cd >= threshold * t + 1e-5f)) {
        sdfest::Cell cell = sdfest::locate(px, py, pz, res);
        cell.idx += grid;
        may_hit = true;
        if constexpr (kBf16) {
          const Bf16Sample b = bf16_sample(sdf_b, cell, res, amax, r.scale);
          if (!(b.d_fast < threshold * t + b.err)) {  // certified fast step
            v = b.d_fast - b.err;
            may_hit = false;
          }
        }
        if (may_hit) v = fp32_sample(sdf, cell, res, r.scale);
      }
      if (have) {
        const float dip = (v_prev + v - (t - t_prev)) * 0.5f;
        min_dip = fminf(min_dip, dip);
      } else {
        v0 = v;
      }
      v_prev = v;
      t_prev = t;
      have = true;
      if (may_hit && v < threshold * t) {
        result = -t * r.dz;
        break;
      }
      t = t + v;
      if (!(t < r.t_max)) break;
    }
  }
  depth[row] = result;
  t_out[row] = t;
  v0_out[row] = have ? v0 : 0.0f;
  min_dip_out[row] = have ? min_dip : 0.0f;
  v_last_out[row] = have ? v_prev : 0.0f;
  t_last_out[row] = t_prev;
}

// The launch grid of both marches (see pixel_index), one z slice per
// hypothesis.
dim3 grid_of(int n, int h, int w, int batch) {
  return h > 0 ? dim3((w + kTile - 1) / kTile, (h + kTile - 1) / kTile,
                      batch)
               : dim3((n + sdfest::kThreads - 1) / sdfest::kThreads, 1,
                      batch);
}

// The dynamic shared memory of a culling launch: the table and its
// mbarrier.
size_t table_smem(bool bf16) {
  return (bf16 ? TableView<true>::kBytes : TableView<false>::kBytes) +
         sizeof(unsigned long long);
}

}  // namespace

// Both entries: sdf_b is the bf16 copy of the grid and coarse the
// interleaved (min, max |value|) table when bf16 is set (the bf16
// instance, culling implied); otherwise sdf_b is not read and coarse is
// the min table (read when culling; the warm march always culls).
// The rays: n = h * w in raster order when h > 0 (one block per 16x16
// tile; the wrappers pass h > 0 only for a culling march), else a set of
// n in 1-D blocks.  batch hypotheses, each with its own grid, table, pose
// and outputs, contiguous one after the other; every hypothesis's coarse
// table is 16-byte aligned (the source of a TMA copy).
extern "C" int sdfest_march(const float* sdf, const void* sdf_b,
                            const float* coarse, const float* dirs,
                            const float* pose, float* depth, int n, int h,
                            int w, int batch, int res, float threshold,
                            int max_steps, int culling, int adaptive,
                            float relaxation, int bf16, void* stream) {
  if (n <= 0 || batch <= 0) return 0;
  const bool relaxed = relaxation > 1.0f;
  auto kernel = bf16 ? (relaxed ? march_kernel<true, true>
                                : march_kernel<false, true>)
                     : (relaxed ? march_kernel<true, false>
                                : march_kernel<false, false>);
  // shared memory only for a culling march
  const size_t smem = bf16 || culling ? table_smem(bf16) : 0;
  kernel<<<grid_of(n, h, w, batch), sdfest::kThreads, smem,
           (cudaStream_t)stream>>>(
      sdf, static_cast<const __nv_bfloat16*>(sdf_b), coarse, dirs, pose,
      depth, n, h, w, res, threshold, max_steps, culling, adaptive,
      relaxation);
  return (int)cudaGetLastError();
}

extern "C" int sdfest_march_warm(const float* sdf, const void* sdf_b,
                                 const float* coarse, const float* dirs,
                                 const float* pose, const float* t_init,
                                 const float* skip, float* depth, float* t,
                                 float* v0, float* min_dip, float* v_last,
                                 float* t_last, int n, int h, int w,
                                 int batch, int res, float threshold,
                                 int max_steps, int bf16, void* stream) {
  if (n <= 0 || batch <= 0) return 0;
  auto kernel = bf16 ? march_warm_kernel<true> : march_warm_kernel<false>;
  kernel<<<grid_of(n, h, w, batch), sdfest::kThreads, table_smem(bf16),
           (cudaStream_t)stream>>>(
      sdf, static_cast<const __nv_bfloat16*>(sdf_b), coarse, dirs, pose,
      t_init, skip, depth, t, v0, min_dip, v_last, t_last, n, h, w, res,
      threshold, max_steps);
  return (int)cudaGetLastError();
}
