// Gradient of trilinear sampling w.r.t. the SDF grid (the sampler's
// transpose): each of a point's 8 corner weights times its cotangent,
// accumulated into a (res, res, res) grid.
//
// Replaces the TPU kernel sdfest_tpu/render/pallas_kernel.py:
// scatter_sdf_grad_pallas -> _scatter_impl -> _scatter_kernel (the sdf
// gradient of the fused backward, render/api.py:79-95).
//
// Deterministic, as the TPU kernel is: no float atomics.  Every cell adds
// its contributions ((wx * wy) * wz) * cot in increasing row index, the
// order of scatter_plain's serial index_add_ on the CPU, so the grid equals
// that plain version bit for bit whatever order the blocks run in, and each
// hypothesis's grid does not depend on the batch.  Integer atomics only
// count rows and hand out slots; where a row lands inside its bucket is then
// fixed by its row index.  Five launches over per-hypothesis scratch
// (blockIdx.z is the hypothesis), after a zero fill of the counts:
//  1. count  (one thread per row): an active row (cot != 0) adds 1 to the
//     count of its base cell (warp-aggregated: lanes of one cell add once)
//     and keeps the value it got, its arrival in that cell's bucket;
//  2. alloc  (one thread per cell): each non-empty bucket takes a range of
//     the row list from a per-hypothesis counter (one atomic per block; the
//     ranges' places vary from run to run, their contents do not);
//  3. place  (one thread per row): an active row writes its index at its
//     arrival slot of its bucket;
//  4. rank   (one thread per slot): a row's rank in its bucket is the
//     number of rows there with a smaller index; the row moves to that slot
//     of the sorted list (the arrival array, dead by then), and its cell
//     fractions (trilinear.cuh's locate, as the sampler) and cotangent to
//     that slot of a float4 array;
//  5. gather (scatter_kernel, one thread per cell, output-stationary): the
//     cell is corner (dx, dy, dz) of up to 8 base cells; it merges their
//     sorted buckets by row index, adds each row's weight for that corner
//     times its cotangent, and writes the cell once, so no zero fill of the
//     grid.  The merge is a chain of dependent loads per cell: the rows
//     of the bucket with the smallest next row that come before every
//     other bucket's next row are added as one run, kRun slots loaded at
//     a time.
// Rows with a zero cotangent are skipped: in the plain version they add
// w * 0, a zero, which leaves every sum as it was.
//
// What bounds it on the H100: not the bytes (cotangents 4 B per row, the
// active rows' points, the 1 MiB grid written once) but the launches (five
// kernels and a 1 MiB memset per call) and the gather's chains of
// dependent loads in the cells near the surface, where up to 8 buckets
// meet.  The scratch (counts and starts, res^3 ints each; arrivals and the
// row list, n ints each; n float4) stays in L2 at the main path's sizes.
#include <climits>

#include <cuda_runtime.h>

#include "trilinear.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarps = sdfest::kThreads / 32;

__device__ __forceinline__ int base_cell(const float* __restrict__ points,
                                         int row, int res) {
  return sdfest::locate(points[3 * row], points[3 * row + 1],
                        points[3 * row + 2], res)
      .idx;
}

__global__ void scatter_count_kernel(const float* __restrict__ points,
                                     const float* __restrict__ cot,
                                     int* __restrict__ count,
                                     int* __restrict__ arrival, int n,
                                     int res) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const size_t z = blockIdx.z;
  points += z * 3 * n;
  cot += z * n;
  arrival += z * n;
  count += z * res * res * res;
  const bool live = i < n && cot[i] != 0.0f;
  // every lane of the warp stays until the match: no exit before here
  if (__ballot_sync(kFull, live) == 0u) return;
  const int key = live ? base_cell(points, i, res) : -1;
  const int lane = threadIdx.x & 31;
  const unsigned group = __match_any_sync(kFull, key);
  const int leader = __ffs(group) - 1;
  int first = 0;
  if (live && lane == leader) first = atomicAdd(count + key, __popc(group));
  first = __shfl_sync(kFull, first, leader);
  if (live) arrival[i] = first + __popc(group & ((1u << lane) - 1u));
}

__global__ void scatter_alloc_kernel(const int* __restrict__ count,
                                     int* __restrict__ total,
                                     int* __restrict__ start, int r3) {
  __shared__ int warp_sum[kWarps];
  __shared__ int block_base;
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  const size_t z = blockIdx.z;
  count += z * r3;
  start += z * r3;
  const int m = c < r3 ? count[c] : 0;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int incl = m;  // inclusive sum over the warp's lanes
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int v = __shfl_up_sync(kFull, incl, d);
    if (lane >= d) incl += v;
  }
  if (lane == 31) warp_sum[warp] = incl;
  __syncthreads();
  if (threadIdx.x == 0) {
    int sum = 0;
    for (int w = 0; w < kWarps; ++w) {
      const int s = warp_sum[w];
      warp_sum[w] = sum;
      sum += s;
    }
    block_base = sum ? atomicAdd(total + z, sum) : 0;
  }
  __syncthreads();
  if (m > 0) start[c] = block_base + warp_sum[warp] + incl - m;
}

__global__ void scatter_place_kernel(const float* __restrict__ points,
                                     const float* __restrict__ cot,
                                     const int* __restrict__ start,
                                     const int* __restrict__ arrival,
                                     int* __restrict__ list, int n,
                                     int res) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const size_t z = blockIdx.z;
  points += z * 3 * n;
  cot += z * n;
  if (i >= n || cot[i] == 0.0f) return;
  const int key = base_cell(points, i, res);
  list[z * n + start[z * res * res * res + key] + arrival[z * n + i]] = i;
}

__global__ void scatter_rank_kernel(const float* __restrict__ points,
                                    const float* __restrict__ cot,
                                    const int* __restrict__ total,
                                    const int* __restrict__ count,
                                    const int* __restrict__ start,
                                    const int* __restrict__ list,
                                    int* __restrict__ sorted,
                                    float4* __restrict__ data, int n,
                                    int res) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  const size_t z = blockIdx.z;
  if (t >= total[z]) return;
  const size_t r3 = (size_t)res * res * res;
  list += z * n;
  const int row = list[t];
  const float* p = points + z * 3 * n + 3 * (size_t)row;
  const sdfest::Cell c = sdfest::locate(p[0], p[1], p[2], res);
  const int s = start[z * r3 + c.idx], m = count[z * r3 + c.idx];
  int rank = 0;
  for (int j = s; j < s + m; ++j) rank += list[j] < row;
  sorted[z * n + s + rank] = row;
  data[z * n + s + rank] = make_float4(c.fx, c.fy, c.fz, cot[z * n + row]);
}

constexpr int kRun = 4;  // rows of one bucket loaded per round trip

__global__ void scatter_kernel(const int* __restrict__ count,
                               const int* __restrict__ start,
                               const int* __restrict__ sorted,
                               const float4* __restrict__ data,
                               float* __restrict__ grad, int n, int res) {
  const int rr = res * res, r3 = rr * res;
  const int cell = blockIdx.x * blockDim.x + threadIdx.x;
  if (cell >= r3) return;
  const size_t z = blockIdx.z;
  count += z * r3;
  start += z * r3;
  sorted += z * n;
  data += z * n;
  const int x = cell / rr, y = (cell / res) % res, w = cell % res;
  // bucket k holds the rows whose base cell has this cell as corner
  // (dx, dy, dz) = (k >> 2, (k >> 1) & 1, k & 1); head[k] is its next slot
  // and next[k] that slot's row (INT_MAX once the bucket is used up)
  int head[8], end[8], next[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const int dx = k >> 2, dy = (k >> 1) & 1, dz = k & 1;
    int h = 0, e = 0;
    if (x - dx >= 0 && x - dx <= res - 2 && y - dy >= 0 &&
        y - dy <= res - 2 && w - dz >= 0 && w - dz <= res - 2) {
      const int key = cell - dx * rr - dy * res - dz;
      const int m = count[key];
      if (m > 0) {
        h = start[key];
        e = h + m;
      }
    }
    head[k] = h;
    end[k] = e;
    next[k] = h < e ? sorted[h] : INT_MAX;
  }
  float acc = 0.0f;
  for (;;) {
    // the bucket with the smallest next row, and the smallest row of the
    // others: its rows below that come next, one run of its slots
    int row = INT_MAX, kb = 0, other = INT_MAX;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      if (next[k] < row) {
        other = row;
        row = next[k];
        kb = k;
      } else if (next[k] < other) {
        other = next[k];
      }
    }
    if (row == INT_MAX) break;
    int h = head[0], e = end[0];
#pragma unroll
    for (int k = 1; k < 8; ++k)
      if (k == kb) {
        h = head[k];
        e = end[k];
      }
    const bool ux = kb >> 2, uy = (kb >> 1) & 1, uz = kb & 1;
    int after = INT_MAX;  // the bucket's first row not added
    for (bool more = true; more;) {
      int r[kRun];
      float4 f[kRun];
#pragma unroll
      for (int j = 0; j < kRun; ++j) {
        r[j] = h + j < e ? sorted[h + j] : INT_MAX;
        f[j] = h + j < e ? data[h + j] : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      }
#pragma unroll
      for (int j = 0; j < kRun; ++j) {
        if (more && r[j] < other) {
          // this cell is corner kb of the row's base cell: scatter_plain's
          // ((wx * wy) * wz) * cot, each step rounded on its own
          const float wx = ux ? f[j].x : 1.0f - f[j].x;
          const float wy = uy ? f[j].y : 1.0f - f[j].y;
          const float wz = uz ? f[j].z : 1.0f - f[j].z;
          acc = __fadd_rn(
              acc, __fmul_rn(__fmul_rn(__fmul_rn(wx, wy), wz), f[j].w));
          ++h;
        } else if (more) {
          after = r[j];
          more = false;
        }
      }
    }
#pragma unroll
    for (int k = 0; k < 8; ++k)
      if (k == kb) {
        head[k] = h;
        next[k] = after;
      }
  }
  grad[z * r3 + cell] = acc;
}

int blocks_for(long long items) {
  return (int)((items + sdfest::kThreads - 1) / sdfest::kThreads);
}

}  // namespace

// scratch: 16-byte aligned, batch * (2 * res^3 + 6 * n) + batch 4-byte
// words, laid out as the sorted rows' fractions and cotangents (batch * n
// float4), counts (batch * res^3), the per-hypothesis totals (batch),
// starts (batch * res^3), arrivals / the sorted row list (batch * n) and
// the arrival-ordered row list (batch * n).  batch hypotheses of n rows
// each, one after the other in every operand.  grad need not be filled:
// every cell is written.
extern "C" int sdfest_scatter(const float* points, const float* cot,
                              float* grad, void* scratch, int n, int batch,
                              int res, void* stream) {
  if (n <= 0 || batch <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  const int r3 = res * res * res;
  float4* data = static_cast<float4*>(scratch);
  int* count = reinterpret_cast<int*>(data + (size_t)batch * n);
  int* total = count + (size_t)batch * r3;
  int* start = total + batch;
  int* arrival = start + (size_t)batch * r3;
  int* list = arrival + (size_t)batch * n;
  cudaError_t err = cudaMemsetAsync(
      count, 0, ((size_t)batch * r3 + batch) * sizeof(int), s);
  if (err != cudaSuccess) return (int)err;
  const dim3 rows(blocks_for(n), 1, batch), cells(blocks_for(r3), 1, batch);
  const int t = sdfest::kThreads;
  scatter_count_kernel<<<rows, t, 0, s>>>(points, cot, count, arrival, n,
                                          res);
  scatter_alloc_kernel<<<cells, t, 0, s>>>(count, total, start, r3);
  scatter_place_kernel<<<rows, t, 0, s>>>(points, cot, start, arrival, list,
                                          n, res);
  // the sorted list reuses the arrivals' memory: place has read them
  scatter_rank_kernel<<<rows, t, 0, s>>>(points, cot, total, count, start,
                                         list, arrival, data, n, res);
  scatter_kernel<<<cells, t, 0, s>>>(count, start, arrival, data, grad, n,
                                     res);
  return (int)cudaGetLastError();
}
