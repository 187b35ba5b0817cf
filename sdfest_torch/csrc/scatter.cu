// Gradient of trilinear sampling w.r.t. the SDF grid (the sampler's
// transpose): each of a point's 8 corner weights times its cotangent,
// accumulated into a (res, res, res) grid.
//
// Replaces the TPU kernel sdfest_tpu/render/pallas_kernel.py:
// scatter_sdf_grad_pallas -> _scatter_impl -> _scatter_kernel (the sdf
// gradient of the fused backward, render/api.py:79-95).
//
// Deterministic, as the TPU kernel is: no float atomics.  Every cell adds
// its contributions ((wx * wy) * wz) * cot in increasing row index, each
// product and sum rounded on its own, the order of scatter_plain's serial
// index_add_ on the CPU: the grid equals that plain version bit for bit
// whatever order the blocks run in, and each hypothesis's grid does not
// depend on the batch.  Integer atomics only count rows and hand out
// ranges and list slots; no result depends on their order.
//
// What bounds it on the H100: not the bytes (cotangents 4 B per row, the
// active rows' points, the 1 MiB grid written once: ~1.1 us at 3.35 TB/s)
// but putting each cell's contributions in row order.  A cell is corner
// (dx, dy, dz) of up to 8 base cells, so its rows come from up to 8
// buckets; a fold that walks those buckets in global memory waits one L2
// round trip per step.  Here each cell's contributions come onto the chip
// with independent loads, are put in row order there (a network of
// shuffles, or their rows' bits in a window of row indices), and are
// folded from registers or shared memory, a few cycles a step.  A memset
// of the counts and four kernels per call, each later one launched while
// the one before runs and waiting for it (programmatic dependent launch;
// blockIdx.z is the hypothesis):
//  1. count (one thread per row): an active row (cot != 0) adds 1 to
//     its base cell's count (warp-aggregated) and keeps its slot in that
//     cell's bucket; it joins a compact list of active rows, and the rows
//     that open a bucket list it (one atomic per list per block);
//  2. alloc (the listed buckets, 8 threads each): each bucket takes a
//     range of the row arrays; the thread of corner d takes the cell that
//     is corner d of the bucket's base cell, and the cell's first
//     non-empty base cell owns it: marks it touched and lists it by its
//     contributions, the sum of its base cells' counts (up to 8, 16, 256,
//     or more); a bucket of more than kBlockCell rows is listed as big;
//  3. place (the active rows): each row goes to its slot, its index and
//     its fractions and cotangent as a float4 beside it.  The block that
//     finishes last sorts every big bucket's rows in place (stable LSD
//     radix, 8 bits a pass);
//  4. gather (scatter_kernel, a grid of resident blocks, output-
//     stationary, each cell written once: no grid fill).  Untouched cells
//     get a zero.  Block-list cells, one block each: windows of row
//     indices from the least row up, a window's contributions set at
//     their rows' bits, a prefix count over the words placing each in
//     order in shared memory (32 kBlockWords rows a window, or for more
//     than kBlockCell contributions 32 kHugeWords, so that a window holds
//     at most kBlockCell), the sorted big buckets read as advancing runs.
//     Warp cells: up to 8, 16 or 32 contributions to a group of as many
//     lanes (4, 2 or 1 cells a warp), one a lane, sorted by a bitonic
//     network of shuffles; 33 to 256 kept in registers (2, 4 or 8 a lane)
//     and put in order through the bits of windows of 32 kWarpWords rows.
//     Thread 0 (or a group's first lane) folds each cell in order.
// Putting m contributions in order costs O(m log^2 m) compares for up to
// 32 (at most 15 network steps), and O(m + W) per window of W words (32
// W rows) for more: the windows skip empty rows, so real sets (rows in
// tile order, a cell's rows close together) take 1-4; a set that spreads
// a cell over all n rows takes at most n / (32 W) + 1.  Big buckets are
// sorted once in O(m) per pass.  No step grows with the square of a
// bucket.
// Rows with a zero cotangent are skipped: in the plain version they add
// w * 0, a zero, and adding a zero leaves every sum as it was (a sum that
// starts at +0 never becomes -0, and x + 0 == x for every other x).  The
// same holds for the zeros that pad a group's network.
#include <climits>

#include <cuda_runtime.h>

#include "trilinear.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = sdfest::kThreads;
constexpr int kWarps = kThreads / 32;
constexpr int kWarpCell = 256;           // at most this: one warp, 8 a lane
constexpr int kBlockCell = 4096;         // at most this: one block
// the count and alloc stages run wide blocks: their counters take one
// atomic per block, and fewer blocks contend for them
constexpr int kWideThreads = 512;
// per-hypothesis counters, zeroed with the counts: the active rows and
// listed buckets (count), the cells of each list, the big buckets and the
// rows given a range (alloc), the place blocks done
enum {
  kActive, kBuckets,
  kList8, kList16, kList256, kBlockList, kBigBuckets, kTotal,
  kDone, kMeta
};

__device__ __forceinline__ unsigned lanes_below(int lane) {
  return (1u << lane) - 1u;
}

// Ranges of amount[l] items for each thread of the block in the counters
// counters[0 .. L - 1], one atomic per counter per block: the thread's
// first item of list l is at[l].  amount[l] is 0 or 1 unless bit l of
// kSums is set.  Every thread of the block calls it.
template <int L, unsigned kSums>
__device__ __forceinline__ void block_ranges(const int (&amount)[L],
                                             int* counters, int (&at)[L]) {
  __shared__ int warp_base[L][32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  int below[L];
#pragma unroll
  for (int l = 0; l < L; ++l) {
    int total;
    if ((kSums >> l) & 1u) {
      int incl = amount[l];
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int v = __shfl_up_sync(kFull, incl, d);
        if (lane >= d) incl += v;
      }
      below[l] = incl - amount[l];
      total = __shfl_sync(kFull, incl, 31);
    } else {
      const unsigned mask = __ballot_sync(kFull, amount[l] != 0);
      below[l] = __popc(mask & lanes_below(lane));
      total = __popc(mask);
    }
    if (lane == 0) warp_base[l][warp] = total;
  }
  __syncthreads();
  if (warp < L) {  // warp l takes counter l
    const int c = lane < warps ? warp_base[warp][lane] : 0;
    int incl = c;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int v = __shfl_up_sync(kFull, incl, d);
      if (lane >= d) incl += v;
    }
    const int sum = __shfl_sync(kFull, incl, 31);
    int base = 0;
    if (lane == 0 && sum > 0) base = atomicAdd(counters + warp, sum);
    base = __shfl_sync(kFull, base, 0);
    if (lane < warps) warp_base[warp][lane] = base + incl - c;
  }
  __syncthreads();
#pragma unroll
  for (int l = 0; l < L; ++l) at[l] = warp_base[l][warp] + below[l];
  __syncthreads();  // warp_base is free for the next call
}

// Programmatic dependent launch (Hopper): a kernel lets the next one in the
// stream be scheduled while it runs, and the next one waits here until
// this grid has finished and its writes are visible.
__device__ __forceinline__ void let_next_launch() {
  asm volatile("griddepcontrol.launch_dependents;");
}
__device__ __forceinline__ void wait_for_previous() {
  asm volatile("griddepcontrol.wait;" ::: "memory");
}

// This cell is corner k = (dx, dy, dz) = (k >> 2, (k >> 1) & 1, k & 1) of
// the row's base cell: scatter_plain's ((wx * wy) * wz) * cot, each step
// rounded on its own.
__device__ __forceinline__ float contribution(float fx, float fy, float fz,
                                              float cot, int k) {
  const float wx = (k & 4) ? fx : 1.0f - fx;
  const float wy = (k & 2) ? fy : 1.0f - fy;
  const float wz = (k & 1) ? fz : 1.0f - fz;
  return __fmul_rn(__fmul_rn(__fmul_rn(wx, wy), wz), cot);
}

// The base cell of corner k of output cell `cell`, or -1 where there is
// none (the cell on the grid's low edge, or past the last base cell).
__device__ __forceinline__ int base_of(int cell, int k, int res) {
  const int rr = res * res;
  const int x = cell / rr, y = (cell / res) % res, w = cell % res;
  const int dx = k >> 2, dy = (k >> 1) & 1, dz = k & 1;
  if (x - dx < 0 || x - dx > res - 2 || y - dy < 0 || y - dy > res - 2 ||
      w - dz < 0 || w - dz > res - 2)
    return -1;
  return cell - dx * rr - dy * res - dz;
}

__global__ void scatter_count_kernel(const float* __restrict__ points,
                                     const float* __restrict__ cot,
                                     int* __restrict__ count,
                                     int* __restrict__ meta,
                                     int2* __restrict__ compact,
                                     int* __restrict__ buckets, int n,
                                     int res) {
  const size_t z = blockIdx.z, r3 = (size_t)res * res * res;
  points += z * 3 * n;
  cot += z * n;
  compact += z * n;
  count += z * r3;
  buckets += z * r3;
  meta += z * kMeta;
  const int lane = threadIdx.x & 31;
  let_next_launch();
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = i < n && cot[i] != 0.0f;
  // the block's threads stay together: this test is uniform
  if (!__syncthreads_or(live)) return;
  const int key =
      live ? sdfest::locate(points[3 * i], points[3 * i + 1],
                            points[3 * i + 2], res).idx
           : -1;
  const unsigned group = __match_any_sync(kFull, key);
  const int leader = __ffs(group) - 1;
  int first = 0;
  if (live && lane == leader) first = atomicAdd(count + key, __popc(group));
  // the rows that open a bucket list it
  const int amount[2] = {live, live && lane == leader && first == 0};
  int at[2];
  block_ranges<2, 0u>(amount, meta + kActive, at);
  if (amount[1]) buckets[at[1]] = key;
  first = __shfl_sync(kFull, first, leader);
  if (live)
    compact[at[0]] = make_int2(i, first + __popc(group & lanes_below(lane)));
}

// The listed buckets, 8 threads each (a grid-stride loop): the thread of
// corner 0 gives its bucket a range of the row arrays and lists it as big
// past kBlockCell rows; the thread of corner d takes the cell that is
// corner d of the bucket's base cell, and the first non-empty of that
// cell's base cells (in corner order) owns it: marks it touched and lists
// it by its contributions, the sum of its base cells' counts.  One atomic
// per list per block.
__global__ void scatter_alloc_kernel(const int* __restrict__ count,
                                     int* __restrict__ meta,
                                     const int* __restrict__ buckets,
                                     int* __restrict__ start,
                                     int* __restrict__ cells,
                                     int* __restrict__ small_cells,
                                     unsigned* __restrict__ touched,
                                     int* __restrict__ big, int n, int res) {
  const int rr = res * res, r3 = rr * res, words = (r3 + 31) / 32;
  const size_t z = blockIdx.z;
  count += z * r3;
  buckets += z * r3;
  start += z * r3;
  cells += z * r3;
  small_cells += z * r3;
  touched += z * words;
  big += z * (n / kBlockCell + 1);
  meta += z * kMeta;
  wait_for_previous();
  let_next_launch();
  const int n_buckets = meta[kBuckets];
  for (int first = blockIdx.x * blockDim.x; first < 8 * n_buckets;
       first += gridDim.x * blockDim.x) {
    const int q = first + threadIdx.x, d = q & 7;
    const bool live = q < 8 * n_buckets;
    const int b = live ? buckets[q >> 3] : 0;
    // the counts around b, shared by its 8 threads: near[i] of lane d is
    // the count at b + (i / 9 - 1, i / 3 % 3 - 1, i % 3 - 1) for i = d + 8 j
    // (0 off the grid's base cells)
    const int x = b / rr, y = (b / res) % res, w = b % res;
    int near[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int i = d + 8 * j;
      const int ex = i / 9 - 1, ey = i / 3 % 3 - 1, ez = i % 3 - 1;
      near[j] = i < 27 && x + ex >= 0 && x + ex <= res - 2 && y + ey >= 0 &&
                        y + ey <= res - 2 && w + ez >= 0 && w + ez <= res - 2
                    ? count[b + ex * rr + ey * res + ez]
                    : 0;
    }
    const int m = __shfl_sync(kFull, near[1], 5, 8);  // i = 13: b itself
    // the cell of corner d: b is its base cell d, and its base cell k is
    // b + corner d - corner k
    const int c = b + (d >> 2) * rr + ((d >> 1) & 1) * res + (d & 1);
    int t = 0;
    bool owns = live;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int i = ((d >> 2) - (k >> 2) + 1) * 9 +
                    (((d >> 1) & 1) - ((k >> 1) & 1) + 1) * 3 +
                    ((d & 1) - (k & 1) + 1);
      int rows_k = 0;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int v = __shfl_sync(kFull, near[j], i & 7, 8);
        if (j == i >> 3) rows_k = v;
      }
      t += rows_k;
      if (k < d && rows_k > 0) owns = false;
    }
    if (owns) atomicOr(touched + (c >> 5), 1u << (c & 31));
    // the lists: cells of at most 8 (4 to a warp), 16 (2 to a warp), 256
    // contributions (1 to a warp), more (1 to a block); the big buckets;
    // the buckets' ranges
    const bool opens = live && d == 0;
    const int amount[6] = {owns && t <= 8, owns && t > 8 && t <= 16,
                           owns && t > 16 && t <= kWarpCell,
                           owns && t > kWarpCell, opens && m > kBlockCell,
                           opens ? m : 0};
    int at[6];
    block_ranges<6, 1u << 5>(amount, meta + kList8, at);
    if (amount[0]) small_cells[at[0]] = c;
    if (amount[1]) small_cells[r3 - 1 - at[1]] = c;
    if (amount[2]) cells[at[2]] = c;
    if (amount[3]) cells[r3 - 1 - at[3]] = c;
    if (amount[4]) big[at[4]] = b;
    if (opens) start[b] = at[5];
  }
}

// Stable LSD radix sort of m row indices in global memory by one block (8
// bits a pass; `spare` holds m ints).  A tile is kRadixRounds keys a
// thread, each warp's in index order; L2 loads (__ldcg): other blocks wrote
// the rows.
constexpr int kRadixRounds = 8;

__device__ void sort_rows(int* keys, int* spare, int m, int bits) {
  __shared__ int offset[256];
  __shared__ int warp_count[kWarps][256];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  constexpr int kTile = kThreads * kRadixRounds;
  int* src = keys;
  int* dst = spare;
  for (int shift = 0; shift < bits; shift += 8) {
    for (int d = threadIdx.x; d < 256; d += blockDim.x) offset[d] = 0;
    __syncthreads();
    for (int e = threadIdx.x; e < m; e += blockDim.x)
      atomicAdd(&offset[(__ldcg(src + e) >> shift) & 255], 1);
    __syncthreads();
    if (threadIdx.x == 0) {
      int sum = 0;
      for (int d = 0; d < 256; ++d) {
        const int v = offset[d];
        offset[d] = sum;
        sum += v;
      }
    }
    for (int base = 0; base < m; base += kTile) {
      for (int d = threadIdx.x; d < kWarps * 256; d += blockDim.x)
        (&warp_count[0][0])[d] = 0;
      __syncthreads();
      // a key's place among its digit's keys of the tile: the count in
      // earlier warps, then in its warp's earlier rounds and lanes
      int key[kRadixRounds], rank[kRadixRounds];
#pragma unroll
      for (int r = 0; r < kRadixRounds; ++r) {
        const int e = base + (warp * kRadixRounds + r) * 32 + lane;
        key[r] = e < m ? __ldcg(src + e) : -1;
        const int digit = e < m ? (key[r] >> shift) & 255 : 256;
        const unsigned peers = __match_any_sync(kFull, digit);
        rank[r] = e < m ? warp_count[warp][digit] +
                              __popc(peers & lanes_below(lane))
                        : 0;
        __syncwarp();
        if (e < m && lane == __ffs(peers) - 1)
          warp_count[warp][digit] += __popc(peers);
        __syncwarp();
      }
      __syncthreads();
#pragma unroll
      for (int r = 0; r < kRadixRounds; ++r) {
        if (key[r] < 0) continue;
        const int digit = (key[r] >> shift) & 255;
        int at = offset[digit] + rank[r];
        for (int k = 0; k < warp; ++k) at += warp_count[k][digit];
        dst[at] = key[r];
      }
      __syncthreads();
      for (int d = threadIdx.x; d < 256; d += blockDim.x) {
        int s = 0;
        for (int k = 0; k < kWarps; ++k) s += warp_count[k][d];
        offset[d] += s;
      }
      __syncthreads();
    }
    int* tmp = src;
    src = dst;
    dst = tmp;
  }
  if (src != keys) {
    for (int e = threadIdx.x; e < m; e += blockDim.x) keys[e] = __ldcg(src + e);
    __syncthreads();
  }
}

__global__ void scatter_place_kernel(const float* __restrict__ points,
                                     const float* __restrict__ cot,
                                     const int* __restrict__ count,
                                     const int* __restrict__ start,
                                     int* __restrict__ meta,
                                     int2* __restrict__ compact,
                                     const int* __restrict__ big,
                                     int* __restrict__ rows,
                                     float4* __restrict__ data, int n,
                                     int res) {
  __shared__ bool last;
  const size_t z = blockIdx.z;
  const size_t r3 = (size_t)res * res * res;
  points += z * 3 * n;
  cot += z * n;
  count += z * r3;
  start += z * r3;
  meta += z * kMeta;
  compact += z * n;
  big += z * (n / kBlockCell + 1);
  rows += z * n;
  data += z * n;
  // the active rows come from the count stage, finished when this grid
  // starts: the first is read while the alloc stage runs
  const int active = __ldcg(meta + kActive);
  int j = blockIdx.x * blockDim.x + threadIdx.x;
  int2 e;
  sdfest::Cell c;
  float g;
  const auto load = [&]() {
    e = __ldcg(compact + j);
    const float* p = points + 3 * (size_t)e.x;
    c = sdfest::locate(p[0], p[1], p[2], res);
    g = cot[e.x];
  };
  if (j < active) load();
  wait_for_previous();
  let_next_launch();
  for (bool first = true; j < active;
       j += gridDim.x * blockDim.x, first = false) {
    if (!first) load();
    const int slot = start[c.idx] + e.y;
    rows[slot] = e.x;
    data[slot] = make_float4(c.fx, c.fy, c.fz, g);
  }
  const int n_big = meta[kBigBuckets];
  if (n_big == 0) return;  // the same for every block of the hypothesis
  // the last block to finish sorts the big buckets in place, the compact
  // list (read by now) their spare memory
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    last = atomicAdd(meta + kDone, 1) == (int)gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  int* spare = reinterpret_cast<int*>(compact);
  const int bits = 32 - __clz(max(n - 1, 1));
  for (int k = 0; k < n_big; ++k) {
    const int b = __ldcg(big + k);
    const int s = __ldcg(start + b);
    sort_rows(rows + s, spare + s, __ldcg(count + b), bits);
  }
}

// The buckets of a cell: bucket k's row count m and its first slot `base`
// (0 where empty; both loads at once: an empty bucket's start is never
// used).
struct Buckets {
  int m, base;
};

__device__ __forceinline__ Buckets cell_buckets(const int* __restrict__ count,
                                               const int* __restrict__ start,
                                               int cell, int k, int res) {
  Buckets q{0, 0};
  const int b = cell >= 0 && k < 8 ? base_of(cell, k, res) : -1;
  if (b >= 0) {
    // both loads at once: an empty bucket's start is never used; from L2,
    // as the gather reads them before the place stage has finished
    q.m = __ldcg(count + b);
    q.base = __ldcg(start + b);
  }
  return q;
}

// A bitonic network over groups of G lanes, one element a lane (G <= 32,
// a power of 2): each group's G keys end ascending.  Ties keep their
// values (only padding ties).
template <int G>
__device__ __forceinline__ void bitonic_sort(int& key, float& val, int s) {
#pragma unroll
  for (int k = 2; k <= G; k <<= 1) {
#pragma unroll
    for (int j = k >> 1; j > 0; j >>= 1) {
      const int pk = __shfl_xor_sync(kFull, key, j);
      const float pv = __shfl_xor_sync(kFull, val, j);
      // an ascending pair's lower element keeps the smaller key
      const bool small = ((s & k) == 0) == ((s & j) == 0);
      if (small ? pk < key : pk > key) {
        key = pk;
        val = pv;
      }
    }
  }
}

// The cell's up-to-8 buckets, from sub-lanes 0-7 of each group of G lanes:
// upto[k] counts the contributions in buckets 0..k, and contribution e,
// in the first bucket k with e < upto[k], lies at slot e + base[k].
template <int G>
__device__ __forceinline__ void group_buckets(const int* __restrict__ count,
                                              const int* __restrict__ start,
                                              int cell, int lane, int res,
                                              int (&upto)[8],
                                              int (&base)[8]) {
  const int s = lane & (G - 1);
  const Buckets q = cell_buckets(count, start, cell, s, res);
  int incl = q.m;  // inclusive over the group's buckets
#pragma unroll
  for (int d = 1; d < 8; d <<= 1) {
    const int v = __shfl_up_sync(kFull, incl, d, 8);
    if ((lane & 7) >= d) incl += v;
  }
  const int first = q.base - (incl - q.m);
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    upto[k] = __shfl_sync(kFull, incl, k, G);
    base[k] = __shfl_sync(kFull, first, k, G);
  }
}

// The slot of contribution e of a cell and its bucket (*bucket): the
// first bucket k with e < upto[k], at offset base[k].
__device__ __forceinline__ int slot_of(const int (&upto)[8],
                                       const int (&base)[8], int e,
                                       int* bucket) {
  int k = 7, first = base[7];  // selects, not an index: registers only
#pragma unroll
  for (int j = 6; j >= 0; --j)
    if (e < upto[j]) {
      k = j;
      first = base[j];
    }
  if (bucket) *bucket = k;
  return first + e;
}

// Contribution e of a cell: its row (the sort key) and value.
__device__ __forceinline__ int load_contribution(
    const int* __restrict__ rows, const float4* __restrict__ data,
    const int (&upto)[8], const int (&base)[8], int e, float* val) {
  int k;
  const int slot = slot_of(upto, base, e, &k);
  const float4 f = data[slot];
  *val = contribution(f.x, f.y, f.z, f.w, k);
  return rows[slot];
}

// Cells of at most G contributions (G = 8, 16 or 32), one to each group of
// G lanes, their buckets read (group_buckets): each lane loads one
// contribution, the group's network sorts them by row and sub-lane 0
// folds them in order from its group's shuffles.  `cell` is -1 for a
// group without one.
template <int G>
__device__ __forceinline__ void group_cells(const int* __restrict__ rows,
                                            const float4* __restrict__ data,
                                            float* __restrict__ grad,
                                            const int (&upto)[8],
                                            const int (&base)[8], int cell,
                                            int lane) {
  const int s = lane & (G - 1);
  const int t = upto[7];
  int key = INT_MAX;
  float val = 0.0f;
  if (s < t) key = load_contribution(rows, data, upto, base, s, &val);
  bitonic_sort<G>(key, val, s);
  float acc = 0.0f;
  const int steps = __reduce_max_sync(kFull, t);
  for (int src = 0; src < steps; ++src)
    acc = __fadd_rn(acc, __shfl_sync(kFull, val, src, G));
  if (s == 0 && cell >= 0) grad[cell] = acc;
}

// Windows of row indices, each contribution of a window set at its row's
// bit (a cell has at most one contribution per row): a contribution's
// place in row order is the set bits before its own, the prefix count of
// its word plus those below it in the word.  A warp's window: 32 x 512
// bits; a block's: 32 x 4096.
constexpr int kWarpWords = 128;
constexpr int kBlockWords = 1024;
constexpr int kHugeWords = kBlockCell / 32;

struct alignas(16) WarpWindow {
  float ordered[kWarpCell];
  unsigned bits[kWarpWords];
  unsigned short before[kWarpWords];
};

struct alignas(16) BlockWindow {
  float ordered[kBlockCell];
  unsigned bits[kBlockWords];
  unsigned short before[kBlockWords];
};

struct alignas(16) Shared {
  union {
    BlockWindow block;
    WarpWindow warp[kWarps];
  };
  // a block cell's buckets: counts, first slots, the inclusive counts
  // over its small buckets (at most kBlockCell rows) and their slot
  // offsets (slot = contribution + offset); a big (sorted) bucket's
  // window [from, next)
  int m[8], first[8], small[8], small_base[8], from[8], next[8];
  int total, lo_next;
  int warp_sum[kWarps];
};

// Adds values 0 .. t - 1 of shared memory (16-byte aligned) to acc in
// order.
__device__ __forceinline__ float fold_shared(const float* v, int t,
                                             float acc) {
  int e = 0;
  for (; e + 8 <= t; e += 8) {
    const float4 a = *reinterpret_cast<const float4*>(v + e);
    const float4 b = *reinterpret_cast<const float4*>(v + e + 4);
    acc = __fadd_rn(acc, a.x);
    acc = __fadd_rn(acc, a.y);
    acc = __fadd_rn(acc, a.z);
    acc = __fadd_rn(acc, a.w);
    acc = __fadd_rn(acc, b.x);
    acc = __fadd_rn(acc, b.y);
    acc = __fadd_rn(acc, b.z);
    acc = __fadd_rn(acc, b.w);
  }
  for (; e < t; ++e) acc = __fadd_rn(acc, v[e]);
  return acc;
}

// The place in row order of the contribution at bit `off` of a window.
__device__ __forceinline__ int rank_in(const unsigned* bits,
                                       const unsigned short* before,
                                       int off) {
  const int w = off >> 5;
  return before[w] + __popc(bits[w] & ((1u << (off & 31)) - 1u));
}

// One cell of 33 to 32 E contributions (E = 2, 4 or 8), by one warp, its
// buckets read (group_buckets<32>): each lane loads E contributions into
// registers once; then windows of
// 32 kWarpWords rows from the least row up, each ordered through its
// bitmap into `ordered` and folded there by lane 0.
template <int E>
__device__ __forceinline__ float warp_window_cell(
    WarpWindow& ww, const int* __restrict__ rows,
    const float4* __restrict__ data, const int (&upto)[8],
    const int (&base)[8], int lane) {
  constexpr int kRows = 32 * kWarpWords, kPerLane = kWarpWords / 32;
  const int t = upto[7];
  int key[E];
  float val[E];
  int least = INT_MAX;
#pragma unroll
  for (int i = 0; i < E; ++i) {
    const int e = i * 32 + lane;
    key[i] = INT_MAX;
    val[i] = 0.0f;
    if (e < t) key[i] = load_contribution(rows, data, upto, base, e, &val[i]);
    least = min(least, key[i]);
  }
  float acc = 0.0f;
  for (int lo = __reduce_min_sync(kFull, least); lo != INT_MAX;) {
    const int hi = lo < INT_MAX - kRows ? lo + kRows : INT_MAX;
    for (int w = lane; w < kWarpWords; w += 32) ww.bits[w] = 0u;
    __syncwarp();
    int next = INT_MAX;
#pragma unroll
    for (int i = 0; i < E; ++i) {
      if (key[i] >= lo && key[i] < hi) {
        const int off = key[i] - lo;
        atomicOr(&ww.bits[off >> 5], 1u << (off & 31));
      } else if (key[i] >= hi) {
        next = min(next, key[i]);
      }
    }
    __syncwarp();
    unsigned word[kPerLane];
    int sum = 0;
#pragma unroll
    for (int j = 0; j < kPerLane; ++j) {
      word[j] = ww.bits[lane * kPerLane + j];
      sum += __popc(word[j]);
    }
    int incl = sum;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int v = __shfl_up_sync(kFull, incl, d);
      if (lane >= d) incl += v;
    }
    int below = incl - sum;
#pragma unroll
    for (int j = 0; j < kPerLane; ++j) {
      ww.before[lane * kPerLane + j] = (unsigned short)below;
      below += __popc(word[j]);
    }
    const int in_window = __shfl_sync(kFull, incl, 31);
    __syncwarp();
#pragma unroll
    for (int i = 0; i < E; ++i)
      if (key[i] >= lo && key[i] < hi)
        ww.ordered[rank_in(ww.bits, ww.before, key[i] - lo)] = val[i];
    __syncwarp();
    if (lane == 0) acc = fold_shared(ww.ordered, in_window, acc);
    __syncwarp();
    lo = __reduce_min_sync(kFull, next);
  }
  return __shfl_sync(kFull, acc, 0);
}

// An exclusive prefix sum over the block's threads (every thread calls
// it); *total gets the sum.
__device__ __forceinline__ int block_exclusive(Shared& sh, int v, int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int incl = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int u = __shfl_up_sync(kFull, incl, d);
    if (lane >= d) incl += u;
  }
  if (lane == 31) sh.warp_sum[warp] = incl;
  __syncthreads();
  int before = 0, sum = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const int c = sh.warp_sum[w];
    before += w < warp ? c : 0;
    sum += c;
  }
  __syncthreads();  // warp_sum is free again
  *total = sum;
  return before + incl - v;
}

// One block-list cell, by the whole block: warp 0 reads its buckets, then
// windows of row indices from the least row up.  A pass sets the bits of
// a window's contributions; a prefix count over the words places each in
// `ordered`; thread 0 folds them.  Up to kBlockCell contributions, a
// window spans 32 kBlockWords rows; more (a huge cell), 32 kHugeWords
// rows, so that a window holds at most kBlockCell.  A big bucket (sorted
// by row since the place stage; the row's fractions are then taken from
// its point) is read as a run, from where the last window stopped to its
// first row past this one; a small one is scanned whole in every window.
__device__ float block_cell(Shared& sh, const float* __restrict__ points,
                            const float* __restrict__ cot,
                            const int* __restrict__ count,
                            const int* __restrict__ start,
                            const int* __restrict__ rows,
                            const float4* __restrict__ data, int cell,
                            int res) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (warp == 0) {
    const Buckets q = cell_buckets(count, start, cell, lane, res);
    const int small = q.m <= kBlockCell ? q.m : 0;
    int incl = q.m, small_incl = small;
#pragma unroll
    for (int d = 1; d < 8; d <<= 1) {
      const int v = __shfl_up_sync(kFull, incl, d);
      const int u = __shfl_up_sync(kFull, small_incl, d);
      if (lane >= d) {
        incl += v;
        small_incl += u;
      }
    }
    if (lane < 8) {
      sh.m[lane] = q.m;
      sh.first[lane] = q.base;
      sh.small[lane] = small_incl;
      sh.small_base[lane] = q.base - (small_incl - small);
      sh.next[lane] = 0;
    }
    if (lane == 7) sh.total = incl;
  }
  if (threadIdx.x == 0) sh.lo_next = INT_MAX;
  __syncthreads();
  const int t = sh.total, t_small = sh.small[7];
  int upto[8], base[8];  // the small buckets, as load_contribution takes
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    upto[k] = sh.small[k];
    base[k] = sh.small_base[k];
  }
  const int words = t > kBlockCell ? kHugeWords : kBlockWords;
  const int span = 32 * words, per_thread = (words + kThreads - 1) / kThreads;
  BlockWindow& bw = sh.block;
  // the small buckets' contributions in one pass, the big ones as runs
  int least = INT_MAX;
  for (int e = threadIdx.x; e < t_small; e += blockDim.x)
    least = min(least, rows[slot_of(upto, base, e, nullptr)]);
  if (threadIdx.x < 8 && sh.m[threadIdx.x] > kBlockCell)
    least = min(least, rows[sh.first[threadIdx.x]]);
  atomicMin(&sh.lo_next, least);
  __syncthreads();
  float acc = 0.0f;
  for (;;) {
    const int lo = sh.lo_next;
    if (lo == INT_MAX) break;
    const int hi = lo < INT_MAX - span ? lo + span : INT_MAX;
    for (int w = threadIdx.x; w < words; w += blockDim.x) bw.bits[w] = 0u;
    __syncthreads();
    if (threadIdx.x == 0) sh.lo_next = INT_MAX;
    int next = INT_MAX;
    for (int e = threadIdx.x; e < t_small; e += blockDim.x) {
      const int row = rows[slot_of(upto, base, e, nullptr)];
      if (row >= lo && row < hi) {
        atomicOr(&bw.bits[(row - lo) >> 5], 1u << ((row - lo) & 31));
      } else if (row >= hi) {
        next = min(next, row);
      }
    }
    for (int k = 0; k < 8; ++k) {
      const int m = sh.m[k], first = sh.first[k];
      if (m > kBlockCell) {
        // the run's rows in the window: chunks until one leaves it
        const int from = sh.next[k];
        int done = from;
        for (;;) {
          const int e = done + threadIdx.x;
          const int row = e < m ? rows[first + e] : INT_MAX;
          if (row < hi) {
            atomicOr(&bw.bits[(row - lo) >> 5], 1u << ((row - lo) & 31));
          } else if (e < m) {
            next = min(next, row);  // sorted: the run's next row is least
          }
          const int taken = __syncthreads_count(row < hi);
          done += taken;
          if (taken < (int)blockDim.x) break;
        }
        if (threadIdx.x == 0) {
          sh.from[k] = from;
          sh.next[k] = done;
        }
      }
    }
    __syncthreads();
    atomicMin(&sh.lo_next, next);
    unsigned word[(kBlockWords + kThreads - 1) / kThreads];
    int sum = 0;
#pragma unroll
    for (int j = 0; j < (kBlockWords + kThreads - 1) / kThreads; ++j) {
      const int w = threadIdx.x * per_thread + j;
      word[j] = j < per_thread && w < words ? bw.bits[w] : 0u;
      sum += __popc(word[j]);
    }
    int in_window;
    int below = block_exclusive(sh, sum, &in_window);
#pragma unroll
    for (int j = 0; j < (kBlockWords + kThreads - 1) / kThreads; ++j) {
      const int w = threadIdx.x * per_thread + j;
      if (j < per_thread && w < words) {
        bw.before[w] = (unsigned short)below;
        below += __popc(word[j]);
      }
    }
    __syncthreads();
    for (int e = threadIdx.x; e < t_small; e += blockDim.x) {
      int k;
      const int slot = slot_of(upto, base, e, &k);
      const int row = rows[slot];
      if (row >= lo && row < hi) {
        const float4 f = data[slot];
        bw.ordered[rank_in(bw.bits, bw.before, row - lo)] =
            contribution(f.x, f.y, f.z, f.w, k);
      }
    }
    for (int k = 0; k < 8; ++k) {
      if (sh.m[k] <= kBlockCell) continue;
      const int first = sh.first[k];
      for (int e = sh.from[k] + threadIdx.x; e < sh.next[k];
           e += blockDim.x) {
        const int row = rows[first + e];
        const float* p = points + 3 * (size_t)row;
        const sdfest::Cell c = sdfest::locate(p[0], p[1], p[2], res);
        bw.ordered[rank_in(bw.bits, bw.before, row - lo)] =
            contribution(c.fx, c.fy, c.fz, cot[row], k);
      }
    }
    __syncthreads();
    if (threadIdx.x == 0) acc = fold_shared(bw.ordered, in_window, acc);
    __syncthreads();
  }
  return acc;
}

__global__ void __launch_bounds__(kThreads, 4)
    scatter_kernel(const float* __restrict__ points,
                   const float* __restrict__ cot,
                   const int* __restrict__ count,
                   const int* __restrict__ start,
                   const int* __restrict__ meta,
                   const int* __restrict__ cells,
                   const int* __restrict__ small_cells,
                   const unsigned* __restrict__ touched,
                   const int* __restrict__ rows,
                   const float4* __restrict__ data, float* __restrict__ grad,
                   int n, int res) {
  __shared__ Shared sh;
  const int r3 = res * res * res, words = (r3 + 31) / 32;
  const size_t z = blockIdx.z;
  points += z * 3 * n;
  cot += z * n;
  count += z * r3;
  start += z * r3;
  meta += z * kMeta;
  cells += z * r3;
  small_cells += z * r3;
  touched += z * words;
  rows += z * n;
  data += z * n;
  grad += z * r3;
  // the warp tasks: a cell of up to 256 contributions, two of up to 16,
  // four of up to 8.  What the count and alloc stages wrote (the lists,
  // counts, starts, the touched bitmap) is final when this grid starts:
  // the first task's cells and buckets are read, and the untouched cells
  // written, while the place stage runs.
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n256 = __ldcg(meta + kList256), n16 = __ldcg(meta + kList16);
  const int n8 = __ldcg(meta + kList8);
  const int t16 = (n16 + 1) / 2, tasks = n256 + t16 + (n8 + 3) / 4;
  int j = blockIdx.x * kWarps + warp, cell = -1, upto[8], base[8];
  const auto prepare = [&]() {
    if (j < n256) {
      cell = __ldcg(cells + j);
      group_buckets<32>(count, start, cell, lane, res, upto, base);
    } else if (j < n256 + t16) {
      const int at = 2 * (j - n256) + (lane >> 4);
      cell = at < n16 ? __ldcg(small_cells + r3 - 1 - at) : -1;
      group_buckets<16>(count, start, cell, lane, res, upto, base);
    } else {
      const int at = 4 * (j - n256 - t16) + (lane >> 3);
      cell = at < n8 ? __ldcg(small_cells + at) : -1;
      group_buckets<8>(count, start, cell, lane, res, upto, base);
    }
  };
  if (j < tasks) prepare();
  // the cells no row touches (the alloc stage's bitmap)
  for (int c = blockIdx.x * blockDim.x + threadIdx.x; c < r3;
       c += gridDim.x * blockDim.x)
    if (!((__ldcg(touched + (c >> 5)) >> (c & 31)) & 1u)) grad[c] = 0.0f;
  wait_for_previous();
  // the block list first: its cells take longest
  const int n_block = meta[kBlockList];
  for (int b = blockIdx.x; b < n_block; b += gridDim.x) {
    const int c = cells[r3 - 1 - b];
    const float acc =
        block_cell(sh, points, cot, count, start, rows, data, c, res);
    if (threadIdx.x == 0) grad[c] = acc;
  }
  for (bool first = true; j < tasks; j += gridDim.x * kWarps, first = false) {
    if (!first) prepare();
    if (j < n256) {
      const int t = upto[7];
      if (t <= 32) {
        group_cells<32>(rows, data, grad, upto, base, cell, lane);
      } else {
        WarpWindow& ww = sh.warp[warp];
        float acc;
        if (t <= 64)
          acc = warp_window_cell<2>(ww, rows, data, upto, base, lane);
        else if (t <= 128)
          acc = warp_window_cell<4>(ww, rows, data, upto, base, lane);
        else
          acc = warp_window_cell<8>(ww, rows, data, upto, base, lane);
        if (lane == 0) grad[cell] = acc;
      }
    } else if (j < n256 + t16) {
      group_cells<16>(rows, data, grad, upto, base, cell, lane);
    } else {
      group_cells<8>(rows, data, grad, upto, base, cell, lane);
    }
  }
}

int blocks_for(long long items) {
  return (int)((items + kThreads - 1) / kThreads);
}

// Streaming multiprocessors and resident gather blocks per SM of the
// current device (asked once per device).
cudaError_t device_shape(int* sms, int* per_sm) {
  static int cache[64][2];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 64 && cache[dev][0] > 0) {
    *sms = cache[dev][0];
    *per_sm = cache[dev][1];
    return cudaSuccess;
  }
  err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, scatter_kernel,
                                                      kThreads, 0);
  if (err != cudaSuccess) return err;
  *per_sm = max(*per_sm, 1);
  if (dev < 64) {
    cache[dev][0] = *sms;
    cache[dev][1] = *per_sm;
  }
  return cudaSuccess;
}

}  // namespace

// scratch: 16-byte aligned, sdfest_scatter_words(n, batch, res) 4-byte
// words, laid out as (batch hypotheses each, one after the other): the
// placed rows' fractions and cotangents (n float4), the compact list of
// active rows (n int2: row, slot in its bucket), the placed rows (n), the
// counts (res^3), counters (kMeta) and touched bitmap ((res^3 + 31) / 32),
// zeroed by one memset, the listed buckets (res^3), the bucket starts
// (res^3), the lists of cells of up to 256 and of more contributions
// (res^3 together), of up to 8 and of up to 16 (res^3 together) and the
// big buckets (n / kBlockCell + 1).  grad need not be filled: every cell
// is written.
extern "C" long long sdfest_scatter_words(int n, int batch, int res) {
  const long long r3 = (long long)res * res * res;
  return (long long)batch * (7LL * n + r3 + kMeta + (r3 + 31) / 32 +
                             4 * r3 + (n / kBlockCell + 1));
}

extern "C" int sdfest_scatter(const float* points, const float* cot,
                              float* grad, void* scratch, int n, int batch,
                              int res, void* stream) {
  if (n <= 0 || batch <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  const int r3 = res * res * res;
  const size_t nb = (size_t)batch * n, cb = (size_t)batch * r3;
  float4* data = static_cast<float4*>(scratch);
  int2* compact = reinterpret_cast<int2*>(data + nb);
  int* rows = reinterpret_cast<int*>(compact + nb);
  const size_t words = (size_t)batch * ((r3 + 31) / 32);
  int* count = rows + nb;
  int* meta = count + cb;
  unsigned* touched = reinterpret_cast<unsigned*>(meta + (size_t)batch * kMeta);
  int* buckets = reinterpret_cast<int*>(touched + words);
  int* start = buckets + cb;
  int* cells = start + cb;
  int* small_cells = cells + cb;
  int* big = small_cells + cb;
  int sms = 0, per_sm = 0;
  cudaError_t err = device_shape(&sms, &per_sm);
  if (err != cudaSuccess) return (int)err;
  // the counts, counters and touched bitmap
  err = cudaMemsetAsync(
      count, 0, (cb + (size_t)batch * kMeta + words) * sizeof(int), s);
  if (err != cudaSuccess) return (int)err;
  const int t = kThreads;
  const auto wide = [](long long items) {
    return (int)((items + kWideThreads - 1) / kWideThreads);
  };
  const dim3 by_row(wide(n), 1, batch);
  const dim3 by_bucket(min(wide(8LL * min(n, r3)), sms), 1, batch);
  const dim3 by_active(min(blocks_for(n), sms), 1, batch);
  const dim3 gather(sms * per_sm, 1, batch);
  scatter_count_kernel<<<by_row, kWideThreads, 0, s>>>(
      points, cot, count, meta, compact, buckets, n, res);
  // each later stage may be scheduled while the one before runs, and
  // waits for it to finish before it reads (wait_for_previous)
  cudaLaunchAttribute early[1];
  early[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  early[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.blockDim = dim3(kWideThreads);
  cfg.stream = s;
  cfg.attrs = early;
  cfg.numAttrs = 1;
  cfg.gridDim = by_bucket;
  err = cudaLaunchKernelEx(&cfg, scatter_alloc_kernel, (const int*)count,
                           meta, (const int*)buckets, start, cells,
                           small_cells, touched, big, n, res);
  if (err != cudaSuccess) return (int)err;
  cfg.blockDim = dim3(t);
  cfg.gridDim = by_active;
  err = cudaLaunchKernelEx(&cfg, scatter_place_kernel, points, cot,
                           (const int*)count, (const int*)start, meta, compact,
                           (const int*)big, rows, data, n, res);
  if (err != cudaSuccess) return (int)err;
  cfg.gridDim = gather;
  err = cudaLaunchKernelEx(&cfg, scatter_kernel, points, cot,
                           (const int*)count, (const int*)start,
                           (const int*)meta, (const int*)cells,
                           (const int*)small_cells, (const unsigned*)touched,
                           (const int*)rows, (const float4*)data, grad, n,
                           res);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
