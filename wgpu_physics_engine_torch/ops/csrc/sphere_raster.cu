// Tile-binned nearest ray-sphere hit for Hopper (sm_90a): a load-balanced
// work list over (world, tile, sub-tile, candidate chunk), culled per warp.
//
// Replaces: wgpu_physics_engine_tpu/ops/raster_pallas.py, `_tiled_kernel`
// (K2) and `_tiled_kernel_chunked` (K3), both sweeping candidates with
// `_hit_sweep`, in their `return_oc=True` form: per pixel the nearest hit
// distance `tmin` (+inf on a miss), the winner's index in the prologue's
// sorted order (-1 on a miss) and the winner's eye-relative centre (zeros
// on a miss). The TPU kernels differ only in where the instance table
// sits: K2 holds it whole in SMEM (N <= 16384), K3 cuts it into SMEM
// chunks. Here the sorted table stays in global memory at any N, so one
// kernel covers both, and one launch covers a batch of worlds (the TPU
// package launched per world: Mosaic rejects batched SMEM scalars).
//
// What bounds it on the H100: per pixel and candidate ~13 flops and one
// IEEE sqrt, issued one candidate after another; global traffic is small.
// Two things decide the time: balance (at 256x256 the flagship's 64 tiles
// hold 39,691 candidates at most against a mean of 4,929, so a CTA a tile
// lasts as long as the busiest tile) and the candidates a pixel tests (a
// tile's ring of bins spans 24x384 pixels, but a binned sphere reaches at
// most 1.5 r_px + 2 < 8 pixels from its centre).
//
// Design:
//  * Work items. A tile's candidates (its four ranges of `wins`, in order:
//    the three row-ring ranges, then the global range, increasing sorted
//    indices) are cut into chunks of `chunk` (at least `chunk_min`, grown
//    with the frame's candidates so that the items fit a buffer the
//    wrapper sizes without reading the device), and each chunk into four
//    8x32-pixel sub-tiles: one item each, at least one chunk a tile. Four
//    small launches build the list on the device (counts, a scan in runs
//    of 1,024 tiles, the runs' prefix, the fill): `item_start` [worlds *
//    tiles + 1], the prefix of items a tile, and `item_tile`, an item's
//    tile. Persistent CTAs of 256 threads (one a pixel of the sub-tile),
//    as many as fit the card at once, take the next item from an atomic
//    counter, so the items of a heavy tile spread over every SM.
//  * Cull. The CTA stages 256 candidates at a time in shared memory (the
//    table `ocb` and the conservative pixel rectangle `rect` that the
//    prologue computes from its own screen bound: centre (col, row) +-
//    (1.5 r_px + 2), floored and ceiled; the whole frame for a sphere it
//    does not bin). Each warp owns a 4x8 patch of pixels and keeps, in
//    order, the staged candidates whose rectangle meets its patch (a
//    ballot a lane-stride); its 32 pixels then test only those. A sphere
//    outside the rectangle hits no pixel of the patch, so culling changes
//    no output bit.
//  * Merge. A pixel keeps the first strict minimum of t over its item's
//    candidates in increasing sorted index, the tie rule of `_hit_sweep`.
//    A tile of one chunk writes its outputs directly. The chunks of a
//    larger tile merge through a 64-bit key per pixel, the order-preserving
//    bits of t above the sorted index, under atomicMin: the least key is
//    the least t and, among equal t, the least index, so the merge gives
//    exactly the first strict minimum in sorted order whatever order the
//    items ran in. A last pass turns each key back into (tmin, inst) and
//    reads the winner's centre from the table.
// Built with -fmad=false and IEEE sqrt, so every output equals the plain
// full sweep bit for bit.

#include <cuda_runtime.h>

#include <math_constants.h>

#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kTileH = 8;
constexpr int kTileW = 128;
constexpr int kSubW = 32;                    // pixel columns of an item
constexpr int kSubs = kTileW / kSubW;        // 4 items a tile and chunk
constexpr int kThreads = kTileH * kSubW;     // 256, one a pixel
constexpr int kWarps = kThreads / 32;
constexpr int kPatchH = 4;                   // a warp's 4x8 pixel patch
constexpr int kPatchW = 8;
constexpr int kPatchCols = kSubW / kPatchW;  // 4 patches across an item
constexpr int kBatch = kThreads;             // candidates staged at once
constexpr int kPlanThreads = 1024;
constexpr unsigned long long kNoKey = ~0ull;

static_assert(kWarps == (kTileH / kPatchH) * kPatchCols, "patch layout");
static_assert(kBatch <= 256, "list entries are bytes");

// Order-preserving map of a float's bits to an unsigned int (and back).
__device__ __forceinline__ unsigned ordered(float t) {
  const unsigned u = __float_as_uint(t);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float unordered(unsigned u) {
  return __uint_as_float((u & 0x80000000u) ? (u & 0x7fffffffu) : ~u);
}

// Items a tile: its slot in the prefix `item_start`.
__device__ __forceinline__ int tile_items(const int* __restrict__ item_start,
                                          int64_t q) {
  return item_start[q + 1] - item_start[q];
}

// Candidates of tile q: the lengths of its four ranges summed.
__device__ __forceinline__ int tile_count(const int* __restrict__ wins,
                                          int64_t q) {
  const int* wq = wins + q * 8;
  int count = 0;
  for (int g = 0; g < 4; ++g) count += max(wq[2 * g + 1] - wq[2 * g], 0);
  return count;
}

// The work list, in four launches over the nq tiles: (1) each tile's
// candidates into counts[q] and their total; (2) the chunk c =
// max(chunk_min, ceil(total / extra)), each tile's items kSubs * max(1,
// ceil(count / c)) and their exclusive prefix within each run of
// kPlanThreads tiles, with each run's sum; (3) one CTA: the prefix of the
// runs' sums, and the list's length item_start[nq]; (4) item_start[q]
// with its run's prefix added, and item_tile of each of its items. With
// extra >= nq the items fit kSubs * (nq + extra): a tile's chunks are at
// most 1 + count / c. The scratch holds the total (u64), the sweep's item
// counter (int 2), then counts [nq] from int 4 and the runs' sums.
struct Plan {
  unsigned long long* total;
  int* counts;
  int* runs;
};

__device__ __forceinline__ Plan plan_of(int* scratch, int nq) {
  return Plan{reinterpret_cast<unsigned long long*>(scratch), scratch + 4,
              scratch + 4 + nq};
}

__global__ void __launch_bounds__(kPlanThreads)
    plan_count(const int* __restrict__ wins, int nq, int* scratch) {
  __shared__ unsigned long long s_sum;
  const Plan pl = plan_of(scratch, nq);
  if (threadIdx.x == 0) s_sum = 0;
  __syncthreads();
  const int q = blockIdx.x * kPlanThreads + threadIdx.x;
  if (q < nq) {
    const int c = tile_count(wins, q);
    pl.counts[q] = c;
    atomicAdd(&s_sum, static_cast<unsigned long long>(c));
  }
  __syncthreads();
  if (threadIdx.x == 0) atomicAdd(pl.total, s_sum);
}

// Exclusive prefix over the CTA of v (kPlanThreads values); returns the
// thread's prefix and sets `sum` to the CTA's total.
__device__ __forceinline__ int block_scan(int v, int& sum) {
  __shared__ int s_warp[kPlanThreads / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int incl = v;
  for (int d = 1; d < 32; d *= 2) {
    const int u = __shfl_up_sync(0xffffffffu, incl, d);
    if (lane >= d) incl += u;
  }
  if (lane == 31) s_warp[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    int x = s_warp[lane];
    for (int d = 1; d < 32; d *= 2) {
      const int u = __shfl_up_sync(0xffffffffu, x, d);
      if (lane >= d) x += u;
    }
    s_warp[lane] = x;
  }
  __syncthreads();
  sum = s_warp[kPlanThreads / 32 - 1];
  const int excl = incl - v + (warp > 0 ? s_warp[warp - 1] : 0);
  __syncthreads();                  // s_warp is reused by the next call
  return excl;
}

__device__ __forceinline__ int chunk_of(const Plan& pl, int chunk_min,
                                        int extra) {
  const long long need =
      (static_cast<long long>(*pl.total) + extra - 1) / extra;
  return static_cast<int>(max(static_cast<long long>(chunk_min), need));
}

__global__ void __launch_bounds__(kPlanThreads)
    plan_scan(int nq, int chunk_min, int extra, int* scratch,
              int* __restrict__ item_start, int* __restrict__ chunk) {
  const Plan pl = plan_of(scratch, nq);
  const int c = chunk_of(pl, chunk_min, extra);
  const int q = blockIdx.x * kPlanThreads + threadIdx.x;
  const int items = q < nq ? kSubs * max(1, (pl.counts[q] + c - 1) / c) : 0;
  int sum;
  const int excl = block_scan(items, sum);
  if (q < nq) item_start[q] = excl;
  if (threadIdx.x == 0) pl.runs[blockIdx.x] = sum;
  if (q == 0) *chunk = c;
}

__global__ void __launch_bounds__(kPlanThreads)
    plan_runs(int nq, int* scratch, int* __restrict__ item_start) {
  const Plan pl = plan_of(scratch, nq);
  const int n_runs = (nq + kPlanThreads - 1) / kPlanThreads;
  int carry = 0;
  for (int r0 = 0; r0 < n_runs; r0 += kPlanThreads) {
    const int r = r0 + threadIdx.x;
    const int v = r < n_runs ? pl.runs[r] : 0;
    int sum;
    const int excl = block_scan(v, sum);
    if (r < n_runs) pl.runs[r] = carry + excl;
    carry += sum;
  }
  if (threadIdx.x == 0) item_start[nq] = carry;
}

__global__ void __launch_bounds__(kPlanThreads)
    plan_fill(int nq, int chunk_min, int extra, int* scratch,
              int* __restrict__ item_start, int* __restrict__ item_tile) {
  const Plan pl = plan_of(scratch, nq);
  const int c = chunk_of(pl, chunk_min, extra);
  const int q = blockIdx.x * kPlanThreads + threadIdx.x;
  if (q >= nq) return;
  const int at = item_start[q] + pl.runs[blockIdx.x];
  item_start[q] = at;
  const int n_items = kSubs * max(1, (pl.counts[q] + c - 1) / c);
  for (int k = 0; k < n_items; ++k) item_tile[at + k] = q;
}

// The four launches of the work list; `scratch` i32 [plan_ints(nq)].
int plan(const int* wins, int nq, int chunk_min, int extra,
         int* item_start, int* item_tile, int* chunk, int* scratch,
         cudaStream_t s) {
  const cudaError_t err = cudaMemsetAsync(scratch, 0, 4 * sizeof(int), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int runs = (nq + kPlanThreads - 1) / kPlanThreads;
  plan_count<<<runs, kPlanThreads, 0, s>>>(wins, nq, scratch);
  plan_scan<<<runs, kPlanThreads, 0, s>>>(nq, chunk_min, extra, scratch,
                                          item_start, chunk);
  plan_runs<<<1, kPlanThreads, 0, s>>>(nq, scratch, item_start);
  plan_fill<<<runs, kPlanThreads, 0, s>>>(nq, chunk_min, extra, scratch,
                                          item_start, item_tile);
  return static_cast<int>(cudaGetLastError());
}

// The sweep: each CTA takes the next item of the work list from an atomic
// counter until none is left. At least 6 CTAs an SM: an item is short, and
// its latency is hidden by having many in flight.
__global__ void __launch_bounds__(kThreads, 6)
    sphere_raster_kernel(const float* __restrict__ znear_p,
                         const int* __restrict__ wins,
                         const float* __restrict__ ocb,
                         const int* __restrict__ rect,
                         const float* __restrict__ dirs,
                         const int* __restrict__ item_start,
                         const int* __restrict__ item_tile,
                         const int* __restrict__ chunk_p,
                         int* __restrict__ counter,
                         unsigned long long* __restrict__ keys,
                         float* __restrict__ tmin_out,
                         int* __restrict__ inst_out,
                         float* __restrict__ oc_out, int n, int h, int w,
                         int tx_tiles, int n_tiles, int n_worlds) {
  __shared__ float4 s_oc[kBatch];
  __shared__ int4 s_rect[kBatch];
  __shared__ int s_idx[kBatch];
  __shared__ unsigned char s_list[kWarps][kBatch];
  __shared__ int s_item;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int64_t hw = static_cast<int64_t>(h) * w;
  const int64_t nq = static_cast<int64_t>(n_tiles) * n_worlds;
  const int total = item_start[nq];
  const int chunk = *chunk_p;
  // this thread's pixel inside an item, and its warp's patch
  const int prow = (warp / kPatchCols) * kPatchH;
  const int pcol = (warp % kPatchCols) * kPatchW;
  const int py = prow + lane / kPatchW;
  const int px = pcol + lane % kPatchW;

  for (;;) {
    if (tid == 0) s_item = atomicAdd(counter, 1);
    __syncthreads();
    const int k = s_item;
    if (k >= total) break;
    const int q = item_tile[k];
    const int local = k - item_start[q];
    const int sub = local % kSubs;
    const int ck = local / kSubs;
    const bool direct = tile_items(item_start, q) == kSubs;
    const int64_t world = q / n_tiles;
    const int tile = q % n_tiles;
    const int* wq = wins + static_cast<int64_t>(q) * 8;
    int rs[4], rl[4];
    int count = 0;
    for (int g = 0; g < 4; ++g) {
      rs[g] = wq[2 * g];
      rl[g] = max(wq[2 * g + 1] - rs[g], 0);
      count += rl[g];
    }
    const int p_begin = ck * chunk;
    const int p_end = min(count, p_begin + chunk);

    const int y0 = (tile / tx_tiles) * kTileH;
    const int x0 = (tile % tx_tiles) * kTileW + sub * kSubW;
    const int row = y0 + py;
    const int col = x0 + px;
    const bool live = row < h && col < w;
    const int64_t pix = static_cast<int64_t>(row) * w + col;
    // the patch rectangle, inclusive
    const int ry0 = y0 + prow, ry1 = ry0 + kPatchH - 1;
    const int rx0 = x0 + pcol, rx1 = rx0 + kPatchW - 1;

    const float* ocw = ocb + world * 4 * n;
    const int* rectw = rect + world * 4 * n;
    const float znear = znear_p[world];
    float dx = 0.0f, dy = 0.0f, dz = 0.0f;
    if (live) {
      const float* d = dirs + world * 3 * hw;
      dx = d[pix];
      dy = d[hw + pix];
      dz = d[2 * hw + pix];
    }
    float tmin = CUDART_INF_F;
    int inst = -1;
    float wx = 0.0f, wy = 0.0f, wz = 0.0f;

    for (int base = p_begin; base < p_end; base += kBatch) {
      const int m = min(kBatch, p_end - base);
      if (tid < m) {
        // position -> sorted index through the four ranges
        int p = base + tid, j;
        if (p < rl[0]) {
          j = rs[0] + p;
        } else if ((p -= rl[0]) < rl[1]) {
          j = rs[1] + p;
        } else if ((p -= rl[1]) < rl[2]) {
          j = rs[2] + p;
        } else {
          j = rs[3] + p - rl[2];
        }
        s_oc[tid] = make_float4(ocw[j], ocw[n + j], ocw[2 * n + j],
                                ocw[3 * n + j]);
        s_rect[tid] = make_int4(rectw[j], rectw[n + j], rectw[2 * n + j],
                                rectw[3 * n + j]);
        s_idx[tid] = j;
      }
      __syncthreads();
      // the warp's list: staged candidates whose rectangle meets its patch,
      // in staging (= sorted) order
      int cnt = 0;
      for (int c0 = 0; c0 < m; c0 += 32) {
        const int c = c0 + lane;
        bool keep = false;
        if (c < m) {
          const int4 r = s_rect[c];
          keep = r.x <= rx1 && r.y >= rx0 && r.z <= ry1 && r.w >= ry0;
        }
        const unsigned ball = __ballot_sync(0xffffffffu, keep);
        if (keep)
          s_list[warp][cnt + __popc(ball & ((1u << lane) - 1u))] =
              static_cast<unsigned char>(c);
        cnt += __popc(ball);
      }
      __syncwarp();
      if (live) {
        for (int e = 0; e < cnt; ++e) {
          const int c = s_list[warp][e];
          const float4 o = s_oc[c];
          const float b = dx * o.x + dy * o.y + dz * o.z;
          const float disc = b * b - o.w;
          const float t = b - sqrtf(fmaxf(disc, 0.0f));
          if (disc > 0.0f && t > znear && t < tmin) {
            tmin = t;
            inst = s_idx[c];
            wx = o.x;
            wy = o.y;
            wz = o.z;
          }
        }
      }
      __syncthreads();
    }

    if (live) {
      const int64_t at = world * hw + pix;
      if (direct) {
        tmin_out[at] = tmin;
        inst_out[at] = inst;
        float* o = oc_out + world * 3 * hw;
        o[pix] = wx;
        o[hw + pix] = wy;
        o[2 * hw + pix] = wz;
      } else if (inst >= 0) {
        atomicMin(keys + at,
                  (static_cast<unsigned long long>(ordered(tmin)) << 32) |
                      static_cast<unsigned>(inst));
      }
    }
    __syncthreads();            // every thread has read s_item
  }
}

// Before the sweep: the keys of the pixels of every tile of several chunks
// to "no hit". After it: those keys back to (tmin, inst, oc). One CTA a
// (world, tile); tiles of one chunk (kSubs items) return at once.
template <bool FINISH>
__global__ void __launch_bounds__(kThreads)
    sphere_raster_merge(const int* __restrict__ item_start,
                        const float* __restrict__ ocb,
                        unsigned long long* __restrict__ keys,
                        float* __restrict__ tmin_out,
                        int* __restrict__ inst_out,
                        float* __restrict__ oc_out, int n, int h, int w,
                        int tx_tiles, int n_tiles) {
  const int64_t q = blockIdx.x;
  if (tile_items(item_start, q) == kSubs) return;
  const int64_t world = q / n_tiles;
  const int tile = static_cast<int>(q % n_tiles);
  const int64_t hw = static_cast<int64_t>(h) * w;
  for (int e = threadIdx.x; e < kTileH * kTileW; e += kThreads) {
    const int row = (tile / tx_tiles) * kTileH + e / kTileW;
    const int col = (tile % tx_tiles) * kTileW + e % kTileW;
    if (row >= h || col >= w) continue;
    const int64_t pix = static_cast<int64_t>(row) * w + col;
    const int64_t at = world * hw + pix;
    if (!FINISH) {
      keys[at] = kNoKey;
      continue;
    }
    const unsigned long long key = keys[at];
    float* o = oc_out + world * 3 * hw;
    if (key == kNoKey) {
      tmin_out[at] = CUDART_INF_F;
      inst_out[at] = -1;
      o[pix] = 0.0f;
      o[hw + pix] = 0.0f;
      o[2 * hw + pix] = 0.0f;
    } else {
      const int j = static_cast<int>(key & 0xffffffffu);
      const float* ocw = ocb + world * 4 * n;
      tmin_out[at] = unordered(static_cast<unsigned>(key >> 32));
      inst_out[at] = j;
      o[pix] = ocw[j];
      o[hw + pix] = ocw[n + j];
      o[2 * hw + pix] = ocw[2 * n + j];
    }
  }
}

}  // namespace

// The work list alone (the first launches of wpe_sphere_raster): wins
// i32 [nq, 8] of nq tiles; chunk_min, extra (>= nq) as for
// wpe_sphere_raster. Outputs item_start i32 [nq + 1], item_tile i32 [4 *
// (nq + extra)], chunk i32 [1]; scratch i32 [4 + nq + ceil(nq / 1024)].
extern "C" int wpe_sphere_raster_plan(const int* wins, int nq, int chunk_min,
                                      int extra, int* item_start,
                                      int* item_tile, int* chunk,
                                      int* scratch, void* stream) {
  if (nq < 1 || chunk_min < 1 || extra < nq ||
      static_cast<int64_t>(kSubs) * (static_cast<int64_t>(nq) + extra) >
          0x7fffffff)
    return cudaErrorInvalidValue;
  return plan(wins, nq, chunk_min, extra, item_start, item_tile, chunk,
              scratch, static_cast<cudaStream_t>(stream));
}

// n_worlds worlds in one call. Per world: wins i32 [n_tiles, 8], four
// [start, end) ranges per tile into the sorted table; ocb f32 [4, n]
// (eye-relative centre xyz, |oc|^2 - r^2); rect i32 [4, n] (pixel column
// lo, hi, row lo, hi of each sphere's conservative footprint, inclusive);
// dirs f32 [3, h, w]; znear f32 (one per world, on the device). All arrays
// hold the worlds back to back (a leading [n_worlds] axis). The work list
// is built here into item_start i32 [nq + 1], item_tile i32 [4 * (nq +
// extra)] and chunk i32 [1] (nq = n_worlds * tiles; chunks of at least
// chunk_min candidates, extra >= nq) with scratch i32 [4 + nq + ceil(nq /
// 1024)]; keys u64 [n_worlds, h, w] is scratch too. Outputs tmin f32 [h,
// w], inst i32 [h, w] (sorted index), oc f32 [3, h, w]. Launches: the four
// of the work list, the merge keys, the sweep over as many persistent
// CTAs as fit the card, the merge.
extern "C" int wpe_sphere_raster(const float* znear, const int* wins,
                                 const float* ocb, const int* rect,
                                 const float* dirs, int* item_start,
                                 int* item_tile, int* chunk, int* scratch,
                                 void* keys, float* tmin_out, int* inst_out,
                                 float* oc_out, int n_worlds, int n, int h,
                                 int w, int ty_tiles, int tx_tiles,
                                 int chunk_min, int extra, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n_tiles = ty_tiles * tx_tiles;
  const int64_t nq = static_cast<int64_t>(n_tiles) * n_worlds;
  if (nq > 0x7fffffff) return cudaErrorInvalidConfiguration;
  if (nq == 0) return cudaSuccess;
  static int ctas = 0;                // the persistent grid, once a process
  if (ctas == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, sphere_raster_kernel, kThreads, 0);
    if (err != cudaSuccess) return static_cast<int>(err);
    ctas = sms * max(per_sm, 1);
  }
  const int err = wpe_sphere_raster_plan(wins, static_cast<int>(nq),
                                         chunk_min, extra, item_start,
                                         item_tile, chunk, scratch, stream);
  if (err != cudaSuccess) return err;
  auto* k64 = static_cast<unsigned long long*>(keys);
  const unsigned grid_q = static_cast<unsigned>(nq);
  sphere_raster_merge<false><<<grid_q, kThreads, 0, s>>>(
      item_start, ocb, k64, tmin_out, inst_out, oc_out, n, h, w, tx_tiles,
      n_tiles);
  sphere_raster_kernel<<<ctas, kThreads, 0, s>>>(
      znear, wins, ocb, rect, dirs, item_start, item_tile, chunk,
      scratch + 2, k64, tmin_out, inst_out, oc_out, n, h, w, tx_tiles,
      n_tiles, n_worlds);
  sphere_raster_merge<true><<<grid_q, kThreads, 0, s>>>(
      item_start, ocb, k64, tmin_out, inst_out, oc_out, n, h, w, tx_tiles,
      n_tiles);
  return static_cast<int>(cudaGetLastError());
}
