// Tile-binned nearest ray-sphere hit for Hopper (sm_90a).
//
// Replaces: wgpu_physics_engine_tpu/ops/raster_pallas.py, `_tiled_kernel`
// (K2) and `_tiled_kernel_chunked` (K3), both sweeping candidates with
// `_hit_sweep`, in their `return_oc=True` form: per pixel the nearest hit
// distance `tmin` (+inf on a miss), the winner's index in the prologue's
// sorted order (-1 on a miss) and the winner's eye-relative centre (zeros
// on a miss). The TPU kernels differ only in where the instance table
// sits: K2 holds it whole in SMEM (N <= 16384), K3 cuts it into SMEM
// chunks. Here the sorted table stays in global memory at any N, so one
// kernel covers both. The TPU package launched them once per world in
// datagen (Mosaic rejects batched SMEM scalars); here one launch covers a
// batch of worlds, each with its own tables, rays and znear.
//
// What bounds it on the H100: per pixel and candidate ~12 flops and one
// IEEE sqrt, and the candidate's 16 bytes, which every pixel of the tile
// reads. Global traffic is small (the table is read once per tile and the
// outputs written once); the bound is the issue rate of the sweep. The
// design stages each block of candidates in shared memory once for the
// whole tile, so the 1024 threads of a tile read it from there. Measured
// at 256x256 with the 65,536 draped instances of the flagship (H100 SXM,
// 700 W): 7.2 ms, because the wide (8, 128) bins give only 64 tiles (64
// CTAs on 132 SMs) and each tile's ring holds thousands of candidates.
// Splitting a tile's pixels over several CTAs is the next step. In
// datagen (3,600 instances a world) a batch of worlds gives 64 tiles per
// world and the CTAs fill the card.
//
// Design: one CTA per (world, (8, 128) pixel tile), one thread per pixel,
// world offsets in 64 bits (4096 worlds of 256x256 rays are 805M floats).
// The CTA walks the tile's four candidate ranges from `wins` in order (the
// three row-ring ranges, then the global range), loading up to 1024
// candidates at a time into shared memory, and each thread keeps the FIRST
// strict minimum of t in sorted-index order, the tie rule of `_hit_sweep`,
// so the winners match the TPU kernel bit for bit. Tiles are ceil-divided;
// the ragged edge pixels take part in loading and barriers but write
// nothing. A single world is the same launch with one world.

#include <cuda_runtime.h>

#include <math_constants.h>

#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kTileH = 8;
constexpr int kTileW = 128;
constexpr int kThreads = kTileH * kTileW;

__global__ void __launch_bounds__(kThreads)
    sphere_raster_kernel(const float* __restrict__ znear_p,
                         const int* __restrict__ wins,
                         const float* __restrict__ ocb,
                         const float* __restrict__ dirs,
                         float* __restrict__ tmin_out,
                         int* __restrict__ inst_out,
                         float* __restrict__ oc_out, int n, int h, int w,
                         int tx_tiles, int n_tiles) {
  __shared__ float s_ox[kThreads];
  __shared__ float s_oy[kThreads];
  __shared__ float s_oz[kThreads];
  __shared__ float s_cc[kThreads];

  const int64_t world = blockIdx.x / n_tiles;
  const int tile = static_cast<int>(blockIdx.x % n_tiles);
  const int64_t hw = static_cast<int64_t>(h) * w;
  wins += world * n_tiles * 8;
  ocb += world * 4 * n;
  dirs += world * 3 * hw;
  tmin_out += world * hw;
  inst_out += world * hw;
  oc_out += world * 3 * hw;

  const int row = (tile / tx_tiles) * kTileH + threadIdx.y;
  const int col = (tile % tx_tiles) * kTileW + threadIdx.x;
  const int tid = threadIdx.y * kTileW + threadIdx.x;
  const bool live = row < h && col < w;
  const int64_t pix = static_cast<int64_t>(row) * w + col;

  const float znear = znear_p[world];
  float dx = 0.0f, dy = 0.0f, dz = 0.0f;
  if (live) {
    dx = dirs[pix];
    dy = dirs[hw + pix];
    dz = dirs[2 * hw + pix];
  }
  float tmin = CUDART_INF_F;
  int inst = -1;
  float wx = 0.0f, wy = 0.0f, wz = 0.0f;

  for (int g = 0; g < 4; ++g) {
    const int start = wins[tile * 8 + 2 * g];
    const int end = wins[tile * 8 + 2 * g + 1];
    for (int base = start; base < end; base += kThreads) {
      const int k = base + tid;
      if (k < end) {
        s_ox[tid] = ocb[k];
        s_oy[tid] = ocb[n + k];
        s_oz[tid] = ocb[2 * n + k];
        s_cc[tid] = ocb[3 * n + k];
      }
      __syncthreads();
      const int m = min(kThreads, end - base);
      if (live) {
        for (int j = 0; j < m; ++j) {
          const float ocx = s_ox[j], ocy = s_oy[j], ocz = s_oz[j];
          const float b = dx * ocx + dy * ocy + dz * ocz;
          const float disc = b * b - s_cc[j];
          const float t = b - sqrtf(fmaxf(disc, 0.0f));
          if (disc > 0.0f && t > znear && t < tmin) {
            tmin = t;
            inst = base + j;
            wx = ocx;
            wy = ocy;
            wz = ocz;
          }
        }
      }
      __syncthreads();
    }
  }
  if (live) {
    tmin_out[pix] = tmin;
    inst_out[pix] = inst;
    oc_out[pix] = wx;
    oc_out[hw + pix] = wy;
    oc_out[2 * hw + pix] = wz;
  }
}

}  // namespace

// n_worlds worlds in one launch. Per world: wins i32 [n_tiles, 8], four
// [start, end) ranges per tile into the sorted table; ocb f32 [4, n]
// (eye-relative centre xyz, |oc|^2 - r^2); dirs f32 [3, h, w]; znear f32
// (one per world, on the device). Outputs tmin f32 [h, w], inst i32 [h, w]
// (sorted index), oc f32 [3, h, w]. All arrays hold the worlds back to
// back (a leading [n_worlds] axis).
extern "C" int wpe_sphere_raster(const float* znear, const int* wins,
                                 const float* ocb, const float* dirs,
                                 float* tmin_out, int* inst_out,
                                 float* oc_out, int n_worlds, int n, int h,
                                 int w, int ty_tiles, int tx_tiles,
                                 void* stream) {
  const int n_tiles = ty_tiles * tx_tiles;
  const int64_t blocks = static_cast<int64_t>(n_tiles) * n_worlds;
  if (blocks > 0x7fffffff) return cudaErrorInvalidConfiguration;
  const dim3 block(kTileW, kTileH);
  const dim3 grid(static_cast<unsigned>(blocks));
  sphere_raster_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      znear, wins, ocb, dirs, tmin_out, inst_out, oc_out, n, h, w, tx_tiles,
      n_tiles);
  return static_cast<int>(cudaGetLastError());
}
