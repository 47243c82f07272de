// Untiled nearest ray-sphere hit for Hopper (sm_90a).
//
// Replaces: wgpu_physics_engine_tpu/ops/raster_pallas.py, `_kernel` (K4),
// launched by `sphere_raster`: per pixel, the nearest hit distance `tmin`
// (+inf on a miss) over ALL instances, and the winner's original instance
// id (-1 on a miss); ties go to the lower id. The renderer takes it for one
// world of at most MAX_INSTANCES = 16384 instances on a frame that is not a
// multiple of (16, 128) pixels, e.g. the free-particle scene's 10 spheres
// at 600x800.
//
// What bounds it on the H100: per (pixel, instance) ~12 flops and one IEEE
// sqrt. At 16,384 instances on 600x800 that is 9.4e10 flops, ~1.4 ms at
// the card's 67 TFLOP/s fp32: bound by operations. At 10 instances the
// bytes bound it: the rays in and two planes out, ~9.6 MB.
//
// Design: one thread per pixel, 256 pixels a CTA. The CTA stages the
// eye-relative table ocb [4, n] (centre xyz, |oc|^2 - r^2, computed once by
// the wrapper) through shared memory in chunks of 2048 instances (32 KB as
// float4), and every thread sweeps each chunk in order, reading the same
// entry as every other thread of the warp (a shared-memory broadcast). The
// sweep keeps the FIRST strict minimum in id order, the tie rule of the TPU
// kernel's `t < tmin` loop. It is not the TPU kernel's shape (a whole frame
// in VMEM, one SMEM scalar load per instance); the TPU design's scalar loop
// has no counterpart here.
//
// With -fmad=false the expressions round exactly where the plain torch
// version (`sphere_raster_untiled_plain`) does, so the two agree bit for bit.

#include <cuda_runtime.h>

#include <math_constants.h>

#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 2048;

__global__ void __launch_bounds__(kThreads)
    sphere_raster_untiled_kernel(const float* __restrict__ znear_p,
                                 const float* __restrict__ ocb,
                                 const float* __restrict__ dirs,
                                 float* __restrict__ tmin_out,
                                 int* __restrict__ inst_out, int n,
                                 int64_t hw) {
  __shared__ float4 s_oc[kChunk];

  const int64_t pix = static_cast<int64_t>(blockIdx.x) * kThreads +
                      threadIdx.x;
  const bool live = pix < hw;
  const float znear = *znear_p;
  float dx = 0.0f, dy = 0.0f, dz = 0.0f;
  if (live) {
    dx = dirs[pix];
    dy = dirs[hw + pix];
    dz = dirs[2 * hw + pix];
  }
  float tmin = CUDART_INF_F;
  int inst = -1;

  for (int base = 0; base < n; base += kChunk) {
    const int m = min(kChunk, n - base);
    for (int j = threadIdx.x; j < m; j += kThreads) {
      const int k = base + j;
      s_oc[j] = make_float4(ocb[k], ocb[n + k], ocb[2 * n + k],
                            ocb[3 * n + k]);
    }
    __syncthreads();
    if (live) {
      for (int j = 0; j < m; ++j) {
        const float4 o = s_oc[j];
        const float b = dx * o.x + dy * o.y + dz * o.z;
        const float disc = b * b - o.w;
        const float t = b - sqrtf(fmaxf(disc, 0.0f));
        if (disc > 0.0f && t > znear && t < tmin) {
          tmin = t;
          inst = base + j;
        }
      }
    }
    __syncthreads();
  }
  if (live) {
    tmin_out[pix] = tmin;
    inst_out[pix] = inst;
  }
}

}  // namespace

// ocb f32 [4, n] (eye-relative centre xyz, |oc|^2 - r^2, in instance
// order); dirs f32 [3, h, w] normalized rays; znear f32 [1] on the device.
// Outputs tmin f32 [h, w] and inst i32 [h, w] (original id, -1 on a miss).
extern "C" int wpe_sphere_raster_untiled(const float* znear, const float* ocb,
                                         const float* dirs, float* tmin_out,
                                         int* inst_out, int n, int h, int w,
                                         void* stream) {
  const int64_t hw = static_cast<int64_t>(h) * w;
  const int64_t blocks = (hw + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffff) return cudaErrorInvalidConfiguration;
  sphere_raster_untiled_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                                 static_cast<cudaStream_t>(stream)>>>(
      znear, ocb, dirs, tmin_out, inst_out, n, hw);
  return static_cast<int>(cudaGetLastError());
}
