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
// What bounds it on the H100: the work any implementation must do is b
// and the discriminant for every (pixel, instance) pair, 7 fp32 operations
// (b 5, disc 2), and the square root, t and the two compares only for the
// pairs with disc > 0 (chip_smoke.py counts those from the data). At
// 16,384 instances on 600x800 that is 5.5e10 operations, ~0.82 ms at the
// card's 67 TFLOP/s fp32, plus the few pairs that meet their sphere's
// silhouette: bound by operations. At 10 instances the bytes bound it: the
// rays in and two planes out, ~9.6 MB.
//
// Design: four consecutive pixels a thread, 256 threads a CTA. The rays
// are read and the results written with 16-byte accesses where the planes
// allow it (hw a multiple of 4 and every plane 16-byte aligned); else the
// same thread reads and writes its four pixels one by one (a scalar tail
// inside the kernel, never another route). The CTA stages the
// eye-relative table ocb [4, n] (centre xyz, |oc|^2 - r^2, computed once by
// the wrapper) through shared memory in chunks of 2048 instances (32 KB as
// float4), and every thread sweeps each chunk in order: one shared-memory
// broadcast of an instance feeds four pairs. A pair computes b and the
// discriminant, and the square root, t and the compares only under disc >
// 0, behind one branch an instance for the thread's four pairs (the sweep
// unrolled by two instances): the plain version's hit test needs disc >
// 0, and there fmaxf(disc, 0) is disc, so the result is the same bits,
// NaN inputs included. Measured on the H100 at 16,384 instances
// (tools/kernel_ab.py, ten pairs in turns, PERF.md §6): 3.07 ms against
// 9.24 for one pixel a thread; a branch a pair and eight pixels a thread
// measured slower. The sweep keeps the FIRST strict minimum in id order,
// the tie rule of the TPU kernel's `t < tmin` loop. It is not the TPU kernel's shape (a whole frame
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
constexpr int kPix = 4;  // pixels a thread: one float4 of each plane
constexpr int kChunk = 2048;

inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

__global__ void __launch_bounds__(kThreads)
    sphere_raster_untiled_kernel(const float* __restrict__ znear_p,
                                 const float* __restrict__ ocb,
                                 const float* __restrict__ dirs,
                                 float* __restrict__ tmin_out,
                                 int* __restrict__ inst_out, int n,
                                 int64_t hw, bool vec) {
  __shared__ float4 s_oc[kChunk];

  const int64_t pix0 =
      (static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x) * kPix;
  const bool live = pix0 < hw;
  const float znear = *znear_p;
  float dx[kPix] = {}, dy[kPix] = {}, dz[kPix] = {};
  if (live && vec) {
    const float4 x = *reinterpret_cast<const float4*>(dirs + pix0);
    const float4 y = *reinterpret_cast<const float4*>(dirs + hw + pix0);
    const float4 z = *reinterpret_cast<const float4*>(dirs + 2 * hw + pix0);
    dx[0] = x.x, dx[1] = x.y, dx[2] = x.z, dx[3] = x.w;
    dy[0] = y.x, dy[1] = y.y, dy[2] = y.z, dy[3] = y.w;
    dz[0] = z.x, dz[1] = z.y, dz[2] = z.z, dz[3] = z.w;
  } else if (live) {
#pragma unroll
    for (int k = 0; k < kPix; ++k) {
      if (pix0 + k < hw) {
        dx[k] = dirs[pix0 + k];
        dy[k] = dirs[hw + pix0 + k];
        dz[k] = dirs[2 * hw + pix0 + k];
      }
    }
  }
  float tmin[kPix];
  int inst[kPix];
#pragma unroll
  for (int k = 0; k < kPix; ++k) {
    tmin[k] = CUDART_INF_F;
    inst[k] = -1;
  }

  for (int base = 0; base < n; base += kChunk) {
    const int m = min(kChunk, n - base);
    for (int j = threadIdx.x; j < m; j += kThreads) {
      const int k = base + j;
      s_oc[j] = make_float4(ocb[k], ocb[n + k], ocb[2 * n + k],
                            ocb[3 * n + k]);
    }
    __syncthreads();
    if (live) {
      // a pair takes the square root, t and the compares only where its
      // disc > 0, behind one branch an instance for the four pixels
#pragma unroll 2
      for (int j = 0; j < m; ++j) {
        const float4 o = s_oc[j];
        float b[kPix], disc[kPix];
        bool any = false;
#pragma unroll
        for (int k = 0; k < kPix; ++k) {
          b[k] = dx[k] * o.x + dy[k] * o.y + dz[k] * o.z;
          disc[k] = b[k] * b[k] - o.w;
          any |= disc[k] > 0.0f;
        }
        if (any) {
#pragma unroll
          for (int k = 0; k < kPix; ++k) {
            if (disc[k] > 0.0f) {
              const float t = b[k] - sqrtf(disc[k]);
              if (t > znear && t < tmin[k]) {
                tmin[k] = t;
                inst[k] = base + j;
              }
            }
          }
        }
      }
    }
    __syncthreads();
  }
  if (live && vec) {
    *reinterpret_cast<float4*>(tmin_out + pix0) =
        make_float4(tmin[0], tmin[1], tmin[2], tmin[3]);
    *reinterpret_cast<int4*>(inst_out + pix0) =
        make_int4(inst[0], inst[1], inst[2], inst[3]);
  } else if (live) {
#pragma unroll
    for (int k = 0; k < kPix; ++k) {
      if (pix0 + k < hw) {
        tmin_out[pix0 + k] = tmin[k];
        inst_out[pix0 + k] = inst[k];
      }
    }
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
  const int64_t per_cta = static_cast<int64_t>(kThreads) * kPix;
  const int64_t blocks = (hw + per_cta - 1) / per_cta;
  if (blocks > 0x7fffffff) return cudaErrorInvalidConfiguration;
  // 16-byte accesses where every plane allows them
  const bool vec = hw % kPix == 0 && aligned16(dirs) && aligned16(tmin_out) &&
                   aligned16(inst_out);
  sphere_raster_untiled_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                                 static_cast<cudaStream_t>(stream)>>>(
      znear, ocb, dirs, tmin_out, inst_out, n, hw, vec);
  return static_cast<int>(cudaGetLastError());
}
