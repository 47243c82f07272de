// One granular substep on sorted state for Hopper (sm_90a): K10.
//
// Replaces: wgpu_physics_engine_tpu/ops/granular_pallas.py, `_kernel`
// (:684, reached through `substep_sorted` :1072 -> `pl.pallas_call` :1120)
// with each of its pair phases: `_pair_force_phase_civ` (:546, full or
// thin cid-interval validity), `_pair_force_phase` (:294, window ranges)
// and `_pair_force_phase_pipelined` (:399, the same with cross-block DMA
// prefetch, which changes no bit). Per sorted particle: the penalty pair
// force over the frozen candidate set (touching = valid & d2 < md^2 &
// d2 > 1e-12, w = k * (md / sqrt(d2) - 1), sums of w * d), gravity on y,
// semi-implicit Euler, then the wall clamp and reflect with restitution
// per axis: the op order of models/granular._frozen_substep. Out of place,
// so neighbours read the old positions.
//
// The candidate set binds, slab truncation included. The TPU kernel sees
// a window's slots only inside its block's slab A [offa, offa + slab) or,
// when offb > offa, inside slab B from max(offb, offa + slab) to
// offb + slab; this kernel applies the same two interval tests, so it
// matches the JAX package even when the rebuild reports dropped entries.
// A window is [cell_start[clip(cid + lo_g)], cell_start[clip(cid + hi_g +
// 1)]) in CIV mode (the slots whose cid difference lies in the group's
// interval), or read from a [2, n, ng] table in window mode.
//
// What bounds it on the H100: per candidate slot 10 flops (difference 3,
// d2 5, two tests) and a position read from shared memory; per touching
// pair 11 more (sqrt and divide, weight 3, sums 6); per particle 52 bytes
// of state in and out. At the default pile (1M particles, 9 groups, ~52
// candidates a particle) both bounds are tens of microseconds; the loop
// over candidates, not HBM, sets the time.
//
// Design: one CTA per block of `block` sorted slots (the rebuild's block),
// one thread per slot. Sorted order keeps a block's windows inside its two
// slabs, so for each group the CTA stages slab A (and slab B when the
// block needs it, a CTA-uniform test) in shared memory with coalesced
// loads, and each thread walks its own window's part of it. Sums follow
// K10's order: each group's A sum added to the A total, each group's B sum
// to the B total, then A + B, then gravity. A group's sum is accumulated in
// double and rounded once (in a dense pile the float sums of kernel and
// plain version, taken in different orders, drift apart by 1e-4 in
// velocity over a 16-substep block); built with -fmad=false and IEEE sqrt
// and divide, so the kernel equals its plain version but for rounding ties.

#include <cuda_runtime.h>

#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kMaxGroups = 9;

struct Groups {
  int lo[kMaxGroups];
  int hi[kMaxGroups];
};

__device__ __forceinline__ int clampi(int x, int lo, int hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

// Cooperative copy of slots [o, o + slab) of the three position planes
// into shared memory (slots past n are left unset: no window reaches them).
__device__ __forceinline__ void stage(const float* __restrict__ pos,
                                      int64_t n, int o, int slab, float* sx,
                                      float* sy, float* sz) {
  for (int k = threadIdx.x; k < slab; k += blockDim.x) {
    const int64_t j = static_cast<int64_t>(o) + k;
    if (j < n) {
      sx[k] = pos[j];
      sy[k] = pos[n + j];
      sz[k] = pos[2 * n + j];
    }
  }
}

// Pair-force sums of slots [lo, hi) (inside the staged slab starting at o)
// on particle i at (px, py, pz). Each term w * d is rounded to float as in
// the plain version; the group's sum is taken in double and rounded once,
// so it does not depend on the order of the terms (the plain version sums
// a gathered row in another order) except at a rounding tie.
__device__ __forceinline__ void pair_sums(int i, float px, float py, float pz,
                                          int lo, int hi, int o,
                                          const float* sx, const float* sy,
                                          const float* sz, float md, float md2,
                                          float kc, float& fx, float& fy,
                                          float& fz) {
  double gx = 0.0, gy = 0.0, gz = 0.0;
  for (int j = lo; j < hi; ++j) {
    if (j == i) continue;
    const float dx = px - sx[j - o];
    const float dy = py - sy[j - o];
    const float dz = pz - sz[j - o];
    const float d2 = dx * dx + dy * dy + dz * dz;
    if (d2 < md2 && d2 > 1e-12f) {
      const float inv = 1.0f / sqrtf(d2);
      const float w = kc * (md * inv - 1.0f);
      gx += static_cast<double>(w * dx);
      gy += static_cast<double>(w * dy);
      gz += static_cast<double>(w * dz);
    }
  }
  fx = static_cast<float>(gx);
  fy = static_cast<float>(gy);
  fz = static_cast<float>(gz);
}

__device__ __forceinline__ void wall(float& p, float& v, float lim, float e) {
  const bool hit = (p < -lim && v < 0.0f) || (p > lim && v > 0.0f);
  p = fminf(fmaxf(p, -lim), lim);
  if (hit) v = -e * v;
}

__global__ void granular_step_kernel(
    const float* __restrict__ prm, const float* __restrict__ pos,
    const float* __restrict__ vel, const int* __restrict__ cid,
    const int* __restrict__ cell_start, const int* __restrict__ wins,
    const int* __restrict__ off, float* __restrict__ pos_out,
    float* __restrict__ vel_out, Groups grp, int n_, int ng, int slab,
    int ncells) {
  extern __shared__ float s_slab[];
  float* sx = s_slab;
  float* sy = s_slab + slab;
  float* sz = s_slab + 2 * slab;

  const int64_t n = n_;
  const int b = blockIdx.x;
  const int i = b * blockDim.x + threadIdx.x;
  const bool live = i < n;
  const float md = prm[0], kc = prm[1], grav = prm[2], dt = prm[3];
  const float e = prm[4], lim = prm[5];
  const float md2 = md * md;

  float px = 0.0f, py = 0.0f, pz = 0.0f;
  int ci = 0;
  if (live) {
    px = pos[i];
    py = pos[n + i];
    pz = pos[2 * n + i];
    if (wins == nullptr) ci = cid[i];
  }
  float ax = 0.0f, ay = 0.0f, az = 0.0f;   // slab A sums, group by group
  float bx = 0.0f, by = 0.0f, bz = 0.0f;   // slab B sums
  for (int g = 0; g < ng; ++g) {
    int s = 0, t = 0;
    if (live) {
      if (wins != nullptr) {
        s = wins[static_cast<int64_t>(i) * ng + g];
        t = wins[(n + i) * ng + g];
      } else {
        s = cell_start[clampi(ci + grp.lo[g], 0, ncells)];
        t = cell_start[clampi(ci + grp.hi[g] + 1, 0, ncells)];
      }
    }
    const int oa = off[(static_cast<int64_t>(b) * ng + g) * 2];
    const int ob = off[(static_cast<int64_t>(b) * ng + g) * 2 + 1];
    float gx, gy, gz;
    stage(pos, n, oa, slab, sx, sy, sz);
    __syncthreads();
    if (live) {
      pair_sums(i, px, py, pz, max(s, oa), min(t, oa + slab), oa, sx, sy, sz,
                md, md2, kc, gx, gy, gz);
      ax += gx;
      ay += gy;
      az += gz;
    }
    __syncthreads();
    if (ob > oa) {                 // the same for every thread of the CTA
      stage(pos, n, ob, slab, sx, sy, sz);
      __syncthreads();
      if (live) {
        pair_sums(i, px, py, pz, max(s, max(ob, oa + slab)),
                  min(t, ob + slab), ob, sx, sy, sz, md, md2, kc, gx, gy, gz);
        bx += gx;
        by += gy;
        bz += gz;
      }
      __syncthreads();
    }
  }
  if (!live) return;

  const float fx = ax + bx;
  const float fy = (ay + by) + grav;                 // unit mass
  const float fz = az + bz;
  float vx = vel[i] + fx * dt;
  float vy = vel[n + i] + fy * dt;
  float vz = vel[2 * n + i] + fz * dt;
  float nx = px + vx * dt;
  float ny = py + vy * dt;
  float nz = pz + vz * dt;
  wall(nx, vx, lim, e);
  wall(ny, vy, lim, e);
  wall(nz, vz, lim, e);
  pos_out[i] = nx;
  pos_out[n + i] = ny;
  pos_out[2 * n + i] = nz;
  vel_out[i] = vx;
  vel_out[n + i] = vy;
  vel_out[2 * n + i] = vz;
}

}  // namespace

// One substep. prm f32[6] on the device (min_dist, k_contact, gravity, dt,
// restitution, wall limit); pos, vel f32 [3, n] sorted; off i32 [nb, ng, 2]
// slab offsets (offa, offb) per block of `block` slots, nb * block >= n.
// Window mode: wins i32 [2, n, ng] (starts, ends), cid and cell_start null.
// CIV mode: wins null, cid i32 [n] sorted cell ids, cell_start i32
// [ncells + 3], bounds (host) i32 [2 * ng] (lo_g..., hi_g...). Outputs
// pos_out, vel_out f32 [3, n].
extern "C" int wpe_granular_step(const float* prm, const float* pos,
                                 const float* vel, const int* cid,
                                 const int* cell_start, const int* wins,
                                 const int* off, float* pos_out,
                                 float* vel_out, const int* bounds, int n,
                                 int ng, int block, int slab, int ncells,
                                 void* stream) {
  if (ng < 1 || ng > kMaxGroups || block < 1 || block > 1024 || slab < 1 ||
      n < 0)
    return cudaErrorInvalidValue;
  if (wins == nullptr && (cid == nullptr || cell_start == nullptr))
    return cudaErrorInvalidValue;
  if (n == 0) return cudaSuccess;
  Groups grp{};
  if (wins == nullptr) {
    for (int g = 0; g < ng; ++g) {
      grp.lo[g] = bounds[g];
      grp.hi[g] = bounds[ng + g];
    }
  }
  const size_t smem = 3 * static_cast<size_t>(slab) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        granular_step_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int blocks = (n + block - 1) / block;
  granular_step_kernel<<<blocks, block, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      prm, pos, vel, cid, cell_start, wins, off, pos_out, vel_out, grp, n, ng,
      slab, ncells);
  return static_cast<int>(cudaGetLastError());
}
