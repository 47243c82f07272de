// Granular contact on sorted state for Hopper (sm_90a): the substep (K10),
// the pair forces alone (K11) and the forces with their directional
// derivative (K12), three entry points on one slab walk.
//
// Replaces: wgpu_physics_engine_tpu/ops/granular_pallas.py
//   * `_kernel` (K10, :684, reached through `substep_sorted` :1072 ->
//     `pl.pallas_call` :1120) with `wpe_granular_step`, with each of its
//     pair phases: `_pair_force_phase_civ` (:546, full or thin cid-interval
//     validity), `_pair_force_phase` (:294, window ranges) and
//     `_pair_force_phase_pipelined` (:399, the same with cross-block DMA
//     prefetch, which changes no bit). Per sorted particle: the penalty
//     pair force over the frozen candidate set (touching = valid & d2 <
//     md^2 & d2 > 1e-12, w = k * (md / sqrt(d2) - 1), sums of w * d),
//     gravity on y, semi-implicit Euler, then the wall clamp and reflect
//     with restitution per axis: the op order of
//     models/granular._frozen_substep. The same entry point with a
//     `base` and a local count `n_local` is K10b, the slot offset that
//     `_pair_force_phase_civ` (:593-599) reads from params[6] (`_kernel`
//     :707-715): one launch steps the sorted slots [base, base + n_local)
//     of the full array, the shard body of parallel/granular_mesh.py. JAX
//     carries `base` in an f32 slot (n_pad < 2^24); here it is an int;
//   * `_forces_kernel` (K11, :750, through `contact_forces_sorted` :796 ->
//     :844) with `wpe_granular_forces`: the same pair force, written out
//     (the differentiable granular path and cloth self-collision integrate
//     it themselves). It runs the device code of K10's force, so K11 and
//     the plain integrate equal one K10 substep bit for bit;
//   * `_jvp_kernel` (K12, :1000, pair phase `_pair_jvp_phase_civ` :862,
//     through `contact_force_jvp_sorted` :1018 -> :1055) with
//     `wpe_granular_force_jvp`: (f(p), J.u) for a tangent field u. The TPU
//     kernel takes the tangent from jax.jvp of the masked pair expressions;
//     here it is written by hand. With d = p_i - p_j, inv = 1/sqrt(d2),
//     w = k (md inv - 1) and du = u_i - u_j, a touching pair adds
//     w du - g d with g = k md inv^3 (d . du); the tests and `valid` are
//     constants, as in JAX. The pair force is the negative gradient of a
//     pair potential and the candidate relation is symmetric, so J is
//     symmetric and the backward passes apply this with u = fbar. Its
//     pair phase also reads a `base` (:864, :922) that no caller passes,
//     so K12 (and K11) keep none.
// Outputs are out of place, so neighbours read the old positions.
//
// The candidate set binds, slab truncation included. The TPU kernel sees
// a window's slots only inside its block's slab A [offa, offa + slab) or,
// when offb > offa, inside slab B from max(offb, offa + slab) to
// offb + slab; these kernels apply the same two interval tests, so they
// match the JAX package even when the rebuild reports dropped entries.
// A window is [cell_start[clip(cid + lo_g)], cell_start[clip(cid + hi_g +
// 1)]) in CIV mode (the slots whose cid difference lies in the group's
// interval), or read from a [2, n, ng] table in window mode.
//
// What bounds them on the H100: per candidate slot 10 flops (difference 3,
// d2 5, two tests) and a position read from shared memory; per touching
// pair 11 more (sqrt and divide, weight 3, sums 6), and for K12 another 25
// (tangent difference 3, d . du 5, g 5, w du - g d 9, sums 3); per
// particle 52 bytes of state in and out for K10, 28 (with the cid) for
// K11, 52 for K12. At the default pile (1M particles, 9 groups, ~52
// candidates a particle) the bounds are tens of microseconds; the loop over
// candidates, not HBM, sets the time.
//
// Design: one CTA per block of `block` sorted slots (the rebuild's block),
// one thread per slot. Sorted order keeps a block's windows inside its two
// slabs, so for each group the CTA stages slab A (and slab B when the
// block needs it, a CTA-uniform test) in shared memory with coalesced
// loads (positions, and for K12 the tangents beside them), and each thread
// walks its own window's part of it. Sums follow K10's order: each group's
// A sum added to the A total, each group's B sum to the B total, then
// A + B. A group's sum is accumulated in double and rounded once (in a
// dense pile the float sums of kernel and plain version, taken in
// different orders, drift apart by 1e-4 in velocity over a 16-substep
// block); built with -fmad=false and IEEE sqrt and divide, so each kernel
// equals its plain version but for rounding ties.

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

// Cooperative copy of slots [o, o + slab) of the three planes of `src`
// into the shared planes sx, sy, sz (slots past n are left unset: no window
// reaches them); with JVP also the tangent planes of `tan` into tx, ty, tz.
template <bool JVP>
__device__ __forceinline__ void stage(const float* __restrict__ src,
                                      const float* __restrict__ tan,
                                      int64_t n, int o, int slab, float* sx,
                                      float* sy, float* sz, float* tx,
                                      float* ty, float* tz) {
  for (int k = threadIdx.x; k < slab; k += blockDim.x) {
    const int64_t j = static_cast<int64_t>(o) + k;
    if (j < n) {
      sx[k] = src[j];
      sy[k] = src[n + j];
      sz[k] = src[2 * n + j];
      if (JVP) {
        tx[k] = tan[j];
        ty[k] = tan[n + j];
        tz[k] = tan[2 * n + j];
      }
    }
  }
}

// Pair-force sums f (and with JVP the tangent sums t) of slots [lo, hi)
// (inside the staged slab starting at o) on particle i at p with tangent u.
// Each term is rounded to float as in the plain version; the group's sum is
// taken in double and rounded once, so it does not depend on the order of
// the terms (the plain version sums a gathered row in another order) except
// at a rounding tie.
template <bool JVP>
__device__ __forceinline__ void pair_sums(
    int i, float px, float py, float pz, float ux, float uy, float uz, int lo,
    int hi, int o, const float* sx, const float* sy, const float* sz,
    const float* tx, const float* ty, const float* tz, float md, float md2,
    float kc, float f[3], float t[3]) {
  double g0 = 0.0, g1 = 0.0, g2 = 0.0;
  double h0 = 0.0, h1 = 0.0, h2 = 0.0;
  for (int j = lo; j < hi; ++j) {
    if (j == i) continue;
    const float dx = px - sx[j - o];
    const float dy = py - sy[j - o];
    const float dz = pz - sz[j - o];
    const float d2 = dx * dx + dy * dy + dz * dz;
    if (d2 < md2 && d2 > 1e-12f) {
      const float inv = 1.0f / sqrtf(d2);
      const float w = kc * (md * inv - 1.0f);
      g0 += static_cast<double>(w * dx);
      g1 += static_cast<double>(w * dy);
      g2 += static_cast<double>(w * dz);
      if (JVP) {
        const float dux = ux - tx[j - o];
        const float duy = uy - ty[j - o];
        const float duz = uz - tz[j - o];
        const float dot = dx * dux + dy * duy + dz * duz;
        const float g = kc * md * inv * inv * inv * dot;
        h0 += static_cast<double>(w * dux - g * dx);
        h1 += static_cast<double>(w * duy - g * dy);
        h2 += static_cast<double>(w * duz - g * dz);
      }
    }
  }
  f[0] = static_cast<float>(g0);
  f[1] = static_cast<float>(g1);
  f[2] = static_cast<float>(g2);
  if (JVP) {
    t[0] = static_cast<float>(h0);
    t[1] = static_cast<float>(h1);
    t[2] = static_cast<float>(h2);
  }
}

// The pair force on sorted particle i of CTA b (and with JVP its
// directional derivative along its tangent u): the walk over the CTA's
// slabs, group by group. Every thread of the CTA calls it (it stages and
// synchronizes); `live` marks the threads that own a particle. The
// candidate set: windows from the table `wins` or, when it is null, from
// `cid`, `cell_start` and the groups' cid intervals `grp`; `off` the
// per-block slab offsets (offa, offb). `s` is the dynamic shared memory,
// 3 (JVP: 6) planes of `slab` floats.
template <bool JVP>
__device__ __forceinline__ void contact_force(
    const float* __restrict__ pos, const float* __restrict__ tan,
    const int* __restrict__ cid, const int* __restrict__ cell_start,
    const int* __restrict__ wins, const int* __restrict__ off,
    const Groups& grp, int64_t n, int ng, int slab, int ncells, int b, int i,
    bool live, const float p[3], const float u[3], float md, float kc,
    float* s, float f[3], float t[3]) {
  float* sx = s;
  float* sy = s + slab;
  float* sz = s + 2 * slab;
  float* tx = s + 3 * slab;
  float* ty = s + 4 * slab;
  float* tz = s + 5 * slab;
  const float md2 = md * md;
  int ci = 0;
  if (live && wins == nullptr) ci = cid[i];
  float a[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};   // slab A sums (f, t)
  float bb[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};  // slab B sums
  float gf[3], gt[3];
  for (int g = 0; g < ng; ++g) {
    int ws = 0, we = 0;
    if (live) {
      if (wins != nullptr) {
        ws = wins[static_cast<int64_t>(i) * ng + g];
        we = wins[(n + i) * ng + g];
      } else {
        ws = cell_start[clampi(ci + grp.lo[g], 0, ncells)];
        we = cell_start[clampi(ci + grp.hi[g] + 1, 0, ncells)];
      }
    }
    const int oa = off[(static_cast<int64_t>(b) * ng + g) * 2];
    const int ob = off[(static_cast<int64_t>(b) * ng + g) * 2 + 1];
    stage<JVP>(pos, tan, n, oa, slab, sx, sy, sz, tx, ty, tz);
    __syncthreads();
    if (live) {
      pair_sums<JVP>(i, p[0], p[1], p[2], u[0], u[1], u[2], max(ws, oa),
                     min(we, oa + slab), oa, sx, sy, sz, tx, ty, tz, md, md2,
                     kc, gf, gt);
      a[0] += gf[0];
      a[1] += gf[1];
      a[2] += gf[2];
      if (JVP) {
        a[3] += gt[0];
        a[4] += gt[1];
        a[5] += gt[2];
      }
    }
    __syncthreads();
    if (ob > oa) {                 // the same for every thread of the CTA
      stage<JVP>(pos, tan, n, ob, slab, sx, sy, sz, tx, ty, tz);
      __syncthreads();
      if (live) {
        pair_sums<JVP>(i, p[0], p[1], p[2], u[0], u[1], u[2],
                       max(ws, max(ob, oa + slab)), min(we, ob + slab), ob,
                       sx, sy, sz, tx, ty, tz, md, md2, kc, gf, gt);
        bb[0] += gf[0];
        bb[1] += gf[1];
        bb[2] += gf[2];
        if (JVP) {
          bb[3] += gt[0];
          bb[4] += gt[1];
          bb[5] += gt[2];
        }
      }
      __syncthreads();
    }
  }
  f[0] = a[0] + bb[0];
  f[1] = a[1] + bb[1];
  f[2] = a[2] + bb[2];
  if (JVP) {
    t[0] = a[3] + bb[3];
    t[1] = a[4] + bb[4];
    t[2] = a[5] + bb[5];
  }
}

__device__ __forceinline__ void wall(float& p, float& v, float lim, float e) {
  const bool hit = (p < -lim && v < 0.0f) || (p > lim && v > 0.0f);
  p = fminf(fmaxf(p, -lim), lim);
  if (hit) v = -e * v;
}

__device__ __forceinline__ void load3(const float* __restrict__ a, int64_t n,
                                      int i, float v[3]) {
  v[0] = a[i];
  v[1] = a[n + i];
  v[2] = a[2 * n + i];
}

// Thread t of the launch steps global sorted slot i = base + t (base a
// multiple of the block, so CTA blockIdx.x is global block base / block +
// blockIdx.x): its own position and the slabs come from the full array pos
// [3, n], its velocity from the local vel [3, n_local] and its outputs go
// to the local pos_out, vel_out [3, n_local]; self-exclusion compares
// global slots. base = 0, n_local = n is K10 as it always was.
__global__ void granular_step_kernel(
    const float* __restrict__ prm, const float* __restrict__ pos,
    const float* __restrict__ vel, const int* __restrict__ cid,
    const int* __restrict__ cell_start, const int* __restrict__ wins,
    const int* __restrict__ off, float* __restrict__ pos_out,
    float* __restrict__ vel_out, Groups grp, int n_, int ng, int slab,
    int ncells, int base, int n_local_) {
  extern __shared__ float s_slab[];
  const int64_t n = n_;
  const int64_t nl = n_local_;
  const int b = base / static_cast<int>(blockDim.x) + blockIdx.x;
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  const int i = base + t;
  const bool live = t < nl;
  const float md = prm[0], kc = prm[1], grav = prm[2], dt = prm[3];
  const float e = prm[4], lim = prm[5];

  float p[3] = {0.0f, 0.0f, 0.0f};
  if (live) load3(pos, n, i, p);
  float f[3], u[3];
  contact_force<false>(pos, nullptr, cid, cell_start, wins, off, grp, n, ng,
                       slab, ncells, b, i, live, p, p, md, kc, s_slab, f, u);
  if (!live) return;

  const float fy = f[1] + grav;                      // unit mass
  float vx = vel[t] + f[0] * dt;
  float vy = vel[nl + t] + fy * dt;
  float vz = vel[2 * nl + t] + f[2] * dt;
  float nx = p[0] + vx * dt;
  float ny = p[1] + vy * dt;
  float nz = p[2] + vz * dt;
  wall(nx, vx, lim, e);
  wall(ny, vy, lim, e);
  wall(nz, vz, lim, e);
  pos_out[t] = nx;
  pos_out[nl + t] = ny;
  pos_out[2 * nl + t] = nz;
  vel_out[t] = vx;
  vel_out[nl + t] = vy;
  vel_out[2 * nl + t] = vz;
}

// K11 (JVP false): out f32 [3, n]. K12 (JVP true): out f32 [6, n], f in
// rows 0-2 and J.u in rows 3-5.
template <bool JVP>
__global__ void granular_forces_kernel(
    const float* __restrict__ prm, const float* __restrict__ pos,
    const float* __restrict__ tan, const int* __restrict__ cid,
    const int* __restrict__ cell_start, const int* __restrict__ wins,
    const int* __restrict__ off, float* __restrict__ out, Groups grp, int n_,
    int ng, int slab, int ncells) {
  extern __shared__ float s_slab[];
  const int64_t n = n_;
  const int b = blockIdx.x;
  const int i = b * blockDim.x + threadIdx.x;
  const bool live = i < n;
  const float md = prm[0], kc = prm[1];
  float p[3] = {0.0f, 0.0f, 0.0f};
  float u[3] = {0.0f, 0.0f, 0.0f};
  if (live) {
    load3(pos, n, i, p);
    if (JVP) load3(tan, n, i, u);
  }
  float f[3], t[3];
  contact_force<JVP>(pos, tan, cid, cell_start, wins, off, grp, n, ng, slab,
                     ncells, b, i, live, p, u, md, kc, s_slab, f, t);
  if (!live) return;
  out[i] = f[0];
  out[n + i] = f[1];
  out[2 * n + i] = f[2];
  if (JVP) {
    out[3 * n + i] = t[0];
    out[4 * n + i] = t[1];
    out[5 * n + i] = t[2];
  }
}

// Checks the launch geometry, fills the groups' cid intervals from the host
// table `bounds` (CIV mode) and raises the dynamic shared memory limit of
// `kernel` to `planes` planes of `slab` floats; returns 0 or a cudaError_t.
template <typename Kernel>
int prepare(Kernel kernel, const int* cid, const int* cell_start,
            const int* wins, const int* bounds, int n, int ng, int block,
            int slab, int planes, Groups* grp, size_t* smem) {
  if (ng < 1 || ng > kMaxGroups || block < 1 || block > 1024 || slab < 1 ||
      n < 0)
    return cudaErrorInvalidValue;
  if (wins == nullptr && (cid == nullptr || cell_start == nullptr))
    return cudaErrorInvalidValue;
  *grp = Groups{};
  if (wins == nullptr) {
    for (int g = 0; g < ng; ++g) {
      grp->lo[g] = bounds[g];
      grp->hi[g] = bounds[ng + g];
    }
  }
  *smem = planes * static_cast<size_t>(slab) * sizeof(float);
  if (*smem <= 48 * 1024) return cudaSuccess;
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(*smem)));
}

}  // namespace

// One substep (K10) of the sorted slots [base, base + n_local) (K10b; K10
// is base 0, n_local n). prm f32[6] on the device (min_dist, k_contact,
// gravity, dt, restitution, wall limit); pos f32 [3, n] sorted, the full
// array; vel f32 [3, n_local], the slots' velocities; off i32 [nb, ng, 2]
// slab offsets (offa, offb) per block of `block` slots of the full array,
// nb * block >= n. Window mode: wins i32 [2, n, ng] (starts, ends), cid and
// cell_start null. CIV mode: wins null, cid i32 [n] sorted cell ids,
// cell_start i32 [ncells + 3], bounds (host) i32 [2 * ng] (lo_g...,
// hi_g...). base must be a multiple of block and base + n_local <= n.
// Outputs pos_out, vel_out f32 [3, n_local].
extern "C" int wpe_granular_step(const float* prm, const float* pos,
                                 const float* vel, const int* cid,
                                 const int* cell_start, const int* wins,
                                 const int* off, float* pos_out,
                                 float* vel_out, const int* bounds, int n,
                                 int ng, int block, int slab, int ncells,
                                 int base, int n_local, void* stream) {
  Groups grp;
  size_t smem;
  const int err = prepare(granular_step_kernel, cid, cell_start, wins,
                          bounds, n, ng, block, slab, 3, &grp, &smem);
  if (err != cudaSuccess) return err;
  if (base < 0 || n_local < 0 || base % block != 0 ||
      static_cast<int64_t>(base) + n_local > n)
    return cudaErrorInvalidValue;
  if (n_local == 0) return cudaSuccess;
  granular_step_kernel<<<(n_local + block - 1) / block, block, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      prm, pos, vel, cid, cell_start, wins, off, pos_out, vel_out, grp, n, ng,
      slab, ncells, base, n_local);
  return static_cast<int>(cudaGetLastError());
}

// The pair forces alone (K11): prm f32[2] on the device (min_dist,
// k_contact); pos f32 [3, n] sorted; the candidate set as for
// wpe_granular_step. Output f_out f32 [3, n].
extern "C" int wpe_granular_forces(const float* prm, const float* pos,
                                   const int* cid, const int* cell_start,
                                   const int* wins, const int* off,
                                   float* f_out, const int* bounds, int n,
                                   int ng, int block, int slab, int ncells,
                                   void* stream) {
  Groups grp;
  size_t smem;
  const int err = prepare(granular_forces_kernel<false>, cid, cell_start,
                          wins, bounds, n, ng, block, slab, 3, &grp, &smem);
  if (err != cudaSuccess || n == 0) return err;
  granular_forces_kernel<false><<<(n + block - 1) / block, block, smem,
                                  static_cast<cudaStream_t>(stream)>>>(
      prm, pos, nullptr, cid, cell_start, wins, off, f_out, grp, n, ng, slab,
      ncells);
  return static_cast<int>(cudaGetLastError());
}

// The pair forces and their directional derivative (K12): as
// wpe_granular_forces, with the tangent field u f32 [3, n] in the same
// sorted order; output ft_out f32 [6, n] (f, then J.u).
extern "C" int wpe_granular_force_jvp(const float* prm, const float* pos,
                                      const float* u, const int* cid,
                                      const int* cell_start, const int* wins,
                                      const int* off, float* ft_out,
                                      const int* bounds, int n, int ng,
                                      int block, int slab, int ncells,
                                      void* stream) {
  Groups grp;
  size_t smem;
  const int err = prepare(granular_forces_kernel<true>, cid, cell_start,
                          wins, bounds, n, ng, block, slab, 6, &grp, &smem);
  if (err != cudaSuccess || n == 0) return err;
  granular_forces_kernel<true><<<(n + block - 1) / block, block, smem,
                                 static_cast<cudaStream_t>(stream)>>>(
      prm, pos, u, cid, cell_start, wins, off, ft_out, grp, n, ng, slab,
      ncells);
  return static_cast<int>(cudaGetLastError());
}
