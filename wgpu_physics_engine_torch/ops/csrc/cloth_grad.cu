// The adjoint of one exact cloth substep for Hopper (sm_90a), walked in
// reverse over a trajectory: the backward pass of
// ops/cloth_grad_kernel.py (`_Segment`, `multi_step_diff`).
//
// Replaces: wgpu_physics_engine_tpu/ops/cloth_pallas_grad.py
//   * `_bwd_kernel` (K7), the whole-plane reverse-walk transpose;
//   * `_bwd_kernel_banded` (K8), the same in 8-row-halo bands;
//   * `_bwd_kernel_stream` (K9), the same with the primal band DMA'd from
//     HBM.
// The three were VMEM tiers of one function; here one kernel takes any
// grid. (The trace kernels of K7 and K9 are K1 itself: `wpe_cloth_trace`
// in cloth_step.cu.) Its WINDOW instantiation, `wpe_cloth_substep_vjp_window`,
// walks a batch of row windows of a larger grid of one shape with K1w's
// global-row spring masks, each window with its own first row and pins,
// one launch a substep for the batch (blockIdx.z the window) and one
// reduction for the call: the backward of the rows-sharded path
// (parallel/mesh.py under autograd), which gives it every window one
// device holds in an exchange block. The JAX package takes this gradient
// by XLA autodiff of the window stencil (`cloth_pallas.py`
// `multi_step_window` :763 in the forward), a window at a time.
//
// The TPU kernels build each substep's transpose with jax.vjp of the
// forward's pure functions. Here the adjoint is written by hand, op for op
// the same as the plain version `_substep_vjp_planes` in
// ops/cloth_grad_kernel.py, which the CPU tests hold against torch.autograd
// and jax.grad. Per substep s, from the state traj[s] entering it and the
// cotangent `ct` (6 planes) of its output, one launch: a CTA takes a core
// of kTileH x kTileW particles (compile-time constants) and
//   0. copies the state over the core grown by 4 into shared memory with
//      cp.async (zeros beyond the grid): the spring adjoint at a core cell
//      needs the force cotangent `ctf` of its neighbours within 2, and each
//      of those needs the spring force, which reaches 2 further;
//   1. computes each spring force that touches the core grown by 2 once
//      (`cloth::edge`, K1's function, an anchor's six families at a time,
//      into shared memory), then for each cell of the core grown by 2 sums
//      them in K1's order and runs the integration adjoint
//      (`integrate_vjp`) on the incoming cotangent, read from device
//      memory: ctf stays in shared memory, the integration's part of the
//      state cotangent is kept for the core;
//   2. computes each spring adjoint that touches the core once (`edge_vjp`
//      on both ends' state and ctf, an anchor's six at a time, into shared
//      memory), then for each core cell adds them to its state cotangent in
//      `_substep_vjp_planes`' order, family by family, -(edge p anchors),
//      then +(edge anchored at p - d), and writes it.
// The recomputation on the core's ring of 2 is what the one launch costs.
// Only core cells count: the parameter cotangent terms (a cell's seven of
// the integration, an edge's three (k, c, rest) by its anchor) are summed
// in float64 over the CTA in a fixed order (warp shuffles, then the warps
// in order) into one row of 16 a CTA, and the pin_pos cotangent is added
// by the core cell alone. The outgoing cotangent goes to the other of two
// buffers (the incoming one is read on the ring, which other CTAs own).
// After the walk `reduce_partials` sums the [n_steps, tiles, 16] float64
// partials in a fixed order (no float atomics) and rounds once, so
// gradients are the same from run to run.
//
// What bounds it on the H100. Per particle and substep the function reads
// the trajectory state (24 B) and the incoming cotangent (24 B) and writes
// the outgoing cotangent (24 B): 72 B. At 256x256 that is 4.7 MB a substep,
// 1.4 us at 3.35 TB/s; the operations (chip_smoke.py OPS_VJP_*: ~1,000 fp32
// a particle) take ~1 us at 67 TFLOP/s, so the bound is the bytes. At 256^2
// there are only 256 tiles of 16x16, two CTAs of 256 threads an SM at ~120
// registers, so the kernel is bound by its instruction issue and latency
// at 16 warps an SM. What this design does about it: each edge force and
// adjoint is computed once; an anchor's six are one block of code, as are
// the integration adjoint's branches (selects), with the IEEE sqrt and
// reciprocal taken from their inline fast paths (`cloth::Checked`; a warp
// whose lane met an input outside them redoes the block exactly), so the
// compiler can interleave them; and the tile is a compile-time shape, so
// every neighbour is a constant offset in shared memory. Its cost is the
// halo: at 16x16 the edge forces of 22x23 anchors and the integration
// adjoint of 20x20 cells serve 256 (PERF.md).
//
// Built with -fmad=false (ops/_build.py), so every a*b + c rounds twice, as
// the plain torch version's separate ops do.
//
// The tile and the CTA size are the macros WPE_VJP_TILE_H, WPE_VJP_TILE_W
// and WPE_VJP_THREADS (default 16, 16, 256); tools/adjoint_probe.py builds
// copies of this file with other values, and with WPE_PROBE_CLOCK (each
// CTA's thread 0 stamps clock64() after each phase into `probe_clock`,
// read back by `wpe_probe_clock`) or WPE_PROBE_EMPTY (the kernel returns
// at once), to time them on the card. The library is built with none of
// them.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "cloth_substep.cuh"
#include "common.cuh"

#ifndef WPE_VJP_TILE_H
#define WPE_VJP_TILE_H 16
#endif
#ifndef WPE_VJP_TILE_W
#define WPE_VJP_TILE_W 16
#endif
#ifndef WPE_VJP_THREADS
#define WPE_VJP_THREADS 256
#endif

#ifdef WPE_PROBE_CLOCK
constexpr int kProbeTiles = 8192, kProbeMarks = 6;
__device__ long long probe_clock[kProbeTiles][kProbeMarks];
#define WPE_PROBE_MARK(n)                                               \
  if (threadIdx.x == 0)                                                 \
  probe_clock[blockIdx.y * gridDim.x + blockIdx.x][n] = clock64()
#else
#define WPE_PROBE_MARK(n)
#endif

namespace {

// The tile of a CTA (rows, columns of particles) and its threads;
// ops/cloth_grad_kernel.py TILE.
constexpr int kTileH = WPE_VJP_TILE_H, kTileW = WPE_VJP_TILE_W;
constexpr int kVjpThreads = WPE_VJP_THREADS;

using cloth::kEps;
using cloth::kNumParams;
using cloth::P6;

// The state of the cells of a tile's extent in shared memory, cell i as
// three float2: (x, y), (z, vx), (vy, vz).
struct StateTile {
  float2* s;
  __device__ __forceinline__ P6 get(int i) const {
    const float2 a = s[3 * i], b = s[3 * i + 1], c = s[3 * i + 2];
    return P6{a.x, a.y, b.x, b.y, c.x, c.y};
  }
};

// Sum each of N per-thread values over the block of NT threads in a fixed
// order (warp shuffles, then the warps in order) into out[0..N). Every
// thread of the block must call it.
template <int NT, int N>
__device__ __forceinline__ void block_sum(double (&v)[N],
                                          double* __restrict__ out) {
  __shared__ double warp_sums[NT / 32][N];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int j = 0; j < N; ++j) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      v[j] += __shfl_down_sync(0xffffffffu, v[j], off);
    }
  }
  if (lane == 0) {
#pragma unroll
    for (int j = 0; j < N; ++j) warp_sums[warp][j] = v[j];
  }
  __syncthreads();
  if (threadIdx.x < N) {
    double s = 0.0;
    for (int k = 0; k < NT / 32; ++k) s += warp_sums[k][threadIdx.x];
    out[threadIdx.x] = s;
  }
}

// The CTA of reduce_partials, and the most dynamic shared memory a CTA can
// opt in to on the H100.
constexpr int kThreads = 256;
constexpr int kMaxSmem = 232448;

// (a) The integration adjoint of one particle with state p under the
// spring force (fx, fy, fz): the integration forward again and its adjoint
// (pins, projection, Euler and damping, friction with its min, contact,
// gravity). b holds the cotangent of the substep's output on entry and the
// integration's part of the input-state cotangent on return; ctf gets the
// spring force's cotangent and g the particle's terms of the parameter
// cotangents 9..15. Names follow `_substep_vjp_planes`: f1 after contact,
// f2 after friction, h = f2/m, a = v + h dt, v1 = a damp, x1 = x + v1 dt;
// b* are cotangents. Every branch of the plain version is a select here
// (both sides computed, the one it takes kept), and M is cloth::Checked or
// cloth::Exact<false>, so that with Checked the function is one block of
// code without calls to the slow paths of sqrt and division.
template <class M>
__device__ __forceinline__ void integrate_vjp(const float* __restrict__ prm,
                                              const P6& p, float fx, float fy,
                                              float fz, bool pinned,
                                              float (&b)[6], float (&ctf)[3],
                                              float (&g)[7], const M& m) {
  // ---- forward of the integration, in the stepper's op order ----
  const float k_contact = prm[9], mu = prm[10], mass = prm[11];
  const float gravity = prm[12], damp = prm[13], min_dist = prm[14];
  const float dt = prm[15];
  fy = fy + mass * gravity;
  const float x = p.x, y = p.y, z = p.z;
  float dist, inv_d;
  m.dist_inv(x * x + y * y + z * z, dist, inv_d);
  const bool in_contact = (dist < min_dist) && (dist > kEps);
  const float nx = x * inv_d, ny = y * inv_d, nz = z * inv_d;
  const float pen = k_contact * (min_dist - dist);
  const float f1x = in_contact ? fx + pen * nx : fx;
  const float f1y = in_contact ? fy + pen * ny : fy;
  const float f1z = in_contact ? fz + pen * nz : fz;
  const float ro_n = f1x * nx + f1y * ny + f1z * nz;
  const float tx = f1x - ro_n * nx, ty = f1y - ro_n * ny,
              tz = f1z - ro_n * nz;
  float tmag, inv_t;
  m.dist_inv(tx * tx + ty * ty + tz * tz, tmag, inv_t);
  const bool fric = in_contact && (tmag > kEps);
  const float cap = mu * fabsf(ro_n);
  const float fmag = -fminf(tmag, cap);
  const float f2x = fric ? f1x + fmag * tx * inv_t : f1x;
  const float f2y = fric ? f1y + fmag * ty * inv_t : f1y;
  const float f2z = fric ? f1z + fmag * tz * inv_t : f1z;
  const float inv_m = m.recip(mass);
  const float hx = f2x * inv_m, hy = f2y * inv_m, hz = f2z * inv_m;
  const float ax = p.vx + hx * dt, ay = p.vy + hy * dt, az = p.vz + hz * dt;
  const float v1x = ax * damp, v1y = ay * damp, v1z = az * damp;
  const float x1 = x + v1x * dt, y1 = y + v1y * dt, z1 = z + v1z * dt;
  float fdist, inv_f;
  m.dist_inv(x1 * x1 + y1 * y1 + z1 * z1, fdist, inv_f);
  const bool pen2 = fdist < min_dist;
  const bool pen_safe = pen2 && (fdist > kEps);
  const bool pen_center = pen2 && !pen_safe;

  // ---- pins (the caller adds the pin_pos cotangent) ----
  const float bx = pinned ? 0.0f : b[0], by = pinned ? 0.0f : b[1],
              bz = pinned ? 0.0f : b[2];
  // ---- projection: x2 = x1 / |x1| * min_dist, v2 = 0 where inside ----
  float bvx = pinned || pen2 ? 0.0f : b[3];
  float bvy = pinned || pen2 ? 0.0f : b[4];
  float bvz = pinned || pen2 ? 0.0f : b[5];
  const float ux = x1 * inv_f, uy = y1 * inv_f, uz = z1 * inv_f;
  const float qx = bx * min_dist, qy = by * min_dist, qz = bz * min_dist;
  const float uq = ux * qx + uy * qy + uz * qz;
  float g_md = pen_safe ? bx * ux + by * uy + bz * uz
                        : (pen_center ? by : 0.0f);
  const float b1x = pen_safe ? (qx - ux * uq) * inv_f
                             : (pen_center ? 0.0f : bx);
  const float b1y = pen_safe ? (qy - uy * uq) * inv_f
                             : (pen_center ? 0.0f : by);
  const float b1z = pen_safe ? (qz - uz * uq) * inv_f
                             : (pen_center ? 0.0f : bz);

  // ---- Euler and damping ----
  bvx = bvx + b1x * dt;
  bvy = bvy + b1y * dt;
  bvz = bvz + b1z * dt;
  float g_dt = b1x * v1x + b1y * v1y + b1z * v1z;
  const float abx = bvx * damp, aby = bvy * damp, abz = bvz * damp;
  const float g_damp = bvx * ax + bvy * ay + bvz * az;
  const float hbx = abx * dt, hby = aby * dt, hbz = abz * dt;
  g_dt = g_dt + (abx * hx + aby * hy + abz * hz);
  const float fbx = hbx * inv_m, fby = hby * inv_m, fbz = hbz * inv_m;
  const float g_inv_m = hbx * f2x + hby * f2y + hbz * f2z;
  float g_mass = -(g_inv_m * inv_m * inv_m);

  // ---- friction: f2 = f1 + fmag t / |t|, fmag = -min(|t|, mu |ro_n|) ----
  const float sdot = fbx * tx + fby * ty + fbz * tz;
  const float m_b = -(sdot * inv_t);
  const float inv_t_b = fmag * sdot;
  const float half = 0.5f * m_b;
  float tmag_b = tmag < cap ? m_b : (tmag > cap ? 0.0f : half);
  const float cap_b = tmag > cap ? m_b : (tmag < cap ? 0.0f : half);
  tmag_b = tmag_b - inv_t_b * inv_t * inv_t;
  const float tbx = fbx * fmag * inv_t + tmag_b * tx * inv_t;
  const float tby = fby * fmag * inv_t + tmag_b * ty * inv_t;
  const float tbz = fbz * fmag * inv_t + tmag_b * tz * inv_t;
  const float g_mu = fric ? cap_b * fabsf(ro_n) : 0.0f;
  const float sgn = ro_n > 0.0f ? 1.0f : (ro_n < 0.0f ? -1.0f : 0.0f);
  float ro_b = cap_b * mu * sgn;
  ro_b = ro_b - (tbx * nx + tby * ny + tbz * nz);
  const float f1bx = fric ? fbx + tbx + ro_b * nx : fbx;
  const float f1by = fric ? fby + tby + ro_b * ny : fby;
  const float f1bz = fric ? fbz + tbz + ro_b * nz : fbz;
  float nbx = fric ? -(ro_n * tbx) + ro_b * f1x : 0.0f;
  float nby = fric ? -(ro_n * tby) + ro_b * f1y : 0.0f;
  float nbz = fric ? -(ro_n * tbz) + ro_b * f1z : 0.0f;

  // ---- contact: f1 = f0 + k_contact (min_dist - |x|) x / |x| ----
  const float pen_b = f1bx * nx + f1by * ny + f1bz * nz;
  nbx = nbx + pen * f1bx;
  nby = nby + pen * f1by;
  nbz = nbz + pen * f1bz;
  const float g_kc = in_contact ? pen_b * (min_dist - dist) : 0.0f;
  g_md = in_contact ? g_md + pen_b * k_contact : g_md;
  const float dist_b =
      -(pen_b * k_contact) - (nbx * x + nby * y + nbz * z) * inv_d * inv_d;
  const float cx = in_contact ? b1x + (nbx * inv_d + dist_b * nx) : b1x;
  const float cy = in_contact ? b1y + (nby * inv_d + dist_b * ny) : b1y;
  const float cz = in_contact ? b1z + (nbz * inv_d + dist_b * nz) : b1z;

  // ---- gravity; the spring force's cotangent is the contact input's ----
  g_mass = g_mass + f1by * gravity;
  const float g_grav = f1by * mass;

  b[0] = cx;
  b[1] = cy;
  b[2] = cz;
  b[3] = abx;
  b[4] = aby;
  b[5] = abz;
  ctf[0] = f1bx;
  ctf[1] = f1by;
  ctf[2] = f1bz;
  g[0] = g_kc;
  g[1] = g_mu;
  g[2] = g_mass;
  g[3] = g_grav;
  g[4] = g_damp;
  g[5] = g_md;
  g[6] = g_dt;
}

// The adjoint of the spring a -> b at the force cotangent Ē = ctf[a] -
// ctf[b]: d̄ (added to x_b, taken from x_a), Δv̄ (likewise for v), and
// the edge's cotangents of k, c and rest. Zero where dist < EPS, as the
// forward keeps no force there.
struct EdgeBar {
  float dx, dy, dz, dvx, dvy, dvz, gk, gc, grest;
};

// M is cloth::Exact<false> or cloth::Checked (cloth_substep.cuh), which
// give the same distance and reciprocal. Without a branch, so that the
// six adjoints of an anchor interleave.
template <class M>
__device__ __forceinline__ EdgeBar edge_vjp(const P6& a, const P6& b,
                                            float eax, float eay, float eaz,
                                            float ebx_, float eby_,
                                            float ebz_, float k, float c,
                                            float rest, const M& m) {
  EdgeBar o;
  const float dx = b.x - a.x, dy = b.y - a.y, dz = b.z - a.z;
  float dist, inv;
  m.dist_inv(dx * dx + dy * dy + dz * dz, dist, inv);
  const bool keep = dist >= kEps;
  const float ux = dx * inv, uy = dy * inv, uz = dz * inv;
  const float stretch = dist - rest;
  const float dvx = b.vx - a.vx, dvy = b.vy - a.vy, dvz = b.vz - a.vz;
  const float v_along = dvx * ux + dvy * uy + dvz * uz;
  const float s = k * stretch + c * v_along;
  const float ex = eax - ebx_, ey = eay - eby_, ez = eaz - ebz_;
  const float sb = ex * ux + ey * uy + ez * uz;
  const float sc = sb * c;
  const float ubx = s * ex + sc * dvx, uby = s * ey + sc * dvy,
              ubz = s * ez + sc * dvz;
  const float ud = ubx * dx + uby * dy + ubz * dz;
  const float lb = sb * k - ud * inv * inv;
  o.dx = keep ? ubx * inv + lb * ux : 0.0f;
  o.dy = keep ? uby * inv + lb * uy : 0.0f;
  o.dz = keep ? ubz * inv + lb * uz : 0.0f;
  o.dvx = keep ? sc * ux : 0.0f;
  o.dvy = keep ? sc * uy : 0.0f;
  o.dvz = keep ? sc * uz : 0.0f;
  o.gk = keep ? sb * stretch : 0.0f;
  o.gc = keep ? sb * v_along : 0.0f;
  o.grest = keep ? -(sb * k) : 0.0f;
  return o;
}

// The regions of a TH x TW tile, each a rectangle of cells (rows and
// columns relative to the core's first cell, their sizes known at compile
// time and not clipped to the grid: cells beyond it hold zeros and count
// for nothing), and one CTA's shared memory, in floats:
//   e4, the core grown by 4: the state (6 floats a cell);
//   e2, the core grown by 2: ctf (3);
//   the core: the integration's part of the state cotangent (6);
//   the edges of step 1, anchored in a1 (e4's first TH + 6 rows and TW + 7
//   columns: e2 and 2 more rows above, 2 more columns left, 1 right; 3
//   floats a family), then those of step 2, anchored in a2 (e2's first
//   TH + 2 rows and TW + 3 columns: the core, 2 rows above, 2 columns
//   left, 1 right; 6 floats a family), in one buffer.
template <int TH, int TW>
struct Tile {
  static constexpr int W4 = TW + 8, N4 = (TH + 8) * W4;
  static constexpr int W2 = TW + 4, N2 = (TH + 4) * W2;
  static constexpr int W1 = TW + 7, N1 = (TH + 6) * W1;
  static constexpr int WA = TW + 3, NA = (TH + 2) * WA;
  static constexpr int NC = TH * TW;
  static constexpr int EDGES = 18 * N1 > 36 * NA ? 18 * N1 : 36 * NA;
  static constexpr int FLOATS = 6 * N4 + 3 * N2 + 6 * NC + EDGES;
};

// Whether the spring of family f anchored at grid cell (r, c) joins two
// grid cells: K1's mask, and with WINDOW K1w's (cloth_substep.cuh
// `edge_ok`): the block is a row window whose row 0 is global row row0 of
// a grid h_global rows high, and the anchor's global row must satisfy
// 0 <= r + row0 < h_global - dr, so no spring reaches a dead row (a
// zero-filled halo row beyond the grid).
template <bool WINDOW>
__device__ __forceinline__ bool spring_ok(int r, int c, int h, int w, int dr,
                                          int dc, int row0, int h_global) {
  return cloth::edge_ok<WINDOW>(r, c, h, w, dr, dc, row0, h_global);
}

// Whether grid cell (r, c) has a spring of family (dr, dc) ending on it,
// i.e. its anchor (r - dr, c - dc) is a grid cell, and with WINDOW the
// anchor passes spring_ok's global-row test. Where it holds, step 2a
// wrote the anchor's adjoint.
template <bool WINDOW>
__device__ __forceinline__ bool reaction_ok(int r, int c, int w, int dr,
                                            int dc, int row0, int h_global) {
  return r >= dr && (dc >= 0 ? c >= dc : c < w + dc) &&
         (!WINDOW || (r - dr + row0 >= 0 && r - dr + row0 < h_global - dr));
}

// Step 1a's six springs anchored at one cell (state pa): family f's force
// into e[f] where ok[f] (its far end at extent index far[f]); a spring that
// does not count is evaluated on the extent's first cell and dropped, so
// the six are one block of code. M is cloth::Checked, whose `slow` is kept
// only for a spring that counts, or cloth::Exact<false>.
template <class M>
__device__ __forceinline__ void anchored_forces(
    const float* __restrict__ prm, const StateTile& S, const P6& pa,
    const bool (&ok)[6], const int (&far)[6], float (&e)[6][3], bool& slow) {
#pragma unroll
  for (int f = 0; f < 6; ++f) {
    int dr, dc, t;
    cloth::family(f, dr, dc, t);
    bool s = false;
    cloth::edge<false>(pa, S.get(far[f]), prm[t], prm[3 + t], prm[6 + t],
                       e[f][0], e[f][1], e[f][2], cloth::make<M>(s));
    slow |= ok[f] && s;
  }
}

// Step 2a's six spring adjoints anchored at one cell (state sa, force
// cotangent ca): family f's d̄ and Δv̄ into out[(6 f + m) * stride] where
// ok[f] (far end at extent index far4[f], ctf index far2[f]), its (k, c,
// rest) terms into gp[f]. Like anchored_forces.
template <class M>
__device__ __forceinline__ void anchored_adjoints(
    const float* __restrict__ prm, const StateTile& S,
    const float* __restrict__ F, int n2, const P6& sa, const float (&ca)[3],
    const bool (&ok)[6], const int (&far4)[6], const int (&far2)[6],
    float* __restrict__ out, int stride, float (&gp)[6][3], bool& slow) {
#pragma unroll
  for (int f = 0; f < 6; ++f) {
    int dr, dc, t;
    cloth::family(f, dr, dc, t);
    bool s = false;
    const int pb = far2[f];
    const EdgeBar e = edge_vjp(sa, S.get(far4[f]), ca[0], ca[1], ca[2], F[pb],
                               F[n2 + pb], F[2 * n2 + pb], prm[t],
                               prm[3 + t], prm[6 + t], cloth::make<M>(s));
    slow |= ok[f] && s;
    if (ok[f]) {
      float* o = out + (6 * f) * stride;
      o[0] = e.dx;
      o[stride] = e.dy;
      o[2 * stride] = e.dz;
      o[3 * stride] = e.dvx;
      o[4 * stride] = e.dvy;
      o[5 * stride] = e.dvz;
    }
    gp[f][0] = e.gk;
    gp[f][1] = e.gc;
    gp[f][2] = e.grest;
  }
}

// One substep's adjoint of the tile at blockIdx.(y, x): the steps 0-2 of
// the header. st is the state entering the substep [6, h, w]; ct_in the
// cotangent of its output [6, h, w], ct_out that of its input (written on
// the core only); partial this substep's [tiles, 16] rows. Every loop runs
// the same number of times in all threads of the CTA (a thread past the
// end works on a cell it does not keep), so a warp can vote on `slow`.
// With WINDOW the grid is a batch of row windows of one shape (spring_ok),
// blockIdx.z the window b: st, ct_in and ct_out hold [B, 6, h, w],
// pin_mask [B, h, w] and ct_pin [B, 3, h, w] (64-bit offsets), window b's
// row 0 is global row row0[b], and its tiles' partial rows follow window
// b - 1's. A window's dead rows join no spring, so their state cotangent
// stays 0 and each of their parameter terms is 0 times a finite value.
// Without it there is one window and row0 and h_global are not read.
template <bool PINS, bool WINDOW, int TH, int TW, int NT>
__global__ void __launch_bounds__(NT)
    vjp_substep(const float* __restrict__ prm, const float* __restrict__ st,
                const float* __restrict__ pin_mask,
                const float* __restrict__ ct_in, float* __restrict__ ct_out,
                float* __restrict__ ct_pin, double* __restrict__ partial,
                int h, int w, const int* __restrict__ row0s, int h_global) {
  using T = Tile<TH, TW>;
  extern __shared__ float2 smem2[];
#ifdef WPE_PROBE_EMPTY
  if (h > 0) return;
#endif
  WPE_PROBE_MARK(0);
  float* const smem = reinterpret_cast<float*>(smem2);
  const StateTile S{smem2};
  float* const F = smem + 6 * T::N4;
  float* const C = F + 3 * T::N2;
  float* const E = C + 6 * T::NC;
  const int hw = h * w;
  // the window: its planes and its first global row
  const int64_t b = WINDOW ? blockIdx.z : 0;
  const int64_t plane = static_cast<int64_t>(hw);
  st += 6 * plane * b;
  ct_in += 6 * plane * b;
  ct_out += 6 * plane * b;
  if (PINS) {
    pin_mask += plane * b;
    ct_pin += 3 * plane * b;
  }
  const int row0 = WINDOW ? row0s[b] : 0;
  // row and column of the core's first cell
  const int r0 = blockIdx.y * TH, c0 = blockIdx.x * TW;
  auto in_grid = [&](int r, int c) {
    return r >= 0 && r < h && c >= 0 && c < w;
  };

  // ---- 0. the state over e4 into shared memory (zeros beyond the grid),
  // without waiting on each load ----
  for (int j = threadIdx.x; j < T::N4; j += NT) {
    const int r = r0 - 4 + j / T::W4, c = c0 - 4 + j % T::W4;
    float* d = smem + 6 * j;
    if (in_grid(r, c)) {
      const int g = r * w + c;
#pragma unroll
      for (int m = 0; m < 6; ++m) {
        __pipeline_memcpy_async(d + m, st + m * hw + g, sizeof(float));
      }
    } else {
#pragma unroll
      for (int m = 0; m < 6; ++m) d[m] = 0.0f;
    }
  }
  __pipeline_commit();
  __pipeline_wait_prior(0);
  __syncthreads();
  WPE_PROBE_MARK(1);

  // ---- 1a. the spring forces that touch e2, each once: E[(f, xyz), a],
  // an anchor's six at a time ----
  for (int j0 = 0; j0 < T::N1; j0 += NT) {
    const int j = j0 + threadIdx.x;
    const bool live = j < T::N1;
    const int y = live ? j / T::W1 : 0, x = live ? j % T::W1 : 0;
    const int r = r0 - 4 + y, c = c0 - 4 + x;  // y, x: the cell in e4
    const int i4 = y * T::W4 + x;
    const bool real = live && in_grid(r, c);
    auto in_e2 = [](int yy, int xx) {
      return yy >= 2 && yy < TH + 6 && xx >= 2 && xx < TW + 6;
    };
    bool need[6], ok[6];
    int far[6];
#pragma unroll
    for (int f = 0; f < 6; ++f) {
      int dr, dc, t;
      cloth::family(f, dr, dc, t);
      need[f] = live && (in_e2(y, x) || in_e2(y + dr, x + dc));
      ok[f] = need[f] && real &&
              spring_ok<WINDOW>(r, c, h, w, dr, dc, row0, h_global);
      far[f] = ok[f] ? i4 + dr * T::W4 + dc : 0;
    }
    const P6 pa = S.get(i4);
    float e[6][3];
    bool slow = false;
    anchored_forces<cloth::Checked>(prm, S, pa, ok, far, e, slow);
    if (__any_sync(0xffffffffu, slow)) {
      anchored_forces<cloth::Exact<false>>(prm, S, pa, ok, far, e, slow);
    }
#pragma unroll
    for (int f = 0; f < 6; ++f) {
      if (need[f]) {
#pragma unroll
        for (int m = 0; m < 3; ++m) {
          E[(3 * f + m) * T::N1 + j] = ok[f] ? e[f][m] : 0.0f;
        }
      }
    }
  }
  __syncthreads();
  WPE_PROBE_MARK(2);

  // ---- 1b. the integration adjoint on e2: ctf into F, the state
  // cotangent's integration part into C for the core ----
  // cotangents of 9 k_contact, 10 mu, 11 mass, 12 gravity, 13 damp,
  // 14 min_dist, 15 dt
  double gi_sum[7] = {0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0};
  for (int j0 = 0; j0 < T::N2; j0 += NT) {
    const int j = j0 + threadIdx.x;
    const bool live = j < T::N2;
    const int y = live ? j / T::W2 + 2 : 2, x = live ? j % T::W2 + 2 : 2;
    const int r = r0 - 4 + y, c = c0 - 4 + x;  // y, x: the cell in e4
    const bool real = live && in_grid(r, c);
    const P6 p = S.get(y * T::W4 + x);
    // K1's sum (cloth_substep.cuh `spring_force`): family by family, +
    // the spring p anchors, then - the spring that ends on p
    float fx = 0.0f, fy = 0.0f, fz = 0.0f;
    const int own = y * T::W1 + x;
#pragma unroll
    for (int f = 0; f < 6; ++f) {
      int dr, dc, t;
      cloth::family(f, dr, dc, t);
      fx = fx + E[(3 * f) * T::N1 + own];
      fy = fy + E[(3 * f + 1) * T::N1 + own];
      fz = fz + E[(3 * f + 2) * T::N1 + own];
      const bool react = reaction_ok<WINDOW>(r, c, w, dr, dc, row0,
                                             h_global);
      const int a = own - dr * T::W1 - dc;
      fx = fx - (react ? E[(3 * f) * T::N1 + a] : 0.0f);
      fy = fy - (react ? E[(3 * f + 1) * T::N1 + a] : 0.0f);
      fz = fz - (react ? E[(3 * f + 2) * T::N1 + a] : 0.0f);
    }
    const int i = real ? r * w + c : 0;
    float b_in[6];
#pragma unroll
    for (int m = 0; m < 6; ++m) b_in[m] = real ? ct_in[m * hw + i] : 0.0f;
    const bool pinned = PINS && real && pin_mask[i] != 0.0f;
    const bool mine = real && y >= 4 && y < TH + 4 && x >= 4 && x < TW + 4;
    if (pinned && mine) {
      ct_pin[i] = ct_pin[i] + b_in[0];
      ct_pin[hw + i] = ct_pin[hw + i] + b_in[1];
      ct_pin[2 * hw + i] = ct_pin[2 * hw + i] + b_in[2];
    }
    float b[6], ctf[3], gi[7];
#pragma unroll
    for (int m = 0; m < 6; ++m) b[m] = b_in[m];
    bool slow = false;
    integrate_vjp(prm, p, fx, fy, fz, pinned, b, ctf, gi,
                  cloth::Checked{slow});
    if (__any_sync(0xffffffffu, real && slow)) {
#pragma unroll
      for (int m = 0; m < 6; ++m) b[m] = b_in[m];
      integrate_vjp(prm, p, fx, fy, fz, pinned, b, ctf, gi,
                    cloth::Exact<false>{});
    }
    if (live) {
#pragma unroll
      for (int m = 0; m < 3; ++m) F[m * T::N2 + j] = ctf[m];
    }
    if (mine) {
      const int q = (y - 4) * TW + (x - 4);
#pragma unroll
      for (int m = 0; m < 6; ++m) C[m * T::NC + q] = b[m];
#pragma unroll
      for (int m = 0; m < 7; ++m) gi_sum[m] += gi[m];
    }
  }
  const int64_t tile =
      (b * gridDim.y + blockIdx.y) * static_cast<int64_t>(gridDim.x) +
      blockIdx.x;
  // (its barrier ends step 1)
  block_sum<NT, 7>(gi_sum, partial + tile * kNumParams + 9);
  WPE_PROBE_MARK(3);

  // ---- 2a. the spring adjoints that touch the core, each once:
  // E[(f, d xyz, dv xyz), a], an anchor's six at a time; the anchor's
  // parameter terms if it is a core cell ----
  // cotangents of 0..2 k, 3..5 c, 6..8 rest per spring type
  double g[9] = {0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0};
  for (int j0 = 0; j0 < T::NA; j0 += NT) {
    const int j = j0 + threadIdx.x;
    const bool live = j < T::NA;
    const int y = live ? j / T::WA : 0, x = live ? j % T::WA : 0;
    const int r = r0 - 2 + y, c = c0 - 2 + x;  // y, x: the cell in e2
    const bool real = live && in_grid(r, c);
    auto in_core = [](int yy, int xx) {
      return yy >= 2 && yy < TH + 2 && xx >= 2 && xx < TW + 2;
    };
    const bool mine = real && in_core(y, x);
    const int i4 = (y + 2) * T::W4 + x + 2, i2 = y * T::W2 + x;
    bool ok[6];
    int far4[6], far2[6];
#pragma unroll
    for (int f = 0; f < 6; ++f) {
      int dr, dc, t;
      cloth::family(f, dr, dc, t);
      ok[f] = real && (mine || in_core(y + dr, x + dc)) &&
              spring_ok<WINDOW>(r, c, h, w, dr, dc, row0, h_global);
      far4[f] = ok[f] ? i4 + dr * T::W4 + dc : 0;
      far2[f] = ok[f] ? i2 + dr * T::W2 + dc : 0;
    }
    const P6 sa = S.get(i4);
    const float ca[3] = {F[i2], F[T::N2 + i2], F[2 * T::N2 + i2]};
    float gp[6][3];
    bool slow = false;
    anchored_adjoints<cloth::Checked>(prm, S, F, T::N2, sa, ca, ok, far4,
                                      far2, E + j, T::NA, gp, slow);
    if (__any_sync(0xffffffffu, slow)) {
      anchored_adjoints<cloth::Exact<false>>(prm, S, F, T::N2, sa, ca, ok,
                                             far4, far2, E + j, T::NA, gp,
                                             slow);
    }
    if (mine) {
#pragma unroll
      for (int f = 0; f < 6; ++f) {
        int dr, dc, t;
        cloth::family(f, dr, dc, t);
        if (ok[f]) {
          g[t] += gp[f][0];
          g[3 + t] += gp[f][1];
          g[6 + t] += gp[f][2];
        }
      }
    }
  }
  // (its barrier ends step 2a)
  block_sum<NT, 9>(g, partial + tile * kNumParams);
  WPE_PROBE_MARK(4);

  // ---- 2b. the core's state cotangents, in `_substep_vjp_planes`' order ----
  for (int q = threadIdx.x; q < T::NC; q += NT) {
    const int y = q / TW + 2, x = q % TW + 2;  // the cell in e2
    const int r = r0 - 2 + y, c = c0 - 2 + x;
    if (!in_grid(r, c)) continue;
    float b[6];
#pragma unroll
    for (int m = 0; m < 6; ++m) b[m] = C[m * T::NC + q];
    const int own = y * T::WA + x;
#pragma unroll
    for (int f = 0; f < 6; ++f) {
      int dr, dc, t;
      cloth::family(f, dr, dc, t);
      if (spring_ok<WINDOW>(r, c, h, w, dr, dc, row0, h_global)) {
        const float* e = E + (6 * f) * T::NA + own;
#pragma unroll
        for (int m = 0; m < 6; ++m) b[m] = b[m] - e[m * T::NA];
      }
      if (reaction_ok<WINDOW>(r, c, w, dr, dc, row0, h_global)) {
        const float* e = E + (6 * f) * T::NA + own - dr * T::WA - dc;
#pragma unroll
        for (int m = 0; m < 6; ++m) b[m] = b[m] + e[m * T::NA];
      }
    }
    const int i = r * w + c;
#pragma unroll
    for (int m = 0; m < 6; ++m) ct_out[m * hw + i] = b[m];
  }
#ifdef WPE_PROBE_CLOCK
  __syncthreads();
  WPE_PROBE_MARK(5);
#endif
}

// out[j] = the sum over rows of partial[row * 16 + j], one CTA per j, in a
// fixed order: a strided sum per thread, then a tree over the CTA.
__global__ void __launch_bounds__(kThreads)
    reduce_partials(const double* __restrict__ partial, int64_t rows,
                    float* __restrict__ out) {
  __shared__ double buf[kThreads];
  const int j = blockIdx.x;
  double s = 0.0;
  for (int64_t row = threadIdx.x; row < rows; row += kThreads) {
    s += partial[row * kNumParams + j];
  }
  buf[threadIdx.x] = s;
  __syncthreads();
  for (int off = kThreads / 2; off > 0; off >>= 1) {
    if (threadIdx.x < off) buf[threadIdx.x] += buf[threadIdx.x + off];
    __syncthreads();
  }
  if (threadIdx.x == 0) out[j] = static_cast<float>(buf[0]);
}

// The walk of n_windows windows of one shape (1 without WINDOW): a launch
// a substep for all of them, then one reduction of all their partials.
template <bool PINS, bool WINDOW>
cudaError_t walk(const float* prm, const float* traj, const float* pin_mask,
                 float* ct_a, float* ct_b, float* ct_pin, double* partial,
                 float* ct_prm, int n_windows, int h, int w, int n_steps,
                 int64_t tiles, const int* row0, int h_global,
                 cudaStream_t stream) {
  constexpr int TH = kTileH, TW = kTileW, NT = kVjpThreads;
  const dim3 grid((w + TW - 1) / TW, (h + TH - 1) / TH, n_windows);
  if (grid.y > 65535 || n_windows < 1 || n_windows > 65535) {
    return cudaErrorInvalidConfiguration;
  }
  if (tiles != static_cast<int64_t>(grid.x) * grid.y) {
    return cudaErrorInvalidValue;
  }
  const int64_t rows = tiles * n_windows;  // partial rows a substep
  const int64_t plane = static_cast<int64_t>(h) * w * n_windows;
  constexpr int smem = 4 * Tile<TH, TW>::FLOATS;
  static_assert(smem <= kMaxSmem, "the tile needs too much shared memory");
  cudaError_t err = allow_smem<vjp_substep<PINS, WINDOW, TH, TW, NT>>(smem);
  if (err != cudaSuccess) return err;
  for (int s = n_steps - 1, done = 0; s >= 0; --s, ++done) {
    const float* st = traj + 6 * plane * s;
    double* part = partial + rows * kNumParams * s;
    const float* src = done % 2 == 0 ? ct_a : ct_b;
    float* dst = done % 2 == 0 ? ct_b : ct_a;
    vjp_substep<PINS, WINDOW, TH, TW, NT><<<grid, NT, smem, stream>>>(
        prm, st, pin_mask, src, dst, ct_pin, part, h, w, row0, h_global);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  reduce_partials<<<kNumParams, kThreads, 0, stream>>>(
      partial, rows * n_steps, ct_prm);
  return cudaGetLastError();
}

}  // namespace

// The backward of n_steps exact substeps of one world, one launch a
// substep on tiles of kTileH x kTileW particles. traj is f32
// [n_steps, 6, h, w], the state entering each substep; ct_a is f32
// [6, h, w] (pos then vel), the cotangent of the last substep's output on
// entry; ct_b f32 [6, h, w] scratch. Substep j of the walk (j = 0 the last
// substep) reads ct_a and writes ct_b when j is even, the other way when
// it is odd, so the cotangent of traj[0] ends in ct_b for an odd n_steps
// and in ct_a for an even one. partial is f64 [n_steps, tiles, 16] scratch
// with tiles = ceil(w / kTileW) * ceil(h / kTileH), which the caller
// passes (cudaErrorInvalidValue if it differs); ct_prm receives the f32
// [16] parameter cotangent summed over the walk. With use_pins, pin_mask is
// f32 [h, w] and ct_pin f32 [3, h, w] gets the pin_pos cotangent added;
// both are ignored otherwise.
extern "C" int wpe_cloth_substep_vjp(const float* params, const float* traj,
                                     const float* pin_mask, float* ct_a,
                                     float* ct_b, float* ct_pin,
                                     double* partial, float* ct_prm, int h,
                                     int w, int n_steps, int tiles,
                                     int use_pins, void* stream) {
  if (h <= 0 || w <= 0 || n_steps <= 0) return cudaSuccess;
  auto s = static_cast<cudaStream_t>(stream);
  return use_pins
             ? walk<true, false>(params, traj, pin_mask, ct_a, ct_b, ct_pin,
                                 partial, ct_prm, 1, h, w, n_steps, tiles,
                                 nullptr, 0, s)
             : walk<false, false>(params, traj, pin_mask, ct_a, ct_b, ct_pin,
                                  partial, ct_prm, 1, h, w, n_steps, tiles,
                                  nullptr, 0, s);
}

// The same walk on a batch of n_windows row windows of one shape, one
// launch a substep for all of them: window b of a grid h_global rows high
// whose local row 0 is global row row0[b] (row0: a device array of
// n_windows int32; < 0 on the top shard, whose leading halo rows are
// dead); the adjoint of K1w's substeps (cloth_step.cu
// `wpe_cloth_trace_window` gives traj, f32 [n_steps, n_windows, 6, h, w]),
// the springs masked as K1w masks them. ct_a and ct_b are f32
// [n_windows, 6, h, w], pin_mask f32 [n_windows, h, w] (a zero mask for a
// window without pins) and ct_pin f32 [n_windows, 3, h, w]; partial is f64
// [n_steps, n_windows * tiles, 16], window b's tiles after window b - 1's,
// and ct_prm receives the one [16] sum over the batch, in a fixed order.
// Every cell of a window counts, the stale halo rows too: the window's
// output depends on the parameters through them.
extern "C" int wpe_cloth_substep_vjp_window(
    const float* params, const float* traj, const float* pin_mask,
    float* ct_a, float* ct_b, float* ct_pin, double* partial, float* ct_prm,
    int n_windows, int h, int w, int n_steps, int tiles, const int* row0,
    int h_global, int use_pins, void* stream) {
  if (h_global < 1 || row0 == nullptr) return cudaErrorInvalidValue;
  if (h <= 0 || w <= 0 || n_steps <= 0) return cudaSuccess;
  auto s = static_cast<cudaStream_t>(stream);
  return use_pins
             ? walk<true, true>(params, traj, pin_mask, ct_a, ct_b, ct_pin,
                                partial, ct_prm, n_windows, h, w, n_steps,
                                tiles, row0, h_global, s)
             : walk<false, true>(params, traj, pin_mask, ct_a, ct_b, ct_pin,
                                 partial, ct_prm, n_windows, h, w, n_steps,
                                 tiles, row0, h_global, s);
}

#ifdef WPE_PROBE_CLOCK
// Copies probe_clock ([kProbeTiles][kProbeMarks] int64) to host memory.
extern "C" int wpe_probe_clock(long long* out) {
  return cudaMemcpyFromSymbol(out, probe_clock, sizeof(probe_clock));
}
#endif
