// The adjoint of one exact cloth substep for Hopper (sm_90a), walked in
// reverse over a trajectory: the backward pass of
// ops/cloth_grad_kernel.py (`_Segment`, `multi_step_diff`).
//
// Replaces: wgpu_physics_engine_tpu/ops/cloth_pallas_grad.py
//   * `_bwd_kernel` (K7), the whole-plane reverse-walk transpose;
//   * `_bwd_kernel_banded` (K8), the same in 8-row-halo bands;
//   * `_bwd_kernel_stream` (K9), the same with the primal band DMA'd from
//     HBM.
// The three were VMEM tiers of one function; here one kernel pair takes
// any grid. (The trace kernels of K7 and K9 are K1 itself:
// `wpe_cloth_trace` in cloth_step.cu.)
//
// The TPU kernels build each substep's transpose with jax.vjp of the
// forward's pure functions. Here the adjoint is written by hand, op for op
// the same as the plain version `_substep_vjp_planes` in
// ops/cloth_grad_kernel.py, which the CPU tests hold against torch.autograd
// and jax.grad. Per substep s, from the state traj[s] entering it and the
// cotangent `ct` (6 planes) of its output:
//   (a) `vjp_integrate`, one thread per particle: recomputes the spring
//       force with K1's gather (cloth_substep.cuh `spring_force`), then the
//       integration forward and its adjoint (pins, projection, Euler and
//       damping, friction with its min, contact, gravity). Writes the
//       integration's part of the input-state cotangent into `ct` (in
//       place: thread p reads and writes only particle p), the spring
//       force's cotangent `ctf` (3 planes), adds the pin_pos cotangent, and
//       writes its block's partial sums of parameter cotangents 9..15.
//   (b) `vjp_springs`, one thread per particle: gathers over the 12 edges
//       that touch p (each family's edge anchored at p and the one anchored
//       at p - d), recomputing each edge's adjoint from its two ends' state
//       and ctf, and adds x̄ and v̄ into ct[p]. No atomics touch the state:
//       every edge adjoint is computed twice, by the same expression on the
//       same inputs. Each edge's parameter cotangents (k, c, rest of its
//       type, entries 0..8) are counted once, by the anchor's thread, into
//       its block's partial sums.
// After the walk `reduce_partials` sums the [n_steps, blocks, 16] float64
// partials in a fixed order (no float atomics), so gradients are the same
// from run to run.
//
// What bounds it on the H100. Per particle and substep the function reads
// the trajectory state (24 B) and the incoming cotangent (24 B) and writes
// the outgoing cotangent (24 B): 72 B. At 256x256 that is 4.7 MB a substep,
// 1.4 us at 3.35 TB/s; the operations (chip_smoke.py OPS_VJP_*: ~1,000 fp32
// a particle) take ~1 us at 67 TFLOP/s, so the bound is the bytes. This
// first design, like K1, gathers 13 neighbours' states in (a) and (b) each
// and the neighbours' ctf in (b) from L1/L2, two launches a substep; fusing
// (a) and (b), and keeping a segment's trajectory in shared memory, are
// later work.
//
// Built with -fmad=false (ops/_build.py), so every a*b + c rounds twice, as
// the plain torch version's separate ops do.

#include <cuda_runtime.h>

#include <cstdint>

#include "cloth_substep.cuh"
#include "common.cuh"

namespace {

using cloth::kEps;
using cloth::kNumParams;
using cloth::P6;

constexpr int kBlockW = 32;
constexpr int kBlockH = 8;
constexpr int kThreads = kBlockW * kBlockH;
constexpr int kWarps = kThreads / 32;

// Sum each of N per-thread values over the block in a fixed order (warp
// shuffles, then the warps in order) into out[0..N). Every thread of the
// block must call it.
template <int N>
__device__ __forceinline__ void block_sum(double (&v)[N],
                                          double* __restrict__ out) {
  __shared__ double warp_sums[kWarps][N];
  const int lane = threadIdx.x;  // blockDim.x == 32
  const int warp = threadIdx.y;
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
  if (lane == 0 && warp == 0) {
#pragma unroll
    for (int j = 0; j < N; ++j) {
      double s = 0.0;
      for (int k = 0; k < kWarps; ++k) s += warp_sums[k][j];
      out[j] = s;
    }
  }
}

// (a) The integration adjoint of particle (r, c). Names follow
// `_substep_vjp_planes`: f1 after contact, f2 after friction, h = f2/m,
// a = v + h dt, v1 = a damp, x1 = x + v1 dt; b* are cotangents.
template <bool PINS>
__global__ void __launch_bounds__(kThreads)
    vjp_integrate(const float* __restrict__ prm, const float* __restrict__ st,
                  const float* __restrict__ pin_mask, float* __restrict__ ct,
                  float* __restrict__ ctf, float* __restrict__ ct_pin,
                  double* __restrict__ partial, int h, int w) {
  const int c = blockIdx.x * kBlockW + threadIdx.x;
  const int r = blockIdx.y * kBlockH + threadIdx.y;
  // cotangents of 9:k_contact 10:mu 11:mass 12:gravity 13:damp
  // 14:min_dist 15:dt
  double g[7] = {0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0};
  if (r < h && c < w) {
    const int hw = h * w;
    const int i = r * w + c;
    const float* pos = st;
    const float* vel = st + 3 * hw;
    const P6 p = cloth::load(pos, vel, i, hw);
    float fx, fy, fz;
    cloth::spring_force<false>(prm, pos, vel, p, r, c, h, w, fx, fy, fz);

    // ---- forward of the integration, in the stepper's op order ----
    const float k_contact = prm[9], mu = prm[10], mass = prm[11];
    const float gravity = prm[12], damp = prm[13], min_dist = prm[14];
    const float dt = prm[15];
    fy = fy + mass * gravity;
    const float x = p.x, y = p.y, z = p.z;
    float dist, inv_d;
    cloth::dist_inv<false>(x * x + y * y + z * z, dist, inv_d);
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
    cloth::dist_inv<false>(tx * tx + ty * ty + tz * tz, tmag, inv_t);
    const bool fric = in_contact && (tmag > kEps);
    const float cap = mu * fabsf(ro_n);
    const float fmag = -fminf(tmag, cap);
    const float f2x = fric ? f1x + fmag * tx * inv_t : f1x;
    const float f2y = fric ? f1y + fmag * ty * inv_t : f1y;
    const float f2z = fric ? f1z + fmag * tz * inv_t : f1z;
    const float inv_m = 1.0f / mass;
    const float hx = f2x * inv_m, hy = f2y * inv_m, hz = f2z * inv_m;
    const float ax = p.vx + hx * dt, ay = p.vy + hy * dt, az = p.vz + hz * dt;
    const float v1x = ax * damp, v1y = ay * damp, v1z = az * damp;
    const float x1 = x + v1x * dt, y1 = y + v1y * dt, z1 = z + v1z * dt;
    float fdist, inv_f;
    cloth::dist_inv<false>(x1 * x1 + y1 * y1 + z1 * z1, fdist, inv_f);
    const bool pen2 = fdist < min_dist;
    const bool pen_safe = pen2 && (fdist > kEps);
    const bool pen_center = pen2 && !pen_safe;

    // ---- pins ----
    float bx = ct[i], by = ct[hw + i], bz = ct[2 * hw + i];
    float bvx = ct[3 * hw + i], bvy = ct[4 * hw + i], bvz = ct[5 * hw + i];
    if (PINS && pin_mask[i] != 0.0f) {
      ct_pin[i] = ct_pin[i] + bx;
      ct_pin[hw + i] = ct_pin[hw + i] + by;
      ct_pin[2 * hw + i] = ct_pin[2 * hw + i] + bz;
      bx = 0.0f;
      by = 0.0f;
      bz = 0.0f;
      bvx = 0.0f;
      bvy = 0.0f;
      bvz = 0.0f;
    }

    // ---- projection: x2 = x1 / |x1| * min_dist, v2 = 0 where inside ----
    if (pen2) {
      bvx = 0.0f;
      bvy = 0.0f;
      bvz = 0.0f;
    }
    float g_md = 0.0f;
    float b1x = bx, b1y = by, b1z = bz;
    if (pen_safe) {
      const float ux = x1 * inv_f, uy = y1 * inv_f, uz = z1 * inv_f;
      g_md = bx * ux + by * uy + bz * uz;
      const float qx = bx * min_dist, qy = by * min_dist, qz = bz * min_dist;
      const float uq = ux * qx + uy * qy + uz * qz;
      b1x = (qx - ux * uq) * inv_f;
      b1y = (qy - uy * uq) * inv_f;
      b1z = (qz - uz * uq) * inv_f;
    } else if (pen_center) {
      g_md = by;
      b1x = 0.0f;
      b1y = 0.0f;
      b1z = 0.0f;
    }

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
    float f1bx = fbx, f1by = fby, f1bz = fbz;
    float nbx = 0.0f, nby = 0.0f, nbz = 0.0f;
    float g_mu = 0.0f;
    if (fric) {
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
      g_mu = cap_b * fabsf(ro_n);
      const float sgn = ro_n > 0.0f ? 1.0f : (ro_n < 0.0f ? -1.0f : 0.0f);
      float ro_b = cap_b * mu * sgn;
      ro_b = ro_b - (tbx * nx + tby * ny + tbz * nz);
      f1bx = fbx + tbx + ro_b * nx;
      f1by = fby + tby + ro_b * ny;
      f1bz = fbz + tbz + ro_b * nz;
      nbx = -(ro_n * tbx) + ro_b * f1x;
      nby = -(ro_n * tby) + ro_b * f1y;
      nbz = -(ro_n * tbz) + ro_b * f1z;
    }

    // ---- contact: f1 = f0 + k_contact (min_dist - |x|) x / |x| ----
    float cx = b1x, cy = b1y, cz = b1z;
    float g_kc = 0.0f;
    if (in_contact) {
      const float pen_b = f1bx * nx + f1by * ny + f1bz * nz;
      nbx = nbx + pen * f1bx;
      nby = nby + pen * f1by;
      nbz = nbz + pen * f1bz;
      g_kc = pen_b * (min_dist - dist);
      g_md = g_md + pen_b * k_contact;
      const float dist_b =
          -(pen_b * k_contact) - (nbx * x + nby * y + nbz * z) * inv_d * inv_d;
      cx = b1x + (nbx * inv_d + dist_b * nx);
      cy = b1y + (nby * inv_d + dist_b * ny);
      cz = b1z + (nbz * inv_d + dist_b * nz);
    }

    // ---- gravity; the spring force's cotangent is the contact input's ----
    g_mass = g_mass + f1by * gravity;
    const float g_grav = f1by * mass;

    ct[i] = cx;
    ct[hw + i] = cy;
    ct[2 * hw + i] = cz;
    ct[3 * hw + i] = abx;
    ct[4 * hw + i] = aby;
    ct[5 * hw + i] = abz;
    ctf[i] = f1bx;
    ctf[hw + i] = f1by;
    ctf[2 * hw + i] = f1bz;
    g[0] = g_kc;
    g[1] = g_mu;
    g[2] = g_mass;
    g[3] = g_grav;
    g[4] = g_damp;
    g[5] = g_md;
    g[6] = g_dt;
  }
  const int64_t block = static_cast<int64_t>(blockIdx.y) * gridDim.x +
                        blockIdx.x;
  block_sum<7>(g, partial + block * kNumParams + 9);
}

// The adjoint of the spring a -> b at the force cotangent Ē = ctf[a] -
// ctf[b]: d̄ (added to x_b, taken from x_a), Δv̄ (likewise for v), and
// the edge's cotangents of k, c and rest. Zero where dist < EPS, as the
// forward keeps no force there.
struct EdgeBar {
  float dx, dy, dz, dvx, dvy, dvz, gk, gc, grest;
};

__device__ __forceinline__ EdgeBar edge_vjp(const P6& a, const P6& b,
                                            float eax, float eay, float eaz,
                                            float ebx_, float eby_,
                                            float ebz_, float k, float c,
                                            float rest) {
  EdgeBar o = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  const float dx = b.x - a.x, dy = b.y - a.y, dz = b.z - a.z;
  float dist, inv;
  cloth::dist_inv<false>(dx * dx + dy * dy + dz * dz, dist, inv);
  if (!(dist >= kEps)) return o;
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
  o.dx = ubx * inv + lb * ux;
  o.dy = uby * inv + lb * uy;
  o.dz = ubz * inv + lb * uz;
  o.dvx = sc * ux;
  o.dvy = sc * uy;
  o.dvz = sc * uz;
  o.gk = sb * stretch;
  o.gc = sb * v_along;
  o.grest = -(sb * k);
  return o;
}

// (b) The spring adjoint gathered at particle (r, c), family by family in
// `_FAMILIES` order: -edge(p as anchor), then +edge(p - d as anchor).
__global__ void __launch_bounds__(kThreads)
    vjp_springs(const float* __restrict__ prm, const float* __restrict__ st,
                const float* __restrict__ ctf, float* __restrict__ ct,
                double* __restrict__ partial, int h, int w) {
  const int c = blockIdx.x * kBlockW + threadIdx.x;
  const int r = blockIdx.y * kBlockH + threadIdx.y;
  // cotangents of 0..2 k, 3..5 c, 6..8 rest per spring type
  double g[9] = {0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0};
  if (r < h && c < w) {
    const int hw = h * w;
    const int i = r * w + c;
    const float* pos = st;
    const float* vel = st + 3 * hw;
    const P6 p = cloth::load(pos, vel, i, hw);
    const float epx = ctf[i], epy = ctf[hw + i], epz = ctf[2 * hw + i];
    float cx = ct[i], cy = ct[hw + i], cz = ct[2 * hw + i];
    float cvx = ct[3 * hw + i], cvy = ct[4 * hw + i], cvz = ct[5 * hw + i];
#pragma unroll
    for (int f = 0; f < 6; ++f) {
      int dr, dc, t;
      cloth::family(f, dr, dc, t);
      const float k = prm[t], cd = prm[3 + t], rest = prm[6 + t];
      // the edge p -> q = (r+dr, c+dc), anchored at p
      if (r < h - dr && (dc >= 0 ? c < w - dc : c >= -dc)) {
        const int j = i + dr * w + dc;
        const P6 q = cloth::load(pos, vel, j, hw);
        const EdgeBar e = edge_vjp(p, q, epx, epy, epz, ctf[j], ctf[hw + j],
                                   ctf[2 * hw + j], k, cd, rest);
        cx = cx - e.dx;
        cy = cy - e.dy;
        cz = cz - e.dz;
        cvx = cvx - e.dvx;
        cvy = cvy - e.dvy;
        cvz = cvz - e.dvz;
        g[t] += e.gk;
        g[3 + t] += e.gc;
        g[6 + t] += e.grest;
      }
      // the edge a = (r-dr, c-dc) -> p, anchored at a (its thread counts
      // the parameter cotangents)
      const int ar = r - dr, ac = c - dc;
      if (ar >= 0 && (dc >= 0 ? ac >= 0 : ac < w)) {
        const int j = ar * w + ac;
        const P6 a = cloth::load(pos, vel, j, hw);
        const EdgeBar e = edge_vjp(a, p, ctf[j], ctf[hw + j], ctf[2 * hw + j],
                                   epx, epy, epz, k, cd, rest);
        cx = cx + e.dx;
        cy = cy + e.dy;
        cz = cz + e.dz;
        cvx = cvx + e.dvx;
        cvy = cvy + e.dvy;
        cvz = cvz + e.dvz;
      }
    }
    ct[i] = cx;
    ct[hw + i] = cy;
    ct[2 * hw + i] = cz;
    ct[3 * hw + i] = cvx;
    ct[4 * hw + i] = cvy;
    ct[5 * hw + i] = cvz;
  }
  const int64_t block = static_cast<int64_t>(blockIdx.y) * gridDim.x +
                        blockIdx.x;
  block_sum<9>(g, partial + block * kNumParams);
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

template <bool PINS>
cudaError_t walk(const float* prm, const float* traj, const float* pin_mask,
                 float* ct, float* ctf, float* ct_pin, double* partial,
                 float* ct_prm, int h, int w, int n_steps,
                 cudaStream_t stream) {
  const dim3 block(kBlockW, kBlockH);
  const dim3 grid((w + kBlockW - 1) / kBlockW, (h + kBlockH - 1) / kBlockH);
  const int64_t blocks = static_cast<int64_t>(grid.x) * grid.y;
  const int64_t plane = static_cast<int64_t>(h) * w;
  for (int s = n_steps - 1; s >= 0; --s) {
    const float* st = traj + 6 * plane * s;
    double* part = partial + blocks * kNumParams * s;
    vjp_integrate<PINS><<<grid, block, 0, stream>>>(prm, st, pin_mask, ct,
                                                    ctf, ct_pin, part, h, w);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    vjp_springs<<<grid, block, 0, stream>>>(prm, st, ctf, ct, part, h, w);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  reduce_partials<<<kNumParams, kThreads, 0, stream>>>(
      partial, blocks * n_steps, ct_prm);
  return cudaGetLastError();
}

}  // namespace

// The backward of n_steps exact substeps of one world. traj is f32
// [n_steps, 6, h, w], the state entering each substep; ct is f32 [6, h, w]
// (pos then vel), the cotangent of the last substep's output on entry and
// of traj[0] on return; ctf is f32 [3, h, w] scratch; partial is f64
// [n_steps, blocks, 16] scratch with blocks = ceil(w/32) * ceil(h/8);
// ct_prm receives the f32 [16] parameter cotangent summed over the walk.
// With use_pins, pin_mask is f32 [h, w] and ct_pin f32 [3, h, w] gets the
// pin_pos cotangent added; both are ignored otherwise.
extern "C" int wpe_cloth_substep_vjp(const float* params, const float* traj,
                                     const float* pin_mask, float* ct,
                                     float* ctf, float* ct_pin,
                                     double* partial, float* ct_prm, int h,
                                     int w, int n_steps, int use_pins,
                                     void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  return use_pins ? walk<true>(params, traj, pin_mask, ct, ctf, ct_pin,
                               partial, ct_prm, h, w, n_steps, s)
                  : walk<false>(params, traj, pin_mask, ct, ctf, ct_pin,
                                partial, ct_prm, h, w, n_steps, s);
}
