// Fused cloth substeps for Hopper (sm_90a): one world (K1), one world with
// an external force plane (K1f), a batch of independent worlds (K5) and a
// row window of a larger grid (K1w). K1, K5 and K1w run the per-particle
// body of cloth_substep.cuh, one thread per particle; K1f runs its edges
// and integration spread over three warps a particle (below). One launch
// per substep.
//
// Replaces: wgpu_physics_engine_tpu/ops/cloth_pallas.py
//   * `_kernel` (K1), the single-world fused substeps, with
//     `wpe_cloth_multi_step`;
//   * `_kernel(extra_force=True)` (K1f, reached through
//     `substep_with_force` :682 -> :708), one substep with a per-particle
//     external force added after the springs (the cloth self-collision pair
//     forces), with `wpe_cloth_substep_with_force`. The self-collision
//     block (models/cloth.py) gives it the pair forces in its frozen sorted
//     order with the inverse permutation, and takes back the next
//     substep's sorted positions: the two gathers JAX does around its
//     kernel (wgpu_physics_engine_tpu/models/cloth.py:279, :291) happen in
//     the launch. It moves 48
//     bytes of state, 12 of force, 4 of permutation and 12 of sorted copy
//     a particle;
//   * `_lanes_kernel` (K5) and `_batched_kernel` (K5b), the same physics for
//     B worlds with a per-world parameter row, with
//     `wpe_cloth_multi_step_batched`. K5 folds several padded worlds into
//     the 128-wide lane axis and K5b runs one program per world; both are
//     Mosaic layouts of one function, which here is one thread per
//     (world, particle) with the world index taken from the grid;
//   * `_kernel(window=True)` (K1w, reached through `multi_step_window`
//     :731 -> `pl.pallas_call` :763), K1 on a halo-extended band of rows
//     of a larger grid, the shard body of the rows-sharded multi-device path
//     (parallel/mesh.py), with `wpe_cloth_multi_step_window`: the same body
//     with the spring masks taken from global rows (cloth_substep.cuh
//     `edge_ok`). It is K1 with two more ints and a few integer compares a
//     spring; what bounds K1 bounds it. JAX maps the windows of a shard one
//     at a time (its vmapped kernel with SMEM operands does not lower);
//     here one launch a substep steps a batch of windows of one shape, each
//     with its own row0 and pins, blockIdx.z the window: the rows path
//     gives it every window one device holds in an exchange block (at 16
//     windows of 16 x 16, 2 CTAs a window, a launch is still below one
//     wave of the 132 SMs). JAX sends a window above its VMEM budget to the
//     XLA stencil; here a window above 100,000 particles takes K6w
//     (cloth_tiled.cu, the same bits on edge-once tiles, one window a
//     launch) and a smaller one K1w.
//
// What bounds them on the H100. Per particle and call the function reads
// 6 floats and writes 6 (48 B); per particle and substep it does ~280 fp32
// operations (34 for each of the ~5.8 edges a particle anchors, counted
// once, and 82 for contact, friction and integration; chip_smoke.py counts
// them from the shapes). K1 at 256x256: 3.1 MB, 0.94 us at 3.35 TB/s, and
// the state stays in the 50 MB L2. Measured (H100 SXM, 700 W) a launch
// takes 5.7 us of device time with ~1 us between launches: each thread
// waits on 13 dependent neighbour gathers while only ~2 CTAs per SM are
// resident. K5 at the datagen scale, 4096 worlds of 60x60 and 24 substeps
// a frame: 14.7M particles, so the state (708 MB) no longer fits in L2.
// Moved once per call the bytes would take 0.21 ms; the operations, 99
// GFLOP at 67 TFLOP/s, 1.48 ms, which is the bound. This design moves the
// bytes 24 times (once a substep, 5.07 ms at the memory rate), so it is
// bound by device memory.
// The faster design keeps each 60x60 world's six planes (86 KB) in shared
// memory across all substeps of a call, one CTA per world; it is a later
// step. Running all of K1's substeps in one cooperative launch (bands of
// rows kept in shared memory, their boundary rows exchanged through L2
// behind a grid barrier, neighbour flags or tagged words) measured level
// with a launch a substep at 256^2 (H100 SXM, 700 W): 8 substeps took
// 53.5 us of device time in one launch against 45.8 us in 8, whose ~1.1
// us gaps it removes; the body is latency bound at 16 warps an SM either
// way, and the exchange inside the launch costs what the gaps did
// (PERF.md).
//
// Neighbours must read the old state, so every substep writes the other
// of two buffers (never in place); the host loop launches n_steps substeps
// on one stream. Built with -fmad=false so no a*b+c is contracted to an
// FMA and the exact path rounds where the plain torch version does.

#include <cuda_runtime.h>

#include <cstdint>

#include "cloth_substep.cuh"
#include "common.cuh"

namespace {

constexpr int kBlockW = 32;
constexpr int kBlockH = 8;

template <bool FAST, bool PINS>
__global__ void __launch_bounds__(kBlockW * kBlockH)
    substep_kernel(const float* __restrict__ prm,
                   const float* __restrict__ pos,
                   const float* __restrict__ vel,
                   const float* __restrict__ pin_mask,
                   const float* __restrict__ pin_pos,
                   float* __restrict__ pos_out, float* __restrict__ vel_out,
                   int h, int w) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  const int r = blockIdx.y * blockDim.y + threadIdx.y;
  if (r >= h || c >= w) return;
  cloth::substep_particle<FAST, PINS>(prm, pos, vel, pin_mask, pin_pos,
                                      pos_out, vel_out, r, c, h, w);
}

// K1w: one substep of a batch of row windows of one shape h x w,
// blockIdx.z the window. Window b's local row 0 is global row row0[b] of a
// grid h_global rows high (see cloth_substep.cuh `edge_ok`); its pos, vel
// and outputs start `stride` floats after window b - 1's (3 planes for a
// [B, 3, h, w] state, 6 for a step of a [n, B, 6, h, w] trajectory), its
// pin mask one plane and its pin positions three planes after. Offsets
// are 64-bit, as K5's are. A window without pins in a batch with pins has
// a zero mask, for which `integrate` takes no pin branch: the bits of
// PINS = false.
template <bool PINS>
__global__ void __launch_bounds__(kBlockW * kBlockH)
    substep_kernel_window(const float* __restrict__ prm,
                          const float* __restrict__ pos,
                          const float* __restrict__ vel,
                          const float* __restrict__ pin_mask,
                          const float* __restrict__ pin_pos,
                          float* __restrict__ pos_out,
                          float* __restrict__ vel_out, int h, int w,
                          int64_t stride, const int* __restrict__ row0,
                          int h_global) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  const int r = blockIdx.y * blockDim.y + threadIdx.y;
  if (r >= h || c >= w) return;
  const int64_t b = blockIdx.z;
  const int64_t plane = static_cast<int64_t>(h) * w;
  const int64_t at = stride * b;
  cloth::substep_particle<false, PINS, true>(
      prm, pos + at, vel + at, PINS ? pin_mask + plane * b : pin_mask,
      PINS ? pin_pos + 3 * plane * b : pin_pos, pos_out + at, vel_out + at,
      r, c, h, w, row0[b], h_global);
}

// The launch grid of K1 (one window) and K1w (n_windows of them).
inline dim3 window_grid(int h, int w, int n_windows) {
  return dim3((w + kBlockW - 1) / kBlockW, (h + kBlockH - 1) / kBlockH,
              n_windows);
}

// The trajectory of one world for the backward pass (ops/cloth_grad_kernel.py):
// traj is f32 [n_states, 6, h, w] (pos planes then vel planes) with the
// start state in traj[0]; substep s reads traj[s] and writes traj[s + 1],
// one launch of the exact K1 kernel each, so traj[s] equals s substeps of
// wpe_cloth_multi_step bit for bit. Replaces `_trace_kernel` (K7) and
// `_trace_kernel_stream` (K9) of wgpu_physics_engine_tpu/ops/
// cloth_pallas_grad.py, which rerun K1's body for the same purpose.
// With WINDOW the launches are K1w's on a batch of n_windows row windows
// (row0, h_global as for wpe_cloth_multi_step_window), traj f32
// [n_states, n_windows, 6, h, w], one launch a substep for the whole
// batch: the trajectories of the backward of the rows path
// (`_WindowSegment`), each window's equal to K1w's substeps bit for bit,
// and so to K6w's, which the forward takes for a window above 100,000
// particles. On the TPU the rows path's gradient is XLA autodiff of the
// window stencil, which saves these states itself. Without WINDOW,
// n_windows is 1 and row0 is not read.
template <bool PINS, bool WINDOW>
cudaError_t trace(const float* params, const float* pin_mask,
                  const float* pin_pos, float* traj, int n_windows, int h,
                  int w, int n_states, const int* row0, int h_global,
                  cudaStream_t stream) {
  const dim3 block(kBlockW, kBlockH);
  const dim3 grid = window_grid(h, w, n_windows);
  const int64_t plane = static_cast<int64_t>(h) * w;
  const int64_t step = 6 * plane * n_windows;
  for (int s = 0; s + 1 < n_states; ++s) {
    const float* src = traj + step * s;
    float* dst = traj + step * (s + 1);
    if (WINDOW) {
      substep_kernel_window<PINS><<<grid, block, 0, stream>>>(
          params, src, src + 3 * plane, pin_mask, pin_pos, dst,
          dst + 3 * plane, h, w, 6 * plane, row0, h_global);
    } else {
      substep_kernel<false, PINS><<<grid, block, 0, stream>>>(
          params, src, src + 3 * plane, pin_mask, pin_pos, dst,
          dst + 3 * plane, h, w);
    }
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

// Batched worlds: the 1-D grid walks (world, tile) with the tiles of one
// world adjacent; world offsets are 64-bit (4096 worlds of 3 x 60 x 60
// floats are 44M floats a plane set, and larger batches or grids pass
// 2^31).
template <bool FAST, bool PINS>
__global__ void __launch_bounds__(kBlockW * kBlockH)
    substep_kernel_batched(const float* __restrict__ prm,
                           const float* __restrict__ pos,
                           const float* __restrict__ vel,
                           const float* __restrict__ pin_mask,
                           const float* __restrict__ pin_pos,
                           float* __restrict__ pos_out,
                           float* __restrict__ vel_out, int h, int w,
                           int tiles_x, int tiles_per_world) {
  const int64_t world = blockIdx.x / tiles_per_world;
  const int tile = static_cast<int>(blockIdx.x % tiles_per_world);
  const int c = (tile % tiles_x) * kBlockW + threadIdx.x;
  const int r = (tile / tiles_x) * kBlockH + threadIdx.y;
  if (r >= h || c >= w) return;
  const int64_t plane = static_cast<int64_t>(h) * w;
  const int64_t state = 3 * plane * world;
  cloth::substep_particle<FAST, PINS>(
      prm + cloth::kNumParams * world, pos + state, vel + state,
      PINS ? pin_mask + plane * world : pin_mask,
      PINS ? pin_pos + state : pin_pos, pos_out + state, vel_out + state, r,
      c, h, w);
}

// n_steps launches ping-ponging between buffers a and b; `launch(src_p,
// src_v, dst_p, dst_v)` enqueues one substep.
template <typename Launch>
cudaError_t ping_pong(const float* pos_in, const float* vel_in, float* pos_a,
                      float* vel_a, float* pos_b, float* vel_b, int n_steps,
                      Launch launch) {
  const float* src_p = pos_in;
  const float* src_v = vel_in;
  for (int s = 0; s < n_steps; ++s) {
    float* dst_p = (s % 2 == 0) ? pos_a : pos_b;
    float* dst_v = (s % 2 == 0) ? vel_a : vel_b;
    launch(src_p, src_v, dst_p, dst_v);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    src_p = dst_p;
    src_v = dst_v;
  }
  return cudaSuccess;
}

template <bool FAST, bool PINS>
cudaError_t run(const float* params, const float* pos_in, const float* vel_in,
                const float* pin_mask, const float* pin_pos, float* pos_a,
                float* vel_a, float* pos_b, float* vel_b, int h, int w,
                int n_steps, cudaStream_t stream) {
  const dim3 block(kBlockW, kBlockH);
  const dim3 grid((w + kBlockW - 1) / kBlockW, (h + kBlockH - 1) / kBlockH);
  return ping_pong(pos_in, vel_in, pos_a, vel_a, pos_b, vel_b, n_steps,
                   [&](const float* sp, const float* sv, float* dp,
                       float* dv) {
                     substep_kernel<FAST, PINS><<<grid, block, 0, stream>>>(
                         params, sp, sv, pin_mask, pin_pos, dp, dv, h, w);
                   });
}

template <bool FAST, bool PINS>
cudaError_t run_batched(const float* params, const float* pos_in,
                        const float* vel_in, const float* pin_mask,
                        const float* pin_pos, float* pos_a, float* vel_a,
                        float* pos_b, float* vel_b, int n_worlds, int h,
                        int w, int n_steps, cudaStream_t stream) {
  const int tiles_x = (w + kBlockW - 1) / kBlockW;
  const int tiles_per_world = tiles_x * ((h + kBlockH - 1) / kBlockH);
  const int64_t blocks = static_cast<int64_t>(tiles_per_world) * n_worlds;
  if (blocks > 0x7fffffff) return cudaErrorInvalidConfiguration;
  const dim3 block(kBlockW, kBlockH);
  const dim3 grid(static_cast<unsigned>(blocks));
  return ping_pong(pos_in, vel_in, pos_a, vel_a, pos_b, vel_b, n_steps,
                   [&](const float* sp, const float* sv, float* dp,
                       float* dv) {
                     substep_kernel_batched<FAST, PINS>
                         <<<grid, block, 0, stream>>>(
                             params, sp, sv, pin_mask, pin_pos, dp, dv, h, w,
                             tiles_x, tiles_per_world);
                   });
}

template <bool PINS>
cudaError_t run_window(const float* params, const float* pos_in,
                       const float* vel_in, const float* pin_mask,
                       const float* pin_pos, float* pos_a, float* vel_a,
                       float* pos_b, float* vel_b, int n_windows, int h,
                       int w, int n_steps, const int* row0, int h_global,
                       cudaStream_t stream) {
  const dim3 block(kBlockW, kBlockH);
  const dim3 grid = window_grid(h, w, n_windows);
  const int64_t stride = 3 * static_cast<int64_t>(h) * w;
  return ping_pong(pos_in, vel_in, pos_a, vel_a, pos_b, vel_b, n_steps,
                   [&](const float* sp, const float* sv, float* dp,
                       float* dv) {
                     substep_kernel_window<PINS><<<grid, block, 0, stream>>>(
                         params, sp, sv, pin_mask, pin_pos, dp, dv, h, w,
                         stride, row0, h_global);
                   });
}

// The checks of the window entries: 1 to 65,535 windows (the grid's z
// extent), a grid of at least one row and a row0 array.
inline bool windows_ok(int n_windows, const int* row0, int h_global) {
  return n_windows >= 1 && n_windows <= 65535 && row0 != nullptr &&
         h_global >= 1;
}

// ---------------------------------------------------------------------------
// K1f: one substep with a force plane
// ---------------------------------------------------------------------------
//
// K1's gather body, one thread a particle, waits on a dozen neighbour
// loads and twelve edge forces in a row with ~16 warps an SM at 256^2.
// K1f spreads each particle over three warps instead: warp g of a row
// computes the edges of families 2g and 2g + 1 (each the spring the
// particle anchors and its reaction, gathered from device memory as K1
// does, all loads issued before the first edge), and warps 1 and 2 leave
// theirs in shared memory for warp 0, which sums all twelve in K1's order
// (`_FAMILIES`, +e then -reaction), adds the force plane and integrates.
// Three times the threads, a third of the chain each: ~46 warps an SM's
// worth at 256^2. The edges and the integration take the header's inline
// IEEE fast paths (`Checked`), and a thread that met an input outside them
// computes them again exactly, so every value is K1's and the plain
// version's. Measured on the H100 at 256^2 in the self-collision block
// (tools/kernel_ab.py, ten pairs in turns, PERF.md §6): 5.46 us of device
// time a launch against 5.92 for K1's body with the force plane; six
// groups of one family and an edge-once tile in shared memory measured
// slower than three groups.

using cloth::Checked;
using cloth::P6;

// 3 groups of 2 families over 4 rows of 32 particles: 12 warps a CTA, at
// most 85 registers a thread (two CTAs an SM; fewer spill).
constexpr int kGroups = 3, kForceCols = 32, kForceRows = 4;
constexpr int kForceThreads = 32 * kForceRows * kGroups;

// The force plane and the sorted copy of wpe_cloth_substep_with_force.
struct ForceIO {
  const float* __restrict__ fext;
  const int* __restrict__ inv;
  float* __restrict__ sp_out;
};

struct F3 {
  float x, y, z;
};

// Spring family F = (dr, dc, type) of `_FAMILIES` at compile time.
template <int F>
struct Fam {
  static constexpr int dr = F == 0 || F == 4 ? 0 : (F == 5 ? 2 : 1);
  static constexpr int dc =
      F == 1 || F == 5 ? 0 : (F == 3 ? -1 : (F == 4 ? 2 : 1));
  static constexpr int t = F / 2;
};

// The spring family F anchors at particle (r, c) (state p, index i) and
// its reaction, the spring anchored at (r - dr, c - dc), both from device
// memory; 0 where the grid does not hold both ends (cloth_substep.cuh
// `spring_force`'s masks). A spring that does not count is evaluated on
// the particle itself and dropped, without a branch. M: cloth::Exact<false>
// or Checked, whose slow flag is kept only for a spring that counts.
template <int F, class M>
__device__ __forceinline__ void family_edges(
    const float* __restrict__ prm, const float* __restrict__ pos,
    const float* __restrict__ vel, const P6& p, int r, int c, int i, int h,
    int w, F3& own, F3& react, bool& slow) {
  constexpr int dr = Fam<F>::dr, dc = Fam<F>::dc, t = Fam<F>::t;
  const int hw = h * w;
  const float k = prm[t], cd = prm[3 + t], rest = prm[6 + t];
  const bool ok = cloth::edge_ok<false>(r, c, h, w, dr, dc, 0, 0);
  const P6 q = cloth::load(pos, vel, ok ? i + dr * w + dc : i, hw);
  const int ar = r - dr, ac = c - dc;
  const bool aok = ar >= 0 && (dc >= 0 ? ac >= 0 : ac < w);
  const P6 a = cloth::load(pos, vel, aok ? ar * w + ac : i, hw);
  bool s = false, s2 = false;
  F3 e, x;
  cloth::edge<false>(p, q, k, cd, rest, e.x, e.y, e.z, cloth::make<M>(s));
  cloth::edge<false>(a, p, k, cd, rest, x.x, x.y, x.z, cloth::make<M>(s2));
  slow |= (ok && s) || (aok && s2);
  own = ok ? e : F3{0.0f, 0.0f, 0.0f};
  react = aok ? x : F3{0.0f, 0.0f, 0.0f};
}

// Families F0 and F0 + 1 of the particle: Checked, then again exactly if
// a spring that counts met a slow-path input.
template <int F0>
__device__ __forceinline__ void two_families(
    const float* __restrict__ prm, const float* __restrict__ pos,
    const float* __restrict__ vel, const P6& p, int r, int c, int i, int h,
    int w, F3* own, F3* react) {
  bool slow = false;
  family_edges<F0, Checked>(prm, pos, vel, p, r, c, i, h, w, own[0],
                            react[0], slow);
  family_edges<F0 + 1, Checked>(prm, pos, vel, p, r, c, i, h, w, own[1],
                                react[1], slow);
  if (slow) {
    family_edges<F0, cloth::Exact<false>>(prm, pos, vel, p, r, c, i, h, w,
                                          own[0], react[0], slow);
    family_edges<F0 + 1, cloth::Exact<false>>(prm, pos, vel, p, r, c, i, h,
                                              w, own[1], react[1], slow);
  }
}

// One substep of a kForceRows x kForceCols block of particles. blockIdx is
// the block's (column, row); warp (row, g) of the CTA computes families
// 2g, 2g + 1 of its row's particles, lane L column L. With io.inv the
// force plane is in the sorted order and particle i reads column inv[i];
// with io.sp_out the new positions are also written there.
template <bool PINS>
__global__ void __launch_bounds__(kForceThreads, 2)
    force_kernel(const float* __restrict__ prm, const float* __restrict__ pos,
                 const float* __restrict__ vel,
                 const float* __restrict__ pin_mask,
                 const float* __restrict__ pin_pos, const ForceIO io,
                 float* __restrict__ pos_out, float* __restrict__ vel_out,
                 int h, int w) {
  // the edges of warps 1 and 2: [group - 1][row][own, react of 2 families]
  __shared__ F3 s_e[kGroups - 1][kForceRows][4][32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int row = warp / kGroups, g = warp % kGroups;
  const int r0 = blockIdx.y * kForceRows + row;
  const int c0 = blockIdx.x * kForceCols + lane;
  const bool live = r0 < h && c0 < w;
  // a lane beyond the grid steps particle (0, 0) and stores nothing
  const int r = live ? r0 : 0, c = live ? c0 : 0;
  const int hw = h * w, i = r * w + c;
  // warp 0's force-plane entry, read early
  const int j = g == 0 && io.inv != nullptr ? io.inv[i] : i;
  const F3 fe = g == 0 ? F3{io.fext[j], io.fext[hw + j], io.fext[2 * hw + j]}
                       : F3{0.0f, 0.0f, 0.0f};
  const P6 p = cloth::load(pos, vel, i, hw);
  F3 own[2], react[2];
  if (g == 0) {  // g is the same for the whole warp
    two_families<0>(prm, pos, vel, p, r, c, i, h, w, own, react);
  } else {
    if (g == 1)
      two_families<2>(prm, pos, vel, p, r, c, i, h, w, own, react);
    else
      two_families<4>(prm, pos, vel, p, r, c, i, h, w, own, react);
    s_e[g - 1][row][0][lane] = own[0];
    s_e[g - 1][row][1][lane] = react[0];
    s_e[g - 1][row][2][lane] = own[1];
    s_e[g - 1][row][3][lane] = react[1];
  }
  __syncthreads();
  if (g > 0 || !live) return;
  float fx = 0.0f, fy = 0.0f, fz = 0.0f;
#pragma unroll
  for (int f = 0; f < 6; ++f) {
    const F3 e = f < 2 ? own[f] : s_e[f / 2 - 1][row][2 * (f % 2)][lane];
    const F3 x = f < 2 ? react[f] : s_e[f / 2 - 1][row][2 * (f % 2) + 1][lane];
    fx = fx + e.x;
    fy = fy + e.y;
    fz = fz + e.z;
    fx = fx - x.x;
    fy = fy - x.y;
    fz = fz - x.z;
  }
  fx = fx + fe.x;
  fy = fy + fe.y;
  fz = fz + fe.z;
  bool slow = false;
  P6 q = cloth::integrate<false, PINS>(prm, p, fx, fy, fz, pin_mask, pin_pos,
                                       i, hw, Checked{slow});
  if (slow)
    q = cloth::integrate<false, PINS>(prm, p, fx, fy, fz, pin_mask, pin_pos,
                                      i, hw);
  pos_out[i] = q.x;
  pos_out[hw + i] = q.y;
  pos_out[2 * hw + i] = q.z;
  vel_out[i] = q.vx;
  vel_out[hw + i] = q.vy;
  vel_out[2 * hw + i] = q.vz;
  if (io.sp_out != nullptr) {
    io.sp_out[j] = q.x;
    io.sp_out[hw + j] = q.y;
    io.sp_out[2 * hw + j] = q.z;
  }
}

}  // namespace

// n_steps fused substeps of one world. Substep s writes buffer a when s is
// even and b when it is odd, so the result is in a for odd n_steps and in
// b for even. pos_in/vel_in are only read. params is f32 [16]; pin_mask is
// f32 [h, w] (pinned where != 0) and pin_pos f32 [3, h, w]; both are
// ignored when use_pins is 0.
extern "C" int wpe_cloth_multi_step(const float* params, const float* pos_in,
                                    const float* vel_in,
                                    const float* pin_mask,
                                    const float* pin_pos, float* pos_a,
                                    float* vel_a, float* pos_b, float* vel_b,
                                    int h, int w, int n_steps, int use_pins,
                                    int fast_math, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (fast_math) {
    return use_pins ? run<true, true>(params, pos_in, vel_in, pin_mask,
                                      pin_pos, pos_a, vel_a, pos_b, vel_b, h,
                                      w, n_steps, s)
                    : run<true, false>(params, pos_in, vel_in, pin_mask,
                                       pin_pos, pos_a, vel_a, pos_b, vel_b, h,
                                       w, n_steps, s);
  }
  return use_pins ? run<false, true>(params, pos_in, vel_in, pin_mask,
                                     pin_pos, pos_a, vel_a, pos_b, vel_b, h,
                                     w, n_steps, s)
                  : run<false, false>(params, pos_in, vel_in, pin_mask,
                                      pin_pos, pos_a, vel_a, pos_b, vel_b, h,
                                      w, n_steps, s);
}

// The same for n_worlds independent worlds in one launch per substep:
// params f32 [n_worlds, 16] (one row per world), pos/vel and the buffers
// f32 [n_worlds, 3, h, w], pin_mask f32 [n_worlds, h, w], pin_pos f32
// [n_worlds, 3, h, w].
extern "C" int wpe_cloth_multi_step_batched(
    const float* params, const float* pos_in, const float* vel_in,
    const float* pin_mask, const float* pin_pos, float* pos_a, float* vel_a,
    float* pos_b, float* vel_b, int n_worlds, int h, int w, int n_steps,
    int use_pins, int fast_math, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (fast_math) {
    return use_pins
               ? run_batched<true, true>(params, pos_in, vel_in, pin_mask,
                                         pin_pos, pos_a, vel_a, pos_b, vel_b,
                                         n_worlds, h, w, n_steps, s)
               : run_batched<true, false>(params, pos_in, vel_in, pin_mask,
                                          pin_pos, pos_a, vel_a, pos_b, vel_b,
                                          n_worlds, h, w, n_steps, s);
  }
  return use_pins
             ? run_batched<false, true>(params, pos_in, vel_in, pin_mask,
                                        pin_pos, pos_a, vel_a, pos_b, vel_b,
                                        n_worlds, h, w, n_steps, s)
             : run_batched<false, false>(params, pos_in, vel_in, pin_mask,
                                         pin_pos, pos_a, vel_a, pos_b, vel_b,
                                         n_worlds, h, w, n_steps, s);
}

// n_states - 1 exact substeps of one world along the trajectory traj (see
// `trace` above); params f32 [16], pin_mask f32 [h, w], pin_pos f32
// [3, h, w] (ignored when use_pins is 0).
extern "C" int wpe_cloth_trace(const float* params, const float* pin_mask,
                               const float* pin_pos, float* traj, int h,
                               int w, int n_states, int use_pins,
                               void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  return use_pins ? trace<true, false>(params, pin_mask, pin_pos, traj, 1, h,
                                       w, n_states, nullptr, 0, s)
                  : trace<false, false>(params, pin_mask, pin_pos, traj, 1,
                                        h, w, n_states, nullptr, 0, s);
}

// The same on a batch of n_windows row windows of one shape with K1w's
// launches, one a substep for the whole batch: traj f32
// [n_states, n_windows, 6, h, w] (halo rows included), row0, h_global,
// pin_mask and pin_pos as for wpe_cloth_multi_step_window.
extern "C" int wpe_cloth_trace_window(const float* params,
                                      const float* pin_mask,
                                      const float* pin_pos, float* traj,
                                      int n_windows, int h, int w,
                                      int n_states, const int* row0,
                                      int h_global, int use_pins,
                                      void* stream) {
  if (!windows_ok(n_windows, row0, h_global)) return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  return use_pins ? trace<true, true>(params, pin_mask, pin_pos, traj,
                                      n_windows, h, w, n_states, row0,
                                      h_global, s)
                  : trace<false, true>(params, pin_mask, pin_pos, traj,
                                       n_windows, h, w, n_states, row0,
                                       h_global, s);
}

// One exact substep of one world with an external force plane added after
// the springs (K1f): pos_in/vel_in are only read and the result is written
// to pos_out/vel_out; params and pins as for wpe_cloth_multi_step. With inv
// null, fext is f32 [3, h, w] in grid order and sp_out must be null. With
// inv (int32 [h*w], a permutation: particle i's column of the sorted
// order), fext is f32 [3, h*w] in that sorted order, particle i reading
// column inv[i], and sp_out, if not null, receives the new positions in the
// same order, sp_out[:, inv[i]] = pos_out[:, i] (f32 [3, h*w]).
extern "C" int wpe_cloth_substep_with_force(
    const float* params, const float* pos_in, const float* vel_in,
    const float* pin_mask, const float* pin_pos, const float* fext,
    const int* inv, float* pos_out, float* vel_out, float* sp_out, int h,
    int w, int use_pins, void* stream) {
  if (fext == nullptr || (inv == nullptr && sp_out != nullptr))
    return cudaErrorInvalidValue;
  const ForceIO io{fext, inv, sp_out};
  auto s = static_cast<cudaStream_t>(stream);
  const dim3 grid((w + kForceCols - 1) / kForceCols,
                  (h + kForceRows - 1) / kForceRows);
  auto kernel = use_pins ? force_kernel<true> : force_kernel<false>;
  kernel<<<grid, kForceThreads, 0, s>>>(params, pos_in, vel_in, pin_mask,
                                        pin_pos, io, pos_out, vel_out, h, w);
  return static_cast<int>(cudaGetLastError());
}

// n_steps exact substeps of a batch of n_windows row windows of one shape
// (K1w), one launch a substep for the whole batch: pos_in/vel_in and the
// buffers f32 [n_windows, 3, h, w], window b of a grid h_global rows high
// whose local row 0 is global row row0[b] (row0: a device array of
// n_windows int32; < 0 on the top shard); pin_mask f32 [n_windows, h, w]
// and pin_pos f32 [n_windows, 3, h, w] (a window without pins has a zero
// mask), ignored when use_pins is 0; the result's place as for
// wpe_cloth_multi_step. Every row is stepped, the halo rows too: the
// caller slices off the rows the halo's staleness has reached.
extern "C" int wpe_cloth_multi_step_window(
    const float* params, const float* pos_in, const float* vel_in,
    const float* pin_mask, const float* pin_pos, float* pos_a, float* vel_a,
    float* pos_b, float* vel_b, int n_windows, int h, int w, int n_steps,
    const int* row0, int h_global, int use_pins, void* stream) {
  if (!windows_ok(n_windows, row0, h_global)) return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  return use_pins ? run_window<true>(params, pos_in, vel_in, pin_mask,
                                     pin_pos, pos_a, vel_a, pos_b, vel_b,
                                     n_windows, h, w, n_steps, row0,
                                     h_global, s)
                  : run_window<false>(params, pos_in, vel_in, pin_mask,
                                      pin_pos, pos_a, vel_a, pos_b, vel_b,
                                      n_windows, h, w, n_steps, row0,
                                      h_global, s);
}
