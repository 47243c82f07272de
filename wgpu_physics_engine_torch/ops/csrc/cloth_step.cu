// Fused cloth substeps for Hopper (sm_90a): one world (K1), one world with
// an external force plane (K1f), a batch of independent worlds (K5) and a
// row window of a larger grid (K1w). All run the per-particle body of
// cloth_substep.cuh, one thread per particle, one launch per substep.
//
// Replaces: wgpu_physics_engine_tpu/ops/cloth_pallas.py
//   * `_kernel` (K1), the single-world fused substeps, with
//     `wpe_cloth_multi_step`;
//   * `_kernel(extra_force=True)` (K1f, reached through
//     `substep_with_force` :682 -> :708), one substep with a per-particle
//     external force added after the springs (the cloth self-collision pair
//     forces), with `wpe_cloth_substep_with_force`: the same body with one
//     more force plane read, 12 bytes a particle more than K1;
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
//     spring; what bounds K1 bounds it. JAX sends a window above its VMEM
//     budget to the XLA stencil; any window size launches K1w here.
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

template <bool FAST, bool PINS, bool EXT = false>
__global__ void __launch_bounds__(kBlockW * kBlockH)
    substep_kernel(const float* __restrict__ prm,
                   const float* __restrict__ pos,
                   const float* __restrict__ vel,
                   const float* __restrict__ pin_mask,
                   const float* __restrict__ pin_pos,
                   const float* __restrict__ fext,
                   float* __restrict__ pos_out, float* __restrict__ vel_out,
                   int h, int w) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  const int r = blockIdx.y * blockDim.y + threadIdx.y;
  if (r >= h || c >= w) return;
  cloth::substep_particle<FAST, PINS, EXT>(prm, pos, vel, pin_mask, pin_pos,
                                           fext, pos_out, vel_out, r, c, h,
                                           w);
}

// K1w: one substep of a row window whose local row 0 is global row `row0`
// of a grid `h_global` rows high (see cloth_substep.cuh `edge_ok`).
template <bool PINS>
__global__ void __launch_bounds__(kBlockW * kBlockH)
    substep_kernel_window(const float* __restrict__ prm,
                          const float* __restrict__ pos,
                          const float* __restrict__ vel,
                          const float* __restrict__ pin_mask,
                          const float* __restrict__ pin_pos,
                          float* __restrict__ pos_out,
                          float* __restrict__ vel_out, int h, int w,
                          int row0, int h_global) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  const int r = blockIdx.y * blockDim.y + threadIdx.y;
  if (r >= h || c >= w) return;
  cloth::substep_particle<false, PINS, false, true>(
      prm, pos, vel, pin_mask, pin_pos, nullptr, pos_out, vel_out, r, c, h, w,
      row0, h_global);
}

// The trajectory of one world for the backward pass (ops/cloth_grad_kernel.py):
// traj is f32 [n_states, 6, h, w] (pos planes then vel planes) with the
// start state in traj[0]; substep s reads traj[s] and writes traj[s + 1],
// one launch of the exact K1 kernel each, so traj[s] equals s substeps of
// wpe_cloth_multi_step bit for bit. Replaces `_trace_kernel` (K7) and
// `_trace_kernel_stream` (K9) of wgpu_physics_engine_tpu/ops/
// cloth_pallas_grad.py, which rerun K1's body for the same purpose.
template <bool PINS>
cudaError_t trace(const float* params, const float* pin_mask,
                  const float* pin_pos, float* traj, int h, int w,
                  int n_states, cudaStream_t stream) {
  const dim3 block(kBlockW, kBlockH);
  const dim3 grid((w + kBlockW - 1) / kBlockW, (h + kBlockH - 1) / kBlockH);
  const int64_t plane = static_cast<int64_t>(h) * w;
  for (int s = 0; s + 1 < n_states; ++s) {
    const float* src = traj + 6 * plane * s;
    float* dst = traj + 6 * plane * (s + 1);
    substep_kernel<false, PINS><<<grid, block, 0, stream>>>(
        params, src, src + 3 * plane, pin_mask, pin_pos, nullptr, dst,
        dst + 3 * plane, h, w);
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
      PINS ? pin_pos + state : pin_pos, nullptr, pos_out + state,
      vel_out + state, r, c, h, w);
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
                         params, sp, sv, pin_mask, pin_pos, nullptr, dp, dv,
                         h, w);
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
                       float* pos_b, float* vel_b, int h, int w, int n_steps,
                       int row0, int h_global, cudaStream_t stream) {
  const dim3 block(kBlockW, kBlockH);
  const dim3 grid((w + kBlockW - 1) / kBlockW, (h + kBlockH - 1) / kBlockH);
  return ping_pong(pos_in, vel_in, pos_a, vel_a, pos_b, vel_b, n_steps,
                   [&](const float* sp, const float* sv, float* dp,
                       float* dv) {
                     substep_kernel_window<PINS><<<grid, block, 0, stream>>>(
                         params, sp, sv, pin_mask, pin_pos, dp, dv, h, w,
                         row0, h_global);
                   });
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
  return use_pins
             ? trace<true>(params, pin_mask, pin_pos, traj, h, w, n_states, s)
             : trace<false>(params, pin_mask, pin_pos, traj, h, w, n_states,
                            s);
}

// One exact substep of one world with the external force plane fext f32
// [3, h, w] added after the springs (K1f): pos_in/vel_in are only read, the
// result is written to pos_out/vel_out; params and pins as for
// wpe_cloth_multi_step.
extern "C" int wpe_cloth_substep_with_force(
    const float* params, const float* pos_in, const float* vel_in,
    const float* pin_mask, const float* pin_pos, const float* fext,
    float* pos_out, float* vel_out, int h, int w, int use_pins,
    void* stream) {
  if (fext == nullptr) return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  const dim3 block(kBlockW, kBlockH);
  const dim3 grid((w + kBlockW - 1) / kBlockW, (h + kBlockH - 1) / kBlockH);
  auto kernel = use_pins ? substep_kernel<false, true, true>
                         : substep_kernel<false, false, true>;
  kernel<<<grid, block, 0, s>>>(params, pos_in, vel_in, pin_mask, pin_pos,
                                fext, pos_out, vel_out, h, w);
  return static_cast<int>(cudaGetLastError());
}

// n_steps exact substeps of the row window (K1w) pos_in/vel_in f32 [3, h, w]
// of a grid h_global rows high whose local row 0 is global row row0 (< 0 on
// the top shard); buffers, pins and the result's place as for
// wpe_cloth_multi_step. Every row is stepped, the halo rows too: the caller
// slices off the rows the halo's staleness has reached.
extern "C" int wpe_cloth_multi_step_window(
    const float* params, const float* pos_in, const float* vel_in,
    const float* pin_mask, const float* pin_pos, float* pos_a, float* vel_a,
    float* pos_b, float* vel_b, int h, int w, int n_steps, int row0,
    int h_global, int use_pins, void* stream) {
  if (h_global < 1) return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  return use_pins ? run_window<true>(params, pos_in, vel_in, pin_mask,
                                     pin_pos, pos_a, vel_a, pos_b, vel_b, h,
                                     w, n_steps, row0, h_global, s)
                  : run_window<false>(params, pos_in, vel_in, pin_mask,
                                      pin_pos, pos_a, vel_a, pos_b, vel_b, h,
                                      w, n_steps, row0, h_global, s);
}
