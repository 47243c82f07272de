// The per-pixel chains of the instanced-sphere render around the raster,
// for Hopper (sm_90a): the primary rays before it (`wpe_pixel_rays`), and
// after it the flat-colour shade, the depth-tested composite over a
// framebuffer and the uint8 cast (`wpe_flat_composite_rgb8`).
//
// Replaces: no Pallas kernel. On the TPU, XLA fused these chains under
// `jit` (wgpu_physics_engine_tpu/render/camera.py `pixel_rays`,
// render/raster.py `draw_instanced_spheres` and `_composite`, and the cast
// of parallel/datagen.py `step_and_render`). Eager PyTorch runs them as
// some 65 launches for a chunk of worlds, each a full fp32 pass over
// [B, 3, H, W] or [B, H, W] planes in device memory, many broadcasting.
//
// What bounds them on the H100: bytes. The rays write 12 B a pixel
// (dirs [B?, 3, H, W] fp32). The epilogue reads the raster's tmin (4 B) and
// winner (4 B) and the framebuffer's depth (4 B) and colour (12 B), and
// writes 3 B of uint8: 27 B a pixel, the directions recomputed in registers
// and not read. For a datagen chunk of 1,024 worlds at 256x256 (67.1 M
// pixels) at 3.35 TB/s: 0.24 ms and 0.54 ms. Per pixel the rays cost ~20
// flops, a square root and three divisions, far under the bytes.
//
// Design:
//  * Four consecutive pixels of one world a thread, 256 threads a CTA, one
//    1-D grid over every world's quads: 16-byte loads and stores where the
//    planes allow it (h*w a multiple of 4 and every plane 16-byte aligned),
//    else the same thread's four pixels one by one (a scalar tail inside
//    the kernel, never another route). A thread reads its world's camera
//    once (the view's rotation, tan(fovy/2), the aspect; the eye and the
//    projection's depth row in the epilogue): one world spans 64 CTAs at
//    256x256, so the reads are L1 broadcasts.
//  * `ray` is the one direction function of both kernels, so the epilogue's
//    recomputed ray has the bits of the rays the raster read. It rounds
//    where the torch expression of render/camera.py `pixel_rays_plain` does
//    on the card: the pixel-centre coordinate (x + 0.5) * (1/w) * 2 - 1
//    (torch's CUDA division by a Python number multiplies by its float
//    reciprocal), vx = (j * tan) * aspect and vy = i * tan, rot^T (vx, vy,
//    -1) one product and one sum at a time in torch's order, the squared
//    norm summed (d0^2 + d1^2) + d2^2 as torch's sum over a size-3 axis
//    does, then an IEEE square root and three IEEE divisions.
//  * The epilogue computes only what the flat colour needs: view z of the
//    hit, as `eye + t * dir`, `- eye` and the third row of `_rotate` give
//    it, then `_ndc_z` and the Less test against the framebuffer's depth;
//    a pixel that misses or loses takes the framebuffer's colour. Then
//    clamp to [0, 1] (NaN kept, as torch's clamp), * 255 + 0.5, and the
//    cast through int64 that torch's float -> uint8 conversion makes. No
//    fp32 framebuffer, no view-space plane and no [.., 3] temporary reaches
//    device memory; the flat colour comes in as three float arguments.
// Built with -fmad=false, IEEE division and square root: both kernels equal
// their plain torch versions on the card bit for bit.

#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kPix = 4;  // pixels a thread

inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// One world's camera as the rays need it: view[:3, :3] row-major (world ->
// view), tan(fovy / 2) and the aspect.
struct Cam {
  float r[9];
  float tan_half;
  float aspect;
};

__device__ __forceinline__ Cam load_cam(const float* __restrict__ view,
                                        const float* __restrict__ tan_half,
                                        const float* __restrict__ aspect,
                                        int64_t world) {
  const float* v = view + 16 * world;
  Cam c;
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int k = 0; k < 3; ++k) c.r[3 * i + k] = v[4 * i + k];
  c.tan_half = tan_half[world];
  c.aspect = aspect[world];
  return c;
}

// The normalized world-space direction of pixel (y, x): render/camera.py
// `pixel_rays_plain`, rounding for rounding (see the design note).
__device__ __forceinline__ void ray(const Cam& c, float inv_h, float inv_w,
                                    int y, int x, float d[3]) {
  const float j = (static_cast<float>(x) + 0.5f) * inv_w * 2.0f - 1.0f;
  const float i = 1.0f - (static_cast<float>(y) + 0.5f) * inv_h * 2.0f;
  const float vx = j * c.tan_half * c.aspect;
  const float vy = i * c.tan_half;
#pragma unroll
  for (int k = 0; k < 3; ++k)
    d[k] = c.r[k] * vx + c.r[3 + k] * vy + c.r[6 + k] * -1.0f;
  const float norm = sqrtf(d[0] * d[0] + d[1] * d[1] + d[2] * d[2]);
#pragma unroll
  for (int k = 0; k < 3; ++k) d[k] = d[k] / norm;
}

template <bool VEC>
__global__ void __launch_bounds__(kThreads)
    wpe_pixel_rays_kernel(const float* __restrict__ view,
                          const float* __restrict__ tan_half,
                          const float* __restrict__ aspect,
                          float* __restrict__ dirs, int64_t n_quads,
                          int64_t quads_per_world, int h, int w, float inv_h,
                          float inv_w) {
  const int64_t q = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (q >= n_quads) return;
  const int64_t world = q / quads_per_world;
  const int64_t hw = static_cast<int64_t>(h) * w;
  const int64_t p0 = (q - world * quads_per_world) * kPix;
  const Cam c = load_cam(view, tan_half, aspect, world);
  float d[kPix][3];
#pragma unroll
  for (int e = 0; e < kPix; ++e) {
    const int64_t p = p0 + e;
    if (VEC || p < hw)
      ray(c, inv_h, inv_w, static_cast<int>(p / w), static_cast<int>(p % w),
          d[e]);
  }
  float* out = dirs + world * 3 * hw + p0;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    if (VEC) {
      *reinterpret_cast<float4*>(out + k * hw) =
          make_float4(d[0][k], d[1][k], d[2][k], d[3][k]);
    } else {
#pragma unroll
      for (int e = 0; e < kPix; ++e)
        if (p0 + e < hw) out[k * hw + e] = d[e][k];
    }
  }
}

// torch.clamp(c, 0, 1) (NaN kept) * 255 + 0.5, then torch's float -> uint8
// conversion (through int64).
__device__ __forceinline__ unsigned char to_u8(float c) {
  if (!isnan(c)) c = fminf(fmaxf(c, 0.0f), 1.0f);
  return static_cast<unsigned char>(static_cast<int64_t>(c * 255.0f + 0.5f));
}

// Whether a pixel the raster hit at distance t wins the depth test (Less)
// against the framebuffer's depth: `_composite` on the flat colour.
__device__ __forceinline__ bool wins(const Cam& c, const float eye[3],
                                     float p22, float p23, float inv_h,
                                     float inv_w, int y, int x, float t,
                                     float depth) {
  float d[3];
  ray(c, inv_h, inv_w, y, x, d);
  float q[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float p = eye[k] + t * d[k];  // p_world
    q[k] = p - eye[k];                  // p_world - eye
  }
  const float vz = c.r[6] * q[0] + c.r[7] * q[1] + c.r[8] * q[2];
  const float zn = (p22 * vz + p23) / -vz;  // _ndc_z
  return zn < depth;
}

template <bool VEC>
__global__ void __launch_bounds__(kThreads) wpe_flat_composite_rgb8_kernel(
    const float* __restrict__ tmin, const int* __restrict__ inst,
    const float* __restrict__ color, const float* __restrict__ depth,
    const float* __restrict__ view, const float* __restrict__ eye,
    const float* __restrict__ proj, const float* __restrict__ tan_half,
    const float* __restrict__ aspect, float flat_r, float flat_g,
    float flat_b, unsigned char* __restrict__ out, int64_t n_quads,
    int64_t quads_per_world, int h, int w, float inv_h, float inv_w) {
  const int64_t q = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (q >= n_quads) return;
  const int64_t world = q / quads_per_world;
  const int64_t hw = static_cast<int64_t>(h) * w;
  const int64_t p0 = (q - world * quads_per_world) * kPix;
  const int64_t base = world * hw + p0;  // the quad's first pixel
  const Cam c = load_cam(view, tan_half, aspect, world);
  const float e[3] = {eye[3 * world], eye[3 * world + 1], eye[3 * world + 2]};
  const float p22 = proj[16 * world + 10];
  const float p23 = proj[16 * world + 11];
  const float flat[3] = {flat_r, flat_g, flat_b};

  int id[kPix];
  float t[kPix], z[kPix], rgb[kPix * 3];
  if (VEC) {
    const int4 i4 = *reinterpret_cast<const int4*>(inst + base);
    const float4 t4 = *reinterpret_cast<const float4*>(tmin + base);
    const float4 z4 = *reinterpret_cast<const float4*>(depth + base);
    id[0] = i4.x, id[1] = i4.y, id[2] = i4.z, id[3] = i4.w;
    t[0] = t4.x, t[1] = t4.y, t[2] = t4.z, t[3] = t4.w;
    z[0] = z4.x, z[1] = z4.y, z[2] = z4.z, z[3] = z4.w;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const float4 c4 = *reinterpret_cast<const float4*>(color + 3 * base +
                                                         4 * k);
      rgb[4 * k] = c4.x, rgb[4 * k + 1] = c4.y, rgb[4 * k + 2] = c4.z;
      rgb[4 * k + 3] = c4.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < kPix; ++i) {
      const bool in = p0 + i < hw;
      id[i] = in ? inst[base + i] : -1;
      t[i] = in ? tmin[base + i] : 0.0f;
      z[i] = in ? depth[base + i] : 0.0f;
#pragma unroll
      for (int k = 0; k < 3; ++k)
        rgb[3 * i + k] = in ? color[3 * (base + i) + k] : 0.0f;
    }
  }

  unsigned char o[kPix * 3];
#pragma unroll
  for (int i = 0; i < kPix; ++i) {
    const int64_t p = p0 + i;
    const bool win = id[i] >= 0 &&
                     wins(c, e, p22, p23, inv_h, inv_w,
                          static_cast<int>(p / w), static_cast<int>(p % w),
                          t[i], z[i]);
#pragma unroll
    for (int k = 0; k < 3; ++k)
      o[3 * i + k] = to_u8(win ? flat[k] : rgb[3 * i + k]);
  }

  unsigned char* dst = out + 3 * base;
  if (VEC) {
    uint32_t word[3];
#pragma unroll
    for (int k = 0; k < 3; ++k)
      word[k] = static_cast<uint32_t>(o[4 * k]) |
                static_cast<uint32_t>(o[4 * k + 1]) << 8 |
                static_cast<uint32_t>(o[4 * k + 2]) << 16 |
                static_cast<uint32_t>(o[4 * k + 3]) << 24;
    uint32_t* d32 = reinterpret_cast<uint32_t*>(dst);
    d32[0] = word[0], d32[1] = word[1], d32[2] = word[2];
  } else {
#pragma unroll
    for (int i = 0; i < kPix; ++i)
      if (p0 + i < hw)
#pragma unroll
        for (int k = 0; k < 3; ++k) dst[3 * i + k] = o[3 * i + k];
  }
}

// The grid over every world's quads; false if it does not fit a launch.
bool grid(int n_worlds, int h, int w, int64_t* quads_per_world,
          int64_t* n_quads, unsigned* blocks) {
  const int64_t hw = static_cast<int64_t>(h) * w;
  *quads_per_world = (hw + kPix - 1) / kPix;
  *n_quads = *quads_per_world * n_worlds;
  const int64_t b = (*n_quads + kThreads - 1) / kThreads;
  *blocks = static_cast<unsigned>(b);
  return b <= 0x7fffffff;
}

}  // namespace

// dirs [n_worlds, 3, h, w] of the cameras view [n_worlds, 4, 4], tan_half
// and aspect [n_worlds] (all fp32, contiguous).
extern "C" int wpe_pixel_rays(const float* view, const float* tan_half,
                              const float* aspect, float* dirs, int n_worlds,
                              int h, int w, void* stream) {
  int64_t qpw, n_quads;
  unsigned blocks;
  if (!grid(n_worlds, h, w, &qpw, &n_quads, &blocks))
    return cudaErrorInvalidConfiguration;
  if (n_quads == 0) return cudaSuccess;
  const float inv_h = 1.0f / static_cast<float>(h);
  const float inv_w = 1.0f / static_cast<float>(w);
  const bool vec = static_cast<int64_t>(h) * w % kPix == 0 && aligned16(dirs);
  auto s = static_cast<cudaStream_t>(stream);
  if (vec)
    wpe_pixel_rays_kernel<true><<<blocks, kThreads, 0, s>>>(
        view, tan_half, aspect, dirs, n_quads, qpw, h, w, inv_h, inv_w);
  else
    wpe_pixel_rays_kernel<false><<<blocks, kThreads, 0, s>>>(
        view, tan_half, aspect, dirs, n_quads, qpw, h, w, inv_h, inv_w);
  return static_cast<int>(cudaGetLastError());
}

// out [n_worlds, h, w, 3] uint8 from the raster's tmin and inst [n_worlds,
// h, w], the framebuffer's color [n_worlds, h, w, 3] and depth [n_worlds,
// h, w], and the cameras: view and proj [n_worlds, 4, 4], eye [n_worlds,
// 3], tan_half and aspect [n_worlds] (fp32 but inst int32; contiguous).
extern "C" int wpe_flat_composite_rgb8(
    const float* tmin, const int* inst, const float* color,
    const float* depth, const float* view, const float* eye,
    const float* proj, const float* tan_half, const float* aspect,
    float flat_r, float flat_g, float flat_b, unsigned char* out,
    int n_worlds, int h, int w, void* stream) {
  int64_t qpw, n_quads;
  unsigned blocks;
  if (!grid(n_worlds, h, w, &qpw, &n_quads, &blocks))
    return cudaErrorInvalidConfiguration;
  if (n_quads == 0) return cudaSuccess;
  const float inv_h = 1.0f / static_cast<float>(h);
  const float inv_w = 1.0f / static_cast<float>(w);
  const bool vec = static_cast<int64_t>(h) * w % kPix == 0 &&
                   aligned16(tmin) && aligned16(inst) && aligned16(color) &&
                   aligned16(depth) &&
                   (reinterpret_cast<uintptr_t>(out) & 3) == 0;
  auto s = static_cast<cudaStream_t>(stream);
  if (vec)
    wpe_flat_composite_rgb8_kernel<true><<<blocks, kThreads, 0, s>>>(
        tmin, inst, color, depth, view, eye, proj, tan_half, aspect, flat_r,
        flat_g, flat_b, out, n_quads, qpw, h, w, inv_h, inv_w);
  else
    wpe_flat_composite_rgb8_kernel<false><<<blocks, kThreads, 0, s>>>(
        tmin, inst, color, depth, view, eye, proj, tan_half, aspect, flat_r,
        flat_g, flat_b, out, n_quads, qpw, h, w, inv_h, inv_w);
  return static_cast<int>(cudaGetLastError());
}
