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
// Design: a CTA takes `cta` consecutive sorted slots of one rebuild block
// (cta divides the block) with L lanes a slot. Sorted order keeps a
// block's windows inside its two slabs. Two walks, picked by the candidate
// set (`ops/granular_kernel.py` `walk_geometry`):
//   * staged (a thin set, 3 groups of long windows): group by group, the
//     CTA stages in shared memory, with coalesced loads, the part of slab A
//     (and of slab B when the block needs it, a CTA-uniform test) that its
//     windows reach (positions, and for K12 the tangents beside them): in
//     CIV mode a window's ends grow with the sorted cid, so the CTA's first
//     and last slots bound that part without a reduction. A window of
//     ~10^3 candidates reads each staged slot many times;
//   * direct (the full set, 9 groups of ~6 candidates each): nothing is
//     staged and nothing synchronizes; each slot reads its candidates from
//     global memory. Staging cost the full set up to 18 dependent round
//     trips to L2 a CTA, each between two barriers, around ~6 candidates of
//     walk; read directly, the sorted positions (12 MB at 1M) stay in L2,
//     neighbouring slots' windows overlap in L1 and the warps of a CTA
//     never wait on each other. What a slot still waits on is latency, so
//     it reads kDirectBatch candidates before it computes any and reads
//     the next group's window while it walks this one. The CTA may be any
//     divisor of the block (the CTA size measured the same from 32 to 128).
// The L lanes of a slot walk
// its window in stride (lane l takes candidates l, l + L, ...), each with
// its own double sums; a fixed butterfly of shuffles merges the L partial
// sums (every lane ends with the same bits), and the group's sum is
// rounded once. L comes from the candidate set (`ops/granular_kernel.py`
// `lanes`): a thin set, whose windows run over whole z-rows of cells
// (~10^3 candidates on the self-colliding 256^2 cloth), takes as many
// lanes as fill the card's resident threads with its slots (4 for the
// cloth's 65,536 slots, 1 for a pile of 1M); the full CIV set (9 short
// windows, ~6 candidates each) keeps one lane, a thread a slot. Sums follow
// K10's order: each group's A sum added to the A total, each group's B sum
// to the B total, then A + B. A group's sum is accumulated in double and
// rounded once (in a dense pile the float sums of kernel and plain
// version, taken in different orders, drift apart by 1e-4 in velocity
// over a 16-substep block), so it does not depend on the order of its
// terms but for a rounding tie; built with -fmad=false and IEEE sqrt and
// divide, so each kernel equals its plain version but for such ties.
// The slot itself is a candidate of its own window and is not skipped:
// its d2 is 0, which fails the touching test.

#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "common.cuh"

namespace {

constexpr int kMaxGroups = 9;

struct Groups {
  int lo[kMaxGroups];
  int hi[kMaxGroups];
};

// Per group, the part of slab A and of slab B that a CTA stages: [lo, hi)
// each (empty where lo >= hi).
struct Spans {
  int v[kMaxGroups][4];
};

__device__ __forceinline__ int clampi(int x, int lo, int hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

// The lanes of a partial last warp (a CTA of cta * L threads need not fill
// its last warp): the mask of the warp-wide shuffles.
__device__ __forceinline__ unsigned warp_lanes() {
  const unsigned left = blockDim.x - (threadIdx.x & ~31u);
  return left >= 32 ? 0xffffffffu : (1u << left) - 1u;
}

// Cooperative copy of slots [o, o + len) of the three planes of `src`
// into the shared planes sx, sy, sz (slots past n are left unset: no window
// reaches them); with JVP also the tangent planes of `tan` into tx, ty, tz.
template <bool JVP>
__device__ __forceinline__ void stage(const float* __restrict__ src,
                                      const float* __restrict__ tan,
                                      int64_t n, int o, int len, float* sx,
                                      float* sy, float* sz, float* tx,
                                      float* ty, float* tz) {
  for (int k = threadIdx.x; k < len; k += blockDim.x) {
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
// (inside the staged span starting at o) on a particle at p with tangent
// u, lane `lane` of L taking every L-th slot. Each term is rounded to float
// as in the plain version; each lane sums its terms in double, the L
// partial sums merge in a fixed butterfly (every lane of `mask` calls
// this, an empty range where it owns no particle) and the result is
// rounded once.
template <bool JVP, int L>
__device__ __forceinline__ void pair_sums(
    unsigned mask, int lane, const float p[3], const float u[3], int lo,
    int hi, int o, const float* sx, const float* sy, const float* sz,
    const float* tx, const float* ty, const float* tz, float md, float md2,
    float kc, float f[3], float t[3]) {
  double g0 = 0.0, g1 = 0.0, g2 = 0.0;
  double h0 = 0.0, h1 = 0.0, h2 = 0.0;
  for (int j = lo + lane; j < hi; j += L) {
    const float dx = p[0] - sx[j - o];
    const float dy = p[1] - sy[j - o];
    const float dz = p[2] - sz[j - o];
    const float d2 = dx * dx + dy * dy + dz * dz;
    if (d2 < md2 && d2 > 1e-12f) {
      const float inv = 1.0f / sqrtf(d2);
      const float w = kc * (md * inv - 1.0f);
      g0 += static_cast<double>(w * dx);
      g1 += static_cast<double>(w * dy);
      g2 += static_cast<double>(w * dz);
      if (JVP) {
        const float dux = u[0] - tx[j - o];
        const float duy = u[1] - ty[j - o];
        const float duz = u[2] - tz[j - o];
        const float dot = dx * dux + dy * duy + dz * duz;
        const float g = kc * md * inv * inv * inv * dot;
        h0 += static_cast<double>(w * dux - g * dx);
        h1 += static_cast<double>(w * duy - g * dy);
        h2 += static_cast<double>(w * duz - g * dz);
      }
    }
  }
#pragma unroll
  for (int m = L / 2; m >= 1; m /= 2) {
    g0 += __shfl_xor_sync(mask, g0, m);
    g1 += __shfl_xor_sync(mask, g1, m);
    g2 += __shfl_xor_sync(mask, g2, m);
    if (JVP) {
      h0 += __shfl_xor_sync(mask, h0, m);
      h1 += __shfl_xor_sync(mask, h1, m);
      h2 += __shfl_xor_sync(mask, h2, m);
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

// The same sums for the direct walk, which reads the candidates from global
// memory: a lane reads kDirectBatch of its candidates before it computes
// any, so that their loads are in flight together, and sums them in slot
// order, the terms as in pair_sums (the tangent read only where the pair
// touches, from the planes tx, ty, tz).
constexpr int kDirectBatch = 4;

template <bool JVP, int L>
__device__ __forceinline__ void pair_sums_direct(
    unsigned mask, int lane, const float p[3], const float u[3], int lo,
    int hi, const float* sx, const float* sy, const float* sz,
    const float* tx, const float* ty, const float* tz, float md, float md2,
    float kc, float f[3], float t[3]) {
  double g0 = 0.0, g1 = 0.0, g2 = 0.0;
  double h0 = 0.0, h1 = 0.0, h2 = 0.0;
  for (int j0 = lo + lane; j0 < hi; j0 += kDirectBatch * L) {
    float qx[kDirectBatch], qy[kDirectBatch], qz[kDirectBatch];
#pragma unroll
    for (int k = 0; k < kDirectBatch; ++k) {
      const int j = j0 + k * L;
      if (j < hi) {
        qx[k] = sx[j];
        qy[k] = sy[j];
        qz[k] = sz[j];
      }
    }
#pragma unroll
    for (int k = 0; k < kDirectBatch; ++k) {
      const int j = j0 + k * L;
      if (j >= hi) break;
      const float dx = p[0] - qx[k];
      const float dy = p[1] - qy[k];
      const float dz = p[2] - qz[k];
      const float d2 = dx * dx + dy * dy + dz * dz;
      if (d2 < md2 && d2 > 1e-12f) {
        const float inv = 1.0f / sqrtf(d2);
        const float w = kc * (md * inv - 1.0f);
        g0 += static_cast<double>(w * dx);
        g1 += static_cast<double>(w * dy);
        g2 += static_cast<double>(w * dz);
        if (JVP) {
          const float dux = u[0] - tx[j];
          const float duy = u[1] - ty[j];
          const float duz = u[2] - tz[j];
          const float dot = dx * dux + dy * duy + dz * duz;
          const float g = kc * md * inv * inv * inv * dot;
          h0 += static_cast<double>(w * dux - g * dx);
          h1 += static_cast<double>(w * duy - g * dy);
          h2 += static_cast<double>(w * duz - g * dz);
        }
      }
    }
  }
#pragma unroll
  for (int m = L / 2; m >= 1; m /= 2) {
    g0 += __shfl_xor_sync(mask, g0, m);
    g1 += __shfl_xor_sync(mask, g1, m);
    g2 += __shfl_xor_sync(mask, g2, m);
    if (JVP) {
      h0 += __shfl_xor_sync(mask, h0, m);
      h1 += __shfl_xor_sync(mask, h1, m);
      h2 += __shfl_xor_sync(mask, h2, m);
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

// The window [ws, we) of sorted particle i in group g: from the table
// `wins` or, when it is null, from the cid `ci`, `cell_start` and the
// group's cid interval.
__device__ __forceinline__ void window(const int* __restrict__ cell_start,
                                       const int* __restrict__ wins,
                                       const Groups& grp, int64_t n, int ng,
                                       int ncells, int g, int i, int ci,
                                       int& ws, int& we) {
  if (wins != nullptr) {
    ws = wins[static_cast<int64_t>(i) * ng + g];
    we = wins[(n + i) * ng + g];
  } else {
    ws = cell_start[clampi(ci + grp.lo[g], 0, ncells)];
    we = cell_start[clampi(ci + grp.hi[g] + 1, 0, ncells)];
  }
}

// The candidates [a_lo, a_hi) of window [ws, we) in slab A at oa and
// [b_lo, b_hi) in slab B at ob (the two interval tests of the TPU kernel).
__device__ __forceinline__ void slab_ranges(int ws, int we, int oa, int ob,
                                            int slab, int r[4]) {
  r[0] = max(ws, oa);
  r[1] = min(we, oa + slab);
  r[2] = max(ws, max(ob, oa + slab));
  r[3] = ob > oa ? min(we, ob + slab) : r[2];
}

// The pair force on sorted particle i of slab block b (and with JVP its
// directional derivative along its tangent u), lane `lane` of its L: the
// staged walk. Every thread of the CTA calls it (it stages and
// synchronizes); `live` marks
// the threads that own a particle, `first` and `last` are the CTA's first
// and last live slots. The candidate set: windows from the table `wins`
// or, when it is null, from `cid`, `cell_start` and the groups' cid
// intervals `grp`; `off` the per-block slab offsets (offa, offb). `s` is
// the dynamic shared memory, 3 (JVP: 6) planes of `slab` floats, `sp` the
// CTA's spans.
//
// What the CTA stages of a slab: in CIV mode a window's ends grow with the
// sorted cid, so the first slot's window start and the last slot's window
// end bound every window of the CTA, and only that span of each slab is
// read; in window mode the whole slab. The first ng threads work out the
// spans of all groups at once, before the walk, so their loads overlap.
template <bool JVP, int L>
__device__ __forceinline__ void contact_force(
    const float* __restrict__ pos, const float* __restrict__ tan,
    const int* __restrict__ cid, const int* __restrict__ cell_start,
    const int* __restrict__ wins, const int* __restrict__ off,
    const Groups& grp, int64_t n, int ng, int slab, int ncells, int b, int i,
    bool live, int lane, int first, int last, const float p[3],
    const float u[3], float md, float kc, float* s, Spans& sp, float f[3],
    float t[3]) {
  float* sx = s;
  float* sy = s + slab;
  float* sz = s + 2 * slab;
  float* tx = s + 3 * slab;
  float* ty = s + 4 * slab;
  float* tz = s + 5 * slab;
  const float md2 = md * md;
  const int* ob_off = off + static_cast<int64_t>(b) * ng * 2;
  const unsigned mask = warp_lanes();
  const int g0 = threadIdx.x;
  if (g0 < ng) {
    const int oa = ob_off[2 * g0], ob = ob_off[2 * g0 + 1];
    if (wins == nullptr) {
      slab_ranges(cell_start[clampi(cid[first] + grp.lo[g0], 0, ncells)],
                  cell_start[clampi(cid[last] + grp.hi[g0] + 1, 0, ncells)],
                  oa, ob, slab, sp.v[g0]);
    } else {
      slab_ranges(0, static_cast<int>(n), oa, ob, slab, sp.v[g0]);
    }
  }
  const int ci = live && wins == nullptr ? cid[i] : 0;
  __syncthreads();
  float a[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};   // slab A sums (f, t)
  float bb[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};  // slab B sums
  float gf[3], gt[3];
  for (int g = 0; g < ng; ++g) {
    int r[4] = {0, 0, 0, 0};
    if (live) {
      int ws, we;
      window(cell_start, wins, grp, n, ng, ncells, g, i, ci, ws, we);
      slab_ranges(ws, we, ob_off[2 * g], ob_off[2 * g + 1], slab, r);
    }
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int lo = sp.v[g][2 * half], hi = sp.v[g][2 * half + 1];
      if (lo >= hi) continue;       // no window of the CTA reaches it
      stage<JVP>(pos, tan, n, lo, hi - lo, sx, sy, sz, tx, ty, tz);
      __syncthreads();
      pair_sums<JVP, L>(mask, lane, p, u, r[2 * half], r[2 * half + 1], lo,
                        sx, sy, sz, tx, ty, tz, md, md2, kc, gf, gt);
#pragma unroll
      for (int e = 0; e < (JVP ? 6 : 3); ++e) {
        const float v = e < 3 ? gf[e] : gt[e - 3];
        if (half == 0)
          a[e] += v;
        else
          bb[e] += v;
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

// The same pair force by the direct walk: nothing staged, no barrier, so
// a thread may own no particle (`live` false: empty ranges) and the CTA
// may be any divisor of the block. Group by group the window's part in
// slab A and in slab B is walked reading each candidate from `pos` (and
// `tan`), kDirectBatch candidates a load, and the sums are added in the
// staged walk's order. The next group's window is read before the walk of
// this one, so its dependent round trip to L2 overlaps the walk.
template <bool JVP, int L>
__device__ __forceinline__ void contact_force_direct(
    const float* __restrict__ pos, const float* __restrict__ tan,
    const int* __restrict__ cid, const int* __restrict__ cell_start,
    const int* __restrict__ wins, const int* __restrict__ off,
    const Groups& grp, int64_t n, int ng, int slab, int ncells, int b, int i,
    bool live, int lane, const float p[3], const float u[3], float md,
    float kc, float f[3], float t[3]) {
  const float md2 = md * md;
  const int* ob_off = off + static_cast<int64_t>(b) * ng * 2;
  const unsigned mask = warp_lanes();
  const int ci = live && wins == nullptr ? cid[i] : 0;
  int ws_next = 0, we_next = 0;
  if (live) window(cell_start, wins, grp, n, ng, ncells, 0, i, ci, ws_next,
                   we_next);
  float a[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};   // slab A sums (f, t)
  float bb[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};  // slab B sums
  float gf[3], gt[3];
  for (int g = 0; g < ng; ++g) {
    const int ws = ws_next, we = we_next;
    if (live && g + 1 < ng)
      window(cell_start, wins, grp, n, ng, ncells, g + 1, i, ci, ws_next,
             we_next);
    int r[4] = {0, 0, 0, 0};
    if (live) slab_ranges(ws, we, ob_off[2 * g], ob_off[2 * g + 1], slab, r);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      // every lane of `mask` takes part, its range empty or not
      pair_sums_direct<JVP, L>(mask, lane, p, u, r[2 * half],
                               r[2 * half + 1], pos, pos + n, pos + 2 * n,
                               tan, tan + n, tan + 2 * n, md, md2, kc, gf,
                               gt);
#pragma unroll
      for (int e = 0; e < (JVP ? 6 : 3); ++e) {
        const float v = e < 3 ? gf[e] : gt[e - 3];
        if (half == 0)
          a[e] += v;
        else
          bb[e] += v;
      }
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

// Local slot t = blockIdx.x * cta + threadIdx.x / L of the launch, lane
// threadIdx.x % L, steps global sorted slot i = base + t (base and cta both
// divide into the block, so the CTA lies in global block (base + blockIdx.x
// * cta) / block): its own position and the slabs come from the full array
// pos [3, n], its velocity from the local vel [3, n_local] and lane 0
// writes its outputs to the local pos_out, vel_out [3, n_local]. base = 0,
// n_local = n is K10 as it always was. STAGE picks the staged walk.
template <int L, bool STAGE>
__global__ void granular_step_kernel(
    const float* __restrict__ prm, const float* __restrict__ pos,
    const float* __restrict__ vel, const int* __restrict__ cid,
    const int* __restrict__ cell_start, const int* __restrict__ wins,
    const int* __restrict__ off, float* __restrict__ pos_out,
    float* __restrict__ vel_out, Groups grp, int n_, int ng, int slab,
    int ncells, int block, int base, int n_local_) {
  extern __shared__ float s_slab[];
  __shared__ Spans s_spans;
  const int64_t n = n_;
  const int64_t nl = n_local_;
  const int cta = blockDim.x / L;
  const int t0 = blockIdx.x * cta;
  const int b = (base + t0) / block;
  const int t = t0 + threadIdx.x / L;
  const int lane = threadIdx.x % L;
  const int i = base + t;
  const bool live = t < nl;
  const float md = prm[0], kc = prm[1], grav = prm[2], dt = prm[3];
  const float e = prm[4], lim = prm[5];

  float p[3] = {0.0f, 0.0f, 0.0f};
  if (live) load3(pos, n, i, p);
  float f[3], u[3];
  if (STAGE) {
    contact_force<false, L>(
        pos, nullptr, cid, cell_start, wins, off, grp, n, ng, slab, ncells, b,
        i, live, lane, base + t0, base + min(t0 + cta, n_local_) - 1, p, p,
        md, kc, s_slab, s_spans, f, u);
  } else {
    contact_force_direct<false, L>(pos, nullptr, cid, cell_start, wins, off,
                                   grp, n, ng, slab, ncells, b, i, live, lane,
                                   p, p, md, kc, f, u);
  }
  if (!live || lane != 0) return;

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
// rows 0-2 and J.u in rows 3-5. Slot i = blockIdx.x * cta + threadIdx.x /
// L, lane threadIdx.x % L; lane 0 writes. STAGE picks the staged walk.
template <bool JVP, int L, bool STAGE>
__global__ void granular_forces_kernel(
    const float* __restrict__ prm, const float* __restrict__ pos,
    const float* __restrict__ tan, const int* __restrict__ cid,
    const int* __restrict__ cell_start, const int* __restrict__ wins,
    const int* __restrict__ off, float* __restrict__ out, Groups grp, int n_,
    int ng, int slab, int ncells, int block) {
  extern __shared__ float s_slab[];
  __shared__ Spans s_spans;
  const int64_t n = n_;
  const int cta = blockDim.x / L;
  const int first = blockIdx.x * cta;
  const int b = first / block;
  const int i = first + threadIdx.x / L;
  const int lane = threadIdx.x % L;
  const bool live = i < n;
  const float md = prm[0], kc = prm[1];
  float p[3] = {0.0f, 0.0f, 0.0f};
  float u[3] = {0.0f, 0.0f, 0.0f};
  if (live) {
    load3(pos, n, i, p);
    if (JVP) load3(tan, n, i, u);
  }
  float f[3], t[3];
  if (STAGE) {
    contact_force<JVP, L>(pos, tan, cid, cell_start, wins, off, grp, n, ng,
                          slab, ncells, b, i, live, lane, first,
                          min(first + cta, n_) - 1, p, u, md, kc, s_slab,
                          s_spans, f, t);
  } else {
    contact_force_direct<JVP, L>(pos, tan, cid, cell_start, wins, off, grp, n,
                                 ng, slab, ncells, b, i, live, lane, p, u, md,
                                 kc, f, t);
  }
  if (!live || lane != 0) return;
  out[i] = f[0];
  out[n + i] = f[1];
  out[2 * n + i] = f[2];
  if (JVP) {
    out[3 * n + i] = t[0];
    out[4 * n + i] = t[1];
    out[5 * n + i] = t[2];
  }
}

// Calls f with std::integral_constant<int, L> for lanes L in {1, 2, 4, 8}
// and std::integral_constant<bool, S>.
template <bool S, typename F>
int with_lanes(int lanes, F&& f) {
  using St = std::integral_constant<bool, S>;
  switch (lanes) {
    case 1:
      return f(std::integral_constant<int, 1>{}, St{});
    case 2:
      return f(std::integral_constant<int, 2>{}, St{});
    case 4:
      return f(std::integral_constant<int, 4>{}, St{});
    case 8:
      return f(std::integral_constant<int, 8>{}, St{});
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// with_lanes for the staged walk (stage != 0) or the direct one.
template <typename F>
int with_walk(int lanes, int stage, F&& f) {
  return stage != 0 ? with_lanes<true>(lanes, f) : with_lanes<false>(lanes, f);
}

// Checks the launch geometry (cta slots of `lanes` lanes a CTA, cta dividing
// the block, and when it stages at least ng threads), fills the groups' cid
// intervals from the host table `bounds` (CIV mode) and raises the dynamic
// shared memory limit of `kernel` to `bytes` (0: the direct walk); returns
// 0 or a cudaError_t.
template <typename Kernel>
int prepare(Kernel kernel, const int* cid, const int* cell_start,
            const int* wins, const int* bounds, int n, int ng, int block,
            int slab, int lanes, int cta, size_t bytes, Groups* grp) {
  if (ng < 1 || ng > kMaxGroups || block < 1 || block > 1024 || slab < 1 ||
      n < 0 || cta < 1 || block % cta != 0 ||
      static_cast<int64_t>(cta) * lanes > 1024 ||
      (bytes > 0 && cta * lanes < ng))
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
  if (bytes <= 48 * 1024 - sizeof(Spans)) return cudaSuccess;
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes)));
}

// Dynamic shared memory of one staged span: 3 (JVP: 6) planes of floats;
// none for the direct walk.
size_t span_bytes(int slab, bool jvp, bool stage) {
  return stage ? static_cast<size_t>(slab) * (jvp ? 24 : 12) : 0;
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
// The walk: `cta` slots a CTA (dividing the block), `lanes` (1, 2, 4 or 8)
// lanes a slot, `stage` 1 for the staged walk and 0 for the direct one.
// Outputs pos_out, vel_out f32 [3, n_local].
extern "C" int wpe_granular_step(const float* prm, const float* pos,
                                 const float* vel, const int* cid,
                                 const int* cell_start, const int* wins,
                                 const int* off, float* pos_out,
                                 float* vel_out, const int* bounds, int n,
                                 int ng, int block, int slab, int ncells,
                                 int lanes, int cta, int stage, int base,
                                 int n_local, void* stream) {
  return with_walk(lanes, stage, [&](auto lc, auto sc) {
    constexpr int L = decltype(lc)::value;
    constexpr bool S = decltype(sc)::value;
    Groups grp;
    const size_t smem = span_bytes(slab, false, S);
    const int err = prepare(granular_step_kernel<L, S>, cid, cell_start,
                            wins, bounds, n, ng, block, slab, L, cta, smem,
                            &grp);
    if (err != cudaSuccess) return err;
    if (base < 0 || n_local < 0 || base % block != 0 ||
        static_cast<int64_t>(base) + n_local > n)
      return static_cast<int>(cudaErrorInvalidValue);
    if (n_local == 0) return static_cast<int>(cudaSuccess);
    granular_step_kernel<L, S><<<(n_local + cta - 1) / cta, cta * L, smem,
                                 static_cast<cudaStream_t>(stream)>>>(
        prm, pos, vel, cid, cell_start, wins, off, pos_out, vel_out, grp, n,
        ng, slab, ncells, block, base, n_local);
    return static_cast<int>(cudaGetLastError());
  });
}

// The pair forces alone (K11) and with their directional derivative along
// a tangent field u (K12).
template <bool JVP>
int launch_forces(const float* prm, const float* pos, const float* u,
                  const int* cid, const int* cell_start, const int* wins,
                  const int* off, float* out, const int* bounds, int n, int ng,
                  int block, int slab, int ncells, int lanes, int cta,
                  int stage, void* stream) {
  return with_walk(lanes, stage, [&](auto lc, auto sc) {
    constexpr int L = decltype(lc)::value;
    constexpr bool S = decltype(sc)::value;
    Groups grp;
    const size_t smem = span_bytes(slab, JVP, S);
    const int err = prepare(granular_forces_kernel<JVP, L, S>, cid,
                            cell_start, wins, bounds, n, ng, block, slab, L,
                            cta, smem, &grp);
    if (err != cudaSuccess || n == 0) return err;
    granular_forces_kernel<JVP, L, S>
        <<<(n + cta - 1) / cta, cta * L, smem,
           static_cast<cudaStream_t>(stream)>>>(prm, pos, u, cid, cell_start,
                                                wins, off, out, grp, n, ng,
                                                slab, ncells, block);
    return static_cast<int>(cudaGetLastError());
  });
}

// The pair forces alone (K11): prm f32[2] on the device (min_dist,
// k_contact); pos f32 [3, n] sorted; the candidate set and the walk as for
// wpe_granular_step. Output f_out f32 [3, n].
extern "C" int wpe_granular_forces(const float* prm, const float* pos,
                                   const int* cid, const int* cell_start,
                                   const int* wins, const int* off,
                                   float* f_out, const int* bounds, int n,
                                   int ng, int block, int slab, int ncells,
                                   int lanes, int cta, int stage,
                                   void* stream) {
  return launch_forces<false>(prm, pos, nullptr, cid, cell_start, wins, off,
                              f_out, bounds, n, ng, block, slab, ncells,
                              lanes, cta, stage, stream);
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
                                      int lanes, int cta, int stage,
                                      void* stream) {
  return launch_forces<true>(prm, pos, u, cid, cell_start, wins, off, ft_out,
                             bounds, n, ng, block, slab, ncells, lanes, cta,
                             stage, stream);
}
