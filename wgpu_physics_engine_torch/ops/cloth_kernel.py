"""Fused cloth substeps: the CUDA kernels, their plain torch version, and
the dispatch between them.

The counterpart of ``wgpu_physics_engine_tpu/ops/cloth_pallas.py``
(``multi_step`` → ``_kernel`` → ``_substep_planes``, kernel K1; for a
batch of worlds ``_multi_step_lanes`` → ``_lanes_kernel``, kernel K5, and
``_batched_kernel``, K5b, the same function):

* :func:`multi_step_plain` transcribes ``_substep_planes`` into torch —
  ``torch.roll`` plus validity masks, the same op order — and loops it. It
  takes one world (``pos`` ``[3, H, W]``) or a batch (``[B, 3, H, W]``,
  per-world parameters broadcast as ``[B, 1, 1]``); every op is
  elementwise, so world i of a batched run equals the single-world run;
* :func:`multi_step_kernel` launches ``csrc/cloth_step.cu`` once per
  substep on the current stream: K1 for one world, K5 for a batch (one
  launch per substep for all worlds). An exact batch of enough worlds
  small enough for one CTA (:func:`resident_batch`) takes K5r instead,
  ``cloth_tiled_kernel.multi_step_batched_kernel_packed``: one launch a
  call, one CTA a world holding it in shared memory for every substep,
  world i equal to K1 on world i bit for bit;
* :func:`multi_step` takes the plain version for a CPU tensor and a
  kernel for a CUDA tensor, and raises for anything else. There is no
  fallback on CUDA. One world above :data:`_TILED_PARTICLE_LIMIT`
  particles (JAX's ``_VMEM_PARTICLE_LIMIT``, ``cloth_pallas.py:293``) goes
  to ``ops/cloth_tiled_kernel.py`` (on the card K6r, the whole call in
  one launch on resident tiles, where its tiles fit the card, else K6, K
  substeps a launch by temporal blocking; on the CPU their plain
  version), as JAX sends it to
  ``cloth_pallas_tiled``; the route is exact and drops ``fast_math``, as
  JAX's does (``:628-638``). JAX's branch for a grid with no banded
  schedule (``h % 8 != 0`` or ``n_steps`` indivisible, to the XLA stencil
  with a warning) has no counterpart: K6 takes any ``h``, ``w`` and
  ``n_steps``, so the route depends on the size alone. A batch of worlds
  stays on K5 at any size: JAX maps large batched worlds one at a time
  through its single-world dispatch (``:615-626``), while K5 takes every
  size in one launch a substep and computes the same function;
* :func:`substep_with_force` is one substep of one world with an external
  force plane added after the springs (``cloth_pallas.substep_with_force``,
  K1f): its plain version, and on CUDA ``csrc/cloth_step.cu``'s K1f, K1's
  arithmetic with a particle's edges spread over three warps.
  :func:`substep_with_force_sorted` is the same substep as the cloth
  self-collision block runs it: the pair forces in the block's frozen
  sorted order, read through its inverse permutation, and the next
  substep's sorted positions written back, with the parameters, checks
  and pins prepared once a block (:func:`force_block`); on the CPU the
  gather, :func:`substep_with_force_plain` and the scatter;
* :func:`multi_step_window` steps a halo-extended band of rows of a larger
  grid, the shard body of the rows-sharded path (``parallel/mesh.py``):
  ``cloth_pallas.multi_step_window``, kernel K1w. Its plain version is
  ``_substep_planes`` with the spring masks taken from global rows
  (:func:`_window_masks`); on CUDA it is K1's device body with the same
  masks. A window above :data:`_TILED_PARTICLE_LIMIT` particles goes, as
  one world does, to ``cloth_tiled_kernel.multi_step_window_kernel`` (K6w,
  K6's edge-once tiles with the same masks; on the CPU its plain version),
  equal to K1w bit for bit; JAX routes its windows by size too (above its
  VMEM budget to the XLA stencil, ``parallel/mesh.py`` ``_kernel_fits``);
* :func:`trace` re-runs substeps of one world with the same stepper and
  keeps each substep's input state, ``[K, 6, H, W]``: the trajectory the
  backward pass of ``ops/cloth_grad_kernel.py`` walks (the counterpart of
  ``cloth_pallas_grad._trace_kernel``, which runs K1's body).
  :func:`trace_window` does the same on a row window with K1w's body at
  every size (the K6w route gives the same bits), for the backward of the
  rows path (``cloth_grad_kernel.multi_step_window``).

All paths read one packed parameter vector per world (:func:`_pack_params`),
so the damping factor ``speed_damp ** dt`` is computed once per call, as in
the TPU kernel, and the paths agree to the last bit on one device.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import torch

from ..core.state import ClothParams, ClothState
from . import _build
from ..utils.profiling import span

_EPS = 1e-6

# Spring families: (dr, dc, k-index), the order of cloth_pallas._FAMILIES.
_FAMILIES = (
    (0, 1, 0), (1, 0, 0),     # structural right, down
    (1, 1, 1), (1, -1, 1),    # shear down-right, down-left
    (0, 2, 2), (2, 0, 2),     # bend 2-right, 2-down
)

# One world above this many particles takes the tiled stepper
# (``cloth_tiled_kernel``, K6): JAX's ``_VMEM_PARTICLE_LIMIT``. A module
# constant, so a test can lower it.
_TILED_PARTICLE_LIMIT = 100_000

# An exact batch of at least this many worlds a multiprocessor takes K5r
# (:func:`resident_batch`): K5r's call costs one CTA's time up to a world
# an SM, K5's grows with the worlds, and the two cross at ~50 worlds on
# the H100's 132 SMs (PERF.md §6). A module constant, so a test can
# change it.
_RESIDENT_MIN_WAVES = 0.375

# Kernel launches by :func:`multi_step_kernel` and :func:`trace_kernel`
# (one per substep): K1 for one world, K5 for a batch. A run reads them to
# show that its path went through the kernels.
LAUNCHES = 0
LAUNCHES_BATCHED = 0
# Launches of K1f by :func:`substep_with_force_kernel` and
# :func:`substep_with_force_sorted_kernel` (one per substep).
LAUNCHES_FORCE = 0
# Launches of K1w by :func:`multi_step_window_kernel` (one per substep,
# for a whole batch of windows).
LAUNCHES_WINDOW = 0
# Launches of K1w's body by :func:`trace_window_kernel` (one per substep
# traced, for a whole batch of windows).
LAUNCHES_WINDOW_TRACE = 0

_SIGNATURES = {
    "wpe_cloth_multi_step": [ctypes.c_void_p] * 9 + [ctypes.c_int] * 5
                            + [ctypes.c_void_p],
    "wpe_cloth_multi_step_batched": [ctypes.c_void_p] * 9
                                    + [ctypes.c_int] * 6 + [ctypes.c_void_p],
    "wpe_cloth_trace": [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4
                       + [ctypes.c_void_p],
    "wpe_cloth_substep_with_force": [ctypes.c_void_p] * 10
                                    + [ctypes.c_int] * 3 + [ctypes.c_void_p],
    "wpe_cloth_multi_step_window": [ctypes.c_void_p] * 9
                                   + [ctypes.c_int] * 4 + [ctypes.c_void_p]
                                   + [ctypes.c_int] * 2 + [ctypes.c_void_p],
    "wpe_cloth_trace_window": [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4
                              + [ctypes.c_void_p] + [ctypes.c_int] * 2
                              + [ctypes.c_void_p],
}


def _pack_params(p: ClothParams, dt) -> torch.Tensor:
    """The 16-float parameter vector of the kernel, on the params' device:
    0:k_struct 1:k_shear 2:k_bend 3:c_struct 4:c_shear 5:c_bend
    6:rest_struct 7:rest_shear 8:rest_bend 9:k_contact 10:mu 11:mass
    12:gravity 13:damp_factor(=speed_damp**dt) 14:min_dist 15:dt.

    0-d leaves give ``[16]``; ``[B]`` leaves (any of them) give one row per
    world, ``[B, 16]``, with the 0-d leaves broadcast. The damping factor
    is one elementwise ``pow`` either way: on CUDA every element takes the
    same device ``powf``, so a row equals the 0-d vector of its world; on
    the CPU torch's vectorized ``pow`` serves batches of 16 or more
    elements and may round them 1 ulp off the scalar one."""
    with span("cloth.pack"):
        dt = torch.as_tensor(dt, dtype=torch.float32, device=p.mass.device)
        cols = [
            p.k_struct, p.k_shear, p.k_bend,
            p.c_struct, p.c_shear, p.c_bend,
            p.rest_struct, p.rest_shear, p.rest_bend,
            p.k_contact, p.mu, p.mass, p.gravity,
            torch.pow(p.speed_damp, dt),  # damp factor, constant per call
            p.globe_radius + p.particle_radius,  # min_dist
            dt,
        ]
        cols = torch.broadcast_tensors(*cols)
        return torch.stack(cols, dim=-1).to(torch.float32)


# ---------------------------------------------------------------------------
# Plain version
# ---------------------------------------------------------------------------

def _shift(x, dr, dc):
    """result[..., r, c] = x[..., (r+dr) % h, (c+dc) % w]."""
    if dr:
        x = torch.roll(x, -dr, dims=-2)
    if dc:
        x = torch.roll(x, -dc, dims=-1)
    return x


def _family_masks(h, w, device):
    """Validity mask [h, w] per family for edges anchored at p0=(r,c): both
    endpoints are real grid cells (no wraparound). A batch of worlds
    broadcasts it."""
    rows = torch.arange(h, device=device)[:, None]
    cols = torch.arange(w, device=device)[None, :]
    masks = []
    for dr, dc, _ in _FAMILIES:
        ok = rows < (h - dr)
        ok = ok & ((cols < (w - dc)) if dc >= 0 else (cols >= -dc))
        masks.append(ok.expand(h, w))
    return masks


def _window_masks(h, w, row0, h_global: int, device):
    """The masks of :func:`_family_masks` for an ``[h, w]`` band of rows
    of a grid ``h_global`` rows high whose local row 0 is global row
    ``row0`` (negative on the top shard): an edge also needs both ends
    inside the global grid (``cloth_pallas._kernel(window=True)``
    :234-245), so halo rows beyond the grid join no edge. An int ``row0``
    gives ``[h, w]`` masks; a sequence of B first rows (a batch of
    windows) gives ``[B, h, w]``."""
    lrow = torch.arange(h, device=device)[:, None]
    if isinstance(row0, (list, tuple)):
        grow = torch.tensor(row0, dtype=torch.long,
                            device=device)[:, None, None] + lrow
    else:
        grow = lrow + int(row0)
    masks = []
    for ok, (dr, _, _) in zip(_family_masks(h, w, device), _FAMILIES):
        masks.append(ok & (grow >= 0) & (grow < h_global - dr))
    return masks


def _exact_dist_inv(d2):
    """(dist, 1/dist) with the zero guard; d2 = squared distance.

    Gradient-safe (``cloth_pallas_grad._gradsafe_dist_inv``): the sqrt
    never sees 0, whose derivative is inf (and inf times a ``where``
    mask's 0 is NaN). The primal is ``sqrtf`` bit for bit, NaN included,
    since only d2 == 0 takes the guard."""
    nonzero = d2 != 0
    dist = torch.where(nonzero, torch.sqrt(torch.where(nonzero, d2, 1.0)), 0.0)
    safe = dist >= _EPS
    inv = torch.where(safe, 1.0 / torch.where(safe, dist, 1.0), 0.0)
    return dist, inv


def _fast_dist_inv(d2):
    """The rsqrt form, under the guard ``d2 > EPS²``."""
    pos_d2 = d2 > _EPS * _EPS
    inv = torch.rsqrt(torch.where(pos_d2, d2, 1.0))
    return torch.where(pos_d2, d2 * inv, 0.0), torch.where(pos_d2, inv, 0.0)


def _spring_planes(carry, masks, prm, dist_inv):
    """The spring stencil of ``cloth_pallas._substep_planes``
    (forces.wgsl:143-313): the force planes (fx, fy, fz), family by family
    in ``_FAMILIES`` order, +E on the anchor and then -E shifted back onto
    the other end."""
    x, y, z, vx, vy, vz = carry
    k, c, rest = prm[0:3], prm[3:6], prm[6:9]
    fx = torch.zeros_like(x)
    fy = torch.zeros_like(x)
    fz = torch.zeros_like(x)
    for fam_idx, (dr, dc, t) in enumerate(_FAMILIES):
        ok = masks[fam_idx]
        p1x, p1y, p1z, v1x, v1y, v1z = (_shift(a, dr, dc)
                                        for a in (x, y, z, vx, vy, vz))
        dxv, dyv, dzv = p1x - x, p1y - y, p1z - z
        dist, inv = dist_inv(dxv * dxv + dyv * dyv + dzv * dzv)
        safe = dist >= _EPS
        ux, uy, uz = dxv * inv, dyv * inv, dzv * inv
        stretch = dist - rest[t]
        v_along = (v1x - vx) * ux + (v1y - vy) * uy + (v1z - vz) * uz
        s = k[t] * stretch + c[t] * v_along
        keep = ok & safe
        ex = torch.where(keep, s * ux, 0.0)
        ey = torch.where(keep, s * uy, 0.0)
        ez = torch.where(keep, s * uz, 0.0)
        fx = fx + ex
        fy = fy + ey
        fz = fz + ez
        # reaction on p1: shift E back by (+dr, +dc); masked zeros wrap
        fx = fx - _shift(ex, -dr, -dc)
        fy = fy - _shift(ey, -dr, -dc)
        fz = fz - _shift(ez, -dr, -dc)
    return fx, fy, fz


def _integrate_planes(carry, force, prm, dist_inv, pins=None):
    """Gravity → contact → friction → Euler + damping → projection → pins
    (compute_movement.wgsl:70-174) on planes: the integration of
    ``cloth_pallas._substep_planes``."""
    x, y, z, vx, vy, vz = carry
    fx, fy, fz = force
    k_contact, mu, mass, gravity = prm[9], prm[10], prm[11], prm[12]
    damp_factor, min_dist, dt = prm[13], prm[14], prm[15]
    fy = fy + mass * gravity

    dist, inv_d = dist_inv(x * x + y * y + z * z)
    in_contact = (dist < min_dist) & (dist > _EPS)
    nx, ny, nz = x * inv_d, y * inv_d, z * inv_d
    pen = k_contact * (min_dist - dist)
    fx = torch.where(in_contact, fx + pen * nx, fx)
    fy = torch.where(in_contact, fy + pen * ny, fy)
    fz = torch.where(in_contact, fz + pen * nz, fz)

    ro_n = fx * nx + fy * ny + fz * nz
    tx, ty, tz = fx - ro_n * nx, fy - ro_n * ny, fz - ro_n * nz
    tmag, inv_t = dist_inv(tx * tx + ty * ty + tz * tz)
    fric = in_contact & (tmag > _EPS)
    fmag = -torch.minimum(tmag, mu * torch.abs(ro_n))
    fx = torch.where(fric, fx + fmag * tx * inv_t, fx)
    fy = torch.where(fric, fy + fmag * ty * inv_t, fy)
    fz = torch.where(fric, fz + fmag * tz * inv_t, fz)

    inv_m = 1.0 / mass
    vx = (vx + fx * inv_m * dt) * damp_factor
    vy = (vy + fy * inv_m * dt) * damp_factor
    vz = (vz + fz * inv_m * dt) * damp_factor
    x = x + vx * dt
    y = y + vy * dt
    z = z + vz * dt

    fdist, inv_f = dist_inv(x * x + y * y + z * z)
    pen2 = fdist < min_dist
    pen_safe = pen2 & (fdist > _EPS)
    pen_center = pen2 & ~pen_safe
    x = torch.where(pen_safe, x * inv_f * min_dist,
                    torch.where(pen_center, 0.0, x))
    y = torch.where(pen_safe, y * inv_f * min_dist,
                    torch.where(pen_center, min_dist, y))
    z = torch.where(pen_safe, z * inv_f * min_dist,
                    torch.where(pen_center, 0.0, z))
    vx = torch.where(pen2, 0.0, vx)
    vy = torch.where(pen2, 0.0, vy)
    vz = torch.where(pen2, 0.0, vz)

    if pins is not None:
        pin, px_pin, py_pin, pz_pin = pins
        x = torch.where(pin, px_pin, x)
        y = torch.where(pin, py_pin, y)
        z = torch.where(pin, pz_pin, z)
        vx = torch.where(pin, 0.0, vx)
        vy = torch.where(pin, 0.0, vy)
        vz = torch.where(pin, 0.0, vz)
    return x, y, z, vx, vy, vz


def _substep_planes(carry, masks, prm, dist_inv, pins=None, fext=None):
    """One substep on six ``[h, w]`` (or ``[B, h, w]``) planes (x, y, z, vx,
    vy, vz): the transcription of ``cloth_pallas._substep_planes``. ``prm``
    is the packed parameter vector as 16 0-d tensors, or for a batch as 16
    ``[B, 1, 1]`` tensors; ``pins`` is ``(pin_bool, px, py, pz)``; ``fext``
    an external force ``(fx, fy, fz)`` added to the spring force before
    gravity (K1f)."""
    force = _spring_planes(carry, masks, prm, dist_inv)
    if fext is not None:
        force = tuple(f + e for f, e in zip(force, fext))
    return _integrate_planes(carry, force, prm, dist_inv, pins)


def _plane_params(prm: torch.Tensor, state: ClothState):
    """The packed vector (``[16]`` or ``[B, 16]``) as the 16 scalars
    :func:`_substep_planes` reads: 0-d for one world or shared parameters,
    ``[B, 1, 1]`` for per-world parameters of a batch."""
    prm = prm.to(state.pos.device)
    if prm.ndim == 1:
        return prm.unbind(0)
    if state.pos.ndim != 4 or prm.shape[0] != state.pos.shape[0]:
        raise ValueError(f"per-world params {tuple(prm.shape[:1])} need a "
                         f"state of as many worlds, got {tuple(state.pos.shape)}")
    return prm[:, :, None, None].unbind(1)


def _plain_pins(state: ClothState):
    if state.pin_mask is None:
        return None
    return (state.pin_mask != 0, *state.pin_pos.unbind(-3))


def multi_step_plain(state: ClothState, params: ClothParams, dt,
                     n_steps: int, fast_math: bool = False) -> ClothState:
    """``n_steps`` substeps of :func:`_substep_planes` on any device, for
    one world (``pos`` ``[3, H, W]``, 0-d params) or a batch (``pos``
    ``[B, 3, H, W]``, params ``[B]`` or shared 0-d; pins, if any, batched
    alongside: ``pin_mask`` ``[B, H, W]``, ``pin_pos`` ``[B, 3, H, W]``)."""
    return multi_step_plain_packed(state, _pack_params(params, dt), n_steps,
                                   fast_math)


def multi_step_plain_packed(state: ClothState, prm: torch.Tensor,
                            n_steps: int,
                            fast_math: bool = False) -> ClothState:
    """:func:`multi_step_plain` on the packed vector of
    :func:`_pack_params`."""
    h, w = state.pos.shape[-2:]
    prm = _plane_params(prm, state)
    masks = _family_masks(h, w, state.pos.device)
    dist_inv = _fast_dist_inv if fast_math else _exact_dist_inv
    pins = _plain_pins(state)
    carry = (*state.pos.unbind(-3), *state.vel.unbind(-3))
    for _ in range(n_steps):
        carry = _substep_planes(carry, masks, prm, dist_inv, pins)
    return state._replace(pos=torch.stack(carry[:3], dim=-3),
                          vel=torch.stack(carry[3:], dim=-3))


def trace_plain(state: ClothState, prm: torch.Tensor,
                n_states: int) -> torch.Tensor:
    """The states entering substeps 0 .. n_states-1 of one world from
    ``state`` (exact path): ``traj[s]`` is ``(x, y, z, vx, vy, vz)`` after
    s substeps, ``[n_states, 6, H, W]``. Each comes from the same substep
    as :func:`multi_step_plain_packed`, so ``traj[s]`` equals that
    function's ``s`` substeps bit for bit."""
    h, w = state.pos.shape[-2:]
    plane = _plane_params(prm, state)
    masks = _family_masks(h, w, state.pos.device)
    pins = _plain_pins(state)
    traj = torch.empty((n_states, 6, h, w), dtype=torch.float32,
                       device=state.pos.device)
    carry = (*state.pos.unbind(-3), *state.vel.unbind(-3))
    for s in range(n_states):
        if s:
            carry = _substep_planes(carry, masks, plane, _exact_dist_inv,
                                    pins)
        traj[s] = torch.stack(carry)
    return traj


def substep_with_force_plain(state: ClothState, params: ClothParams, dt,
                             fext: torch.Tensor) -> ClothState:
    """One exact substep of one world (``[3, H, W]``) with the external
    force ``fext`` ``[3, H, W]`` added to the spring force before gravity
    (the cloth self-collision pair forces), on any device: the plain
    version of K1f, ``cloth_pallas.substep_with_force``."""
    return _substep_with_force_packed_plain(state, _pack_params(params, dt),
                                            fext)


def _substep_with_force_packed_plain(state: ClothState, prm: torch.Tensor,
                                     fext: torch.Tensor) -> ClothState:
    """:func:`substep_with_force_plain` on the packed vector of
    :func:`_pack_params`."""
    h, w = state.pos.shape[-2:]
    carry = (*state.pos.unbind(-3), *state.vel.unbind(-3))
    carry = _substep_planes(carry, _family_masks(h, w, state.pos.device),
                            _plane_params(prm, state), _exact_dist_inv,
                            _plain_pins(state),
                            fext.to(state.pos.device).unbind(-3))
    return state._replace(pos=torch.stack(carry[:3], dim=-3),
                          vel=torch.stack(carry[3:], dim=-3))


class ForceBlock(NamedTuple):
    """What K1f reads unchanged through one frozen self-collision block
    (``models.cloth._self_collide_block``), prepared once a block by
    :func:`force_block`: the packed parameters, the block's inverse
    permutation ``inv`` (int32 ``[n]``: particle i's column of the sorted
    order) and, on CUDA, the checked pins, the loaded library, the
    stream and the entry point's fixed pointers, so that a substep only
    allocates its outputs and launches."""
    prm: torch.Tensor
    inv: torch.Tensor
    h: int
    w: int
    pins: Optional[tuple] = None     # CUDA: (pin_mask f32, pin_pos)
    lib: Optional[ctypes.CDLL] = None
    device: int = -1                 # CUDA: the device index
    stream: int = 0
    ptrs: tuple = ()                 # CUDA: prm, pin_mask, pin_pos, inv


def force_block(state: ClothState, params: ClothParams, dt,
                inv: torch.Tensor):
    """``(block, state)``: the :class:`ForceBlock` of a self-collision
    block of one world, its parameters packed once, and on CUDA the state
    checked and made contiguous for :func:`substep_with_force_sorted`."""
    h, w = state.pos.shape[-2:]
    prm = _pack_params(params, dt)
    inv = inv.to(device=state.pos.device, dtype=torch.int32).contiguous()
    if inv.shape != (h * w,):
        raise ValueError(f"inv: expected [{h * w}], got {tuple(inv.shape)}")
    if state.pos.device.type != "cuda":
        return ForceBlock(prm, inv, h, w), state
    pos, vel, prm, pins, lead, h, w = _kernel_inputs(state, prm)
    if lead:
        raise ValueError(f"substep_with_force takes one world, got "
                         f"{tuple(pos.shape)}")
    with torch.cuda.device(pos.device):
        stream = torch.cuda.current_stream().cuda_stream
    ptrs = (prm.data_ptr(),
            *((pins[0].data_ptr(), pins[1].data_ptr()) if pins
              else (None, None)),
            inv.data_ptr())
    blk = ForceBlock(prm, inv, h, w, pins, _build.load("cloth_step",
                                                       _SIGNATURES),
                     pos.device.index, stream, ptrs)
    return blk, state._replace(pos=pos, vel=vel)


def substep_with_force_sorted_plain(state: ClothState, blk: ForceBlock,
                                    f_sorted: torch.Tensor,
                                    want_sp: bool = True):
    """The plain version of K1f's sorted entry: the pair forces
    ``f_sorted`` ``[3, n]`` in the block's sorted order gathered to the
    grid, :func:`substep_with_force_plain`'s substep on the block's packed
    parameters, and with ``want_sp`` the new positions scattered to the
    sorted order, ``sp[:, inv[i]] = pos[:, i]``. Returns ``(state, sp or
    None)``."""
    inv = blk.inv.to(f_sorted.device).long()
    fext = f_sorted[:, inv].reshape(3, blk.h, blk.w)
    out = _substep_with_force_packed_plain(state, blk.prm, fext)
    sp = None
    if want_sp:
        sp = torch.empty_like(f_sorted)
        sp[:, inv] = out.pos.reshape(3, blk.h * blk.w)
    return out, sp


def _row0_list(row0, n_windows: Optional[int]):
    """The first global row of each window as host ints: an int for one
    window (``n_windows`` None), else a list of ``n_windows`` from a
    sequence or a tensor of ints (a CUDA tensor is read back)."""
    if torch.is_tensor(row0):
        row0 = row0.reshape(-1).tolist()
    seq = isinstance(row0, (list, tuple))
    if n_windows is None:
        if seq:
            (row0,) = row0
        return int(row0)
    rows = [int(r) for r in (row0 if seq else [row0])]
    if len(rows) != n_windows:
        raise ValueError(f"row0: expected {n_windows} first rows, got "
                         f"{len(rows)}")
    return rows


@functools.lru_cache(maxsize=256)
def _row0_cached(rows: tuple, device: torch.device) -> torch.Tensor:
    return torch.tensor(rows, dtype=torch.int32, device=device)


def _row0_device(row0, n_windows: int, device) -> torch.Tensor:
    """The kernels' ``row0`` operand: int32 ``[n_windows]`` on ``device``.
    An int32 tensor already there is taken as it is; a sequence of ints is
    copied once and kept: the rows path gives the same first rows in every
    exchange block, and a copy from pageable host memory would make the
    host wait for the stream."""
    if torch.is_tensor(row0):
        if tuple(row0.shape) != (n_windows,):
            raise ValueError(f"row0: expected [{n_windows}], got "
                             f"{tuple(row0.shape)}")
        return row0.to(device=device, dtype=torch.int32).contiguous()
    return _row0_cached(tuple(_row0_list(row0, n_windows)),
                        torch.device(device))


def _batch_rows(pos, row0):
    """``row0`` as :func:`_window_masks` takes it: an int for one window
    (``pos`` ``[3, h, W]``), the list of B first rows for a batch
    (``[B, 3, h, W]``)."""
    return _row0_list(row0, pos.shape[0] if pos.ndim == 4 else None)


def multi_step_window_plain(pos, vel, pin_mask, pin_pos, params, dt,
                            n_steps: int, row0, h_global: int):
    """The plain version of K1w: ``n_steps`` exact substeps of the row
    window ``pos``/``vel`` ``[3, h, W]`` (halo rows included; ``row0`` the
    global row of local row 0, ``h_global`` the grid's height), or of a
    batch of windows of one shape, ``[B, 3, h, W]`` with B first rows in
    ``row0`` (a sequence or an int tensor) and pins, if any, ``[B, h, W]``
    and ``[B, 3, h, W]`` (a zero mask for a window without), on any
    device. Every op is elementwise, so window b of a batch equals the
    window alone. Returns ``(pos, vel)`` with the halo rows, stale ones
    too."""
    return _window_plain_packed(pos, vel, pin_mask, pin_pos,
                                _pack_params(params, dt), n_steps, row0,
                                h_global)


def _window_plain_packed(pos, vel, pin_mask, pin_pos, prm, n_steps: int,
                         row0, h_global: int):
    """:func:`multi_step_window_plain` on the packed vector of
    :func:`_pack_params`."""
    h, w = pos.shape[-2:]
    state = ClothState(pos=pos, vel=vel, pin_mask=pin_mask, pin_pos=pin_pos)
    plane = _plane_params(prm, state)
    masks = _window_masks(h, w, _batch_rows(pos, row0), h_global,
                          pos.device)
    pins = _plain_pins(state)
    carry = (*pos.unbind(-3), *vel.unbind(-3))
    for _ in range(n_steps):
        carry = _substep_planes(carry, masks, plane, _exact_dist_inv, pins)
    return torch.stack(carry[:3], dim=-3), torch.stack(carry[3:], dim=-3)


def trace_window_plain(pos, vel, pin_mask, pin_pos, prm: torch.Tensor,
                       n_states: int, row0,
                       h_global: int) -> torch.Tensor:
    """The states entering substeps 0 .. n_states-1 of the row window
    ``pos``/``vel`` (the arguments of :func:`multi_step_window_plain`,
    the parameters packed): ``[n_states, 6, h, W]``, or for a batch
    ``[n_states, B, 6, h, W]``, each from the same substep as
    :func:`multi_step_window_plain`, so ``traj[s]`` equals its ``s``
    substeps bit for bit."""
    h, w = pos.shape[-2:]
    state = ClothState(pos=pos, vel=vel, pin_mask=pin_mask, pin_pos=pin_pos)
    plane = _plane_params(prm, state)
    masks = _window_masks(h, w, _batch_rows(pos, row0), h_global,
                          pos.device)
    pins = _plain_pins(state)
    traj = torch.empty((max(n_states, 0),) + tuple(pos.shape[:-3])
                       + (6, h, w), dtype=torch.float32, device=pos.device)
    carry = (*pos.unbind(-3), *vel.unbind(-3))
    for s in range(n_states):
        if s:
            carry = _substep_planes(carry, masks, plane, _exact_dist_inv,
                                    pins)
        traj[s] = torch.stack(carry, dim=-3)
    return traj


# ---------------------------------------------------------------------------
# Kernel
# ---------------------------------------------------------------------------

def _check_plane(a: torch.Tensor, shape, device, what: str) -> None:
    if (a.dtype != torch.float32 or tuple(a.shape) != tuple(shape)
            or a.device != device):
        raise ValueError(f"{what}: expected float32 {tuple(shape)} on "
                         f"{device}, got {a.dtype} {tuple(a.shape)} on "
                         f"{a.device}")


def multi_step_kernel(state: ClothState, params: ClothParams, dt,
                      n_steps: int, fast_math: bool = False) -> ClothState:
    """``n_steps`` substeps of ``csrc/cloth_step.cu`` on a CUDA state: one
    launch per substep on the current stream, ping-ponging between two
    new buffers (the input state is only read). A ``[3, H, W]`` state runs
    the single-world kernel (K1), a ``[B, 3, H, W]`` state the batched one
    (K5), with one parameter row per world (``[B]`` params, or shared 0-d
    params broadcast to every row)."""
    return multi_step_kernel_packed(state, _pack_params(params, dt), n_steps,
                                    fast_math)


def _kernel_inputs(state: ClothState, prm: torch.Tensor,
                   shared: bool = False):
    """Checked, contiguous kernel inputs: (pos, vel, the parameter table
    ``lead + (16,)``, or with ``shared`` the one ``[16]`` vector, the pin
    pointers, lead, h, w)."""
    pos, vel = state.pos, state.vel
    if pos.device.type != "cuda":
        raise ValueError(f"cloth kernel needs CUDA tensors, got {pos.device}")
    if pos.ndim not in (3, 4):
        raise ValueError(f"pos: expected [3, H, W] or [B, 3, H, W], got "
                         f"{tuple(pos.shape)}")
    lead = tuple(pos.shape[:-3])
    h, w = pos.shape[-2:]
    _check_plane(pos, lead + (3, h, w), pos.device, "pos")
    _check_plane(vel, lead + (3, h, w), pos.device, "vel")
    pos, vel = pos.contiguous(), vel.contiguous()
    prm = prm.detach().to(device=pos.device, dtype=torch.float32)
    if (prm.shape[:-1] not in (((),) if shared else ((), lead))
            or prm.shape[-1:] != (16,)):
        raise ValueError(f"params: expected {'shared' if shared else '0-d or '
                         + str(lead)} leaves for a state of "
                         f"{tuple(pos.shape)}, got {tuple(prm.shape[:-1])}")
    prm = (prm if shared else prm.expand(lead + (16,))).contiguous()
    pins = None
    if state.pin_mask is not None:
        pin_mask = state.pin_mask.to(device=pos.device, dtype=torch.float32)
        pin_mask = pin_mask.contiguous()
        pin_pos = state.pin_pos.contiguous()
        _check_plane(pin_mask, lead + (h, w), pos.device, "pin_mask")
        _check_plane(pin_pos, lead + (3, h, w), pos.device, "pin_pos")
        pins = (pin_mask, pin_pos)
    return pos, vel, prm, pins, lead, h, w


def resident_batch(n_worlds: int, h: int, w: int, fast_math: bool,
                   sms: int, smem: int) -> bool:
    """Whether a CUDA batch of ``n_worlds`` worlds of ``h × w`` on a card
    of ``sms`` multiprocessors and ``smem`` bytes of shared memory a CTA
    takes K5r: exact (K5r has no fast_math), a world that fits one CTA
    (``cloth_tiled_kernel.batched_fits``), at most 65,535 worlds, and at
    least :data:`_RESIDENT_MIN_WAVES` worlds a multiprocessor: below that
    one CTA a world leaves too many multiprocessors idle, and K5 is faster
    on the H100."""
    from .cloth_tiled_kernel import batched_fits

    return (not fast_math and batched_fits(h, w, smem)
            and _RESIDENT_MIN_WAVES * sms <= n_worlds <= 65535)


def multi_step_kernel_packed(state: ClothState, prm: torch.Tensor,
                             n_steps: int,
                             fast_math: bool = False) -> ClothState:
    """:func:`multi_step_kernel` on the packed vector of
    :func:`_pack_params` (``[16]``, or ``[B, 16]`` for a batch): K5r for
    a batch :func:`resident_batch` takes, else :func:`multi_step_launch_packed`."""
    if state.pos.ndim == 4 and state.pos.is_cuda:
        from . import cloth_tiled_kernel

        if resident_batch(state.pos.shape[0], *state.pos.shape[-2:],
                          fast_math, *cloth_tiled_kernel.card(
                              state.pos.device)):
            return cloth_tiled_kernel.multi_step_batched_kernel_packed(
                state, prm, n_steps)
    return multi_step_launch_packed(state, prm, n_steps, fast_math)


def multi_step_launch_packed(state: ClothState, prm: torch.Tensor,
                             n_steps: int,
                             fast_math: bool = False) -> ClothState:
    """K1 on one world, K5 on a batch: ``n_steps`` launches of
    ``csrc/cloth_step.cu`` on the current stream, ping-ponging between two
    new buffers; the packed vector of :func:`_pack_params`."""
    global LAUNCHES, LAUNCHES_BATCHED
    with span("cloth.issue"):
        pos, vel, prm, pins, lead, h, w = _kernel_inputs(state, prm)
        if n_steps <= 0 or pos.numel() == 0:
            return state
        pin_ptrs = ((pins[0].data_ptr(), pins[1].data_ptr()) if pins
                    else (None, None))
        bufs = torch.empty((4,) + lead + (3, h, w), dtype=torch.float32,
                           device=pos.device)
        lib = _build.load("cloth_step", _SIGNATURES)
        ptrs = (prm.data_ptr(), pos.data_ptr(), vel.data_ptr(), *pin_ptrs,
                bufs[0].data_ptr(), bufs[1].data_ptr(),
                bufs[2].data_ptr(), bufs[3].data_ptr())
        with torch.cuda.device(pos.device):
            stream = torch.cuda.current_stream().cuda_stream
            if lead:
                err = lib.wpe_cloth_multi_step_batched(
                    *ptrs, lead[0], h, w, n_steps, int(pins is not None),
                    int(fast_math), stream)
            else:
                err = lib.wpe_cloth_multi_step(
                    *ptrs, h, w, n_steps, int(pins is not None),
                    int(fast_math), stream)
        _build.check(lib, err, "cloth_step launch")
    if lead:
        LAUNCHES_BATCHED += n_steps
    else:
        LAUNCHES += n_steps
    out = bufs[0:2] if n_steps % 2 else bufs[2:4]
    return state._replace(pos=out[0], vel=out[1])


def trace_kernel(state: ClothState, prm: torch.Tensor,
                 n_states: int) -> torch.Tensor:
    """:func:`trace_plain` with K1 (exact path): the start state is copied
    into ``traj[0]`` and substep s reads ``traj[s]`` and writes
    ``traj[s + 1]``, ``n_states - 1`` launches of the same kernel as
    :func:`multi_step_kernel`, so the trajectory equals the forward bit for
    bit. One world only."""
    global LAUNCHES
    with span("cloth.issue"):
        pos, vel, prm, pins, lead, h, w = _kernel_inputs(state, prm)
        if lead:
            raise ValueError(f"trace takes one world, got "
                             f"{tuple(pos.shape)}")
        traj = torch.empty((n_states, 6, h, w), dtype=torch.float32,
                           device=pos.device)
        if n_states <= 0:
            return traj
        traj[0, :3] = pos
        traj[0, 3:] = vel
        if n_states == 1 or pos.numel() == 0:
            return traj
        pin_ptrs = ((pins[0].data_ptr(), pins[1].data_ptr()) if pins
                    else (None, None))
        lib = _build.load("cloth_step", _SIGNATURES)
        with torch.cuda.device(pos.device):
            err = lib.wpe_cloth_trace(
                prm.data_ptr(), *pin_ptrs, traj.data_ptr(), h, w, n_states,
                int(pins is not None),
                torch.cuda.current_stream().cuda_stream)
        _build.check(lib, err, "cloth_step trace launch")
    LAUNCHES += n_states - 1
    return traj


def substep_with_force_kernel(state: ClothState, params: ClothParams, dt,
                              fext: torch.Tensor) -> ClothState:
    """K1f on a CUDA state of one world: one launch of ``csrc/
    cloth_step.cu``'s ``wpe_cloth_substep_with_force`` on the current
    stream with the force plane ``fext`` ``[3, H, W]`` in grid order (no
    permutation), into new buffers."""
    global LAUNCHES_FORCE
    pos, vel, prm, pins, lead, h, w = _kernel_inputs(
        state, _pack_params(params, dt))
    if lead:
        raise ValueError(f"substep_with_force takes one world, got "
                         f"{tuple(pos.shape)}")
    _check_plane(fext, (3, h, w), pos.device, "fext")
    fext = fext.detach().contiguous()
    out = torch.empty((2, 3, h, w), dtype=torch.float32, device=pos.device)
    if pos.numel() == 0:
        return state._replace(pos=out[0], vel=out[1])
    pin_ptrs = ((pins[0].data_ptr(), pins[1].data_ptr()) if pins
                else (None, None))
    lib = _build.load("cloth_step", _SIGNATURES)
    with torch.cuda.device(pos.device):
        err = lib.wpe_cloth_substep_with_force(
            prm.data_ptr(), pos.data_ptr(), vel.data_ptr(), *pin_ptrs,
            fext.data_ptr(), None, out[0].data_ptr(), out[1].data_ptr(),
            None, h, w, int(pins is not None),
            torch.cuda.current_stream().cuda_stream)
    _build.check(lib, err, "cloth_step substep_with_force launch")
    LAUNCHES_FORCE += 1
    return state._replace(pos=out[0], vel=out[1])


def substep_with_force_sorted_kernel(state: ClothState, blk: ForceBlock,
                                     f_sorted: torch.Tensor,
                                     want_sp: bool = True):
    """K1f's sorted entry on CUDA: one launch of
    ``wpe_cloth_substep_with_force`` with the block's inverse permutation,
    reading the pair forces ``f_sorted`` (f32 ``[3, n]``, contiguous, in
    the block's sorted order: K11's output) and with ``want_sp`` also
    writing the next substep's sorted positions. ``state`` is the one
    :func:`force_block` returned or this function's last result; the
    checks and the parameters are the block's. Returns ``(state, sp or
    None)``, the new state and ``sp`` ``[3, n]`` in new buffers."""
    global LAUNCHES_FORCE
    h, w = blk.h, blk.w
    hw = h * w
    if (not f_sorted.is_cuda or f_sorted.shape != (3, hw)
            or not f_sorted.is_contiguous()):
        raise ValueError(f"f_sorted: expected a contiguous CUDA [3, {hw}], "
                         f"got {tuple(f_sorted.shape)} on {f_sorted.device}")
    out = torch.empty((3 if want_sp else 2, 3, h, w), dtype=torch.float32,
                      device=f_sorted.device)
    o = out.data_ptr()
    plane = 12 * hw                    # bytes of three planes
    prm_ptr, mask_ptr, pin_ptr, inv_ptr = blk.ptrs
    args = (prm_ptr, state.pos.data_ptr(), state.vel.data_ptr(), mask_ptr,
            pin_ptr, f_sorted.data_ptr(), inv_ptr, o, o + plane,
            o + 2 * plane if want_sp else None, h, w,
            int(blk.pins is not None), blk.stream)
    if hw:
        if torch.cuda.current_device() == blk.device:
            err = blk.lib.wpe_cloth_substep_with_force(*args)
        else:
            with torch.cuda.device(blk.device):
                err = blk.lib.wpe_cloth_substep_with_force(*args)
        _build.check(blk.lib, err, "cloth_step substep_with_force launch")
        LAUNCHES_FORCE += 1
    planes = out.unbind(0)
    return state._replace(pos=planes[0], vel=planes[1]), (
        planes[2].view(3, hw) if want_sp else None)


def multi_step_window_kernel(pos, vel, pin_mask, pin_pos, params, dt,
                             n_steps: int, row0, h_global: int):
    """K1w on a CUDA window or batch of windows of one shape (the
    arguments of :func:`multi_step_window_plain`): ``n_steps`` launches of
    ``csrc/cloth_step.cu``'s ``wpe_cloth_multi_step_window`` on the
    current stream for the whole batch, ping-ponging between two new
    buffers (the inputs are only read). Returns ``(pos, vel)``
    ``[3, h, W]``, or ``[B, 3, h, W]`` for a batch."""
    return _window_kernel_packed(pos, vel, pin_mask, pin_pos,
                                 _pack_params(params, dt), n_steps, row0,
                                 h_global)


def _window_batch(pos, vel, pin_mask, pin_pos, prm, row0):
    """The checked kernel inputs of a window or a batch of windows, as a
    batch: ``(single, pos, vel, prm, pins, n_windows, h, w, row0)``, one
    window ``[3, h, W]`` taken as a batch of one, ``prm`` the shared
    ``[16]`` vector and ``row0`` the int32 ``[B]`` operand on the card."""
    single = pos.ndim == 3
    if single:
        pos, vel = pos[None], vel[None]
        if pin_mask is not None:
            pin_mask, pin_pos = pin_mask[None], pin_pos[None]
    if pos.ndim != 4:
        raise ValueError(f"window: expected [3, h, W] or [B, 3, h, W], got "
                         f"{tuple(pos.shape)}")
    state = ClothState(pos=pos, vel=vel, pin_mask=pin_mask, pin_pos=pin_pos)
    pos, vel, prm, pins, lead, h, w = _kernel_inputs(state, prm, shared=True)
    rows = _row0_device(row0, lead[0], pos.device)
    return single, pos, vel, prm, pins, lead[0], h, w, rows


def _window_kernel_packed(pos, vel, pin_mask, pin_pos, prm, n_steps: int,
                          row0, h_global: int):
    """:func:`multi_step_window_kernel` on the packed vector of
    :func:`_pack_params`: ``n_steps`` launches of K1w for the whole batch,
    a window being a batch of one."""
    global LAUNCHES_WINDOW
    if h_global < 1:
        raise ValueError(f"h_global must be positive, got {h_global}")
    single, pos, vel, prm, pins, n, h, w, rows = _window_batch(
        pos, vel, pin_mask, pin_pos, prm, row0)
    if n_steps <= 0 or pos.numel() == 0:
        return (pos[0], vel[0]) if single else (pos, vel)
    pin_ptrs = ((pins[0].data_ptr(), pins[1].data_ptr()) if pins
                else (None, None))
    bufs = torch.empty((4, n, 3, h, w), dtype=torch.float32,
                       device=pos.device)
    lib = _build.load("cloth_step", _SIGNATURES)
    with torch.cuda.device(pos.device):
        err = lib.wpe_cloth_multi_step_window(
            prm.data_ptr(), pos.data_ptr(), vel.data_ptr(), *pin_ptrs,
            bufs[0].data_ptr(), bufs[1].data_ptr(), bufs[2].data_ptr(),
            bufs[3].data_ptr(), n, h, w, n_steps, rows.data_ptr(),
            int(h_global), int(pins is not None),
            torch.cuda.current_stream().cuda_stream)
    _build.check(lib, err, "cloth_step window launch")
    LAUNCHES_WINDOW += n_steps
    out = bufs[0:2] if n_steps % 2 else bufs[2:4]
    return (out[0, 0], out[1, 0]) if single else (out[0], out[1])


def trace_window_kernel(pos, vel, pin_mask, pin_pos, prm: torch.Tensor,
                        n_states: int, row0,
                        h_global: int) -> torch.Tensor:
    """:func:`trace_window_plain` with K1w's body on a CUDA window or batch
    of windows, at any size (``wpe_cloth_trace_window``): the start states
    are copied into ``traj[0]`` and substep s reads ``traj[s]`` and writes
    ``traj[s + 1]``, ``n_states - 1`` launches for the whole batch, so each
    window's trajectory equals its forward (K1w, or K6w above the tiled
    limit) bit for bit. ``traj`` is ``[n_states, B, 6, h, W]`` for a batch,
    ``[n_states, 6, h, W]`` for one window."""
    global LAUNCHES_WINDOW_TRACE
    if h_global < 1:
        raise ValueError(f"h_global must be positive, got {h_global}")
    single, pos, vel, prm, pins, n, h, w, rows = _window_batch(
        pos, vel, pin_mask, pin_pos, prm, row0)
    traj = torch.empty((max(n_states, 0), n, 6, h, w), dtype=torch.float32,
                       device=pos.device)
    if n_states > 0:
        traj[0, :, :3] = pos
        traj[0, :, 3:] = vel
    if n_states > 1 and pos.numel():
        pin_ptrs = ((pins[0].data_ptr(), pins[1].data_ptr()) if pins
                    else (None, None))
        lib = _build.load("cloth_step", _SIGNATURES)
        with torch.cuda.device(pos.device):
            err = lib.wpe_cloth_trace_window(
                prm.data_ptr(), *pin_ptrs, traj.data_ptr(), n, h, w, n_states,
                rows.data_ptr(), int(h_global), int(pins is not None),
                torch.cuda.current_stream().cuda_stream)
        _build.check(lib, err, "cloth_step window trace launch")
        LAUNCHES_WINDOW_TRACE += n_states - 1
    return traj[:, 0] if single else traj


def _dispatch(state: ClothState, plain, kernel):
    dev = state.pos.device.type
    if dev == "cpu":
        return plain
    if dev == "cuda":
        return kernel
    raise ValueError(f"no cloth stepper for device {state.pos.device}")


def multi_step(state: ClothState, params: ClothParams, dt, n_steps: int,
               fast_math: bool = False) -> ClothState:
    """Run ``n_steps`` fused substeps; the drop-in counterpart of
    ``cloth_pallas.multi_step``, for one world (``[3, H, W]``) or a batch
    (``[B, 3, H, W]``). A CPU state takes the plain version, a CUDA state
    the kernel (K1, or for a batch K5r or K5); any other device raises.
    One world of more than :data:`_TILED_PARTICLE_LIMIT` particles takes
    the tiled steppers of ``cloth_tiled_kernel`` (on CUDA K6r where its
    resident tiles fit the card, else K6; on the CPU their plain version),
    exactly, with ``fast_math`` dropped.

    ``fast_math=True`` computes distances with rsqrt instead of
    sqrt + divide (≈1 ulp a step off the exact path)."""
    return multi_step_packed(state, _pack_params(params, dt), n_steps,
                             fast_math)


def multi_step_packed(state: ClothState, prm: torch.Tensor, n_steps: int,
                      fast_math: bool = False) -> ClothState:
    """:func:`multi_step` on the packed vector of :func:`_pack_params`."""
    h, w = state.pos.shape[-2:]
    if state.pos.ndim == 3 and h * w > _TILED_PARTICLE_LIMIT:
        from . import cloth_tiled_kernel

        if (state.pos.device.type == "cuda"
                and cloth_tiled_kernel.resident_fits(h, w, state.pos.device)):
            return cloth_tiled_kernel.multi_step_resident_kernel_packed(
                state, prm, n_steps)
        return cloth_tiled_kernel.multi_step_packed(state, prm, n_steps)
    step = _dispatch(state, multi_step_plain_packed, multi_step_kernel_packed)
    return step(state, prm, n_steps, fast_math)


def trace(state: ClothState, prm: torch.Tensor, n_states: int) -> torch.Tensor:
    """The trajectory ``[n_states, 6, H, W]`` of one world: CPU → the plain
    version, CUDA → K1, any other device raises."""
    return _dispatch(state, trace_plain, trace_kernel)(state, prm, n_states)


def substep_with_force(state: ClothState, params: ClothParams, dt,
                       fext: torch.Tensor) -> ClothState:
    """One fused exact substep with the external force plane ``fext`` (the
    counterpart of ``cloth_pallas.substep_with_force``; its ``fast_math``
    has no caller and no counterpart): CPU → the plain version, CUDA → K1f,
    any other device raises."""
    step = _dispatch(state, substep_with_force_plain, substep_with_force_kernel)
    return step(state, params, dt, fext)


def substep_with_force_sorted(state: ClothState, blk: ForceBlock,
                              f_sorted: torch.Tensor, want_sp: bool = True):
    """One fused exact substep with the pair forces ``f_sorted`` ``[3, n]``
    in the sorted order of a self-collision block (:func:`force_block`),
    and with ``want_sp`` the new positions in that order: ``(state, sp or
    None)``. CPU → the plain version, CUDA → K1f's sorted entry, any other
    device raises."""
    step = _dispatch(state, substep_with_force_sorted_plain,
                     substep_with_force_sorted_kernel)
    return step(state, blk, f_sorted, want_sp)


def multi_step_window(pos, vel, pin_mask, pin_pos, params, dt, n_steps: int,
                      row0, h_global: int):
    """``n_steps`` fused exact substeps on a halo-extended window of rows of
    a larger grid: the counterpart of ``cloth_pallas.multi_step_window``,
    the shard body of ``parallel/mesh.py``'s rows-sharded path.

    ``pos``/``vel``: the local ``[3, h_ext, W]`` including the halo rows
    the caller exchanged; ``pin_mask`` ``[h_ext, W]`` and ``pin_pos``
    ``[3, h_ext, W]`` or both None; ``row0``: the global row of local row 0
    (negative on the top shard, whose leading halo rows are dead);
    ``h_global``: the grid's height. Or a batch of windows of one shape:
    ``pos``/``vel`` ``[B, 3, h_ext, W]``, pins ``[B, h_ext, W]`` and
    ``[B, 3, h_ext, W]`` (a zero mask for a window without) and ``row0`` a
    sequence or an int32 tensor of B first rows; each window's output is
    the window's alone. The spring masks use global rows, so the grid's
    edges are where the unsharded kernel has them; the halo's staleness (2
    rows a substep) is the caller's to slice off. Returns ``(pos, vel)``
    with the halo rows, by :func:`_window_route`. JAX's ``fast_math`` has
    no caller here and no counterpart."""
    step = _window_route(pos, vel, packed=False)
    return step(pos, vel, pin_mask, pin_pos, params, dt, n_steps, row0,
                h_global)


def multi_step_window_packed(pos, vel, pin_mask, pin_pos, prm: torch.Tensor,
                             n_steps: int, row0, h_global: int):
    """:func:`multi_step_window` on the packed vector of
    :func:`_pack_params`, by the same route: the rows path's shard body,
    whose parameters are packed once a device and which gives it every
    window one device holds in an exchange block."""
    step = _window_route(pos, vel, packed=True)
    return step(pos, vel, pin_mask, pin_pos, prm, n_steps, row0, h_global)


def _each_window(step):
    """``step`` (a one-window stepper: pos, vel, pin_mask, pin_pos, the
    parameters, n_steps, row0, h_global) taken a window at a time over a
    batch, the results stacked."""
    def run(pos, vel, pin_mask, pin_pos, *args):
        if pos.ndim == 3:
            return step(pos, vel, pin_mask, pin_pos, *args)
        *prm, n_steps, row0, h_global = args
        outs = [step(pos[b], vel[b],
                     None if pin_mask is None else pin_mask[b],
                     None if pin_pos is None else pin_pos[b], *prm, n_steps,
                     r, h_global)
                for b, r in enumerate(_row0_list(row0, pos.shape[0]))]
        return (torch.stack([o[0] for o in outs]),
                torch.stack([o[1] for o in outs]))
    return run


def _window_route(pos, vel, packed: bool):
    """The window stepper for ``pos``'s size and device: CPU → the plain
    version, CUDA → K1w (one launch a substep for a whole batch), any
    other device raises; a window of more than
    :data:`_TILED_PARTICLE_LIMIT` particles takes ``cloth_tiled_kernel``'s
    (K6w on CUDA, its plain version on the CPU), one window a launch,
    which gives the same bits. ``packed``: the entries on the vector of
    :func:`_pack_params` in place of ``(params, dt)``."""
    if pos.shape[-2] * pos.shape[-1] > _TILED_PARTICLE_LIMIT:
        from . import cloth_tiled_kernel as ct

        pair = tuple(map(_each_window, (
            (ct._window_plain_packed, ct._window_kernel_packed) if packed
            else (ct.multi_step_window_plain, ct.multi_step_window_kernel))))
    else:
        pair = ((_window_plain_packed, _window_kernel_packed) if packed
                else (multi_step_window_plain, multi_step_window_kernel))
    return _dispatch(ClothState(pos=pos, vel=vel), *pair)


def trace_window(pos, vel, pin_mask, pin_pos, prm: torch.Tensor,
                 n_states: int, row0, h_global: int) -> torch.Tensor:
    """The trajectory ``[n_states, 6, h, W]`` of a row window, or
    ``[n_states, B, 6, h, W]`` of a batch of windows (the arguments of
    :func:`multi_step_window_packed`): CPU → the plain version, CUDA →
    K1w's body at every size, one launch a substep for the batch, any
    other device raises. ``traj[n]`` equals :func:`multi_step_window`'s
    ``n`` substeps bit for bit."""
    step = _dispatch(ClothState(pos=pos, vel=vel), trace_window_plain,
                     trace_window_kernel)
    return step(pos, vel, pin_mask, pin_pos, prm, n_states, row0, h_global)
