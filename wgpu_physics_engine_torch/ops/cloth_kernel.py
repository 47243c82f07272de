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
  launch per substep for all worlds);
* :func:`multi_step` takes the plain version for a CPU tensor and a
  kernel for a CUDA tensor, and raises for anything else. There is no
  fallback on CUDA, and no size limit: the TPU's VMEM routing
  (``_VMEM_PARTICLE_LIMIT``) and lane folding have no counterpart here.

All paths read one packed parameter vector per world (:func:`_pack_params`),
so the damping factor ``speed_damp ** dt`` is computed once per call, as in
the TPU kernel, and the paths agree to the last bit on one device.
"""

from __future__ import annotations

import ctypes

import torch

from ..core.state import ClothParams, ClothState
from . import _build

_EPS = 1e-6

# Spring families: (dr, dc, k-index), the order of cloth_pallas._FAMILIES.
_FAMILIES = (
    (0, 1, 0), (1, 0, 0),     # structural right, down
    (1, 1, 1), (1, -1, 1),    # shear down-right, down-left
    (0, 2, 2), (2, 0, 2),     # bend 2-right, 2-down
)

# Kernel launches by :func:`multi_step_kernel` (one per substep): K1 for
# one world, K5 for a batch. A run reads them to show that its path went
# through the kernels.
LAUNCHES = 0
LAUNCHES_BATCHED = 0

_SIGNATURES = {
    "wpe_cloth_multi_step": [ctypes.c_void_p] * 9 + [ctypes.c_int] * 5
                            + [ctypes.c_void_p],
    "wpe_cloth_multi_step_batched": [ctypes.c_void_p] * 9
                                    + [ctypes.c_int] * 6 + [ctypes.c_void_p],
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
    dt = torch.as_tensor(dt, dtype=torch.float32, device=p.mass.device)
    cols = [
        p.k_struct, p.k_shear, p.k_bend,
        p.c_struct, p.c_shear, p.c_bend,
        p.rest_struct, p.rest_shear, p.rest_bend,
        p.k_contact, p.mu, p.mass, p.gravity,
        torch.pow(p.speed_damp, dt),          # damp factor, constant per call
        p.globe_radius + p.particle_radius,   # min_dist
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


def _exact_dist_inv(d2):
    """(dist, 1/dist) with the zero guard; d2 = squared distance."""
    dist = torch.sqrt(d2)
    safe = dist >= _EPS
    inv = torch.where(safe, 1.0 / torch.where(safe, dist, 1.0), 0.0)
    return dist, inv


def _fast_dist_inv(d2):
    """The rsqrt form, under the guard ``d2 > EPS²``."""
    pos_d2 = d2 > _EPS * _EPS
    inv = torch.rsqrt(torch.where(pos_d2, d2, 1.0))
    return torch.where(pos_d2, d2 * inv, 0.0), torch.where(pos_d2, inv, 0.0)


def _substep_planes(carry, masks, prm, dist_inv, pins=None):
    """One substep on six ``[h, w]`` (or ``[B, h, w]``) planes (x, y, z, vx,
    vy, vz): the transcription of ``cloth_pallas._substep_planes``. ``prm``
    is the packed parameter vector as 16 0-d tensors, or for a batch as 16
    ``[B, 1, 1]`` tensors; ``pins`` is ``(pin_bool, px, py, pz)``."""
    x, y, z, vx, vy, vz = carry
    k, c, rest = prm[0:3], prm[3:6], prm[6:9]
    k_contact, mu, mass, gravity = prm[9], prm[10], prm[11], prm[12]
    damp_factor, min_dist, dt = prm[13], prm[14], prm[15]

    # ---- spring stencil (forces.wgsl:143-313) ----
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

    # ---- integrate (compute_movement.wgsl:70-174) ----
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


def _plane_params(params: ClothParams, dt, state: ClothState):
    """The packed vector as the 16 scalars :func:`_substep_planes` reads:
    0-d for one world or shared parameters, ``[B, 1, 1]`` for per-world
    ``[B]`` parameters of a batch."""
    prm = _pack_params(params, dt).to(state.pos.device)
    if prm.ndim == 1:
        return prm.unbind(0)
    if state.pos.ndim != 4 or prm.shape[0] != state.pos.shape[0]:
        raise ValueError(f"per-world params {tuple(prm.shape[:1])} need a "
                         f"state of as many worlds, got {tuple(state.pos.shape)}")
    return prm[:, :, None, None].unbind(1)


def multi_step_plain(state: ClothState, params: ClothParams, dt,
                     n_steps: int, fast_math: bool = False) -> ClothState:
    """``n_steps`` substeps of :func:`_substep_planes` on any device, for
    one world (``pos`` ``[3, H, W]``, 0-d params) or a batch (``pos``
    ``[B, 3, H, W]``, params ``[B]`` or shared 0-d; pins, if any, batched
    alongside: ``pin_mask`` ``[B, H, W]``, ``pin_pos`` ``[B, 3, H, W]``)."""
    h, w = state.pos.shape[-2:]
    prm = _plane_params(params, dt, state)
    masks = _family_masks(h, w, state.pos.device)
    dist_inv = _fast_dist_inv if fast_math else _exact_dist_inv
    pins = None
    if state.pin_mask is not None:
        pins = (state.pin_mask != 0, *state.pin_pos.unbind(-3))
    carry = (*state.pos.unbind(-3), *state.vel.unbind(-3))
    for _ in range(n_steps):
        carry = _substep_planes(carry, masks, prm, dist_inv, pins)
    return state._replace(pos=torch.stack(carry[:3], dim=-3),
                          vel=torch.stack(carry[3:], dim=-3))


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
    global LAUNCHES, LAUNCHES_BATCHED
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
    if n_steps <= 0 or pos.numel() == 0:
        return state
    pos, vel = pos.contiguous(), vel.contiguous()
    prm = _pack_params(params, dt).to(pos.device)
    if prm.shape[:-1] not in ((), lead):
        raise ValueError(f"params: expected 0-d or {lead} leaves for a state "
                         f"of {tuple(pos.shape)}, got {tuple(prm.shape[:-1])}")
    prm = prm.expand(lead + (16,)).contiguous()
    use_pins = state.pin_mask is not None
    if use_pins:
        pin_mask = state.pin_mask.to(device=pos.device, dtype=torch.float32)
        pin_mask = pin_mask.contiguous()
        pin_pos = state.pin_pos.contiguous()
        _check_plane(pin_mask, lead + (h, w), pos.device, "pin_mask")
        _check_plane(pin_pos, lead + (3, h, w), pos.device, "pin_pos")
        pin_ptrs = (pin_mask.data_ptr(), pin_pos.data_ptr())
    else:
        pin_ptrs = (None, None)
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
                *ptrs, lead[0], h, w, n_steps, int(use_pins), int(fast_math),
                stream)
        else:
            err = lib.wpe_cloth_multi_step(
                *ptrs, h, w, n_steps, int(use_pins), int(fast_math), stream)
    _build.check(lib, err, "cloth_step launch")
    if lead:
        LAUNCHES_BATCHED += n_steps
    else:
        LAUNCHES += n_steps
    out = bufs[0:2] if n_steps % 2 else bufs[2:4]
    return state._replace(pos=out[0], vel=out[1])


def multi_step(state: ClothState, params: ClothParams, dt, n_steps: int,
               fast_math: bool = False) -> ClothState:
    """Run ``n_steps`` fused substeps; the drop-in counterpart of
    ``cloth_pallas.multi_step``, for one world (``[3, H, W]``) or a batch
    (``[B, 3, H, W]``). A CPU state takes the plain version, a CUDA state
    the kernel (K1 or K5); any other device raises.

    ``fast_math=True`` computes distances with rsqrt instead of
    sqrt + divide (≈1 ulp a step off the exact path)."""
    dev = state.pos.device.type
    if dev == "cpu":
        return multi_step_plain(state, params, dt, n_steps, fast_math)
    if dev == "cuda":
        return multi_step_kernel(state, params, dt, n_steps, fast_math)
    raise ValueError(f"no cloth stepper for device {state.pos.device}")
