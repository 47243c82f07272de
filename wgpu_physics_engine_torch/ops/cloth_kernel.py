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
  fallback on CUDA. One world above :data:`_TILED_PARTICLE_LIMIT`
  particles (JAX's ``_VMEM_PARTICLE_LIMIT``, ``cloth_pallas.py:293``) goes
  to ``ops/cloth_tiled_kernel.py`` (K6, K substeps a launch by temporal
  blocking; on the CPU its plain version), as JAX sends it to
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
  K1f; the cloth self-collision loop feeds its pair forces in here): its
  plain version, and on CUDA the same device body as K1 with one more
  force plane read;
* :func:`multi_step_window` steps a halo-extended band of rows of a larger
  grid, the shard body of the rows-sharded path (``parallel/mesh.py``):
  ``cloth_pallas.multi_step_window``, kernel K1w. Its plain version is
  ``_substep_planes`` with the spring masks taken from global rows
  (:func:`_window_masks`); on CUDA it is K1's device body with the same
  masks. A window above :data:`_TILED_PARTICLE_LIMIT` particles goes, as
  one world does, to ``cloth_tiled_kernel.multi_step_window`` (K6w, K6's
  edge-once tiles with the same masks; on the CPU its plain version),
  equal to K1w bit for bit; JAX routes its windows by size too (above its
  VMEM budget to the XLA stencil, ``parallel/mesh.py`` ``_kernel_fits``);
* :func:`trace` re-runs substeps of one world with the same stepper and
  keeps each substep's input state, ``[K, 6, H, W]``: the trajectory the
  backward pass of ``ops/cloth_grad_kernel.py`` walks (the counterpart of
  ``cloth_pallas_grad._trace_kernel``, which runs K1's body).

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

# One world above this many particles takes the tiled stepper
# (``cloth_tiled_kernel``, K6): JAX's ``_VMEM_PARTICLE_LIMIT``. A module
# constant, so a test can lower it.
_TILED_PARTICLE_LIMIT = 100_000

# Kernel launches by :func:`multi_step_kernel` and :func:`trace_kernel`
# (one per substep): K1 for one world, K5 for a batch. A run reads them to
# show that its path went through the kernels.
LAUNCHES = 0
LAUNCHES_BATCHED = 0
# Launches of K1f by :func:`substep_with_force_kernel` (one per substep).
LAUNCHES_FORCE = 0
# Launches of K1w by :func:`multi_step_window_kernel` (one per substep).
LAUNCHES_WINDOW = 0

_SIGNATURES = {
    "wpe_cloth_multi_step": [ctypes.c_void_p] * 9 + [ctypes.c_int] * 5
                            + [ctypes.c_void_p],
    "wpe_cloth_multi_step_batched": [ctypes.c_void_p] * 9
                                    + [ctypes.c_int] * 6 + [ctypes.c_void_p],
    "wpe_cloth_trace": [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4
                       + [ctypes.c_void_p],
    "wpe_cloth_substep_with_force": [ctypes.c_void_p] * 8
                                    + [ctypes.c_int] * 3 + [ctypes.c_void_p],
    "wpe_cloth_multi_step_window": [ctypes.c_void_p] * 9
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


def _window_masks(h, w, row0: int, h_global: int, device):
    """The masks of :func:`_family_masks` for an ``[h, w]`` band of rows
    of a grid ``h_global`` rows high whose local row 0 is global row
    ``row0`` (negative on the top shard): an edge also needs both ends
    inside the global grid (``cloth_pallas._kernel(window=True)``
    :234-245), so halo rows beyond the grid join no edge."""
    lrow = torch.arange(h, device=device)[:, None]
    grow = lrow + row0
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
    h, w = state.pos.shape[-2:]
    prm = _plane_params(_pack_params(params, dt), state)
    carry = (*state.pos.unbind(-3), *state.vel.unbind(-3))
    carry = _substep_planes(carry, _family_masks(h, w, state.pos.device), prm,
                            _exact_dist_inv, _plain_pins(state),
                            fext.to(state.pos.device).unbind(-3))
    return state._replace(pos=torch.stack(carry[:3], dim=-3),
                          vel=torch.stack(carry[3:], dim=-3))


def multi_step_window_plain(pos, vel, pin_mask, pin_pos, params, dt,
                            n_steps: int, row0: int, h_global: int):
    """The plain version of K1w: ``n_steps`` exact substeps of the row
    window ``pos``/``vel`` ``[3, h, W]`` (halo rows included; ``row0`` the
    global row of local row 0, ``h_global`` the grid's height), on any
    device. Returns ``(pos, vel)`` with the halo rows, stale ones too."""
    h, w = pos.shape[-2:]
    state = ClothState(pos=pos, vel=vel, pin_mask=pin_mask, pin_pos=pin_pos)
    prm = _plane_params(_pack_params(params, dt), state)
    masks = _window_masks(h, w, row0, h_global, pos.device)
    pins = _plain_pins(state)
    carry = (*pos.unbind(-3), *vel.unbind(-3))
    for _ in range(n_steps):
        carry = _substep_planes(carry, masks, prm, _exact_dist_inv, pins)
    return torch.stack(carry[:3], dim=-3), torch.stack(carry[3:], dim=-3)


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


def _kernel_inputs(state: ClothState, prm: torch.Tensor):
    """Checked, contiguous kernel inputs: (pos, vel, the parameter table
    ``lead + (16,)``, the pin pointers, lead, h, w)."""
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
    if prm.shape[:-1] not in ((), lead) or prm.shape[-1:] != (16,):
        raise ValueError(f"params: expected 0-d or {lead} leaves for a state "
                         f"of {tuple(pos.shape)}, got {tuple(prm.shape[:-1])}")
    prm = prm.expand(lead + (16,)).contiguous()
    pins = None
    if state.pin_mask is not None:
        pin_mask = state.pin_mask.to(device=pos.device, dtype=torch.float32)
        pin_mask = pin_mask.contiguous()
        pin_pos = state.pin_pos.contiguous()
        _check_plane(pin_mask, lead + (h, w), pos.device, "pin_mask")
        _check_plane(pin_pos, lead + (3, h, w), pos.device, "pin_pos")
        pins = (pin_mask, pin_pos)
    return pos, vel, prm, pins, lead, h, w


def multi_step_kernel_packed(state: ClothState, prm: torch.Tensor,
                             n_steps: int,
                             fast_math: bool = False) -> ClothState:
    """:func:`multi_step_kernel` on the packed vector of
    :func:`_pack_params` (``[16]``, or ``[B, 16]`` for a batch)."""
    global LAUNCHES, LAUNCHES_BATCHED
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
                *ptrs, h, w, n_steps, int(pins is not None), int(fast_math),
                stream)
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
    pos, vel, prm, pins, lead, h, w = _kernel_inputs(state, prm)
    if lead:
        raise ValueError(f"trace takes one world, got {tuple(pos.shape)}")
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
            int(pins is not None), torch.cuda.current_stream().cuda_stream)
    _build.check(lib, err, "cloth_step trace launch")
    LAUNCHES += n_states - 1
    return traj


def substep_with_force_kernel(state: ClothState, params: ClothParams, dt,
                              fext: torch.Tensor) -> ClothState:
    """K1f on a CUDA state of one world: one launch of ``csrc/
    cloth_step.cu``'s ``wpe_cloth_substep_with_force`` on the current
    stream, the same device body as K1 with one more force plane, into new
    buffers."""
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
            fext.data_ptr(), out[0].data_ptr(), out[1].data_ptr(), h, w,
            int(pins is not None), torch.cuda.current_stream().cuda_stream)
    _build.check(lib, err, "cloth_step substep_with_force launch")
    LAUNCHES_FORCE += 1
    return state._replace(pos=out[0], vel=out[1])


def multi_step_window_kernel(pos, vel, pin_mask, pin_pos, params, dt,
                             n_steps: int, row0: int, h_global: int):
    """K1w on a CUDA window: ``n_steps`` launches of ``csrc/
    cloth_step.cu``'s ``wpe_cloth_multi_step_window`` on the current
    stream, ping-ponging between two new buffers (the inputs are only
    read). Returns ``(pos, vel)`` ``[3, h, W]``."""
    global LAUNCHES_WINDOW
    state = ClothState(pos=pos, vel=vel, pin_mask=pin_mask, pin_pos=pin_pos)
    pos, vel, prm, pins, lead, h, w = _kernel_inputs(
        state, _pack_params(params, dt))
    if lead:
        raise ValueError(f"multi_step_window takes one window, got "
                         f"{tuple(pos.shape)}")
    if h_global < 1:
        raise ValueError(f"h_global must be positive, got {h_global}")
    if n_steps <= 0 or pos.numel() == 0:
        return pos, vel
    pin_ptrs = ((pins[0].data_ptr(), pins[1].data_ptr()) if pins
                else (None, None))
    bufs = torch.empty((4, 3, h, w), dtype=torch.float32, device=pos.device)
    lib = _build.load("cloth_step", _SIGNATURES)
    with torch.cuda.device(pos.device):
        err = lib.wpe_cloth_multi_step_window(
            prm.data_ptr(), pos.data_ptr(), vel.data_ptr(), *pin_ptrs,
            bufs[0].data_ptr(), bufs[1].data_ptr(), bufs[2].data_ptr(),
            bufs[3].data_ptr(), h, w, n_steps, int(row0), int(h_global),
            int(pins is not None), torch.cuda.current_stream().cuda_stream)
    _build.check(lib, err, "cloth_step window launch")
    LAUNCHES_WINDOW += n_steps
    out = bufs[0:2] if n_steps % 2 else bufs[2:4]
    return out[0], out[1]


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
    the kernel (K1 or K5); any other device raises. One world of more than
    :data:`_TILED_PARTICLE_LIMIT` particles takes
    ``cloth_tiled_kernel.multi_step`` (K6 on CUDA, its plain version on
    the CPU), exactly, with ``fast_math`` dropped.

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


def multi_step_window(pos, vel, pin_mask, pin_pos, params, dt, n_steps: int,
                      row0: int, h_global: int):
    """``n_steps`` fused exact substeps on a halo-extended window of rows of
    a larger grid: the counterpart of ``cloth_pallas.multi_step_window``,
    the shard body of ``parallel/mesh.py``'s rows-sharded path.

    ``pos``/``vel``: the local ``[3, h_ext, W]`` including the halo rows
    the caller exchanged; ``pin_mask`` ``[h_ext, W]`` and ``pin_pos``
    ``[3, h_ext, W]`` or both None; ``row0``: the global row of local row 0
    (negative on the top shard, whose leading halo rows are dead);
    ``h_global``: the grid's height. The spring masks use global rows, so
    the grid's edges are where the unsharded kernel has them; the halo's
    staleness (2 rows a substep) is the caller's to slice off. Returns
    ``(pos, vel)`` with the halo rows. CPU → the plain version, CUDA →
    K1w, any other device raises; a window of more than
    :data:`_TILED_PARTICLE_LIMIT` particles takes
    ``cloth_tiled_kernel.multi_step_window`` (K6w on CUDA, its plain
    version on the CPU), which gives the same bits. JAX's ``fast_math``
    has no caller here and no counterpart."""
    if pos.shape[-2] * pos.shape[-1] > _TILED_PARTICLE_LIMIT:
        from . import cloth_tiled_kernel

        return cloth_tiled_kernel.multi_step_window(
            pos, vel, pin_mask, pin_pos, params, dt, n_steps, row0, h_global)
    state = ClothState(pos=pos, vel=vel)
    step = _dispatch(state, multi_step_window_plain, multi_step_window_kernel)
    return step(pos, vel, pin_mask, pin_pos, params, dt, n_steps, row0,
                h_global)
