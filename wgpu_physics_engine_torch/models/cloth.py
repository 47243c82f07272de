"""Mass-spring cloth: the stencil formulation in eager torch.

The counterpart of ``wgpu_physics_engine_tpu/models/cloth.py`` (its
``spring_forces``, ``integrate``, ``substep``, ``multi_step``,
``frame_substeps`` and ``frame_update``): the model-level twin that every
cloth kernel is held to. The six spring families (structural right/down,
shear down-right/down-left, bend 2-right/2-down — ``cloth.rs:945-957``) are
slices of the ``[H, W]`` grid; each edge adds ``+F`` to its p0 slice and
``-F`` to its p1 slice, family by family, in the same order and with the
same fp32 expressions as the JAX stencil path.

Semantics are ``forces.wgsl`` (``compute_springs``) followed by
``compute_movement.wgsl`` (``main``). ``jax.lax.scan`` over substeps
becomes a Python loop; the fused kernel path is
:mod:`wgpu_physics_engine_torch.ops.cloth_kernel`, and
:func:`multi_step_diff` is the differentiable fused path
(:mod:`wgpu_physics_engine_torch.ops.cloth_grad_kernel`).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from ..core.state import ClothParams, ClothState
from ..ops import cloth_grad_kernel

_EPS = 1e-6

# (dr, dc) offsets for the six spring families, grouped by type.
STRUCT_OFFSETS = ((0, 1), (1, 0))
SHEAR_OFFSETS = ((1, 1), (1, -1))
BEND_OFFSETS = ((0, 2), (2, 0))


def _edge_slices(h: int, w: int, dr: int, dc: int):
    """Index slices selecting the p0 and p1 grids of edge family (dr, dc)."""
    if dc >= 0:
        c0 = slice(0, w - dc)
        c1 = slice(dc, w)
    else:
        c0 = slice(-dc, w)
        c1 = slice(0, w + dc)
    r0 = slice(0, h - dr)
    r1 = slice(dr, h)
    return (r0, c0), (r1, c1)


def _norm(a: torch.Tensor) -> torch.Tensor:
    """Euclidean norm over the leading (xyz) axis, with a gradient-safe
    zero (``_safe_norm`` of the JAX package): the primal is ``torch.sqrt``
    bit for bit (sqrt(0) = 0), but the sqrt never sees 0, whose derivative
    is inf (and inf times a ``where`` mask's 0 is NaN). An even grid puts
    a particle at x = z = 0, whose friction tangent is exactly zero under
    gravity alone."""
    sq = torch.sum(a * a, dim=0)
    positive = sq > 0
    return torch.where(positive, torch.sqrt(torch.where(positive, sq, 1.0)),
                       0.0)


def _edge_force(p0, p1, v0, v1, k, c, rest):
    """Spring force on p0 for one edge family (forces.wgsl:158-186): Hooke
    with a uniform rest length plus velocity-projection damping, zero where
    ``dist < 1e-6``. Inputs ``[3, h', w']``."""
    delta = p1 - p0
    dist = _norm(delta)
    safe = dist >= _EPS
    inv = torch.where(safe, 1.0 / torch.where(safe, dist, 1.0), 0.0)
    dirv = delta * inv[None]
    stretch = dist - rest
    hooke = (k * stretch)[None] * dirv
    v_along = torch.sum((v1 - v0) * dirv, dim=0)
    damp = (c * v_along)[None] * dirv
    return torch.where(safe[None], hooke + damp, 0.0)


def spring_forces(pos: torch.Tensor, vel: torch.Tensor,
                  p: ClothParams) -> torch.Tensor:
    """Accumulated spring force per particle, ``[3, H, W]``
    (compute_springs + accumulate_forces, forces.wgsl:143-313)."""
    h, w = pos.shape[-2:]
    force = torch.zeros_like(pos)
    families = (
        (STRUCT_OFFSETS, p.k_struct, p.c_struct, p.rest_struct),
        (SHEAR_OFFSETS, p.k_shear, p.c_shear, p.rest_shear),
        (BEND_OFFSETS, p.k_bend, p.c_bend, p.rest_bend),
    )
    for offsets, k, c, rest in families:
        for dr, dc in offsets:
            (r0, c0), (r1, c1) = _edge_slices(h, w, dr, dc)
            e = _edge_force(pos[:, r0, c0], pos[:, r1, c1],
                            vel[:, r0, c0], vel[:, r1, c1], k, c, rest)
            force[:, r0, c0] += e
            force[:, r1, c1] += -e
    return force


def integrate(pos: torch.Tensor, vel: torch.Tensor, spring_force: torch.Tensor,
              p: ClothParams, dt) -> Tuple[torch.Tensor, torch.Tensor]:
    """Movement kernel (compute_movement.wgsl:70-174) on ``[3, H, W]``:
    gravity → sphere penalty contact → Coulomb friction on the
    post-contact resultant → semi-implicit Euler with exponential speed
    damping → hard surface projection (zeroing velocity)."""
    zero = torch.zeros_like(p.mass)
    g = torch.stack([zero, p.mass * p.gravity, zero])
    total = spring_force + g[:, None, None]

    dist = _norm(pos)
    min_dist = p.globe_radius + p.particle_radius
    in_contact = (dist < min_dist) & (dist > _EPS)
    n = pos / torch.where(dist > _EPS, dist, 1.0)[None]
    f_contact = (p.k_contact * (min_dist - dist))[None] * n
    total = torch.where(in_contact[None], total + f_contact, total)

    ro_n_mag = torch.sum(total * n, dim=0)
    ro_t = total - ro_n_mag[None] * n
    ro_t_mag = _norm(ro_t)
    fric_active = in_contact & (ro_t_mag > _EPS)
    tangent = ro_t / torch.where(ro_t_mag > _EPS, ro_t_mag, 1.0)[None]
    f_fric = (-torch.minimum(ro_t_mag, p.mu * torch.abs(ro_n_mag)))[None] * tangent
    total = torch.where(fric_active[None], total + f_fric, total)

    vel = vel + (total / p.mass) * dt
    vel = vel * torch.pow(p.speed_damp, dt)
    pos = pos + vel * dt

    final_dist = _norm(pos)
    pen = final_dist < min_dist
    pen_safe = pen & (final_dist > _EPS)
    pen_center = pen & ~pen_safe
    nf = pos / torch.where(final_dist > _EPS, final_dist, 1.0)[None]
    center_pos = torch.stack([zero, min_dist, zero])
    pos = torch.where(pen_safe[None], nf * min_dist, pos)
    pos = torch.where(pen_center[None], center_pos[:, None, None], pos)
    vel = torch.where(pen[None], 0.0, vel)
    return pos, vel


def substep(state: ClothState, params: ClothParams, dt) -> ClothState:
    """One physics substep: the three compute passes of ``dispatch_compute``
    (cloth.rs:1283-1327) plus the optional fixed pins."""
    dt = torch.as_tensor(dt, dtype=torch.float32, device=state.pos.device)
    force = spring_forces(state.pos, state.vel, params)
    pos, vel = integrate(state.pos, state.vel, force, params, dt)
    if state.pin_mask is not None:
        pin = state.pin_mask[None]
        pos = torch.where(pin, state.pin_pos, pos)
        vel = torch.where(pin, 0.0, vel)
    return state._replace(pos=pos, vel=vel)


def multi_step(state: ClothState, params: ClothParams, dt,
               n_steps: int) -> ClothState:
    """``n_steps`` substeps — the reference's per-frame substep loop
    (cloth.rs:1474-1493) as a Python loop."""
    dt = torch.as_tensor(dt, dtype=torch.float32, device=state.pos.device)
    for _ in range(n_steps):
        state = substep(state, params, dt)
    return state


def multi_step_diff(state: ClothState, params: ClothParams, dt,
                    n_steps: int, segment: Optional[int] = None) -> ClothState:
    """Differentiable ``n_steps`` fused substeps of one world: the
    counterpart of the JAX package's ``multi_step_diff``.

    ``torch.autograd`` carries gradients with respect to ``state.pos``,
    ``state.vel``, ``state.pin_pos``, every ``ClothParams`` leaf and
    ``dt``. The forward is ``ops.cloth_kernel.multi_step`` run in segments
    of ``segment`` substeps (default 64), so its output equals that
    function's bit for bit; the backward re-runs each segment with the
    same stepper and walks it in reverse with the hand-written adjoint of
    one substep (``ops.cloth_grad_kernel``). A CPU state takes the plain
    versions, a CUDA state the kernels (K1 and ``csrc/cloth_grad.cu``), at
    every grid size: the TPU's size tiers and its XLA fallback have no
    counterpart here."""
    return cloth_grad_kernel.multi_step(state, params, dt, n_steps,
                                        segment=segment)


def frame_substeps(delta_time: float, time_scale: float, hz: float = 480.0,
                   max_substeps: int = 8) -> Tuple[int, float]:
    """Host-side substep schedule (cloth.rs:1461-1471):
    ``n = clamp(ceil(time_scale*dt*hz), 1, max)``; ``sub_dt = scaled/n``."""
    scaled = time_scale * delta_time
    n = max(1, min(max_substeps, math.ceil(scaled * hz)))
    return n, scaled / n


def frame_update(state: ClothState, params: ClothParams, delta_time: float,
                 time_scale: float = 1.0, hz: float = 480.0,
                 max_substeps: int = 8) -> ClothState:
    """One render-frame's worth of physics (App::update, cloth.rs:1458-1493)."""
    n, sub_dt = frame_substeps(delta_time, time_scale, hz, max_substeps)
    return multi_step(state, params, sub_dt, n)
