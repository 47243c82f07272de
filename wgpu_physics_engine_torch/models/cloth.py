"""Mass-spring cloth: the stencil formulation in eager torch.

The counterpart of ``wgpu_physics_engine_tpu/models/cloth.py`` (its
``spring_forces``, ``integrate``, ``substep``, ``multi_step``,
``frame_substeps`` and ``frame_update``, and the cloth self-collision
path: ``self_collision_forces``, ``multi_step_self_collide``,
``multi_step_self_collide_diff``, ``default_self_collision_grid``): the
model-level twin that every cloth kernel is held to. The six spring families (structural right/down,
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
from torch.autograd.function import once_differentiable
from torch.utils.checkpoint import checkpoint

from ..core.state import ClothParams, ClothState
from ..ops import cloth_grad_kernel, cloth_kernel, granular_kernel
from . import broadphase
from ..utils.profiling import span

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


def spring_forces(pos: torch.Tensor, vel: torch.Tensor, p: ClothParams,
                  row_valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Accumulated spring force per particle, ``[3, H, W]``
    (compute_springs + accumulate_forces, forces.wgsl:143-313).

    ``row_valid`` (optional ``[H]`` bool) marks the rows that exist in the
    global grid: the rows-sharded path (``parallel/mesh.py``) steps a
    shard's rows with halo rows around them, and an edge touching a row
    beyond the grid contributes nothing. None means every row is real."""
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
            if row_valid is not None:
                edge_ok = row_valid[r0] & row_valid[r1]
                e = torch.where(edge_ok[None, :, None], e, 0.0)
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


def _pinned(state: ClothState, pos, vel) -> ClothState:
    """The new ``pos``/``vel`` with the fixed pins of ``state`` applied."""
    if state.pin_mask is not None:
        pin = state.pin_mask[None]
        pos = torch.where(pin, state.pin_pos, pos)
        vel = torch.where(pin, 0.0, vel)
    return state._replace(pos=pos, vel=vel)


def substep(state: ClothState, params: ClothParams, dt) -> ClothState:
    """One physics substep: the three compute passes of ``dispatch_compute``
    (cloth.rs:1283-1327) plus the optional fixed pins."""
    dt = torch.as_tensor(dt, dtype=torch.float32, device=state.pos.device)
    force = spring_forces(state.pos, state.vel, params)
    pos, vel = integrate(state.pos, state.vel, force, params, dt)
    return _pinned(state, pos, vel)


def self_collision_forces(pos: torch.Tensor, vel: torch.Tensor,
                          p: ClothParams, grid_spec, k_self=None
                          ) -> torch.Tensor:
    """Cloth self-collision (BASELINE configs[3]), rebuilt every call: the
    sorted-grid broad phase over the cloth's own particles (the grid's
    origin follows the cloth's bounding box) and the pairwise sphere
    penalty of ``2·particle_radius`` (``broadphase.pair_forces_sorted``),
    ``[3, H, W]``. An extension over the reference, which lets the cloth
    pass through itself. The candidate window is capped at ``3 ·
    grid_spec.capacity`` per group; a tightly compressed fold can drop
    contacts (the frozen schedule's slab kernel has no such cap)."""
    h, w = pos.shape[-2:]
    flat_pos = pos.reshape(3, h * w)
    origin = flat_pos.amin(1) - grid_spec.cell_size
    grid = broadphase.build_sorted_grid(flat_pos, vel.reshape(3, h * w),
                                        grid_spec, origin)
    k = p.k_contact if k_self is None else k_self
    f = broadphase.pair_forces_sorted(grid, grid_spec, p.particle_radius, k,
                                      window=3 * grid_spec.capacity,
                                      origin=origin)
    return f.reshape(3, h, w)


def substep_self_collide(state: ClothState, params: ClothParams, dt,
                         grid_spec) -> ClothState:
    """A substep with the self-collision forces added to the springs
    (springs + self-contact → integrate → pins)."""
    dt = torch.as_tensor(dt, dtype=torch.float32, device=state.pos.device)
    force = spring_forces(state.pos, state.vel, params)
    force = force + self_collision_forces(state.pos, state.vel, params,
                                          grid_spec)
    pos, vel = integrate(state.pos, state.vel, force, params, dt)
    return _pinned(state, pos, vel)


def _default_slab(block: int) -> int:
    """The per-dx slab of the thin candidate set: the block's own span and
    ~3 y-columns, with headroom for draped states whose columns compress
    (the JAX package measured no drops at 640 over its 512-substep bench
    trajectory)."""
    return max(640, (5 * block // 2 + 127) // 128 * 128)


def _frozen_structs(flat_pos: torch.Tensor, flat_vel: torch.Tensor,
                    grid_spec, block: int, slab: int, stats: bool = False):
    """One rebuild of the frozen self-collision schedule: the sorted grid
    on the cloth's bounding box and its thin-CIV candidate set. Returns
    ``(grid, slabs, dropped)``; a profiler trace shows it as the range
    ``cloth.self_collide.rebuild``."""
    n = flat_pos.shape[-1]
    with span("cloth.self_collide.rebuild"):
        origin = flat_pos.amin(1) - grid_spec.cell_size
        grid = broadphase.build_sorted_grid(flat_pos, flat_vel, grid_spec,
                                            origin)
        n_pad = -(-max(n, slab) // block) * block
        slabs, dropped = granular_kernel.build_offsets_civ(
            grid, grid_spec, block, slab, n_pad, thin=True, stats=stats)
    return grid, slabs, dropped


def _self_collide_block(state: ClothState, params: ClothParams, dt,
                        length: int, grid_spec, block: int, slab: int,
                        use_kernel: bool = True, stats: bool = False):
    """Frozen-window self-collision: one broad-phase rebuild and ``length``
    substeps against it. The sort order is frozen for the block. Per
    substep the pair forces come from ``granular_kernel.
    contact_forces_sorted`` on the thin (3-group) candidate set (K11) in
    that order, and enter one fused cloth substep with the force plane
    (``cloth_kernel.substep_with_force_sorted``, K1f), which reads them
    through the block's inverse permutation and writes the next substep's
    sorted positions; its parameters are packed once a block
    (``cloth_kernel.force_block``), and the first substep's sorted
    positions are the rebuild's. With ``use_kernel=False`` the forces are
    gathered to the grid and the positions to the sorted order every
    substep around the stencil springs and ``integrate``. Valid while the
    displacement between rebuilds stays under ``(cell_size −
    2·particle_radius)/2`` (size the grid with a skin). Returns ``(state,
    dropped)``."""
    h, w = state.pos.shape[-2:]
    n = h * w
    grid, slabs, dropped = _frozen_structs(
        state.pos.reshape(3, n), state.vel.reshape(3, n), grid_spec, block,
        slab, stats)
    inv = broadphase._inverse(grid.order)
    md = 2.0 * params.particle_radius
    if use_kernel:
        blk, state = cloth_kernel.force_block(state, params, dt, inv)
        sp = grid.sorted_pos                           # frozen sort order
        for s in range(length):
            f_self = granular_kernel.contact_forces_sorted(
                sp, md, params.k_contact, slabs)
            state, sp = cloth_kernel.substep_with_force_sorted(
                state, blk, f_self, want_sp=s + 1 < length)
        return state, dropped
    order = grid.order.long()
    for _ in range(length):
        sp = state.pos.reshape(3, n)[:, order]        # frozen sort order
        f_self = granular_kernel.contact_forces_sorted(
            sp, md, params.k_contact, slabs)[:, inv].reshape(3, h, w)
        force = spring_forces(state.pos, state.vel, params) + f_self
        pos, vel = integrate(state.pos, state.vel, force, params, dt)
        state = _pinned(state, pos, vel)
    return state, dropped


def multi_step_self_collide(state: ClothState, params: ClothParams, dt,
                            n_steps: int, grid_spec, rebuild_every: int = 1,
                            pallas_block: int = 256,
                            pallas_slab: Optional[int] = None,
                            return_stats: bool = False,
                            use_spring_kernel: Optional[bool] = None):
    """``n_steps`` self-colliding substeps (BASELINE configs[3]).

    ``rebuild_every=1`` rebuilds the broad phase every substep
    (:func:`substep_self_collide`, exact). ``rebuild_every=K>1`` freezes it
    for K substeps: the pair forces of each substep come from the granular
    contact kernel K11 over the thin candidate set (``pallas_slab=None``
    sizes the per-dx slab from ``pallas_block``), and springs, contact and
    integration run as one fused cloth substep with the force plane (K1f).
    On a CPU state both are their plain versions. Size the grid with a
    skin (``default_self_collision_grid(..., skin=...)``) so the Verlet
    invariant holds between rebuilds.

    ``use_spring_kernel=False`` keeps springs and integration on the
    stencil path (the fp32 reference of the tests); ``None`` means the
    kernel at every size (the TPU's VMEM limit has no counterpart).
    ``return_stats`` also returns the worst per-rebuild dropped-candidate
    count (int32 0-d; exact; 0 on the rebuild-every-substep path)."""
    dev = state.pos.device
    dt = torch.as_tensor(dt, dtype=torch.float32, device=dev)
    dmax = torch.zeros((), dtype=torch.int32, device=dev)
    if rebuild_every <= 1:
        for _ in range(n_steps):
            state = substep_self_collide(state, params, dt, grid_spec)
        return (state, dmax) if return_stats else state
    use_kernel = True if use_spring_kernel is None else use_spring_kernel
    slab = _default_slab(pallas_block) if pallas_slab is None else pallas_slab
    n_outer, rem = divmod(n_steps, rebuild_every)
    for length in [rebuild_every] * n_outer + ([rem] if rem else []):
        state, d = _self_collide_block(state, params, dt, length, grid_spec,
                                       pallas_block, slab, use_kernel,
                                       stats=return_stats)
        dmax = torch.maximum(dmax, d)
    return (state, dmax) if return_stats else state


class _FrozenSelfContact(torch.autograd.Function):
    """The pair contact forces on sorted positions ``[3, n]`` over a frozen
    candidate set: K11 forward, differentiable in the positions, ``md``
    and ``kc``.

    Backward: the pair force is the negative gradient of a pair potential
    and the CIV candidate relation is symmetric, so J (w.r.t. positions) is
    symmetric and ``Jᵀf̄`` is K12 applied with ``u = f̄``. The parameter
    cotangents need no launch: the force is linear in ``kc``, so ``k̄c =
    ⟨f̄, f⟩ / kc``; it is homogeneous of degree 1 in (positions, md), so
    ``md·∂f/∂md = f − J·p`` and ``m̄d = (⟨f̄, f⟩ − ⟨Jᵀf̄, p⟩) / md``. Needs
    zero dropped slab entries (a drop breaks the pairing)."""

    @staticmethod
    def forward(ctx, posc, md, kc, slabs):
        f = granular_kernel.contact_forces_sorted(posc, md, kc, slabs)
        ctx.save_for_backward(posc, f, md, kc)
        ctx.slabs = slabs
        return f

    @staticmethod
    @once_differentiable
    def backward(ctx, fbar):
        posc, f, md, kc = ctx.saved_tensors
        ft = granular_kernel.contact_force_jvp_sorted(
            posc, fbar.contiguous(), md, kc, ctx.slabs)
        posbar = ft[3:]
        ff = (fbar.double() * f.double()).sum()
        fjp = (posbar.double() * posc.double()).sum()
        kcbar = torch.where(kc != 0.0, ff / torch.where(kc != 0.0, kc, 1.0),
                            0.0)
        mdbar = torch.where(md != 0.0,
                            (ff - fjp) / torch.where(md != 0.0, md, 1.0), 0.0)
        return posbar, mdbar.to(md.dtype), kcbar.to(kc.dtype), None


def _sc_diff_segment(state: ClothState, params: ClothParams, dt,
                     length: int, grid_spec, block: int,
                     slab: int) -> ClothState:
    """One frozen rebuild segment of the differentiable self-collision
    path: the broad-phase structures from the detached positions
    (discrete, locally constant), then ``length`` substeps of (the contact
    force through :class:`_FrozenSelfContact` → stencil springs,
    ``integrate`` and pins), each under ``torch.utils.checkpoint``, so the
    backward keeps one substep's activations."""
    h, w = state.pos.shape[-2:]
    n = h * w
    frozen = state.pos.detach().reshape(3, n)
    grid, slabs, _ = _frozen_structs(frozen, torch.zeros_like(frozen),
                                     grid_spec, block, slab)
    order = grid.order.long()
    inv = broadphase._inverse(grid.order)
    md = 2.0 * params.particle_radius

    def sub(pos, vel, pin_pos):
        sp = pos.reshape(3, n)[:, order]
        f_self = _FrozenSelfContact.apply(sp, md, params.k_contact, slabs)
        force = (spring_forces(pos, vel, params)
                 + f_self[:, inv].reshape(3, h, w))
        pos1, vel1 = integrate(pos, vel, force, params, dt)
        out = _pinned(state._replace(pin_pos=pin_pos), pos1, vel1)
        return out.pos, out.vel

    pos, vel = state.pos, state.vel
    for _ in range(length):
        pos, vel = checkpoint(sub, pos, vel, state.pin_pos,
                              use_reentrant=False)
    return state._replace(pos=pos, vel=vel)


def multi_step_self_collide_diff(state: ClothState, params: ClothParams, dt,
                                 n_steps: int, grid_spec,
                                 rebuild_every: int = 8,
                                 pallas_block: int = 256,
                                 pallas_slab: Optional[int] = None
                                 ) -> ClothState:
    """Differentiable :func:`multi_step_self_collide` (the frozen schedule,
    the contact forces on K11 and their transpose on K12).

    ``torch.autograd`` carries gradients with respect to ``state.pos``,
    ``state.vel``, ``state.pin_pos``, every ``ClothParams`` leaf
    (``k_contact`` and ``particle_radius`` through the contact kernel, by
    the identities of :class:`_FrozenSelfContact`) and ``dt``. Springs and
    integration stay on the differentiable stencil path (the
    ``use_spring_kernel=False`` variant of the production path). The
    contracts are the production path's: the Verlet skin invariant between
    rebuilds, zero dropped slab entries (check with ``return_stats``), and
    piecewise differentiability across contact activations."""
    dt = torch.as_tensor(dt, dtype=torch.float32, device=state.pos.device)
    slab = _default_slab(pallas_block) if pallas_slab is None else pallas_slab
    k = max(1, rebuild_every)
    n_full, rem = divmod(n_steps, k)
    for length in [k] * n_full + ([rem] if rem else []):
        state = _sc_diff_segment(state, params, dt, length, grid_spec,
                                 pallas_block, slab)
    return state


def default_self_collision_grid(config, pad: float = 1.5,
                                skin: float = 0.0) -> broadphase.GridSpec:
    """GridSpec for cloth self-collision: the cell is the contact diameter
    plus ``skin`` (for the frozen rebuild-every-K schedule the displacement
    between rebuilds must stay under ``skin/2``), the dims span the cloth's
    possible extent; the origin follows the cloth's bounding box at every
    rebuild, so the domain stays tight. Dims stay at most 255 (cell ids
    below 2**24, the CIV cid range)."""
    r = config.particle_radius
    cell = 2.05 * r + skin
    span = pad * max(config.cloth_size, 2.2 * config.globe_radius)
    dims = min(int(span / cell) + 2, 255)
    return broadphase.GridSpec(origin=(0.0, 0.0, 0.0), cell_size=cell,
                               dims=(dims, dims, dims), capacity=8)


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
