"""Granular pile: up to millions of free particles with gravity, ground
plane bounce, box walls and uniform-grid pairwise contact (BASELINE
configs[2]): the counterpart of ``wgpu_physics_engine_tpu/models/granular.py``,
its differentiable :func:`multi_step_diff` included.

Two broad-phase schedules:

* ``rebuild_every=1``: rebuild the sorted grid and its candidate windows
  every substep;
* ``rebuild_every=K>1`` (default): frozen candidates. The sorted grid is
  built once with query radius ``2·radius + skin`` and reused for K
  substeps; correct while relative displacement between rebuilds stays
  under ``skin/2``.

Two routes through the frozen schedule (:func:`multi_step`'s ``backend``):
``"kernel"`` (the JAX package's ``"pallas"``) steps each block over the
slab windows with ``ops.granular_kernel.substep_sorted``, the CUDA kernel
K10 on a CUDA device and its plain version on the CPU; ``"gather"`` (the
JAX package's ``"xla"``) builds a compacted ``[N, max_neighbors]``
candidate list and gathers it every substep.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import numpy as np
import torch

from . import broadphase
from ..core.state import ParticleState
from ..ops import granular_kernel
from ..utils.profiling import span

_F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class GranularConfig:
    """Static granular-scene config. The box spans [-bounds, bounds]^3 with
    a solid floor at y = -bounds (the ground plane). The fields and
    defaults are the JAX package's."""

    num_particles: int = 1_000_000
    bounds: float = 10.0
    radius: float = 0.04
    k_contact: float = 2000.0
    gravity: float = -9.81
    restitution: float = 0.5         # ground/wall bounce energy retention
    grid_capacity: int = 8
    window: int = 32                 # candidates per z-triple window
    skin: Optional[float] = None     # Verlet skin; default 2·radius
    max_neighbors: int = 48          # frozen-list width
    rebuild_every: int = 8           # substeps per neighbour-list rebuild
    pallas_block: int = 128          # sorted particles per kernel block
    pallas_slab: int = 384           # slab width (candidates per group)
    pipeline: bool = True            # TPU slab-DMA prefetch; changes no
    # bit of the result, accepted and ignored here
    civ: bool = True                 # cid-interval validity: the kernel
    # tests candidates by cid difference (no per-particle window table);
    # the same candidate sets as the window formulation
    thin: bool = False               # 3-group CIV: one cid interval
    # dx·D ± (d2+1) per dx, a superset of the 9 intervals whose extras
    # fail the distance test (forces differ from full CIV only by the
    # order of the sums). CIV only; size pallas_slab accordingly.

    @property
    def skin_value(self) -> float:
        return 2.0 * self.radius if self.skin is None else self.skin

    @property
    def query_radius(self) -> float:
        return 2.0 * self.radius + (
            self.skin_value if self.rebuild_every > 1 else 0.0)

    def grid_spec(self) -> broadphase.GridSpec:
        cell = max(self.query_radius, 2.0 * self.bounds / 128)
        dims = int(2.0 * self.bounds / cell) + 1
        return broadphase.GridSpec(
            origin=(-self.bounds, -self.bounds, -self.bounds),
            cell_size=cell,
            dims=(dims, dims, dims),
            capacity=self.grid_capacity,
        )


def init_state(config: GranularConfig,
               generator: Optional[torch.Generator] = None,
               device="cuda") -> ParticleState:
    """Particles jittered on a lattice in the upper half of the box, on
    ``device`` (the card unless the caller asks for the CPU). The lattice
    is the JAX package's to the bit; the jitter, uniform in ±0.2 of the
    spacing, is drawn on the CPU from ``generator`` (jax.random bits cannot
    be reproduced), so a seed gives the same pile on every device."""
    n = config.num_particles
    side = int(math.ceil(np.float32(n ** (1.0 / 3.0))))
    i = torch.arange(side ** 3, dtype=torch.int32)[:n]
    x = (i % side).to(_F32)
    y = ((i // side) % side).to(_F32)
    z = (i // (side * side)).to(_F32)
    span = 1.6 * config.bounds
    scale = span / side
    base = torch.stack([
        x * scale - 0.8 * config.bounds,
        y * scale * 0.5 + 0.0,                  # upper half
        z * scale - 0.8 * config.bounds,
    ])
    u = torch.rand((3, n), generator=generator, dtype=_F32)
    jitter = 0.2 * scale * (u * 2.0 - 1.0)
    pos = (base + jitter).to(device)
    return ParticleState(pos=pos, vel=torch.zeros((3, n), dtype=_F32,
                                                  device=device))


def _f32(v, device) -> torch.Tensor:
    return torch.as_tensor(v, dtype=_F32).to(device)


def _wall_response(pos: torch.Tensor, vel: torch.Tensor,
                   config: GranularConfig, e=None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Ground plane and walls: clamp and reflect with restitution."""
    limit = _f32(config.bounds - config.radius, pos.device)
    e = _f32(config.restitution, pos.device) if e is None else e
    hit_low = (pos < -limit) & (vel < 0.0)
    hit_high = (pos > limit) & (vel > 0.0)
    vel = torch.where(hit_low | hit_high, -e * vel, vel)
    pos = torch.minimum(torch.maximum(pos, -limit), limit)
    return pos, vel


def _add_gravity(force: torch.Tensor, grav) -> torch.Tensor:
    return torch.stack([force[0], force[1] + grav, force[2]])


def substep(state: ParticleState, config: GranularConfig, dt,
            return_stats: bool = False, kc=None, grav=None, e=None):
    """One step with a grid rebuild: sorted grid → windowed pair forces →
    gravity → integrate → ground/wall response. With
    ``return_stats=True`` also returns the dropped-candidate count.
    ``kc``/``grav``/``e`` override the config's constants (0-d tensors)."""
    dev = state.pos.device
    spec = config.grid_spec()
    grid = broadphase.build_sorted_grid(state.pos, state.vel, spec)
    force, dropped = broadphase.pair_forces_sorted(
        grid, spec, config.radius,
        _f32(config.k_contact, dev) if kc is None else kc,
        window=config.window, return_stats=True)
    force = _add_gravity(force, _f32(config.gravity, dev) if grav is None
                         else grav)                      # unit mass
    vel = state.vel + force * dt
    pos = state.pos + vel * dt
    pos, vel = _wall_response(pos, vel, config, e)
    new = ParticleState(pos=pos, vel=vel)
    if return_stats:
        return new, dropped
    return new


def _frozen_substep(pos: torch.Tensor, vel: torch.Tensor, idx: torch.Tensor,
                    mask: torch.Tensor, config: GranularConfig, dt,
                    kc=None, grav=None, e=None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One substep against a frozen candidate list (sorted order), the
    gather route."""
    dev = pos.device
    min_dist = 2.0 * _f32(config.radius, dev)
    kc = _f32(config.k_contact, dev) if kc is None else kc
    grav = _f32(config.gravity, dev) if grav is None else grav
    d = pos[:, :, None] - pos[:, idx.long()]                 # [3, N, M]
    dist = broadphase._safe_norm(torch.sum(d * d, dim=0))
    touching = mask & (dist < min_dist) & (dist > 1e-6)
    inv = 1.0 / torch.where(dist > 1e-6, dist, 1.0)
    f = torch.where(touching[None], (kc * (min_dist - dist) * inv)[None] * d,
                    0.0)
    force = _add_gravity(torch.sum(f, dim=2), grav)
    vel = vel + force * dt
    pos = pos + vel * dt
    return _wall_response(pos, vel, config, e)


def _run_block(state: ParticleState, config: GranularConfig, dt, length: int,
               kc=None, grav=None, e=None) -> Tuple[ParticleState, torch.Tensor]:
    """Gather route: rebuild the frozen candidate list, run ``length``
    substeps on it, return the state in ORIGINAL particle order and the
    dropped-candidate count."""
    spec = config.grid_spec()
    grid = broadphase.build_sorted_grid(state.pos, state.vel, spec)
    idx, mask, dropped = broadphase.build_candidates(
        grid, spec, config.query_radius, config.window, config.max_neighbors)
    pos, vel = grid.sorted_pos, grid.sorted_vel
    for _ in range(length):
        pos, vel = _frozen_substep(pos, vel, idx, mask, config, dt, kc, grav,
                                   e)
    inv = broadphase._inverse(grid.order)
    return ParticleState(pos=pos[:, inv], vel=vel[:, inv]), dropped


def pad_slots(n: int, config: GranularConfig, unit: Optional[int] = None
              ) -> int:
    """The padded slot count of a rebuild: the least multiple of ``unit``
    (default the block) that holds ``n`` particles and one slab. The slab
    offsets are clipped to ``[0, n_pad - slab]``, which binds the candidate
    set; the sharded path pads to ``block·8·D``
    (``parallel/granular_mesh.py``), as JAX's does."""
    unit = config.pallas_block if unit is None else unit
    return -(-max(n, config.pallas_slab) // unit) * unit


def rebuild(pos: torch.Tensor, vel: torch.Tensor, config: GranularConfig,
            stats: bool = False, n_pad: Optional[int] = None):
    """The kernel route's rebuild: the sorted grid and the frozen candidate
    set of one block (CIV offsets, or the window table where ``civ`` is
    off or a grid dimension is below 3). Returns ``(grid, slabs,
    dropped)``; ``stats`` selects the exact dropped count (CIV) over the
    sound fast indicator; ``n_pad`` the padded slot count (default
    :func:`pad_slots`; a multiple of the block that holds the particles and
    one slab). A profiler trace shows it as the range
    ``granular.rebuild``."""
    with span("granular.rebuild"):
        spec = config.grid_spec()
        grid = broadphase.build_sorted_grid(pos, vel, spec)
        n = pos.shape[-1]
        block, slab = config.pallas_block, config.pallas_slab
        if n_pad is None:
            n_pad = pad_slots(n, config)
        elif n_pad % block or n_pad < max(n, slab):
            raise ValueError(f"n_pad {n_pad} must be a multiple of the block "
                             f"{block} holding {n} particles and a slab of "
                             f"{slab}")
        civ_ok = config.civ and min(spec.dims) >= 3
        if config.thin and not civ_ok:
            raise ValueError(
                "thin=True requires civ=True and a grid with dims >= 3 on "
                f"every axis (got {spec.dims})")
        if civ_ok:
            slabs, dropped = granular_kernel.build_offsets_civ(
                grid, spec, block, slab, n_pad, thin=config.thin,
                stats=stats)
        else:
            slabs, dropped = granular_kernel.build_windows(grid, spec, block,
                                                           slab, n_pad)
        return grid, slabs, dropped


def _run_block_kernel(pos: torch.Tensor, vel: torch.Tensor,
                      config: GranularConfig, dt, length: int,
                      stats: bool = False, kc=None, grav=None, e=None):
    """Kernel route: rebuild, then ``length`` substeps of
    ``granular_kernel.substep_sorted`` over the frozen slab windows (no
    ``window``/``max_neighbors`` caps; the only truncation is slab
    overflow, counted in ``dropped``).

    Sort-carry: takes and returns the state in its own sorted layout plus
    ``order_step`` (new slot → input slot); the caller composes the
    permutations across blocks and unsorts once at the end."""
    grid, slabs, dropped = rebuild(pos, vel, config, stats)
    prm = granular_kernel.kernel_params(config, dt, pos.device, kc, grav, e)
    pos, vel = grid.sorted_pos, grid.sorted_vel
    for _ in range(length):
        pos, vel = granular_kernel.substep_sorted(pos, vel, prm, slabs)
    return pos, vel, grid.order, dropped


def _mirror_substep(pos, vel, f, prm):
    """The integrate phase of a substep on sorted ``[3, n]`` state with the
    pair force ``f`` as an input: gravity → semi-implicit Euler → wall clamp
    and reflect, per axis in K10's op order (``granular_kernel._integrate``,
    the JAX package's ``_mirror_substep``). ``prm`` is the parameter vector
    of ``granular_kernel.kernel_params``; the differentiable half of the
    substep, whose ``torch.autograd`` transpose the backward pass takes
    (and with it the dt, gravity and restitution cotangents)."""
    return granular_kernel._integrate(pos, vel, f, prm)


def _diff_structs(pos, vel, config: GranularConfig):
    """The rebuild of the differentiable path: the sorted grid and the CIV
    candidate set (``rebuild``). The discrete structure (order, cids,
    offsets) is locally constant in the positions: gradients flow through
    the values, the frozen schedule's own contract."""
    grid, slabs, _ = rebuild(pos, vel, config)
    return grid, slabs


def _diff_segment_fwd(pos, vel, config: GranularConfig, prm, length: int):
    """One frozen block of the differentiable path: rebuild, then
    ``length`` substeps of (K11 → the plain integrate). Original order in
    and out."""
    grid, slabs = _diff_structs(pos, vel, config)
    posc, velc = grid.sorted_pos, grid.sorted_vel
    for _ in range(length):
        f = granular_kernel.contact_forces_sorted(posc, prm[0], prm[1], slabs)
        posc, velc = _mirror_substep(posc, velc, f, prm)
    inv = broadphase._inverse(grid.order)
    return posc[:, inv], velc[:, inv]


def _diff_segment_bwd(pos0, vel0, config: GranularConfig, prm, length: int,
                      pbar, vbar):
    """The transpose of :func:`_diff_segment_fwd`: re-run the segment
    keeping (pos, vel, f) per substep, then walk it backwards. Each step
    transposes the integrate with ``torch.autograd`` of
    :func:`_mirror_substep` (which also yields the dt, gravity and
    restitution cotangents) and adds the pair-force term ``Jᵀf̄ = J·f̄``
    from K12 (J is symmetric where nothing is dropped). ``k_contact``'s
    cotangent uses the force's linearity in it: ``⟨f̄, f⟩ / k``.

    Returns the cotangents of pos and vel entering the segment (original
    order) and of dt, k_contact, gravity and restitution."""
    grid, slabs = _diff_structs(pos0, vel0, config)
    md, kc = prm[0], prm[1]
    posc, velc = grid.sorted_pos, grid.sorted_vel
    trace = []
    for _ in range(length):
        f = granular_kernel.contact_forces_sorted(posc, md, kc, slabs)
        trace.append((posc, velc, f))
        posc, velc = _mirror_substep(posc, velc, f, prm)
    order = grid.order.long()
    pbc, vbc = pbar[:, order], vbar[:, order]
    prm_bar = torch.zeros_like(prm)
    f_dot = torch.zeros((), dtype=torch.float64, device=prm.device)
    for posc, velc, f in reversed(trace):
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_()
                      for t in (posc, velc, f, prm)]
            out = _mirror_substep(*leaves)
            pb1, vb1, fbar, g = torch.autograd.grad(out, leaves, (pbc, vbc))
        ft = granular_kernel.contact_force_jvp_sorted(posc, fbar, md, kc,
                                                      slabs)
        f_dot = f_dot + (fbar.double() * f.double()).sum()
        pbc, vbc = pb1 + ft[3:], vb1
        prm_bar = prm_bar + g
    kcb = torch.where(kc == 0.0, 0.0, f_dot / torch.where(kc == 0.0, 1.0, kc))
    inv = broadphase._inverse(grid.order)
    return (pbc[:, inv], vbc[:, inv], prm_bar[3], kcb.float(), prm_bar[2],
            prm_bar[4])


def _segments(config: GranularConfig, n_steps: int):
    k = max(1, config.rebuild_every)
    n_full, rem = divmod(n_steps, k)
    return [k] * n_full + ([rem] if rem else [])


class _DiffCore(torch.autograd.Function):
    """``n_steps`` differentiable substeps, checkpointed per rebuild
    segment: the forward keeps each segment's start state; the backward
    walks the segments in reverse with :func:`_diff_segment_bwd`."""

    @staticmethod
    def forward(ctx, pos, vel, dt, kc, grav, e, config, n_steps):
        prm = granular_kernel.kernel_params(config, dt, pos.device, kc, grav, e)
        starts = []
        for length in _segments(config, n_steps):
            starts += [pos, vel]
            pos, vel = _diff_segment_fwd(pos, vel, config, prm, length)
        ctx.save_for_backward(prm, *starts)
        ctx.config = config
        ctx.n_steps = n_steps
        return pos, vel

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, pbar, vbar):
        prm, *starts = ctx.saved_tensors
        config = ctx.config
        acc = [torch.zeros((), dtype=torch.float32, device=prm.device)] * 4
        lengths = _segments(config, ctx.n_steps)
        for s in reversed(range(len(lengths))):
            pbar, vbar, *ds = _diff_segment_bwd(
                starts[2 * s], starts[2 * s + 1], config, prm, lengths[s],
                pbar, vbar)
            acc = [a + d for a, d in zip(acc, ds)]
        return (pbar, vbar, *acc, None, None)


def multi_step_diff(state: ParticleState, config: GranularConfig, dt,
                    n_steps: int, k_contact=None, gravity=None,
                    restitution=None) -> ParticleState:
    """Differentiable ``multi_step`` on the kernel route.

    ``torch.autograd`` carries gradients with respect to ``state.pos``,
    ``state.vel``, ``dt`` and the physics parameters ``k_contact`` /
    ``gravity`` / ``restitution`` (each defaults to the config's value;
    pass a 0-d tensor that requires grad to fit it, the system-ID use of
    ``examples/inverse_granular.py``). Forward: K11 (the production contact
    kernel's force) and the plain integrate per substep on the frozen
    schedule, which equals :func:`multi_step` on the kernel route up to
    the order of the sort within a cell. Backward, per rebuild segment in
    reverse: re-run the segment keeping (state, force) per substep,
    transpose the integrate with ``torch.autograd`` and apply the pair
    force's transpose ``Jᵀf̄`` with K12 (J is symmetric: the force is
    conservative). Memory: one segment's trajectory. A CPU state takes the
    plain versions, a CUDA state the kernels.

    Gradient contract (the JAX package's): contact activation and wall
    hits differentiate piecewise, the broad-phase structure is locally
    constant, and slab drops must be zero (``multi_step(...,
    return_stats=True)``) or J loses its symmetry on the dropped pairs.
    Needs the CIV kernel path (``civ=True``, grid dims >= 3)."""
    spec = config.grid_spec()
    if not (config.civ and min(spec.dims) >= 3):
        raise ValueError(
            "multi_step_diff needs the CIV kernel path: civ=True and "
            f"grid dims >= 3 (got {spec.dims})")
    dev = state.pos.device
    kc = config.k_contact if k_contact is None else k_contact
    grav = config.gravity if gravity is None else gravity
    e = config.restitution if restitution is None else restitution
    pos, vel = _DiffCore.apply(state.pos, state.vel, _f32(dt, dev),
                               _f32(kc, dev), _f32(grav, dev), _f32(e, dev),
                               config, n_steps)
    return ParticleState(pos=pos, vel=vel)


def multi_step(state: ParticleState, config: GranularConfig, dt,
               n_steps: int, return_stats: bool = False,
               backend: Optional[str] = None, k_contact=None, gravity=None,
               restitution=None):
    """``n_steps`` substeps. ``rebuild_every>1`` uses the frozen schedule;
    ``rebuild_every=1`` on the gather route rebuilds every substep.

    ``backend``: ``"kernel"`` (the default; the JAX package's ``"pallas"``)
    steps each frozen block with ``granular_kernel.substep_sorted`` (K10
    on a CUDA state, its plain version on a CPU one); ``"gather"`` (the
    JAX package's ``"xla"``) keeps the compacted-candidate gather path. No
    entry point of the port takes the gather route: it is the independent
    formulation the tests hold the kernel route against (and the JAX
    package's xla route against).

    ``k_contact`` / ``gravity`` / ``restitution`` optionally override the
    config's constants as 0-d tensors: they ride the kernel's parameter
    vector, so a material change rebuilds nothing. Equal to the static
    path bit for bit when given the config's values.

    With ``return_stats=True`` returns ``(state, dropped_max)``: the worst
    per-rebuild dropped-candidate count (int32 0-d tensor; exact on the
    kernel route). Nonzero means the broad-phase capacities
    (``window``/``max_neighbors`` for the gather route, ``pallas_slab`` for
    the kernel route) lose contacts."""
    backend = "kernel" if backend is None else backend
    if backend not in ("kernel", "gather"):
        raise ValueError(f"backend must be 'kernel' or 'gather', got "
                         f"{backend!r}")
    dev = state.pos.device
    kc, grav, e = k_contact, gravity, restitution
    dmax = torch.zeros((), dtype=torch.int32, device=dev)
    k = max(1, config.rebuild_every)
    if backend == "kernel":
        n = state.pos.shape[-1]
        pos, vel = state.pos, state.vel
        ordc = torch.arange(n, dtype=torch.int32, device=dev)
        n_outer, rem = divmod(n_steps, k)
        for length in [k] * n_outer + ([rem] if rem else []):
            pos, vel, order_step, d = _run_block_kernel(
                pos, vel, config, dt, length, stats=return_stats, kc=kc,
                grav=grav, e=e)
            # original index of new slot s is ordc[order_step[s]]
            ordc = ordc[order_step.long()]
            dmax = torch.maximum(dmax, d)
        inv = broadphase._inverse(ordc)             # one unsort for the run
        state = ParticleState(pos=pos[:, inv], vel=vel[:, inv])
        return (state, dmax) if return_stats else state
    if k == 1:
        for _ in range(n_steps):
            state, d = substep(state, config, dt, return_stats=True, kc=kc,
                               grav=grav, e=e)
            dmax = torch.maximum(dmax, d)
        return (state, dmax) if return_stats else state
    n_outer, rem = divmod(n_steps, k)
    for length in [k] * n_outer + ([rem] if rem else []):
        state, d = _run_block(state, config, dt, length, kc, grav, e)
        dmax = torch.maximum(dmax, d)
    return (state, dmax) if return_stats else state
