"""Multi-device parallelism over a mesh of torch devices held by one
process: the counterpart of ``wgpu_physics_engine_tpu/parallel/mesh.py``.

The JAX package drives its devices from a single controller: ``shard_map``
over a ``Mesh``, one process. The port keeps that model. A :class:`Mesh`
is a grid of ``torch.device``s with named axes; a shard is a tensor on its
device; a collective is a copy between them (``ppermute`` of a shard's
edge rows becomes a ``.to(dev)`` of them, ``all_gather`` a ``torch.cat``
onto each device). Devices may repeat: four shards of ``cuda:0`` run the
decomposition on one card (its copies and halo redundancy, none of its
parallelism), ``cuda:0..3`` run it on four cards with peer copies, and
``["cpu"] * n`` is what the tests run. NCCL is not used: it refuses two
ranks on one card.

The two axes of the JAX package:

1. **Worlds (data parallel):** a batch of independent worlds cut along its
   leading axis, each shard stepped by the batched kernel K5
   (:func:`batched_multi_step`) or world by world through cloth
   self-collision (:func:`batched_self_collide_multi_step`). No copies in
   the step.
2. **Rows (halo exchange):** one cloth cut into bands of rows. The stencil
   reaches 2 rows (the bend family, cloth.rs:956-957), so each band takes
   ``2·k`` halo rows from each neighbour once every ``k`` substeps (halo
   widening: the stale rows creep in 2 a substep and are sliced off) and
   is stepped by a row-window kernel with global-row spring masks
   (``ops.cloth_kernel.multi_step_window``: K1w, or K6w for a window above
   100,000 particles).

They compose: a ``(worlds, rows)`` mesh runs a batch of row-sharded cloths
(:func:`batched_spatial_multi_step`). The rows path runs block by block:
in each exchange block the halos of each worlds shard's stacked worlds are
exchanged once, and every window one device holds (all worlds of every
shard there) goes into one window call, one kernel launch a substep for
the batch (:func:`_rows_run`).

Functions take and return whole tensors, as JAX's take global arrays: they
cut their inputs into shards on the mesh's devices, step them with every
launch under its shard's device, and put the result together on the input
state's device. Halo exchange and gathers are explicit copies.
``use_kernel`` (default on) selects K1w for a rows shard at every size:
JAX's switch to the XLA stencil above its VMEM budget (``_kernel_fits``)
is a TPU limit with no counterpart. ``use_kernel=False`` takes the stencil
shard body (``models.cloth.spring_forces(row_valid=...)``), on CPU shards
only: no plain path runs on the card.

The rows path is differentiable on both devices. Under autograd a
device's window call is ``ops.cloth_grad_kernel.multi_step_window``, a
``torch.autograd.Function`` whose forward is the same window kernel and
whose backward walks the windows' trajectories with the window adjoint,
one call for the batch (on the card ``csrc/cloth_grad.cu``'s ``WINDOW``
instantiation; on CPU shards its plain version). The parameters are
packed once a device, outside it. The halo exchange is row slices, ``.to`` and ``cat``,
so autograd adds each halo row's cotangent back onto its owner's rows and
sums the parameter cotangents over shards and blocks: the data-parallel
all-reduce of JAX's ``shard_map`` transpose.
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..core.state import ClothParams, ClothState
from ..models import cloth
from ..ops import cloth_grad_kernel, cloth_kernel
from ..utils.profiling import span

HALO = 2  # bend springs reach 2 rows (cloth.rs:956-957)


class Mesh:
    """Devices on a grid with named axes (``jax.sharding.Mesh``):
    ``devices`` is an object array of ``torch.device`` of one dimension per
    name in ``axis_names``; ``shape[axis]`` is that axis's size."""

    def __init__(self, devices: np.ndarray, axis_names: Sequence[str]):
        if devices.ndim != len(axis_names):
            raise ValueError(f"{devices.ndim}-d devices for axes "
                             f"{tuple(axis_names)}")
        self.devices = devices
        self.axis_names = tuple(axis_names)

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    def axis_devices(self, axis: str) -> List[torch.device]:
        """The devices along ``axis`` (index 0 on the other axes, over
        which a one-axis function's operands are replicated)."""
        a = self.axis_names.index(axis)
        idx = [0] * self.devices.ndim
        idx[a] = slice(None)
        return list(self.devices[tuple(idx)])

    def grid(self, outer: str, inner: str) -> List[List[torch.device]]:
        """The devices as ``[outer][inner]`` lists (index 0 on any other
        axis)."""
        a, b = self.axis_names.index(outer), self.axis_names.index(inner)
        arr = np.moveaxis(self.devices, (a, b), (0, 1))
        arr = arr.reshape(arr.shape[:2] + (-1,))[..., 0]
        return [list(row) for row in arr]

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, {list(self.devices.flat)})"


def make_mesh(shape: Optional[Sequence[int]] = None,
              axis_names: Sequence[str] = ("worlds",),
              devices=None) -> Mesh:
    """Build a device mesh. Default: a 1-D ``worlds`` axis over every CUDA
    device (it raises without one; pass ``devices=["cpu"] * n`` for CPU
    shards). Devices may repeat, for several shards on one device."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh: no CUDA device; pass devices= "
                               "(e.g. ['cpu'] * n) to shard elsewhere")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    # "cuda" names the current card: give it its index, as tensors carry
    devices = [torch.device("cuda", torch.cuda.current_device())
               if d.type == "cuda" and d.index is None else d
               for d in devices]
    if shape is None:
        shape = (len(devices),)
    if math.prod(shape) != len(devices):
        raise ValueError(f"mesh shape {tuple(shape)} needs "
                         f"{math.prod(shape)} devices, got {len(devices)}")
    arr = np.empty(len(devices), dtype=object)
    for i, d in enumerate(devices):
        arr[i] = d
    return Mesh(arr.reshape(tuple(shape)), axis_names)


def _on(dev: torch.device):
    """Launches below run under ``dev`` (its current stream)."""
    if dev.type == "cuda":
        return torch.cuda.device(dev)
    return contextlib.nullcontext()


def _params_on(params: ClothParams, dev: torch.device) -> ClothParams:
    return ClothParams(*(leaf.to(dev) for leaf in params))


def _world_params(params: ClothParams, j: int) -> ClothParams:
    """World ``j``'s parameters from ``[B]`` leaves (0-d leaves shared)."""
    return ClothParams(*(leaf[j] if leaf.ndim else leaf for leaf in params))


def _use_kernel(use_kernel: Optional[bool], devices) -> bool:
    if use_kernel is None or use_kernel:
        return True
    bad = sorted({str(d) for d in devices if d.type != "cpu"})
    if bad:
        raise ValueError(f"use_kernel=False (the stencil shard body) runs on "
                         f"CPU shards only, got {bad}: on the card the rows "
                         "path takes K1w")
    return False


# ---------------------------------------------------------------------------
# 1. Worlds-axis data parallelism
# ---------------------------------------------------------------------------

def _cut_worlds(n_worlds: int, n_shards: int) -> int:
    if n_worlds % n_shards:
        raise ValueError(f"B={n_worlds} worlds not divisible by {n_shards} "
                         "devices")
    return n_worlds // n_shards


def shard_worlds(state: ClothState, mesh: Mesh,
                 axis: str = "worlds") -> List[ClothState]:
    """Cut a batched state (leading worlds axis on pos/vel) into the
    shards of ``mesh``'s ``axis``, each on its device: world chunk ``i``
    on device ``i``. Batched pins (``pin_mask`` ``[B, H, W]``) are cut
    alongside; shared pins are copied to every device."""
    devs = mesh.axis_devices(axis)
    per = _cut_worlds(state.pos.shape[0], len(devs))

    def put(x, batched, i, dev):
        if x is None:
            return None
        return (x[i * per:(i + 1) * per] if batched else x).to(dev)

    pm, pp = state.pin_mask, state.pin_pos
    return [ClothState(
        pos=put(state.pos, True, i, dev), vel=put(state.vel, True, i, dev),
        pin_mask=put(pm, pm is not None and pm.ndim > 2, i, dev),
        pin_pos=put(pp, pp is not None and pp.ndim > 3, i, dev))
        for i, dev in enumerate(devs)]


def _shard_params(params: ClothParams, devs, per: int) -> List[ClothParams]:
    """Per-world ``[B]`` leaves cut like :func:`shard_worlds`; 0-d leaves
    copied to every device."""
    return [ClothParams(*((leaf[i * per:(i + 1) * per] if leaf.ndim else leaf)
                          .to(dev) for leaf in params))
            for i, dev in enumerate(devs)]


def _gather_worlds(shards: List[ClothState], like: ClothState) -> ClothState:
    dev = like.pos.device
    return like._replace(pos=torch.cat([s.pos.to(dev) for s in shards]),
                         vel=torch.cat([s.vel.to(dev) for s in shards]))


def batched_multi_step(state: ClothState, params: ClothParams, dt,
                       n_steps: int, mesh: Mesh,
                       axis: str = "worlds") -> ClothState:
    """``n_steps`` substeps of a batch of worlds (``pos`` ``[B, 3, H, W]``,
    params ``[B]`` or shared 0-d), each shard of ``mesh``'s ``axis``
    stepped by ``ops.cloth_kernel.multi_step`` (K5, or K5r for a shard of
    enough worlds; their plain version on CPU shards); no copies between
    shards. JAX partitions
    a vmapped stepper by the input's sharding; here the mesh is an
    argument."""
    shards = shard_worlds(state, mesh, axis)
    devs = mesh.axis_devices(axis)
    prms = _shard_params(params, devs, shards[0].pos.shape[0])
    outs = []
    for s, p, dev in zip(shards, prms, devs):
        with _on(dev):
            outs.append(cloth_kernel.multi_step(s, p, dt, n_steps))
    return _gather_worlds(outs, state)


def batched_self_collide_multi_step(state: ClothState, params: ClothParams,
                                    dt, n_steps: int, spec, mesh: Mesh,
                                    axis: str = "worlds",
                                    rebuild_every: int = 2,
                                    pallas_block: int = 128,
                                    pallas_slab: int = 128,
                                    use_spring_kernel=None) -> ClothState:
    """Worlds-DP self-colliding stepping (BASELINE configs[3] over a
    mesh): each shard of ``mesh``'s ``axis`` steps its worlds one at a
    time through ``models.cloth.multi_step_self_collide`` (the contact
    kernel K11 on the frozen candidate set, then the cloth substep with a
    force plane K1f; their plain versions on CPU shards). No copies in
    the step. ``pos``/``vel`` ``[B, 3, H, W]`` with B divisible by the
    axis's size; optional per-world pins; params ``[B]`` or shared."""
    shards = shard_worlds(state, mesh, axis)
    devs = mesh.axis_devices(axis)
    prms = _shard_params(params, devs, shards[0].pos.shape[0])
    outs = []
    for s, p, dev in zip(shards, prms, devs):
        worlds = []
        with _on(dev):
            for j in range(s.pos.shape[0]):
                pin = (None, None) if s.pin_mask is None else (
                    s.pin_mask[j] if s.pin_mask.ndim > 2 else s.pin_mask,
                    s.pin_pos[j] if s.pin_pos.ndim > 3 else s.pin_pos)
                worlds.append(cloth.multi_step_self_collide(
                    ClothState(s.pos[j], s.vel[j], *pin),
                    _world_params(p, j), dt, n_steps, spec,
                    rebuild_every=rebuild_every, pallas_block=pallas_block,
                    pallas_slab=pallas_slab,
                    use_spring_kernel=use_spring_kernel))
        outs.append(s._replace(pos=torch.stack([w.pos for w in worlds]),
                               vel=torch.stack([w.vel for w in worlds])))
    return _gather_worlds(outs, state)


# ---------------------------------------------------------------------------
# 2. Spatial sharding with halo exchange
# ---------------------------------------------------------------------------

def _exchange_halo(shards: Sequence[torch.Tensor],
                   halo: int = HALO) -> List[torch.Tensor]:
    """Extend each shard's local ``[..., h, W]`` rows (the shards in row
    order, each on its device) with ``halo`` rows from both neighbours:
    the bottom rows of shard i-1 above, the top rows of shard i+1 below,
    copied to shard i's device (JAX's two ``ppermute``s). Boundary shards
    receive zeros, as a ``ppermute`` with no source gives; the global-row
    masks keep them out of every edge."""
    out = []
    with span("mesh.halo_exchange"):
        for i, x in enumerate(shards):
            zeros = x.new_zeros(x.shape[:-2] + (halo, x.shape[-1]))
            up = shards[i - 1][..., -halo:, :].to(x.device) if i else zeros
            down = (shards[i + 1][..., :halo, :].to(x.device)
                    if i + 1 < len(shards) else zeros)
            out.append(torch.cat([up, x, down], dim=-2))
    return out


def _spatial_substep_local(pos_ext, vel_ext, pinm_ext, pinpos_ext,
                           prm: torch.Tensor, row0, h_global: int,
                           substeps: int = 1):
    """Shard body: ``substeps`` substeps of a batch of halo-extended
    windows of one shape (``[B, 3, h_local + 2·halo, W]``, halo =
    ``HALO·substeps``; pins ``[B, ...]`` or None) whose local row 0 is
    global row ``row0[b]``, then the centres ``[B, 3, h_local, W]`` (the
    halo's staleness sliced off); one window ``[3, ...]`` with an int
    ``row0`` likewise. K1w or K6w on the packed parameters ``prm``
    (``cloth_kernel.multi_step_window_packed``, one call for the batch;
    their plain versions on the CPU), through ``cloth_grad_kernel.
    multi_step_window`` when autograd needs a gradient of the windows."""
    halo = HALO * substeps
    # the Function costs host time even when nothing needs a gradient: a
    # call of 2 substeps took 82.3 µs through it against 59.2 direct on a
    # 16×16 window, 97.1 against 65.0 on 136×256 (tools/kernel_ab.py
    # --only adjoint; NVIDIA H100 80GB HBM3, 700.00 W)
    step = cloth_kernel.multi_step_window_packed
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad
            for t in (pos_ext, vel_ext, pinpos_ext, prm)):
        step = cloth_grad_kernel.multi_step_window
    pos_ext, vel_ext = step(pos_ext, vel_ext, pinm_ext, pinpos_ext, prm,
                            substeps, row0, h_global)
    return pos_ext[..., halo:-halo, :], vel_ext[..., halo:-halo, :]


def _stencil_substep_local(pos_ext, vel_ext, pinm_ext, pinpos_ext,
                           params: ClothParams, dt, row0: int, h_global: int,
                           substeps: int = 1):
    """The shard body of ``use_kernel=False``: :func:`_spatial_substep_local`
    by the stencil with ``row_valid`` from global rows, CPU only."""
    halo = HALO * substeps
    _use_kernel(False, [pos_ext.device])
    grow = torch.arange(pos_ext.shape[-2], device=pos_ext.device) + row0
    row_valid = (grow >= 0) & (grow < h_global)
    dt = torch.as_tensor(dt, dtype=torch.float32, device=pos_ext.device)
    for _ in range(substeps):
        force = cloth.spring_forces(pos_ext, vel_ext, params,
                                    row_valid=row_valid)
        pos_ext, vel_ext = cloth.integrate(pos_ext, vel_ext, force, params,
                                           dt)
        if pinm_ext is not None:
            pos_ext = torch.where(pinm_ext[None], pinpos_ext, pos_ext)
            vel_ext = torch.where(pinm_ext[None], 0.0, vel_ext)
    return pos_ext[:, halo:-halo], vel_ext[:, halo:-halo]


def _check_rows(h: int, n_shards: int, n_steps: int, k: int) -> int:
    """JAX's asserts on a rows schedule; returns the shard height."""
    assert n_steps % k == 0, ("n_steps must be divisible by "
                              "substeps_per_exchange")
    if h % n_shards:
        raise ValueError(f"H={h} rows not divisible by {n_shards} devices")
    h_local = h // n_shards
    assert HALO * k <= h_local, (
        f"halo width {HALO * k} exceeds shard height {h_local}; lower "
        "substeps_per_exchange or use fewer shards")
    return h_local


def _rows_run(state: ClothState, params: ClothParams, dt, n_blocks: int,
              k: int, grid: List[List[torch.device]],
              use_kernel: bool) -> ClothState:
    """A batch of worlds (``[B, 3, H, W]``; pins ``[B, H, W]`` and
    ``[B, 3, H, W]`` or None) stepped ``n_blocks`` times by one halo
    exchange of width ``2k`` and ``k`` substeps: worlds shard ``a`` (the
    ``a``-th of ``len(grid)`` equal chunks) is cut into ``len(grid[a])``
    bands of rows, band ``i`` on ``grid[a][i]``. Each block exchanges the
    halos of each worlds shard's stacked worlds once, then makes one window
    call a device with every window it holds (all worlds of every shard
    there; the windows are independent, so their grouping changes no
    bit). Returned whole on the state's device. Pins never change, so
    their halos are exchanged once."""
    n_worlds, _, h, _ = state.pos.shape
    per = n_worlds // len(grid)
    h_local = h // len(grid[0])
    halo = HALO * k
    devs = list(dict.fromkeys(d for row in grid for d in row))
    prms = {dev: _params_on(params, dev) for dev in devs}
    if use_kernel:
        # packed once a device, outside the windows' autograd Function, so
        # autograd carries exp(log k), speed_damp ** dt and min_dist's sum
        prms = {dev: cloth_kernel._pack_params(p, dt)
                for dev, p in prms.items()}

    def cut(x):
        return [[band.to(dev) for band, dev in zip(
            x[a * per:(a + 1) * per].split(h_local, -2), row)]
            for a, row in enumerate(grid)]

    def cat(xs):
        return xs[0] if len(xs) == 1 else torch.cat(xs)

    pos, vel = cut(state.pos), cut(state.vel)
    pins = [[(None, None)] * len(row) for row in grid]
    if state.pin_mask is not None:
        pins = [list(zip(_exchange_halo(m, halo), _exchange_halo(p, halo)))
                for m, p in zip(cut(state.pin_mask != 0),
                                cut(state.pin_pos))]
    # the (worlds shard, rows shard) windows of each device, and their first
    # global rows, a world at a time
    calls = {dev: [(a, i) for a, row in enumerate(grid)
                   for i, d in enumerate(row) if d == dev] for dev in devs}
    row0 = {dev: tuple(i * h_local - halo for _, i in ws for _ in range(per))
            for dev, ws in calls.items()}
    for _ in range(n_blocks):
        pos_ext = [_exchange_halo(p, halo) for p in pos]
        vel_ext = [_exchange_halo(v, halo) for v in vel]
        for dev, ws in calls.items():
            with _on(dev):
                if use_kernel:
                    pm, pp = (None, None)
                    if state.pin_mask is not None:
                        pm = cat([pins[a][i][0] for a, i in ws])
                        pp = cat([pins[a][i][1] for a, i in ws])
                    p_out, v_out = _spatial_substep_local(
                        cat([pos_ext[a][i] for a, i in ws]),
                        cat([vel_ext[a][i] for a, i in ws]), pm, pp,
                        prms[dev], row0[dev], h, k)
                    for (a, i), p_w, v_w in zip(ws, p_out.split(per),
                                                v_out.split(per)):
                        pos[a][i], vel[a][i] = p_w, v_w
                    continue
                for a, i in ws:
                    pm, pp = pins[a][i]
                    outs = [_stencil_substep_local(
                        pos_ext[a][i][j], vel_ext[a][i][j],
                        None if pm is None else pm[j],
                        None if pp is None else pp[j], prms[dev], dt,
                        i * h_local - halo, h, k) for j in range(per)]
                    pos[a][i] = torch.stack([o[0] for o in outs])
                    vel[a][i] = torch.stack([o[1] for o in outs])
    out = state.pos.device

    def whole(bands):
        return torch.cat([torch.cat([b.to(out) for b in row], dim=-2)
                          for row in bands])

    return state._replace(pos=whole(pos), vel=whole(vel))


def _rows_world(state: ClothState, params: ClothParams, dt, n_blocks: int,
                k: int, devs: List[torch.device],
                use_kernel: bool) -> ClothState:
    """One world (``[3, H, W]``) cut into ``len(devs)`` bands of rows, one
    a device: :func:`_rows_run` on a batch of one."""
    pin = (None, None) if state.pin_mask is None else (
        state.pin_mask[None], state.pin_pos[None])
    out = _rows_run(ClothState(state.pos[None], state.vel[None], *pin),
                    params, dt, n_blocks, k, [devs], use_kernel)
    return state._replace(pos=out.pos[0], vel=out.vel[0])


def spatial_substep(state: ClothState, params: ClothParams, dt, mesh: Mesh,
                    axis: str = "rows", substeps: int = 1,
                    use_kernel=None) -> ClothState:
    """``substeps`` substeps of a single cloth sharded by rows across
    ``axis``, with ONE halo exchange (width 2·substeps): the same function
    as ``substeps`` × ``models.cloth.substep`` (halo rows carry the
    neighbours' data, edges across the global boundary are masked, the
    stale rows are sliced off). ``use_kernel``: see the module."""
    devs = mesh.axis_devices(axis)
    _check_rows(state.pos.shape[-2], len(devs), substeps, substeps)
    return _rows_world(state, params, dt, 1, substeps, devs,
                       _use_kernel(use_kernel, devs))


def spatial_multi_step(state: ClothState, params: ClothParams, dt,
                       n_steps: int, mesh: Mesh, axis: str = "rows",
                       substeps_per_exchange: int = 1,
                       use_kernel=None) -> ClothState:
    """``n_steps`` row-sharded substeps of one cloth: a halo exchange once
    every ``substeps_per_exchange`` substeps (halo widening), the shards
    kept on their devices in between. ``n_steps`` must be divisible by
    ``substeps_per_exchange``. ``use_kernel``: see the module."""
    k = substeps_per_exchange
    devs = mesh.axis_devices(axis)
    _check_rows(state.pos.shape[-2], len(devs), n_steps, k)
    return _rows_world(state, params, dt, n_steps // k, k, devs,
                       _use_kernel(use_kernel, devs))


def batched_spatial_multi_step(state: ClothState, params: ClothParams, dt,
                               n_steps: int, mesh: Mesh,
                               worlds_axis: str = "worlds",
                               rows_axis: str = "rows",
                               substeps_per_exchange: int = 1,
                               use_kernel=None) -> ClothState:
    """Composed 2-D parallelism: a batch of worlds (data parallel over
    ``worlds_axis``) of row-sharded cloths (halo exchange over
    ``rows_axis``). ``pos``/``vel`` ``[B, 3, H, W]``; optional per-world
    pins (``pin_mask`` ``[B, H, W]``, ``pin_pos`` ``[B, 3, H, W]``);
    params shared (0-d), as JAX replicates them. The worlds of worlds
    shard ``a`` are cut over the rows devices of row ``a`` of the mesh and
    stepped as :func:`spatial_multi_step` steps one cloth, block by block,
    with one window call a device and block for every window the device
    holds (:func:`_rows_run`). JAX maps the worlds of a shard one at a
    time in each exchange block, since its vmapped window kernel does not
    lower; the windows are independent, so the grouping changes no bit."""
    k = substeps_per_exchange
    grid = mesh.grid(worlds_axis, rows_axis)
    _check_rows(state.pos.shape[-2], len(grid[0]), n_steps, k)
    _cut_worlds(state.pos.shape[0], len(grid))
    use_kernel = _use_kernel(use_kernel, [d for row in grid for d in row])
    return _rows_run(state, params, dt, n_steps // k, k, grid, use_kernel)
