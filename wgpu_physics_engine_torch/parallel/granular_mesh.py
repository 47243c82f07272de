"""Sharded granular stepping over a mesh of torch devices: the counterpart
of ``wgpu_physics_engine_tpu/parallel/granular_mesh.py``.

The granular substep is one CTA per block of the SORTED particle array,
independent given two shared inputs: the full position array (the slab
source) and the rebuild's candidate set. So the decomposition is by
blocks of sorted slots, with no halo bookkeeping:

* shard ``d`` of the ``grains`` axis owns the sorted slots ``[d·nloc_pad,
  (d+1)·nloc_pad)`` (clipped to the ``n`` real ones) and integrates only
  those: one launch of the granular kernel with a base, K10b
  (``ops.granular_kernel.substep_sorted(..., base, n_local)``), a
  substep, under the shard's device; self-exclusion sees global slots;
* the slab source stays the full position array, all-gathered each
  substep (``torch.cat`` of the shards' new positions onto each device);
  velocities stay shard-local until the block ends;
* the rebuild (sort and CIV offsets) is replicated: each distinct device
  rebuilds the gathered state (on one card, once). The pad follows JAX's
  sharded path, a multiple of ``block·8·D`` (``granular_mesh.py:143-146``):
  the 8-row SMEM offset tiles behind it are a TPU fact, but the pad clips
  the slab offsets and so binds the candidate set. JAX carries the base in
  an f32 parameter slot, which caps the pad below 2^24 (``:147``); the
  port passes an int, so that limit goes away;
* each block starts from the unsorted state and ends with JAX's per-block
  unsort (``:205``). The single-device path carries the sorted order
  across blocks instead, so after the first block the stable sort may
  break ties within a cell in another order: one block is bitwise equal to
  it where the pads agree, several blocks agree within the contact
  contract.

:func:`multi_step_diff_sharded` is the worlds-DP composition of the
differentiable path. Functions take and return whole tensors, as in
``parallel/mesh.py``.
"""

from __future__ import annotations

import torch

from ..core.state import ParticleState
from ..models import broadphase, granular
from ..ops import granular_kernel
from .mesh import Mesh, _on


def multi_step_diff_sharded(state: ParticleState,
                            config: granular.GranularConfig, dt,
                            n_steps: int, mesh: Mesh, axis: str = "worlds",
                            k_contact=None, gravity=None,
                            restitution=None) -> ParticleState:
    """Batched differentiable granular stepping, worlds-data-parallel over
    ``mesh``'s ``axis``: ``state.pos``/``state.vel`` ``[W, 3, N]`` with
    ``W`` divisible by the axis's size. Each shard steps its worlds one at
    a time through ``models.granular.multi_step_diff`` (K11 forward, K11
    and K12 backward; their plain versions on CPU shards).

    ``torch.autograd`` carries gradients with respect to the batched state,
    ``dt`` and the physics scalars ``k_contact`` / ``gravity`` /
    ``restitution`` (each defaults to the config's value). The scalars are
    copied to each shard's device, so autograd sums their cotangents back
    over the shards: JAX's psum of the replicated operands."""
    devs = mesh.axis_devices(axis)
    n_worlds = state.pos.shape[0]
    if n_worlds % len(devs):
        raise ValueError(f"W={n_worlds} worlds not divisible by {len(devs)} "
                         "devices")
    per = n_worlds // len(devs)
    out_dev = state.pos.device
    scal = [torch.as_tensor(v, dtype=torch.float32, device=out_dev)
            for v in (dt, config.k_contact if k_contact is None else k_contact,
                      config.gravity if gravity is None else gravity,
                      config.restitution if restitution is None
                      else restitution)]
    pos, vel = [], []
    for d, dev in enumerate(devs):
        dt_d, kc_d, grav_d, e_d = (x.to(dev) for x in scal)
        with _on(dev):
            for j in range(d * per, (d + 1) * per):
                out = granular.multi_step_diff(
                    ParticleState(pos=state.pos[j].to(dev),
                                  vel=state.vel[j].to(dev)),
                    config, dt_d, n_steps, k_contact=kc_d, gravity=grav_d,
                    restitution=e_d)
                pos.append(out.pos.to(out_dev))
                vel.append(out.vel.to(out_dev))
    return ParticleState(pos=torch.stack(pos), vel=torch.stack(vel))


def _gather(parts, devs):
    """All-gather: the shards' ``[3, n_d]`` slices put together (in shard
    order) on each distinct device."""
    return {dev: torch.cat([p.to(dev) for p in parts], dim=1)
            for dev in devs}


def multi_step_sharded(state: ParticleState, config: granular.GranularConfig,
                       dt, n_steps: int, mesh: Mesh, axis: str = "grains",
                       return_stats: bool = False):
    """``n_steps`` granular substeps sharded over ``mesh``'s ``axis``.

    ``state.pos``/``state.vel`` are ``[3, N]`` with ``N`` divisible by the
    axis's size (JAX shards the particle axis in contiguous chunks).
    Needs the CIV kernel path (``config.civ``, the default, and grid
    dimensions >= 3); ``thin`` composes. Each substep launches K10b once
    per shard that owns slots (CPU shards take its plain version).

    With ``return_stats=True`` also returns the worst per-rebuild dropped
    count (the contract of ``granular.multi_step``)."""
    devs = mesh.axis_devices(axis)
    num_d = len(devs)
    n = state.pos.shape[-1]
    if n % num_d:
        raise ValueError(f"N={n} not divisible by {num_d} devices")
    spec = config.grid_spec()
    if not (config.civ and min(spec.dims) >= 3):
        raise ValueError(
            "multi_step_sharded needs the CIV kernel path: civ=True, "
            f"grid dims >= 3 (got {spec.dims})")
    block = config.pallas_block
    n_pad = granular.pad_slots(n, config, unit=block * 8 * num_d)
    nloc_pad = n_pad // num_d
    # shard d's sorted slots [lo, hi), clipped to the real ones
    cuts = [(min(d * nloc_pad, n), min((d + 1) * nloc_pad, n))
            for d in range(num_d)]
    uniq = list(dict.fromkeys(devs))
    k = max(1, config.rebuild_every)
    n_outer, rem = divmod(n_steps, k)
    out_dev = state.pos.device
    posf = {dev: state.pos.to(dev) for dev in uniq}
    velf = {dev: state.vel.to(dev) for dev in uniq}
    prm = {dev: granular_kernel.kernel_params(config, dt, dev) for dev in uniq}
    dmax = torch.zeros((), dtype=torch.int32, device=out_dev)
    for length in [k] * n_outer + ([rem] if rem else []):
        # the replicated rebuild on the gathered state
        built = {dev: granular.rebuild(posf[dev], velf[dev], config,
                                       stats=return_stats, n_pad=n_pad)
                 for dev in uniq}
        dmax = torch.maximum(dmax, built[uniq[0]][2].to(out_dev))
        posc = {dev: built[dev][0].sorted_pos for dev in uniq}
        vel_l = [built[dev][0].sorted_vel[:, lo:hi]
                 for dev, (lo, hi) in zip(devs, cuts)]
        for _ in range(length):
            pos_l = []
            for d, (dev, (lo, hi)) in enumerate(zip(devs, cuts)):
                if hi == lo:
                    pos_l.append(posc[dev][:, lo:hi])
                    continue
                with _on(dev):
                    p, vel_l[d] = granular_kernel.substep_sorted(
                        posc[dev], vel_l[d], prm[dev], built[dev][1],
                        base=lo, n_local=hi - lo)
                pos_l.append(p)
            # refresh the slab source: positions only
            posc = _gather(pos_l, uniq)
        velc = _gather(vel_l, uniq)
        for dev in uniq:
            inv = broadphase._inverse(built[dev][0].order)
            posf[dev] = posc[dev][:, inv]
            velf[dev] = velc[dev][:, inv]
    src = out_dev if out_dev in posf else uniq[0]
    out = ParticleState(pos=posf[src].to(out_dev), vel=velf[src].to(out_dev))
    return (out, dmax) if return_stats else out
