"""Free-particle box simulation (sim 4, ``4_instances_imgui``): the
counterpart of ``wgpu_physics_engine_tpu/models/particles.py``.

N spheres under gravity inside a wireframe box, per-axis wall bounce
(``4_instances_imgui/compute_movement.wgsl:36-105``). State is SoA
``[3, N]``. The physics is a few elementwise torch ops a substep (plain
XLA in the JAX package too, so there is no kernel to port).

Two semantic modes:

* documented-correct (default): on bounce the position is clamped to the
  wall AND the velocity is flipped;
* ``bug_compat=True``: reproduces the reference kernel exactly — the
  position clamp is computed into a local after the matrix write
  (compute_movement.wgsl:62-64 vs :71-100) and is lost, so only the
  velocity flip persists.

The reference's ``damping`` uniform is bound but never applied
(instance.rs:84); ``ParticleParams.damping`` is carried but unused.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..core import config as cfg
from ..core.state import ParticleParams, ParticleState

_F32 = torch.float32


def init_state(config: cfg.FreeParticleConfig,
               generator: Optional[torch.Generator] = None,
               device="cuda") -> ParticleState:
    """Initial state (``generate_instances``, instance.rs:443-492): all
    particles at ``(0, radius, 0)`` with velocity ~ U(-speed, speed)³,
    drawn on the CPU from ``generator`` (jax.random bits cannot be
    reproduced), so a seed gives the same state on every device."""
    n = config.num_particles
    pos = torch.zeros((3, n), dtype=_F32)
    pos[1] = config.radius
    speed = config.initial_speed
    vel = torch.rand((3, n), generator=generator, dtype=_F32) * (2.0 * speed) - speed
    return ParticleState(pos=pos.to(device), vel=vel.to(device))


def substep(state: ParticleState, params: ParticleParams, dt,
            bug_compat: bool = False) -> ParticleState:
    """One integration step (compute_movement.wgsl:36-105), in the JAX
    package's op order: ``v += g*dt``; ``pos += v*dt``; then per axis, if
    beyond the wall and moving outward, flip the velocity (and clamp the
    position unless ``bug_compat``)."""
    dt = torch.as_tensor(dt, dtype=_F32, device=state.pos.device)
    vel = state.vel + params.gravity[:, None] * dt
    pos = state.pos + vel * dt

    limit = params.bounds - params.radius
    hit_low = (pos < -limit) & (vel < 0.0)
    hit_high = (pos > limit) & (vel > 0.0)
    vel = torch.where(hit_low | hit_high, -vel, vel)
    if not bug_compat:
        pos = torch.where(hit_low, -limit, pos)
        pos = torch.where(hit_high, limit, pos)
    return ParticleState(pos=pos, vel=vel)


def multi_step(state: ParticleState, params: ParticleParams, dt,
               n_steps: int, bug_compat: bool = False) -> ParticleState:
    """``n_steps`` substeps (the JAX package's ``lax.scan``)."""
    for _ in range(n_steps):
        state = substep(state, params, dt, bug_compat)
    return state


def oracle_substep(pos, vel, gravity, bounds, radius, dt, bug_compat=False):
    """NumPy fp32 reference for unit tests; same semantics as
    :func:`substep`. ``pos``/``vel``: ``[3, N]`` float32."""
    dt = np.float32(dt)
    vel = vel + np.asarray(gravity, np.float32)[:, None] * dt
    pos = pos + vel * dt
    limit = np.float32(bounds) - np.float32(radius)
    hit_low = (pos < -limit) & (vel < 0.0)
    hit_high = (pos > limit) & (vel > 0.0)
    new_vel = np.where(hit_low | hit_high, -vel, vel)
    if not bug_compat:
        pos = np.where(hit_low, -limit, pos)
        pos = np.where(hit_high, limit, pos)
    return pos.astype(np.float32), new_vel.astype(np.float32)
