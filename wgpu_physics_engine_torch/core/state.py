"""State and dynamic-parameter NamedTuples of torch tensors.

The counterpart of ``wgpu_physics_engine_tpu/core/state.py``: the same
fields, the same channels-first ``[3, H, W]`` layout, the same fp32 values
bit for bit. Every tensor lives on the device the caller names: the card
(``"cuda"``) by default, as in the scenes and the CLI (the tests pass
``device="cpu"``). Params are 0-d fp32 tensors, so the egui-slider
equivalents (gravity, damping, radii — ``cloth.rs:1383-1451``) rewrite a
tensor and rebuild no kernel.

``params_from_numpy`` / ``state_from_numpy`` carry the JAX package's
NamedTuples across (after ``np.asarray`` on each leaf), so a state stepped
by one package can be stepped on by the other. They take one world (0-d
params, ``[3, H, W]`` state) or a batch of worlds (``[B]`` params, ``[B, 3,
H, W]`` / ``[B, H, W]`` state leaves) alike
(``parallel.datagen.world_batch_from_numpy`` carries a whole batch);
``particle_state_from_numpy`` and ``particle_params_from_numpy`` do the
same for a particle set's ``[3, N]`` ``ParticleState`` and the
free-particle box's ``ParticleParams``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from . import config as cfg


class ClothParams(NamedTuple):
    """Dynamic physics parameters for the cloth sim (0-d fp32 tensors).

    Union of the reference's ``PhysicsConstants`` (cloth.rs:196-216) and
    ``SimulationData`` (cloth.rs:181-192) uniforms, minus ``dt`` (passed per
    call) and ``grid_width`` (the state's shape).
    """

    k_struct: torch.Tensor
    k_shear: torch.Tensor
    k_bend: torch.Tensor
    c_struct: torch.Tensor
    c_shear: torch.Tensor
    c_bend: torch.Tensor
    rest_struct: torch.Tensor
    rest_shear: torch.Tensor
    rest_bend: torch.Tensor
    k_contact: torch.Tensor
    mu: torch.Tensor
    mass: torch.Tensor
    gravity: torch.Tensor
    speed_damp: torch.Tensor
    globe_radius: torch.Tensor
    particle_radius: torch.Tensor

    @classmethod
    def from_config(cls, c: cfg.ClothConfig, device="cuda") -> "ClothParams":
        return cls(**{f: _f32(getattr(c, f), device) for f in cls._fields})


class ClothState(NamedTuple):
    """Cloth grid state. ``pos``/``vel``: fp32 ``[3, H, W]``.

    ``pin_mask`` (optional bool ``[H, W]``): True = pinned. Pinned particles
    hold ``pin_pos`` and keep zero velocity (the fixed-pin extension of
    BASELINE.json configs[1]).
    """

    pos: torch.Tensor
    vel: torch.Tensor
    pin_mask: Optional[torch.Tensor] = None
    pin_pos: Optional[torch.Tensor] = None


class ParticleParams(NamedTuple):
    """Dynamic params of the free-particle box (``SimulationUniform``,
    instance.rs:79-87 / 4_instances_imgui/compute_movement.wgsl:10-17):
    0-d fp32 tensors and ``gravity`` [3]."""

    bounds: torch.Tensor
    radius: torch.Tensor
    gravity: torch.Tensor  # [3]
    damping: torch.Tensor  # bound but unused, like the reference kernel

    @classmethod
    def from_config(cls, c: cfg.FreeParticleConfig,
                    device="cuda") -> "ParticleParams":
        return cls(bounds=_f32(c.bounds, device), radius=_f32(c.radius, device),
                   gravity=_f32(c.gravity, device),
                   damping=_f32(c.damping, device))


class ParticleState(NamedTuple):
    """Free-particle SoA state: ``pos``/``vel`` fp32 ``[3, N]`` (the
    free-particle box, ``models/particles.py``, and the granular pile,
    ``models/granular.py``)."""

    pos: torch.Tensor
    vel: torch.Tensor


def _f32(v, device) -> torch.Tensor:
    return torch.tensor(v, dtype=torch.float32, device=device)


def init_cloth_state(c: cfg.ClothConfig, device="cuda") -> ClothState:
    """Initial grid: row r → x, col c → z, y = spawn height.

    Mirrors ``generate_instances`` (cloth.rs:848-893):
    ``x = (r - n/2) * spacing``, ``z = (c - n/2) * spacing`` — offset by
    ``n/2``, not ``(n-1)/2``, as the reference does — and zero velocity.
    Same fp32 op order as the JAX package, so the grids are bitwise equal.
    """
    h, w = c.height, c.width
    f32 = torch.float32
    spacing = _f32(c.spacing, device)
    r = torch.arange(h, dtype=f32, device=device)[:, None]       # rows → x
    col = torch.arange(w, dtype=f32, device=device)[None, :]     # cols → z
    x = (r - h / 2.0) * spacing + _f32(c.center[0], device)
    z = (col - w / 2.0) * spacing + _f32(c.center[2], device)
    pos = torch.stack([
        x.expand(h, w),
        torch.full((h, w), c.center[1], dtype=f32, device=device),
        z.expand(h, w),
    ])
    vel = torch.zeros((3, h, w), dtype=f32, device=device)
    return ClothState(pos=pos, vel=vel)


def params_from_numpy(p, device="cuda") -> ClothParams:
    """The JAX package's ``ClothParams`` (leaves as numpy or anything
    ``np.asarray`` takes) → the port's, on ``device``."""
    return ClothParams(**{
        f: torch.tensor(np.asarray(getattr(p, f), np.float32),
                        device=device)
        for f in ClothParams._fields})


def state_from_numpy(s, device="cuda") -> ClothState:
    """The JAX package's ``ClothState`` → the port's, on ``device``."""
    def conv(a, dtype):
        if a is None:
            return None
        return torch.tensor(np.asarray(a, dtype), device=device)

    return ClothState(pos=conv(s.pos, np.float32), vel=conv(s.vel, np.float32),
                      pin_mask=conv(s.pin_mask, np.bool_),
                      pin_pos=conv(s.pin_pos, np.float32))


def particle_state_from_numpy(s, device="cuda") -> ParticleState:
    """The JAX package's ``ParticleState`` (``pos``/``vel`` ``[3, N]``, as
    numpy or anything ``np.asarray`` takes) → the port's, on ``device``."""
    return ParticleState(
        pos=torch.tensor(np.asarray(s.pos, np.float32), device=device),
        vel=torch.tensor(np.asarray(s.vel, np.float32), device=device))



def particle_params_from_numpy(p, device="cuda") -> ParticleParams:
    """The JAX package's ``ParticleParams`` → the port's, on ``device``."""
    return ParticleParams(**{
        f: torch.tensor(np.asarray(getattr(p, f), np.float32), device=device)
        for f in ParticleParams._fields})
