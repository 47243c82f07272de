"""Scene & physics configuration.

The reference engine (Muten-Roshi-Sama/wgpu_physics_engine) keeps all of its
configuration in two tiers:

1. compile-time ``const`` blocks at the top of each app
   (``simulations/5_cloth_simulation/src/cloth.rs:52-105``,
   ``simulations/4_instances_imgui/src/instance.rs:25-49``), and
2. runtime egui sliders that mutate a small set of uniforms
   (``cloth.rs:1383-1451``).

Here tier (1) becomes frozen Python dataclasses (static, hashable), and
tier (2) becomes the *dynamic* parameter NamedTuples of device tensors in
:mod:`wgpu_physics_engine_torch.core.state` (``ClothParams``), so slider
changes rewrite a tensor and rebuild no kernel.

A copy of ``wgpu_physics_engine_tpu/core/config.py`` (that package's
``__init__`` imports jax, so the port cannot import it);
``tests/test_torch_core.py`` holds the two equal field for field.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

# ---------------------------------------------------------------------------
# Reference default constants (cloth app, cloth.rs:69-105)
# ---------------------------------------------------------------------------

DEFAULT_ZOOM = 40.0               # cloth.rs:69  (camera orbit radius)
GLOBE_RADIUS = 10.0               # cloth.rs:72  (RADIUS)
GLOBE_STACK_COUNT = 64            # cloth.rs:73
GLOBE_SECTOR_COUNT = 128          # cloth.rs:74
LIGHT_POS = (20.0, 20.0, 20.0)    # cloth.rs:76  (2*RADIUS each)
LIGHT_KS = 2.0                    # cloth.rs:77
LIGHT_SHININESS = 100.0           # cloth.rs:78

TIME_SCALE = 1.0                  # cloth.rs:82
PHYSICS_HZ = 480.0                # cloth.rs:83  (HZ — substep target rate)
MAX_SUBSTEPS = 8                  # cloth.rs:1463
GRAVITY = -9.81                   # cloth.rs:84
SPEED_DAMP = 1.0                  # cloth.rs:85
COLLISION_K = 2000.0              # cloth.rs:86
FRICTION_COEFF = 0.1              # cloth.rs:87

CLOTH_PARTICLES_PER_SIDE = 60     # cloth.rs:90
CLOTH_PARTICLE_RADIUS = 0.1       # cloth.rs:91
CLOTH_SIZE = 30.0                 # cloth.rs:92
CLOTH_CENTER = (0.0, 40.0, 0.0)   # cloth.rs:93  (0, 4*RADIUS, 0)

MASS = 1.0                        # cloth.rs:98
STRUCTURAL_STIFFNESS = 450.0      # cloth.rs:99
SHEAR_STIFFNESS = 300.0           # cloth.rs:100
BEND_STIFFNESS = 100.0            # cloth.rs:101
STRUCTURAL_DAMPING = 5.0          # cloth.rs:102
SHEAR_DAMPING = 5.0               # cloth.rs:103
BEND_DAMPING = 2.0                # cloth.rs:104

# Free-particle app defaults (instance.rs:25-49)
FP_BOUNDS = 10.0                  # instance.rs:30 (BOUNDS — half extent of box)
FP_RADIUS = 1.0                   # instance.rs:33 (sphere radius)
FP_NUM_PARTICLES = 10             # instance.rs:39
FP_INITIAL_SPEED = 20.0           # instance.rs:34 (velocity ~ U(-20, 20))
FP_GRAVITY = (0.0, -9.81, 0.0)    # instance.rs:42
FP_DAMPING = 0.95                 # instance.rs:43 (bound but unused by kernel)


@dataclasses.dataclass(frozen=True)
class ClothConfig:
    """Static scene description for the flagship mass-spring cloth.

    Mirrors the const block at ``cloth.rs:82-105`` plus the scene geometry
    constants. ``height``/``width`` generalise the reference's square
    ``CLOTH_PARTICLES_PER_SIDE`` grid to rectangular grids (the reference
    topology builder ``cloth.rs:907-962`` already supports H != W).
    """

    height: int = CLOTH_PARTICLES_PER_SIDE
    width: int = CLOTH_PARTICLES_PER_SIDE
    cloth_size: float = CLOTH_SIZE
    center: Tuple[float, float, float] = CLOTH_CENTER
    particle_radius: float = CLOTH_PARTICLE_RADIUS
    globe_radius: float = GLOBE_RADIUS

    mass: float = MASS
    gravity: float = GRAVITY
    speed_damp: float = SPEED_DAMP
    k_contact: float = COLLISION_K
    mu: float = FRICTION_COEFF

    k_struct: float = STRUCTURAL_STIFFNESS
    k_shear: float = SHEAR_STIFFNESS
    k_bend: float = BEND_STIFFNESS
    c_struct: float = STRUCTURAL_DAMPING
    c_shear: float = SHEAR_DAMPING
    c_bend: float = BEND_DAMPING

    time_scale: float = TIME_SCALE
    hz: float = PHYSICS_HZ
    max_substeps: int = MAX_SUBSTEPS

    @property
    def spacing(self) -> float:
        """Inter-particle spacing: ``CLOTH_SIZE / (n - 1)`` (cloth.rs:851)."""
        return self.cloth_size / (self.width - 1.0)

    @property
    def rest_struct(self) -> float:
        """Uniform structural rest length (cloth.rs:557)."""
        return self.spacing

    @property
    def rest_shear(self) -> float:
        """Uniform shear rest length: spacing * sqrt(2) (cloth.rs:558)."""
        return self.spacing * math.sqrt(2.0)

    @property
    def rest_bend(self) -> float:
        """Uniform bend rest length: spacing * 2 (cloth.rs:559)."""
        return self.spacing * 2.0

    @property
    def num_particles(self) -> int:
        return self.height * self.width


@dataclasses.dataclass(frozen=True)
class FreeParticleConfig:
    """Static config for the free-particle box sim (instance.rs:25-49).

    ``bug_compat`` selects bit-faithful reproduction of the reference
    integrator's quirk (``4_instances_imgui/compute_movement.wgsl:62-100``):
    the post-bounce position clamp is written to a local that is never copied
    back into the model matrix, so only the velocity flip persists. The
    default implements the documented-correct semantics (clamp persists).
    """

    num_particles: int = FP_NUM_PARTICLES
    bounds: float = FP_BOUNDS
    radius: float = FP_RADIUS
    initial_speed: float = FP_INITIAL_SPEED
    gravity: Tuple[float, float, float] = FP_GRAVITY
    damping: float = FP_DAMPING  # carried for parity; unused, like the ref
    time_scale: float = TIME_SCALE
    bug_compat: bool = False


@dataclasses.dataclass(frozen=True)
class GlobeConfig:
    """Lit/textured UV-sphere scene (sim 3 'Globe'; globe.rs:85-562)."""

    radius: float = GLOBE_RADIUS
    stack_count: int = GLOBE_STACK_COUNT
    sector_count: int = GLOBE_SECTOR_COUNT


@dataclasses.dataclass(frozen=True)
class LightConfig:
    """Phong light parameters (cloth.rs:76-79, globe_shader.wgsl:11-17)."""

    position: Tuple[float, float, float] = LIGHT_POS
    ks: float = LIGHT_KS
    shininess: float = LIGHT_SHININESS
    compute_specular: bool = True
    ambient: float = 0.1       # globe_shader.wgsl:100
    luminosity: float = 2.4    # globe_shader.wgsl:101


@dataclasses.dataclass(frozen=True)
class CameraConfig:
    """Orbit camera defaults (cloth.rs:568-581; wgpu-bootstrap OrbitCamera)."""

    fovy_deg: float = 45.0
    znear: float = 0.1
    zfar: float = 100.0
    target: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    radius: float = DEFAULT_ZOOM
    theta: float = 0.0  # azimuth
    phi: float = 0.0    # elevation
