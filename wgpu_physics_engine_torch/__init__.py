"""wgpu_physics_engine_torch — the PyTorch / CUDA port of
``wgpu_physics_engine_tpu``, for one NVIDIA H100.

The same layout (``core``, ``models``, ``ops``, ``render``, ``utils``) and
function names as the JAX package, which stays beside it as the reference.
Plain code is eager torch on tensors; each TPU kernel on a ported path is a
hand-written CUDA kernel in ``ops/csrc``, built by nvcc at first CUDA use,
with a plain torch version beside it that CPU tensors take. This package
never imports jax.

Ported so far: every scene of the JAX CLI — the mesh cube, textured cube
and globe (``CubeScene``, ``TexturedCubeScene``, ``GlobeScene``), the
free-particle box (``FreeParticleScene``), the flagship cloth
(``ClothScene``) and the granular pile (``GranularScene``), all in
``models.scenes`` and behind ``python -m wgpu_physics_engine_torch
{cube,textured,globe,particles,cloth,granular}`` (``--live`` streams
ANSI frames to the terminal); batched datagen of both model families,
cloth and granular, written through the native shard writer (``native``);
gradients through the cloth, through granular contact and through the
renderer (``examples.inverse_rendering``); the utils (checkpoints, debug,
metrics, profiling); and the multi-device paths over a mesh of torch
devices held by one process (``parallel.mesh``: worlds- and rows-sharded
cloth with halo exchange; ``parallel.granular_mesh``: the grain-sharded
granular pile).
"""

__version__ = "0.1.0"

from .core import config
from .core.config import (
    CameraConfig,
    ClothConfig,
    FreeParticleConfig,
    GlobeConfig,
    LightConfig,
)
from .core.state import (
    ClothParams,
    ClothState,
    ParticleParams,
    ParticleState,
    init_cloth_state,
    params_from_numpy,
    particle_params_from_numpy,
    particle_state_from_numpy,
    state_from_numpy,
)

__all__ = [
    "config",
    "CameraConfig",
    "ClothConfig",
    "FreeParticleConfig",
    "GlobeConfig",
    "LightConfig",
    "ClothParams",
    "ClothState",
    "ParticleParams",
    "ParticleState",
    "init_cloth_state",
    "params_from_numpy",
    "particle_params_from_numpy",
    "particle_state_from_numpy",
    "state_from_numpy",
]
