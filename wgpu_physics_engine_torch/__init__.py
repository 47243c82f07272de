"""wgpu_physics_engine_torch — the PyTorch / CUDA port of
``wgpu_physics_engine_tpu``, for one NVIDIA H100.

The same layout (``core``, ``models``, ``ops``, ``render``, ``utils``) and
function names as the JAX package, which stays beside it as the reference.
Plain code is eager torch on tensors; each TPU kernel on a ported path is a
hand-written CUDA kernel in ``ops/csrc``, built by nvcc at first CUDA use,
with a plain torch version beside it that CPU tensors take. This package
never imports jax.

Ported so far: the flagship cloth scene (``models.scenes.ClothScene``:
step + render) and its CLI, ``python -m wgpu_physics_engine_torch cloth``;
batched cloth datagen; gradients through the cloth; and the granular pile
(``models.scenes.GranularScene``, ``python -m wgpu_physics_engine_torch
granular``).
"""

__version__ = "0.1.0"

from .core import config
from .core.config import CameraConfig, ClothConfig, GlobeConfig, LightConfig
from .core.state import (
    ClothParams,
    ClothState,
    ParticleState,
    init_cloth_state,
    params_from_numpy,
    particle_state_from_numpy,
    state_from_numpy,
)

__all__ = [
    "config",
    "CameraConfig",
    "ClothConfig",
    "GlobeConfig",
    "LightConfig",
    "ClothParams",
    "ClothState",
    "ParticleState",
    "init_cloth_state",
    "params_from_numpy",
    "particle_state_from_numpy",
    "state_from_numpy",
]
