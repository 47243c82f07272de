from . import broadphase, cloth, granular, particles, scenes

__all__ = ["broadphase", "cloth", "granular", "particles", "scenes"]
