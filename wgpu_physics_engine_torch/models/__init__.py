from . import broadphase, cloth, granular, scenes

__all__ = ["broadphase", "cloth", "granular", "scenes"]
