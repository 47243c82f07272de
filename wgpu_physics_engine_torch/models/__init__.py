from . import cloth, scenes

__all__ = ["cloth", "scenes"]
