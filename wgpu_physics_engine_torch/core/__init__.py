from . import config, state, topology

__all__ = ["config", "state", "topology"]
