from . import checkpoint, debug, metrics, profiling, viewer

__all__ = ["checkpoint", "debug", "metrics", "profiling", "viewer"]
