from . import viewer

__all__ = ["viewer"]
