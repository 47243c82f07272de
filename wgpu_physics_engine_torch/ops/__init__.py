from . import cloth_kernel, raster_kernel

__all__ = ["cloth_kernel", "raster_kernel"]
