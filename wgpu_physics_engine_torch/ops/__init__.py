from . import cloth_grad_kernel, cloth_kernel, raster_kernel

__all__ = ["cloth_grad_kernel", "cloth_kernel", "raster_kernel"]
