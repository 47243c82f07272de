from . import (cloth_grad_kernel, cloth_kernel, cloth_tiled_kernel,
               granular_kernel, pixel_kernel, raster_kernel)

__all__ = ["cloth_grad_kernel", "cloth_kernel", "cloth_tiled_kernel",
           "granular_kernel", "pixel_kernel", "raster_kernel"]
