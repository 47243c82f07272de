from . import camera, raster, shading, texture
from .camera import Camera, make_camera, pixel_rays
from .raster import (
    Framebuffer,
    clear,
    draw_globe,
    draw_instanced_spheres,
)

__all__ = [
    "camera", "raster", "shading", "texture",
    "Camera", "make_camera", "pixel_rays",
    "Framebuffer", "clear", "draw_globe", "draw_instanced_spheres",
]
