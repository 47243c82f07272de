from . import camera, geometry, raster, shading, texture
from .camera import Camera, make_camera, pixel_rays
from .raster import (
    DeviceMesh,
    Framebuffer,
    clear,
    draw_globe,
    draw_instanced_spheres,
    draw_instanced_spheres_rgb8,
    draw_lines,
    draw_mesh,
)

__all__ = [
    "camera", "geometry", "raster", "shading", "texture",
    "Camera", "make_camera", "pixel_rays",
    "DeviceMesh", "Framebuffer", "clear",
    "draw_globe", "draw_instanced_spheres", "draw_instanced_spheres_rgb8",
    "draw_lines", "draw_mesh",
]
