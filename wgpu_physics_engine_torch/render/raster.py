"""Headless renderer passes over an explicit framebuffer (the counterpart of
``wgpu_physics_engine_tpu/render/raster.py``: ``Framebuffer``, ``clear``,
``draw_globe`` and ``draw_instanced_spheres``).

The globe and every cloth instance — the reference draws all of them as
instanced UV-sphere meshes (cloth.rs:1350-1379) — are rendered
analytically, by per-pixel ray-sphere intersection. Depth convention: NDC
z in [0, 1], test = Less (wgpu Depth32Float, cloth.rs:749-770).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import torch

from ..core import config as cfg
from ..ops import raster_kernel
from . import shading, texture as tex_mod
from .camera import Camera, pixel_rays


class Framebuffer(NamedTuple):
    color: torch.Tensor   # [H, W, 3] fp32
    depth: torch.Tensor   # [H, W] fp32 (NDC z, 1.0 = far/clear)


def clear(height: int, width: int, color=(0.05, 0.05, 0.08),
          device=None) -> Framebuffer:
    """Clear pass (the Runner's clear color and depth = max)."""
    c = torch.as_tensor(color, dtype=torch.float32, device=device)
    return Framebuffer(
        color=c.expand(height, width, 3).contiguous(),
        depth=torch.ones((height, width), dtype=torch.float32, device=device))


def _ndc_z(view_z: torch.Tensor, camera: Camera) -> torch.Tensor:
    """View-space z (negative in front) → NDC depth in [0, 1]."""
    return (camera.proj[2, 2] * view_z + camera.proj[2, 3]) / (-view_z)


def _rotate(rot: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``rot`` [3, 3] @ ``v`` [3, H, W], written out (no matmul)."""
    return torch.stack([rot[i, 0] * v[0] + rot[i, 1] * v[1] + rot[i, 2] * v[2]
                        for i in range(3)])


def _sphere_uv(rel: torch.Tensor, radius) -> Tuple[torch.Tensor, torch.Tensor]:
    """Reference sphere parametrization (sphere_vertices.rs:34-54): polar
    axis +z, u = θ/2π with θ = atan2(y, x), v = (π/2 − asin(z/r))/π."""
    z_over_r = torch.clamp(rel[2] / radius, -1.0, 1.0)
    interior = torch.abs(z_over_r) < 1.0
    asv = torch.asin(torch.where(interior, z_over_r, 0.0))
    v = torch.where(interior, (math.pi / 2.0 - asv) / math.pi,
                    torch.where(z_over_r > 0, 0.0, 1.0))
    r2xy = rel[0] * rel[0] + rel[1] * rel[1]
    off_pole = r2xy > 0
    theta = torch.atan2(torch.where(off_pole, rel[1], 0.0),
                        torch.where(off_pole, rel[0], 1.0))
    u = torch.remainder(theta / (2.0 * math.pi), 1.0)
    return u, v


def _light_view(camera: Camera, light: cfg.LightConfig) -> torch.Tensor:
    """Light position in view space (globe_shader.wgsl:91)."""
    lp = torch.as_tensor(light.position, dtype=torch.float32,
                         device=camera.view.device)
    return camera.view[:3, :3] @ lp + camera.view[:3, 3]


def draw_globe(fb: Framebuffer, camera: Camera, radius, texture: torch.Tensor,
               light: cfg.LightConfig) -> Framebuffer:
    """Lit, textured sphere at the origin — the analytic equivalent of the
    globe render pipeline (cloth.rs:705-773 + globe_shader.wgsl)."""
    h, w = fb.depth.shape
    eye, dirs = pixel_rays(camera, h, w)              # [3], [3,H,W]
    center = torch.zeros(3, dtype=torch.float32, device=eye.device)
    radius = torch.tensor(float(radius), dtype=torch.float32, device=eye.device)
    oc = center - eye
    b = oc[0] * dirs[0] + oc[1] * dirs[1] + oc[2] * dirs[2]
    cc = torch.dot(oc, oc)
    disc = b * b - (cc - radius * radius)
    hit = disc > 0.0
    t = b - torch.sqrt(torch.clamp_min(disc, 0.0))
    hit = hit & (t > camera.znear)

    p_world = eye[:, None, None] + t[None] * dirs
    rel = p_world - center[:, None, None]
    n_world = rel / radius

    rot = camera.view[:3, :3]
    p_view = _rotate(rot, p_world - eye[:, None, None])
    n_view = _rotate(rot, n_world)

    u, v = _sphere_uv(rel, radius)
    albedo = tex_mod.sample(texture, u, v)
    color = shading.phong(p_view, n_view, albedo, _light_view(camera, light),
                          light)

    zn = _ndc_z(torch.where(hit, p_view[2], -1.0), camera)
    win = hit & (zn < fb.depth)
    return Framebuffer(color=torch.where(win[..., None], color, fb.color),
                       depth=torch.where(win, zn, fb.depth))


def draw_instanced_spheres(
    fb: Framebuffer, camera: Camera, centers: torch.Tensor, radius,
    flat_color: Tuple[float, float, float] = (1.0, 0.0, 0.0),
) -> Framebuffer:
    """Instanced sphere pass — the analytic replacement for the cloth's
    instanced draw (cloth.rs:1366-1379) in its flat-colored mode
    (cloth_instances.wgsl:81). ``centers``: [N, 3].

    The nearest hit per pixel comes from the tile-binned raster
    (``ops.raster_kernel``): the CUDA kernel for a CUDA framebuffer, its
    plain version for a CPU one. (The JAX package's textured and lit modes
    serve the free-particle scene and come with its port.)
    """
    h, w = fb.depth.shape
    eye, dirs = pixel_rays(camera, h, w)
    tmin, hit, _ = raster_kernel.sphere_raster_tiled(
        camera.view[:3, :3], eye, dirs, centers, radius, camera.znear,
        torch.tan(camera.fovy_rad / 2.0), camera.aspect)

    tmin_g = torch.where(hit, tmin, 0.0)
    p_world = eye[:, None, None] + tmin_g[None] * dirs
    p_view = _rotate(camera.view[:3, :3], p_world - eye[:, None, None])
    color = torch.as_tensor(flat_color, dtype=torch.float32,
                            device=dirs.device).expand(h, w, 3)

    zn = _ndc_z(torch.where(hit, p_view[2], -1.0), camera)
    win = hit & (zn < fb.depth)
    return Framebuffer(color=torch.where(win[..., None], color, fb.color),
                       depth=torch.where(win, zn, fb.depth))
