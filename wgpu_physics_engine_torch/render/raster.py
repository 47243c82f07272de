"""Headless renderer passes over an explicit framebuffer (the counterpart of
``wgpu_physics_engine_tpu/render/raster.py``: ``Framebuffer``, ``clear``,
``draw_globe``, ``draw_instanced_spheres`` and ``draw_lines``).

The globe and every cloth instance — the reference draws all of them as
instanced UV-sphere meshes (cloth.rs:1350-1379) — are rendered
analytically, by per-pixel ray-sphere intersection. Depth convention: NDC
z in [0, 1], test = Less (wgpu Depth32Float, cloth.rs:749-770).

Every pass also takes a batch of worlds: a framebuffer with a leading
``[B]`` axis and a batched camera (``camera.make_camera`` with ``[B]``
orbit tensors), the counterpart of the JAX datagen's ``vmap`` over worlds.
Per-world scalars (radii, ``znear``, projection entries) then broadcast as
``[B, 1, 1]``; every op stays elementwise per pixel.
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
    color: torch.Tensor   # [H, W, 3] fp32 ([B, H, W, 3] for a batch)
    depth: torch.Tensor   # [H, W] fp32 (NDC z, 1.0 = far/clear)


def clear(height: int, width: int, color=(0.05, 0.05, 0.08),
          device=None, n_worlds=None) -> Framebuffer:
    """Clear pass (the Runner's clear color and depth = max); with
    ``n_worlds`` a batch of that many framebuffers."""
    lead = () if n_worlds is None else (n_worlds,)
    c = torch.as_tensor(color, dtype=torch.float32, device=device)
    return Framebuffer(
        color=c.expand(lead + (height, width, 3)).contiguous(),
        depth=torch.ones(lead + (height, width), dtype=torch.float32,
                         device=device))


def _plane(x: torch.Tensor) -> torch.Tensor:
    """A per-camera scalar (0-d, or [B] for a batch) shaped to broadcast
    against [..., H, W] planes."""
    return x[..., None, None]


def _ndc_z(view_z: torch.Tensor, camera: Camera) -> torch.Tensor:
    """View-space z (negative in front) → NDC depth in [0, 1]."""
    return ((_plane(camera.proj[..., 2, 2]) * view_z
             + _plane(camera.proj[..., 2, 3])) / (-view_z))


def _rotate(rot: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``rot`` [.., 3, 3] @ ``v`` [.., 3, H, W], written out (no matmul)."""
    r = rot[..., None, None]
    return torch.stack([r[..., i, 0, :, :] * v[..., 0, :, :]
                        + r[..., i, 1, :, :] * v[..., 1, :, :]
                        + r[..., i, 2, :, :] * v[..., 2, :, :]
                        for i in range(3)], dim=-3)


def _sphere_uv(rel: torch.Tensor, radius) -> Tuple[torch.Tensor, torch.Tensor]:
    """Reference sphere parametrization (sphere_vertices.rs:34-54): polar
    axis +z, u = θ/2π with θ = atan2(y, x), v = (π/2 − asin(z/r))/π."""
    x, y, z = rel.unbind(-3)
    z_over_r = torch.clamp(z / radius, -1.0, 1.0)
    interior = torch.abs(z_over_r) < 1.0
    asv = torch.asin(torch.where(interior, z_over_r, 0.0))
    v = torch.where(interior, (math.pi / 2.0 - asv) / math.pi,
                    torch.where(z_over_r > 0, 0.0, 1.0))
    r2xy = x * x + y * y
    off_pole = r2xy > 0
    theta = torch.atan2(torch.where(off_pole, y, 0.0),
                        torch.where(off_pole, x, 1.0))
    u = torch.remainder(theta / (2.0 * math.pi), 1.0)
    return u, v


def _light_view(camera: Camera, light: cfg.LightConfig) -> torch.Tensor:
    """Light position in view space (globe_shader.wgsl:91)."""
    lp = torch.as_tensor(light.position, dtype=torch.float32,
                         device=camera.view.device)
    return camera.view[..., :3, :3] @ lp + camera.view[..., :3, 3]


def _composite(fb: Framebuffer, hit: torch.Tensor, p_view: torch.Tensor,
               color: torch.Tensor, camera: Camera) -> Framebuffer:
    """Depth-tested write of ``color`` where ``hit`` (test = Less)."""
    zn = _ndc_z(torch.where(hit, p_view[..., 2, :, :], -1.0), camera)
    win = hit & (zn < fb.depth)
    return Framebuffer(color=torch.where(win[..., None], color, fb.color),
                       depth=torch.where(win, zn, fb.depth))


def draw_globe(fb: Framebuffer, camera: Camera, radius, texture: torch.Tensor,
               light: cfg.LightConfig) -> Framebuffer:
    """Lit, textured sphere at the origin — the analytic equivalent of the
    globe render pipeline (cloth.rs:705-773 + globe_shader.wgsl).
    ``radius`` is a number, or a [B] tensor for a batch of worlds."""
    h, w = fb.depth.shape[-2:]
    eye, dirs = pixel_rays(camera, h, w)              # [3], [3,H,W]
    center = torch.zeros(3, dtype=torch.float32, device=eye.device)
    radius = torch.as_tensor(radius, dtype=torch.float32, device=eye.device)
    oc = center - eye
    b = (_plane(oc[..., 0]) * dirs[..., 0, :, :]
         + _plane(oc[..., 1]) * dirs[..., 1, :, :]
         + _plane(oc[..., 2]) * dirs[..., 2, :, :])
    cc = torch.dot(oc, oc) if oc.ndim == 1 else torch.sum(oc * oc, dim=-1)
    disc = b * b - _plane(cc - radius * radius)
    hit = disc > 0.0
    t = b - torch.sqrt(torch.clamp_min(disc, 0.0))
    hit = hit & (t > _plane(camera.znear))

    p_world = eye[..., :, None, None] + t[..., None, :, :] * dirs
    rel = p_world - center[:, None, None]
    n_world = rel / _plane(radius)[..., None, :, :]

    rot = camera.view[..., :3, :3]
    p_view = _rotate(rot, p_world - eye[..., :, None, None])
    n_view = _rotate(rot, n_world)

    u, v = _sphere_uv(rel, _plane(radius))
    albedo = tex_mod.sample(texture, u, v)
    color = shading.phong(p_view, n_view, albedo, _light_view(camera, light),
                          light)
    return _composite(fb, hit, p_view, color, camera)


def draw_instanced_spheres(
    fb: Framebuffer, camera: Camera, centers, radius,
    flat_color: Tuple[float, float, float] = (1.0, 0.0, 0.0),
) -> Framebuffer:
    """Instanced sphere pass — the analytic replacement for the cloth's
    instanced draw (cloth.rs:1366-1379) in its flat-colored mode
    (cloth_instances.wgsl:81). ``centers``: [N, 3], or [B, N, 3] for a
    batch of worlds.

    The nearest hit per pixel comes from the tile-binned raster
    (``ops.raster_kernel``): the CUDA kernel for a CUDA framebuffer, its
    plain version for a CPU one; a batch is binned in one pass
    (``tiled_prologue_batched``) and takes one launch for all worlds.
    (The JAX package's textured and lit modes serve the free-particle
    scene and come with its port.)
    """
    h, w = fb.depth.shape[-2:]
    eye, dirs = pixel_rays(camera, h, w)
    prologue = (raster_kernel.tiled_prologue_batched if eye.ndim == 2
                else raster_kernel.tiled_prologue)
    wins, ocb, _ = prologue(camera.view[..., :3, :3], eye, centers, radius,
                            camera.znear, torch.tan(camera.fovy_rad / 2.0),
                            camera.aspect, h, w)
    tmin, inst, _ = raster_kernel.sphere_raster_binned(wins, ocb, dirs,
                                                       camera.znear)
    hit = inst >= 0

    tmin_g = torch.where(hit, tmin, 0.0)
    p_world = eye[..., :, None, None] + tmin_g[..., None, :, :] * dirs
    p_view = _rotate(camera.view[..., :3, :3], p_world - eye[..., :, None, None])
    color = torch.as_tensor(flat_color, dtype=torch.float32,
                            device=dirs.device).expand(fb.color.shape)
    return _composite(fb, hit, p_view, color, camera)


def _affine_rows(m: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``v @ m[:3, :3].T + m[:3, 3]`` for ``v`` [L, 3], written out."""
    return torch.stack([v[:, 0] * m[i, 0] + v[:, 1] * m[i, 1]
                        + v[:, 2] * m[i, 2] + m[i, 3] for i in range(3)],
                       dim=1)


def draw_lines(fb: Framebuffer, camera: Camera, segments,
               color=(0.0, 0.0, 1.0), px_width: float = 1.0) -> Framebuffer:
    """Line-list pass (the wireframe bounds box, the reference's
    wireframe_shader). ``segments``: [L, 2, 3] world-space endpoints (a
    tensor or an array). Screen-space distance test per pixel, depth-tested
    against the interpolated segment depth. One framebuffer, no batch."""
    h, w = fb.depth.shape
    dev = fb.depth.device
    seg = torch.as_tensor(segments, dtype=torch.float32, device=dev)
    view = camera.view.to(dev)
    proj = camera.proj.to(dev)

    def project(v):
        vv = _affine_rows(view, v)
        wc = -vv[:, 2]
        ndc = _affine_rows(proj, vv) / wc[:, None]
        return (torch.stack([(ndc[:, 0] + 1) * 0.5 * w,
                             (1 - ndc[:, 1]) * 0.5 * h], 1), ndc[:, 2], wc)

    pa, za, wa = project(seg[:, 0, :])
    pb, zb, wb = project(seg[:, 1, :])
    znear = camera.znear.to(dev)
    ok = (wa > znear) & (wb > znear)

    px = (torch.arange(w, dtype=torch.float32, device=dev) + 0.5)[None, :, None]
    py = (torch.arange(h, dtype=torch.float32, device=dev) + 0.5)[:, None, None]
    ab = pb - pa                                       # [L, 2]
    ap_x = px - pa[None, None, :, 0]
    ap_y = py - pa[None, None, :, 1]
    ab2 = ab[:, 0] * ab[:, 0] + ab[:, 1] * ab[:, 1]
    s = ((ap_x * ab[None, None, :, 0] + ap_y * ab[None, None, :, 1])
         / torch.clamp_min(ab2, 1e-12))
    s = torch.clamp(s, 0.0, 1.0)
    dx = ap_x - s * ab[None, None, :, 0]
    dy = ap_y - s * ab[None, None, :, 1]
    dist2 = dx * dx + dy * dy
    on_line = (dist2 <= (0.5 + px_width / 2) ** 2) & ok[None, None, :]
    z = za[None, None, :] + s * (zb - za)[None, None, :]
    z = torch.where(on_line, z, torch.inf)
    zmin = torch.amin(z, dim=2)
    win = (zmin < fb.depth) & torch.isfinite(zmin)
    c = torch.as_tensor(color, dtype=torch.float32, device=dev)
    return Framebuffer(color=torch.where(win[..., None], c, fb.color),
                       depth=torch.where(win, zmin, fb.depth))
