"""Headless renderer passes over an explicit framebuffer (the counterpart of
``wgpu_physics_engine_tpu/render/raster.py``: ``Framebuffer``, ``clear``,
``draw_globe``, ``draw_instanced_spheres``, ``DeviceMesh`` / ``draw_mesh``
and ``draw_lines``), and ``draw_instanced_spheres_rgb8``, the datagens'
uint8 frame of flat-coloured spheres.

The globe and every cloth or particle instance — the reference draws all
of them as instanced UV-sphere meshes (cloth.rs:1350-1379) — are rendered
analytically, by per-pixel ray-sphere intersection. A z-buffered triangle
rasterizer (``draw_mesh``, plain torch as the JAX package's is XLA) covers
the cube apps and the tessellated globe. Depth convention: NDC z in [0, 1],
test = Less (wgpu Depth32Float, cloth.rs:749-770).

The sphere passes also take a batch of worlds: a framebuffer with a
leading ``[B]`` axis and a batched camera (``camera.make_camera`` with
``[B]`` orbit tensors), the counterpart of the JAX datagen's ``vmap`` over
worlds. Per-world scalars (radii, ``znear``, projection entries) then
broadcast as ``[B, 1, 1]``; every op stays elementwise per pixel.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..core import config as cfg
from ..ops import pixel_kernel, raster_kernel
from . import shading, texture as tex_mod
from .camera import Camera, _needs_grad, pixel_rays
from ..utils.profiling import span


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


def _sqrt0(x: torch.Tensor) -> torch.Tensor:
    """``sqrt(max(x, 0))``. Where ``x`` carries a gradient, the form whose
    backward pass is finite everywhere (JAX's ``raster._safe_sqrt``):
    ``d sqrt/dx`` at 0 is inf, and inf times the 0 cotangent of a masked
    pixel is NaN. Both forms give the same bits."""
    if not x.requires_grad:
        return torch.sqrt(torch.clamp_min(x, 0.0))
    pos = x > 0.0
    return torch.where(pos, torch.sqrt(torch.where(pos, x, 1.0)), 0.0)


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
               light: cfg.LightConfig, compute_specular=None,
               center=(0.0, 0.0, 0.0)) -> Framebuffer:
    """Lit, textured sphere at ``center`` — the analytic equivalent of the
    globe render pipeline (cloth.rs:705-773 + globe_shader.wgsl).
    ``radius`` is a number, or a [B] tensor for a batch of worlds;
    ``compute_specular`` overrides the light's toggle (None keeps it).

    Differentiable: ``torch.autograd`` carries gradients to ``radius``,
    ``center``, the camera and a tensor ``light.position``, through the
    gradient-safe square roots of :func:`_sqrt0` and
    ``shading._normalize`` and the pole-safe :func:`_sphere_uv`."""
    h, w = fb.depth.shape[-2:]
    eye, dirs = pixel_rays(camera, h, w)              # [3], [3,H,W]
    center = torch.as_tensor(center, dtype=torch.float32, device=eye.device)
    radius = torch.as_tensor(radius, dtype=torch.float32, device=eye.device)
    oc = center - eye
    b = (_plane(oc[..., 0]) * dirs[..., 0, :, :]
         + _plane(oc[..., 1]) * dirs[..., 1, :, :]
         + _plane(oc[..., 2]) * dirs[..., 2, :, :])
    cc = torch.dot(oc, oc) if oc.ndim == 1 else torch.sum(oc * oc, dim=-1)
    disc = b * b - _plane(cc - radius * radius)
    hit = disc > 0.0
    t = b - _sqrt0(disc)
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
                          light, compute_specular)
    return _composite(fb, hit, p_view, color, camera)


def _hit_t(cen: torch.Tensor, eye: torch.Tensor, dirs: torch.Tensor, radius,
           hit: torch.Tensor) -> torch.Tensor:
    """``t_t - t_t.detach()``: zero in value, the gradient of the hit
    distance of rays ``dirs`` against the spheres centred at ``cen``
    ([..., 3, H, W], each pixel's winner), the plain sweep's expression
    (``raster_kernel._sweep``) on the winner alone; 0 where nothing
    hit."""
    oc = cen - eye[..., :, None, None]
    ox, oy, oz = oc.unbind(-3)
    r = _plane(torch.as_tensor(radius, dtype=torch.float32,
                               device=dirs.device))
    b = (dirs[..., 0, :, :] * ox + dirs[..., 1, :, :] * oy
         + dirs[..., 2, :, :] * oz)
    disc = b * b - (ox * ox + oy * oy + oz * oz - r * r)
    t = torch.where(hit, b - _sqrt0(disc), 0.0)
    return t - t.detach()


def _nearest_hits(camera: Camera, eye: torch.Tensor, dirs: torch.Tensor,
                  centers, radius):
    """The nearest sphere hit of every pixel, by the JAX renderer's route
    (see :func:`draw_instanced_spheres`): ``(tmin, inst, order, oc)``;
    ``order`` (sorted → original index) and ``oc`` (the winner's
    eye-relative centre) are ``None`` on the untiled route. No gradient."""
    h, w = dirs.shape[-2:]
    if (eye.ndim == 1 and centers.shape[0] <= raster_kernel.MAX_INSTANCES
            and (h % 16 or w % 128)):
        with torch.no_grad(), span("render.raster"):
            tmin, inst = raster_kernel.sphere_raster_untiled(
                eye, dirs, centers, radius, camera.znear)
        return tmin, inst, None, None
    prologue = (raster_kernel.tiled_prologue_batched if eye.ndim == 2
                else raster_kernel.tiled_prologue)
    with torch.no_grad():
        with span("render.bin"):
            wins, ocb, order, rect = prologue(
                camera.view[..., :3, :3], eye, centers, radius,
                camera.znear, torch.tan(camera.fovy_rad / 2.0),
                camera.aspect, h, w)
        with span("render.raster"):
            tmin, inst, oc = raster_kernel.sphere_raster_binned(
                wins, ocb, rect, dirs, camera.znear)
    return tmin, inst, order, oc


def draw_instanced_spheres(
    fb: Framebuffer, camera: Camera, centers, radius,
    light: Optional[cfg.LightConfig] = None,
    flat_color: Optional[Tuple[float, float, float]] = (1.0, 0.0, 0.0),
    texture: Optional[torch.Tensor] = None,
    lit: bool = False,
) -> Framebuffer:
    """Instanced sphere pass — the analytic replacement for the cloth and
    particle instanced draws (cloth.rs:1366-1379). ``centers``: [N, 3], or
    [B, N, 3] for a batch of worlds.

    Modes, mirroring the reference fragment shaders: ``flat_color`` (red by
    default, cloth_instances.wgsl:81); ``texture`` without ``lit``, the
    unlit texture sample (instances_shader.wgsl:70-77); ``lit``, Phong
    under ``light`` (the commented-out path of instances_shader.wgsl:80-112).

    The nearest hit per pixel takes the JAX renderer's route: one world of
    at most ``raster_kernel.MAX_INSTANCES`` instances on a frame that is
    not a multiple of (16, 128) pixels goes to the untiled raster (K4),
    the winner's centre gathered from ``centers``; everything else, and
    every batch, to the tile-binned raster (K2/K3), the winner's centre
    from its ``oc`` output (a batch is binned in one pass and takes one
    launch for all worlds). Each route runs its CUDA kernel for a CUDA
    framebuffer and its plain version for a CPU one.

    Differentiable on both routes and devices: the search for the nearest
    hit is discrete and carries no gradient, so where autograd needs one
    (grad enabled and ``centers``, ``radius`` or a camera leaf requiring
    grad) the winner's hit distance, and on the K2/K3 route its centre,
    are recomputed in torch from the winner's index, the a.e. gradient of
    JAX's plain route through its argmin. The forward keeps the kernel's
    bits (``t_k + (t_t - t_t.detach())``); without a gradient to carry
    nothing is recomputed.
    """
    h, w = fb.depth.shape[-2:]
    eye, dirs = pixel_rays(camera, h, w)
    shaded = texture is not None or lit
    grad = _needs_grad(centers, radius, *camera)
    tmin, inst, order, oc = _nearest_hits(camera, eye, dirs, centers, radius)
    hit = inst >= 0
    if oc is None:
        cen = (centers.T[:, inst.clamp_min(0).long()] if shaded or grad
               else None)
    else:
        cen = eye[..., :, None, None] + oc if shaded else None
        if grad:
            # the winner's original index: order maps sorted to original
            srt = inst.clamp_min(0).long()
            if eye.ndim == 1:
                idx = order.long()[srt]
                cen_t = centers.T[:, idx]
            else:
                idx = torch.gather(order.long(), 1, srt.flatten(1)
                                   ).reshape(srt.shape)
                cen_t = torch.stack([
                    torch.gather(centers[..., k], 1, idx.flatten(1)
                                 ).reshape(idx.shape) for k in range(3)],
                    dim=1)
            cen = ((eye[..., :, None, None] + oc).detach()
                   + (cen_t - cen_t.detach()))
    if grad:
        with span("render.shade"):
            tmin = tmin + _hit_t(cen, eye, dirs, radius, hit)
    if not shaded:
        return _flat_composite(fb, camera, eye, dirs, tmin, hit, flat_color)
    with span("render.shade"):
        p_world, p_view = _hit_points(camera, eye, dirs, tmin, hit)
        r = _plane(torch.as_tensor(radius, dtype=torch.float32,
                                   device=dirs.device))
        rel = p_world - cen
        if texture is not None:
            u, v = _sphere_uv(rel, r)
            albedo = tex_mod.sample(texture, u, v)
        else:
            albedo = _flat_albedo(flat_color, fb)
        if lit:
            n_view = _rotate(camera.view[..., :3, :3], rel / r[..., None, :, :])
            color = shading.phong(p_view, n_view, albedo,
                                  _light_view(camera, light), light)
        else:
            color = albedo
    with span("render.composite"):
        return _composite(fb, hit, p_view, color, camera)


def _hit_points(camera: Camera, eye: torch.Tensor, dirs: torch.Tensor,
                tmin: torch.Tensor, hit: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The world and view positions ``[.., 3, H, W]`` of each pixel's
    nearest hit (the eye on a miss)."""
    tmin_g = torch.where(hit, tmin, 0.0)
    p_world = eye[..., :, None, None] + tmin_g[..., None, :, :] * dirs
    p_view = _rotate(camera.view[..., :3, :3],
                     p_world - eye[..., :, None, None])
    return p_world, p_view


def _flat_albedo(flat_color, fb: Framebuffer) -> torch.Tensor:
    """``flat_color`` as a colour plane of ``fb``'s shape."""
    return torch.as_tensor(flat_color, dtype=torch.float32,
                           device=fb.color.device).expand(fb.color.shape)


def _flat_composite(fb: Framebuffer, camera: Camera, eye: torch.Tensor,
                    dirs: torch.Tensor, tmin: torch.Tensor, hit: torch.Tensor,
                    flat_color) -> Framebuffer:
    """:func:`draw_instanced_spheres`' flat route after the raster: the
    nearest hits (``tmin`` where ``hit``) in ``flat_color``, depth-tested
    over ``fb``. With :func:`to_rgb8`, the epilogue kernel's plain
    version."""
    with span("render.shade"):
        p_view = _hit_points(camera, eye, dirs, tmin, hit)[1]
        color = _flat_albedo(flat_color, fb)
    with span("render.composite"):
        return _composite(fb, hit, p_view, color, camera)


def to_rgb8(color: torch.Tensor) -> torch.Tensor:
    """An fp32 colour plane as the datagens' uint8 frame:
    ``clamp(c, 0, 1) * 255 + 0.5`` truncated."""
    return (torch.clamp(color, 0.0, 1.0) * 255.0 + 0.5).to(torch.uint8)


def draw_instanced_spheres_rgb8(
    fb: Framebuffer, camera: Camera, centers, radius,
    flat_color: Tuple[float, float, float] = (1.0, 0.0, 0.0),
) -> torch.Tensor:
    """Flat-coloured instanced spheres over ``fb``, as the uint8 frame
    ``[H, W, 3]`` (``[B, H, W, 3]`` for a batch): the datagens' frame, the
    colour of ``draw_instanced_spheres(fb, camera, centers, radius,
    flat_color=flat_color)`` through :func:`to_rgb8`, which is its plain
    version (:func:`draw_instanced_spheres_rgb8_plain`).

    A CUDA framebuffer with no gradient to carry takes the rays kernel,
    the same binning and raster, and the epilogue kernel
    (``ops.pixel_kernel.flat_composite_rgb8``, the same bits), so that no
    fp32 colour plane is written; a CPU one, or a call where autograd needs
    a gradient, the plain version."""
    if fb.depth.device.type != "cuda" or _needs_grad(centers, radius,
                                                      *camera):
        return draw_instanced_spheres_rgb8_plain(fb, camera, centers, radius,
                                                 flat_color)
    h, w = fb.depth.shape[-2:]
    eye, dirs = pixel_rays(camera, h, w)
    tmin, inst, _, _ = _nearest_hits(camera, eye, dirs, centers, radius)
    with span("render.composite"):
        return pixel_kernel.flat_composite_rgb8(
            tmin, inst, fb.color, fb.depth, camera.view, eye, camera.proj,
            torch.tan(camera.fovy_rad / 2.0), camera.aspect, flat_color)


def draw_instanced_spheres_rgb8_plain(
    fb: Framebuffer, camera: Camera, centers, radius,
    flat_color: Tuple[float, float, float] = (1.0, 0.0, 0.0),
) -> torch.Tensor:
    """:func:`draw_instanced_spheres_rgb8` by :func:`draw_instanced_spheres`
    and :func:`to_rgb8`: its plain version."""
    return to_rgb8(draw_instanced_spheres(fb, camera, centers, radius,
                                          flat_color=flat_color).color)


# ---------------------------------------------------------------------------
# General triangle rasterizer
# ---------------------------------------------------------------------------

class DeviceMesh(NamedTuple):
    """A mesh as device tensors (the vertex/index buffer analog)."""

    positions: torch.Tensor   # [V, 3]
    normals: torch.Tensor     # [V, 3]
    uvs: torch.Tensor         # [V, 2]
    tris: torch.Tensor        # [T, 3] int64
    colors: Optional[torch.Tensor] = None

    @classmethod
    def from_host(cls, mesh, device=None) -> "DeviceMesh":
        """Upload a host mesh (``geometry.Mesh`` or anything with its
        fields as arrays)."""
        def f32(a):
            return torch.tensor(np.asarray(a, np.float32), device=device)

        return cls(
            positions=f32(mesh.positions), normals=f32(mesh.normals),
            uvs=f32(mesh.uvs),
            tris=torch.tensor(np.asarray(mesh.indices, np.int64).reshape(-1, 3),
                              device=device),
            colors=None if mesh.colors is None else f32(mesh.colors))


def _edge(ax, ay, bx, by, cx, cy):
    return (cx - ax) * (by - ay) - (cy - ay) * (bx - ax)


def _tri_setup(tris, sx, sy, wclip, znear):
    """Per-triangle screen-space setup shared by the brute and tiled
    resolvers: vertex screen coords, signed area, and the front-facing and
    in-front-of-near validity mask (back faces are culled)."""
    i0, i1, i2 = tris[..., 0], tris[..., 1], tris[..., 2]
    x0, y0 = sx[i0], sy[i0]
    x1, y1 = sx[i1], sy[i1]
    x2, y2 = sx[i2], sy[i2]
    area = _edge(x0, y0, x1, y1, x2, y2)
    # CCW-in-NDC front faces (the reference's FrontFace::Ccw) come out
    # with positive area under this edge function after the y flip
    front = ((area > 0.0) & (wclip[i0] > znear) & (wclip[i1] > znear)
             & (wclip[i2] > znear))
    return (x0, y0, x1, y1, x2, y2), area, front


def _resolve_brute(depth0, sx, sy, sz, wclip, tris, tvalid, znear, px, py):
    """O(pixels × tris) visibility resolve: scan triangle chunks in order
    against the pixels, keeping per pixel the first strict depth minimum.
    Returns ``(depth [P], win_tri [P] (-1 where nothing won), win_b0,
    win_b1)``; ``win_tri`` numbers the triangles of ``tris``.

    A chunk is tested only against the pixels in the screen bounding box
    of its valid triangles, widened by :data:`_BOX_MARGIN` pixels (the
    JAX resolver tests every pixel): a pixel centre that far outside every
    triangle's box is inside none of them, so the result is the same, and
    a chunk with no valid triangle (all back faces) costs nothing."""
    depth = depth0.clone()
    win_tri = torch.full(depth.shape, -1, dtype=torch.int64, device=px.device)
    win_b0 = torch.zeros(depth.shape, dtype=torch.float32, device=px.device)
    win_b1 = torch.zeros(depth.shape, dtype=torch.float32, device=px.device)
    for c0 in range(0, tris.shape[0], _BRUTE_CHUNK):
        tr = tris[c0:c0 + _BRUTE_CHUNK]
        (x0, y0, x1, y1, x2, y2), area, front = _tri_setup(
            tr, sx, sy, wclip, znear)
        front = front & tvalid[c0:c0 + _BRUTE_CHUNK]
        if not bool(front.any()):
            continue
        xs = torch.stack([x0, x1, x2])[:, front]
        ys = torch.stack([y0, y1, y2])[:, front]
        sel = ((px >= xs.min() - _BOX_MARGIN) & (px <= xs.max() + _BOX_MARGIN)
               & (py >= ys.min() - _BOX_MARGIN)
               & (py <= ys.max() + _BOX_MARGIN)).nonzero()[:, 0]
        if sel.numel() == 0:
            continue
        pxc, pyc = px[sel][:, None], py[sel][:, None]
        inv_area = 1.0 / torch.where(area != 0.0, area, 1.0)
        b0 = _edge(x1[None], y1[None], x2[None], y2[None], pxc, pyc) * inv_area
        b1 = _edge(x2[None], y2[None], x0[None], y0[None], pxc, pyc) * inv_area
        b2 = _edge(x0[None], y0[None], x1[None], y1[None], pxc, pyc) * inv_area
        inside = (b0 >= 0) & (b1 >= 0) & (b2 >= 0) & front[None]
        z = (b0 * sz[tr[:, 0]][None] + b1 * sz[tr[:, 1]][None]
             + b2 * sz[tr[:, 2]][None])
        z = torch.where(inside, z, torch.inf)
        zbest, kbest = torch.min(z, dim=1)             # the first minimum
        better = zbest < depth[sel]
        idx = sel[better]
        k = kbest[better]
        depth[idx] = zbest[better]
        win_tri[idx] = k + c0
        win_b0[idx] = b0[better].gather(1, k[:, None])[:, 0]
        win_b1[idx] = b1[better].gather(1, k[:, None])[:, 0]
    return depth, win_tri, win_b0, win_b1


# Triangles a chunk of the brute resolver; pixels beyond a chunk's screen
# bounding box that it still tests, against rounding in the edge functions.
_BRUTE_CHUNK = 256
_BOX_MARGIN = 2.0

# Screen tile side of the tiled resolver.
_TILE = 16


def _pixel_centers(h: int, w: int, device):
    """Pixel-centre x and y of an h × w frame, row-major, flattened."""
    px = (torch.arange(w, dtype=torch.float32, device=device) + 0.5)
    py = (torch.arange(h, dtype=torch.float32, device=device) + 0.5)
    return px[None, :].expand(h, w).reshape(-1), py[:, None].expand(h, w).reshape(-1)


def _resolve_tiled(depth0, sx, sy, sz, wclip, tris, znear, h, w,
                   window: int, cand_chunk: int, big_capacity: int):
    """Tile-binned visibility resolve, O(pixels × tris-per-tile).

    Each small triangle emits its ≤2×2 block of :data:`_TILE`-square
    screen tiles as (tile_id, tri) pairs; the pairs are sorted stably by tile id
    and answered as contiguous windows of at most ``window`` candidates.
    Triangles whose bounding box spans more than 2 tiles on an axis are
    compacted into a list of at most ``big_capacity`` and resolved by the
    brute scan over all pixels.

    Returns ``(depth [P], win_tri, win_b0, win_b1, dropped)``, ``dropped``
    counting candidates lost to the ``window``/``big_capacity`` truncation
    (0 in a correctly sized render). The JAX resolver walks a static
    ``ceil(window / cand_chunk)`` steps and brute-scans all
    ``big_capacity`` slots; here the walk stops after the longest window
    and the scan covers the big triangles there are, since the steps and
    slots past them hold no candidate and change nothing.
    """
    dev = sx.device
    t = tris.shape[0]
    tile = _TILE
    ntx = -(-w // tile)
    nty = -(-h // tile)
    n_tiles = ntx * nty
    tpx = tile * tile
    hp, wp = nty * tile, ntx * tile      # padded screen

    (x0, y0, x1, y1, x2, y2), _, ok = _tri_setup(tris, sx, sy, wclip, znear)
    xmin = torch.minimum(x0, torch.minimum(x1, x2))
    xmax = torch.maximum(x0, torch.maximum(x1, x2))
    ymin = torch.minimum(y0, torch.minimum(y1, y2))
    ymax = torch.maximum(y0, torch.maximum(y1, y2))
    ok = ok & (xmax >= 0) & (xmin < w) & (ymax >= 0) & (ymin < h)

    def tile_of(v, n):
        return torch.clamp(torch.floor(v / tile).to(torch.int64), 0, n - 1)

    tx0, tx1 = tile_of(xmin, ntx), tile_of(xmax, ntx)
    ty0, ty1 = tile_of(ymin, nty), tile_of(ymax, nty)
    big = ok & ((tx1 - tx0 > 1) | (ty1 - ty0 > 1))
    small = ok & ~big

    # --- bin small tris: 4 emissions (2x2 tile block), sort by tile id ---
    tids = []
    for dy in (0, 1):
        for dx in (0, 1):
            tx = tx0 + dx
            ty = ty0 + dy
            valid = small & (tx <= tx1) & (ty <= ty1)
            tids.append(torch.where(valid, ty * ntx + tx, n_tiles))
    pair_tid = torch.cat(tids)                             # [4T]
    pair_tri = torch.arange(t, device=dev).repeat(4)
    order = torch.argsort(pair_tid, stable=True)
    sorted_tid = pair_tid[order]
    sorted_tri = pair_tri[order]
    tile_start = torch.searchsorted(
        sorted_tid, torch.arange(n_tiles + 1, device=dev), side="left")
    counts = tile_start[1:] - tile_start[:-1]
    dropped = int(torch.clamp_min(counts - window, 0).sum())

    # --- tile-major pixel layout: [H, W] <-> [n_tiles, tile*tile] ---
    def to_tiles(a):
        return (a.reshape(nty, tile, ntx, tile).permute(0, 2, 1, 3)
                .reshape(n_tiles, tpx))

    def from_tiles(a):
        return (a.reshape(nty, ntx, tile, tile).permute(0, 2, 1, 3)
                .reshape(hp, wp)[:h, :w])

    pxg, pyg = _pixel_centers(hp, wp, dev)
    px_t = to_tiles(pxg)[:, :, None]
    py_t = to_tiles(pyg)[:, :, None]
    d0 = torch.full((hp, wp), torch.inf, dtype=torch.float32, device=dev)
    d0[:h, :w] = depth0.reshape(h, w)
    depth = to_tiles(d0)
    win_tri = torch.full((n_tiles, tpx), -1, dtype=torch.int64, device=dev)
    win_b0 = torch.zeros((n_tiles, tpx), dtype=torch.float32, device=dev)
    win_b1 = torch.zeros((n_tiles, tpx), dtype=torch.float32, device=dev)

    k_idx = torch.arange(cand_chunk, device=dev)
    start = tile_start[:-1]
    end = tile_start[1:]
    longest = min(window, int(counts.max())) if n_tiles else 0
    n_pairs = sorted_tri.shape[0]
    for s in range(-(-longest // cand_chunk)):
        slot = start[:, None] + s * cand_chunk + k_idx[None, :]   # [NT, C]
        valid = slot < end[:, None]
        tri_idx = sorted_tri[torch.clamp(slot, 0, n_pairs - 1)]    # [NT, C]
        tr = tris[tri_idx]                                         # [NT, C, 3]
        (cx0, cy0, cx1, cy1, cx2, cy2), careas, _ = _tri_setup(
            tr, sx, sy, wclip, znear)
        inv_area = (1.0 / torch.where(careas != 0.0, careas, 1.0))[:, None, :]
        # [NT, tpx, C] edge evals against this tile's pixels only
        e = [(cx1, cy1, cx2, cy2), (cx2, cy2, cx0, cy0), (cx0, cy0, cx1, cy1)]
        b0, b1, b2 = (_edge(ax[:, None], ay[:, None], bx[:, None],
                            by[:, None], px_t, py_t) * inv_area
                      for ax, ay, bx, by in e)
        inside = (b0 >= 0) & (b1 >= 0) & (b2 >= 0) & valid[:, None, :]
        z = (b0 * sz[tr[..., 0]][:, None] + b1 * sz[tr[..., 1]][:, None]
             + b2 * sz[tr[..., 2]][:, None])
        z = torch.where(inside, z, torch.inf)
        zbest, kbest = torch.min(z, dim=2)                        # [NT, tpx]
        better = zbest < depth
        depth = torch.where(better, zbest, depth)
        win_tri = torch.where(better, torch.gather(tri_idx, 1, kbest),
                              win_tri)
        k = kbest[..., None]
        win_b0 = torch.where(better, torch.gather(b0, 2, k)[..., 0], win_b0)
        win_b1 = torch.where(better, torch.gather(b1, 2, k)[..., 0], win_b1)
    depth = from_tiles(depth).reshape(-1)
    win_tri = from_tiles(win_tri).reshape(-1)
    win_b0 = from_tiles(win_b0).reshape(-1)
    win_b1 = from_tiles(win_b1).reshape(-1)

    # --- big-triangle residue through the brute scan (compacted) ---
    n_big = int(big.sum())
    dropped += max(n_big - big_capacity, 0)
    n_keep = min(n_big, big_capacity)
    if n_keep:
        big_idx = torch.argsort((~big).to(torch.int8), stable=True)[:n_keep]
        px1, py1 = _pixel_centers(h, w, dev)
        # the brute pass numbers the gathered subset by position in big_idx
        d2, wt2, b02, b12 = _resolve_brute(
            depth, sx, sy, sz, wclip, tris[big_idx], big[big_idx], znear,
            px1, py1)
        taken = (wt2 >= 0) & (d2 < depth)
        depth = torch.where(taken, d2, depth)
        win_tri = torch.where(taken, big_idx[torch.clamp(wt2, 0, n_keep - 1)],
                              win_tri)
        win_b0 = torch.where(taken, b02, win_b0)
        win_b1 = torch.where(taken, b12, win_b1)
    return depth, win_tri, win_b0, win_b1, dropped


# Auto-switch to the tiled resolver above this triangle count (the brute
# path is O(pixels × tris)).
_BINNED_TRI_THRESHOLD = 20_000


def draw_mesh(fb: Framebuffer, camera: Camera, mesh: DeviceMesh,
              texture: Optional[torch.Tensor] = None,
              light: Optional[cfg.LightConfig] = None,
              mode: str = "phong",
              binned: Optional[bool] = None,
              window: int = 4096,
              cand_chunk: int = 256,
              big_capacity: int = 2048,
              return_stats: bool = False):
    """Z-buffered triangle rasterization with perspective-correct attribute
    interpolation — the reference render pipeline state (depth Less,
    back-face culling, CCW front faces; cloth.rs:749-770). One
    framebuffer, no batch.

    ``mode``: 'phong' (the globe), 'diffuse' (the textured cube), 'color'
    (the flat vertex-colored cube), 'texture' (unlit).

    ``binned`` picks the tile-binned resolver (None = auto from
    :data:`_BINNED_TRI_THRESHOLD` triangles): work drops from O(pixels ×
    tris) to O(pixels × tris-per-tile). ``window`` bounds candidate tris
    per screen tile; ``return_stats=True`` also returns the
    dropped-candidate count (nonzero = undersized ``window`` or
    ``big_capacity``, geometry lost), an int.
    """
    h, w = fb.depth.shape
    vview = _affine_rows(camera.view, mesh.positions)
    clip = _affine_rows(camera.proj, vview)
    wclip = -vview[:, 2]                              # proj[3] = (0,0,-1,0)
    ndc = clip / wclip[:, None]
    sx = (ndc[:, 0] + 1.0) * 0.5 * w
    sy = (1.0 - ndc[:, 1]) * 0.5 * h
    sz = ndc[:, 2]
    inv_w = 1.0 / wclip
    nview = _linear_rows(camera.view, mesh.normals)

    tris = mesh.tris
    t = tris.shape[0]
    if binned is None:
        binned = t >= _BINNED_TRI_THRESHOLD

    dropped = 0
    if binned:
        depth, win_tri, win_b0, win_b1, dropped = _resolve_tiled(
            fb.depth.reshape(-1), sx, sy, sz, wclip, tris, camera.znear,
            h, w, window, cand_chunk, big_capacity)
    else:
        px, py = _pixel_centers(h, w, sx.device)
        tvalid = torch.ones((t,), dtype=torch.bool, device=sx.device)
        depth, win_tri, win_b0, win_b1 = _resolve_brute(
            fb.depth.reshape(-1), sx, sy, sz, wclip, tris, tvalid,
            camera.znear, px, py)

    hit = win_tri >= 0
    tr = tris[torch.where(hit, win_tri, 0)]                  # [P, 3]
    b0, b1 = win_b0, win_b1
    b2 = 1.0 - b0 - b1
    w0 = (b0 * inv_w[tr[:, 0]])[:, None]
    w1 = (b1 * inv_w[tr[:, 1]])[:, None]
    w2 = (b2 * inv_w[tr[:, 2]])[:, None]
    denom = w0 + w1 + w2
    denom = torch.where(denom != 0, denom, 1.0)

    def interp(attr):
        return ((attr[tr[:, 0]] * w0 + attr[tr[:, 1]] * w1
                 + attr[tr[:, 2]] * w2) / denom)

    hitg = hit.reshape(h, w)
    if mode == "color":
        color = interp(mesh.colors).reshape(h, w, 3)
    else:
        if texture is not None:
            uv = interp(mesh.uvs)
            albedo = tex_mod.sample(texture, uv[:, 0].reshape(h, w),
                                    uv[:, 1].reshape(h, w))
        else:
            albedo = torch.ones((h, w, 3), dtype=torch.float32,
                                device=sx.device)
        if mode == "texture":
            color = albedo
        else:
            pv = interp(vview).T.reshape(3, h, w)
            nv = interp(nview).T.reshape(3, h, w)
            shade = shading.diffuse_only if mode == "diffuse" else shading.phong
            color = shade(pv, nv, albedo, _light_view(camera, light), light)

    out = Framebuffer(
        color=torch.where(hitg[..., None], color, fb.color),
        depth=torch.where(hitg, depth.reshape(h, w), fb.depth))
    if return_stats:
        return out, dropped
    return out


def _linear_rows(m: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``v @ m[..., :3, :3].T`` for ``v`` [..., L, 3], written out; a
    leading [B] on ``m`` maps each world's rows with its own matrix."""
    return torch.stack([v[..., 0] * m[..., i, 0, None]
                        + v[..., 1] * m[..., i, 1, None]
                        + v[..., 2] * m[..., i, 2, None] for i in range(3)],
                       dim=-1)


def _affine_rows(m: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``v @ m[..., :3, :3].T + m[..., :3, 3]`` for ``v`` [..., L, 3],
    written out."""
    return _linear_rows(m, v) + m[..., None, :3, 3]


def draw_lines(fb: Framebuffer, camera: Camera, segments,
               color=(0.0, 0.0, 1.0), px_width: float = 1.0) -> Framebuffer:
    """Line-list pass (the wireframe bounds box, the reference's
    wireframe_shader). ``segments``: [L, 2, 3] world-space endpoints (a
    tensor or an array). Screen-space distance test per pixel, depth-tested
    against the interpolated segment depth. A batch of framebuffers
    ([B, H, W]) takes a batched camera and draws each world with its own,
    every op elementwise, so world i equals the single-camera pass bit for
    bit."""
    h, w = fb.depth.shape[-2:]
    dev = fb.depth.device
    seg = torch.as_tensor(segments, dtype=torch.float32, device=dev)
    view = camera.view.to(dev)
    proj = camera.proj.to(dev)

    def project(v):
        vv = _affine_rows(view, v)
        wc = -vv[..., 2]
        ndc = _affine_rows(proj, vv) / wc[..., None]
        return (torch.stack([(ndc[..., 0] + 1) * 0.5 * w,
                             (1 - ndc[..., 1]) * 0.5 * h], -1), ndc[..., 2],
                wc)

    pa, za, wa = project(seg[:, 0, :])                 # [..., L, 2], [..., L]
    pb, zb, wb = project(seg[:, 1, :])
    znear = camera.znear.to(dev)[..., None]
    ok = (wa > znear) & (wb > znear)

    px = (torch.arange(w, dtype=torch.float32, device=dev) + 0.5)[None, :, None]
    py = (torch.arange(h, dtype=torch.float32, device=dev) + 0.5)[:, None, None]
    ab = (pb - pa)[..., None, None, :, :]              # [..., 1, 1, L, 2]
    pa = pa[..., None, None, :, :]
    ap_x = px - pa[..., 0]
    ap_y = py - pa[..., 1]
    ab2 = ab[..., 0] * ab[..., 0] + ab[..., 1] * ab[..., 1]
    s = ((ap_x * ab[..., 0] + ap_y * ab[..., 1])
         / torch.clamp_min(ab2, 1e-12))
    s = torch.clamp(s, 0.0, 1.0)
    dx = ap_x - s * ab[..., 0]
    dy = ap_y - s * ab[..., 1]
    dist2 = dx * dx + dy * dy
    on_line = (dist2 <= (0.5 + px_width / 2) ** 2) & ok[..., None, None, :]
    z = za[..., None, None, :] + s * (zb - za)[..., None, None, :]
    z = torch.where(on_line, z, torch.inf)
    zmin = torch.amin(z, dim=-1)
    win = (zmin < fb.depth) & torch.isfinite(zmin)
    c = torch.as_tensor(color, dtype=torch.float32, device=dev)
    return Framebuffer(color=torch.where(win[..., None], c, fb.color),
                       depth=torch.where(win, zmin, fb.depth))
