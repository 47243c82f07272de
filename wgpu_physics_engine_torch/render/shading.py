"""View-space Phong shading, matching the reference fragment shader
(``5_cloth_simulation/globe_shader.wgsl:89-121``); the counterpart of
``wgpu_physics_engine_tpu/render/shading.py``.

* ``n`` = normalized view-space normal, ``l`` = direction to the light (the
  light position transformed by the view matrix), ``v`` = direction to the
  camera (−position), ``r = reflect(−l, n)``.
* diffuse = tex.rgb · clamp(n·l, ambient=0.1, 1) · luminosity=2.4
* specular (toggleable) = ks · max(r·v, 0)^shininess · white
* diffuse only (the textured cube, cube_textured_shader.wgsl:59-76):
  tex.rgb · clamp(n·l, 0.1, 1) · luminosity

Inputs are channels-first ``[3, H, W]`` view-space tensors, or ``[B, 3, H,
W]`` for a batch of worlds.
"""

from __future__ import annotations

import torch

from ..core import config as cfg


def _normalize(v: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    s = torch.sum(v * v, dim=-3, keepdim=True)
    if s.requires_grad:
        # the same bits (sqrt(0) = 0), but the sqrt never sees 0 on the
        # backward pass: d sqrt/dx at 0 is inf, and inf times the 0
        # cotangent of a masked pixel is NaN (JAX's shading._normalize)
        pos = s > 0
        n = torch.where(pos, torch.sqrt(torch.where(pos, s, 1.0)), 0.0)
    else:
        n = torch.sqrt(s)
    return v / torch.clamp_min(n, eps)


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.sum(a * b, dim=-3)


def phong(pos_view: torch.Tensor, normal_view: torch.Tensor,
          albedo: torch.Tensor, light_pos_view: torch.Tensor,
          light: cfg.LightConfig, compute_specular=None) -> torch.Tensor:
    """Shade pixels. ``pos_view``/``normal_view``: [3, H, W]; ``albedo``:
    [H, W, 3]; ``light_pos_view``: [3]. Returns [H, W, 3]. A batch of
    worlds adds a leading ``[B]`` axis to every argument and the result."""
    n = _normalize(normal_view)
    l = _normalize(light_pos_view[..., :, None, None] - pos_view)
    v = _normalize(-pos_view)

    shading = torch.clamp(_dot(n, l), light.ambient, 1.0)
    diffuse = albedo * (shading * light.luminosity)[..., None]

    if compute_specular is None:
        compute_specular = light.compute_specular
    # reflect(-l, n) = -l - 2*dot(n, -l)*n = 2*dot(n,l)*n - l
    r = _normalize(2.0 * _dot(n, l)[..., None, :, :] * n - l)
    r_dot_v = torch.clamp_min(_dot(r, v), 0.0)
    spec = (light.ks * torch.pow(r_dot_v, light.shininess))[..., None]
    spec_on = 1.0 if compute_specular else 0.0
    return diffuse + spec_on * spec


def diffuse_only(pos_view: torch.Tensor, normal_view: torch.Tensor,
                 albedo: torch.Tensor, light_pos_view: torch.Tensor,
                 light: cfg.LightConfig) -> torch.Tensor:
    """The textured cube's clamped-diffuse shading (no specular); the
    arguments and result of :func:`phong`."""
    n = _normalize(normal_view)
    l = _normalize(light_pos_view[..., :, None, None] - pos_view)
    shading = torch.clamp(_dot(n, l), light.ambient, 1.0)
    return albedo * (shading * light.luminosity)[..., None]
