"""Textures: file loading (PIL), procedural fallbacks and bilinear sampling
(the counterpart of ``wgpu_physics_engine_tpu/render/texture.py``).

A texture is an fp32 ``[Th, Tw, 3]`` tensor in [0, 1], or the packed RGB8
format of :func:`pack_rgb8` (one int32 ``[Th, Tw]`` plane); sampling is
bilinear with wrap addressing (the wgpu sampler default used by the
reference apps).
"""

from __future__ import annotations

import math
import os

import numpy as np
import torch

_F32 = torch.float32


def load_texture(path: str, device=None) -> torch.Tensor:
    """Load an image file (jpg/png/bmp via PIL) → fp32 [H, W, 3]."""
    from PIL import Image

    img = Image.open(path).convert("RGB")
    arr = np.asarray(img, np.float32) / 255.0
    return torch.tensor(arr, device=device)


# reference asset name → committed package asset (original art; the
# reference's binaries themselves are not shipped)
_ASSET_MAP = {
    "earth2048": "planet_equirect.png", "moon1024": "planet_equirect.png",
    "earth": "planet_equirect.png", "moon": "planet_equirect.png",
    "planet": "planet_equirect.png",
    "mesh": "grid.png", "texture": "grid.png", "diffuse": "grid.png",
    "grid": "grid.png",
}


def _downsample(tex: torch.Tensor, max_size: int) -> torch.Tensor:
    """Box-filter a texture down by powers of 2 until both dims fit
    ``max_size`` (a mip level)."""
    while max(tex.shape[0], tex.shape[1]) > max_size:
        h2, w2 = tex.shape[0] // 2, tex.shape[1] // 2
        tex = tex[: 2 * h2, : 2 * w2].reshape(h2, 2, w2, 2, 3).mean((1, 3))
    return tex


def get(name_or_path: str, size: int = 256, device=None,
        max_size: int | None = None) -> torch.Tensor:
    """Resolve a texture by file path or by the reference's asset names
    (``textures/``: grey/red/texture/mesh/diffuse/moon1024/earth2048).
    Known names load the package assets (``assets/``); anything else falls
    back to a procedural equivalent.

    ``max_size``: if set, file-loaded textures are box-downsampled to fit
    (a mip level); datagen renders 256² frames from the 256 mip."""
    if os.path.exists(name_or_path):
        tex = load_texture(name_or_path, device)
        return _downsample(tex, max_size) if max_size else tex
    key = os.path.splitext(os.path.basename(name_or_path))[0].lower()
    asset = _ASSET_MAP.get(key)
    if asset is not None:
        path = os.path.join(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))), "assets", asset)
        if os.path.exists(path):
            tex = load_texture(path, device)
            return _downsample(tex, max_size) if max_size else tex
    if key in ("red",):
        return solid((1.0, 0.0, 0.0), device=device)
    if key in ("grey", "gray"):
        return solid((0.5, 0.5, 0.5), device=device)
    if key in ("mesh", "texture", "diffuse", "grid"):
        return checkerboard(size=size, device=device)
    if key in ("earth2048", "moon1024", "earth", "moon", "planet"):
        return earth_gradient(size, device=device)
    raise FileNotFoundError(
        f"texture '{name_or_path}' not found and no procedural equivalent")


def solid(color, size: int = 4, device=None) -> torch.Tensor:
    """Solid-color texture (the cloth particles' ``red.png`` equivalent)."""
    c = torch.as_tensor(color, dtype=_F32, device=device)
    return c.expand(size, size, 3).contiguous()


def checkerboard(n: int = 8, size: int = 256, c0=(0.85, 0.85, 0.85),
                 c1=(0.25, 0.25, 0.3), device=None) -> torch.Tensor:
    """Procedural checker (stand-in for ``mesh.jpg``'s grid pattern)."""
    i = torch.arange(size, device=device) * n // size
    mask = ((i[:, None] + i[None, :]) % 2).to(_F32)[..., None]
    return (mask * torch.as_tensor(c1, dtype=_F32, device=device)
            + (1 - mask) * torch.as_tensor(c0, dtype=_F32, device=device))


def earth_gradient(size: int = 256, device=None) -> torch.Tensor:
    """Procedural blue-green planet gradient (earth2048.bmp stand-in)."""
    v = torch.linspace(0.0, 1.0, size, device=device)[:, None, None]
    u = torch.linspace(0.0, 1.0, size, device=device)[None, :, None]
    land = 0.5 + 0.5 * torch.sin(12.0 * u * math.pi) * torch.sin(8.0 * v * math.pi)
    one = torch.ones_like(land)
    ocean = torch.cat([0.1 * one, 0.3 + 0.2 * v * one, 0.7 * one], -1)
    ground = torch.cat([0.2 + 0.3 * land, 0.5 + 0.2 * land, 0.2 * one], -1)
    sel = (land > 0.75).to(_F32)
    return sel * ground + (1 - sel) * ocean


def sample_bilinear(tex: torch.Tensor, u: torch.Tensor,
                    v: torch.Tensor) -> torch.Tensor:
    """Bilinear texture sample with wrap addressing.

    ``u``/``v``: tensors of any shape; returns ``[..., 3]``. v=0 maps to
    texture row 0 (images are uploaded without a flip, as the reference
    does).
    """
    th, tw = tex.shape[0], tex.shape[1]
    x = u * tw - 0.5
    y = v * th - 0.5
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = x - x0
    fy = y - y0
    x0i = torch.remainder(x0.to(torch.int64), tw)
    x1i = torch.remainder(x0i + 1, tw)
    y0i = torch.remainder(y0.to(torch.int64), th)
    y1i = torch.remainder(y0i + 1, th)
    chans = []
    for ch in range(tex.shape[2]):
        p = tex[:, :, ch]
        top = p[y0i, x0i] * (1 - fx) + p[y0i, x1i] * fx
        bot = p[y1i, x0i] * (1 - fx) + p[y1i, x1i] * fx
        chans.append(top * (1 - fy) + bot * fy)
    return torch.stack(chans, dim=-1)


def pack_rgb8(tex: torch.Tensor) -> torch.Tensor:
    """Quantize an fp32 [H, W, 3] texture to 8 bits a channel and pack it
    into one int32 [H, W] plane (0x00RRGGBB).

    The JAX package packs into uint32; torch has no full uint32
    arithmetic, and 24 bits fit an int32 with the sign bit clear, so the
    shifts and masks of :func:`sample_bilinear_packed` give the same
    channels. A bilinear sample then gathers one value per tap instead of
    three, from a table a third the size. The 8-bit quantization is
    lossless for file-loaded assets (8-bit sources)."""
    q = torch.clamp(tex * 255.0 + 0.5, 0.0, 255.0).to(torch.int32)
    return (q[..., 0] << 16) | (q[..., 1] << 8) | q[..., 2]


def sample_bilinear_packed(packed: torch.Tensor, u: torch.Tensor,
                           v: torch.Tensor) -> torch.Tensor:
    """Bilinear sample from a :func:`pack_rgb8` texture: the wrap
    addressing and lerp order of :func:`sample_bilinear`, one gather per
    tap. Equals the unpacked sampler on 8-bit-quantized inputs up to the
    k*(1/255) vs k/255 rounding of the unpack (<= 1e-7)."""
    th, tw = packed.shape
    x = u * tw - 0.5
    y = v * th - 0.5
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = x - x0
    fy = y - y0
    x0i = torch.remainder(x0.to(torch.int64), tw)
    x1i = torch.remainder(x0i + 1, tw)
    y0i = torch.remainder(y0.to(torch.int64), th)
    y1i = torch.remainder(y0i + 1, th)
    t00 = packed[y0i, x0i]
    t01 = packed[y0i, x1i]
    t10 = packed[y1i, x0i]
    t11 = packed[y1i, x1i]
    inv = torch.tensor(1.0 / 255.0, dtype=_F32, device=packed.device)
    chans = []
    for shift in (16, 8, 0):
        c00 = ((t00 >> shift) & 0xFF).to(_F32) * inv
        c01 = ((t01 >> shift) & 0xFF).to(_F32) * inv
        c10 = ((t10 >> shift) & 0xFF).to(_F32) * inv
        c11 = ((t11 >> shift) & 0xFF).to(_F32) * inv
        top = c00 * (1 - fx) + c01 * fx
        bot = c10 * (1 - fx) + c11 * fx
        chans.append(top * (1 - fy) + bot * fy)
    return torch.stack(chans, dim=-1)


def sample(tex: torch.Tensor, u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Format-dispatching bilinear sample: a packed int32 [H, W] plane
    (:func:`pack_rgb8`) or an fp32 [H, W, 3] texture."""
    if tex.ndim == 2:
        return sample_bilinear_packed(tex, u, v)
    if tex.ndim != 3:
        raise ValueError(f"expected an [H, W, 3] texture or a packed [H, W] "
                         f"plane, got {tuple(tex.shape)}")
    return sample_bilinear(tex, u, v)
