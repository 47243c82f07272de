"""Plain PyTorch reference of the datagen frame's render: a frozen copy of
the engine's analytic renderer (the orbit camera of wgpu-bootstrap, the lit
and textured globe of globe_shader.wgsl, the red cloth instances of
cloth_instances.wgsl, the depth test Less), for a batch of worlds.

Each pixel casts one ray; the globe's colour and depth come from its
ray-sphere hit, Phong shading and a bilinear sample of the grid texture,
and every cloth particle is a sphere tested against every ray by brute
force (no binning, no tiles). The image is the uint8 cast
``(clamp(colour, 0, 1) * 255 + 0.5)``. It reads the texture from the
engine's PNG asset and imports nothing of the program.

Computed in ``dtype`` (float32 as configured; bfloat16 for the control).
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch

F32 = torch.float32
# pixels x spheres a block of the brute-force sweep
_SWEEP_ELEMS = 1 << 26


def load_texture(path: str, max_size: int, device) -> torch.Tensor:
    """The PNG at ``path`` as float32 ``[H, W, 3]`` in [0, 1], box-filtered
    down by powers of two until it fits ``max_size``, then quantized to 8
    bits a channel (``floor(clamp(t * 255 + 0.5, 0, 255))``) and returned
    as the integer channel values ``[H, W, 3]`` (int32)."""
    from PIL import Image

    arr = np.asarray(Image.open(path).convert("RGB"), np.float32) / 255.0
    tex = torch.tensor(arr, device=device)
    while max(tex.shape[0], tex.shape[1]) > max_size:
        h2, w2 = tex.shape[0] // 2, tex.shape[1] // 2
        tex = tex[:2 * h2, :2 * w2].reshape(h2, 2, w2, 2, 3).mean((1, 3))
    return torch.clamp(tex * 255.0 + 0.5, 0.0, 255.0).to(torch.int32)


def cameras(theta, phi, radius, cam: Dict):
    """Orbit cameras for ``[B]`` azimuth, elevation and distance, built in
    float32 on the CPU: ``(rot [B, 3, 3], trans [B, 3], eye [B, 3])`` of
    the right-handed look-at at ``cam["target"]`` (+y up)."""
    f32 = F32
    t = lambda v: torch.as_tensor(v, dtype=f32, device="cpu")  # noqa: E731
    target, radius, theta, phi = (t(cam["target"]), t(radius), t(theta),
                                  t(phi))
    eye = target + torch.stack([radius * torch.cos(phi) * torch.sin(theta),
                                radius * torch.sin(phi),
                                radius * torch.cos(phi) * torch.cos(theta)],
                               dim=-1)
    up = t((0.0, 1.0, 0.0))
    f = target - eye
    f = f / torch.linalg.norm(f, dim=-1, keepdim=True)
    s = torch.linalg.cross(f, up.expand_as(f))
    s = s / torch.linalg.norm(s, dim=-1, keepdim=True)
    u = torch.linalg.cross(s, f)
    rot = torch.stack([s, u, -f], dim=-2)
    trans = -(rot @ eye[..., None])[..., 0]
    return rot, trans, eye


def _proj(cam: Dict):
    """Perspective entries (wgpu depth in [0, 1]) as float32 0-d tensors
    built on the CPU: ``(fovy, m22, m23)``."""
    f32 = F32
    fovy = torch.tensor(cam["fovy_deg"] * math.pi / 180.0, dtype=f32)
    zn = torch.tensor(cam["znear"], dtype=f32)
    zf = torch.tensor(cam["zfar"], dtype=f32)
    return fovy, zf / (zn - zf), zf * zn / (zn - zf)


def pixel_rays(rot, eye, tan_half, aspect: float, h: int, w: int):
    """Unit world-space rays through pixel centres, ``[B, 3, H, W]``; row
    0 is the top of the image."""
    dev = eye.device
    dt = eye.dtype
    j = (torch.arange(w, dtype=F32, device=dev) + 0.5) / w * 2.0 - 1.0
    i = 1.0 - (torch.arange(h, dtype=F32, device=dev) + 0.5) / h * 2.0
    j, i = j.to(dt), i.to(dt)
    b = eye.shape[0]
    th = tan_half.reshape(-1, 1, 1)
    asp = torch.tensor(aspect, dtype=F32, device=dev).to(dt)
    vx = (j[None, :] * th * asp).expand(b, h, w)
    vy = (i[:, None] * th).expand(b, h, w)
    vz = torch.full((h, w), -1.0, dtype=dt, device=dev)
    r = rot[..., None, None]
    d = torch.stack([r[..., 0, k, :, :] * vx + r[..., 1, k, :, :] * vy
                     + r[..., 2, k, :, :] * vz for k in range(3)], dim=-3)
    norm = torch.sqrt(torch.sum(d * d, dim=-3, keepdim=True))
    return d / norm


def _rotate(rot, v):
    r = rot[..., None, None]
    return torch.stack([r[..., i, 0, :, :] * v[..., 0, :, :]
                        + r[..., i, 1, :, :] * v[..., 1, :, :]
                        + r[..., i, 2, :, :] * v[..., 2, :, :]
                        for i in range(3)], dim=-3)


def _normalize(v):
    s = torch.sum(v * v, dim=-3, keepdim=True)
    return v / torch.clamp_min(torch.sqrt(s), 1e-12)


def _dot(a, b):
    return torch.sum(a * b, dim=-3)


def _sample(tex_int, u, v, dtype):
    """Bilinear, wrap-addressed sample of the 8-bit texture; ``[..., 3]``."""
    th, tw = tex_int.shape[:2]
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
    inv = torch.tensor(1.0 / 255.0, dtype=F32, device=u.device).to(dtype)
    chans = []
    for ch in range(3):
        p = tex_int[:, :, ch]
        c00 = p[y0i, x0i].to(dtype) * inv
        c01 = p[y0i, x1i].to(dtype) * inv
        c10 = p[y1i, x0i].to(dtype) * inv
        c11 = p[y1i, x1i].to(dtype) * inv
        top = c00 * (1 - fx) + c01 * fx
        bot = c10 * (1 - fx) + c11 * fx
        chans.append(top * (1 - fy) + bot * fy)
    return torch.stack(chans, dim=-1)


def _ndc_z(view_z, m22, m23):
    return (m22 * view_z + m23) / (-view_z)


def globe(rot, trans, eye, dirs, radius, tex_int, light: Dict, cam: Dict,
          dtype):
    """Colour ``[B, H, W, 3]`` and depth ``[B, H, W]`` of the clear colour
    with the lit, textured globe of ``radius`` at the origin."""
    _, m22, m23 = (a.to(eye.device).to(dtype) for a in _proj(cam))
    b, _, h, w = dirs.shape
    dev = eye.device
    color = torch.tensor(light["clear_color"], dtype=F32, device=dev).to(
        dtype).expand(b, h, w, 3)
    depth = torch.ones((b, h, w), dtype=dtype, device=dev)
    r = torch.as_tensor(radius, dtype=F32, device=dev).to(dtype)
    oc = -eye
    pl = lambda a: a[..., None, None]  # noqa: E731
    bb = (pl(oc[..., 0]) * dirs[:, 0] + pl(oc[..., 1]) * dirs[:, 1]
          + pl(oc[..., 2]) * dirs[:, 2])
    cc = torch.sum(oc * oc, dim=-1)
    disc = bb * bb - pl(cc - r * r)
    hit = disc > 0.0
    t = bb - torch.sqrt(torch.clamp_min(disc, 0.0))
    znear = torch.tensor(cam["znear"], dtype=F32, device=dev).to(dtype)
    hit = hit & (t > znear)
    p_world = eye[..., :, None, None] + t[:, None] * dirs
    rel = p_world
    n_world = rel / pl(r)[..., None, :, :]
    p_view = _rotate(rot, p_world - eye[..., :, None, None])
    n_view = _rotate(rot, n_world)

    x, y, z = rel.unbind(-3)
    z_over_r = torch.clamp(z / pl(r), -1.0, 1.0)
    interior = torch.abs(z_over_r) < 1.0
    asv = torch.asin(torch.where(interior, z_over_r, 0.0))
    v = torch.where(interior, (math.pi / 2.0 - asv) / math.pi,
                    torch.where(z_over_r > 0, 0.0, 1.0))
    off = (x * x + y * y) > 0
    theta = torch.atan2(torch.where(off, y, 0.0), torch.where(off, x, 1.0))
    u = torch.remainder(theta / (2.0 * math.pi), 1.0)
    albedo = _sample(tex_int, u, v, dtype)

    lp = torch.tensor(light["position"], dtype=F32, device=dev).to(dtype)
    light_view = rot @ lp + trans
    n = _normalize(n_view)
    l_dir = _normalize(light_view[..., :, None, None] - p_view)
    v_dir = _normalize(-p_view)
    shade = torch.clamp(_dot(n, l_dir), light["ambient"], 1.0)
    diffuse = albedo * (shade * light["luminosity"])[..., None]
    refl = _normalize(2.0 * _dot(n, l_dir)[..., None, :, :] * n - l_dir)
    r_dot_v = torch.clamp_min(_dot(refl, v_dir), 0.0)
    spec = (light["ks"] * torch.pow(r_dot_v, light["shininess"]))[..., None]
    col = diffuse + 1.0 * spec
    zn = _ndc_z(torch.where(hit, p_view[:, 2], -1.0), m22, m23)
    win = hit & (zn < depth)
    return (torch.where(win[..., None], col, color),
            torch.where(win, zn, depth))


def nearest_sphere(eye, dirs, centers, radius, znear):
    """Nearest hit distance ``[B, H, W]`` (+inf on a miss) of every ray
    against every sphere of ``centers`` ``[B, N, 3]``, by brute force."""
    b, _, h, w = dirs.shape
    p = h * w
    oc = centers - eye[:, None, :]
    ox, oy, oz = oc.unbind(-1)
    cc = ox * ox + oy * oy + oz * oz - radius * radius
    out = []
    for i in range(b):
        d = dirs[i].reshape(3, p)
        dx, dy, dz = d[0][:, None], d[1][:, None], d[2][:, None]
        tmin = torch.full((p,), float("inf"), dtype=dirs.dtype,
                          device=dirs.device)
        n = oc.shape[1]
        step = max(1, _SWEEP_ELEMS // p)
        for k0 in range(0, n, step):
            bb = (dx * ox[i, k0:k0 + step] + dy * oy[i, k0:k0 + step]
                  + dz * oz[i, k0:k0 + step])
            disc = bb * bb - cc[i, k0:k0 + step]
            t = bb - torch.sqrt(torch.clamp_min(disc, 0.0))
            t = torch.where((disc > 0.0) & (t > znear), t, float("inf"))
            tmin = torch.minimum(tmin, t.min(dim=1).values)
        out.append(tmin.reshape(h, w))
    return torch.stack(out)


def frame(positions, theta, phi, radius, cfg: Dict, tex_int,
          dtype=torch.float32) -> torch.Tensor:
    """uint8 images ``[B, H, W, 3]`` of worlds whose cloth positions are
    ``positions`` ``[B, 3, n, n]`` (float32), seen by the orbit cameras of
    ``theta``, ``phi``, ``radius`` ``[B]``: the globe, then the cloth's
    spheres in flat red over it."""
    dev = positions.device
    cam, light, cloth = cfg["camera"], cfg["light"], cfg["cloth"]
    h, w = cfg["frame"]
    rot, trans, eye = cameras(theta, phi, radius, cam)
    rot, trans, eye = (a.to(dev).to(dtype) for a in (rot, trans, eye))
    fovy, m22, m23 = (a.to(dev) for a in _proj(cam))
    tan_half = torch.tan(fovy / 2.0).to(dtype)      # on the frame's device
    m22, m23 = m22.to(dtype), m23.to(dtype)
    dirs = pixel_rays(rot, eye, tan_half, 1.0, h, w)
    color, depth = globe(rot, trans, eye, dirs, cloth["globe_radius"],
                         tex_int, light, cam, dtype)
    b = positions.shape[0]
    centers = positions.to(dtype).reshape(b, 3, -1).transpose(1, 2)
    r = torch.tensor(cloth["particle_radius"], dtype=F32, device=dev).to(dtype)
    znear = torch.tensor(cam["znear"], dtype=F32, device=dev).to(dtype)
    tmin = nearest_sphere(eye, dirs, centers, r, znear)
    hit = torch.isfinite(tmin)
    tmin_g = torch.where(hit, tmin, 0.0)
    p_world = eye[..., :, None, None] + tmin_g[:, None] * dirs
    p_view = _rotate(rot, p_world - eye[..., :, None, None])
    zn = _ndc_z(torch.where(hit, p_view[:, 2], -1.0), m22, m23)
    win = hit & (zn < depth)
    red = torch.tensor(cfg["cloth_color"], dtype=F32, device=dev).to(dtype)
    color = torch.where(win[..., None], red.expand_as(color), color)
    return (torch.clamp(color.float(), 0.0, 1.0) * 255.0 + 0.5).to(
        torch.uint8)
