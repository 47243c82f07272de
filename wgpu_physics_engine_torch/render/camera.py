"""Orbit camera as plain functions on torch tensors (the counterpart of
``wgpu_physics_engine_tpu/render/camera.py``; wgpu-bootstrap's OrbitCamera,
usage at cloth.rs:568-581).

Conventions: right-handed world, +y up; polar ``(radius, theta, phi)`` with
theta the azimuth around +y (0 → eye on +z) and phi the elevation; ``view``
is a right-handed look-at, ``proj`` a perspective with wgpu's depth range
z ∈ [0, 1].

The matrices are built in fp32 on the CPU and then moved to the caller's
device, so a camera is the same on every device.

A batch of cameras (the counterpart of ``jax.vmap(make_camera)``) is a
``Camera`` whose leaves carry a leading worlds axis: ``make_camera`` builds
one from ``[B]`` tensors of radius, theta and phi, and ``pixel_rays`` then
returns ``eye [B, 3]`` and ``dirs [B, 3, H, W]``.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import torch

from ..core import config as cfg
from ..ops import pixel_kernel

_F32 = torch.float32


class Camera(NamedTuple):
    """Resolved camera: view/proj matrices and eye position (fp32), each
    leaf with a leading ``[B]`` axis for a batch of cameras."""

    view: torch.Tensor   # [4, 4]
    proj: torch.Tensor   # [4, 4]
    eye: torch.Tensor    # [3]
    fovy_rad: torch.Tensor
    aspect: torch.Tensor
    znear: torch.Tensor
    zfar: torch.Tensor


def _t(v) -> torch.Tensor:
    return torch.as_tensor(v, dtype=_F32, device="cpu")


def orbit_eye(target, radius, theta, phi) -> torch.Tensor:
    """Eye position on the orbit sphere: ``[3]``, or ``[B, 3]`` for ``[B]``
    radius/theta/phi."""
    target, radius, theta, phi = _t(target), _t(radius), _t(theta), _t(phi)
    offset = torch.stack([
        radius * torch.cos(phi) * torch.sin(theta),
        radius * torch.sin(phi),
        radius * torch.cos(phi) * torch.cos(theta),
    ], dim=-1)
    return target + offset


def look_at(eye, target, up=(0.0, 1.0, 0.0)) -> torch.Tensor:
    """Right-handed view matrix (the camera looks down −z in view space);
    ``[4, 4]``, or ``[B, 4, 4]`` for eyes ``[B, 3]``."""
    eye, target, up = _t(eye), _t(target), _t(up)
    if eye.ndim > 1:
        return _look_at_batched(eye, target, up)
    f = target - eye
    f = f / torch.linalg.norm(f)
    s = torch.linalg.cross(f, up)
    s = s / torch.linalg.norm(s)
    u = torch.linalg.cross(s, f)
    rot = torch.stack([s, u, -f])          # rows: right, up, -forward
    view = torch.zeros((4, 4), dtype=_F32)
    view[:3, :3] = rot
    view[:3, 3] = -rot @ eye
    view[3, 3] = 1.0
    return view


def _look_at_batched(eye, target, up) -> torch.Tensor:
    """:func:`look_at` for eyes ``[B, 3]``."""
    f = target - eye
    f = f / torch.linalg.norm(f, dim=-1, keepdim=True)
    s = torch.linalg.cross(f, up.expand_as(f))
    s = s / torch.linalg.norm(s, dim=-1, keepdim=True)
    u = torch.linalg.cross(s, f)
    rot = torch.stack([s, u, -f], dim=-2)  # rows: right, up, -forward
    view = torch.zeros(eye.shape[:-1] + (4, 4), dtype=_F32)
    view[..., :3, :3] = rot
    view[..., :3, 3] = -(rot @ eye[..., None])[..., 0]
    view[..., 3, 3] = 1.0
    return view


def perspective(fovy_rad, aspect, znear, zfar) -> torch.Tensor:
    """Perspective projection, depth mapped to [0, 1] (wgpu convention)."""
    fovy_rad, aspect, znear, zfar = (_t(fovy_rad), _t(aspect), _t(znear),
                                     _t(zfar))
    f = 1.0 / torch.tan(fovy_rad / 2.0)
    m = torch.zeros((4, 4), dtype=_F32)
    m[0, 0] = f / aspect
    m[1, 1] = f
    m[2, 2] = zfar / (znear - zfar)
    m[2, 3] = zfar * znear / (znear - zfar)
    m[3, 2] = -1.0
    return m


def make_camera(config: cfg.CameraConfig = cfg.CameraConfig(),
                aspect: float = 1.0, radius=None, theta=None, phi=None,
                target=None, device=None) -> Camera:
    """Build a camera from config with optional per-call overrides (the
    egui zoom slider equivalent — cloth.rs:1389-1391), on ``device``.

    ``radius``/``theta``/``phi`` given as ``[B]`` tensors build a batch of
    cameras: every leaf gets a leading ``[B]`` axis, the shared ones
    (``proj``, ``fovy_rad``, ``aspect``, ``znear``, ``zfar``) broadcast."""
    radius = config.radius if radius is None else radius
    theta = config.theta if theta is None else theta
    phi = config.phi if phi is None else phi
    target = config.target if target is None else target
    eye = orbit_eye(target, radius, theta, phi)
    fovy = _t(config.fovy_deg * math.pi / 180.0)
    cam = Camera(
        view=look_at(eye, target),
        proj=perspective(fovy, aspect, config.znear, config.zfar),
        eye=eye,
        fovy_rad=fovy,
        aspect=_t(aspect),
        znear=_t(config.znear),
        zfar=_t(config.zfar),
    )
    lead = eye.shape[:-1]
    if lead:
        cam = Camera(*(a.expand(lead + a.shape[a.ndim - ref:]).contiguous()
                       for a, ref in zip(cam, (2, 2, 1, 0, 0, 0, 0))))
    return Camera(*(a.to(device) for a in cam))


def _needs_grad(*xs) -> bool:
    """Whether autograd is recording and any of ``xs`` (tensors or numbers)
    requires a gradient."""
    return torch.is_grad_enabled() and any(
        isinstance(x, torch.Tensor) and x.requires_grad for x in xs)


def pixel_rays(camera: Camera, height: int,
               width: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-pixel primary rays in WORLD space: (origin [3], dirs [3, H, W]),
    or (``[B, 3]``, ``[B, 3, H, W]``) for a batch of cameras.

    Pixel centres; row 0 is the top of the image (NDC y = +1 edge).
    Directions are normalized.

    A CUDA camera that autograd needs no gradient through takes the rays
    kernel (``ops.pixel_kernel.pixel_rays``, the same bits); a CPU camera,
    or one carrying a gradient, :func:`pixel_rays_plain`.
    """
    if camera.eye.device.type == "cuda" and not _needs_grad(*camera):
        return camera.eye, pixel_kernel.pixel_rays(
            camera.view, torch.tan(camera.fovy_rad / 2.0), camera.aspect,
            height, width)
    return pixel_rays_plain(camera, height, width)


def pixel_rays_plain(camera: Camera, height: int,
                     width: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`pixel_rays` in torch: the plain version of the rays kernel."""
    return camera.eye, pixel_dirs_plain(
        camera.view, torch.tan(camera.fovy_rad / 2.0), camera.aspect, height,
        width)


def pixel_dirs_plain(view: torch.Tensor, tan_half: torch.Tensor,
                     aspect: torch.Tensor, height: int,
                     width: int) -> torch.Tensor:
    """The directions of :func:`pixel_rays_plain` from the camera's
    ``view`` ``[.., 4, 4]``, ``tan_half`` (tan(fovy / 2)) and ``aspect``
    (broadcast to ``view``'s leading axes ``..``):
    ``ops.pixel_kernel.pixel_rays``' plain version, with its arguments."""
    dev = view.device
    lead = view.shape[:-2]
    j = (torch.arange(width, dtype=_F32, device=dev) + 0.5) / width * 2.0 - 1.0
    i = 1.0 - (torch.arange(height, dtype=_F32, device=dev) + 0.5) / height * 2.0
    tan_half = tan_half[..., None, None]
    aspect = aspect[..., None, None]
    vx = (j[None, :] * tan_half * aspect).expand(lead + (height, width))
    vy = (i[:, None] * tan_half).expand(lead + (height, width))
    vz = torch.full((height, width), -1.0, dtype=_F32, device=dev)
    rot = view[..., :3, :3, None, None]                # world→view
    # rotᵀ @ d, written out (no matmul, so no TF32 question on the card)
    d_world = torch.stack([rot[..., 0, k, :, :] * vx + rot[..., 1, k, :, :] * vy
                           + rot[..., 2, k, :, :] * vz for k in range(3)],
                          dim=-3)
    norm = torch.sqrt(torch.sum(d_world * d_world, dim=-3, keepdim=True))
    return d_world / norm
