"""The per-pixel chains of the sphere render around the raster as two CUDA
kernels (``csrc/pixel_chain.cu``), and their launch counts.

* :func:`pixel_rays` launches ``wpe_pixel_rays``: the primary rays of
  ``render.camera.pixel_rays`` for a camera or a batch of cameras (the
  plain version, with this function's arguments, is
  ``render.camera.pixel_dirs_plain``), counted in :data:`LAUNCHES_RAYS`;
* :func:`flat_composite_rgb8` launches ``wpe_flat_composite_rgb8``: from
  the raster's nearest hits to the uint8 frame, flat-coloured spheres
  composited over a framebuffer (the plain version is
  ``render.raster.draw_instanced_spheres`` with a flat colour followed by
  the datagens' uint8 cast: ``draw_instanced_spheres_rgb8_plain``, and
  after the raster ``_flat_composite`` and ``to_rgb8``), counted in
  :data:`LAUNCHES_EPILOGUE`.

Neither replaces a Pallas kernel: XLA fused these chains on the TPU. The
callers choose them by device and gradient (``render.camera.pixel_rays``,
``render.raster.draw_instanced_spheres_rgb8``); on CUDA tensors these
functions launch or raise.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from . import _build

# Kernel launches by :func:`pixel_rays` and :func:`flat_composite_rgb8`; a
# run reads them to show that its path went through the kernels.
LAUNCHES_RAYS = 0
LAUNCHES_EPILOGUE = 0

_SIGNATURES = {
    "wpe_pixel_rays": [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3
                      + [ctypes.c_void_p],
    "wpe_flat_composite_rgb8": [ctypes.c_void_p] * 9 + [ctypes.c_float] * 3
                               + [ctypes.c_void_p] + [ctypes.c_int] * 3
                               + [ctypes.c_void_p],
}


def _per_world(x: torch.Tensor, lead: Tuple[int, ...], tail: int = 0
               ) -> torch.Tensor:
    """``x`` (a camera leaf, or a framebuffer plane with ``tail`` trailing
    axes) as a contiguous fp32 tensor with the leading axes ``lead``, a
    shared one broadcast to them."""
    return x.to(torch.float32).expand(lead + x.shape[x.ndim - tail:]
                                      ).contiguous()


def _check_cuda(what: str, *xs: torch.Tensor) -> torch.device:
    dev = xs[0].device
    if dev.type != "cuda" or any(x.device != dev for x in xs):
        raise ValueError(f"{what} needs CUDA tensors on one device, got "
                         f"{[str(x.device) for x in xs]}")
    return dev


def pixel_rays(view: torch.Tensor, tan_half: torch.Tensor,
               aspect: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """Normalized world-space primary rays ``[.., 3, H, W]`` for cameras
    ``view`` ``[.., 4, 4]``, ``tan_half`` (tan(fovy / 2)) and ``aspect``
    ``[..]`` (broadcast to ``view``'s leading axes ``..``, none for one
    camera). The bits of ``camera.pixel_dirs_plain`` on the card."""
    global LAUNCHES_RAYS
    dev = _check_cuda("pixel_rays", view, tan_half, aspect)
    if view.shape[-2:] != (4, 4):
        raise ValueError(f"pixel_rays: view must be [.., 4, 4], got "
                         f"{tuple(view.shape)}")
    lead = tuple(view.shape[:-2])
    view = _per_world(view, lead, 2)
    tan_half, aspect = _per_world(tan_half, lead), _per_world(aspect, lead)
    dirs = torch.empty(lead + (3, height, width), dtype=torch.float32,
                       device=dev)
    lib = _build.load("pixel_chain", _SIGNATURES)
    with torch.cuda.device(dev):
        err = lib.wpe_pixel_rays(
            view.data_ptr(), tan_half.data_ptr(), aspect.data_ptr(),
            dirs.data_ptr(), view.numel() // 16, height, width,
            torch.cuda.current_stream().cuda_stream)
    _build.check(lib, err, "pixel_rays launch")
    LAUNCHES_RAYS += 1
    return dirs


def flat_composite_rgb8(tmin: torch.Tensor, inst: torch.Tensor,
                        color: torch.Tensor, depth: torch.Tensor,
                        view: torch.Tensor, eye: torch.Tensor,
                        proj: torch.Tensor, tan_half: torch.Tensor,
                        aspect: torch.Tensor,
                        flat_color: Tuple[float, float, float]
                        ) -> torch.Tensor:
    """The uint8 frame ``[.., H, W, 3]`` of flat-coloured spheres over the
    framebuffer ``(color [.., H, W, 3], depth [.., H, W])``, from the
    raster's ``tmin`` and ``inst`` (``[.., H, W]``, -1 on a miss) for the
    cameras ``view``/``proj`` ``[.., 4, 4]``, ``eye`` ``[.., 3]``,
    ``tan_half``/``aspect`` ``[..]``: ``draw_instanced_spheres``' colour
    cast to uint8 on the card, bit for bit. The leading axes ``..`` are
    those of ``tmin``; a framebuffer or camera leaf without them (shared
    by all worlds) is broadcast to them."""
    global LAUNCHES_EPILOGUE
    dev = _check_cuda("flat_composite_rgb8", tmin, inst, color, depth, view,
                      eye, proj, tan_half, aspect)
    lead = tuple(tmin.shape[:-2])
    h, w = tmin.shape[-2:]
    if (tuple(inst.shape) != tuple(tmin.shape)
            or tuple(depth.shape[-2:]) != (h, w)
            or tuple(color.shape[-3:]) != (h, w, 3)
            or inst.dtype != torch.int32 or tmin.dtype != torch.float32
            or color.dtype != torch.float32 or depth.dtype != torch.float32):
        raise ValueError(
            "flat_composite_rgb8: expected tmin f32 and inst int32 [.., H, "
            "W], depth f32 [.., H, W], color f32 [.., H, W, 3]; got "
            f"{tuple(tmin.shape)} {tmin.dtype}, {tuple(inst.shape)} "
            f"{inst.dtype}, {tuple(depth.shape)} {depth.dtype}, "
            f"{tuple(color.shape)} {color.dtype}")
    tmin, inst = tmin.contiguous(), inst.contiguous()
    color, depth = _per_world(color, lead, 3), _per_world(depth, lead, 2)
    view, proj = _per_world(view, lead, 2), _per_world(proj, lead, 2)
    eye = _per_world(eye, lead, 1)
    tan_half, aspect = _per_world(tan_half, lead), _per_world(aspect, lead)
    out = torch.empty(lead + (h, w, 3), dtype=torch.uint8, device=dev)
    lib = _build.load("pixel_chain", _SIGNATURES)
    r, g, b = (float(c) for c in flat_color)
    with torch.cuda.device(dev):
        err = lib.wpe_flat_composite_rgb8(
            tmin.data_ptr(), inst.data_ptr(), color.data_ptr(),
            depth.data_ptr(), view.data_ptr(), eye.data_ptr(),
            proj.data_ptr(), tan_half.data_ptr(), aspect.data_ptr(), r, g, b,
            out.data_ptr(), view.numel() // 16, h, w,
            torch.cuda.current_stream().cuda_stream)
    _build.check(lib, err, "flat_composite_rgb8 launch")
    LAUNCHES_EPILOGUE += 1
    return out
