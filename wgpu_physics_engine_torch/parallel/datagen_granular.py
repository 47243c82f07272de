"""Batched granular datagen: independent granular worlds with per-world
MATERIALS, stepped by the granular kernel and rendered to framebuffers.

The counterpart of ``wgpu_physics_engine_tpu/parallel/datagen_granular.py``
and the granular twin of :mod:`.datagen`. Diversity comes from two axes
the cloth generator cannot express:

* per-world initial conditions (lattice jitter and velocity noise);
* per-world material constants: ``k_contact`` / ``gravity`` /
  ``restitution`` ride :func:`granular.multi_step`'s parameter vector as
  0-d tensors, so every material of the batch steps through the same
  kernel K10 and rebuilds nothing.

The pipeline is the cloth generator's (:func:`datagen.chunk_sizes`,
:func:`datagen.chunk_cameras`, :func:`datagen.encode_parts`,
:func:`datagen.stream_frames`): the worlds are stepped one at a time, as
JAX's ``lax.map`` does (K10 and the rebuild take one world), then each
chunk of worlds is binned in one pass and rendered in one launch of the
batched sphere raster K2/K3 over the wireframe box pre-rendered once per
(world, camera); frames compress on the device with the DCT codec, and
frame f+1 is dispatched before frame f is fetched.

A CPU batch takes the plain versions of the kernels. Every entry point
defaults to ``device="cuda"``; random draws come from an explicit
``torch.Generator``.
"""

from __future__ import annotations

from typing import Iterator, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..core import config as cfg
from ..core.state import ParticleState
from ..models import granular
from .. import render as R
from . import datagen
from ..utils.profiling import span

SAND = (0.86, 0.65, 0.35)

# Worlds a pass of the one-time box pre-render (box_base_fbs): the line
# test keeps ~10 fp32 [h, w, 12] temporaries a world, ~30 MB at 256², so
# 64 worlds peak near 2 GB.
BOX_CHUNK = 64


class GranularWorldBatch(NamedTuple):
    """A batch of independent granular worlds (leading axis = world)."""

    state: ParticleState        # pos/vel [B, 3, N]
    k_contact: torch.Tensor     # [B] material constants
    gravity: torch.Tensor       # [B]
    restitution: torch.Tensor   # [B]


def granular_world_batch_from_numpy(batch, device="cuda"
                                    ) -> GranularWorldBatch:
    """The JAX package's ``GranularWorldBatch`` (leaves as numpy or
    anything ``np.asarray`` takes: state ``[B, 3, N]``, materials ``[B]``)
    → the port's, on ``device``."""
    def f32(a):
        return torch.tensor(np.asarray(a, np.float32), device=device)

    return GranularWorldBatch(
        state=ParticleState(pos=f32(batch.state.pos), vel=f32(batch.state.vel)),
        k_contact=f32(batch.k_contact), gravity=f32(batch.gravity),
        restitution=f32(batch.restitution))


def randomized_granular_worlds(config: granular.GranularConfig,
                               n_worlds: int,
                               generator: Optional[torch.Generator] = None,
                               vel_jitter: float = 0.5,
                               k_jitter: float = 0.3,
                               gravity_jitter: float = 0.2,
                               restitution_range=(0.2, 0.8),
                               device="cuda") -> GranularWorldBatch:
    """Per-world initial conditions and material constants, the
    distributions of the JAX package's ``randomized_granular_worlds``:
    each world's lattice jitter (``granular.init_state``), velocity noise
    N(0, vel_jitter²) per particle and axis, ``k_contact`` and ``gravity``
    scaled by U(1 ± jitter), restitution U(restitution_range). The
    geometry (N, radius, bounds: everything that shapes the broad-phase
    grid) is shared."""
    device = torch.device(device)
    gdev = generator.device if generator is not None else "cpu"
    states = [granular.init_state(config, generator, device=device)
              for _ in range(n_worlds)]
    pos = torch.stack([s.pos for s in states])
    vel = vel_jitter * torch.randn(pos.shape, generator=generator,
                                   device=gdev)
    vel = torch.stack([s.vel for s in states]) + vel.to(device)

    def u(lo, hi):
        return datagen._uniform((n_worlds,), lo, hi, generator, device)

    return GranularWorldBatch(
        state=ParticleState(pos=pos, vel=vel),
        k_contact=config.k_contact * u(1.0 - k_jitter, 1.0 + k_jitter),
        gravity=config.gravity * u(1.0 - gravity_jitter, 1.0 + gravity_jitter),
        restitution=u(*restitution_range))


def box_base_fbs(cameras: R.Camera, bounds: float,
                 fb_size: Tuple[int, int] = (256, 256)) -> R.Framebuffer:
    """Pre-render the STATIC part of every world's frame — background and
    wireframe box — once per (world, camera); ``cameras`` is batched
    (leaves ``[B, ...]``). The granular analog of
    :func:`datagen.globe_base_fbs`: ``draw_lines`` on a batch of
    framebuffers, ``BOX_CHUNK`` worlds a pass, each world equal to the
    single-camera pass bit for bit."""
    h, w = fb_size
    n = cameras.view.shape[0]
    dev = cameras.view.device
    segs = R.geometry.wireframe_box(float(bounds)).reshape(-1, 2, 3)
    out = R.Framebuffer(
        color=torch.empty((n, h, w, 3), dtype=torch.float32, device=dev),
        depth=torch.empty((n, h, w), dtype=torch.float32, device=dev))
    for i0 in range(0, n, BOX_CHUNK):
        i1 = min(n, i0 + BOX_CHUNK)
        fb = R.draw_lines(R.clear(h, w, device=dev, n_worlds=i1 - i0),
                          datagen._slice_camera(cameras, i0, i1), segs,
                          color=(0.0, 0.0, 1.0))
        out.color[i0:i1] = fb.color
        out.depth[i0:i1] = fb.depth
    return out


def step_worlds(batch: GranularWorldBatch, config: granular.GranularConfig,
                dt, n_steps: int) -> GranularWorldBatch:
    """Advance every world ``n_steps`` substeps under its own materials,
    one world at a time (JAX's ``lax.map``): ``granular.multi_step`` on
    the kernel route, K10 on a CUDA batch."""
    outs = [granular.multi_step(ParticleState(pos=p, vel=v), config, dt,
                                n_steps, k_contact=kc, gravity=g,
                                restitution=e)
            for p, v, kc, g, e in zip(batch.state.pos, batch.state.vel,
                                      batch.k_contact, batch.gravity,
                                      batch.restitution)]
    return batch._replace(state=ParticleState(
        pos=torch.stack([s.pos for s in outs]),
        vel=torch.stack([s.vel for s in outs])))


def granular_step_and_render(batch: GranularWorldBatch,
                             config: granular.GranularConfig, dt,
                             n_steps: int, camera: R.Camera,
                             fb_size: Tuple[int, int] = (256, 256),
                             base_fb: Optional[R.Framebuffer] = None
                             ) -> Tuple[GranularWorldBatch, torch.Tensor]:
    """Advance every world ``n_steps`` substeps (:func:`step_worlds`), then
    render each to a framebuffer: sand-coloured spheres over the cached
    box frame ``base_fb`` (:func:`box_base_fbs`; a cleared frame without
    it, as in the JAX package).
    The worlds are binned in one pass, rendered in one launch of the
    batched raster and composited to uint8 in one launch of the epilogue
    kernel (``render.draw_instanced_spheres_rgb8``). ``camera`` is one
    camera shared by all worlds or a batched one. Returns (new batch,
    images ``[B, h, w, 3]``: uint8, ``(clip(img, 0, 1) * 255 + 0.5)``
    truncated). The flat sand colour
    takes no light, so JAX's ``light`` has no counterpart here."""
    with span("datagen.step"):
        new_batch = step_worlds(batch, config, dt, n_steps)

    with span("datagen.render"):
        pos = new_batch.state.pos
        n_worlds = pos.shape[0]
        cams = datagen._broadcast_camera(camera, n_worlds)
        if base_fb is None:
            base_fb = R.clear(*fb_size, device=pos.device, n_worlds=n_worlds)
        img = R.draw_instanced_spheres_rgb8(
            base_fb, cams, pos.transpose(1, 2), float(config.radius),
            flat_color=SAND)
    return new_batch, img


def granular_chunks(
    config: granular.GranularConfig, n_worlds: int,
    generator: Optional[torch.Generator] = None,
    fb_size: Tuple[int, int] = (256, 256),
    camera: Optional[R.Camera] = None,
    world_chunk: Optional[int] = None,
    randomize_cameras: bool = False,
    worlds: Optional[GranularWorldBatch] = None,
    device="cuda",
) -> Tuple[List[GranularWorldBatch], List[R.Camera], List[R.Framebuffer]]:
    """The set-up of :func:`generate_granular_dataset` (which documents the
    arguments): per chunk of worlds its batch, its cameras and its cached
    box frame, drawn from ``generator`` chunk by chunk (worlds, then
    cameras)."""
    device = torch.device(device)
    if randomize_cameras and camera is not None:
        raise ValueError("pass either a camera or randomize_cameras=True")
    if worlds is not None and worlds.state.pos.shape[0] != n_worlds:
        raise ValueError(f"worlds holds {worlds.state.pos.shape[0]} worlds, "
                         f"n_worlds is {n_worlds}")
    default = cfg.CameraConfig(radius=3.2 * config.bounds, phi=0.35,
                               theta=0.4)
    batches, cameras, base_fbs = [], [], []
    i0 = 0
    for size in datagen.chunk_sizes(n_worlds, world_chunk):
        i1 = i0 + size
        if worlds is None:
            batches.append(randomized_granular_worlds(config, size, generator,
                                                      device=device))
        else:
            batches.append(GranularWorldBatch(
                state=ParticleState(*(a[i0:i1].to(device)
                                      for a in worlds.state)),
                k_contact=worlds.k_contact[i0:i1].to(device),
                gravity=worlds.gravity[i0:i1].to(device),
                restitution=worlds.restitution[i0:i1].to(device)))
        cams = datagen.chunk_cameras(
            size, i0, camera, randomize_cameras, generator, device,
            default=default,
            radius_range=(2.2 * config.bounds, 4.0 * config.bounds))
        cameras.append(cams)
        base_fbs.append(box_base_fbs(cams, config.bounds, fb_size))
        i0 = i1
    return batches, cameras, base_fbs


def generate_granular_dataset(
    config: granular.GranularConfig, n_worlds: int, n_frames: int,
    steps_per_frame: int, generator: Optional[torch.Generator] = None,
    fb_size: Tuple[int, int] = (256, 256),
    camera: Optional[R.Camera] = None,
    world_chunk: Optional[int] = None,
    randomize_cameras: bool = False,
    codec_k: Optional[int] = None,
    codec_quality: float = 1.0,
    hz: float = 240.0,
    worlds: Optional[GranularWorldBatch] = None,
    device="cuda",
) -> Iterator[Tuple[int, np.ndarray, List[GranularWorldBatch]]]:
    """Yield ``(frame_idx, images, batches)`` host-side per frame — the
    granular twin of :func:`datagen.generate_trajectory_dataset`: the same
    chunking (``world_chunk`` worlds a chunk, the last taking the
    remainder), the same codec contract (``codec_k``: ``[B, h/8, w/8, 3,
    codec_k]`` int8, else ``[B, h, w, 3]`` uint8) and the same overlap of
    the copy of frame f with the compute of frame f+1
    (:func:`datagen.stream_frames`).

    Initial worlds come from :func:`randomized_granular_worlds` with
    ``generator``, chunk by chunk, unless ``worlds`` (a
    ``GranularWorldBatch`` of ``n_worlds``) is given. Cameras: a batched
    ``camera`` gives each world its own, else ``randomize_cameras``
    samples them (zoom U(2.2, 4.0) × bounds, after each chunk's worlds),
    else one camera (``camera`` or the pile's default orbit) is shared.
    Each frame advances ``steps_per_frame`` substeps at ``hz``."""
    device = torch.device(device)
    batches, cameras, base_fbs = granular_chunks(
        config, n_worlds, generator, fb_size, camera, world_chunk,
        randomize_cameras, worlds, device)
    dt = 1.0 / hz
    yield from datagen.stream_frames(
        lambda: datagen.encode_parts(
            batches, lambda bi, b: granular_step_and_render(
                b, config, dt, steps_per_frame, cameras[bi], fb_size=fb_size,
                base_fb=base_fbs[bi]),
            codec_k, codec_quality),
        n_frames, batches, device)
