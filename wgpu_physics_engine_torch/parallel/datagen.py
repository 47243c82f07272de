"""Batched datagen: thousands of independent cloth worlds stepped and
rendered to framebuffers per call (BASELINE.json configs[4]: "4096 vmapped
cloth scenes + headless instanced-sphere render to 256² framebuffers").

The counterpart of ``wgpu_physics_engine_tpu/parallel/datagen.py``. What
``jax.vmap`` batched there is a leading worlds axis written out here, and
the two kernels of the path each take the whole batch in one launch:

* stepping: ``ops.cloth_kernel.multi_step`` on a ``[B, 3, H, W]`` state
  runs a batched-worlds kernel, a parameter row per world: K5r (one launch
  a call, a CTA a world holding it in shared memory) for a chunk of enough
  worlds, such as the default 1,024, else K5 (one launch per substep for
  all worlds);
* rendering (``render.draw_instanced_spheres_rgb8``): one launch of the
  rays kernel, one binning pass (``raster_kernel.tiled_prologue_batched``)
  and one sphere-raster launch for all worlds, then one launch of the
  epilogue kernel, which composites the spheres over each world's cached
  globe and writes the uint8 frames.

A CPU batch takes the plain versions of both. Each frame's work runs under
``torch.profiler`` ranges (``datagen.step``, ``datagen.render``,
``datagen.codec``, ``datagen.fetch``), so a trace attributes the device
time to them; outside a profiler they cost a few microseconds a frame.

Every entry point defaults to ``device="cuda"`` and runs on the CPU only
when asked; random draws come from an explicit ``torch.Generator``.
"""

from __future__ import annotations

import math
from typing import Iterator, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..core import config as cfg
from ..core.state import (ClothParams, ClothState, init_cloth_state,
                          params_from_numpy, state_from_numpy)
from ..models import cloth
from ..ops import cloth_kernel
from .. import render as R
from ..render import texture as T
from . import codec
from ..utils.profiling import span

# Worlds per chunk of the one-time globe pre-render (globe_base_fbs).
# draw_globe keeps ~25 fp32 [3, 256, 256] temporaries a world (rays,
# hit points, normals, Phong terms), ~20 MB, so 512 worlds peak near
# 10 GB; a 4,096-world run at 256² in world chunks of 1,024 peaked at
# 12.4 GiB of an H100's 80 GB (chip_smoke.py phase 10). The pass runs
# once per dataset, so a larger chunk buys little; the JAX package's 512
# was sized for 16 GB of HBM.
GLOBE_CHUNK = 512


class WorldBatch(NamedTuple):
    """A batch of independent cloth worlds (leading axis = world)."""

    state: ClothState          # pos/vel [B, 3, H, W]
    params: ClothParams        # each leaf [B]


def world_batch_from_numpy(batch, device="cuda") -> WorldBatch:
    """The JAX package's ``datagen.WorldBatch`` (leaves as numpy or
    anything ``np.asarray`` takes: state ``[B, ...]``, params ``[B]``) →
    the port's, on ``device``."""
    return WorldBatch(state=state_from_numpy(batch.state, device),
                      params=params_from_numpy(batch.params, device))


def _uniform(shape, lo, hi, generator, device) -> torch.Tensor:
    """``lo + (hi - lo) * U[0, 1)``, drawn on the generator's device and
    moved to ``device``."""
    gdev = generator.device if generator is not None else "cpu"
    u = torch.rand(shape, generator=generator, device=gdev)
    return (lo + (hi - lo) * u).to(device)


def randomized_worlds(config: cfg.ClothConfig, n_worlds: int,
                      generator: Optional[torch.Generator] = None,
                      height_jitter: float = 5.0,
                      vel_jitter: float = 1.0,
                      stiffness_jitter: float = 0.2,
                      device="cuda") -> WorldBatch:
    """Sample varied initial conditions: spawn height, initial velocity,
    and spring-stiffness scale per world — the knobs the reference exposes
    as egui sliders, randomized for dataset diversity. The distributions
    of the JAX package's ``randomized_worlds``: height offset U(±height_
    jitter), velocity N(0, vel_jitter²) per particle and axis, stiffness
    scale 1 + U(±stiffness_jitter) on all three spring families."""
    device = torch.device(device)
    gdev = generator.device if generator is not None else "cpu"
    base = init_cloth_state(config, device=device)
    dy = _uniform((n_worlds,), -height_jitter, height_jitter, generator,
                  device)
    pos = base.pos.expand((n_worlds,) + base.pos.shape).clone()
    pos[:, 1] += dy[:, None, None]
    vel = vel_jitter * torch.randn((n_worlds,) + base.vel.shape,
                                   generator=generator, device=gdev)
    vel = vel.to(device)

    p1 = ClothParams.from_config(config, device=device)
    scale = 1.0 + stiffness_jitter * _uniform((n_worlds,), -1.0, 1.0,
                                              generator, device)
    params = ClothParams(*(leaf.expand(n_worlds).contiguous() for leaf in p1))
    params = params._replace(
        k_struct=p1.k_struct * scale,
        k_shear=p1.k_shear * scale,
        k_bend=p1.k_bend * scale,
    )
    return WorldBatch(state=ClothState(pos=pos, vel=vel), params=params)


def randomized_cameras(n_worlds: int,
                       generator: Optional[torch.Generator] = None,
                       radius_range=(30.0, 55.0),
                       phi_range=(0.05, 1.2),
                       aspect: float = 1.0, device="cuda") -> R.Camera:
    """Batched orbit cameras (leaves have a leading worlds axis): random
    azimuth U(0, 2π), elevation U(phi_range) and zoom U(radius_range) per
    world — varied dataset viewpoints."""
    theta = _uniform((n_worlds,), 0.0, 2 * math.pi, generator, "cpu")
    phi = _uniform((n_worlds,), *phi_range, generator, "cpu")
    radius = _uniform((n_worlds,), *radius_range, generator, "cpu")
    return R.make_camera(cfg.CameraConfig(), aspect, radius=radius,
                         theta=theta, phi=phi, device=device)


def _broadcast_camera(camera: R.Camera, n_worlds: int) -> R.Camera:
    """A single camera as a batch of ``n_worlds`` equal ones; a batched
    camera as it is."""
    if camera.view.ndim == 3:
        return camera
    return R.Camera(*(a.expand((n_worlds,) + a.shape) for a in camera))


def _slice_camera(camera: R.Camera, i0: int, i1: int) -> R.Camera:
    return R.Camera(*(a[i0:i1] for a in camera))


def globe_base_fbs(cameras: R.Camera, params: ClothParams,
                   globe_tex: torch.Tensor,
                   light: cfg.LightConfig = cfg.LightConfig(),
                   fb_size: Tuple[int, int] = (256, 256),
                   chunk: int = GLOBE_CHUNK) -> R.Framebuffer:
    """Pre-render the STATIC part of every world's frame — background +
    textured, lit globe — once per (world, camera). ``cameras`` is
    batched (leaves ``[B, ...]``), ``params.globe_radius`` ``[B]``.

    The globe never moves during a trajectory and the camera is fixed per
    world, so its render can be paid once per dataset instead of once per
    frame; each frame then composites only the cloth spheres over the
    cached color and depth. Worlds are rendered ``chunk`` at a time to
    bound the pass's temporaries (see ``GLOBE_CHUNK``)."""
    h, w = fb_size
    n = cameras.view.shape[0]
    dev = cameras.view.device
    out = R.Framebuffer(
        color=torch.empty((n, h, w, 3), dtype=torch.float32, device=dev),
        depth=torch.empty((n, h, w), dtype=torch.float32, device=dev))
    for i0 in range(0, n, chunk):
        i1 = min(n, i0 + chunk)
        fb = R.draw_globe(R.clear(h, w, device=dev, n_worlds=i1 - i0),
                          _slice_camera(cameras, i0, i1),
                          params.globe_radius[i0:i1], globe_tex, light)
        out.color[i0:i1] = fb.color
        out.depth[i0:i1] = fb.depth
    return out


def _step_stencil(batch: WorldBatch, dt, n_steps: int) -> ClothState:
    """The stencil twin ``models.cloth.multi_step`` over a batch: it steps
    one world at a time (the counterpart of ``jax.vmap`` over it)."""
    params = [ClothParams(*p) for p in zip(*(leaf.expand(
        batch.state.pos.shape[0]) for leaf in batch.params))]
    worlds = [cloth.multi_step(ClothState(pos=p, vel=v), pr, dt, n_steps)
              for p, v, pr in zip(batch.state.pos, batch.state.vel, params)]
    return batch.state._replace(pos=torch.stack([s.pos for s in worlds]),
                                vel=torch.stack([s.vel for s in worlds]))


def step_and_render(batch: WorldBatch, dt, n_steps: int, camera: R.Camera,
                    globe_tex: torch.Tensor,
                    light: cfg.LightConfig = cfg.LightConfig(),
                    fb_size: Tuple[int, int] = (256, 256),
                    base_fb: Optional[R.Framebuffer] = None,
                    use_kernel: bool = True
                    ) -> Tuple[WorldBatch, torch.Tensor]:
    """Advance every world ``n_steps`` substeps, then render each to a
    framebuffer. Returns (new batch, images ``[B, h, w, 3]`` uint8,
    ``(clip(img, 0, 1) * 255 + 0.5)`` truncated, a quarter of the fp32
    bytes to move to the host).

    ``camera`` is one camera shared by all worlds or a batched one
    (leaves ``[B, ...]``, e.g. from :func:`randomized_cameras`).
    ``base_fb``: the worlds' cached globe (:func:`globe_base_fbs`); without
    it the globe is rendered here. ``use_kernel=True`` steps with
    ``ops.cloth_kernel.multi_step`` (K5r or K5 on a CUDA batch, their
    plain version on a CPU one); ``use_kernel=False`` with the stencil twin
    ``models.cloth.multi_step``."""
    with span("datagen.step"):
        if use_kernel:
            new_state = cloth_kernel.multi_step(batch.state, batch.params,
                                                dt, n_steps)
        else:
            new_state = _step_stencil(batch, dt, n_steps)

    with span("datagen.render"):
        n_worlds = batch.state.pos.shape[0]
        cams = _broadcast_camera(camera, n_worlds)
        h, w = fb_size
        if base_fb is None:
            base_fb = R.draw_globe(
                R.clear(h, w, device=new_state.pos.device, n_worlds=n_worlds),
                cams, batch.params.globe_radius, globe_tex, light)
        centers = new_state.pos.reshape(n_worlds, 3, -1).transpose(1, 2)
        img = R.draw_instanced_spheres_rgb8(base_fb, cams, centers,
                                            batch.params.particle_radius)
    return WorldBatch(state=new_state, params=batch.params), img


class _Fetch:
    """One frame's copy from the card to pinned host memory, started on a
    side stream behind an event recorded after the frame's compute;
    :meth:`wait` blocks until it has landed and returns it as numpy.

    Each frame gets its own pinned buffer (torch's caching host allocator
    reuses freed ones), so a yielded array is never overwritten later, and
    each source is ``record_stream``-ed on the side stream, so the
    allocator does not reuse its memory until the copy has read it."""

    def __init__(self, parts: List[torch.Tensor], stream):
        n = sum(p.shape[0] for p in parts)
        self.host = torch.empty((n,) + tuple(parts[0].shape[1:]),
                                dtype=parts[0].dtype, pin_memory=True)
        ready = torch.cuda.Event()
        ready.record()                     # behind the frame's compute
        with torch.cuda.stream(stream):
            stream.wait_event(ready)
            i0 = 0
            for p in parts:
                self.host[i0:i0 + p.shape[0]].copy_(p, non_blocking=True)
                p.record_stream(stream)
                i0 += p.shape[0]
            self.done = torch.cuda.Event()
            self.done.record(stream)

    def wait(self) -> np.ndarray:
        with span("fetch.wait"):
            self.done.synchronize()
        return self.host.numpy()


def globe_texture(device="cuda") -> torch.Tensor:
    """The datagen globe texture: the 256 mip of the mesh texture, packed
    to one int32 RGB8 plane (one gather per bilinear tap instead of
    three)."""
    return T.pack_rgb8(T.get("mesh", max_size=256, device=device))


def chunk_sizes(n_worlds: int, world_chunk: Optional[int]) -> List[int]:
    """Worlds per chunk: ``world_chunk`` each (default: all at once), the
    last chunk taking the remainder."""
    world_chunk = world_chunk or n_worlds
    n_full, rem = divmod(n_worlds, world_chunk)
    return [world_chunk] * n_full + ([rem] if rem else [])


def chunk_cameras(size: int, i0: int, camera: Optional[R.Camera],
                  randomize_cameras: bool,
                  generator: Optional[torch.Generator], device,
                  default: cfg.CameraConfig = cfg.CameraConfig(),
                  radius_range=(30.0, 55.0)) -> R.Camera:
    """The cameras of the chunk of ``size`` worlds starting at world
    ``i0``: drawn from ``generator`` (:func:`randomized_cameras` with
    ``radius_range``) if ``randomize_cameras``, else the chunk's slice of a
    batched ``camera``, else one camera (``camera`` or the orbit of
    ``default``) shared by the chunk."""
    if randomize_cameras:
        return randomized_cameras(size, generator, radius_range=radius_range,
                                  device=device)
    if camera is not None and camera.view.ndim == 3:
        return R.Camera(*(a[i0:i0 + size].to(device) for a in camera))
    one = camera if camera is not None else R.make_camera(default, aspect=1.0)
    return _broadcast_camera(R.Camera(*(a.to(device) for a in one)), size)


def world_chunks(
    config: cfg.ClothConfig, n_worlds: int, globe_tex: torch.Tensor,
    generator: Optional[torch.Generator] = None,
    fb_size: Tuple[int, int] = (256, 256),
    camera: Optional[R.Camera] = None,
    world_chunk: Optional[int] = None,
    randomize_cameras: bool = False,
    cache_globe: bool = True,
    worlds: Optional[WorldBatch] = None,
    device="cuda",
) -> Tuple[List[WorldBatch], List[R.Camera], List[Optional[R.Framebuffer]]]:
    """The set-up of :func:`generate_trajectory_dataset` (which documents
    the arguments): per chunk of worlds its batch, its cameras and its
    cached globe (``None`` without ``cache_globe``), drawn from
    ``generator`` chunk by chunk (worlds, then cameras)."""
    device = torch.device(device)
    if randomize_cameras and camera is not None:
        raise ValueError("pass either a camera or randomize_cameras=True")
    if worlds is not None and worlds.state.pos.shape[0] != n_worlds:
        raise ValueError(f"worlds holds {worlds.state.pos.shape[0]} worlds, "
                         f"n_worlds is {n_worlds}")
    batches: List[WorldBatch] = []
    cameras: List[R.Camera] = []
    base_fbs: List[Optional[R.Framebuffer]] = []
    i0 = 0
    for size in chunk_sizes(n_worlds, world_chunk):
        i1 = i0 + size
        if worlds is None:
            batches.append(randomized_worlds(config, size, generator,
                                             device=device))
        else:
            batches.append(WorldBatch(
                state=ClothState(*(None if a is None else a[i0:i1].to(device)
                                   for a in worlds.state)),
                params=ClothParams(*(a[i0:i1].to(device)
                                     for a in worlds.params))))
        cams = chunk_cameras(size, i0, camera, randomize_cameras, generator,
                             device)
        cameras.append(cams)
        base_fbs.append(globe_base_fbs(cams, batches[-1].params, globe_tex,
                                       fb_size=fb_size)
                        if cache_globe else None)
        i0 = i1
    return batches, cameras, base_fbs


def encode_parts(batches: list, step, codec_k: Optional[int] = None,
                 codec_quality: float = 1.0) -> List[torch.Tensor]:
    """One frame on the device, chunk by chunk: ``step(i, batches[i])``
    returns the chunk's next batch (stored back into ``batches``) and its
    images, which the codec then compresses if ``codec_k``. Returns each
    chunk's images (uint8 ``[b, h, w, 3]``, or int8 coefficients)."""
    parts = []
    for bi in range(len(batches)):
        batches[bi], im = step(bi, batches[bi])
        if codec_k is not None:
            with span("datagen.codec"):
                im = codec.encode(im, k=codec_k, quality=codec_quality)
        parts.append(im)
    return parts


def frame_parts(batches: List[WorldBatch], cameras: List[R.Camera],
                base_fbs: List[Optional[R.Framebuffer]], dt,
                steps_per_frame: int, globe_tex: torch.Tensor,
                fb_size: Tuple[int, int] = (256, 256),
                use_kernel: bool = True, codec_k: Optional[int] = None,
                codec_quality: float = 1.0) -> List[torch.Tensor]:
    """One frame of :func:`generate_trajectory_dataset` on the device:
    :func:`step_and_render` on every chunk (``batches`` advance in place),
    then the codec if ``codec_k`` (:func:`encode_parts`)."""
    return encode_parts(
        batches, lambda bi, b: step_and_render(
            b, dt, steps_per_frame, cameras[bi], globe_tex, fb_size=fb_size,
            base_fb=base_fbs[bi], use_kernel=use_kernel),
        codec_k, codec_quality)


def stream_frames(frame, n_frames: int, batches: list, device
                  ) -> Iterator[Tuple[int, np.ndarray, list]]:
    """Yield ``(frame_idx, images, batches)`` host-side for ``n_frames``
    frames of ``frame()`` (each chunk's images on the device, ``batches``
    advanced in place), concatenated over the chunks.

    On CUDA each frame's copy to pinned host memory starts on a side
    stream as soon as the frame is enqueued (:class:`_Fetch`), and frame
    f+1 is enqueued before frame f is waited for and yielded, so the copy
    of frame f runs beside the compute of frame f+1; the yielded
    ``batches`` then already hold frame f+1's state. On the CPU each frame
    is copied as it is made."""
    device = torch.device(device)
    side = torch.cuda.Stream(device) if device.type == "cuda" else None
    pending = None          # (frame_idx, fetch of that frame)
    for f in range(n_frames):
        parts = frame()
        with span("datagen.fetch"):
            if side is not None:
                fetch = _Fetch(parts, side)
            else:
                fetch = torch.cat(parts).numpy()
        if pending is not None:
            pf, pfetch = pending
            yield pf, pfetch.wait() if side is not None else pfetch, batches
        pending = (f, fetch)
    if pending is not None:                       # n_frames == 0: yield nothing
        pf, pfetch = pending
        yield pf, pfetch.wait() if side is not None else pfetch, batches


def generate_trajectory_dataset(
    config: cfg.ClothConfig, n_worlds: int, n_frames: int,
    steps_per_frame: int, generator: Optional[torch.Generator] = None,
    fb_size: Tuple[int, int] = (256, 256),
    camera: Optional[R.Camera] = None,
    globe_tex: Optional[torch.Tensor] = None,
    world_chunk: Optional[int] = None,
    use_kernel: bool = True,
    randomize_cameras: bool = False,
    codec_k: Optional[int] = None,
    codec_quality: float = 1.0,
    cache_globe: bool = True,
    worlds: Optional[WorldBatch] = None,
    device="cuda",
) -> Iterator[Tuple[int, np.ndarray, List[WorldBatch]]]:
    """Yield ``(frame_idx, images, batches)`` host-side per frame.

    ``world_chunk`` bounds device memory: worlds are processed in chunks of
    that size (default: all at once), the last chunk taking the remainder.

    Initial worlds come from :func:`randomized_worlds` with ``generator``,
    chunk by chunk, unless ``worlds`` (a ``WorldBatch`` of ``n_worlds``)
    is given. Cameras: a batched ``camera`` gives each world its own, else
    ``randomize_cameras`` samples them (:func:`randomized_cameras`, after
    each chunk's worlds), else one camera (``camera`` or the default
    orbit) is shared. ``globe_tex`` defaults to :func:`globe_texture`.

    ``codec_k``: if set, frames are compressed ON DEVICE with the
    fixed-rate DCT codec (:mod:`.codec`) before the copy to the host —
    yielded arrays are ``[B, h/8, w/8, 3, codec_k]`` int8 (64/k× fewer
    bytes; decode with :func:`codec.decode`); else ``[B, h, w, 3]`` uint8.

    Transfer/compute overlap (on CUDA, :func:`stream_frames`): frame f+1's
    step and render are enqueued before frame f is waited for and yielded,
    so the copy of frame f runs beside the compute of frame f+1. The
    yielded ``batches`` therefore already hold frame f+1's state when frame
    f's images are delivered.
    """
    device = torch.device(device)
    globe_tex = (globe_texture(device) if globe_tex is None
                 else globe_tex.to(device))
    batches, cameras, base_fbs = world_chunks(
        config, n_worlds, globe_tex, generator, fb_size, camera, world_chunk,
        randomize_cameras, cache_globe, worlds, device)
    dt = 1.0 / config.hz
    yield from stream_frames(
        lambda: frame_parts(batches, cameras, base_fbs, dt, steps_per_frame,
                            globe_tex, fb_size, use_kernel, codec_k,
                            codec_quality),
        n_frames, batches, device)
