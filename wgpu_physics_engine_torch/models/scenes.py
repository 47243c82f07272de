"""Application layer: the reference's simulations as scene objects (the
counterparts of the scenes of ``wgpu_physics_engine_tpu/models/scenes.py``):

* :class:`CubeScene`          — sim 1 (flat-colored indexed cube)
* :class:`TexturedCubeScene`  — sim 2 (diffuse textured cube)
* :class:`GlobeScene`         — sim 3 (lit, textured UV sphere)
* :class:`FreeParticleScene`  — sim 4 (bouncing spheres in a wireframe box)
* :class:`ClothScene`         — sim 5, the flagship (cloth over the globe)
* :class:`GranularScene`      — sim 4 scaled to contact-resolved piles

A host-side stateful wrapper around the functional core with the
``update(delta_time)`` / ``render(h, w)`` frame contract of wgpu-bootstrap's
``trait App``, and runtime parameters that live in device tensors, so a
slider rewrites a tensor and rebuilds no kernel. Scenes take an explicit
``device``; nothing falls back to another device.
"""

from __future__ import annotations

import dataclasses
import functools
import time
from typing import Optional

import numpy as np
import torch

from ..core import config as cfg
from ..core.state import ClothParams, ParticleParams, init_cloth_state
from ..ops import cloth_kernel
from .. import render as R
from ..render import texture as T
from . import cloth, granular, particles
from ..utils.profiling import span


# The slab of the scene's thin self-collision candidate set. The scene's
# grid has a skin of 2·particle_radius (cells of 0.405 at the default
# radius), so at 256² an x-column of cells of the falling sheet holds ~900
# particles and a block's window hull spans up to two of them: with the
# default 640 a rebuild in the first simulated second drops up to 13.2M
# window entries, with 1024 none while the cloth falls (H100,
# tools/self_collide_slab_probe.py). Once the cloth lands on the globe and
# folds, every slab up to 2560 drops entries.
SELF_COLLIDE_SLAB = 1024


class _FrameClock:
    """FPS bookkeeping (the egui FPS label, cloth.rs:1446,1459)."""

    def __init__(self):
        self._last = None
        self.fps = 0.0

    def tick(self) -> float:
        now = time.time()
        dt = 1.0 / 60.0 if self._last is None else max(now - self._last, 1e-6)
        self._last = now
        self.fps = 1.0 / dt
        return dt


class _SceneBase:
    """Common camera/light handling and orbit controls."""

    def __init__(self, camera_cfg: cfg.CameraConfig, light: cfg.LightConfig,
                 aspect: float, device):
        self.device = torch.device(device)
        self.camera_cfg = camera_cfg
        self.light = light
        self._aspect = aspect
        self._orbit = dict(radius=camera_cfg.radius, theta=camera_cfg.theta,
                           phi=camera_cfg.phi)
        self.clock = _FrameClock()

    # --- input / resize (App::input, App::resize equivalents) ---
    def orbit(self, d_theta: float = 0.0, d_phi: float = 0.0,
              d_radius: float = 0.0) -> None:
        self._orbit["theta"] += d_theta
        self._orbit["phi"] = float(np.clip(self._orbit["phi"] + d_phi,
                                           -1.55, 1.55))
        self._orbit["radius"] = max(self._orbit["radius"] + d_radius, 0.1)

    def set_zoom(self, radius: float) -> None:  # camera zoom slider
        self._orbit["radius"] = radius

    def resize(self, width: int, height: int) -> None:
        self._aspect = width / height

    def camera(self) -> R.Camera:
        return R.make_camera(self.camera_cfg, self._aspect, **self._orbit,
                             device=self.device)

    # --- light panel (globe.rs:491-545) ---
    def set_light(self, position=None, ks=None, shininess=None,
                  compute_specular=None) -> None:
        upd = {}
        if position is not None:
            upd["position"] = tuple(position)
        if ks is not None:
            upd["ks"] = ks
        if shininess is not None:
            upd["shininess"] = shininess
        if compute_specular is not None:
            upd["compute_specular"] = compute_specular
        self.light = dataclasses.replace(self.light, **upd)

    @staticmethod
    def _to_image(fb: R.Framebuffer) -> np.ndarray:
        return torch.clamp(fb.color, 0.0, 1.0).cpu().numpy()


def _texture(name: str, texture, device) -> torch.Tensor:
    """``texture`` on ``device``, or the named asset when it is None."""
    return (T.get(name, device=device) if texture is None
            else texture.to(device))


class CubeScene(_SceneBase):
    """Sim 1: indexed draw of a per-face colored cube (cube_app.rs:156-296)."""

    def __init__(self, camera_cfg=cfg.CameraConfig(radius=5.0, phi=0.5, theta=0.7),
                 light=cfg.LightConfig(), aspect=800 / 600, device="cuda"):
        super().__init__(camera_cfg, light, aspect, device)
        self.mesh = R.DeviceMesh.from_host(R.geometry.cube_mesh(1.0),
                                           device=self.device)

    def update(self, delta_time: Optional[float] = None) -> None:
        self.clock.tick()

    def render(self, height: int = 600, width: int = 800) -> np.ndarray:
        fb = R.clear(height, width, device=self.device)
        fb = R.draw_mesh(fb, self.camera(), self.mesh, mode="color")
        return self._to_image(fb)


class TexturedCubeScene(_SceneBase):
    """Sim 2: textured cube with clamped diffuse shading
    (textured_cube_app.rs:111-369, cube_textured_shader.wgsl:59-76)."""

    def __init__(self, texture: Optional[torch.Tensor] = None,
                 camera_cfg=cfg.CameraConfig(radius=5.0, phi=0.5, theta=0.7),
                 light=cfg.LightConfig(), aspect=800 / 600, device="cuda"):
        super().__init__(camera_cfg, light, aspect, device)
        self.mesh = R.DeviceMesh.from_host(R.geometry.cube_mesh(1.0),
                                           device=self.device)
        self.texture = _texture("texture", texture, self.device)

    def update(self, delta_time: Optional[float] = None) -> None:
        self.clock.tick()

    def render(self, height: int = 600, width: int = 800) -> np.ndarray:
        fb = R.clear(height, width, device=self.device)
        fb = R.draw_mesh(fb, self.camera(), self.mesh, texture=self.texture,
                         mode="diffuse", light=self.light)
        return self._to_image(fb)


class GlobeScene(_SceneBase):
    """Sim 3: lit, textured UV sphere with Phong specular and a light
    control panel (globe.rs:85-562). Renders analytically (an exact
    sphere) by default; ``use_mesh=True`` rasterizes the tessellated mesh
    like the reference (16,128 triangles at the default 64 × 128)."""

    def __init__(self, config=cfg.GlobeConfig(), texture=None,
                 camera_cfg=cfg.CameraConfig(), light=cfg.LightConfig(),
                 aspect=800 / 600, use_mesh: bool = False, device="cuda"):
        super().__init__(camera_cfg, light, aspect, device)
        self.config = config
        self.texture = _texture("moon1024", texture, self.device)
        self.use_mesh = use_mesh
        self.mesh = R.DeviceMesh.from_host(R.geometry.generate_uv_sphere(
            config.radius, config.stack_count, config.sector_count),
            device=self.device)

    def update(self, delta_time: Optional[float] = None) -> None:
        self.clock.tick()

    def render(self, height: int = 600, width: int = 800) -> np.ndarray:
        fb = R.clear(height, width, device=self.device)
        cam = self.camera()
        if self.use_mesh:
            fb = R.draw_mesh(fb, cam, self.mesh, texture=self.texture,
                             mode="phong", light=self.light)
        else:
            fb = R.draw_globe(fb, cam, self.config.radius, self.texture,
                              self.light)
        return self._to_image(fb)


class FreeParticleScene(_SceneBase):
    """Sim 4: N textured spheres bouncing in a wireframe box, with the
    physics sliders (instance.rs:169-1017). The initial velocities come
    from a ``torch.Generator`` seeded with ``seed``. Its default frame,
    600×800, is not a multiple of (16, 128), so the spheres go through the
    untiled raster (K4)."""

    def __init__(self, config=cfg.FreeParticleConfig(), texture=None,
                 camera_cfg=cfg.CameraConfig(radius=40.0, phi=0.3, theta=0.3),
                 light=cfg.LightConfig(), aspect=800 / 600, seed: int = 0,
                 device="cuda"):
        super().__init__(camera_cfg, light, aspect, device)
        self.config = config
        self.params = ParticleParams.from_config(config, device=self.device)
        self.state = particles.init_state(
            config, torch.Generator().manual_seed(seed), device=self.device)
        self.texture = _texture("moon1024", texture, self.device)
        self.time_scale = config.time_scale

    def _f32(self, v) -> torch.Tensor:
        return torch.tensor(v, dtype=torch.float32, device=self.device)

    # --- egui sliders (instance.rs:924-981) ---
    def set_gravity(self, g) -> None:
        self.params = self.params._replace(gravity=self._f32(g))

    def set_bounds(self, b: float) -> None:
        self.params = self.params._replace(bounds=self._f32(b))

    def set_radius(self, r: float) -> None:
        self.params = self.params._replace(radius=self._f32(r))

    def set_time_scale(self, s: float) -> None:
        self.time_scale = s

    def update(self, delta_time: Optional[float] = None) -> None:
        dt = self.clock.tick()
        if delta_time is not None:
            dt = delta_time
        with span("scene.update"):
            self.state = particles.multi_step(
                self.state, self.params, self.time_scale * dt, 1,
                bug_compat=self.config.bug_compat)

    def simulate(self, seconds: float, hz: float = 60.0) -> None:
        """Run physics headless at a fixed rate in one call."""
        n = max(1, int(round(seconds * hz)))
        with span("scene.simulate"):
            self.state = particles.multi_step(
                self.state, self.params, self.time_scale / hz, n,
                bug_compat=self.config.bug_compat)

    def render(self, height: int = 600, width: int = 800) -> np.ndarray:
        fb = R.clear(height, width, device=self.device)
        cam = self.camera()
        segs = R.geometry.wireframe_box(
            float(self.params.bounds)).reshape(-1, 2, 3)
        fb = R.draw_lines(fb, cam, segs, color=(0.0, 0.0, 1.0))
        fb = R.draw_instanced_spheres(
            fb, cam, self.state.pos.T, float(self.params.radius), self.light,
            flat_color=None, texture=self.texture)
        return self._to_image(fb)


class ClothScene(_SceneBase):
    """Sim 5 flagship: mass-spring cloth over the lit, textured globe
    (ClothSimApp, cloth.rs:229-1502) with the egui panel's runtime
    parameters and the substep schedule of App::update (cloth.rs:1458-1493).

    ``use_kernel=True`` steps with ``ops.cloth_kernel.multi_step`` (the
    CUDA kernel on a CUDA device, its plain version on the CPU);
    ``use_kernel=False`` with the stencil path ``models.cloth.multi_step``.
    ``self_collide=True`` adds cloth-cloth contact (BASELINE configs[3], an
    extension over the reference, which lets the cloth pass through
    itself): ``models.cloth.multi_step_self_collide`` with the broad phase
    frozen for 8 substeps, the pair forces from the granular contact
    kernel K11 and the cloth substep with a force plane K1f, on a grid
    with a skin of 2·particle_radius and a slab of
    :data:`SELF_COLLIDE_SLAB`.
    """

    def __init__(self, config=cfg.ClothConfig(), globe_texture=None,
                 particle_color=(1.0, 0.0, 0.0),
                 camera_cfg=cfg.CameraConfig(), light=cfg.LightConfig(),
                 aspect=1200 / 800, use_kernel: bool = True,
                 self_collide: bool = False, device="cuda"):
        super().__init__(camera_cfg, light, aspect, device)
        self.config = config
        self.params = ClothParams.from_config(config, device=self.device)
        self.state = init_cloth_state(config, device=self.device)
        self.globe_texture = (T.get("mesh", device=self.device)
                              if globe_texture is None
                              else globe_texture.to(self.device))
        self.particle_color = particle_color
        self.time_scale = config.time_scale
        self.use_kernel = use_kernel
        self.self_collide = self_collide
        self._sc_grid = cloth.default_self_collision_grid(
            config, skin=2.0 * config.particle_radius)

    def _f32(self, v: float) -> torch.Tensor:
        return torch.tensor(v, dtype=torch.float32, device=self.device)

    # --- egui sliders (cloth.rs:1409-1435) ---
    def set_gravity(self, g: float) -> None:
        self.params = self.params._replace(gravity=self._f32(g))

    def set_time_scale(self, s: float) -> None:
        self.time_scale = s

    def set_speed_damp(self, d: float) -> None:
        self.params = self.params._replace(speed_damp=self._f32(d))

    def set_particle_radius(self, r: float) -> None:
        """The radius slider RESETS the cloth in the reference (it rewrites
        the whole instance buffer — cloth.rs:1427-1435); reproduced here."""
        self.params = self.params._replace(particle_radius=self._f32(r))
        self.state = init_cloth_state(self.config, device=self.device)

    def pin(self, mask) -> None:
        """Fixed-pin extension: pin particles where ``mask`` is True at
        their current positions."""
        self.state = self.state._replace(
            pin_mask=torch.as_tensor(mask, dtype=torch.bool,
                                     device=self.device),
            pin_pos=self.state.pos)

    def _stepper(self):
        if self.self_collide:
            return functools.partial(cloth.multi_step_self_collide,
                                     grid_spec=self._sc_grid,
                                     rebuild_every=8,
                                     pallas_slab=SELF_COLLIDE_SLAB)
        return cloth_kernel.multi_step if self.use_kernel else cloth.multi_step

    def update(self, delta_time: Optional[float] = None) -> None:
        dt = self.clock.tick()
        if delta_time is not None:
            dt = delta_time
        n, sub_dt = cloth.frame_substeps(dt, self.time_scale, self.config.hz,
                                         self.config.max_substeps)
        with span("scene.update"):
            self.state = self._stepper()(self.state, self.params, sub_dt, n)

    def simulate(self, seconds: float, hz: Optional[float] = None) -> None:
        """Run physics headless (no frame pacing) in one call."""
        hz = self.config.hz if hz is None else hz
        n = int(round(seconds * hz))
        with span("scene.simulate"):
            step = self._stepper()
            self.state = step(self.state, self.params, 1.0 / hz, n)

    def render(self, height: int = 800, width: int = 1200) -> np.ndarray:
        fb = R.clear(height, width, device=self.device)
        cam = self.camera()
        fb = R.draw_globe(fb, cam, float(self.params.globe_radius),
                          self.globe_texture, self.light)
        centers = self.state.pos.reshape(3, -1).T
        fb = R.draw_instanced_spheres(
            fb, cam, centers, float(self.params.particle_radius),
            flat_color=self.particle_color)
        return self._to_image(fb)

    @property
    def instance_count(self) -> int:  # egui label (cloth.rs:1448)
        return self.config.num_particles

    @property
    def spring_count(self) -> int:
        """egui "springs" info label (cloth.rs:1438-1448)."""
        from ..core import topology

        return sum(topology.spring_counts(self.config.height,
                                          self.config.width))


class GranularScene(_SceneBase):
    """Granular pile: the free-particle box (sim 4) scaled to up to millions
    of spheres with particle-particle contact through the sorted-grid broad
    phase and the granular kernel K10 (BASELINE configs[2]); the
    counterpart of the JAX package's ``GranularScene``.

    Geometry lives in the static :class:`granular.GranularConfig` (radius
    and bounds shape the broad-phase grid; :meth:`reconfigure` replaces
    them). The material constants (``k_contact``, ``gravity``,
    ``restitution``) are 0-d device tensors riding the kernel's parameter
    vector, so their setters rebuild nothing. The jitter of the initial
    pile comes from a ``torch.Generator`` seeded with ``seed``."""

    def __init__(self, config=None, camera_cfg=None,
                 light=cfg.LightConfig(), aspect=800 / 600, seed: int = 0,
                 device="cuda"):
        config = config or granular.GranularConfig(num_particles=20_000)
        camera_cfg = camera_cfg or cfg.CameraConfig(
            radius=3.2 * config.bounds, phi=0.35, theta=0.4)
        super().__init__(camera_cfg, light, aspect, device)
        self.config = config
        self.state = granular.init_state(
            config, torch.Generator().manual_seed(seed), device=self.device)
        self.k_contact = self._f32(config.k_contact)
        self.gravity = self._f32(config.gravity)
        self.restitution = self._f32(config.restitution)
        self.time_scale = 1.0
        self.hz = 240.0
        self.max_substeps = 8         # the substep clamp of a frame
        self.dropped = 0              # broad-phase overflow telemetry

    def _f32(self, v: float) -> torch.Tensor:
        return torch.tensor(v, dtype=torch.float32, device=self.device)

    # --- egui sliders (device tensors: nothing is rebuilt) ---
    def set_gravity(self, g: float) -> None:
        self.gravity = self._f32(g)

    def set_k_contact(self, k: float) -> None:
        self.k_contact = self._f32(k)

    def set_restitution(self, e: float) -> None:
        self.restitution = self._f32(e)

    @property
    def params(self):
        """Viewer-facing material view (``.gravity``, ``.k_contact``,
        ``.restitution``)."""
        import types

        return types.SimpleNamespace(gravity=self.gravity,
                                     k_contact=self.k_contact,
                                     restitution=self.restitution)

    def set_time_scale(self, s: float) -> None:
        self.time_scale = s

    def reconfigure(self, **changes) -> None:
        """Replace static physics config (resets nothing). Material keys go
        to the runtime tensors."""
        for key, setter in (("k_contact", self.set_k_contact),
                            ("gravity", self.set_gravity),
                            ("restitution", self.set_restitution)):
            if key in changes:
                setter(changes.pop(key))
        if changes:
            self.config = dataclasses.replace(self.config, **changes)

    def _advance(self, n: int) -> None:
        self.state, d = granular.multi_step(
            self.state, self.config, 1.0 / self.hz, n, return_stats=True,
            k_contact=self.k_contact, gravity=self.gravity,
            restitution=self.restitution)
        self.dropped = max(self.dropped, int(d))

    def update(self, delta_time: Optional[float] = None) -> None:
        dt = self.clock.tick()
        if delta_time is not None:
            dt = delta_time
        n = int(round(self.time_scale * dt * self.hz))
        with span("scene.update"):
            self._advance(min(max(n, 1), self.max_substeps))

    def simulate(self, seconds: float, hz: Optional[float] = None) -> None:
        """Run physics headless in one call (no substep clamp)."""
        if hz is not None:
            self.hz = hz
        with span("scene.simulate"):
            self._advance(max(1, int(round(seconds * self.hz))))

    def render(self, height: int = 600, width: int = 800) -> np.ndarray:
        fb = R.clear(height, width, device=self.device)
        cam = self.camera()
        segs = R.geometry.wireframe_box(
            float(self.config.bounds)).reshape(-1, 2, 3)
        fb = R.draw_lines(fb, cam, segs, color=(0.0, 0.0, 1.0))
        fb = R.draw_instanced_spheres(
            fb, cam, self.state.pos.T, float(self.config.radius),
            flat_color=(0.86, 0.65, 0.35))      # sand
        return self._to_image(fb)

    @property
    def instance_count(self) -> int:
        return self.config.num_particles
