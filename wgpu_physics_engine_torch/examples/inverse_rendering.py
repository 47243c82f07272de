"""Inverse rendering: the port of ``examples/inverse_rendering.py``.
Gradients from PIXELS back to scene and physics parameters.

The renderer is differentiable (``render.raster``: gradient-safe square
roots and pole-safe UVs; on the card the nearest-hit kernels' winners get
their gradient from a torch recompute of the hit), so ``torch.autograd``
flows from an image loss back through shading and sphere intersection
and, composed with the differentiable simulator
(``models.cloth.multi_step_diff``), through the PHYSICS to gravity:

  stage 1: recover the Phong light position from a rendered globe
           (pixel MSE, gradient descent with backtracking);
  stage 2: recover GRAVITY from one rendered frame of the falling cloth,
           loss(g) = || render(simulate(g)) − target ||²; the gradient
           crosses the renderer (lit instanced spheres) and 240 physics
           substeps. On the card the 48×64 frame of 256 spheres takes the
           untiled raster K4, the physics the cloth kernel K1 forward and
           the substep adjoint of ``ops/csrc/cloth_grad.cu`` backward; on
           the CPU their plain versions.

    python -m wgpu_physics_engine_torch.examples.inverse_rendering \\
        [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import dataclasses
import math

import torch

from ..core import config as cfg
from ..core.state import ClothParams, init_cloth_state
from ..models import cloth
from ..render import camera as cam
from ..render import raster, texture

TRUE_LIGHT = (25.0, 18.0, 12.0)
G_TRUE = -22.5                              # off any scan grid point


def _globe_image(light_pos: torch.Tensor, h: int = 48, w: int = 64
                 ) -> torch.Tensor:
    dev = light_pos.device
    camera = cam.make_camera(cfg.CameraConfig(), aspect=w / h, device=dev)
    light = dataclasses.replace(cfg.LightConfig(), position=light_pos)
    fb = raster.clear(h, w, device=dev)
    tex = texture.earth_gradient(64, device=dev)
    fb = raster.draw_globe(fb, camera, 10.0, tex, light)
    return fb.color


def recover_light(n_iters: int = 60, device="cuda") -> float:
    """Shading observes the light's direction (and weakly its distance),
    so the unknown is (azimuth, elevation) on the true radius: a
    well-posed 2-parameter inverse problem with an exact optimum. Returns
    the recovered direction's error in degrees."""
    device = torch.device(device)
    true_pos = torch.tensor(TRUE_LIGHT, dtype=torch.float32, device=device)
    radius = torch.linalg.norm(true_pos)
    target = _globe_image(true_pos)

    def pos(angles):
        th, ph = angles[0], angles[1]
        return radius * torch.stack([torch.cos(ph) * torch.cos(th),
                                     torch.sin(ph),
                                     torch.cos(ph) * torch.sin(th)])

    def loss(angles):
        return torch.mean((_globe_image(pos(angles)) - target) ** 2)

    def value_and_grad(angles):
        a = angles.detach().requires_grad_(True)
        val = loss(a)
        (g,) = torch.autograd.grad(val, a)
        return val.detach(), g

    def err_deg(angles) -> float:
        with torch.no_grad():
            u = pos(angles) / radius
            t = true_pos / radius
            return math.degrees(math.acos(
                max(-1.0, min(1.0, float(torch.dot(u, t))))))

    a = torch.tensor([1.4, 1.1], dtype=torch.float32, device=device)  # ~45°
    a0 = a
    lr = 20.0
    val, g = value_and_grad(a)
    for i in range(n_iters):
        # backtracking: halve the step until the pixel loss decreases
        with torch.no_grad():
            for _ in range(8):
                a_try = a - lr * g
                l_try = loss(a_try)
                if float(l_try) < float(val):
                    break
                lr *= 0.5
        a = a_try
        val, g = value_and_grad(a)
        lr *= 1.3
        if i % 12 == 0:
            print(f"  light iter {i:2d}: loss {float(val):.3e}  "
                  f"direction error {err_deg(a):6.2f} deg")
    err = err_deg(a)
    print(f"  recovered direction error {err:.2f} deg "
          f"(started at {err_deg(a0):.2f})")
    return err


def _cloth_image(state, h: int = 48, w: int = 64) -> torch.Tensor:
    """The lit spheres of the cloth seen from a camera aimed at the falling
    sheet (it spawns at y = 40, far above the globe). Lit, because pixel
    shading then varies smoothly with the particle positions (flat shading
    would have zero interior gradient, coverage only)."""
    dev = state.pos.device
    camera = cam.make_camera(cfg.CameraConfig(target=(0.0, 36.0, 0.0),
                                              radius=30.0), aspect=w / h,
                             device=dev)
    centers = state.pos.reshape(3, -1).T
    fb = raster.clear(h, w, device=dev)
    fb = raster.draw_instanced_spheres(fb, camera, centers, 0.6,
                                       cfg.LightConfig(), lit=True)
    return fb.color


def gravity_frame(state0, params: ClothParams, g: torch.Tensor, dt,
                  n_steps: int = 240, segment: int = 48, h: int = 48,
                  w: int = 64) -> torch.Tensor:
    """The rendered frame after ``n_steps`` substeps under gravity ``g``
    (a 0-d tensor), differentiable in ``g``."""
    out = cloth.multi_step_diff(state0, params._replace(gravity=g), dt,
                                n_steps, segment=segment)
    return _cloth_image(out, h, w)


def recover_gravity(n_bisect: int = 14, device="cuda"):
    """Pixel losses over physics rollouts are nonconvex with a narrow
    basin, so bracket with a coarse forward scan, then drive the
    pixel-loss DERIVATIVE to zero by bisection: every refinement consumes
    d(image MSE)/d(gravity) computed end to end through the renderer and
    240 physics substeps. Returns (recovered, true) gravity."""
    device = torch.device(device)
    c = cfg.ClothConfig(height=16, width=16)
    params = ClothParams.from_config(c, device=device)
    state0 = init_cloth_state(c, device=device)
    dt = torch.tensor(1.0 / 480.0, dtype=torch.float32, device=device)

    def f32(v):
        return torch.tensor(v, dtype=torch.float32, device=device)

    with torch.no_grad():
        target = gravity_frame(state0, params, f32(G_TRUE), dt)

    def loss(g):
        return torch.mean((gravity_frame(state0, params, g, dt) - target) ** 2)

    # coarse bracket from forward evaluations only
    grid = [-5.0, -12.5, -20.0, -27.5, -35.0]
    with torch.no_grad():
        losses = [float(loss(f32(g))) for g in grid]
    i_best = min(range(len(grid)), key=lambda i: losses[i])
    lo, hi = sorted((grid[max(i_best - 1, 0)],
                     grid[min(i_best + 1, len(grid) - 1)]))
    print(f"  scan best g={grid[i_best]} (loss {losses[i_best]:.3e}); "
          f"bisecting dL/dg on [{lo}, {hi}]")
    for i in range(n_bisect):
        mid = 0.5 * (lo + hi)
        g = f32(mid).requires_grad_(True)
        val = loss(g)
        (dg,) = torch.autograd.grad(val, g)
        val = val.detach()
        # the derivative's sign says which side of the basin's minimum
        if float(dg) > 0:
            hi = mid
        else:
            lo = mid
        if i % 4 == 0:
            print(f"  bisect {i:2d}: g {mid:8.4f}  loss {float(val):.3e}  "
                  f"dL/dg {float(dg):+.2e}")
    g = 0.5 * (lo + hi)
    print(f"  recovered gravity {g:.3f} (true {G_TRUE})")
    return g, G_TRUE


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    print("stage 1: light direction from globe pixels")
    err = recover_light(device=args.device)
    print("stage 2: gravity from one rendered cloth frame")
    g, g_true = recover_gravity(device=args.device)
    print(f"  |error| {abs(g - g_true):.4f}")
    return err, g


if __name__ == "__main__":
    main()
