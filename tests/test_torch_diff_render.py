"""Port parity, the differentiable render: ``torch.autograd`` through the
port's renderer (and, for pixels → gravity, through
``models.cloth.multi_step_diff``) against ``jax.grad`` through the JAX
package's, on the same inputs (CPU; the five render tests of
``tests/test_diff_render.py``, each with its own assertions kept).

Tolerances (measured on these inputs: the light 3.5e-7 relative, the
radius and the pole gradients equal to the printed digits, the instanced
centres 9.4e-5 on a largest 1.44e-2, the light through the spheres 3.4e-4
of its largest):

* the globe's light, radius and centre gradients: 1e-4 relative;
* the instanced spheres' loss 1e-6 relative; the centre gradients within
  1% of the largest JAX centre gradient (a pixel near a silhouette is
  ill-conditioned in t = b - sqrt(b² - c), and the two packages round b
  apart); the light gradient within 1e-3 of its largest;
* pixels → gravity: the derivative at both sides of the basin within 1e-2
  relative of JAX's, and with JAX's signs.
"""

import dataclasses
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wgpu_physics_engine_tpu.core import config as jcfg
from wgpu_physics_engine_tpu.render import camera as jcam
from wgpu_physics_engine_tpu.render import raster as jraster
from wgpu_physics_engine_tpu.render import texture as jtex
from wgpu_physics_engine_torch.core import config as tcfg
from wgpu_physics_engine_torch.render import camera as tcam
from wgpu_physics_engine_torch.render import raster as traster
from wgpu_physics_engine_torch.render import texture as ttex

H, W = 32, 48
LIGHT = (25.0, 18.0, 12.0)


def _t(x, grad=False):
    return torch.tensor(np.asarray(x, np.float32), requires_grad=grad)


def _grad(fn, *args):
    """Value and ``torch.autograd`` gradients of ``fn`` at ``args``."""
    leaves = [_t(a, True) for a in args]
    val = fn(*leaves)
    return float(val.detach()), [g.numpy() for g in
                                 torch.autograd.grad(val, leaves)]


def _jglobe(light_pos, radius=10.0):
    light = dataclasses.replace(jcfg.LightConfig(), position=light_pos)
    fb = jraster.draw_globe(jraster.clear(H, W), jcam.make_camera(
        jcfg.CameraConfig(), aspect=W / H), radius, jtex.earth_gradient(32),
        light)
    return fb.color


def _tglobe(light_pos, radius=10.0):
    light = dataclasses.replace(tcfg.LightConfig(), position=light_pos)
    fb = traster.draw_globe(traster.clear(H, W), tcam.make_camera(
        tcfg.CameraConfig(), aspect=W / H), radius, ttex.earth_gradient(32),
        light)
    return fb.color


def test_globe_light_grad_matches_finite_difference_and_jax():
    target = _tglobe(torch.tensor(LIGHT))

    def loss(p):
        return torch.mean((_tglobe(p) - target) ** 2)

    p0 = np.array([10.0, 30.0, -5.0], np.float32)
    _, (g,) = _grad(loss, p0)
    assert np.isfinite(g).all()
    eps = 1e-2
    with torch.no_grad():
        for j in range(3):
            e = np.zeros(3, np.float32)
            e[j] = eps
            fd = (float(loss(_t(p0 + e))) - float(loss(_t(p0 - e)))) / (2 * eps)
            # shading is smooth in the light position
            assert abs(g[j] - fd) < 5e-2 * max(abs(fd), 1e-6)
    jt = jax.jit(_jglobe)(jnp.asarray(LIGHT))
    gj = jax.jit(jax.grad(lambda p: jnp.mean((_jglobe(p) - jt) ** 2)))(
        jnp.asarray(p0))
    np.testing.assert_allclose(g, np.asarray(gj), rtol=1e-4)


def test_globe_radius_grad_finite_signed_and_matches_jax():
    """Radius moves the silhouette (a nondifferentiable boundary) and the
    interior shading/UV (smooth): the gradient is finite, growing the globe
    toward a larger target lowers the loss, and it equals JAX's."""
    target = _tglobe(tcfg.LightConfig().position, torch.tensor(11.0))
    _, (g,) = _grad(lambda r: torch.mean(
        (_tglobe(tcfg.LightConfig().position, r) - target) ** 2), 10.0)
    assert np.isfinite(g) and float(g) < 0.0
    jt = jax.jit(_jglobe)(jnp.asarray(jcfg.LightConfig().position),
                          jnp.float32(11.0))
    gj = jax.jit(jax.grad(lambda r: jnp.mean(
        (_jglobe(jnp.asarray(jcfg.LightConfig().position), r) - jt) ** 2)))(
        jnp.float32(10.0))
    np.testing.assert_allclose(float(g), float(gj), rtol=1e-4)


@pytest.mark.parametrize("hw", [(32, 48), (32, 128)])
def test_instanced_spheres_grads_no_nan_with_background(hw):
    """Most rays MISS (the sqrt(max(disc, 0)) NaN trap): every gradient —
    centres, light — comes back finite and the centre gradients are
    nonzero in lit mode, on the untiled route (32×48) and the tile-binned
    route (32×128), both the nearest-hit search plus the recompute of the
    winner's hit; and they equal JAX's plain route's."""
    h, w = hw
    centers = np.asarray(jax.random.uniform(jax.random.PRNGKey(0), (40, 3),
                                            minval=-4.0, maxval=4.0))

    def tloss(cen, lp):
        light = dataclasses.replace(tcfg.LightConfig(), position=lp)
        fb = traster.draw_instanced_spheres(
            traster.clear(h, w), tcam.make_camera(tcfg.CameraConfig(),
                                                  aspect=w / h),
            cen, 0.8, light, lit=True)
        return torch.mean(fb.color ** 2) + torch.mean(fb.depth)

    def jloss(cen, lp):
        light = dataclasses.replace(jcfg.LightConfig(), position=lp)
        fb = jraster.draw_instanced_spheres(
            jraster.clear(h, w), jcam.make_camera(jcfg.CameraConfig(),
                                                  aspect=w / h),
            cen, 0.8, light, lit=True, use_kernel=False)
        return jnp.mean(fb.color ** 2) + jnp.mean(fb.depth)

    val, (g_cen, g_lp) = _grad(tloss, centers, LIGHT)
    assert np.isfinite(g_cen).all() and np.isfinite(g_lp).all()
    assert np.abs(g_cen).max() > 0.0
    jval, (jg_cen, jg_lp) = jax.jit(jax.value_and_grad(jloss,
                                                       argnums=(0, 1)))(
        jnp.asarray(centers), jnp.asarray(LIGHT))
    assert abs(val - float(jval)) <= 1e-6 * abs(float(jval))
    jg_cen, jg_lp = np.asarray(jg_cen), np.asarray(jg_lp)
    np.testing.assert_allclose(g_cen, jg_cen, rtol=0,
                               atol=1e-2 * np.abs(jg_cen).max())
    np.testing.assert_allclose(g_lp, jg_lp, rtol=0,
                               atol=1e-3 * np.abs(jg_lp).max())


def test_textured_globe_grad_finite_at_poles():
    """The UV parametrization's asin/atan2 pole guards: a camera looking
    straight down the polar axis renders the pole pixel; the gradients with
    respect to the globe's centre stay finite and equal JAX's."""
    tc = tcam.make_camera(tcfg.CameraConfig(), aspect=1.0, phi=1.5707963)
    jc = jcam.make_camera(jcfg.CameraConfig(), aspect=1.0, phi=1.5707963)
    _, (g,) = _grad(lambda c: torch.mean(traster.draw_globe(
        traster.clear(24, 24), tc, 10.0, ttex.checkerboard(4, 16),
        tcfg.LightConfig(), center=c).color), np.zeros(3))
    assert np.isfinite(g).all()
    gj = jax.jit(jax.grad(lambda c: jnp.mean(jraster.draw_globe(
        jraster.clear(24, 24), jc, 10.0, jtex.checkerboard(4, 16),
        jcfg.LightConfig(), center=c).color)))(jnp.zeros(3))
    np.testing.assert_allclose(g, np.asarray(gj), rtol=1e-4)


def _jax_example(monkeypatch):
    """The JAX package's ``examples/inverse_rendering.py``, loaded by path
    under a name of its own; ``sys.path`` (which the script extends) is
    restored after the test."""
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
    monkeypatch.syspath_prepend(root)
    spec = importlib.util.spec_from_file_location(
        "_jax_inverse_rendering",
        os.path.join(root, "examples", "inverse_rendering.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_pixels_to_gravity_derivative_sign(monkeypatch):
    """End to end pixels → physics: d(image MSE)/d(gravity) through the
    renderer and the differentiable simulator points toward the true
    gravity from both sides of the basin, as JAX's does."""
    jir = _jax_example(monkeypatch)
    import wgpu_physics_engine_tpu as eng
    from wgpu_physics_engine_tpu.models import cloth as jcloth
    from wgpu_physics_engine_torch.core.state import (ClothParams,
                                                      init_cloth_state)
    from wgpu_physics_engine_torch.examples import inverse_rendering as tir

    c = tcfg.ClothConfig(height=12, width=12)
    params = ClothParams.from_config(c, device="cpu")
    state0 = init_cloth_state(c, device="cpu")
    dt = torch.tensor(1.0 / 480.0)

    def frame(g):
        return tir.gravity_frame(state0, params, g, dt, n_steps=64,
                                 segment=32, h=28, w=32)

    with torch.no_grad():
        target = frame(torch.tensor(-22.5))
    (l_hi, (d_hi,)), (l_lo, (d_lo,)) = (
        _grad(lambda g: torch.mean((frame(g) - target) ** 2), g0)
        for g0 in (-18.0, -27.0))
    assert np.isfinite(d_hi) and np.isfinite(d_lo)
    assert l_hi > 0 and l_lo > 0
    assert float(d_hi) > 0          # above the truth: the loss rises with g
    assert float(d_lo) < 0          # below the truth: it falls with g

    jc = eng.ClothConfig(height=12, width=12)
    jp = eng.ClothParams.from_config(jc)
    js0 = eng.init_cloth_state(jc)

    def jframe(g):
        out = jcloth.multi_step_diff(js0, jp._replace(gravity=g),
                                     jnp.float32(1 / 480), 64, segment=32)
        return jir._cloth_image(out, h=28, w=32)

    jt = jax.jit(jframe)(jnp.float32(-22.5))
    vg = jax.jit(jax.value_and_grad(lambda g: jnp.mean((jframe(g) - jt) ** 2)))
    for g0, d in ((-18.0, d_hi), (-27.0, d_lo)):
        _, jd = vg(jnp.float32(g0))
        np.testing.assert_allclose(float(d), float(jd), rtol=1e-2)


def _sphere_scene(n_worlds, h, w, seed=0):
    rng = np.random.default_rng(seed)
    centers = rng.uniform(-4.0, 4.0, (n_worlds, 40, 3)).astype(np.float32)
    theta = torch.tensor(rng.uniform(0, 6.28, n_worlds), dtype=torch.float32)
    cams = tcam.make_camera(tcfg.CameraConfig(), aspect=w / h,
                            theta=theta, phi=torch.full((n_worlds,), 0.3),
                            radius=torch.full((n_worlds,), 20.0))
    return centers, cams


@pytest.mark.parametrize("hw", [(32, 48), (32, 128)])
def test_instanced_spheres_forward_bits_unchanged_under_grad(hw):
    """The recompute of the winner's hit changes no bit of the frame: the
    same frame with and without a gradient to carry."""
    h, w = hw
    centers, cams = _sphere_scene(1, h, w)
    cam = tcam.Camera(*(a[0] for a in cams))
    cen = torch.tensor(centers[0])
    for lit in (False, True):
        ref = traster.draw_instanced_spheres(
            traster.clear(h, w), cam, cen, 0.8, tcfg.LightConfig(), lit=lit)
        got = traster.draw_instanced_spheres(
            traster.clear(h, w), cam, cen.clone().requires_grad_(True), 0.8,
            tcfg.LightConfig(), lit=lit)
        assert torch.equal(got.color.detach(), ref.color)
        assert torch.equal(got.depth.detach(), ref.depth)


def test_batched_instanced_spheres_grads_equal_per_world():
    """A batch of worlds (one binning pass, one raster call) carries each
    world's gradient as the world rendered alone does."""
    h, w = 32, 128
    centers, cams = _sphere_scene(3, h, w, seed=1)

    def loss(cen, lit, b=None):
        if b is None:
            fb = traster.draw_instanced_spheres(
                traster.clear(h, w, n_worlds=3), cams, cen, 0.8,
                tcfg.LightConfig(), lit=lit)
        else:
            fb = traster.draw_instanced_spheres(
                traster.clear(h, w), tcam.Camera(*(a[b] for a in cams)),
                cen, 0.8, tcfg.LightConfig(), lit=lit)
        return torch.sum(fb.color ** 2) + torch.sum(fb.depth)

    for lit in (False, True):
        _, (g,) = _grad(lambda c: loss(c, lit), centers)
        assert np.abs(g).max() > 0
        for b in range(3):
            _, (gb,) = _grad(lambda c: loss(c, lit, b), centers[b])
            np.testing.assert_allclose(g[b], gb, rtol=1e-6, atol=1e-7)
