"""The port's CUDA kernels against their plain torch versions, on the card.

Every test here needs a CUDA device and skips without one. The file
imports no jax, so it also runs on a machine without JAX; there, skip the
JAX-importing ``tests/conftest.py``:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

Both kernels are built with ``-fmad=false`` and transcribe their plain
versions op for op, so the exact paths are held to bitwise equality; the
cloth kernel's fast_math path (rsqrt) to 1e-5 after 25 substeps. The
substep adjoint (``csrc/cloth_grad.cu``) is held to its plain version
within 1e-5 max-relative (its parameter cotangents are sums taken in
another order), and ``multi_step_diff`` to the plain path within 1e-4.
The contact kernels K11 and K12 are held to their plain versions within
1e-5 relative (each group's sum in double, rounded once), K11 with the
plain integrate to K10 bit for bit, K1f to its plain version bit for bit
(grid order at 256², 48×40, 61×67 and 2×3; its sorted entry, the next
sorted positions included, to the gather, plain substep and scatter) and,
with a zero force plane, to K1 bit for bit; the granular gradient
path on the card to the CPU plain path within 1e-4. The untiled sphere
raster (K4) is held to its plain version and to the tiled kernel bit for
bit, at 600×800 and 601×799 from 0 to 16,384 instances, on two identical
spheres (the lower id wins) and a sphere behind the camera; the free-particle and mesh frames on the card to their CPU frames
within 1 in u8 on >= 99.9% of pixels (CPU and CUDA libm round
pow/atan2/asin apart by ulps, which a sphere's pole or silhouette
amplifies);
the golden scenes to ``tests/golden/*.png`` (at most 2 in u8 on < 2% of
pixels, ``tests/test_render.py::test_golden_frame``'s tolerance). The
large-grid kernel (K6) is held to its plain version and to K1 bit for bit,
and the route above ``cloth_kernel._TILED_PARTICLE_LIMIT`` to K6r's launch
count (K6 where no resident tiling fits); the resident kernels K6r (one
large world, one cooperative launch a call) and K5r (a batch, one CTA a
world) to their plain versions, K1 and K6 or K5 bit for bit on ragged
shapes, with one launch a call. The row-window kernel (K1w) is held to its plain version and, on a
window's centre rows, to K1 bit for bit, and the rows path on four shards
of one card to K1; its tiled form (K6w) to its plain version and K1w on
whole windows, dead rows included, and to K6 on the centre rows, bit for
bit; the one-launch adjoint's state and pin cotangents to its plain
version bit for bit; the granular kernel with a base (K10b) to the same rows
of K10 bit for bit and to its plain version within K10's 1e-5, and the
grain-sharded pile to the single-device K10 path bit for bit. K11 and K12
on the long windows of a thin self-collision set (several lanes a slot)
are held to their plain versions as at 1M, an undersized slab included;
the tiled raster to the full plain sweep bit for bit on an overloaded
tile, on exact-t ties across chunks and on several worlds in one call,
and its device-built work list to ``raster_kernel.work_list``. The rays
kernel is held to ``camera.pixel_rays_plain`` bit for bit (a camera, a
batch and a batch of two leading axes at 256², 600×800 and 37×61), and
the datagens' uint8 entry (``draw_instanced_spheres_rgb8``: the rays
kernel, the raster, the epilogue kernel) to its plain route,
``draw_instanced_spheres`` and the cast, bit for bit on a 64-world
datagen chunk at 256² and 37×61 in red and in sand, and on a framebuffer
shared by a batch of cameras.
K1 is held to its plain version bit for bit (exact) and to K5 on one world
bit for bit (exact and fast_math) on the flagship's 256², the reference
60×60, a ragged 255×257 and 1000×1030, and its trace to ``trace_plain`` at
256². K10's direct walk (the full set) and its staged walk (the thin set)
are held to their plain versions bit for bit at 1M, in window mode and as
K10b, and K11 with the plain integrate to K10. The window trace (K1w's
body) is held to its plain version and to ``multi_step_window`` bit for
bit, and the window adjoint to its plain version (state, pin and
parameter cotangents bit for bit, the plain version summing the last in
the kernel's order), on the top, a middle and the bottom window of
136×256 and 264×1024 row windows, and on batches of the rows path's
windows (16 of 16×16, 16 of 136×256, 4 of 264×1024; mixed first rows
and pins) against their batched plain versions and against the same calls
a window at a time; the training example's gradient on 8 shards of the
card to 8 CPU shards within 1e-4.
"""

import math
import os

import numpy as np
import pytest
import torch

from wgpu_physics_engine_torch.core import config as cfg
from wgpu_physics_engine_torch.core import state as st
from wgpu_physics_engine_torch.models import scenes
from wgpu_physics_engine_torch.models import cloth
from wgpu_physics_engine_torch.ops import (cloth_grad_kernel, cloth_kernel,
                                           cloth_tiled_kernel, pixel_kernel,
                                           raster_kernel)
from wgpu_physics_engine_torch.render import camera, raster

DT = 1.0 / 480.0


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("hw,pins,fast", [((64, 64), False, False),
                                          ((33, 70), True, False),
                                          ((64, 64), True, True)])
def test_cloth_kernel_matches_plain(dev, hw, pins, fast):
    h, w = hw
    c = cfg.ClothConfig(height=h, width=w)
    s = st.init_cloth_state(c, device=dev)
    rng = np.random.default_rng(7)
    s = s._replace(vel=torch.tensor(
        (0.5 * rng.standard_normal((3, h, w))).astype(np.float32), device=dev))
    if pins:
        mask = torch.zeros((h, w), dtype=torch.bool, device=dev)
        mask[0] = True
        s = s._replace(pin_mask=mask, pin_pos=s.pos)
    p = st.ClothParams.from_config(c, device=dev)
    before = cloth_kernel.LAUNCHES
    got = cloth_kernel.multi_step(s, p, DT, 25, fast_math=fast)
    torch.cuda.synchronize()
    assert cloth_kernel.LAUNCHES == before + 25
    ref = cloth_kernel.multi_step_plain(s, p, DT, 25, fast_math=fast)
    tol = 1e-5 if fast else 0.0
    torch.testing.assert_close(got.pos, ref.pos, atol=tol, rtol=0)
    torch.testing.assert_close(got.vel, ref.vel, atol=10 * tol, rtol=0)


@pytest.mark.cuda
def test_cloth_kernel_leaves_input_and_counts_zero_steps(dev):
    c = cfg.ClothConfig(height=16, width=16)
    s = st.init_cloth_state(c, device=dev)
    p = st.ClothParams.from_config(c, device=dev)
    pos0 = s.pos.clone()
    before = cloth_kernel.LAUNCHES
    assert cloth_kernel.multi_step(s, p, DT, 0) is s
    out = cloth_kernel.multi_step(s, p, DT, 3)
    torch.cuda.synchronize()
    assert cloth_kernel.LAUNCHES == before + 3
    assert torch.equal(s.pos, pos0) and not torch.equal(out.pos, pos0)


def _centers(dev, seed):
    rng = np.random.default_rng(seed)
    g = np.linspace(-4.0, 4.0, 24, dtype=np.float32)
    sheet = np.stack(np.meshgrid(g, g, indexing="ij"), -1).reshape(-1, 2)
    sheet = np.concatenate([sheet, np.zeros((len(sheet), 1), np.float32)], 1)
    pts = np.concatenate([sheet, rng.uniform(-8, 8, (300, 3)),
                          [[0, 0, 39.8], [0, 0, 45.0], [0, 0, 38.5]]])
    return torch.tensor(pts.astype(np.float32), device=dev)


@pytest.mark.cuda
@pytest.mark.parametrize("hw", [(64, 256), (24, 40), (200, 300)])
def test_raster_kernel_matches_plain(dev, hw):
    h, w = hw
    tc = camera.make_camera(cfg.CameraConfig(), aspect=w / h, device=dev)
    _, dirs = camera.pixel_rays(tc, h, w)
    wins, ocb, _, rect = raster_kernel.tiled_prologue(
        tc.view[:3, :3], tc.eye, _centers(dev, 4), 0.3, tc.znear,
        torch.tan(tc.fovy_rad / 2.0), tc.aspect, h, w)
    before = raster_kernel.LAUNCHES
    kt, ki, ko = raster_kernel.sphere_raster_binned(wins, ocb, rect, dirs,
                                                    tc.znear)
    torch.cuda.synchronize()
    assert raster_kernel.LAUNCHES == before + 1
    pt, pi, po = raster_kernel.sphere_raster_plain(ocb, dirs, tc.znear)
    assert int((ki >= 0).sum()) > 20
    assert torch.equal(ki, pi)
    assert torch.equal(kt, pt)
    assert torch.equal(ko, po)


@pytest.mark.cuda
def test_scene_on_cuda_runs_both_kernels(dev):
    c = cfg.ClothConfig(height=32, width=32)
    scene = scenes.ClothScene(c, device=dev)
    scene.resize(160, 64)
    k0, r0 = cloth_kernel.LAUNCHES, raster_kernel.LAUNCHES
    u0 = raster_kernel.LAUNCHES_UNTILED
    scene.simulate(0.5)
    scene.update(1 / 60)
    img = scene.render(64, 160)
    assert cloth_kernel.LAUNCHES - k0 == 240 + 8
    # 1,024 instances on a frame that is not a multiple of (16, 128): the
    # untiled raster (K4), as in the JAX renderer
    assert raster_kernel.LAUNCHES_UNTILED - u0 == 1
    assert raster_kernel.LAUNCHES == r0
    assert img.shape == (64, 160, 3) and np.isfinite(img).all()
    ref = cloth_kernel.multi_step_plain(st.init_cloth_state(c, device=dev),
                                        scene.params, DT, 240)
    ref = cloth_kernel.multi_step_plain(ref, scene.params, 1 / 60 / 8, 8)
    assert torch.equal(scene.state.pos, ref.pos)


# a small cloth of large particles spawned close above the globe, so that
# the randomized datagen cameras (aimed at the origin) see it
VISIBLE = dict(particle_radius=0.8, cloth_size=16.0, center=(0.0, 14.0, 0.0))


def _worlds(dev, n, h, w, seed, contact=False):
    """Randomized worlds of the VISIBLE cloth; with ``contact`` spawned at
    y = 10.5 with no height jitter, so that the middle of every cloth
    starts inside the globe's contact distance (10 + 0.8) and the
    penalty, friction and projection branches run from the first
    substep."""
    from wgpu_physics_engine_torch.parallel import datagen

    over = dict(center=(0.0, 10.5, 0.0)) if contact else {}
    c = cfg.ClothConfig(height=h, width=w, **{**VISIBLE, **over})
    return datagen.randomized_worlds(
        c, n, torch.Generator().manual_seed(seed),
        height_jitter=0.0 if contact else 5.0, device=dev)


@pytest.mark.cuda
@pytest.mark.parametrize("pins,fast,contact", [
    (False, False, False), (True, False, False), (False, True, False),
    (False, False, True), (True, False, True)])
def test_batched_cloth_kernel_matches_plain_and_k1(dev, pins, fast, contact):
    b = _worlds(dev, 5, 12, 20, seed=3, contact=contact)
    s = b.state
    if contact:
        dist = torch.linalg.vector_norm(s.pos, dim=1)
        assert bool((dist < b.params.globe_radius[:, None, None]
                     + b.params.particle_radius[:, None, None]).all(0).any())
    if pins:
        mask = torch.zeros((5, 12, 20), dtype=torch.bool, device=dev)
        mask[:, 0] = True
        s = s._replace(pin_mask=mask, pin_pos=s.pos)
    k1_0, k5_0 = cloth_kernel.LAUNCHES, cloth_kernel.LAUNCHES_BATCHED
    got = cloth_kernel.multi_step(s, b.params, DT, 25, fast_math=fast)
    torch.cuda.synchronize()
    assert cloth_kernel.LAUNCHES_BATCHED == k5_0 + 25
    assert cloth_kernel.LAUNCHES == k1_0
    ref = cloth_kernel.multi_step_plain(s, b.params, DT, 25, fast_math=fast)
    tol = 1e-5 if fast else 0.0
    torch.testing.assert_close(got.pos, ref.pos, atol=tol, rtol=0)
    torch.testing.assert_close(got.vel, ref.vel, atol=10 * tol, rtol=0)
    for i in (0, 2, 4):              # world i is K1 on world i, bit for bit
        one = st.ClothState(
            pos=s.pos[i], vel=s.vel[i],
            pin_mask=None if s.pin_mask is None else s.pin_mask[i],
            pin_pos=None if s.pin_pos is None else s.pin_pos[i])
        k1 = cloth_kernel.multi_step_kernel(
            one, st.ClothParams(*(leaf[i] for leaf in b.params)), DT, 25,
            fast_math=fast)
        assert torch.equal(got.pos[i], k1.pos)
        assert torch.equal(got.vel[i], k1.vel)
    if contact:          # projected onto the globe in the last substep
        assert int((got.vel == 0).all(1)[:, 1:].sum()) > 0


@pytest.mark.cuda
def test_batched_raster_kernel_matches_plain(dev):
    from wgpu_physics_engine_torch.parallel import datagen

    b = _worlds(dev, 4, 16, 16, seed=4)
    cams = datagen.randomized_cameras(4, torch.Generator().manual_seed(5),
                                      device=dev)
    h, w = 48, 200
    eye, dirs = camera.pixel_rays(cams, h, w)
    centers = b.state.pos.reshape(4, 3, -1).transpose(1, 2)
    wins, ocb, _, rect = raster_kernel.tiled_prologue_batched(
        cams.view[:, :3, :3], eye, centers, b.params.particle_radius,
        cams.znear, torch.tan(cams.fovy_rad / 2.0), cams.aspect, h, w)
    before = raster_kernel.LAUNCHES
    kt, ki, ko = raster_kernel.sphere_raster_binned(wins, ocb, rect, dirs,
                                                    cams.znear)
    torch.cuda.synchronize()
    assert raster_kernel.LAUNCHES == before + 1
    pt, pi, po = raster_kernel.sphere_raster_plain(ocb, dirs, cams.znear)
    assert int((ki >= 0).sum()) > 20
    assert torch.equal(ki, pi) and torch.equal(kt, pt) and torch.equal(ko, po)
    for i in range(4):               # the batch equals four one-world launches
        t1, i1, _ = raster_kernel.sphere_raster_kernel(
            wins[i], ocb[i], rect[i], dirs[i], cams.znear[i])
        assert torch.equal(ki[i], i1) and torch.equal(kt[i], t1)


@pytest.mark.cuda
def test_datagen_on_cuda_matches_plain_path(dev):
    from wgpu_physics_engine_torch.parallel import datagen

    c = cfg.ClothConfig(height=12, width=12, **VISIBLE)
    kw = dict(n_worlds=5, n_frames=3, steps_per_frame=8, fb_size=(32, 128),
              randomize_cameras=True, world_chunk=3, device=dev)
    k5_0, r0 = cloth_kernel.LAUNCHES_BATCHED, raster_kernel.LAUNCHES
    e0 = pixel_kernel.LAUNCHES_EPILOGUE
    got = [(f, im) for f, im, _ in datagen.generate_trajectory_dataset(
        c, generator=torch.Generator().manual_seed(2), **kw)]
    assert cloth_kernel.LAUNCHES_BATCHED - k5_0 == 3 * 2 * 8   # frames × chunks
    assert raster_kernel.LAUNCHES - r0 == 3 * 2
    assert pixel_kernel.LAUNCHES_EPILOGUE - e0 == 3 * 2
    # the CPU run of the same draws (a CPU generator either way) takes the
    # plain versions; CPU and CUDA libm round pow/atan2/asin apart by ulps,
    # so a frame agrees within 1 except where a silhouette crosses a pixel
    ref = [(f, im) for f, im, _ in datagen.generate_trajectory_dataset(
        c, generator=torch.Generator().manual_seed(2),
        **{**kw, "device": "cpu"})]
    assert [f for f, _ in got] == [f for f, _ in ref] == [0, 1, 2]
    for (_, a), (_, r) in zip(got, ref):
        assert a.shape == (5, 32, 128, 3) and a.dtype == np.uint8
        d = np.abs(a.astype(np.int16) - r.astype(np.int16)).max(-1)
        assert (d <= 1).mean() >= 0.999, (d <= 1).mean()
        assert (a == [255, 0, 0]).all(-1).sum() > 50


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [None, (4,), (2, 3)])
@pytest.mark.parametrize("hw", [(256, 256), (600, 800), (37, 61)])
def test_pixel_rays_kernel_matches_plain(dev, hw, batch):
    """The rays kernel against ``pixel_rays_plain`` on the card, bit for
    bit: a camera, a batch and a batch with two leading axes, at 256²,
    600×800 and a ragged 37×61 (its scalar tail); a camera carrying a
    gradient takes the plain version."""
    from wgpu_physics_engine_torch.parallel import datagen

    h, w = hw
    if batch is None:
        cam = camera.make_camera(cfg.CameraConfig(radius=30.0, theta=0.7,
                                                  phi=0.4),
                                 aspect=w / h, device=dev)
    else:
        n = int(np.prod(batch))
        cam = datagen.randomized_cameras(
            n, torch.Generator().manual_seed(3), aspect=w / h, device=dev)
        cam = camera.Camera(*(a.reshape(batch + a.shape[1:]) for a in cam))
    before = pixel_kernel.LAUNCHES_RAYS
    eye, got = camera.pixel_rays(cam, h, w)
    torch.cuda.synchronize()
    assert pixel_kernel.LAUNCHES_RAYS == before + 1
    ref_eye, ref = camera.pixel_rays_plain(cam, h, w)
    assert got.shape == ref.shape and torch.equal(eye, ref_eye)
    assert torch.equal(got, ref)
    grad_cam = cam._replace(eye=cam.eye.clone().requires_grad_(True))
    _, plain = camera.pixel_rays(grad_cam, h, w)
    assert pixel_kernel.LAUNCHES_RAYS == before + 1
    assert torch.equal(plain, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("flat", [(1.0, 0.0, 0.0), (0.86, 0.65, 0.35)])
@pytest.mark.parametrize("hw", [(256, 256), (37, 61)])
def test_rgb8_entry_matches_plain_route_on_datagen_chunk(dev, hw, flat):
    """``draw_instanced_spheres_rgb8`` on a 64-world datagen chunk of the
    60×60 cloth draped 3 s over cached globes (hits, misses and hits the
    globe hides all occur) equals its plain route, ``draw_instanced_
    spheres`` and the cast, bit for bit, with one launch of each kernel a
    call, in the cloth datagen's red and the granular datagen's sand
    (three channels apart, none 0 or 1); 37×61 takes the epilogue's
    scalar tail."""
    from wgpu_physics_engine_torch.parallel import datagen

    h, w = hw
    b = datagen.randomized_worlds(cfg.ClothConfig(), 64,
                                  torch.Generator().manual_seed(6),
                                  device=dev)
    state = cloth_kernel.multi_step(b.state, b.params, DT, 1440)
    cams = datagen.randomized_cameras(64, torch.Generator().manual_seed(7),
                                      aspect=w / h, device=dev)
    base = datagen.globe_base_fbs(cams, b.params, datagen.globe_texture(dev),
                                  fb_size=hw)
    centers = state.pos.reshape(64, 3, -1).transpose(1, 2)
    radius = b.params.particle_radius
    rays0, epi0 = pixel_kernel.LAUNCHES_RAYS, pixel_kernel.LAUNCHES_EPILOGUE
    got = raster.draw_instanced_spheres_rgb8(base, cams, centers, radius,
                                             flat_color=flat)
    torch.cuda.synchronize()
    assert (pixel_kernel.LAUNCHES_RAYS - rays0,
            pixel_kernel.LAUNCHES_EPILOGUE - epi0) == (1, 1)
    fb = raster.draw_instanced_spheres(base, cams, centers, radius,
                                       flat_color=flat)
    ref = (torch.clamp(fb.color, 0.0, 1.0) * 255.0 + 0.5).to(torch.uint8)
    assert got.dtype == torch.uint8 and got.shape == (64, h, w, 3)
    assert torch.equal(got, ref)
    eye, dirs = camera.pixel_rays(cams, h, w)
    hit = raster._nearest_hits(cams, eye, dirs, centers, radius)[1] >= 0
    won = hit & (fb.depth < base.depth)
    assert int((~hit).sum()) > 1000 and int(won.sum()) > 1000
    assert int((hit & ~won).sum()) > 0


@pytest.mark.cuda
def test_rgb8_entry_broadcasts_a_shared_framebuffer(dev):
    """A framebuffer ``[H, W]`` shared by a batch of cameras: the uint8
    entry broadcasts it as its plain route does, bit for bit."""
    from wgpu_physics_engine_torch.parallel import datagen

    h, w = 64, 128
    cams = datagen.randomized_cameras(3, torch.Generator().manual_seed(5),
                                      aspect=w / h, device=dev)
    shared = raster.draw_globe(raster.clear(h, w, device=dev),
                               camera.make_camera(aspect=w / h, device=dev),
                               10.0, datagen.globe_texture(dev),
                               cfg.LightConfig())
    rng = np.random.default_rng(4)
    d = rng.standard_normal((3, 400, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    centers = torch.tensor(d * rng.uniform(10.4, 13.0, (3, 400, 1)),
                           dtype=torch.float32, device=dev)
    epi0 = pixel_kernel.LAUNCHES_EPILOGUE
    got = raster.draw_instanced_spheres_rgb8(shared, cams, centers, 0.6)
    assert pixel_kernel.LAUNCHES_EPILOGUE == epi0 + 1
    ref = raster.draw_instanced_spheres_rgb8_plain(shared, cams, centers,
                                                   0.6)
    assert got.shape == ref.shape == (3, h, w, 3)
    assert torch.equal(got, ref)


@pytest.mark.cuda
def test_cli_gif_on_cuda(dev, tmp_path):
    from wgpu_physics_engine_torch.__main__ import main

    k0, r0 = cloth_kernel.LAUNCHES, raster_kernel.LAUNCHES
    u0 = raster_kernel.LAUNCHES_UNTILED
    out = tmp_path / "cloth.gif"
    rc = main(["cloth", "--grid", "16", "--size", "32", "64", "--seconds",
               "0.2", "--fps", "10", "--gif", str(out)])
    assert rc == 0 and out.exists()
    assert cloth_kernel.LAUNCHES - k0 == 2 * 8      # 2 frames of 8 substeps
    # 256 instances on a 32 x 64 frame: the untiled raster (K4)
    assert raster_kernel.LAUNCHES_UNTILED - u0 == 2
    assert raster_kernel.LAUNCHES == r0


def _max_rel(a, b):
    return float((a.double() - b.double()).abs().max()
                 / b.double().abs().max().clamp_min(1e-30))


def _grad_state(dev, h, w, case):
    """A state entering a substep and its pins: in free fall with random
    velocities, draped on the globe (contact, friction and projection run),
    or draped with the top row pinned."""
    c = cfg.ClothConfig(height=h, width=w)
    p = st.ClothParams.from_config(c, device=dev)
    s = st.init_cloth_state(c, device=dev)
    rng = np.random.default_rng(11)
    if case == "free":
        s = s._replace(vel=torch.tensor(
            rng.standard_normal((3, h, w)).astype(np.float32), device=dev))
    else:
        s = cloth_kernel.multi_step(s, p, DT, 1500)
        dist = torch.linalg.vector_norm(s.pos, dim=0)
        assert bool((dist < 10.1).any())
    if case == "pinned":
        mask = torch.zeros((h, w), dtype=torch.bool, device=dev)
        mask[0] = True
        s = s._replace(pin_mask=mask, pin_pos=s.pos)
    return s, p


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["free", "contact", "pinned"])
def test_substep_vjp_kernel_matches_plain(dev, case):
    h, w = 40, 70
    s, p = _grad_state(dev, h, w, case)
    prm = cloth_kernel._pack_params(p, DT)
    planes = torch.cat([s.pos, s.vel])
    rng = np.random.default_rng(12)
    cp, cv = (torch.tensor(rng.standard_normal((3, h, w)).astype(np.float32),
                           device=dev) for _ in range(2))
    pins = None if s.pin_mask is None else (s.pin_mask, s.pin_pos)
    before = cloth_grad_kernel.LAUNCHES
    got = cloth_grad_kernel.substep_vjp(planes, cp, cv, prm, pins)
    torch.cuda.synchronize()
    assert cloth_grad_kernel.LAUNCHES == before + 1
    ref = cloth_grad_kernel.substep_vjp_plain(planes, cp, cv, prm, pins)
    for a, b in zip(got[:3], ref[:3]):
        assert _max_rel(a, b) <= 1e-5
    if pins is not None:
        assert _max_rel(got[3], ref[3]) <= 1e-5
        assert float(got[3].abs().max()) > 0


@pytest.mark.cuda
def test_trace_kernel_equals_forward(dev):
    s, p = _grad_state(dev, 33, 70, "pinned")
    prm = cloth_kernel._pack_params(p, DT)
    before = cloth_kernel.LAUNCHES
    traj = cloth_kernel.trace(s, prm, 9)
    torch.cuda.synchronize()
    assert cloth_kernel.LAUNCHES == before + 8
    out = cloth_kernel.multi_step_kernel(s, p, DT, 8)
    assert torch.equal(traj[8, :3], out.pos) and torch.equal(traj[8, 3:], out.vel)
    assert torch.equal(traj, cloth_kernel.trace_plain(s, prm, 9))


def _linear_loss_grads(state, params, n, segment, dev, wp, wv):
    leaves = [a.detach().clone().requires_grad_(True) for a in params]
    pos = state.pos.detach().clone().requires_grad_(True)
    vel = state.vel.detach().clone().requires_grad_(True)
    dt = torch.tensor(DT, device=dev, requires_grad=True)
    s = state._replace(pos=pos, vel=vel)
    out = cloth.multi_step_diff(s, st.ClothParams(*leaves), dt, n,
                                segment=segment)
    loss = (out.pos * wp).sum() + (out.vel * wv).sum()
    return torch.autograd.grad(loss, [*leaves, pos, vel, dt]), out


@pytest.mark.cuda
def test_multi_step_diff_cuda_matches_cpu_plain(dev):
    """The kernel path on the card against the plain path on the CPU, in
    free fall with random velocities (no contact: the CPU's sqrt rounds
    apart from the card's by an ulp, which could flip a contact test)."""
    h, w = 24, 40
    s, p = _grad_state(dev, h, w, "free")
    rng = np.random.default_rng(13)
    wp, wv = (torch.tensor(rng.standard_normal((3, h, w)).astype(np.float32))
              for _ in range(2))
    k0, g0 = cloth_kernel.LAUNCHES, cloth_grad_kernel.LAUNCHES
    got, out = _linear_loss_grads(s, p, 48, 16, dev, wp.to(dev), wv.to(dev))
    torch.cuda.synchronize()
    assert cloth_grad_kernel.LAUNCHES - g0 == 48
    assert cloth_kernel.LAUNCHES - k0 == 48 + 3 * 15     # forward + traces
    cpu = st.ClothState(pos=s.pos.cpu(), vel=s.vel.cpu())
    ref, _ = _linear_loss_grads(cpu, st.ClothParams(*(a.cpu() for a in p)),
                                48, 16, "cpu", wp, wv)
    for a, b in zip(got, ref):
        if float(b.abs().max()) < 1e-6:
            assert float(a.abs().max()) < 1e-6
            continue
        assert _max_rel(a.cpu(), b) <= 1e-4
    assert torch.equal(out.pos, cloth_kernel.multi_step(s, p, DT, 48).pos)


# --- the granular kernel (K10, csrc/granular_step.cu) ---

GRANULAR = dict(num_particles=1500, bounds=2.0, radius=0.08, restitution=0.4,
                rebuild_every=4, pallas_block=128, pallas_slab=512)


def _settled_pile(dev, **kw):
    from wgpu_physics_engine_torch.models import granular

    c = granular.GranularConfig(**{**GRANULAR, **kw})
    s = granular.init_state(c, torch.Generator().manual_seed(3), device=dev)
    return c, granular.multi_step(s, c, 1.0 / 240.0, 200)   # on the floor


@pytest.mark.cuda
@pytest.mark.parametrize("kw", [dict(), dict(thin=True, pallas_slab=768),
                                dict(civ=False), dict(pallas_slab=128)],
                         ids=["civ", "thin", "windows", "undersized"])
def test_granular_kernel_matches_plain(dev, kw):
    """K10 against its plain version on the card over the same candidate
    set (slab truncation included): one substep and one rebuild block,
    positions 1e-5 and velocities 1e-4 (sums in another order)."""
    from wgpu_physics_engine_torch.models import granular
    from wgpu_physics_engine_torch.ops import granular_kernel as gk

    c, s = _settled_pile(dev, **kw)
    grid, slabs, dropped = granular.rebuild(s.pos, s.vel, c, stats=True)
    assert (int(dropped) > 0) == (c.pallas_slab == 128)
    prm = gk.kernel_params(c, 1.0 / 240.0, dev)
    kp, kv = grid.sorted_pos, grid.sorted_vel
    pp, pv = kp, kv
    before = gk.LAUNCHES
    for step in range(c.rebuild_every):
        kp, kv = gk.substep_sorted(kp, kv, prm, slabs)
        pp, pv = gk.substep_sorted_plain(pp, pv, prm, slabs)
        torch.cuda.synchronize()
        tol = 1e-5 if step == 0 else 1e-4
        assert float((kp - pp).abs().max()) <= 1e-5
        assert float((kv - pv).abs().max()) <= tol
    assert gk.LAUNCHES == before + c.rebuild_every


@pytest.mark.cuda
def test_granular_multi_step_cuda_matches_cpu_plain(dev):
    from wgpu_physics_engine_torch.models import granular
    from wgpu_physics_engine_torch.ops import granular_kernel as gk

    c, s = _settled_pile(dev)
    before = gk.LAUNCHES
    got, d = granular.multi_step(s, c, 1.0 / 240.0, 6, return_stats=True)
    torch.cuda.synchronize()
    assert gk.LAUNCHES == before + 6
    cpu = s._replace(pos=s.pos.cpu(), vel=s.vel.cpu())
    ref, dr = granular.multi_step(cpu, c, 1.0 / 240.0, 6, return_stats=True)
    assert int(d) == int(dr) == 0
    torch.testing.assert_close(got.pos.cpu(), ref.pos, atol=1e-5, rtol=0)
    torch.testing.assert_close(got.vel.cpu(), ref.vel, atol=1e-4, rtol=0)


@pytest.mark.cuda
def test_granular_scene_on_cuda(dev):
    from wgpu_physics_engine_torch.models import granular
    from wgpu_physics_engine_torch.ops import granular_kernel as gk

    sc = scenes.GranularScene(granular.GranularConfig(num_particles=4000),
                              device=dev)
    before = gk.LAUNCHES
    sc.simulate(0.1)
    img = sc.render(128, 128)
    assert gk.LAUNCHES == before + 24
    assert torch.isfinite(sc.state.pos).all() and np.isfinite(img).all()
    assert (np.abs(img - np.asarray([0.86, 0.65, 0.35])).max(-1) < 1e-6).sum() > 0


# --- contact gradients and self-collision (K11, K12, K1f) ---

@pytest.mark.cuda
@pytest.mark.parametrize("kw", [dict(), dict(thin=True, pallas_slab=768),
                                dict(civ=False)],
                         ids=["civ", "thin", "windows"])
def test_granular_forces_and_jvp_match_plain(dev, kw):
    """K11 and K12 against their plain versions on the card over the same
    candidate set (1e-5 relative to the largest component), K12's force
    equal to K11's, and K11 with the plain integrate equal to one K10
    substep bit for bit (one device code for both forces)."""
    from wgpu_physics_engine_torch.models import granular
    from wgpu_physics_engine_torch.ops import granular_kernel as gk

    c, s = _settled_pile(dev, **kw)
    grid, slabs, _ = granular.rebuild(s.pos, s.vel, c)
    prm = gk.kernel_params(c, 1.0 / 240.0, dev)
    p = grid.sorted_pos
    u = torch.tensor(np.random.default_rng(4).standard_normal(
        tuple(p.shape)).astype(np.float32), device=dev)
    before = (gk.LAUNCHES_FORCES, gk.LAUNCHES_JVP)
    f = gk.contact_forces_sorted(p, prm[0], prm[1], slabs)
    ft = gk.contact_force_jvp_sorted(p, u, prm[0], prm[1], slabs)
    torch.cuda.synchronize()
    assert (gk.LAUNCHES_FORCES, gk.LAUNCHES_JVP) == (before[0] + 1,
                                                     before[1] + 1)
    f_ref = gk.contact_forces_sorted_plain(p, prm[0], prm[1], slabs)
    ft_ref = gk.contact_force_jvp_sorted_plain(p, u, prm[0], prm[1], slabs)
    assert float(f_ref.abs().max()) > 0
    assert float((f - f_ref).abs().max()) <= 1e-5 * float(f_ref.abs().max())
    assert float((ft - ft_ref).abs().max()) <= 1e-5 * float(
        ft_ref.abs().max())
    assert torch.equal(ft[:3], f)
    kp, kv = gk.substep_sorted_kernel(p, grid.sorted_vel, prm, slabs)
    ip, iv = gk._integrate(p, grid.sorted_vel, f, prm)
    assert torch.equal(kp, ip) and torch.equal(kv, iv)


def _k1f_state(dev, h, w, pins, seed=8):
    """A fresh h × w cloth with seeded velocities and force plane, the top
    row pinned with ``pins``."""
    c = cfg.ClothConfig(height=h, width=w)
    s = st.init_cloth_state(c, device=dev)
    rng = np.random.default_rng(seed)
    s = s._replace(vel=torch.tensor(
        (0.5 * rng.standard_normal((3, h, w))).astype(np.float32), device=dev))
    if pins:
        mask = torch.zeros((h, w), dtype=torch.bool, device=dev)
        mask[0] = True
        s = s._replace(pin_mask=mask, pin_pos=s.pos)
    fext = torch.tensor((20.0 * rng.standard_normal((3, h, w))).astype(
        np.float32), device=dev)
    return s, st.ClothParams.from_config(c, device=dev), fext


@pytest.mark.cuda
@pytest.mark.parametrize("hw", [(256, 256), (48, 40), (61, 67), (2, 3)])
@pytest.mark.parametrize("pins", [False, True])
def test_cloth_substep_with_force_matches_plain_and_k1(dev, pins, hw):
    """K1f against its plain version bit for bit (one substep) and, with a
    zero force plane, against K1 bit for bit."""
    s, p, fext = _k1f_state(dev, *hw, pins)
    before = cloth_kernel.LAUNCHES_FORCE
    got = cloth_kernel.substep_with_force(s, p, DT, fext)
    torch.cuda.synchronize()
    assert cloth_kernel.LAUNCHES_FORCE == before + 1
    ref = cloth_kernel.substep_with_force_plain(s, p, DT, fext)
    assert torch.equal(got.pos, ref.pos) and torch.equal(got.vel, ref.vel)
    zero = cloth_kernel.substep_with_force(s, p, DT, torch.zeros_like(fext))
    k1 = cloth_kernel.multi_step(s, p, DT, 1)
    assert torch.equal(zero.pos, k1.pos) and torch.equal(zero.vel, k1.vel)


@pytest.mark.cuda
@pytest.mark.parametrize("hw", [(256, 256), (61, 67)])
@pytest.mark.parametrize("pins", [False, True])
def test_cloth_substep_with_force_sorted_matches_composition(dev, pins, hw):
    """K1f's sorted entry (forces in a permuted order, the next sorted
    positions written) against its plain version, the gather, K1f's plain
    substep and the scatter, and against the grid-order entry on the
    gathered forces, all bit for bit; without ``want_sp`` no sorted copy
    and the same state."""
    s, p, fext = _k1f_state(dev, *hw, pins)
    n = hw[0] * hw[1]
    order = torch.randperm(n, generator=torch.Generator().manual_seed(3)).to(
        dev)
    inv = torch.empty_like(order)
    inv[order] = torch.arange(n, device=dev)
    f_sorted = fext.reshape(3, n)[:, order].contiguous()
    blk, sb = cloth_kernel.force_block(s, p, DT, inv)
    before = cloth_kernel.LAUNCHES_FORCE
    got, sp = cloth_kernel.substep_with_force_sorted(sb, blk, f_sorted)
    last, none = cloth_kernel.substep_with_force_sorted(sb, blk, f_sorted,
                                                        want_sp=False)
    torch.cuda.synchronize()
    assert cloth_kernel.LAUNCHES_FORCE == before + 2
    ref, rsp = cloth_kernel.substep_with_force_sorted_plain(sb, blk, f_sorted)
    assert torch.equal(got.pos, ref.pos) and torch.equal(got.vel, ref.vel)
    assert torch.equal(sp, rsp)
    assert torch.equal(sp, got.pos.reshape(3, n)[:, order])
    grid = cloth_kernel.substep_with_force(s, p, DT, fext)
    assert torch.equal(got.pos, grid.pos) and torch.equal(got.vel, grid.vel)
    assert none is None
    assert torch.equal(last.pos, got.pos) and torch.equal(last.vel, got.vel)


@pytest.mark.cuda
def test_granular_multi_step_diff_cuda_matches_cpu_plain(dev):
    """The granular gradient path on the card (K11 forward, K11 and K12
    backward) against the same path on the CPU (plain versions): the
    primal and the gradients w.r.t. pos, vel, dt, k, g, e within 1e-4
    max-relative."""
    from wgpu_physics_engine_torch.models import granular
    from wgpu_physics_engine_torch.ops import granular_kernel as gk

    c, s = _settled_pile(dev)
    s = s._replace(vel=s.vel * 8.0)
    rng = np.random.default_rng(6)
    wp, wv = (rng.standard_normal(tuple(s.pos.shape)).astype(np.float32)
              for _ in range(2))

    def grads(device):
        leaves = [s.pos.to(device), s.vel.to(device)] + [
            torch.tensor(v, dtype=torch.float32, device=device)
            for v in (1.0 / 240.0, c.k_contact, c.gravity, c.restitution)]
        leaves = [t.clone().requires_grad_() for t in leaves]
        out = granular.multi_step_diff(
            st.ParticleState(pos=leaves[0], vel=leaves[1]), c, leaves[2], 6,
            k_contact=leaves[3], gravity=leaves[4], restitution=leaves[5])
        loss = ((out.pos * torch.tensor(wp, device=device)).sum()
                + (out.vel * torch.tensor(wv, device=device)).sum())
        return out, torch.autograd.grad(loss, leaves)

    before = (gk.LAUNCHES_FORCES, gk.LAUNCHES_JVP)
    out, got = grads(dev)
    torch.cuda.synchronize()
    assert (gk.LAUNCHES_FORCES - before[0], gk.LAUNCHES_JVP - before[1]) == (
        12, 6)
    ref_out, ref = grads("cpu")
    torch.testing.assert_close(out.pos.cpu(), ref_out.pos, atol=1e-5, rtol=0)
    for a, b in zip(got, ref):
        assert torch.isfinite(a).all()
        assert _max_rel(a.cpu(), b) <= 1e-4


# --- the untiled sphere raster (K4), the free-particle and mesh scenes ---

def _box_centers(dev, n, seed):
    """n instances uniform in the free-particle box (bounds 10)."""
    g = torch.Generator().manual_seed(seed)
    return (torch.rand((n, 3), generator=g) * 20.0 - 10.0).to(dev)


def _box_rays(dev, h, w):
    tc = camera.make_camera(cfg.CameraConfig(radius=40.0, phi=0.3, theta=0.3),
                            aspect=w / h, device=dev)
    eye, dirs = camera.pixel_rays(tc, h, w)
    return tc, eye, dirs


@pytest.mark.cuda
@pytest.mark.parametrize("n,radius", [(10, 1.0), (16384, 0.25)])
def test_untiled_raster_kernel_matches_plain_and_tiled(dev, n, radius):
    h, w = 120, 200
    tc, eye, dirs = _box_rays(dev, h, w)
    centers = _box_centers(dev, n, n)
    before = raster_kernel.LAUNCHES_UNTILED
    kt, ki = raster_kernel.sphere_raster_untiled(eye, dirs, centers, radius,
                                                 tc.znear)
    torch.cuda.synchronize()
    assert raster_kernel.LAUNCHES_UNTILED == before + 1
    ocb = raster_kernel.untiled_prologue(eye, centers, radius)
    pt, pi = raster_kernel.sphere_raster_untiled_plain(ocb, dirs, tc.znear)
    assert int((ki >= 0).sum()) > 50
    assert torch.equal(ki, pi) and torch.equal(kt, pt)
    wins, tocb, order, rect = raster_kernel.tiled_prologue(
        tc.view[:3, :3], eye, centers, radius, tc.znear,
        torch.tan(tc.fovy_rad / 2.0), tc.aspect, h, w)
    tt, ti, _ = raster_kernel.sphere_raster_kernel(wins, tocb, rect, dirs,
                                                   tc.znear)
    ids = torch.where(ti >= 0, order[ti.clamp_min(0).long()], -1)
    assert torch.equal(ids, ki) and torch.equal(tt, kt)


def _k4_against_plain_and_tiled(dev, h, w, centers, radius):
    """K4 on the box camera's h × w rays against its plain version and the
    tiled kernel (winners mapped back to instance ids), bit for bit; the
    hit count."""
    tc, eye, dirs = _box_rays(dev, h, w)
    kt, ki = raster_kernel.sphere_raster_untiled(eye, dirs, centers, radius,
                                                 tc.znear)
    ocb = raster_kernel.untiled_prologue(eye, centers, radius)
    pt, pi = raster_kernel.sphere_raster_untiled_plain(ocb, dirs, tc.znear)
    assert torch.equal(ki, pi) and torch.equal(kt, pt)
    if centers.shape[0]:
        wins, tocb, order, rect = raster_kernel.tiled_prologue(
            tc.view[:3, :3], eye, centers, radius, tc.znear,
            torch.tan(tc.fovy_rad / 2.0), tc.aspect, h, w)
        tt, ti, _ = raster_kernel.sphere_raster_kernel(wins, tocb, rect, dirs,
                                                       tc.znear)
        ids = torch.where(ti >= 0, order[ti.clamp_min(0).long()], -1)
        assert torch.equal(ids, ki) and torch.equal(tt, kt)
    return int((ki >= 0).sum())


@pytest.mark.cuda
@pytest.mark.parametrize("n", [0, 1, 10, 2048, 2049, 16384])
@pytest.mark.parametrize("hw", [(600, 800), (601, 799)])
def test_untiled_raster_kernel_at_frame_sizes(dev, hw, n):
    """K4 at the free-particle scene's 600×800 and at 601×799 (h·w not a
    multiple of 4: the kernel's scalar accesses), from no instance to
    MAX_INSTANCES, across a chunk boundary (2,048 and 2,049), against its
    plain version and the tiled kernel bit for bit."""
    radius = 1.0 if n <= 10 else 0.25
    hits = _k4_against_plain_and_tiled(dev, *hw, _box_centers(dev, n, n),
                                       radius)
    assert (hits == 0) == (n == 0)


@pytest.mark.cuda
def test_untiled_raster_ties_and_behind_camera(dev):
    """Two identical spheres: the lower id wins every pixel they cover; a
    sphere behind the camera (t below znear) hits no pixel."""
    h, w = 601, 799
    tc, eye, dirs = _box_rays(dev, h, w)
    fwd = -tc.view[2, :3]                  # the camera looks down -z_view
    front = eye + 30.0 * fwd
    behind = eye - 5.0 * fwd
    centers = torch.stack([behind, front, front, front + 0.5 * fwd])
    kt, ki = raster_kernel.sphere_raster_untiled(eye, dirs, centers, 2.0,
                                                 tc.znear)
    ocb = raster_kernel.untiled_prologue(eye, centers, 2.0)
    pt, pi = raster_kernel.sphere_raster_untiled_plain(ocb, dirs, tc.znear)
    assert torch.equal(ki, pi) and torch.equal(kt, pt)
    assert int((ki == 1).sum()) > 100
    assert int((ki == 2).sum()) == 0 and int((ki == 0).sum()) == 0
    assert int((ki == 3).sum()) == 0     # behind sphere 1, farther


@pytest.mark.cuda
def test_free_particle_scene_on_cuda_takes_k4(dev):
    s = scenes.FreeParticleScene(device=dev)
    s.simulate(1.0)
    u0, r0 = raster_kernel.LAUNCHES_UNTILED, raster_kernel.LAUNCHES
    img = s.render(60, 80)
    assert raster_kernel.LAUNCHES_UNTILED - u0 == 1
    assert raster_kernel.LAUNCHES == r0
    c = scenes.FreeParticleScene(device="cpu")
    c.state = st.ParticleState(pos=s.state.pos.cpu(), vel=s.state.vel.cpu())
    ref = c.render(60, 80)
    # within 1 in u8 but for rare pixels: at a sphere's pole u = atan2(y,
    # x) / 2π is undefined and at a silhouette t is ill-conditioned, so an
    # ulp of CPU vs CUDA libm there moves the texture sample by texels
    d = np.abs(np.round(img * 255) - np.round(ref * 255)).max(-1)
    assert (d <= 1).mean() >= 0.999, (d <= 1).mean()
    assert (np.abs(img - np.asarray([0.05, 0.05, 0.08])).max(-1) > 0.01).sum() > 30


@pytest.mark.cuda
@pytest.mark.parametrize("binned", [False, True])
def test_draw_mesh_cuda_matches_cpu(dev, binned):
    from wgpu_physics_engine_torch import render as R

    host = R.geometry.generate_uv_sphere(10.0, 32, 64)
    tex = R.texture.checkerboard()
    out = []
    for d in (dev, "cpu"):
        cam = camera.make_camera(cfg.CameraConfig(radius=30.0, phi=0.4),
                                 aspect=1.5, device=d)
        fb, dropped = R.draw_mesh(
            R.clear(96, 144, device=d), cam, R.DeviceMesh.from_host(host, d),
            texture=tex.to(d), light=cfg.LightConfig(), mode="phong",
            binned=binned, return_stats=True)
        out.append((fb.color.cpu(), fb.depth.cpu(), dropped))
    (gc, gd, gdrop), (rc, rd, rdrop) = out
    assert gdrop == rdrop == 0
    assert ((gd < 1.0) == (rd < 1.0)).float().mean() >= 0.999
    assert int((gd < 1.0).sum()) > 2000
    both = (gd < 1.0) & (rd < 1.0)
    assert float((gd - rd).abs()[both].max()) <= 1e-6
    diff = (gc - rc).abs().amax(-1)
    assert float((diff <= 1e-4).float().mean()) >= 0.999


GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")


def golden_frame_diff(name: str, device) -> np.ndarray:
    """Per pixel and channel, |the port's frame - the committed golden
    frame| in u8, for one of ``tests/golden/regen.py``'s scenes rendered on
    ``device`` with its settings (64 × 64; the 12 × 12 cloth on the
    stencil path after 0.5 s)."""
    from PIL import Image

    if name == "globe":
        s = scenes.GlobeScene(device=device)
    elif name == "cube":
        s = scenes.CubeScene(device=device)
    else:
        s = scenes.ClothScene(config=cfg.ClothConfig(height=12, width=12),
                              use_kernel=False, device=device)
        s.simulate(0.5)
    got = (np.clip(s.render(64, 64), 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
    want = np.asarray(Image.open(os.path.join(GOLDEN, f"{name}.png"))
                      .convert("RGB"))
    assert got.shape == want.shape
    return np.abs(got.astype(np.int32) - want.astype(np.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["globe", "cube", "cloth"])
def test_golden_frame_on_cuda(dev, name):
    diff = golden_frame_diff(name, dev)
    assert diff.max() <= 2, f"max pixel diff {diff.max()}"
    assert (diff > 0).mean() < 0.02, f"{(diff > 0).mean():.1%} pixels differ"


def _k6_state(dev, h, w, draped, pins):
    """A cloth of h × w with random velocities, or a short-fall cloth
    draped on the globe by 300 K1 substeps; pinned at ``pins``."""
    c = cfg.ClothConfig(height=h, width=w, center=(0.0, 12.0, 0.0),
                        cloth_size=8.0)
    p = st.ClothParams.from_config(c, device=dev)
    s = st.init_cloth_state(c, device=dev)
    if draped:
        s = cloth_kernel.multi_step_kernel(s, p, DT, 300)
        dist = torch.linalg.vector_norm(s.pos, dim=0)
        assert bool((dist < 10.1 + 1e-3).any())
    else:
        rng = np.random.default_rng(h * w)
        s = s._replace(vel=torch.tensor(
            (0.5 * rng.standard_normal((3, h, w))).astype(np.float32),
            device=dev))
    if pins:
        mask = torch.zeros((h, w), dtype=torch.bool, device=dev)
        for r, c_ in pins:
            mask[r, c_] = True
        s = s._replace(pin_mask=mask, pin_pos=s.pos)
    return s, p


@pytest.mark.cuda
@pytest.mark.parametrize("hw,schedule,n,draped,pins", [
    ((64, 64), (4, 16, 16), 9, True, [(0, 0), (16, 16)]),
    ((33, 70), (2, 8, 8), 5, False, [(8, 3), (20, 69)]),
    ((20, 20), (4, 64, 64), 8, True, None),           # smaller than a tile
    ((130, 100), None, 13, True, [(0, 50), (32, 32)]),  # the default
    ((45, 61), (8, 16, 24), 13, False, [(16, 24)]),
])
def test_cloth_tiled_kernel_matches_plain_and_k1(dev, hw, schedule, n,
                                                 draped, pins):
    h, w = hw
    s, p = _k6_state(dev, h, w, draped, pins)
    k = (schedule or cloth_tiled_kernel.pick_schedule(h, w, n))[0]
    before = cloth_tiled_kernel.LAUNCHES
    got = cloth_tiled_kernel.multi_step_kernel(s, p, DT, n, schedule=schedule)
    torch.cuda.synchronize()
    assert cloth_tiled_kernel.LAUNCHES == before + -(-n // k)
    plain = cloth_tiled_kernel.multi_step_plain(s, p, DT, n,
                                                schedule=schedule)
    k1 = cloth_kernel.multi_step_kernel(s, p, DT, n)
    for ref in (plain, k1):
        assert torch.equal(got.pos, ref.pos)
        assert torch.equal(got.vel, ref.vel)


@pytest.mark.cuda
def test_cloth_route_on_cuda_launches_k6(dev, monkeypatch):
    """Above the limit one CUDA world takes the large-grid kernels
    (fast_math dropped) and K1 never: K6r, one launch, where its resident
    tiles fit the card, else K6; a batch of two stays on K5; the input is
    only read."""
    ct = cloth_tiled_kernel
    monkeypatch.setattr(cloth_kernel, "_TILED_PARTICLE_LIMIT", 1000)
    s, p = _k6_state(dev, 48, 40, True, [(0, 5)])
    pos0 = s.pos.clone()
    k1_before, k6_before = cloth_kernel.LAUNCHES, ct.LAUNCHES
    r_before = ct.LAUNCHES_RESIDENT
    got = cloth_kernel.multi_step(s, p, DT, 7, fast_math=True)
    torch.cuda.synchronize()
    assert ct.LAUNCHES_RESIDENT == r_before + 1
    assert ct.LAUNCHES == k6_before
    assert cloth_kernel.LAUNCHES == k1_before
    assert torch.equal(s.pos, pos0)
    ref = cloth_kernel.multi_step_launch_packed(
        s, cloth_kernel._pack_params(p, DT), 7)
    assert torch.equal(got.pos, ref.pos) and torch.equal(got.vel, ref.vel)
    # no resident tiling fits: K6, ceil(n / k) launches
    monkeypatch.setattr(ct, "_card_resident", lambda h, w, sms, smem: None)
    got = cloth_kernel.multi_step(s, p, DT, 7)
    torch.cuda.synchronize()
    k = ct.pick_schedule(48, 40, 7)[0]
    assert ct.LAUNCHES == k6_before + -(-7 // k)
    assert ct.LAUNCHES_RESIDENT == r_before + 1
    assert torch.equal(got.pos, ref.pos) and torch.equal(got.vel, ref.vel)
    batch = s._replace(pos=torch.stack([s.pos, s.pos]),
                       vel=torch.stack([s.vel, s.vel]), pin_mask=None,
                       pin_pos=None)
    k6 = ct.LAUNCHES
    b_before = cloth_kernel.LAUNCHES_BATCHED
    cloth_kernel.multi_step(batch, p, DT, 3)
    torch.cuda.synchronize()
    assert ct.LAUNCHES == k6
    assert cloth_kernel.LAUNCHES_BATCHED == b_before + 3


@pytest.mark.cuda
def test_cloth_tiled_refuses_oversized_schedule(dev):
    s, p = _k6_state(dev, 300, 300, False, None)
    with pytest.raises(ValueError, match="shared memory"):
        cloth_tiled_kernel.multi_step_kernel(s, p, DT, 8,
                                             schedule=(8, 200, 200))


@pytest.mark.cuda
@pytest.mark.parametrize("hw,tile,n,draped,pins", [
    ((448, 256), None, 13, True, [(0, 0), (200, 100)]),   # the schedule's
    ((448, 256), None, 8, False, [(35, 26)]),            # even n: buffer b
    ((130, 100), (30, 40), 9, True, [(0, 50), (30, 40)]),
    ((64, 64), (16, 16), 6, False, [(16, 15), (47, 48)]),
    ((37, 53), (37, 53), 11, False, None),               # one tile
])
def test_cloth_resident_kernel_matches_plain_k1_and_k6(dev, hw, tile, n,
                                                       draped, pins):
    """K6r (the whole call in one cooperative launch, tiles resident in
    shared memory, borders exchanged each substep) ≡ K6's plain version,
    K1 and K6, bit for bit, pins on tile corners included; the input is
    only read."""
    ct = cloth_tiled_kernel
    h, w = hw
    s, p = _k6_state(dev, h, w, draped, pins)
    pos0 = s.pos.clone()
    before = ct.LAUNCHES_RESIDENT
    got = ct.multi_step_resident_kernel(s, p, DT, n, tile)
    torch.cuda.synchronize()
    assert ct.LAUNCHES_RESIDENT == before + 1
    assert torch.equal(s.pos, pos0)
    prm = cloth_kernel._pack_params(p, DT)
    for ref in (ct.multi_step_plain(s, p, DT, n),
                cloth_kernel.multi_step_launch_packed(s, prm, n),
                ct.multi_step_kernel(s, p, DT, n)):
        assert torch.equal(got.pos, ref.pos)
        assert torch.equal(got.vel, ref.vel)


@pytest.mark.cuda
def test_cloth_resident_kernel_refuses_bad_tiles(dev):
    s, p = _k6_state(dev, 300, 300, False, None)
    for tile in ((1, 64), (64, 1), (200, 200), (8, 17 * 29)):
        with pytest.raises(ValueError, match="resident tile"):
            cloth_tiled_kernel.multi_step_resident_kernel(s, p, DT, 4, tile)


@pytest.mark.cuda
@pytest.mark.parametrize("hw,n_worlds,pins,contact", [
    ((37, 53), 9, False, False), ((37, 53), 9, True, True),
    ((60, 60), 7, True, False), ((12, 20), 5, False, True)])
def test_cloth_batched_resident_kernel_matches_plain_k1_and_k5(
        dev, hw, n_worlds, pins, contact):
    """K5r (a CTA a world, all substeps in one launch) ≡ the plain
    version, K5 on the batch and K1 on each world, bit for bit."""
    ct = cloth_tiled_kernel
    h, w = hw
    b = _worlds(dev, n_worlds, h, w, seed=h * w, contact=contact)
    s = b.state
    if pins:
        mask = torch.zeros((n_worlds, h, w), dtype=torch.bool, device=dev)
        mask[:, 0] = True
        mask[:, h // 2, w // 3] = True
        s = s._replace(pin_mask=mask, pin_pos=s.pos)
    prm = cloth_kernel._pack_params(b.params, DT)
    before = ct.LAUNCHES_BATCHED
    got = ct.multi_step_batched_kernel_packed(s, prm, 11)
    torch.cuda.synchronize()
    assert ct.LAUNCHES_BATCHED == before + 1
    for ref in (cloth_kernel.multi_step_plain(s, b.params, DT, 11),
                cloth_kernel.multi_step_launch_packed(s, prm, 11)):
        assert torch.equal(got.pos, ref.pos)
        assert torch.equal(got.vel, ref.vel)
    for i in (0, n_worlds - 1):
        one = st.ClothState(
            pos=s.pos[i], vel=s.vel[i],
            pin_mask=None if s.pin_mask is None else s.pin_mask[i],
            pin_pos=None if s.pin_pos is None else s.pin_pos[i])
        k1 = cloth_kernel.multi_step_launch_packed(one, prm[i], 11)
        assert torch.equal(got.pos[i], k1.pos)
        assert torch.equal(got.vel[i], k1.vel)
    if contact:
        assert int((got.vel == 0).all(1).sum()) > 0


@pytest.mark.cuda
def test_cloth_batch_route_on_cuda_takes_k5r(dev):
    """``cloth_kernel.multi_step`` sends an exact batch of at least
    ``_RESIDENT_MIN_WAVES`` worlds a multiprocessor to K5r (one launch), a
    fast_math one and a smaller one to K5 (a launch a substep)."""
    ct = cloth_tiled_kernel
    n = math.ceil(cloth_kernel._RESIDENT_MIN_WAVES * ct.sm_count(dev))
    big = _worlds(dev, n, 12, 20, seed=1)
    small = _worlds(dev, n - 1, 12, 20, seed=1)
    r0, k0 = ct.LAUNCHES_BATCHED, cloth_kernel.LAUNCHES_BATCHED
    got = cloth_kernel.multi_step(big.state, big.params, DT, 6)
    torch.cuda.synchronize()
    assert (ct.LAUNCHES_BATCHED, cloth_kernel.LAUNCHES_BATCHED) == (r0 + 1, k0)
    ref = cloth_kernel.multi_step_plain(big.state, big.params, DT, 6)
    assert torch.equal(got.pos, ref.pos) and torch.equal(got.vel, ref.vel)
    cloth_kernel.multi_step(big.state, big.params, DT, 6, fast_math=True)
    cloth_kernel.multi_step(small.state, small.params, DT, 6)
    torch.cuda.synchronize()
    assert (ct.LAUNCHES_BATCHED, cloth_kernel.LAUNCHES_BATCHED) == (r0 + 1,
                                                                     k0 + 12)


# --- the multi-device paths (K1w, K10b) ---

def _window_of(x, lo, hi, h):
    """Rows [lo, hi) of ``x`` [..., h, W], zero beyond the grid."""
    out = torch.zeros(x.shape[:-2] + (hi - lo, x.shape[-1]), dtype=x.dtype,
                      device=x.device)
    a, b = max(lo, 0), min(hi, h)
    out[..., a - lo:b - lo, :] = x[..., a:b, :]
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("k,pins", [(1, True), (2, False), (4, True)])
def test_cloth_window_kernel_matches_plain_and_k1(dev, k, pins):
    """K1w on the four row windows of a 64×48 grid (the top one with row0
    < 0) against its plain version and, on each window's centre rows,
    against K1 on the whole grid: bit for bit."""
    h, w, n_shards = 64, 48, 4
    c = cfg.ClothConfig(height=h, width=w)
    s = st.init_cloth_state(c, device=dev)
    rng = np.random.default_rng(12)
    s = s._replace(vel=torch.tensor(
        (0.5 * rng.standard_normal((3, h, w))).astype(np.float32), device=dev))
    if pins:
        mask = torch.zeros((h, w), dtype=torch.bool, device=dev)
        mask[0] = True
        s = s._replace(pin_mask=mask, pin_pos=s.pos)
    p = st.ClothParams.from_config(c, device=dev)
    ref = cloth_kernel.multi_step_kernel(s, p, DT, k)
    h_local, halo = h // n_shards, 2 * k
    before = cloth_kernel.LAUNCHES_WINDOW
    k6w = cloth_tiled_kernel.LAUNCHES_WINDOW
    for i in range(n_shards):
        lo, hi = i * h_local - halo, (i + 1) * h_local + halo
        args = [_window_of(s.pos, lo, hi, h), _window_of(s.vel, lo, hi, h),
                None if not pins else _window_of(s.pin_mask, lo, hi, h),
                None if not pins else _window_of(s.pin_pos, lo, hi, h)]
        kp, kv = cloth_kernel.multi_step_window(*args, p, DT, k, lo, h)
        pp, pv = cloth_kernel.multi_step_window_plain(*args, p, DT, k, lo, h)
        torch.cuda.synchronize()
        assert torch.equal(kp, pp) and torch.equal(kv, pv)
        rows = slice(i * h_local, (i + 1) * h_local)
        assert torch.equal(kp[:, halo:-halo], ref.pos[:, rows])
        assert torch.equal(kv[:, halo:-halo], ref.vel[:, rows])
    assert cloth_kernel.LAUNCHES_WINDOW == before + n_shards * k
    # the windows lie under the tiled limit: the route keeps K1w's body
    assert cloth_tiled_kernel.LAUNCHES_WINDOW == k6w


@pytest.mark.cuda
@pytest.mark.parametrize("k,pins,schedule", [
    (1, True, None), (2, False, None), (2, True, (1, 7, 29)),
    (4, True, (2, 9, 50))])
def test_cloth_window_k6w_matches_plain_and_k1w(dev, monkeypatch, k, pins,
                                                schedule):
    """K6w on the four row windows of a draped 448×256 grid (above the
    tiled limit; the top window with zero-filled dead rows, row0 < 0)
    against K1w's plain version and K1w's body on the whole window, and on
    each window's centre rows against K6 on the whole grid, bit for bit;
    the default schedule and ragged ones (k = 2 a launch included). With
    the limit lowered the route launches K6w and not K1w."""
    h, w, n_shards = 448, 256, 4
    s, p = _k6_state(dev, h, w, True, [(0, c) for c in range(w)]
                     if pins else None)
    ref = cloth_tiled_kernel.multi_step_kernel(s, p, DT, k)
    h_local, halo = h // n_shards, 2 * k
    monkeypatch.setattr(cloth_kernel, "_TILED_PARTICLE_LIMIT", 1000)
    for i in range(n_shards):
        lo, hi = i * h_local - halo, (i + 1) * h_local + halo
        args = [_window_of(a, lo, hi, h) for a in (s.pos, s.vel)]
        args += ([_window_of(s.pin_mask, lo, hi, h),
                  _window_of(s.pin_pos, lo, hi, h)] if pins
                 else [None, None])
        kw, k1w = (cloth_tiled_kernel.LAUNCHES_WINDOW,
                   cloth_kernel.LAUNCHES_WINDOW)
        got = cloth_tiled_kernel.multi_step_window_kernel(
            *args, p, DT, k, lo, h, schedule=schedule)
        routed = cloth_kernel.multi_step_window(*args, p, DT, k, lo, h)
        torch.cuda.synchronize()
        k_sub = (schedule or cloth_tiled_kernel.pick_schedule(
            hi - lo, w, k))[0]
        assert (cloth_tiled_kernel.LAUNCHES_WINDOW
                == kw + -(-k // k_sub) + k)
        assert cloth_kernel.LAUNCHES_WINDOW == k1w
        body = cloth_kernel.multi_step_window_kernel(*args, p, DT, k, lo, h)
        plain = cloth_kernel.multi_step_window_plain(*args, p, DT, k, lo, h)
        for r in (routed, body, plain):
            assert torch.equal(got[0], r[0]) and torch.equal(got[1], r[1])
        rows = slice(i * h_local, (i + 1) * h_local)
        assert torch.equal(got[0][:, halo:-halo], ref.pos[:, rows])
        assert torch.equal(got[1][:, halo:-halo], ref.vel[:, rows])


@pytest.mark.cuda
@pytest.mark.parametrize("side", [64, 256])
@pytest.mark.parametrize("case", ["free", "pinned"])
def test_adjoint_one_launch_matches_plain(dev, side, case):
    """The one-launch substep adjoint against ``substep_vjp_plain`` (one
    substep) and ``_walk_plain`` (a walk of 12 over the trace) at 64² and
    256², in free fall and draped with the top row pinned: state and pin
    cotangents bit for bit, the parameter cotangent within 1e-5
    (float64 sums in another order, rounded once); one launch a
    substep."""
    s, p = _grad_state(dev, side, side, case)
    prm = cloth_kernel._pack_params(p, DT)
    rng = np.random.default_rng(side)
    cp, cv = (torch.tensor(rng.standard_normal((3, side, side))
                           .astype(np.float32), device=dev)
              for _ in range(2))
    pins = None if s.pin_mask is None else (s.pin_mask, s.pin_pos)
    traj = cloth_kernel.trace(s, prm, 12)
    refs = {1: cloth_grad_kernel.substep_vjp_plain(traj[0], cp, cv, prm,
                                                   pins),
            12: cloth_grad_kernel._walk_plain(traj, cp, cv, prm, pins)}
    for n, ref in refs.items():
        before = cloth_grad_kernel.LAUNCHES
        got = cloth_grad_kernel._walk_kernel(traj[:n], cp, cv, prm, pins)
        torch.cuda.synchronize()
        assert cloth_grad_kernel.LAUNCHES == before + n
        assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
        assert _max_rel(got[2], ref[2]) <= 1e-5
        if pins is None:
            assert got[3] is None
        else:
            assert torch.equal(got[3], ref[3])
            assert float(got[3].abs().max()) > 0


@pytest.mark.cuda
def test_spatial_multi_step_cuda_matches_k1(dev):
    """The rows path on four shards of one card (K1w a shard) ≡ K1 on the
    whole grid bit for bit, K1 never launched by it; the composed (2, 2)
    worlds × rows path ≡ K1 per world; the stencil shard body refuses a
    CUDA mesh."""
    from wgpu_physics_engine_torch.parallel import mesh as pmesh

    c = cfg.ClothConfig(height=64, width=64)
    s = st.init_cloth_state(c, device=dev)
    mask = torch.zeros((64, 64), dtype=torch.bool, device=dev)
    mask[0] = True
    s = s._replace(pin_mask=mask, pin_pos=s.pos)
    p = st.ClothParams.from_config(c, device=dev)
    m = pmesh.make_mesh((4,), ("rows",), [dev] * 4)
    k1, kw = cloth_kernel.LAUNCHES, cloth_kernel.LAUNCHES_WINDOW
    got = pmesh.spatial_multi_step(s, p, DT, 24, m, substeps_per_exchange=2)
    torch.cuda.synchronize()
    assert cloth_kernel.LAUNCHES == k1
    assert cloth_kernel.LAUNCHES_WINDOW == kw + 4 * 24
    ref = cloth_kernel.multi_step(s, p, DT, 24)
    assert torch.equal(got.pos, ref.pos) and torch.equal(got.vel, ref.vel)
    batch = st.ClothState(pos=torch.stack([s.pos, ref.pos]),
                          vel=torch.stack([s.vel, ref.vel]))
    m2 = pmesh.make_mesh((2, 2), ("worlds", "rows"), [dev] * 4)
    out = pmesh.batched_spatial_multi_step(batch, p, DT, 8, m2,
                                           substeps_per_exchange=2)
    for i in range(2):
        one = cloth_kernel.multi_step(
            st.ClothState(pos=batch.pos[i], vel=batch.vel[i]), p, DT, 8)
        assert torch.equal(out.pos[i], one.pos)
    with pytest.raises(ValueError, match="CPU shards only"):
        pmesh.spatial_multi_step(s, p, DT, 2, m, use_kernel=False)


@pytest.mark.cuda
def test_granular_k10b_matches_plain_and_k10(dev):
    """K10b on four slices of the sorted slots of a settled pile ≡ the same
    rows of one K10 launch bit for bit and its plain version within K10's
    contract (1e-5); base = 0, n_local = n ≡ K10."""
    from wgpu_physics_engine_torch.models import granular
    from wgpu_physics_engine_torch.ops import granular_kernel as gk

    c, s = _settled_pile(dev)
    grid, slabs, _ = granular.rebuild(s.pos, s.vel, c)
    prm = gk.kernel_params(c, 1.0 / 240.0, dev)
    p, v = grid.sorted_pos, grid.sorted_vel
    n = p.shape[1]
    full_p, full_v = gk.substep_sorted(p, v, prm, slabs)
    before = gk.LAUNCHES_SHARDED
    whole = gk.substep_sorted(p, v, prm, slabs, base=0, n_local=n)
    assert torch.equal(whole[0], full_p) and torch.equal(whole[1], full_v)
    cuts = [0, 384, 768, 1280, n]
    for lo, hi in zip(cuts[:-1], cuts[1:]):
        kp, kv = gk.substep_sorted(p, v[:, lo:hi], prm, slabs, base=lo,
                                   n_local=hi - lo)
        pp, pv = gk.substep_sorted_plain(p, v[:, lo:hi], prm, slabs, base=lo,
                                         n_local=hi - lo)
        torch.cuda.synchronize()
        assert torch.equal(kp, full_p[:, lo:hi])
        assert torch.equal(kv, full_v[:, lo:hi])
        assert float((kp - pp).abs().max()) <= 1e-5
        assert float((kv - pv).abs().max()) <= 1e-5
    assert gk.LAUNCHES_SHARDED == before + 1 + len(cuts) - 1


@pytest.mark.cuda
def test_multi_step_sharded_cuda_matches_single(dev):
    """The grain-sharded pile on four shards of one card, N = 8192 (the
    sharded pad equals the single one): one rebuild block ≡ the
    single-device K10 path bit for bit, K10b launched once a shard and
    substep."""
    from wgpu_physics_engine_torch.models import granular
    from wgpu_physics_engine_torch.ops import granular_kernel as gk
    from wgpu_physics_engine_torch.parallel import granular_mesh, mesh as pm

    c = granular.GranularConfig(**{**GRANULAR, "num_particles": 8192})
    s = granular.init_state(c, torch.Generator().manual_seed(5), device=dev)
    s = granular.multi_step(s, c, 1.0 / 240.0, 120)
    m = pm.make_mesh((4,), ("grains",), [dev] * 4)
    before = gk.LAUNCHES_SHARDED
    got = granular_mesh.multi_step_sharded(s, c, 1.0 / 240.0, 4, m)
    torch.cuda.synchronize()
    assert gk.LAUNCHES_SHARDED == before + 4 * 4
    ref = granular.multi_step(s, c, 1.0 / 240.0, 4)
    assert torch.equal(got.pos, ref.pos) and torch.equal(got.vel, ref.vel)


def _sheet_set(dev, side, slab, draped=False):
    """The self-collision candidate set (thin CIV, block 256, skin 2·r) of
    a sheet of the flagship's spacing: fresh and flat (every window runs
    over a whole z-row of cells, ~870 candidates at 256²), or draped on
    the globe (folds). Returns (sorted pos, slabs, md, kc, dropped)."""
    from wgpu_physics_engine_torch.ops import granular_kernel as gk

    c = cfg.ClothConfig(height=side, width=side,
                        cloth_size=30.0 * side / 256)
    p = st.ClothParams.from_config(c, device=dev)
    s = st.init_cloth_state(c, device=dev)
    if draped:
        s = cloth_kernel.multi_step(s, p, DT, 1440)
    n = side * side
    spec = cloth.default_self_collision_grid(c, skin=2.0 * c.particle_radius)
    grid, slabs, dropped = cloth._frozen_structs(
        s.pos.reshape(3, n), s.vel.reshape(3, n), spec, 256, slab,
        stats=True)
    assert gk.lanes(slabs, n, gk.resident_threads(dev)) > 1
    return (grid.sorted_pos, grid.sorted_vel, slabs,
            2.0 * c.particle_radius, c.k_contact, int(dropped))


@pytest.mark.cuda
@pytest.mark.parametrize("draped,slab", [(False, 1024), (True, 1024),
                                         (False, 384)],
                         ids=["flat", "draped", "undersized"])
def test_granular_forces_long_thin_windows_match_plain(dev, draped, slab):
    """K11 and K12 on the thin self-collision set of a 256² sheet, windows
    of ~10³ candidates (several lanes a slot), against their plain
    versions within 1e-5 relative; an undersized slab drops entries and
    the kernels drop the same ones. K12's force is K11's, and K11 with the
    plain integrate is one K10 substep bit for bit."""
    from wgpu_physics_engine_torch.ops import granular_kernel as gk

    p, v, slabs, md, kc, dropped = _sheet_set(dev, 256, slab, draped)
    n = p.shape[1]
    assert (dropped > 0) == (slab == 384)
    (a_lo, a_hi), _ = gk.slab_ranges(slabs, n)
    assert float(torch.clamp_min(a_hi - a_lo, 0).float().mean()) > 300
    u = torch.tensor(np.random.default_rng(7).standard_normal(
        (3, n)).astype(np.float32), device=dev)
    before = (gk.LAUNCHES_FORCES, gk.LAUNCHES_JVP)
    f = gk.contact_forces_sorted(p, md, kc, slabs)
    ft = gk.contact_force_jvp_sorted(p, u, md, kc, slabs)
    torch.cuda.synchronize()
    assert (gk.LAUNCHES_FORCES, gk.LAUNCHES_JVP) == (before[0] + 1,
                                                     before[1] + 1)
    f_ref = gk.contact_forces_sorted_plain(p, md, kc, slabs)
    ft_ref = gk.contact_force_jvp_sorted_plain(p, u, md, kc, slabs)
    assert float(f_ref.abs().max()) > 0
    assert float((f - f_ref).abs().max()) <= 1e-5 * float(f_ref.abs().max())
    assert float((ft - ft_ref).abs().max()) <= 1e-5 * float(
        ft_ref.abs().max())
    assert torch.equal(ft[:3], f)
    prm = torch.stack([torch.tensor(md), torch.tensor(kc),
                       torch.tensor(-9.8), torch.tensor(DT),
                       torch.tensor(0.5), torch.tensor(100.0)]).to(dev)
    kp, kv = gk.substep_sorted_kernel(p, v, prm, slabs)
    ip, iv = gk._integrate(p, v, f, prm)
    assert torch.equal(kp, ip) and torch.equal(kv, iv)


def _raster_case(dev, centers, h, w, radius=0.3):
    tc = camera.make_camera(cfg.CameraConfig(), aspect=w / h, device=dev)
    _, dirs = camera.pixel_rays(tc, h, w)
    bins = raster_kernel.tiled_prologue(
        tc.view[:3, :3], tc.eye, centers, radius, tc.znear,
        torch.tan(tc.fovy_rad / 2.0), tc.aspect, h, w)
    return bins, dirs, tc.znear


def _raster_equal(bins, dirs, znear, min_hits):
    wins, ocb, _, rect = bins
    before = raster_kernel.LAUNCHES
    got = raster_kernel.sphere_raster_kernel(wins, ocb, rect, dirs, znear)
    torch.cuda.synchronize()
    assert raster_kernel.LAUNCHES == before + 1
    ref = raster_kernel.sphere_raster_plain(ocb, dirs, znear)
    assert int((ref[1] >= 0).sum()) > min_hits
    for a, b in zip(got, ref):
        assert torch.equal(a, b)
    return got


@pytest.mark.cuda
def test_raster_overloaded_tile_matches_plain(dev):
    """20,000 spheres clustered in a band in front of a row of tiles (each
    tile's ring holds ~20,000 candidates: its chunks spread over many work
    items and merge through the 64-bit key) beside a sparse frame: equal
    to the full plain sweep bit for bit."""
    rng = np.random.default_rng(21)
    cluster = rng.normal(0, 1, (20000, 3)) * [6.0, 0.8, 0.3] + [0.0, 0.0, 2.0]
    sparse = rng.uniform(-8, 8, (500, 3))
    centers = torch.tensor(np.concatenate([cluster, sparse]).astype(
        np.float32), device=dev)
    bins, dirs, znear = _raster_case(dev, centers, 64, 256, radius=0.15)
    wins = bins[0]
    count = sum(wins[:, 2 * g + 1] - wins[:, 2 * g] for g in range(4))
    assert int(count.max()) > 8 * raster_kernel.CHUNK
    _raster_equal(bins, dirs, znear, 200)


@pytest.mark.cuda
def test_raster_exact_ties_across_chunks_match_plain(dev):
    """Copies of spheres later in the instance order sort later in their
    tile, past runs of other spheres into later chunks, and give exactly
    the same t: the first strict minimum in sorted order (the original)
    wins, as in the plain sweep, on a frame whose tiles hold several
    chunks."""
    base = _centers(dev, 8)
    rng = np.random.default_rng(22)
    fill = torch.tensor(rng.normal(0, 1.5, (6000, 3)).astype(np.float32),
                        device=dev)
    centers = torch.cat([base, fill, base])
    bins, dirs, znear = _raster_case(dev, centers, 64, 256)
    wins = bins[0]
    count = sum(wins[:, 2 * g + 1] - wins[:, 2 * g] for g in range(4))
    assert int(count.max()) > raster_kernel.CHUNK
    got = _raster_equal(bins, dirs, znear, 200)
    order = bins[2]
    ids = order[got[1][got[1] >= 0].long()]
    assert bool((ids < len(base)).any())
    assert not bool((ids >= len(base) + len(fill)).any())


@pytest.mark.cuda
def test_raster_several_worlds_one_call_matches_plain(dev):
    """Six worlds of different sizes of load (a cluster, a sheet, nothing,
    a few spheres) in one call: each world equal to the plain sweep bit
    for bit and to the call on that world alone."""
    from wgpu_physics_engine_torch.parallel import datagen

    rng = np.random.default_rng(23)
    n = 3000
    worlds = []
    for kind in range(6):
        if kind == 0:
            pts = rng.normal(0, 0.2, (n, 3))
        elif kind == 1:
            pts = rng.uniform(-6, 6, (n, 3)) * [1.0, 1.0, 0.01]
        elif kind == 2:
            pts = rng.uniform(-6, 6, (n, 3)) + [0.0, 0.0, 500.0]
        else:
            pts = rng.uniform(-10, 10, (n, 3))
        worlds.append(pts)
    centers = torch.tensor(np.stack(worlds).astype(np.float32), device=dev)
    cams = datagen.randomized_cameras(6, torch.Generator().manual_seed(24),
                                      radius_range=(15.0, 30.0), device=dev)
    h, w = 48, 200
    eye, dirs = camera.pixel_rays(cams, h, w)
    wins, ocb, _, rect = raster_kernel.tiled_prologue_batched(
        cams.view[:, :3, :3], eye, centers, torch.full((6,), 0.15,
                                                       device=dev),
        cams.znear, torch.tan(cams.fovy_rad / 2.0), cams.aspect, h, w)
    before = raster_kernel.LAUNCHES
    got = raster_kernel.sphere_raster_kernel(wins, ocb, rect, dirs,
                                             cams.znear)
    torch.cuda.synchronize()
    assert raster_kernel.LAUNCHES == before + 1
    ref = raster_kernel.sphere_raster_plain(ocb, dirs, cams.znear)
    assert int((ref[1] >= 0).sum()) > 500
    for a, b in zip(got, ref):
        assert torch.equal(a, b)
    for i in range(6):
        one = raster_kernel.sphere_raster_kernel(wins[i], ocb[i], rect[i],
                                                 dirs[i], cams.znear[i])
        for a, b in zip(one, got):
            assert torch.equal(a, b[i])


@pytest.mark.cuda
def test_raster_work_list_kernel_equals_its_mirror(dev):
    """The raster's first launch builds the work list of
    ``raster_kernel.work_list`` exactly, on light tiles, heavy tiles and
    empty ones, in one world and several, and with a chunk grown past its
    floor."""
    rng = np.random.default_rng(25)
    for n_worlds, n_tiles, n in ((1, 64, 65536), (7, 33, 3000), (2, 5, 5000)):
        w = np.zeros((n_worlds, n_tiles, 8), np.int32)
        for b in range(n_worlds):
            for t in range(n_tiles):
                cuts = np.sort(rng.integers(0, n, 6))
                w[b, t, :6] = cuts
                w[b, t, 6:8] = (n - rng.integers(0, 50), n)
        w[0, 0] = 0
        wins = torch.tensor(w, device=dev)
        got = raster_kernel.work_list_kernel(wins)
        ref = raster_kernel.work_list(wins)
        torch.cuda.synchronize()
        total = int(ref[0][-1])
        assert torch.equal(got[0], ref[0]) and torch.equal(got[2], ref[2])
        assert torch.equal(got[1][:total], ref[1][:total])



# --- K1 and the direct K10 walk at the main paths' sizes ---

def _k1_state(dev, h, w, pins, seed):
    """A sheet at the flagship's spacing spawned just above the globe and
    stepped 150 substeps by the plain version (contact and friction run),
    with random velocities; the top row pinned where ``pins``."""
    c = cfg.ClothConfig(height=h, width=w, center=(0.0, 10.15, 0.0))
    p = st.ClothParams.from_config(c, device=dev)
    s = cloth_kernel.multi_step_plain(st.init_cloth_state(c, device=dev), p,
                                      DT, 150)
    rng = np.random.default_rng(seed)
    s = s._replace(vel=s.vel + torch.tensor(
        (0.2 * rng.standard_normal((3, h, w))).astype(np.float32),
        device=dev))
    if pins:
        mask = torch.zeros((h, w), dtype=torch.bool, device=dev)
        mask[0] = True
        s = s._replace(pin_mask=mask, pin_pos=s.pos)
    return s, p


@pytest.mark.cuda
@pytest.mark.parametrize("hw", [(256, 256), (60, 60), (255, 257),
                                (1000, 1030)])
@pytest.mark.parametrize("pins", [False, True])
def test_k1_matches_plain_and_k5_at_main_path_shapes(dev, hw, pins):
    h, w = hw
    s, p = _k1_state(dev, h, w, pins, seed=h + w)
    one = lambda a: None if a is None else a[None]
    batch = s._replace(pos=s.pos[None], vel=s.vel[None],
                       pin_mask=one(s.pin_mask), pin_pos=one(s.pin_pos))
    for n in (1, 2, 7, 48):
        for fast in (False, True):
            before = cloth_kernel.LAUNCHES
            got = cloth_kernel.multi_step_kernel(s, p, DT, n, fast_math=fast)
            torch.cuda.synchronize()
            assert cloth_kernel.LAUNCHES == before + n
            k5 = cloth_kernel.multi_step_kernel(batch, p, DT, n,
                                                fast_math=fast)
            assert torch.equal(got.pos, k5.pos[0])
            assert torch.equal(got.vel, k5.vel[0])
            if not fast:
                ref = cloth_kernel.multi_step_plain(s, p, DT, n)
                assert torch.equal(got.pos, ref.pos)
                assert torch.equal(got.vel, ref.vel)
    assert bool((torch.linalg.norm(s.pos, dim=0) < 10.11).any())


@pytest.mark.cuda
@pytest.mark.parametrize("pins", [False, True])
def test_k1_trace_matches_trace_plain_at_256(dev, pins):
    s, p = _k1_state(dev, 256, 256, pins, seed=3)
    prm = cloth_kernel._pack_params(p, DT)
    before = cloth_kernel.LAUNCHES
    traj = cloth_kernel.trace(s, prm, 49)
    torch.cuda.synchronize()
    assert cloth_kernel.LAUNCHES == before + 48
    assert torch.equal(traj, cloth_kernel.trace_plain(s, prm, 49))


def _pile_1m(dev, **kw):
    from wgpu_physics_engine_torch.models import granular
    from wgpu_physics_engine_torch.ops import granular_kernel as gk

    c = granular.GranularConfig(num_particles=1_000_000, **kw)
    s = granular.init_state(c, torch.Generator().manual_seed(0), device=dev)
    grid, slabs, dropped = granular.rebuild(s.pos, s.vel, c, stats=True)
    return grid.sorted_pos, grid.sorted_vel, slabs, gk.kernel_params(
        c, 1.0 / 240.0, dev)


@pytest.mark.cuda
@pytest.mark.parametrize("kw", [dict(), dict(thin=True, pallas_slab=640,
                                             rebuild_every=16),
                                dict(civ=False)],
                         ids=["default", "thin", "windows"])
def test_granular_walks_match_plain_at_1m(dev, kw):
    """K10 (the direct walk on the full set, the staged one on the thin
    set) equals its plain version bit for bit on the 1M lattice; so do
    K10b on a quarter of the slots and K11 with the plain integrate."""
    from wgpu_physics_engine_torch.ops import granular_kernel as gk

    p, v, slabs, prm = _pile_1m(dev, **kw)
    n = p.shape[1]
    stage = gk.walk_geometry(slabs, n, gk.resident_threads(dev))[2]
    assert stage == (slabs.ng <= 3)
    before = gk.LAUNCHES
    got = gk.substep_sorted(p, v, prm, slabs)
    torch.cuda.synchronize()
    assert gk.LAUNCHES == before + 1
    ref = gk.substep_sorted_plain(p, v, prm, slabs)
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
    q = n // 4 // slabs.block * slabs.block
    for base in (0, q):
        b = gk.substep_sorted(p, v[:, base:base + q].contiguous(), prm, slabs,
                              base, q)
        assert torch.equal(b[0], got[0][:, base:base + q])
        assert torch.equal(b[1], got[1][:, base:base + q])
    f = gk.contact_forces_sorted(p, prm[0], prm[1], slabs)
    ip, iv = gk._integrate(p, v, f, prm)
    assert torch.equal(ip, got[0]) and torch.equal(iv, got[1])
    assert torch.equal(f, gk.contact_forces_sorted_plain(p, prm[0], prm[1],
                                                         slabs))


# The differentiable render on the card against the CPU route: the same
# losses and the gradients of their centres and light within this share of
# the largest CPU gradient (the routes differ only where the card's libm
# and correctly rounded sqrt part from the CPU's by ulps).
DIFF_RENDER_TOL = 1e-3


def _render_loss(centers, light_pos, h, w, device, lit=True):
    import dataclasses

    from wgpu_physics_engine_torch.render import raster

    light = dataclasses.replace(cfg.LightConfig(), position=light_pos)
    cam = camera.make_camera(cfg.CameraConfig(), aspect=w / h, device=device)
    fb = raster.draw_instanced_spheres(raster.clear(h, w, device=device), cam,
                                       centers, 0.8, light, lit=lit)
    return fb, torch.mean(fb.color ** 2) + torch.mean(fb.depth)


@pytest.mark.cuda
@pytest.mark.parametrize("hw", [(32, 48), (32, 128)])
def test_diff_render_kernel_route_grad_matches_cpu(dev, hw):
    """``test_instanced_spheres_grads_no_nan_with_background``'s loss: on
    the card the nearest hit comes from K4 (32×48) or K2/K3 (32×128) and
    the gradient from the torch recompute of the winner's hit; it matches
    the CPU plain route's, and the frame keeps the kernel's bits."""
    h, w = hw
    centers = np.random.default_rng(0).uniform(-4.0, 4.0, (40, 3)).astype(
        np.float32)
    out = {}
    for d in ("cpu", dev):
        cen = torch.tensor(centers, device=d, requires_grad=True)
        lp = torch.tensor([25.0, 18.0, 12.0], device=d, requires_grad=True)
        launches = (raster_kernel.LAUNCHES, raster_kernel.LAUNCHES_UNTILED)
        fb, val = _render_loss(cen, lp, h, w, d)
        g_cen, g_lp = torch.autograd.grad(val, (cen, lp))
        out[torch.device(d).type] = (float(val.detach()), g_cen.cpu().numpy(),
                                     g_lp.cpu().numpy())
        if torch.device(d).type == "cuda":
            torch.cuda.synchronize()
            untiled = h % 16 != 0 or w % 128 != 0
            assert (raster_kernel.LAUNCHES_UNTILED - launches[1],
                    raster_kernel.LAUNCHES - launches[0]) == (
                        (1, 0) if untiled else (0, 1))
            with torch.no_grad():
                ref, _ = _render_loss(cen, lp, h, w, d)
            assert torch.equal(fb.color.detach(), ref.color)
            assert torch.equal(fb.depth.detach(), ref.depth)
    (lc, gc, gl), (lk, gk, glk) = out["cpu"], out["cuda"]
    assert np.isfinite(gk).all() and np.isfinite(glk).all()
    assert abs(lk - lc) <= 1e-5 * abs(lc)
    np.testing.assert_allclose(gk, gc, rtol=0,
                               atol=DIFF_RENDER_TOL * np.abs(gc).max())
    np.testing.assert_allclose(glk, gl, rtol=0,
                               atol=DIFF_RENDER_TOL * np.abs(gl).max())


# --- the differentiable rows path: the window trace and the window adjoint ---

@pytest.mark.cuda
@pytest.mark.parametrize("where", ["top", "middle", "bottom"])
@pytest.mark.parametrize("hg,h_local,pins", [(256, 128, False),
                                             (256, 128, True),
                                             (1024, 256, True)])
def test_window_adjoint_and_trace_match_plain(dev, hg, h_local, pins, where):
    """On the draped cloth, the windows of the rows path at k = 2: 136×256
    (the composed path's, K1w) and 264×1024 (a 1024² rows shard's, above
    the tiled limit, K6w forward), the top one with dead rows (row0 < 0),
    a middle and the bottom one. ``trace_window`` (K1w's body) ≡
    ``trace_window_plain`` and its state 2 ≡ ``multi_step_window``'s
    output, bit for bit; the window adjoint over the two substeps against
    ``_walk_plain`` with the window: state and pin cotangents bit for
    bit, the parameter cotangent too (the plain version sums it in the
    kernel's order), and finite; one launch a substep each."""
    k, halo = 2, 4
    row0 = {"top": -halo, "middle": hg // 2 - h_local // 2 - halo,
            "bottom": hg - h_local - halo}[where]
    rows = h_local + 2 * halo
    s, p = _k6_state(dev, hg, hg, True, [(r, c) for r in (0, hg // 2, hg - 1)
                                         for c in range(0, hg, 2)]
                     if pins else None)
    prm = cloth_kernel._pack_params(p, DT)
    win = [None if a is None else _window_of(a, row0, row0 + rows, hg)
           for a in (s.pos, s.vel, s.pin_mask, s.pin_pos)]
    t0 = cloth_kernel.LAUNCHES_WINDOW_TRACE
    traj = cloth_kernel.trace_window(*win, prm, k + 1, row0, hg)
    fwd = cloth_kernel.multi_step_window(*win, p, DT, k, row0, hg)
    torch.cuda.synchronize()
    assert cloth_kernel.LAUNCHES_WINDOW_TRACE == t0 + k
    assert torch.equal(traj, cloth_kernel.trace_window_plain(
        *win, prm, k + 1, row0, hg))
    assert torch.equal(traj[k, :3], fwd[0]) and torch.equal(traj[k, 3:],
                                                           fwd[1])
    rng = np.random.default_rng(hg + row0)
    cp, cv = (torch.tensor(rng.standard_normal((3, rows, hg))
                           .astype(np.float32), device=dev)
              for _ in range(2))
    pins_t = None if not pins else (win[2], win[3])
    a0 = cloth_grad_kernel.LAUNCHES_WINDOW
    got = cloth_grad_kernel.walk_window(traj[:k], cp, cv, prm, row0, hg,
                                        pins_t)
    torch.cuda.synchronize()
    assert cloth_grad_kernel.LAUNCHES_WINDOW == a0 + k
    ref = cloth_grad_kernel._walk_plain(traj[:k], cp, cv, prm, pins_t,
                                        (row0, hg))
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
    assert torch.equal(got[2], ref[2])
    assert bool(torch.isfinite(got[2]).all())
    if pins:
        assert torch.equal(got[3], ref[3])
        assert float(got[3].abs().max()) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("hg,h_local,n_worlds", [(16, 8, 8), (256, 128, 8),
                                                 (1024, 256, 1)])
def test_window_batch_matches_plain_and_each_window(dev, hg, h_local,
                                                    n_worlds):
    """A batch of the rows path's windows at k = 2, every rows shard of
    ``n_worlds`` worlds: the example's 16 windows of 16×16, the composed
    cell's 16 of 136×256 and the rows cell's 4 of 264×1024 (K6w forward, a
    window a launch), with top (row0 < 0), middle and bottom windows,
    world 0 draped and pinned, the others with random velocities and a
    zero pin mask. The batched trace (one launch a substep), forward and
    window adjoint (one launch a substep) against their batched plain
    versions bit for bit, the parameter cotangent included; against the
    same calls a window at a time bit for bit (a zero mask as no pins),
    the parameter cotangent within 1e-5 of its largest entry of their sum."""
    k, halo = 2, 4
    rows = h_local + 2 * halo
    worlds = [_k6_state(dev, hg, hg, j == 0, [(0, c) for c in range(0, hg, 2)]
                        if j == 0 else None) for j in range(n_worlds)]
    p = worlds[0][1]
    prm = cloth_kernel._pack_params(p, DT)
    n_shards = hg // h_local
    row0 = [i * h_local - halo for _ in worlds for i in range(n_shards)]
    zero = torch.zeros((hg, hg), dtype=torch.bool, device=dev)

    def planes(s):
        return (s.pos, s.vel, zero if s.pin_mask is None else s.pin_mask,
                s.pos if s.pin_pos is None else s.pin_pos)

    win = [torch.stack([_window_of(planes(s)[m], r, r + rows, hg)
                        for s, _ in worlds for r in row0[:n_shards]])
           for m in range(4)]
    n = len(row0)
    t0 = (cloth_kernel.LAUNCHES_WINDOW_TRACE, cloth_grad_kernel.LAUNCHES_WINDOW)
    traj = cloth_kernel.trace_window(*win, prm, k + 1, row0, hg)
    fwd = cloth_kernel.multi_step_window(*win, p, DT, k, row0, hg)
    rng = np.random.default_rng(hg)
    cp, cv = (torch.tensor(rng.standard_normal((n, 3, rows, hg))
                           .astype(np.float32), device=dev)
              for _ in range(2))
    pins = (win[2], win[3])
    got = cloth_grad_kernel.walk_window(traj[:k], cp, cv, prm, row0, hg,
                                        pins)
    torch.cuda.synchronize()
    assert (cloth_kernel.LAUNCHES_WINDOW_TRACE - t0[0],
            cloth_grad_kernel.LAUNCHES_WINDOW - t0[1]) == (k, k)
    assert torch.equal(traj, cloth_kernel.trace_window_plain(
        *win, prm, k + 1, row0, hg))
    assert torch.equal(traj[k, :, :3], fwd[0])
    assert torch.equal(traj[k, :, 3:], fwd[1])
    ref = cloth_grad_kernel._walk_plain(traj[:k], cp, cv, prm, pins,
                                        (row0, hg))
    for a, b in zip(got, ref):
        assert torch.equal(a, b)
    assert bool(torch.isfinite(got[2]).all())
    g_sum = torch.zeros(16, dtype=torch.float64, device=dev)
    for b, r in enumerate(row0):
        pins_b = (win[2][b], win[3][b]) if bool(win[2][b].any()) else None
        one = [win[0][b], win[1][b], *(pins_b or (None, None))]
        t1 = cloth_kernel.trace_window(*one, prm, k + 1, r, hg)
        f1 = cloth_kernel.multi_step_window(*one, p, DT, k, r, hg)
        w1 = cloth_grad_kernel.walk_window(t1[:k], cp[b], cv[b], prm, r, hg,
                                           pins_b)
        assert torch.equal(traj[:, b], t1)
        assert torch.equal(fwd[0][b], f1[0]) and torch.equal(fwd[1][b],
                                                             f1[1])
        assert torch.equal(got[0][b], w1[0]) and torch.equal(got[1][b],
                                                             w1[1])
        if pins_b is not None:
            assert torch.equal(got[3][b], w1[3])
        else:
            assert not bool(got[3][b].any())
        g_sum += w1[2].double()
    assert _max_rel(got[2], g_sum.float()) <= 1e-5


@pytest.mark.cuda
def test_window_adjoint_example_gradient_cuda_matches_cpu(dev):
    """``examples/multichip_training.py``'s loss and d loss/d log k at k =
    430 and 470 on 8 shards of the card against 8 CPU shards (the plain
    versions; torch's CPU sqrt is not correctly rounded, the card's is):
    within 1e-4 relative; on the card K1w, the window trace and the
    window adjoint launch as the path predicts."""
    from wgpu_physics_engine_torch.examples import multichip_training as mt

    out = {}
    for d in ("cpu", "cuda"):
        m, _, params, state = mt.make_problem(device=d)
        with torch.no_grad():
            target = mt.rollout(state, params, m)
        counts = (cloth_kernel.LAUNCHES_WINDOW,
                  cloth_kernel.LAUNCHES_WINDOW_TRACE,
                  cloth_grad_kernel.LAUNCHES_WINDOW)
        vals = []
        for k in (430.0, 470.0):
            log_k = torch.log(torch.tensor(k, device=state.pos.device)
                              ).requires_grad_(True)
            loss = mt.loss_fn(log_k, state, params, m, target)
            (g,) = torch.autograd.grad(loss, log_k)
            vals.append((float(loss.detach()), float(g)))
        out[d] = vals
        if d == "cuda":
            torch.cuda.synchronize()
            # a rollout: 8 blocks of 2 substeps, one window call of the 8
            # worlds x 2 rows shards a block on the one card
            calls = mt.N_STEPS // mt.SUBSTEPS_PER_EXCHANGE
            k_sub = mt.SUBSTEPS_PER_EXCHANGE
            assert (cloth_kernel.LAUNCHES_WINDOW - counts[0],
                    cloth_kernel.LAUNCHES_WINDOW_TRACE - counts[1],
                    cloth_grad_kernel.LAUNCHES_WINDOW - counts[2]) == (
                2 * calls * k_sub, 2 * calls * (k_sub - 1),
                2 * calls * k_sub)
    for (lc, gc), (lk, gk) in zip(out["cpu"], out["cuda"]):
        assert abs(lk - lc) <= 1e-4 * abs(lc)
        assert abs(gk - gc) <= 1e-4 * abs(gc)
