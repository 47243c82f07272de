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
"""

import numpy as np
import pytest
import torch

from wgpu_physics_engine_torch.core import config as cfg
from wgpu_physics_engine_torch.core import state as st
from wgpu_physics_engine_torch.models import scenes
from wgpu_physics_engine_torch.models import cloth
from wgpu_physics_engine_torch.ops import cloth_grad_kernel, cloth_kernel, raster_kernel
from wgpu_physics_engine_torch.render import camera

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
    wins, ocb, _ = raster_kernel.tiled_prologue(
        tc.view[:3, :3], tc.eye, _centers(dev, 4), 0.3, tc.znear,
        torch.tan(tc.fovy_rad / 2.0), tc.aspect, h, w)
    before = raster_kernel.LAUNCHES
    kt, ki, ko = raster_kernel.sphere_raster_binned(wins, ocb, dirs, tc.znear)
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
    scene.simulate(0.5)
    scene.update(1 / 60)
    img = scene.render(64, 160)
    assert cloth_kernel.LAUNCHES - k0 == 240 + 8
    assert raster_kernel.LAUNCHES - r0 == 1
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
    wins, ocb, _ = raster_kernel.tiled_prologue_batched(
        cams.view[:, :3, :3], eye, centers, b.params.particle_radius,
        cams.znear, torch.tan(cams.fovy_rad / 2.0), cams.aspect, h, w)
    before = raster_kernel.LAUNCHES
    kt, ki, ko = raster_kernel.sphere_raster_binned(wins, ocb, dirs,
                                                    cams.znear)
    torch.cuda.synchronize()
    assert raster_kernel.LAUNCHES == before + 1
    pt, pi, po = raster_kernel.sphere_raster_plain(ocb, dirs, cams.znear)
    assert int((ki >= 0).sum()) > 20
    assert torch.equal(ki, pi) and torch.equal(kt, pt) and torch.equal(ko, po)
    for i in range(4):               # the batch equals four one-world launches
        t1, i1, _ = raster_kernel.sphere_raster_kernel(wins[i], ocb[i],
                                                       dirs[i], cams.znear[i])
        assert torch.equal(ki[i], i1) and torch.equal(kt[i], t1)


@pytest.mark.cuda
def test_datagen_on_cuda_matches_plain_path(dev):
    from wgpu_physics_engine_torch.parallel import datagen

    c = cfg.ClothConfig(height=12, width=12, **VISIBLE)
    kw = dict(n_worlds=5, n_frames=3, steps_per_frame=8, fb_size=(32, 128),
              randomize_cameras=True, world_chunk=3, device=dev)
    k5_0, r0 = cloth_kernel.LAUNCHES_BATCHED, raster_kernel.LAUNCHES
    got = [(f, im) for f, im, _ in datagen.generate_trajectory_dataset(
        c, generator=torch.Generator().manual_seed(2), **kw)]
    assert cloth_kernel.LAUNCHES_BATCHED - k5_0 == 3 * 2 * 8   # frames × chunks
    assert raster_kernel.LAUNCHES - r0 == 3 * 2
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
def test_cli_gif_on_cuda(dev, tmp_path):
    from wgpu_physics_engine_torch.__main__ import main

    k0, r0 = cloth_kernel.LAUNCHES, raster_kernel.LAUNCHES
    out = tmp_path / "cloth.gif"
    rc = main(["cloth", "--grid", "16", "--size", "32", "64", "--seconds",
               "0.2", "--fps", "10", "--gif", str(out)])
    assert rc == 0 and out.exists()
    assert cloth_kernel.LAUNCHES - k0 == 2 * 8      # 2 frames of 8 substeps
    assert raster_kernel.LAUNCHES - r0 == 2


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
